"""Kernel launches per train step: kernel events in the profiled stretch over
the train steps it ran."""


def read(ctx):
    return len(ctx.trace.kernels) / ctx.units if ctx.units else None
