"""The share of the profiled stretch in which no operation ran on the
card (torch.profiler CUDA activity: kernels, copies, sets), in %."""


def read(ctx):
    t = ctx.trace
    return 100.0 * (1.0 - t.busy_s / t.window_s) if t.window_s > 0 else None
