"""Device ms per train step of the operations launched inside the
trainer's `optimizer` span (training/trainer.py: the clip, the optimizer's
step and the EMA) in the profiled stretch."""


def read(ctx):
    if ctx.units == 0 or not any(s.name == "optimizer" for s in ctx.trace.spans):
        return None
    return 1e3 * ctx.trace.seconds_under("optimizer") / ctx.units
