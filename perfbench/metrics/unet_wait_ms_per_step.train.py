"""Idle ms of the card that ended with an operation launched inside the
program's `unet` span (the loss's UNet forward, models/factory.py), per
`train_step` span (training/trainer.py) in the profiled stretch
(perfbench/spans.py defines a wait)."""

from perfbench import spans


def read(ctx):
    return spans.ms_per(ctx.trace, spans.wait_seconds, "unet", per="train_step")
