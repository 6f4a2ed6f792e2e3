"""Idle ms of the card that ended with an operation launched inside the
program's `encoder` span (models/factory.py encode_rrdb), per
`train_step` span in the profiled stretch (perfbench/spans.py defines a
wait)."""

from perfbench import spans


def read(ctx):
    return spans.ms_per(ctx.trace, spans.wait_seconds, "encoder", per="train_step")
