"""Device ms of the operations launched inside the program's `encoder`
span (models/factory.py encode_rrdb: the RRDB forward and its tap
projection) per `train_step` span in the profiled stretch."""

from perfbench import spans


def read(ctx):
    return spans.ms_per(ctx.trace, spans.device_seconds, "encoder", per="train_step")
