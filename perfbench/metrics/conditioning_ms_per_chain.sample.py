"""Device ms of the operations launched inside the program's
`conditioning` span (models/factory.py: the bicubic condition, the DWT
pyramid and stencil maps, an RRDB encoder, the chain UNet's weight cast)
per `chain` span (one generate_sr) in the profiled stretch."""

from perfbench import spans


def read(ctx):
    return spans.ms_per(ctx.trace, spans.device_seconds, "conditioning", per="chain")
