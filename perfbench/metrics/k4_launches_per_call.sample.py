"""K4 (the float32 3x3 convolution, csrc/conv3x3.cu) launches per UNet call:
the kernel events named "conv3x3_fwd_kernel" in the profiled stretch over the
UNet calls it ran; None for a program without K4 (no ops/conv3x3.py)."""

import importlib.util


def read(ctx):
    if not ctx.units or importlib.util.find_spec("srewd_tpu_torch.ops.conv3x3") is None:
        return None
    return sum(1 for k in ctx.trace.kernels if "conv3x3_fwd_kernel" in k.name) / ctx.units
