"""Device ms of every kernel other than K1, K2, K3 and K3's backward (the
convolutions, matrix products, FFTs and elementwise work of the libraries
and PyTorch) per UNet call in the profiled stretch."""

KERNELS = ("flash_fwd_", "flash_bwd_", "gn_fwd_kernel", "gn_bwd_kernel", "gn_wb_kernel")


def read(ctx):
    t = ctx.trace
    if ctx.units == 0:
        return None
    total = sum(k.dur for k in t.kernels) / 1e6
    return 1e3 * (total - t.kernel_seconds(*KERNELS)) / ctx.units
