"""The share of its roofline of K1 (flash attention forward), in % of the profiled stretch's
device time of the kernels named "flash_fwd_": the least time of the work that the
reference's calls of a unit need (work/: the larger of operations over
the peak and bytes over 3.35 TB/s), times the units."""

from perfbench import work


def read(ctx):
    device_s = ctx.trace.kernel_seconds("flash_fwd_")
    if "k1" not in ctx.kernel_work or device_s <= 0:
        return None
    bound = work.kernel_bound_seconds(ctx.kernel_work, ctx.dtype)["k1"] * ctx.units
    return 100.0 * bound / device_s
