"""Model FLOP utilization of the unprofiled stretch before the traced
one: the plain reference's operations of a unit (work/: convolutions and
matrix products, counted on the meta device) times the units run, over the
stretch's wall time, over the peak of the dtype's matrix work (bf16 989
TFLOP/s; float32 165, 3xTF32), in %."""

from perfbench import work


def read(ctx):
    if ctx.timed_units == 0 or ctx.timed_seconds <= 0:
        return None
    rate = ctx.unit_flops * ctx.timed_units / ctx.timed_seconds
    return 100.0 * rate / work.PEAK_MATRIX[ctx.dtype]
