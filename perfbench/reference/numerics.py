"""The reference's arithmetic modes.

"f32" is full float32 (the caller keeps TF32 off on a card). The two lower
modes are the correctness controls of the benchmark: they round the inputs
of every matrix product (convolutions, linear layers, both products of the
attention, the bicubic resize) to a narrower format and keep float32
accumulation, as the tensor cores do.

* "tf32": round to nearest even on TF32's 10 stored mantissa bits (the
  step below float32 with TF32 off);
* "fp8": per-tensor scaled fp8 (the step below bf16): each operand is
  scaled so that its largest magnitude maps to the format's largest
  value, cast and back; e4m3 for the forward's operands, e5m2 for the
  gradients.

Training rounds both passes: an operand is rounded in the forward and its
gradient passes through (`mm_in`), and the gradient arriving at a
product's output is rounded before the backward's products read it
(`mm_out`).

The mode lives in a context variable, so a caller opens it around one
computation and nothing else sees it.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

MODES = ("f32", "tf32", "fp8")
_MODE = contextvars.ContextVar("perfbench_reference_mode", default="f32")


@contextlib.contextmanager
def mode(name: str):
    if name not in MODES:
        raise ValueError(f"unknown reference mode {name!r} (one of {MODES})")
    token = _MODE.set(name)
    try:
        yield
    finally:
        _MODE.reset(token)


def current() -> str:
    return _MODE.get()


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.float().contiguous().view(torch.int32)
    # round half to even on the 13 dropped mantissa bits
    lsb = (bits >> 13) & 1
    bits = (bits + 0x0FFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def _round_fp8(x: torch.Tensor, fmt=torch.float8_e4m3fn) -> torch.Tensor:
    x = x.float()
    top = torch.finfo(fmt).max
    amax = x.abs().amax()
    scale = torch.where(amax > 0, top / amax, torch.ones_like(amax))
    return (x * scale).to(fmt).float() / scale


def _round(x: torch.Tensor, m: str, backward: bool) -> torch.Tensor:
    if m == "tf32":
        return _round_tf32(x)
    # fp8 training: e4m3 for operands, e5m2 for gradients
    return _round_fp8(x, torch.float8_e5m2 if backward else torch.float8_e4m3fn)


class _Operand(torch.autograd.Function):
    """Rounded in the forward; the gradient passes through unchanged."""

    @staticmethod
    def forward(ctx, x, m):
        return _round(x, m, backward=False)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Product(torch.autograd.Function):
    """Unchanged in the forward; the gradient arriving at a product's
    output is rounded before the backward's products read it."""

    @staticmethod
    def forward(ctx, y, m):
        ctx.m = m
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.m, backward=True), None


def mm_in(x: torch.Tensor) -> torch.Tensor:
    """An operand of a matrix product, rounded as the current mode says."""
    m = _MODE.get()
    return x if m == "f32" else _Operand.apply(x, m)


def mm_out(y: torch.Tensor) -> torch.Tensor:
    """A matrix product's result: in a lower mode its gradient is rounded
    too, so the backward's products also read rounded operands."""
    m = _MODE.get()
    return y if m == "f32" or not y.requires_grad else _Product.apply(y, m)
