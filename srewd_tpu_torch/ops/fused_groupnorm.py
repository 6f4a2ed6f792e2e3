"""GroupNorm + affine (+ Swish) on NHWC: a Triton kernel and its plain version.

Replaces the TPU kernel `_pallas_gn_swish` in srewd_tpu/ops/pallas_fused.py
(body `_kernel`, reached through `fused_groupnorm_swish`). Semantics, as
there: GroupNorm over [B, HW, C] with G groups, statistics in float32 as
E[x^2] - E[x]^2 with eps, affine in float32, result cast to the storage
dtype BEFORE the optional Swish y * sigmoid(y).

On the card the op is bound by memory: per element it does a handful of
flops against 2-4 bytes read twice and written once, far below the H100's
~295 flop/byte balance point. The design keeps it to the minimum traffic of
a two-pass GroupNorm (read for the statistics, read again and write for the
apply) inside ONE launch: one Triton program per (sample, group) loops over
HW itself, first summing x and x^2 in float32, then normalising and writing
its tile. No cross-program reduction is needed, so nothing goes through
device memory between the passes; the second read of a group's slab mostly
hits L2 (the largest slab is 128*256*64*4 B / 32 groups = 256 KB).
The input must be channels-last memory (NHWC contiguous), so the kernel
reads rows of CG = C/G channels at a row stride of C. At small CG those
reads use only part of each 32-byte sector; the neighbouring groups'
programs, resident at the same time, read the rest from L2. Widening a
program to several groups, or splitting HW across programs, is later work.

Training: `GNSwishFn` launches the kernel in its forward and recomputes the
gradient through the plain math with torch.autograd in its backward, as the
JAX package's `_pallas_gn_swish_vjp` takes `jax.vjp` of `_pure_gn_swish`
(the JAX package has no backward kernel for it either). The backward's math
(`_gn_swish_math`) does not count as a call of `gn_swish_reference`, so a
count of 0 plain calls still says that no forward fell back.
"""

from __future__ import annotations

import torch

from . import use_plain


def _gn_swish_math(x, weight, bias, num_groups, eps, apply_swish):
    b, h, w, c = x.shape
    cg = c // num_groups
    x32 = x.float().reshape(b, h * w, num_groups, cg)
    mean = x32.mean(dim=(1, 3), keepdim=True)
    var = x32.square().mean(dim=(1, 3), keepdim=True) - mean.square()
    y = ((x32 - mean) * torch.rsqrt(var + eps)).reshape(b, h, w, c)
    y = (y * weight.float() + bias.float()).to(x.dtype)
    if apply_swish:
        y = y * torch.sigmoid(y)
    return y


def gn_swish_reference(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int = 32,
    eps: float = 1e-5,
    apply_swish: bool = True,
) -> torch.Tensor:
    """Plain PyTorch version (the semantics of pallas_fused._pure_gn_swish)."""
    gn_swish_reference.calls += 1
    return _gn_swish_math(x, weight, bias, num_groups, eps, apply_swish)


gn_swish_reference.calls = 0

_KERNEL = None


def _kernel():
    """Define the Triton kernel on first launch (no triton at import time)."""
    global _KERNEL
    if _KERNEL is not None:
        return _KERNEL
    import triton
    import triton.language as tl

    @triton.jit
    def _gn_swish_kernel(
        x_ptr, w_ptr, b_ptr, y_ptr,
        HW, C, CG, inv_n, eps,
        APPLY_SWISH: tl.constexpr, BLOCK_HW: tl.constexpr, BLOCK_CG: tl.constexpr,
    ):
        pid_b = tl.program_id(0)
        pid_g = tl.program_id(1)
        base = pid_b.to(tl.int64) * HW * C + pid_g * CG
        rows = tl.arange(0, BLOCK_HW)
        cols = tl.arange(0, BLOCK_CG)
        cmask = cols < CG

        # pass 1: float32 sum and sum of squares over the group's slab
        acc = tl.zeros([BLOCK_HW, BLOCK_CG], tl.float32)
        acc2 = tl.zeros([BLOCK_HW, BLOCK_CG], tl.float32)
        for start in range(0, HW, BLOCK_HW):
            r = start + rows
            m = (r < HW)[:, None] & cmask[None, :]
            offs = base + r[:, None].to(tl.int64) * C + cols[None, :]
            xv = tl.load(x_ptr + offs, mask=m, other=0.0).to(tl.float32)
            acc += xv
            acc2 += xv * xv
        mean = tl.sum(tl.sum(acc, axis=1), axis=0) * inv_n
        var = tl.sum(tl.sum(acc2, axis=1), axis=0) * inv_n - mean * mean
        rstd = 1.0 / tl.sqrt(var + eps)
        wv = tl.load(w_ptr + pid_g * CG + cols, mask=cmask, other=0.0).to(tl.float32)
        bv = tl.load(b_ptr + pid_g * CG + cols, mask=cmask, other=0.0).to(tl.float32)

        # pass 2: normalise, affine in f32, cast to storage dtype, Swish
        for start in range(0, HW, BLOCK_HW):
            r = start + rows
            m = (r < HW)[:, None] & cmask[None, :]
            offs = base + r[:, None].to(tl.int64) * C + cols[None, :]
            xv = tl.load(x_ptr + offs, mask=m, other=0.0).to(tl.float32)
            yv = ((xv - mean) * rstd * wv[None, :] + bv[None, :]).to(
                y_ptr.dtype.element_ty
            )
            if APPLY_SWISH:
                yf = yv.to(tl.float32)
                yv = (yf * tl.sigmoid(yf)).to(y_ptr.dtype.element_ty)
            tl.store(y_ptr + offs, yv, mask=m)

    _KERNEL = (triton, _gn_swish_kernel)
    return _KERNEL


def gn_swish(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int = 32,
    eps: float = 1e-5,
    apply_swish: bool = True,
) -> torch.Tensor:
    """GroupNorm(+Swish) of NHWC `x` [B,H,W,C]; weight/bias [C].

    CPU tensors take `gn_swish_reference`; CUDA tensors launch the Triton
    kernel (float32 or bfloat16, NHWC-contiguous) or raise.

    The Swish runs on the value already rounded to the storage dtype, in
    float32, and is rounded once; the plain version multiplies in the
    storage dtype. In bfloat16 the two can differ by one bf16 ulp.
    """
    if use_plain(x):
        return gn_swish_reference(x, weight, bias, num_groups, eps, apply_swish)
    if x.ndim != 4:
        raise ValueError(f"gn_swish expects NHWC [B,H,W,C], got {tuple(x.shape)}")
    b, h, w, c = x.shape
    if c % num_groups:
        raise ValueError(f"C={c} is not a multiple of num_groups={num_groups}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"gn_swish supports float32 and bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("gn_swish expects NHWC-contiguous (channels_last) memory")
    for name, p in (("weight", weight), ("bias", bias)):
        if p.device != x.device or p.shape != (c,) or not p.is_contiguous():
            raise ValueError(f"{name} must be a contiguous [C] tensor on {x.device}")
    triton, kernel = _kernel()
    cg = c // num_groups
    hw = h * w
    block_cg = triton.next_power_of_2(cg)
    block_hw = max(16, min(triton.next_power_of_2(hw), 4096 // block_cg))
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        kernel[(b, num_groups)](
            x, weight, bias, y, hw, c, cg, 1.0 / (hw * cg), eps,
            APPLY_SWISH=apply_swish, BLOCK_HW=block_hw, BLOCK_CG=block_cg,
            num_warps=4,
        )
    gn_swish.launches += 1
    return y


gn_swish.launches = 0


class GNSwishFn(torch.autograd.Function):
    """gn_swish forward (the kernel, or the plain version on the CPU); the
    backward recomputes through `_gn_swish_math` with torch.autograd."""

    @staticmethod
    def forward(ctx, x, weight, bias, num_groups, eps, apply_swish):
        ctx.save_for_backward(x, weight, bias)
        ctx.cfg = (num_groups, eps, apply_swish)
        return gn_swish(x, weight, bias, num_groups, eps, apply_swish)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            y = _gn_swish_math(*inputs, *ctx.cfg)
        grads = torch.autograd.grad(y, inputs, g)
        return (*grads, None, None, None)


def gn_swish_trainable(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int = 32,
    eps: float = 1e-5,
    apply_swish: bool = True,
) -> torch.Tensor:
    """gn_swish that autograd can differentiate: through `GNSwishFn` when
    grad is enabled and an input needs it, else the bare forward."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return GNSwishFn.apply(x, weight, bias, num_groups, eps, apply_swish)
    return gn_swish(x, weight, bias, num_groups, eps, apply_swish)
