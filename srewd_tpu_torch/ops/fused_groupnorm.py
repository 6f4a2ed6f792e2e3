"""GroupNorm + affine (+ Swish) on NHWC, forward and backward: the CUDA
kernels and their plain versions.

The forward replaces the TPU kernel `_pallas_gn_swish` in
srewd_tpu/ops/pallas_fused.py (body `_kernel`, reached through
`fused_groupnorm_swish`); the backward replaces that package's recompute VJP
(`_bwd`, jax.vjp of `_pure_gn_swish`) with a hand-written gradient of the
same function. Semantics, as there: GroupNorm over [B, HW, C] with G groups,
statistics in float32 as E[x^2] - E[x]^2 with eps, affine in float32, the
result cast to the storage dtype BEFORE the optional Swish y * sigmoid(y).

Both kernels live in csrc/gn_swish.cu (built by ops/_build.py, bound with
ctypes), which describes the design: the op is bound by memory, so one
thread-block cluster holds a sample's channel slice in shared memory, reads
it from device memory once, sums the statistics across its blocks through
distributed shared memory in a fixed order, and writes the result once. The
backward keeps x and dy resident the same way and reduces dweight and dbias
through a float32 workspace in a second launch: deterministic, no atomics.

`gn_plan` (pure Python) chooses the slice width, cluster size, rows per
block and threads; the wrappers and the CPU tests both use it.

`GNSwishFn` is what the model trains through: its forward launches the
kernel and keeps the statistics, its backward launches the backward kernel.
While torch.export traces the bare forward, `gn_swish` calls the custom op
`srewd::gn_swish` instead (see ops/__init__.py): its CUDA implementation is
the forward's launch, its CPU one `gn_swish_reference`, and its fake runs
`_check` and asks `gn_plan` whether a plan exists, so a shape the kernel
does not take fails when a program is exported, not when it is served.
Whether the plain versions run is decided in the forward (a CPU tensor, or
inside `reference_ops()`) and kept for the backward, which autograd may run
on another thread.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from . import _build, count, launch, use_op, use_plain

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
SMEM_LIMIT = 232448  # bytes of shared memory one block may use (227 KiB)
MAX_CLUSTER = 16  # blocks per cluster (above 8 is non-portable)
MAX_THREADS = 512
# A block's slab target (x; the backward also holds dy): two blocks of this
# size fit one SM's shared memory, so one block's loads can run beside
# another's stores.
CTA_SLAB_TARGET = 100 * 1024
MIN_BLOCKS = 132  # one block for each of the H100's SMs
MIN_ROWS = 8
WIDE_SEGMENT = 64  # bytes: two sectors of a row
_lib = None
_active: dict = {}


class GNPlan(NamedTuple):
    slice_channels: int  # S: channels of one work item, whole groups
    slices: int  # C / S
    cluster: int  # blocks per cluster, one cluster per (sample, slice)
    rows_per_cta: int  # rows of HW each block holds (the last may hold fewer)
    threads: int  # per block; a multiple of S
    bytes_per_cta: int  # dynamic shared memory of one block
    blocks: int  # B * slices * cluster: one cluster per work item


def _slab(rows: int, s: int, isz: int) -> int:
    return (rows * s * isz + 15) // 16 * 16


def _threads(s: int) -> int:
    """A multiple of S (each thread sums one channel) and, where it can be,
    of 32; at most MAX_THREADS."""
    step = s * 32 // math.gcd(s, 32)
    if step > MAX_THREADS:
        step = s
    return max(step, MAX_THREADS // step * step)


@functools.lru_cache(maxsize=None)
def gn_plan(shape, groups: int, dtype: torch.dtype, backward: bool = False) -> GNPlan:
    """How the kernel splits NHWC `shape` [B,H,W,C] with `groups` groups.

    Slices are runs of whole groups whose row segment is a multiple of 16
    bytes (cp.async) and at least one 32-byte sector, at most MAX_THREADS
    channels. Segments of whole sectors (a multiple of 32 bytes) come first.
    Each such slice whose slab (x; the backward also holds dy) fits
    MAX_CLUSTER blocks of CTA_SLAB_TARGET bytes gets the smallest cluster
    that holds it, grown (to MAX_CLUSTER, keeping MIN_ROWS rows a block)
    until the grid has MIN_BLOCKS blocks. Of the slices that reach
    MIN_BLOCKS, the one with the smallest cluster among those whose segment
    is at least WIDE_SEGMENT bytes is taken (a cluster barrier costs more the
    more blocks it joins), else the widest; if none reaches it, the one with
    the most blocks. Failing all, the widest slice that fits MAX_CLUSTER
    blocks of SMEM_LIMIT bytes; then the same two steps for segments that
    are not whole sectors. A shape that nothing fits raises ValueError.
    Cached: the wrappers ask once per shape.
    """
    b, h, w, c = (int(v) for v in shape)
    if c % groups:
        raise ValueError(f"C={c} is not a multiple of num_groups={groups}")
    hw, cg = h * w, c // groups
    isz = torch.empty((), dtype=dtype).element_size()
    slabs = 2 if backward else 1
    cands = [k * cg for k in range(groups, 0, -1)
             if groups % k == 0 and (k * cg * isz) % 16 == 0 and k * cg * isz >= 32
             and k * cg <= MAX_THREADS]

    def make(s: int, cs: int) -> GNPlan:
        rows = -(-hw // cs)
        nt = _threads(s)
        return GNPlan(s, c // s, cs, rows, nt, slabs * _slab(rows, s, isz) + 4 * (2 * nt + 10 * s),
                      b * (c // s) * cs)

    def under_target(pool):
        plans = []
        for s in pool:
            cs = 1
            while cs < MAX_CLUSTER and slabs * _slab(-(-hw // cs), s, isz) > CTA_SLAB_TARGET:
                cs *= 2
            if slabs * _slab(-(-hw // cs), s, isz) > CTA_SLAB_TARGET:
                continue
            while (b * (c // s) * cs < MIN_BLOCKS and cs < MAX_CLUSTER
                   and -(-hw // (2 * cs)) >= MIN_ROWS):
                cs *= 2
            plans.append(make(s, cs))
        full = [p for p in plans if p.blocks >= MIN_BLOCKS]
        wide = [p for p in full if p.slice_channels * isz >= WIDE_SEGMENT]
        if wide:
            return min(wide, key=lambda p: p.cluster)
        if full:
            return full[0]
        return max(plans, key=lambda p: p.blocks, default=None)

    def under_limit(pool):
        for s in pool:
            plan = make(s, MAX_CLUSTER)
            if plan.bytes_per_cta <= SMEM_LIMIT:
                return plan
        return None

    sectors = [s for s in cands if (s * isz) % 32 == 0]
    others = [s for s in cands if (s * isz) % 32]
    steps = ((under_target, sectors), (under_limit, sectors), (under_target, others),
             (under_limit, others))
    for step, pool in steps:
        plan = step(pool)
        if plan is not None:
            return plan
    raise ValueError(
        f"GroupNorm of {tuple(shape)} ({groups} groups, {dtype}"
        f"{', backward' if backward else ''}): no slice of whole groups fits "
        f"{MAX_CLUSTER} CTAs x {SMEM_LIMIT // 1024} KiB of shared memory")


def _gn_swish_math(x, weight, bias, num_groups, eps, apply_swish, return_stats=False):
    b, h, w, c = x.shape
    cg = c // num_groups
    acc = torch.promote_types(x.dtype, torch.float32)  # float64 stays float64
    x32 = x.to(acc).reshape(b, h * w, num_groups, cg)
    mean = x32.mean(dim=(1, 3), keepdim=True)
    var = x32.square().mean(dim=(1, 3), keepdim=True) - mean.square()
    rstd = torch.rsqrt(var + eps)
    y = ((x32 - mean) * rstd).reshape(b, h, w, c)
    y = (y * weight.to(acc) + bias.to(acc)).to(x.dtype)
    if apply_swish:
        y = y * torch.sigmoid(y)
    if return_stats:
        return y, mean.reshape(b, num_groups), rstd.reshape(b, num_groups)
    return y


def gn_swish_reference(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int = 32,
    eps: float = 1e-5,
    apply_swish: bool = True,
    return_stats: bool = False,
):
    """Plain PyTorch version (the semantics of pallas_fused._pure_gn_swish);
    with `return_stats`, (y, mean, rstd), the statistics float32 [B, G]."""
    count(gn_swish_reference, "calls")
    return _gn_swish_math(x, weight, bias, num_groups, eps, apply_swish, return_stats)


gn_swish_reference.calls = 0


def gn_swish_backward_reference(x, dy, weight, bias, num_groups: int = 32, eps: float = 1e-5,
                                apply_swish: bool = True):
    """Plain version of the backward: (dx, dweight, dbias) by autograd of the
    plain forward's math, as the JAX package takes jax.vjp of
    `_pure_gn_swish`; each gradient in its input's dtype."""
    count(gn_swish_backward_reference, "calls")
    inputs = [t.detach().requires_grad_() for t in (x, weight, bias)]
    with torch.enable_grad():
        y = _gn_swish_math(*inputs, num_groups, eps, apply_swish)
    return torch.autograd.grad(y, inputs, dy)


gn_swish_backward_reference.calls = 0


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("gn_swish")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.srewd_gn_swish_fwd.argtypes = [p] * 6 + [i] * 9 + [ctypes.c_float, i, i, p]
        lib.srewd_gn_swish_fwd.restype = i
        lib.srewd_gn_swish_bwd.argtypes = [p] * 10 + [i] * 10 + [i, p]
        lib.srewd_gn_swish_bwd.restype = i
        lib.srewd_gn_max_clusters.argtypes = [i, i, i, i, i, ctypes.POINTER(i)]
        lib.srewd_gn_max_clusters.restype = i
        lib.srewd_gn_error_string.argtypes = [i]
        lib.srewd_gn_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: {lib.srewd_gn_error_string(err).decode()} ({err})")


def max_active_clusters(plan: GNPlan, dtype: torch.dtype, backward: bool) -> int:
    """How many of the plan's clusters the card holds at once
    (cudaOccupancyMaxActiveClusters)."""
    lib = _library()
    out = ctypes.c_int(0)
    _raise_on(lib, lib.srewd_gn_max_clusters(int(backward), _DTYPE_CODE[dtype], plan.cluster,
                                             plan.threads, plan.bytes_per_cta, ctypes.byref(out)),
              "cudaOccupancyMaxActiveClusters")
    return out.value


def _active_clusters(plan: GNPlan, dtype: torch.dtype, backward: bool) -> int:
    """max_active_clusters, asked once per plan; raises if it is 0: a cluster
    that does not fit the card must not be launched."""
    key = (plan, dtype, backward)
    n = _active.get(key)
    if n is None:
        n = max_active_clusters(plan, dtype, backward)
        if n == 0:
            raise RuntimeError(
                f"no cluster of {plan.cluster} blocks x {plan.bytes_per_cta} bytes of shared "
                f"memory x {plan.threads} threads fits this card "
                "(cudaOccupancyMaxActiveClusters returned 0)")
        _active[key] = n
    return n


def _check(name: str, x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           num_groups: int, pointer: bool = True) -> None:
    """What the kernels take. The custom op's fake runs it with `pointer`
    False: a fake tensor has shapes, dtypes and strides but no data."""
    if x.ndim != 4:
        raise ValueError(f"{name} expects NHWC [B,H,W,C], got {tuple(x.shape)}")
    c = x.shape[-1]
    if c % num_groups:
        raise ValueError(f"C={c} is not a multiple of num_groups={num_groups}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name} supports float32 and bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} expects NHWC-contiguous (channels_last) memory")
    if pointer and x.data_ptr() % 16:
        raise ValueError(f"{name}: x's data pointer is not 16-byte aligned")
    for pname, p in (("weight", weight), ("bias", bias)):
        if p.device != x.device or p.shape != (c,) or not p.is_contiguous():
            raise ValueError(f"{pname} must be a contiguous [C] tensor on {x.device}")
        if p.dtype != x.dtype:
            raise ValueError(f"{pname} must be in x's dtype {x.dtype}, got {p.dtype}")


def gn_swish(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int = 32,
    eps: float = 1e-5,
    apply_swish: bool = True,
    return_stats: bool = False,
):
    """GroupNorm(+Swish) of NHWC `x` [B,H,W,C]; weight/bias [C]; K3.

    CPU tensors take `gn_swish_reference`; CUDA tensors launch the kernel
    (float32 or bfloat16, NHWC-contiguous, weight and bias in x's dtype) or
    raise. With `return_stats` it returns (y, mean, rstd), the statistics
    float32 [B, G]; y is the same bit for bit with and without them.

    The Swish runs on the value already rounded to the storage dtype, in
    float32, and is rounded once; the plain version multiplies in the
    storage dtype. In bfloat16 the two can differ by one bf16 ulp.
    """
    if use_op(x) and not return_stats:
        return torch.ops.srewd.gn_swish(x, weight, bias, int(num_groups), float(eps),
                                        bool(apply_swish))
    if use_plain(x):
        return gn_swish_reference(x, weight, bias, num_groups, eps, apply_swish, return_stats)
    return _launch_forward(x, weight, bias, num_groups, eps, apply_swish, return_stats)


def _launch_forward(x, weight, bias, num_groups, eps, apply_swish, return_stats=False):
    """The forward kernel's launch on the current stream (the wrapper's CUDA
    route and the custom op's CUDA implementation); counts
    `gn_swish.launches`."""
    _check("gn_swish", x, weight, bias, num_groups)
    b, h, w, c = x.shape
    plan = gn_plan(x.shape, num_groups, x.dtype)
    lib = _library()
    _active_clusters(plan, x.dtype, False)
    y = torch.empty_like(x)
    mean = rstd = None
    if return_stats:
        mean = torch.empty((b, num_groups), dtype=torch.float32, device=x.device)
        rstd = torch.empty_like(mean)
    err = launch(
        x.device, lib.srewd_gn_swish_fwd,
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
        mean.data_ptr() if mean is not None else None,
        rstd.data_ptr() if rstd is not None else None,
        b, h * w, c, num_groups, plan.slice_channels, plan.cluster, plan.rows_per_cta,
        plan.threads, plan.bytes_per_cta, float(eps), int(apply_swish), _DTYPE_CODE[x.dtype])
    _raise_on(lib, err, "gn_swish launch")
    count(gn_swish)
    return (y, mean, rstd) if return_stats else y


gn_swish.launches = 0


@torch.library.custom_op("srewd::gn_swish", mutates_args=(), device_types="cuda")
def _gn_swish_op(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, num_groups: int,
                 eps: float, apply_swish: bool) -> torch.Tensor:
    """K3's forward as a graph node of an exported program."""
    return _launch_forward(x, weight, bias, num_groups, eps, apply_swish)


@_gn_swish_op.register_kernel("cpu")
def _(x, weight, bias, num_groups, eps, apply_swish):
    return gn_swish_reference(x, weight, bias, num_groups, eps, apply_swish)


@_gn_swish_op.register_fake
def _(x, weight, bias, num_groups, eps, apply_swish):
    if x.device.type == "cuda":
        _check("gn_swish", x, weight, bias, num_groups, pointer=False)
        # whether a plan exists does not depend on the batch, which may be symbolic
        gn_plan((1, *x.shape[1:]), num_groups, x.dtype)
    elif x.ndim != 4 or x.shape[-1] % num_groups:
        raise ValueError(f"gn_swish expects NHWC [B,H,W,C] with C a multiple of "
                         f"num_groups={num_groups}, got {tuple(x.shape)}")
    return torch.empty_like(x)


def gn_swish_backward(x, dy, weight, bias, mean, rstd, num_groups: int = 32,
                      apply_swish: bool = True):
    """(dx, dweight, dbias) of gn_swish for the output gradient `dy`; the
    backward kernel (two launches: dx, then dweight and dbias).

    `mean` and `rstd` are the forward's float32 [B, G] statistics for the
    same x. CUDA tensors only: the backward's plain version is
    `gn_swish_backward_reference`, which `GNSwishFn` takes itself. dx comes
    in x's dtype, dweight and dbias in weight's.
    """
    if x.device.type != "cuda":
        raise RuntimeError(f"gn_swish_backward launches a CUDA kernel; got {x.device}")
    _check("gn_swish_backward", x, weight, bias, num_groups)
    b, h, w, c = x.shape
    if mean.shape != (b, num_groups) or rstd.shape != (b, num_groups) or \
            mean.dtype != torch.float32 or rstd.dtype != torch.float32:
        raise ValueError("mean and rstd must be float32 [B, G], from the forward")
    dy = dy.to(x.dtype).contiguous()
    mean, rstd = mean.contiguous(), rstd.contiguous()
    if dy.shape != x.shape or dy.data_ptr() % 16:
        raise ValueError("dy must have x's shape and a 16-byte aligned data pointer")
    plan = gn_plan(x.shape, num_groups, x.dtype, backward=True)
    lib = _library()
    _active_clusters(plan, x.dtype, True)
    dx = torch.empty_like(x)
    ws = torch.empty((b, 2, c), dtype=torch.float32, device=x.device)
    dweight = torch.empty(c, dtype=torch.float32, device=x.device)
    dbias = torch.empty_like(dweight)
    err = launch(
        x.device, lib.srewd_gn_swish_bwd,
        x.data_ptr(), dy.data_ptr(), weight.data_ptr(), bias.data_ptr(), mean.data_ptr(),
        rstd.data_ptr(), dx.data_ptr(), ws.data_ptr(), dweight.data_ptr(), dbias.data_ptr(),
        b, h * w, c, num_groups, plan.slice_channels, plan.cluster, plan.rows_per_cta,
        plan.threads, plan.bytes_per_cta, int(apply_swish), _DTYPE_CODE[x.dtype])
    _raise_on(lib, err, "gn_swish_backward launch")
    count(gn_swish_backward)
    return dx, dweight.to(weight.dtype), dbias.to(bias.dtype)


gn_swish_backward.launches = 0


class GNSwishFn(torch.autograd.Function):
    """gn_swish forward (keeping the statistics) and its backward kernel; on
    the plain route, `gn_swish_reference` and `gn_swish_backward_reference`."""

    @staticmethod
    def forward(ctx, x, weight, bias, num_groups, eps, apply_swish):
        ctx.cfg = (num_groups, eps, apply_swish)
        ctx.plain = use_plain(x)
        if ctx.plain:
            ctx.save_for_backward(x, weight, bias)
            return gn_swish_reference(x, weight, bias, num_groups, eps, apply_swish)
        y, mean, rstd = gn_swish(x, weight, bias, num_groups, eps, apply_swish, return_stats=True)
        ctx.save_for_backward(x, weight, bias, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, g):
        num_groups, eps, apply_swish = ctx.cfg
        if ctx.plain:
            x, weight, bias = ctx.saved_tensors
            grads = gn_swish_backward_reference(x, g, weight, bias, num_groups, eps, apply_swish)
        else:
            x, weight, bias, mean, rstd = ctx.saved_tensors
            grads = gn_swish_backward(x, g, weight, bias, mean, rstd, num_groups, apply_swish)
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
