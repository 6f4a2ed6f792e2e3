"""Exact attention [B,N,D] -> [B,N,D] and its gradient: the CUDA kernels and
their plain versions.

K1, the forward, replaces the TPU kernel `flash_attention` of
srewd_tpu/ops/flash_attention.py; K2, the backward, replaces `_flash_bwd`
there. The kernels, their designs and what bounds them are described in
csrc/flash_attention.cu and csrc/flash_attention_bwd.cu; both are built by
ops/_build.py and bound with ctypes.

The wrappers pass q, k and v as strided views: unit stride along D, any
batch and row stride whose size in bytes, like the data pointer, is a
multiple of 16 (the kernels load tiles by TMA, whose tensor maps need
that; `_check_qkv` raises otherwise). The 1x1 qkv (self-attention, row
stride 3C) and kv (cross-attention, row stride 2C) convolutions therefore
feed the kernels without a copy, and autograd's view handling routes the
gradients of the views back into the convolutions' output slabs.

`flash_attention_trainable` is what the model calls: with grad enabled it
goes through `FlashAttentionFn` (K1 saving the row log-sum-exp, then K2 in
the backward), as the JAX package's `flash_attention_trainable` carries its
custom VJP; otherwise it is the bare forward. While torch.export traces the
bare forward it calls the custom op `srewd::flash_attention` instead (see
ops/__init__.py): its CUDA implementation is the launch below, its CPU one
`attention_reference`, and its fake runs `_check_qkv`, so a shape K1 does
not take fails when a program is exported, not when it is served. Whether the plain versions
run is decided in the forward (a CPU tensor, or inside `reference_ops()`)
and kept for the backward, which autograd may run on another thread.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, count, launch, use_op, use_plain

SUPPORTED_D = (64, 128, 256, 512)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_fwd_lib = None
_bwd_lib = None


def _acc(t: torch.Tensor) -> torch.dtype:
    """The plain versions' accumulation dtype: float32, or float64 for
    float64 inputs (chip_smoke.py's float64 reference gradients)."""
    return torch.promote_types(t.dtype, torch.float32)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float) -> torch.Tensor:
    """Plain PyTorch version, with the TPU kernel's numerics: float32 scores
    and softmax, P cast to V's dtype before P V, float32 sums, output in
    Q's dtype."""
    count(attention_reference, "calls")
    acc = _acc(q)
    s = torch.einsum("bid,bjd->bij", q.to(acc), k.to(acc)) * scale
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bij,bjd->bid", p.to(acc), v.to(acc)).to(q.dtype)


attention_reference.calls = 0


def attention_backward_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 do: torch.Tensor, scale: float):
    """Plain version of the backward, the math of the TPU `_bwd_kernel`:
    full-row float32 P, dP = dO V^T, Δ = rowsum(P ∘ dP), dS = P ∘ (dP - Δ)
    * scale, dQ = dS K, dK = dS^T Q, dV = P^T dO, all in float32, each cast
    to its input's dtype."""
    count(attention_backward_reference, "calls")
    acc = _acc(q)
    qf, kf, vf, dof = q.to(acc), k.to(acc), v.to(acc), do.to(acc)
    p = torch.softmax(torch.einsum("bid,bjd->bij", qf, kf) * scale, dim=-1)
    dp = torch.einsum("bid,bjd->bij", dof, vf)
    delta = (p * dp).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta) * scale
    dq = torch.einsum("bij,bjd->bid", ds, kf)
    dk = torch.einsum("bij,bid->bjd", ds, qf)
    dv = torch.einsum("bij,bid->bjd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


attention_backward_reference.calls = 0


def _library():
    global _fwd_lib
    if _fwd_lib is None:
        lib = _build.load("flash_attention")
        lib.srewd_flash_attention_fwd.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.srewd_flash_attention_fwd.restype = ctypes.c_int
        lib.srewd_cuda_error_string.argtypes = [ctypes.c_int]
        lib.srewd_cuda_error_string.restype = ctypes.c_char_p
        _fwd_lib = lib
    return _fwd_lib


def bind_bwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """`lib` (a build of csrc/flash_attention_bwd.cu) with its C entry
    points' argument and result types set."""
    lib.srewd_flash_attention_bwd.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.srewd_flash_attention_bwd.restype = ctypes.c_int
    lib.srewd_cuda_error_string_bwd.argtypes = [ctypes.c_int]
    lib.srewd_cuda_error_string_bwd.restype = ctypes.c_char_p
    return lib


def _bwd_library():
    global _bwd_lib
    if _bwd_lib is None:
        _bwd_lib = bind_bwd(_build.load("flash_attention_bwd"))
    return _bwd_lib


def _check_qkv(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               pointers: bool = True) -> None:
    """What K1 and K2 take. The custom op's fake runs it with `pointers`
    False: a fake tensor has shapes, dtypes and strides but no data."""
    if q.ndim != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"{name} expects equal [B,N,D] shapes, got "
            f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}"
        )
    if q.shape[2] not in SUPPORTED_D:
        raise ValueError(f"{name} supports D in {SUPPORTED_D}, got {q.shape[2]}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name} needs one dtype of float32/bfloat16, got "
                         f"{q.dtype} {k.dtype} {v.dtype}")
    for t in (k, v):
        if t.device != q.device:
            raise ValueError("q, k and v must be on one device")
    for tname, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(2) != 1:
            raise ValueError(f"{tname} needs unit stride along D")
        _check_aligned(name, tname, t, pointers)


def _check_aligned(name: str, tname: str, t: torch.Tensor, pointer: bool = True) -> None:
    """The kernels load tiles by TMA, whose tensor maps take a 16-byte
    aligned base and strides: the data pointer (unless `pointer` is False)
    and the batch and row strides, in bytes, must be multiples of 16. No
    copy is made for a tensor that is not."""
    isz = t.element_size()
    if pointer and t.data_ptr() % 16:
        raise ValueError(f"{name}: {tname}'s data pointer is not 16-byte aligned "
                         f"(storage offset {t.storage_offset()} elements)")
    for dim in (0, 1):
        if (t.stride(dim) * isz) % 16:
            raise ValueError(f"{name}: {tname}'s stride along dim {dim} is {t.stride(dim)} "
                             f"elements, not a multiple of 16 bytes")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                    return_lse: bool = False):
    """softmax(scale * q k^T) v for [B,N,D] q, k, v (single head); K1.

    CPU tensors take `attention_reference`; CUDA tensors launch the kernel
    (float32 or bfloat16, D in SUPPORTED_D) or raise. With `return_lse`
    (CUDA only) it returns (o, lse, o32), lse the rows' float32 log-sum-exp
    of the scaled scores, [B,N], and o32 O in float32 before its rounding
    (o itself for float32 inputs): what the backward, K2, takes.
    """
    if use_op(q) and not return_lse:
        return torch.ops.srewd.flash_attention(q, k, v, float(scale))
    if use_plain(q):
        if return_lse:
            raise ValueError("the row log-sum-exp is an output of the CUDA kernel only")
        return attention_reference(q, k, v, scale)
    return _launch_forward(q, k, v, scale, return_lse)


def _launch_forward(q, k, v, scale, return_lse=False):
    """K1's launch on the current stream (the wrapper's CUDA route and the
    custom op's CUDA implementation); counts `flash_attention.launches`."""
    _check_qkv("flash_attention", q, k, v)
    b, n, d = q.shape
    lib = _library()
    o = torch.empty((b, n, d), dtype=q.dtype, device=q.device)
    lse = o32 = None
    if return_lse:
        lse = torch.empty((b, n), dtype=torch.float32, device=q.device)
        o32 = o if q.dtype == torch.float32 else torch.empty(
            (b, n, d), dtype=torch.float32, device=q.device)
    err = launch(
        q.device, lib.srewd_flash_attention_fwd,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        o32.data_ptr() if o32 is not None and o32 is not o else None,
        b, n, d,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        float(scale), _DTYPE_CODE[q.dtype],
    )
    if err != 0:
        msg = lib.srewd_cuda_error_string(err).decode()
        raise RuntimeError(f"flash_attention launch failed: {msg} ({err})")
    count(flash_attention)
    return (o, lse, o32) if return_lse else o


flash_attention.launches = 0


@torch.library.custom_op("srewd::flash_attention", mutates_args=(), device_types="cuda")
def _flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float) -> torch.Tensor:
    """K1's forward as a graph node of an exported program."""
    return _launch_forward(q, k, v, scale)


@_flash_attention_op.register_kernel("cpu")
def _(q, k, v, scale):
    return attention_reference(q, k, v, scale)


@_flash_attention_op.register_fake
def _(q, k, v, scale):
    if q.device.type == "cuda":
        _check_qkv("flash_attention", q, k, v, pointers=False)
    elif q.ndim != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention expects equal [B,N,D] shapes, got "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    return q.new_empty(q.shape)


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                             scale: float):
    """(dq, dk, dv) of flash_attention for the output gradient `do`; K2.

    `o` and `lse` are K1's float32 output (`o32` of its training outputs)
    and row log-sum-exp for the same q, k, v; an `o` in another dtype is
    taken in float32 as it is. CUDA tensors only: the backward's plain
    version is `attention_backward_reference`, which `FlashAttentionFn`
    takes itself.
    """
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention_backward launches a CUDA kernel; got {q.device}")
    _check_qkv("flash_attention_backward", q, k, v)
    b, n, d = q.shape
    if o.shape != q.shape or lse.shape != (b, n) or lse.dtype != torch.float32:
        raise ValueError("o must be [B,N,D] and lse float32 [B,N], from the forward")
    o = o.float().contiguous()
    do = do.to(q.dtype).contiguous()
    lse = lse.contiguous()
    _check_aligned("flash_attention_backward", "do", do)
    lib = _bwd_library()
    dq = torch.empty((b, n, d), dtype=q.dtype, device=q.device)
    dk = torch.empty_like(dq)
    dv = torch.empty_like(dq)
    delta = torch.empty((b, n), dtype=torch.float32, device=q.device)
    err = launch(
        q.device, lib.srewd_flash_attention_bwd,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, n, d,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        float(scale), _DTYPE_CODE[q.dtype],
    )
    if err != 0:
        msg = lib.srewd_cuda_error_string_bwd(err).decode()
        raise RuntimeError(f"flash_attention_backward launch failed: {msg} ({err})")
    count(flash_attention_backward)
    return dq, dk, dv


flash_attention_backward.launches = 0


class FlashAttentionFn(torch.autograd.Function):
    """K1 forward (saving the row log-sum-exp and the float32 O) and K2
    backward; on the plain
    route, `attention_reference` and `attention_backward_reference`."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.scale = float(scale)
        ctx.plain = use_plain(q)
        if ctx.plain:
            ctx.save_for_backward(q, k, v)
            return attention_reference(q, k, v, scale)
        o, lse, o32 = flash_attention(q, k, v, scale, return_lse=True)
        ctx.save_for_backward(q, k, v, o32, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        if ctx.plain:
            q, k, v = ctx.saved_tensors
            dq, dk, dv = attention_backward_reference(q, k, v, do, ctx.scale)
        else:
            q, k, v, o32, lse = ctx.saved_tensors
            dq, dk, dv = flash_attention_backward(q, k, v, o32, lse, do, ctx.scale)
        return dq, dk, dv, None


def flash_attention_trainable(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              scale: float) -> torch.Tensor:
    """flash_attention that autograd can differentiate: through
    `FlashAttentionFn` when grad is enabled and an input needs it, else the
    bare forward (sampling runs under no_grad and saves nothing)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, scale)
    return flash_attention(q, k, v, scale)
