"""Exact attention [B,N,D] -> [B,N,D]: the CUDA kernel and its plain version.

Replaces the TPU kernel `flash_attention` of srewd_tpu/ops/flash_attention.py.
The kernel itself, its design and what bounds it are described in
csrc/flash_attention.cu; it is built by ops/_build.py and bound with ctypes.

The wrapper passes q, k and v as strided views: unit stride along D, any
batch and row stride. The 1x1 qkv (self-attention, row stride 3C) and kv
(cross-attention, row stride 2C) convolutions therefore feed the kernel
without a copy.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, use_plain

SUPPORTED_D = (64, 128, 256, 512)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float) -> torch.Tensor:
    """Plain PyTorch version, with the TPU kernel's numerics: float32 scores
    and softmax, P cast to V's dtype before P V, float32 sums, output in
    Q's dtype."""
    attention_reference.calls += 1
    s = torch.einsum("bid,bjd->bij", q.float(), k.float()) * scale
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bij,bjd->bid", p.float(), v.float()).to(q.dtype)


attention_reference.calls = 0


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("flash_attention")
        lib.srewd_flash_attention_fwd.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.srewd_flash_attention_fwd.restype = ctypes.c_int
        lib.srewd_cuda_error_string.argtypes = [ctypes.c_int]
        lib.srewd_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """softmax(scale * q k^T) v for [B,N,D] q, k, v (single head).

    CPU tensors take `attention_reference`; CUDA tensors launch the kernel
    (float32 or bfloat16, D in SUPPORTED_D) or raise.
    """
    if use_plain(q):
        return attention_reference(q, k, v, scale)
    if q.ndim != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"flash_attention expects equal [B,N,D] shapes, got "
            f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}"
        )
    b, n, d = q.shape
    if d not in SUPPORTED_D:
        raise ValueError(f"flash_attention supports D in {SUPPORTED_D}, got {d}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention needs one dtype of float32/bfloat16, got "
                         f"{q.dtype} {k.dtype} {v.dtype}")
    for t in (k, v):
        if t.device != q.device:
            raise ValueError("q, k and v must be on one device")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(2) != 1:
            raise ValueError(f"{name} needs unit stride along D")
    lib = _library()
    o = torch.empty((b, n, d), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = lib.srewd_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            b, n, d,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
            float(scale), _DTYPE_CODE[q.dtype], torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        msg = lib.srewd_cuda_error_string(err).decode()
        raise RuntimeError(f"flash_attention launch failed: {msg} ({err})")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
