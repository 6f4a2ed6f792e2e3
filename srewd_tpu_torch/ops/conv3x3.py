"""Float32 3x3 convolution, stride 1, padding 1, one group: the CUDA kernel
K4 and its plain version.

K4 replaces no TPU kernel (the JAX package leaves its convolutions to XLA):
it moves the forward of the UNets' and the RRDB's float32 3x3 convolutions
from cuDNN's CUDA-core algorithms onto the tensor cores, as a 3xTF32 implicit
GEMM on wgmma and TMA. csrc/conv3x3.cu describes the design; it is built by
ops/_build.py and bound with ctypes.

`routes` is the predicate `models/layers.py` `Conv2d` applies to every call:
float32 input and weight on a card (or while torch.export traces), a 3x3
kernel, stride 1, padding 1 (zeros), dilation 1, one group, Cin a multiple of
8 and Cout of 32, and a forward that builds no autograd graph. Such a call
goes to `conv3x3`; every other one (bf16, 1x1, stride 2, the 5-channel stem,
the 1-channel head, and every forward that records a graph for a backward)
to the layer's `_conv_forward`, as before. The output is an NCHW tensor in
channels_last memory, as the UNet holds its activations (an input in another
layout is copied into it first).

The test is whether the forward records an autograd graph, not whether a
model trains. A training step's forward records one and keeps cuDNN's
forward: K4 rounds differently from it (3xTF32 against FFMA), and over a
few training steps the loss drifts from the float32 reference's past the
training limit (4.2e-5 against 2.5e-5 on an H100), where a sampling chain
stays a hundredth under its own. A forward run under no_grad inside a
training step records none and takes K4: a locked encoder's
(`DiffusionModel._encoder_grad`), as in srdiff+rrdb_locked. While
torch.export traces,
`conv3x3` calls the custom op `srewd::conv3x3` instead (see ops/__init__.py):
its CUDA implementation is the launch below, its CPU one
`conv3x3_reference`, and its fake runs `_check`.

The kernel's B operand is the weight split into TF32 hi and lo parts,
[2][9][Cout][Cin] (`_weight_parts`; a small kernel launched by the same C
call makes them); the split is kept on the weight tensor and made again
only when the weight's data pointer or version changes, so sampling splits
each weight once. `conv3x3_plan` (pure Python) chooses the output-channel tile and the
split of the input channels over work items for small grids; the wrapper and
the CPU tests both use it.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from . import _build, count, launch, use_op, use_plain

TILE_H, TILE_W = 8, 16  # output pixels of a block's tile
CHUNK = 32  # input channels a stage
MAX_SPLITS = 8
SMS = 132  # an H100's SMs, for the plan on a CPU
_lib = None


class Conv3x3Plan(NamedTuple):
    bn: int  # output channels a block
    splits: int  # work items the input-channel chunks are split over
    tiles: int  # output tiles: pixel tiles x channel tiles
    chunks: int  # input-channel chunks of CHUNK
    items: int  # tiles x splits
    grid: int  # persistent blocks, at most one an SM


@functools.lru_cache(maxsize=None)
def conv3x3_plan(n: int, cin: int, cout: int, h: int, w: int, sms: int = SMS) -> Conv3x3Plan:
    """K4's tiling of a call: BN the widest of 128, 64, 32 that divides
    Cout. Where the tiles make less than one wave, the input-channel chunks
    are split over the work items that take the fewest waves per unit of
    work (the least split on a tie); otherwise nothing is split, since the
    persistent blocks walk the items and a split only adds the workspace's
    traffic."""
    bn = 128 if cout % 128 == 0 else 64 if cout % 64 == 0 else 32
    tiles = n * -(-h // TILE_H) * -(-w // TILE_W) * (cout // bn)
    chunks = -(-cin // CHUNK)
    splits, cost = 1, 1.0
    for s in range(2, min(chunks, MAX_SPLITS) + 1 if tiles < sms else 2):
        c = math.ceil(tiles * s / sms) / s
        if c < cost:
            splits, cost = s, c
    items = tiles * splits
    return Conv3x3Plan(bn, splits, tiles, chunks, items, min(items, sms))


def takes(weight: torch.Tensor, stride, padding, dilation, groups: int,
          padding_mode: str = "zeros") -> bool:
    """Whether a convolution of this weight and these settings has K4's
    shape: 3x3, stride 1, padding 1 (zeros), dilation 1, one group, Cin a
    multiple of 8 and Cout of 32."""
    return (weight.dim() == 4 and weight.shape[2] == 3 and weight.shape[3] == 3
            and groups == 1 and tuple(stride) == (1, 1) and tuple(padding) == (1, 1)
            and tuple(dilation) == (1, 1) and padding_mode == "zeros"
            and weight.shape[1] % 8 == 0 and weight.shape[0] % 32 == 0)


def routes(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], stride,
           padding, dilation, groups: int, padding_mode: str = "zeros") -> bool:
    """Whether K4 takes this call: float32 input and weight on a card (or
    while torch.export traces, `use_op`), 4-d, `takes`, and no autograd
    graph recorded (grad disabled, or nothing that needs a gradient)."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad or (
            bias is not None and bias.requires_grad)):
        return False  # first: a training forward pays only this check
    return (x.dtype == torch.float32 and weight.dtype == torch.float32
            and (x.device.type == "cuda" or use_op(x)) and x.dim() == 4
            and takes(weight, stride, padding, dilation, groups, padding_mode))


def conv3x3_reference(x: torch.Tensor, weight: torch.Tensor,
                      bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version: unfold and one matrix product, in float32 (or
    float64 for float64 inputs), channels_last output."""
    count(conv3x3_reference, "calls")
    acc = torch.promote_types(x.dtype, torch.float32)
    n, _, h, w = x.shape
    cols = F.unfold(x.to(acc), 3, padding=1)  # [N, Cin * 9, H * W], (c, ky, kx) order
    y = weight.to(acc).reshape(weight.shape[0], -1) @ cols
    if bias is not None:
        y = y + bias.to(acc)[:, None]
    return y.view(n, -1, h, w).to(x.dtype).contiguous(memory_format=torch.channels_last)


conv3x3_reference.calls = 0


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("conv3x3")
        lib.srewd_conv3x3_fwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [
            ctypes.c_void_p]
        lib.srewd_conv3x3_fwd.restype = ctypes.c_int
        lib.srewd_conv3x3_split_weights.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                                    ctypes.c_int, ctypes.c_int,
                                                    ctypes.c_void_p]
        lib.srewd_conv3x3_split_weights.restype = ctypes.c_int
        lib.srewd_cuda_error_string_conv3x3.argtypes = [ctypes.c_int]
        lib.srewd_cuda_error_string_conv3x3.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _raise(what: str, err: int) -> None:
    msg = _library().srewd_cuda_error_string_conv3x3(err).decode()
    raise RuntimeError(f"{what} launch failed: {msg} ({err})")


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor]) -> None:
    """What K4 takes: float32 [N, Cin, H, W] x and [Cout, Cin, 3, 3] weight on
    one device, Cin a multiple of 4 (TMA's 16-byte strides), Cout of 32, a
    float32 [Cout] bias or none."""
    if x.dim() != 4 or weight.dim() != 4 or tuple(weight.shape[2:]) != (3, 3) or (
            weight.shape[1] != x.shape[1]):
        raise ValueError(f"conv3x3 expects x [N, Cin, H, W] and weight [Cout, Cin, 3, 3], got "
                         f"{tuple(x.shape)} {tuple(weight.shape)}")
    if x.dtype != torch.float32 or weight.dtype != torch.float32 or (
            bias is not None and bias.dtype != torch.float32):
        raise ValueError(f"conv3x3 is float32 only, got {x.dtype} {weight.dtype}")
    if x.shape[1] % 4 or weight.shape[0] % 32:
        raise ValueError(f"conv3x3 needs Cin a multiple of 4 and Cout of 32, got "
                         f"{x.shape[1]} {weight.shape[0]}")
    if bias is not None and tuple(bias.shape) != (weight.shape[0],):
        raise ValueError(f"conv3x3's bias must be [Cout], got {tuple(bias.shape)}")
    for t in (weight, bias):
        if t is not None and t.device != x.device:
            raise ValueError("x, weight and bias must be on one device")


def _weight_parts(weight: torch.Tensor) -> tuple:
    """(parts, fresh): the [2][9][Cout][Cin] buffer of the weight's TF32 hi
    and lo parts (K4's B operand) kept on the weight (attribute
    `_srewd_k4_split`, with its data pointer and version), and whether the
    launch has to split the weight into it first: a new weight or version
    gets a new buffer."""
    key = None if weight.is_inference() else (weight.data_ptr(), weight._version)
    kept = getattr(weight, "_srewd_k4_split", None)
    if key is not None and kept is not None and kept[0] == key:
        return kept[1], False
    cout, cin = weight.shape[:2]
    return torch.empty((2, 9, cout, cin), dtype=torch.float32, device=weight.device), True


def conv3x3(x: torch.Tensor, weight: torch.Tensor,
            bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """conv2d(x, weight, bias, stride 1, padding 1) of float32 x [N, Cin, H,
    W] and weight [Cout, Cin, 3, 3]; K4. CPU tensors (and any inside
    `reference_ops()`) take `conv3x3_reference`; CUDA tensors launch the
    kernel or raise."""
    if use_op(x):
        return torch.ops.srewd.conv3x3(x, weight, bias)
    if use_plain(x):
        return conv3x3_reference(x, weight, bias)
    return _launch(x, weight, bias)


def _launch(x, weight, bias):
    """K4's launch on the current stream (the wrapper's CUDA route and the
    custom op's CUDA implementation); counts `conv3x3.launches`."""
    _check(x, weight, bias)
    n, cin, h, w = x.shape
    cout = weight.shape[0]
    x = x.contiguous(memory_format=torch.channels_last)
    if x.data_ptr() % 16:
        x = x.clone(memory_format=torch.channels_last)
    parts, fresh = _weight_parts(weight)
    raw = weight.detach().contiguous() if fresh else None
    plan = conv3x3_plan(n, cin, cout, h, w, _sms(x.device.index))
    out = torch.empty((n, cout, h, w), dtype=torch.float32, device=x.device,
                      memory_format=torch.channels_last)
    ws = None if plan.splits == 1 else torch.empty(
        (plan.splits, out.numel()), dtype=torch.float32, device=x.device)
    bias = None if bias is None else bias.contiguous()
    err = launch(x.device, _library().srewd_conv3x3_fwd, x.data_ptr(),
                 None if raw is None else raw.data_ptr(), parts.data_ptr(),
                 None if bias is None else bias.data_ptr(), out.data_ptr(),
                 None if ws is None else ws.data_ptr(), n, h, w, cin, cout, plan.bn,
                 plan.splits, plan.grid)
    if err != 0:
        _raise("conv3x3", err)
    count(conv3x3)
    if fresh:
        count(conv3x3, "weight_splits")
        if not weight.is_inference():
            weight._srewd_k4_split = ((weight.data_ptr(), weight._version), parts)
    return out


conv3x3.launches = 0
conv3x3.weight_splits = 0  # launches of the weight split (a new weight or version)


@torch.library.custom_op("srewd::conv3x3", mutates_args=(), device_types="cuda")
def _conv3x3_op(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor]) -> torch.Tensor:
    """K4 as a graph node of an exported program."""
    return _launch(x, weight, bias)


@_conv3x3_op.register_kernel("cpu")
def _(x, weight, bias):
    return conv3x3_reference(x, weight, bias)


@_conv3x3_op.register_fake
def _(x, weight, bias):
    _check(x, weight, bias)
    return torch.empty((x.shape[0], weight.shape[0], x.shape[2], x.shape[3]), dtype=x.dtype,
                       device=x.device, memory_format=torch.channels_last)
