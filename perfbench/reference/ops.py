"""Plain operations of the reference models, on NCHW tensors unless said.

Each follows the published layer it stands for; where the port's JAX
original fixed a convention (Haar subband order, the stencils' reflect
padding, bicubic with A = -0.75 and clamped taps), it is written out here
from that description. Every matrix product's operands pass through
`numerics.mm_in`, so the controls can lower their precision.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from .numerics import mm_in, mm_out


def conv2d(x, weight, bias=None, stride=1, padding=0):
    return mm_out(F.conv2d(mm_in(x), mm_in(weight), bias, stride, padding))


def conv_transpose2d(x, weight, bias, stride, padding):
    return mm_out(F.conv_transpose2d(mm_in(x), mm_in(weight), bias, stride, padding))


def linear(x, weight, bias=None):
    return mm_out(F.linear(mm_in(x), mm_in(weight), bias))


def attention(q, k, v, scale: float):
    """softmax(q k^T scale) v over [B, N, D]; the call shapes are what the
    operation counts of K1 and K2 read (`work/`)."""
    _record("attention", b=q.shape[0], n=q.shape[1], d=q.shape[2], dtype=q.dtype)
    s = mm_out(torch.einsum("bid,bjd->bij", mm_in(q), mm_in(k))) * scale
    p = torch.softmax(s, dim=-1)
    return mm_out(torch.einsum("bij,bjd->bid", mm_in(p), mm_in(v)))


def group_norm(x, weight, bias, groups: int, eps: float = 1e-5, swish: bool = False):
    """GroupNorm over (channels of a group, H, W), biased variance, then the
    affine map and optionally x * sigmoid(x)."""
    _record("group_norm", numel=x.numel(), c=x.shape[1], swish=swish, dtype=x.dtype)
    y = F.group_norm(x, groups, weight, bias, eps)
    return y * torch.sigmoid(y) if swish else y


# ------------------------------------------------------------ call records
# `work/` counts the kernels' operations from the reference's own calls on
# the meta device: a recorder collects (kind, shape) while it is open.
_RECORDERS: list = []


def _record(kind: str, **shape) -> None:
    for rec in _RECORDERS:
        rec.append((kind, shape))


class record_calls:
    """Collects the attention and group-norm calls made inside it."""

    def __enter__(self):
        self.calls: list = []
        _RECORDERS.append(self.calls)
        return self.calls

    def __exit__(self, *exc):
        _RECORDERS.remove(self.calls)


# ------------------------------------------------------------ image ops (NHWC)
def haar_pyramid(x, levels: int = 4):
    """Orthonormal 2-D Haar DWT of NHWC fields, `levels` deep; each level's
    three detail bands (rows-high, cols-high, both) concatenated on the
    channel axis, [B, H/2^j, W/2^j, 3C]."""
    out = []
    ll = x
    for _ in range(levels):
        b, h, w, c = ll.shape
        blk = ll.reshape(b, h // 2, 2, w // 2, 2, c)
        a, bb = blk[:, :, 0, :, 0], blk[:, :, 0, :, 1]
        cc, d = blk[:, :, 1, :, 0], blk[:, :, 1, :, 1]
        ll = (a + bb + cc + d) * 0.5
        out.append(torch.cat([(a + bb - cc - d) * 0.5, (a - bb + cc - d) * 0.5,
                              (a - bb - cc + d) * 0.5], dim=-1))
    return out


def stencils(x):
    """[B,H,W,C] -> [B,H,W,3]: forward differences along W and H and the
    5-point Laplacian of the channel sum, reflect-padded by one."""
    s = x.float().sum(dim=-1)
    p = F.pad(s[:, None], (1, 1, 1, 1), mode="reflect")[:, 0]
    c = p[:, 1:-1, 1:-1]
    right, left = p[:, 1:-1, 2:], p[:, 1:-1, :-2]
    down, up = p[:, 2:, 1:-1], p[:, :-2, 1:-1]
    return torch.stack([right - c, down - c, up + down + left + right - 4.0 * c], dim=-1)


@functools.lru_cache(maxsize=8)
def _cubic_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] bicubic resampling (Keys, A = -0.75, half-pixel
    centres, taps clamped at the edges), as F.interpolate(bicubic,
    align_corners=False) computes it."""
    def kern(t):
        t = abs(t)
        if t <= 1.0:
            return (1.25 * t - 2.25) * t * t + 1.0
        if t < 2.0:
            return ((-0.75 * t + 3.75) * t - 6.0) * t + 3.0
        return 0.0

    m = np.zeros((n_out, n_in))
    for o in range(n_out):
        s = (o + 0.5) * n_in / n_out - 0.5
        i = math.floor(s)
        for tap in range(i - 1, i + 3):
            m[o, min(max(tap, 0), n_in - 1)] += kern(s - tap)
    return m.astype(np.float32)


def bicubic_up4(x):
    """x4 bicubic upsample of NHWC fields, as two matrix products."""
    _, h, w, _ = x.shape
    wh = torch.from_numpy(_cubic_matrix(h, 4 * h)).to(x.device)
    ww = torch.from_numpy(_cubic_matrix(w, 4 * w)).to(x.device)
    out = mm_out(torch.einsum("oh,bhwc->bowc", mm_in(wh), mm_in(x.float())))
    return mm_out(torch.einsum("ow,bhwc->bhoc", mm_in(ww), mm_in(out)))
