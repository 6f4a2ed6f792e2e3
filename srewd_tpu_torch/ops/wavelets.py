"""Orthonormal 2-D Haar DWT as reshape + adds (port of srewd_tpu/ops/wavelets.py).

For the Haar wavelet on even-sized inputs each level is a 2x2 block
transform; subbands follow pywt (H = rows-high, V = cols-high, D = both).
"""

from __future__ import annotations

import torch


def haar_dwt2d(x: torch.Tensor):
    """Single-level 2-D Haar DWT of NHWC input with even H and W.

    Returns (ll, (h, v, d)), each [B, H/2, W/2, C].
    """
    b, h, w, c = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"haar_dwt2d requires even spatial dims, got {(h, w)}")
    blocks = x.reshape(b, h // 2, 2, w // 2, 2, c)
    a = blocks[:, :, 0, :, 0, :]
    bb = blocks[:, :, 0, :, 1, :]
    cc = blocks[:, :, 1, :, 0, :]
    d = blocks[:, :, 1, :, 1, :]
    ll = (a + bb + cc + d) * 0.5
    hh = (a + bb - cc - d) * 0.5
    vv = (a - bb + cc - d) * 0.5
    dd = (a - bb - cc + d) * 0.5
    return ll, (hh, vv, dd)


def haar_dwt_pyramid(x: torch.Tensor, levels: int = 4, combine: str = "concat") -> list:
    """J-level high-frequency pyramid (the cross-attention queries).

    combine="sum"    — H+V+D per level, [B, H/2^j, W/2^j, C] (resdiff)
    combine="concat" — channel-concat [H, V, D], [B, ., ., 3C] (phydiff,
                       physrdiff)
    combine="none"   — list of (H, V, D) tuples (the SimpleCNN loss)
    """
    out = []
    ll = x
    for _ in range(levels):
        ll, (hh, vv, dd) = haar_dwt2d(ll)
        if combine == "sum":
            out.append(hh + vv + dd)
        elif combine == "concat":
            out.append(torch.cat([hh, vv, dd], dim=-1))
        elif combine == "none":
            out.append((hh, vv, dd))
        else:
            raise ValueError(f"unknown combine: {combine}")
    return out
