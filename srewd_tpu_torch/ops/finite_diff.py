"""Fixed finite-difference stencils of phydiff (port of srewd_tpu/ops/finite_diff.py)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def fd_stencils(x: torch.Tensor) -> torch.Tensor:
    """[B,H,W,C] -> [B,H,W,3]: (d/dx, d/dy, laplacian), summed over channels.

    Forward differences and the 5-point Laplacian of the channel sum, after
    reflect padding of 1, computed in float32 and cast back to x's dtype.
    """
    xs = x.float().sum(dim=-1)  # [B,H,W]
    p = F.pad(xs[:, None], (1, 1, 1, 1), mode="reflect")[:, 0]
    center = p[:, 1:-1, 1:-1]
    right = p[:, 1:-1, 2:]
    left = p[:, 1:-1, :-2]
    down = p[:, 2:, 1:-1]
    up = p[:, :-2, 1:-1]
    ddx = right - center
    ddy = down - center
    lap = up + down + left + right - 4.0 * center
    return torch.stack([ddx, ddy, lap], dim=-1).to(x.dtype)
