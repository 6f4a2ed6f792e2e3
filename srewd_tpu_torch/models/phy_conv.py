"""PhyConv: a learnable bank of stencils (port of srewd_tpu/models/phy_conv.py).

The reference keeps it but leaves it unused (phydiff/unet.py:11-137,
constrain_moments.py:1-5), as does the JAX package: nothing in the model
factory builds it. `kernels` [n_filters, k, k] are applied with reflect
padding to the coarsest level of a bilinear x0.5 pyramid of the condition's
first `in_channels` channels, a 1x1 convolution projects the response to
one channel, and the kernels' moment matrices (ops/moments.k2m) come back
beside it, for `moment_constraint_loss` to pin each kernel to a derivative
order.

Reflect padding is a gather through an index map built in numpy by
`np.pad(mode="reflect")`: it reflects again where the pad is as large as
the field (a 32x64 field at levels=4 ends at 2x4 and a 5x5 stencil pads
2), as jnp.pad does, where torch's reflect pad raises.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.moments import k2m
from ..ops.resize import resize2d
from .layers import Conv2d


@lru_cache(maxsize=None)
def _reflect_index(n: int, pad: int) -> np.ndarray:
    """Source index of each position of a length-n axis reflect-padded by
    `pad` on both sides (numpy's and jnp's "reflect", repeated as needed)."""
    return np.pad(np.arange(n), pad, mode="reflect")


def reflect_pad2d(x: torch.Tensor, pad: int) -> torch.Tensor:
    """NCHW x reflect-padded by `pad` on both sides of H and W."""
    if pad == 0:
        return x
    rows = torch.from_numpy(_reflect_index(x.shape[-2], pad)).to(x.device)
    cols = torch.from_numpy(_reflect_index(x.shape[-1], pad)).to(x.device)
    return x.index_select(-2, rows).index_select(-1, cols)


class PhyConv(nn.Module):
    """NHWC in and out, as JAX's and the port's other modules' interfaces
    (the convolutions run on an NCHW view inside): x [B, H, W, C >=
    in_channels] -> (the coarsest level's one-channel response [B, H / 2^levels,
    W / 2^levels, 1], the moments of `kernels` [n_filters, k, k], float32).

    The stencil convolution is depthwise (groups=in_channels): each input
    channel meets every kernel. JAX's filter bank takes in_channels=1 only
    (its tiled bank does not fit its group count otherwise); there the two
    agree. `dtype` is the compute dtype of the 1x1 projection (None: the
    input's), whose weights are cast per call (models/layers.py); the
    parameters stay float32.
    """

    def __init__(self, n_filters: int = 3, kernel_size: int = 5, in_channels: int = 1,
                 levels: int = 4, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.n_filters = n_filters
        self.kernel_size = kernel_size
        self.in_channels = in_channels
        self.levels = levels
        self.dtype = dtype
        self.kernels = nn.Parameter(torch.randn(n_filters, kernel_size, kernel_size) * 0.02)
        self.conv = Conv2d(in_channels * n_filters, 1, 1)

    def forward(self, x: torch.Tensor) -> tuple:
        img = x[..., : self.in_channels]
        for _ in range(self.levels):
            img = resize2d(img, (img.shape[1] // 2, img.shape[2] // 2), "bilinear")
        k = self.kernel_size
        y = reflect_pad2d(img.permute(0, 3, 1, 2), (k - 1) // 2)
        bank = self.kernels.repeat(self.in_channels, 1, 1)[:, None].to(y.dtype)
        y = F.conv2d(y, bank, groups=self.in_channels)
        out = self.conv(y.to(self.dtype or y.dtype))
        return out.permute(0, 2, 3, 1), k2m(self.kernels)
