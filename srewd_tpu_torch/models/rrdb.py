"""RRDBNet, SRDiff's encoder (port of srewd_tpu/models/rrdb.py).

The input is remapped [-1,1] -> [0,1] at entry and back at exit;
`get_fea=True` also returns the per-block feature maps (NHWC) that the
srdiff and physrdiff UNets take every third of (`feats[2::3]`).
`clamp_output` clamps the SR output to [0,1] before the remap, the
reference's behaviour; every training and factory path builds it False
(the clamp saturates sigma-scaled fields and zeroes their gradients).

Attribute names are the reference's (`conv_first`, `RRDB_trunk.{i}.RDB{r}.
conv{c}`, `trunk_conv`, `upconv1`, `upconv2`, `HRconv`, `conv_last`).
`dtype` is the compute dtype, as in models/simple_cnn.py.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .simple_cnn import conv_in


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


class ResidualDenseBlock5C(nn.Module):
    def __init__(self, nf: int = 64, gc: int = 32):
        super().__init__()
        self.conv1 = nn.Conv2d(nf, gc, 3, padding=1)
        self.conv2 = nn.Conv2d(nf + gc, gc, 3, padding=1)
        self.conv3 = nn.Conv2d(nf + 2 * gc, gc, 3, padding=1)
        self.conv4 = nn.Conv2d(nf + 3 * gc, gc, 3, padding=1)
        self.conv5 = nn.Conv2d(nf + 4 * gc, nf, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = _lrelu(conv_in(self.conv1, x))
        x2 = _lrelu(conv_in(self.conv2, torch.cat([x, x1], 1)))
        x3 = _lrelu(conv_in(self.conv3, torch.cat([x, x1, x2], 1)))
        x4 = _lrelu(conv_in(self.conv4, torch.cat([x, x1, x2, x3], 1)))
        x5 = conv_in(self.conv5, torch.cat([x, x1, x2, x3, x4], 1))
        return x5 * 0.2 + x


class RRDB(nn.Module):
    def __init__(self, nf: int = 64, gc: int = 32):
        super().__init__()
        self.RDB1 = ResidualDenseBlock5C(nf, gc)
        self.RDB2 = ResidualDenseBlock5C(nf, gc)
        self.RDB3 = ResidualDenseBlock5C(nf, gc)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.RDB3(self.RDB2(self.RDB1(x))) * 0.2 + x


class RRDBNet(nn.Module):
    def __init__(self, in_nc: int = 1, out_nc: int = 1, nf: int = 64, nb: int = 17,
                 gc: int = 32, dtype: Optional[torch.dtype] = None,
                 clamp_output: bool = True):
        super().__init__()
        self.dtype = dtype
        self.clamp_output = clamp_output
        self.conv_first = nn.Conv2d(in_nc, nf, 3, padding=1)
        self.RRDB_trunk = nn.Sequential(*[RRDB(nf, gc) for _ in range(nb)])
        self.trunk_conv = nn.Conv2d(nf, nf, 3, padding=1)
        self.upconv1 = nn.Conv2d(nf, nf, 3, padding=1)
        self.upconv2 = nn.Conv2d(nf, nf, 3, padding=1)
        self.HRconv = nn.Conv2d(nf, nf, 3, padding=1)
        self.conv_last = nn.Conv2d(nf, out_nc, 3, padding=1)

    def forward(self, x: torch.Tensor, get_fea: bool = False):
        """x [B,h,w,C] in [-1,1] -> SR [B,4h,4w,C] (and the feature maps,
        each [B,h,w,nf], when get_fea)."""
        x = ((x + 1.0) / 2.0).to(self.dtype or x.dtype).permute(0, 3, 1, 2)
        x = x.contiguous(memory_format=torch.channels_last)
        feas = []
        fea_first = fea = conv_in(self.conv_first, x)
        for block in self.RRDB_trunk:
            fea = block(fea)
            feas.append(fea)
        fea = fea_first + conv_in(self.trunk_conv, fea)
        feas.append(fea)
        fea = _lrelu(conv_in(self.upconv1, F.interpolate(fea, scale_factor=2, mode="nearest")))
        fea = _lrelu(conv_in(self.upconv2, F.interpolate(fea, scale_factor=2, mode="nearest")))
        out = conv_in(self.conv_last, _lrelu(conv_in(self.HRconv, fea)))
        if self.clamp_output:
            out = out.clamp(0.0, 1.0)
        out = (out * 2.0 - 1.0).permute(0, 2, 3, 1)
        if get_fea:
            return out, [f.permute(0, 2, 3, 1) for f in feas]
        return out
