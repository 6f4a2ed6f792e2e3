"""SimpleCNN, ResDiff's encoder (port of srewd_tpu/models/simple_cnn.py):
pixel_shuffle(conv3(relu(conv2(relu(conv1(x)))))) + bicubic_up4(x).

Attribute names are the reference's (`conv1`, `conv2`, `conv3`); the pixel
shuffle uses torch's channel order on both sides. NHWC in and out.

`dtype` is the compute dtype (None: the weights' float32): the input and
each convolution's weights are cast to it per call and the weights are
never cast in place, as flax's `dtype` computes over float32 params.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.resize import bicubic_up4


def conv_in(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """`conv` applied in x's dtype (the weights cast per call when they differ)."""
    w, b = conv.weight, conv.bias
    if w.dtype != x.dtype:
        w, b = w.to(x.dtype), None if b is None else b.to(x.dtype)
    return F.conv2d(x, w, b, conv.stride, conv.padding)


class SimpleCNN(nn.Module):
    def __init__(self, scale_factor: int = 4, channels: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if scale_factor != 4:
            raise ValueError("the port's SimpleCNN upsamples x4 (bicubic_up4)")
        self.scale_factor = scale_factor
        self.dtype = dtype
        self.conv1 = nn.Conv2d(channels, 64, 3, padding=1)
        self.conv2 = nn.Conv2d(64, 32, 3, padding=1)
        self.conv3 = nn.Conv2d(32, channels * scale_factor**2, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B,h,w,C] -> [B,4h,4w,C]."""
        x_up = bicubic_up4(x)
        h = x.to(self.dtype or x.dtype).permute(0, 3, 1, 2)
        h = F.relu(conv_in(self.conv1, h))
        h = F.relu(conv_in(self.conv2, h))
        h = F.pixel_shuffle(conv_in(self.conv3, h), self.scale_factor)
        return h.permute(0, 2, 3, 1) + x_up
