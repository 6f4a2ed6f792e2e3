"""Shared UNet blocks (port of srewd_tpu/models/blocks.py) as torch modules.

Activations are NCHW tensors in channels_last memory: convolutions take them
as they are, and `x.permute(0, 2, 3, 1)` is an NHWC view without a copy,
which is the layout both kernels read. Attribute names follow the reference
torch modules (resnet.py, guided_cross_attention.py), which are also the
names srewd_tpu/utils/torch_convert.py reads.

Left out on purpose: the TPU-only paired / space-to-depth conv plumbing, the
SPMD-mesh kernel routing and the HBM-slab chunking of the attention.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.flash_attention import flash_attention_trainable
from ..ops.fused_groupnorm import gn_swish_trainable
from ..ops.resize import upsample_nearest2x


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    """NHWC view of an NCHW channels_last tensor (copies only if needed)."""
    return x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """NCHW view of an NHWC-contiguous tensor (channels_last memory)."""
    return x.permute(0, 3, 1, 2)


class PositionalEncoding(nn.Module):
    """WaveGrad-style sinusoidal encoding of a continuous noise level."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, noise_level: torch.Tensor) -> torch.Tensor:
        count = self.dim // 2
        step = torch.arange(count, dtype=torch.float32, device=noise_level.device) / count
        encoding = noise_level.float()[:, None] * torch.exp(-math.log(1e4) * step[None, :])
        return torch.cat([torch.sin(encoding), torch.cos(encoding)], dim=-1)


class Swish(nn.Module):
    def forward(self, x):
        return x * torch.sigmoid(x)


class Mish(nn.Module):
    """x * tanh(softplus(x)): the noise MLP's activation in srdiff and physrdiff."""

    def forward(self, x):
        return x * torch.tanh(F.softplus(x))


def NoiseLevelMLP(dim: int, activation: type = Swish) -> nn.Sequential:
    """PositionalEncoding -> Linear(4x) -> activation -> Linear(1x); [B] -> [B, dim].

    Indexed as the reference's `noise_level_mlp` (Linear layers at .1, .3).
    """
    return nn.Sequential(
        PositionalEncoding(dim), nn.Linear(dim, dim * 4), activation(), nn.Linear(dim * 4, dim)
    )


class FeatureWiseAffine(nn.Module):
    """Add the noise embedding to the features (the affine level is unused
    by every shipped config and is not ported)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.noise_func = nn.Sequential(nn.Linear(in_channels, out_channels))

    def forward(self, x: torch.Tensor, noise_embed: torch.Tensor) -> torch.Tensor:
        return x + self.noise_func(noise_embed)[:, :, None, None]


class FusedGroupNorm(nn.Module):
    """GroupNorm (+ optional fused Swish) through the GN+Swish kernel.

    Parameters are named as torch.nn.GroupNorm's (`weight`, `bias`). They
    are cast to the activation's dtype, as the JAX module casts `scale` and
    `bias` to its compute dtype.
    """

    def __init__(self, num_channels: int, num_groups: int = 32, eps: float = 1e-5,
                 with_swish: bool = False):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.with_swish = with_swish
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = gn_swish_trainable(
            _nhwc(x), self.weight.to(x.dtype), self.bias.to(x.dtype),
            self.num_groups, self.eps, self.with_swish,
        )
        return _nchw(y)


class Block(nn.Module):
    """GroupNorm+Swish -> Dropout -> Conv3x3, indexed as the reference's
    `block` Sequential (norm at .0, conv at .3; the Swish is fused into .0)."""

    def __init__(self, dim: int, dim_out: int, groups: int = 32, dropout: float = 0.0):
        super().__init__()
        self.block = nn.Sequential(
            FusedGroupNorm(dim, groups, with_swish=True),
            nn.Identity(),
            nn.Dropout(dropout) if dropout > 0 else nn.Identity(),
            nn.Conv2d(dim, dim_out, 3, padding=1),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(x)


class ResnetBlock(nn.Module):
    """Two conv blocks with noise injection and a residual 1x1 shortcut."""

    def __init__(self, dim: int, dim_out: int, noise_dim: int, dropout: float = 0.0,
                 norm_groups: int = 32):
        super().__init__()
        self.noise_func = FeatureWiseAffine(noise_dim, dim_out)
        self.block1 = Block(dim, dim_out, groups=norm_groups)
        self.block2 = Block(dim_out, dim_out, groups=norm_groups, dropout=dropout)
        self.res_conv = nn.Conv2d(dim, dim_out, 1) if dim != dim_out else nn.Identity()

    def forward(self, x: torch.Tensor, time_emb: torch.Tensor) -> torch.Tensor:
        h = self.block1(x)
        h = self.noise_func(h, time_emb)
        h = self.block2(h)
        return h + self.res_conv(x)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
            b: int, h: int, w: int) -> torch.Tensor:
    """flash attention (K1, and K2 in the backward) over [B, HW, C] views;
    returns NCHW channels_last."""
    out = flash_attention_trainable(q, k, v, scale)
    return _nchw(out.reshape(b, h, w, out.shape[-1]))


class SelfAttention(nn.Module):
    """Single-head full-spatial self-attention with scale 1/sqrt(C), as the
    JAX module (the scale is over the total channels, resnet.py:92)."""

    def __init__(self, in_channel: int, norm_groups: int = 32):
        super().__init__()
        self.norm = FusedGroupNorm(in_channel, norm_groups)
        self.qkv = nn.Conv2d(in_channel, in_channel * 3, 1, bias=False)
        self.out = nn.Conv2d(in_channel, in_channel, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        qkv = _nhwc(self.qkv(self.norm(x))).reshape(b, h * w, 3 * c)
        q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
        out = _attend(q, k, v, 1.0 / math.sqrt(c), b, h, w)
        return self.out(out) + x


class CrossAttention(nn.Module):
    """HF-guided cross-attention: the wavelet query image attends to the
    GroupNorm'd feature map (guided_cross_attention.py), scale 1/sqrt(C)."""

    def __init__(self, in_channel: int, query_channels: int, norm_groups: int = 32):
        super().__init__()
        self.norm = FusedGroupNorm(in_channel, norm_groups)
        self.kv = nn.Conv2d(in_channel, in_channel * 2, 1, bias=False)
        self.q = nn.Conv2d(query_channels, in_channel, 1, bias=False)
        self.out = nn.Conv2d(in_channel, in_channel, 1)

    def forward(self, x: torch.Tensor, query_img: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        kv = _nhwc(self.kv(self.norm(x))).reshape(b, h * w, 2 * c)
        k, v = kv[..., :c], kv[..., c:]
        q = _nhwc(self.q(query_img)).reshape(b, h * w, c)
        out = _attend(q, k, v, 1.0 / math.sqrt(c), b, h, w)
        return self.out(out) + x


class ResnetBlockWithAttn(nn.Module):
    """ResnetBlock optionally followed by SelfAttention."""

    def __init__(self, dim: int, dim_out: int, noise_dim: int, norm_groups: int = 32,
                 dropout: float = 0.0, with_attn: bool = False):
        super().__init__()
        self.res_block = ResnetBlock(dim, dim_out, noise_dim, dropout, norm_groups)
        self.attn = SelfAttention(dim_out, norm_groups) if with_attn else None

    def forward(self, x: torch.Tensor, time_emb: torch.Tensor) -> torch.Tensor:
        x = self.res_block(x, time_emb)
        return self.attn(x) if self.attn is not None else x


class Upsample(nn.Module):
    """Nearest x2 then Conv3x3 (same channels)."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv = nn.Conv2d(dim, dim, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(_nchw(upsample_nearest2x(_nhwc(x))))


class Downsample(nn.Module):
    """Stride-2 Conv3x3 (same channels)."""

    def __init__(self, dim: int):
        super().__init__()
        self.conv = nn.Conv2d(dim, dim, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class ResSE(nn.Module):
    """Squeeze-excite with a residual, on NHWC: x * sigmoid(MLP(mean_HW(x))) + x.

    Bias-free MLP indexed as the reference's `fc` Sequential (Linear at .0
    and .2). Its input is cast to the weights' dtype, as flax's compute
    dtype does; the product with x keeps x's dtype.
    """

    def __init__(self, channels: int, reduction: int = 2):
        super().__init__()
        hidden = max(channels // reduction, 1)
        self.fc = nn.Sequential(
            nn.Linear(channels, hidden, bias=False), nn.ReLU(),
            nn.Linear(hidden, channels, bias=False), nn.Sigmoid(),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.fc(x.mean(dim=(1, 2)).to(self.fc[0].weight.dtype))
        return x * y[:, None, None, :] + x
