"""Plain reference networks: the diffusion UNet of SR3 with the phydiff and
SRDiff variants, and SRDiff's RRDBNet encoder.

Written from the architectures' descriptions (SR3, arXiv:2104.07636;
SRDiff, arXiv:2104.14951; phydiff's physics-informed conditioning,
arXiv:2406.04099) in plain PyTorch over NCHW tensors, with no kernel and
no batching trick. Parameters carry the attribute names of the published
torch code (`noise_level_mlp`, `downs`, `mid`, `ups`, `hf_ca_list`,
`final_conv`, `cond_proj`; `conv_first`, `RRDB_trunk`, ...), so one state
dict of seeded weights loads into this model and into the system under
test alike. nn.Conv2d, nn.Linear and nn.GroupNorm only hold the
parameters: every forward goes through `ops`, where the controls can
lower the precision of the products.

Semantics kept from the configurations' published code:
* UNet input: concat(condition, x_t) for phydiff, x_t alone for srdiff;
  phydiff appends three stencil maps of the condition before the stem.
* A resolution in `attn_res` gets single-head self-attention (scale
  1/sqrt(C)) after each residual block; the middle is [block with
  attention, block].
* phydiff: after each of the first four downsamples, the downsampled map
  is attended by the condition's Haar detail pyramid at that level
  (cross-attention, queries from the pyramid) and the result goes to the
  skip connection only; the trunk goes on with the plain map.
* srdiff: the noise MLP uses Mish; every third RRDB feature map (taps
  2, 5, ..., 17 of 18) is concatenated, projected x4 by a transposed
  convolution (k 8, s 4, p 2) and added to the trunk after the second
  full-resolution residual block.
* Dropout (the training configurations' 0.2) sits between the GroupNorm
  + Swish and the convolution of each residual block's second half; its
  mask is drawn from float32 uniforms of the activation's NCHW shape on
  the device's default generator, kept where u >= p.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import ops

_PYRAMID_LEVELS = 4


def _swish(x):
    return x * torch.sigmoid(x)


def _mish(x):
    return x * torch.tanh(F.softplus(x))


def _dropout(x, p: float, training: bool):
    if not training or p == 0.0:
        return x
    u = torch.rand(tuple(x.shape), device=x.device, dtype=torch.float32)
    return x * (u >= p).to(x.dtype) * (1.0 / (1.0 - p))


def _conv(m: nn.Conv2d, x):
    return ops.conv2d(x, m.weight, m.bias, m.stride, m.padding)


def _lin(m: nn.Linear, x):
    return ops.linear(x, m.weight, m.bias)


class Block(nn.Module):
    """GroupNorm + Swish -> Dropout -> Conv3x3 (`block.0` and `block.3`)."""

    def __init__(self, dim, dim_out, groups, dropout=0.0):
        super().__init__()
        self.groups, self.p = groups, dropout
        self.block = nn.Sequential(nn.GroupNorm(groups, dim), nn.Identity(), nn.Identity(),
                                   nn.Conv2d(dim, dim_out, 3, padding=1))

    def forward(self, x):
        gn, conv = self.block[0], self.block[3]
        h = ops.group_norm(x, gn.weight, gn.bias, self.groups, swish=True)
        return _conv(conv, _dropout(h, self.p, self.training))


class ResnetBlock(nn.Module):
    def __init__(self, dim, dim_out, noise_dim, dropout, groups):
        super().__init__()
        self.noise_func = nn.Module()
        self.noise_func.noise_func = nn.Sequential(nn.Linear(noise_dim, dim_out))
        self.block1 = Block(dim, dim_out, groups)
        self.block2 = Block(dim_out, dim_out, groups, dropout)
        self.res_conv = nn.Conv2d(dim, dim_out, 1) if dim != dim_out else None

    def forward(self, x, t):
        h = self.block1(x)
        h = h + _lin(self.noise_func.noise_func[0], t)[:, :, None, None]
        h = self.block2(h)
        return h + (x if self.res_conv is None else _conv(self.res_conv, x))


class SelfAttention(nn.Module):
    def __init__(self, c, groups):
        super().__init__()
        self.groups = groups
        self.norm = nn.GroupNorm(groups, c)
        self.qkv = nn.Conv2d(c, 3 * c, 1, bias=False)
        self.out = nn.Conv2d(c, c, 1)

    def forward(self, x):
        b, c, h, w = x.shape
        n = ops.group_norm(x, self.norm.weight, self.norm.bias, self.groups)
        qkv = _conv(self.qkv, n).flatten(2).transpose(1, 2)  # [B, HW, 3C]
        q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
        o = ops.attention(q, k, v, 1.0 / math.sqrt(c))
        return _conv(self.out, o.transpose(1, 2).reshape(b, c, h, w)) + x


class CrossAttention(nn.Module):
    def __init__(self, c, query_channels, groups):
        super().__init__()
        self.groups = groups
        self.norm = nn.GroupNorm(groups, c)
        self.kv = nn.Conv2d(c, 2 * c, 1, bias=False)
        self.q = nn.Conv2d(query_channels, c, 1, bias=False)
        self.out = nn.Conv2d(c, c, 1)

    def forward(self, x, query):
        b, c, h, w = x.shape
        n = ops.group_norm(x, self.norm.weight, self.norm.bias, self.groups)
        kv = _conv(self.kv, n).flatten(2).transpose(1, 2)
        q = _conv(self.q, query).flatten(2).transpose(1, 2)
        o = ops.attention(q, kv[..., :c], kv[..., c:], 1.0 / math.sqrt(c))
        return _conv(self.out, o.transpose(1, 2).reshape(b, c, h, w)) + x


class ResnetBlockWithAttn(nn.Module):
    def __init__(self, dim, dim_out, noise_dim, groups, dropout, with_attn):
        super().__init__()
        self.res_block = ResnetBlock(dim, dim_out, noise_dim, dropout, groups)
        self.attn = SelfAttention(dim_out, groups) if with_attn else None

    def forward(self, x, t):
        x = self.res_block(x, t)
        return x if self.attn is None else self.attn(x)


class Resample(nn.Module):
    """Downsample (stride-2 Conv3x3) or Upsample (nearest x2, Conv3x3)."""

    def __init__(self, dim, up: bool):
        super().__init__()
        self.up = up
        self.conv = nn.Conv2d(dim, dim, 3, stride=1 if up else 2, padding=1)

    def forward(self, x):
        if self.up:
            x = F.interpolate(x, scale_factor=2, mode="nearest")
        return _conv(self.conv, x)


class UNet(nn.Module):
    """The denoiser; `variant` "phydiff" or "srdiff"."""

    def __init__(self, variant: str, *, inner_channel=64, norm_groups=32,
                 channel_mults: Sequence[int] = (1, 2, 4, 8, 8), attn_res=(16,), res_blocks=2,
                 dropout=0.0, image_height=128, out_channel=1, rrdb_nf=64, rrdb_nb=17):
        super().__init__()
        if variant not in ("phydiff", "srdiff"):
            raise ValueError(f"no reference for UNet variant {variant!r}")
        self.variant = variant
        self.inner = inner_channel
        wide = 4 * inner_channel
        self.noise_level_mlp = nn.Sequential(nn.Identity(), nn.Linear(inner_channel, wide),
                                             nn.Identity(), nn.Linear(wide, inner_channel))
        stem_in = 2 + 3 if variant == "phydiff" else 1
        if variant == "srdiff":
            self.cond_proj = nn.ConvTranspose2d(rrdb_nf * (rrdb_nb + 1) // 3, inner_channel,
                                                8, 4, 2)
            self.inject_at = min(2, res_blocks)
        downs: list = [nn.Conv2d(stem_in, inner_channel, 3, padding=1)]
        hf_ca: list = []
        feat_ch = [inner_channel]
        pre = inner_channel
        res = image_height
        n = len(channel_mults)
        for i, mult in enumerate(channel_mults):
            ch = inner_channel * mult
            for _ in range(res_blocks):
                downs.append(ResnetBlockWithAttn(pre, ch, inner_channel, norm_groups, dropout,
                                                 res in attn_res))
                feat_ch.append(ch)
                pre = ch
            if i != n - 1:
                downs.append(Resample(pre, up=False))
                if variant == "phydiff" and len(hf_ca) < _PYRAMID_LEVELS:
                    hf_ca.append(CrossAttention(pre, 3, norm_groups))
                feat_ch.append(pre)
                res //= 2
        self.downs = nn.ModuleList(downs)
        self.hf_ca_list = nn.ModuleList(hf_ca)
        self.mid = nn.ModuleList([
            ResnetBlockWithAttn(pre, pre, inner_channel, norm_groups, dropout, True),
            ResnetBlockWithAttn(pre, pre, inner_channel, norm_groups, dropout, False)])
        ups: list = []
        for i in reversed(range(n)):
            ch = inner_channel * channel_mults[i]
            for _ in range(res_blocks + 1):
                ups.append(ResnetBlockWithAttn(pre + feat_ch.pop(), ch, inner_channel,
                                               norm_groups, dropout, res in attn_res))
                pre = ch
            if i > 0:
                ups.append(Resample(pre, up=True))
                res *= 2
        self.ups = nn.ModuleList(ups)
        self.final_conv = Block(pre, out_channel, norm_groups)

    def _noise_embedding(self, level):
        half = self.inner // 2
        step = torch.arange(half, dtype=torch.float32, device=level.device) / half
        enc = level.float()[:, None] * torch.exp(-math.log(1e4) * step[None, :])
        enc = torch.cat([torch.sin(enc), torch.cos(enc)], dim=-1)
        act = _mish if self.variant == "srdiff" else _swish
        return _lin(self.noise_level_mlp[3], act(_lin(self.noise_level_mlp[1], enc)))

    def forward(self, x, level, *, condition=None, rrdb_feats=None):
        """x: NHWC UNet input (concat(condition, x_t) or x_t); level: [B]
        noise levels; condition: the NHWC condition image (phydiff);
        rrdb_feats: NHWC concatenated RRDB taps (srdiff). Returns eps, NHWC."""
        t = self._noise_embedding(level)
        queries = None
        if self.variant == "phydiff":
            x = torch.cat([x, ops.stencils(condition).to(x.dtype)], dim=-1)
            queries = [q.permute(0, 3, 1, 2) for q in ops.haar_pyramid(condition)]
        inject = None
        if self.variant == "srdiff":
            p = self.cond_proj
            inject = ops.conv_transpose2d(rrdb_feats.permute(0, 3, 1, 2), p.weight, p.bias,
                                          p.stride, p.padding)
        h = _conv(self.downs[0], x.permute(0, 3, 1, 2))
        feats = [h]
        ca = 0
        for idx, layer in enumerate(self.downs[1:], start=1):
            if isinstance(layer, Resample):
                h = layer(h)
                if ca < len(self.hf_ca_list):
                    feats.append(self.hf_ca_list[ca](h, queries[ca]))
                    ca += 1
                else:
                    feats.append(h)
            else:
                h = layer(h, t)
                if inject is not None and idx == self.inject_at:
                    h = h + inject
                feats.append(h)
        for layer in self.mid:
            h = layer(h, t)
        for layer in self.ups:
            if isinstance(layer, Resample):
                h = layer(h)
            else:
                h = layer(torch.cat([h, feats.pop()], 1), t)
        return self.final_conv(h).permute(0, 2, 3, 1)


class _RDB(nn.Module):
    def __init__(self, nf, gc):
        super().__init__()
        for i in range(5):
            setattr(self, f"conv{i + 1}", nn.Conv2d(nf + i * gc, gc if i < 4 else nf, 3,
                                                    padding=1))

    def forward(self, x):
        xs = [x]
        for i in range(1, 5):
            xs.append(F.leaky_relu(_conv(getattr(self, f"conv{i}"), torch.cat(xs, 1)), 0.2))
        return _conv(self.conv5, torch.cat(xs, 1)) * 0.2 + x


class _RRDB(nn.Module):
    def __init__(self, nf, gc):
        super().__init__()
        self.RDB1, self.RDB2, self.RDB3 = _RDB(nf, gc), _RDB(nf, gc), _RDB(nf, gc)

    def forward(self, x):
        return self.RDB3(self.RDB2(self.RDB1(x))) * 0.2 + x


class RRDBNet(nn.Module):
    """ESRGAN's RRDBNet as SRDiff's encoder: input in [-1, 1] mapped to
    [0, 1], x4 by two nearest upsamples, output mapped back, unclamped;
    also the 18 trunk feature maps (after each block, and after the trunk
    convolution's residual)."""

    def __init__(self, nf=64, nb=17, gc=32):
        super().__init__()
        self.conv_first = nn.Conv2d(1, nf, 3, padding=1)
        self.RRDB_trunk = nn.Sequential(*[_RRDB(nf, gc) for _ in range(nb)])
        self.trunk_conv = nn.Conv2d(nf, nf, 3, padding=1)
        self.upconv1 = nn.Conv2d(nf, nf, 3, padding=1)
        self.upconv2 = nn.Conv2d(nf, nf, 3, padding=1)
        self.HRconv = nn.Conv2d(nf, nf, 3, padding=1)
        self.conv_last = nn.Conv2d(nf, 1, 3, padding=1)

    def forward(self, lr):
        """lr NHWC -> (SR NHWC, the concatenated taps 2, 5, ..., 17, NHWC)."""
        x = ((lr + 1.0) / 2.0).permute(0, 3, 1, 2)
        first = fea = _conv(self.conv_first, x)
        feas = []
        for block in self.RRDB_trunk:
            fea = block(fea)
            feas.append(fea)
        fea = first + _conv(self.trunk_conv, fea)
        feas.append(fea)
        lrelu = lambda y: F.leaky_relu(y, 0.2)  # noqa: E731
        fea = lrelu(_conv(self.upconv1, F.interpolate(fea, scale_factor=2, mode="nearest")))
        fea = lrelu(_conv(self.upconv2, F.interpolate(fea, scale_factor=2, mode="nearest")))
        out = _conv(self.conv_last, lrelu(_conv(self.HRconv, fea)))
        taps = torch.cat(feas[2::3], dim=1).permute(0, 2, 3, 1)
        return (out * 2.0 - 1.0).permute(0, 2, 3, 1), taps


def build(model_cfg: dict, device="meta"):
    """(unet, encoder or None) of a configuration's `model` section, with
    uninitialised parameters on `device`."""
    arch = model_cfg["architecture"]
    u = model_cfg["unet"]
    d = model_cfg["diffusion"]
    pre = model_cfg.get("pretrained_model") or {}
    nf, nb = int(pre.get("hidden_size", 64)), int(pre.get("num_block", 17))
    with torch.device("meta"):
        unet = UNet(arch, inner_channel=u["inner_channel"], norm_groups=u["norm_groups"],
                    channel_mults=tuple(u["channel_multiplier"]), attn_res=tuple(u["attn_res"]),
                    res_blocks=u["res_blocks"], dropout=float(u.get("dropout", 0.0)),
                    image_height=int(d["image_height"]), out_channel=u["out_channel"],
                    rrdb_nf=nf, rrdb_nb=nb)
        encoder = RRDBNet(nf, nb, nf // 2) if arch == "srdiff" else None
    if torch.device(device).type != "meta":
        unet = unet.to_empty(device=device)
        encoder = None if encoder is None else encoder.to_empty(device=device)
    return unet, encoder
