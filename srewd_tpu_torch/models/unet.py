"""WeatherUNet (port of srewd_tpu/models/unet.py) for the sr3 and phydiff variants.

Module attributes follow the reference torch UNet: `noise_level_mlp`,
`downs` (stem conv at index 0, then ResnetBlockWithAttn / Downsample),
`mid`, `ups` (ResnetBlockWithAttn / Upsample), `hf_ca_list` (phydiff's
cross-attention at the downsample boundaries) and `final_conv`, so a port
`state_dict` maps onto the JAX tree by srewd_tpu/utils/torch_convert.py and
back by utils/jax_params.py.

`forward` takes and returns NHWC tensors, as the JAX module does; inside,
activations are NCHW in channels_last memory.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from ..ops.finite_diff import fd_stencils
from ..ops.wavelets import haar_dwt_pyramid
from .blocks import (
    Block,
    CrossAttention,
    Downsample,
    NoiseLevelMLP,
    ResnetBlockWithAttn,
    Upsample,
)

# Variants of srewd_tpu's WeatherUNet not ported yet, with their ROADMAP item.
_LATER = {
    "resdiff": "Queue 1 item 2 (resdiff)",
    "srdiff": "Queue 1 item 3 (encoders, srdiff and physrdiff)",
    "physrdiff": "Queue 1 item 3 (encoders, srdiff and physrdiff)",
}
_J = 4  # wavelet pyramid levels feeding the cross-attention (resdiff/unet.py:73)


class WeatherUNet(nn.Module):
    def __init__(
        self,
        variant: str = "sr3",
        in_channel: int = 2,
        out_channel: int = 1,
        inner_channel: int = 64,
        norm_groups: int = 32,
        channel_mults: Sequence[int] = (1, 2, 4, 8, 8),
        attn_res: Sequence[int] = (16,),
        res_blocks: int = 2,
        dropout: float = 0.0,
        image_height: int = 128,
        image_channels: int = 1,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        if variant in _LATER:
            raise NotImplementedError(
                f"variant {variant!r} is not ported yet: ROADMAP.md {_LATER[variant]}"
            )
        if variant not in ("sr3", "phydiff"):
            raise ValueError(f"unknown variant {variant}")
        self.variant = variant
        self.image_channels = image_channels
        self.dtype = dtype  # compute dtype; None = the weights' float32
        uses_ca = variant == "phydiff"
        num_mults = len(channel_mults)
        attn_res = tuple(attn_res)

        self.noise_level_mlp = NoiseLevelMLP(inner_channel)
        # phydiff concatenates 3 stencil maps of the condition onto its input
        stem_in = in_channel + (3 if variant == "phydiff" else 0)
        downs: list = [nn.Conv2d(stem_in, inner_channel, 3, padding=1)]
        hf_ca = []
        feat_channels = [inner_channel]
        pre_channel = inner_channel
        now_res = image_height
        for ind in range(num_mults):
            is_last = ind == num_mults - 1
            use_attn = now_res in attn_res
            channel_mult = inner_channel * channel_mults[ind]
            for _ in range(res_blocks):
                downs.append(ResnetBlockWithAttn(
                    pre_channel, channel_mult, inner_channel, norm_groups, dropout, use_attn))
                feat_channels.append(channel_mult)
                pre_channel = channel_mult
            if not is_last:
                downs.append(Downsample(pre_channel))
                if uses_ca and len(hf_ca) < _J:
                    hf_ca.append(CrossAttention(pre_channel, 3 * image_channels, norm_groups))
                feat_channels.append(pre_channel)
                now_res //= 2
        self.downs = nn.ModuleList(downs)
        self.hf_ca_list = nn.ModuleList(hf_ca)

        mid_specs = [False] if variant == "sr3" else [True, False]
        self.mid = nn.ModuleList([
            ResnetBlockWithAttn(pre_channel, pre_channel, inner_channel, norm_groups,
                                dropout, with_attn)
            for with_attn in mid_specs
        ])

        ups: list = []
        for ind in reversed(range(num_mults)):
            is_last = ind < 1
            use_attn = now_res in attn_res
            channel_mult = inner_channel * channel_mults[ind]
            for _ in range(res_blocks + 1):
                ups.append(ResnetBlockWithAttn(
                    pre_channel + feat_channels.pop(), channel_mult, inner_channel,
                    norm_groups, dropout, use_attn))
                pre_channel = channel_mult
            if not is_last:
                ups.append(Upsample(pre_channel))
                now_res *= 2
        self.ups = nn.ModuleList(ups)
        self.final_conv = Block(pre_channel, out_channel, groups=norm_groups)

    def make_dwt_pyramid(self, cond_img: torch.Tensor) -> list:
        """HF query pyramid of the condition image (hoistable out of the chain)."""
        return haar_dwt_pyramid(cond_img, levels=_J)

    def forward(
        self,
        x: torch.Tensor,
        noise_level: torch.Tensor,
        *,
        dwt_pyramid: Optional[Sequence[torch.Tensor]] = None,
        fd_maps: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Predict epsilon. x [B,H,W,Cin] NHWC: concat(condition, noisy).

        dwt_pyramid / fd_maps: phydiff's chain-constant conditioning; computed
        from x's condition channels when not given.
        """
        dt = self.dtype or torch.float32
        c_img = self.image_channels
        mlp = self.noise_level_mlp  # the encoding is f32; the Linear layers run in dt
        t = mlp[1:](mlp[0](noise_level).to(dt))

        if self.variant == "phydiff":
            if dwt_pyramid is None:
                dwt_pyramid = self.make_dwt_pyramid(x[..., :c_img])
            maps = fd_maps if fd_maps is not None else fd_stencils(x[..., :c_img])
            x = torch.cat([x, maps.to(x.dtype)], dim=-1)
            queries = [q.to(dt).permute(0, 3, 1, 2) for q in dwt_pyramid]
        h = x.to(dt).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)

        h = self.downs[0](h)
        feats = [h]
        ca_idx = 0
        for layer in self.downs[1:]:
            if isinstance(layer, Downsample):
                h = layer(h)
                if ca_idx < len(self.hf_ca_list):
                    feats.append(self.hf_ca_list[ca_idx](h, queries[ca_idx]))
                    ca_idx += 1
                else:
                    feats.append(h)
            else:
                h = layer(h, t)
                feats.append(h)
        for layer in self.mid:
            h = layer(h, t)
        for layer in self.ups:
            if isinstance(layer, Upsample):
                h = layer(h)
            else:
                h = layer(torch.cat([h, feats.pop()], dim=1), t)
        out = self.final_conv(h)
        return out.permute(0, 2, 3, 1)
