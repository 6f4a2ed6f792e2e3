"""WeatherUNet (port of srewd_tpu/models/unet.py): the denoiser of all five
architectures, chosen by `variant`.

  sr3        plain UNet; mid = one block without attention.
  resdiff    FD_Info_Spliter front end (5C channels into the stem);
             HF-guided cross-attention on the skip tensor at each
             downsample boundary, queried by the summed Haar pyramid.
  phydiff    3 finite-difference stencil maps of the condition on the
             input; cross-attention queried by the concatenated
             3-component pyramid.
  srdiff     Mish noise MLP; RRDB features, projected x4 by a transposed
             conv, added to the trunk after the last full-resolution
             residual block at reference index min(2, res_blocks).
  physrdiff  srdiff + resdiff: spliter, RRDB projection and cross-attention
             with concatenated 3-component queries (the JAX tree, which has
             a spliter, is the reference; the original torch UNet defines
             none).
All but sr3 have mid = [attention block, plain block].

Module attributes follow the reference torch UNets: `noise_level_mlp`,
`fd_spliter`, `cond_proj`, `downs` (stem conv at index 0, then
ResnetBlockWithAttn / Downsample), `mid`, `ups`, `hf_ca_list` and
`final_conv`, so a port `state_dict` maps onto the JAX tree by
srewd_tpu/utils/torch_convert.py and back by utils/jax_params.py.

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
    Mish,
    NoiseLevelMLP,
    ResnetBlockWithAttn,
    Swish,
    Upsample,
)
from .fd_info_spliter import FDInfoSpliter

VARIANTS = ("sr3", "resdiff", "phydiff", "srdiff", "physrdiff")
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
        image_width: int = 256,
        image_channels: int = 1,
        rrdb_num_feats: int = 64,
        rrdb_num_blocks: int = 17,
        dtype: Optional[torch.dtype] = None,
    ):
        """in_channel: channels of the UNet input x (concat(condition, x_t),
        or x_t alone for srdiff and unconditional sr3); the spliter and the
        stencil maps widen it before the stem."""
        super().__init__()
        if variant not in VARIANTS:
            raise ValueError(f"unknown variant {variant}")
        self.variant = variant
        self.image_height, self.image_width = image_height, image_width
        self.image_channels = image_channels
        self.dtype = dtype  # compute dtype; None = the weights' float32
        self.uses_ca = variant in ("resdiff", "phydiff", "physrdiff")
        uses_spliter = variant in ("resdiff", "physrdiff")
        uses_rrdb = variant in ("srdiff", "physrdiff")
        num_mults = len(channel_mults)
        attn_res = tuple(attn_res)

        self.noise_level_mlp = NoiseLevelMLP(inner_channel, Mish if uses_rrdb else Swish)
        stem_in = in_channel
        if uses_spliter:
            self.fd_spliter = FDInfoSpliter(image_channels, out_channel, inner_channel,
                                            image_width)
            stem_in = FDInfoSpliter.out_channels(image_channels, out_channel)
        elif variant == "phydiff":
            stem_in = in_channel + 3  # 3 stencil maps of the condition
        if uses_rrdb:
            # x4 transposed conv of the concatenated RRDB taps (feats[2::3]);
            # torch's k=8, s=4, p=2 is flax's 'SAME' with the kernel flipped
            self.cond_proj = nn.ConvTranspose2d(
                rrdb_num_feats * (rrdb_num_blocks + 1) // 3, inner_channel, 8, 4, 2)
            # the reference's downs index 2, clamped to the last full-res block
            self.inject_at = min(2, res_blocks)
        query_channels = (1 if variant == "resdiff" else 3) * image_channels
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
                if self.uses_ca and len(hf_ca) < _J:
                    hf_ca.append(CrossAttention(pre_channel, query_channels, norm_groups))
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
        """HF query pyramid of the condition image (hoistable out of the chain):
        summed subbands for resdiff, concatenated for phydiff and physrdiff."""
        combine = "sum" if self.variant == "resdiff" else "concat"
        return haar_dwt_pyramid(cond_img, levels=_J, combine=combine)

    @staticmethod
    def project_rrdb_features(feats: Sequence[torch.Tensor]) -> torch.Tensor:
        """Every third RRDB feature map, concatenated (srdiff/unet.py:118)."""
        return torch.cat(list(feats)[2::3], dim=-1)

    def forward(
        self,
        x: torch.Tensor,
        noise_level: Optional[torch.Tensor] = None,
        *,
        rrdb_feats: Optional[torch.Tensor] = None,
        dwt_pyramid: Optional[Sequence[torch.Tensor]] = None,
        cond_feats: Optional[tuple] = None,
        fd_maps: Optional[torch.Tensor] = None,
        cond_features_only: bool = False,
    ):
        """Predict epsilon. x [B,H,W,Cin] NHWC (see __init__'s in_channel).

        rrdb_feats: srdiff/physrdiff's [B,h,w,nf(nb+1)/3] encoder taps
        (project_rrdb_features). dwt_pyramid / cond_feats / fd_maps: the
        chain-constant conditioning of the cross-attention, the spliter and
        phydiff's stencils; computed from x's condition channels when not
        given. cond_features_only: x is the bare condition image; return the
        spliter's (low, high) frequency maps and nothing else.
        """
        if cond_features_only:
            return self.fd_spliter.cond_features(x)
        dt = self.dtype or torch.float32
        c_img = self.image_channels
        mlp = self.noise_level_mlp  # the encoding is f32; the Linear layers run in dt
        t = mlp[1:](mlp[0](noise_level).to(dt))

        if self.uses_ca:
            if dwt_pyramid is None:
                dwt_pyramid = self.make_dwt_pyramid(x[..., :c_img])
            queries = [q.to(dt).permute(0, 3, 1, 2) for q in dwt_pyramid]
        cond = None
        if hasattr(self, "cond_proj"):
            if rrdb_feats is None:
                raise ValueError(f"variant {self.variant} requires rrdb_feats")
            cond = self.cond_proj(rrdb_feats.to(dt).permute(0, 3, 1, 2))
        if hasattr(self, "fd_spliter"):
            x = self.fd_spliter(x, t, cond_feats=cond_feats)
        elif self.variant == "phydiff":
            maps = fd_maps if fd_maps is not None else fd_stencils(x[..., :c_img])
            x = torch.cat([x, maps.to(x.dtype)], dim=-1)
        h = x.to(dt).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)

        h = self.downs[0](h)
        feats = [h]
        ca_idx = 0
        for idx, layer in enumerate(self.downs[1:], start=1):
            if isinstance(layer, Downsample):
                h = layer(h)
                if ca_idx < len(self.hf_ca_list):
                    feats.append(self.hf_ca_list[ca_idx](h, queries[ca_idx]))
                    ca_idx += 1
                else:
                    feats.append(h)
            else:
                h = layer(h, t)
                if cond is not None and idx == self.inject_at:
                    h = h + cond
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
