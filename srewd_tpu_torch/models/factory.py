"""DiffusionModel — arch wiring for sampling (port of srewd_tpu/models/factory.py).

Per-arch contract, as in the JAX package (batch is NHWC {"HR","LR","SR"};
"SR" is the bicubic x4 upsample of LR, computed on the device when absent):

  arch     x0 target   eps-net input              addback   conditioning
  sr3      HR          concat(SR, x_t)            —         —
  phydiff  HR - SR     concat(SR, x_t) + stencil  + SR      DWT(SR) 3-comp
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from ..diffusion.gaussian import ddim_sample_chain, sample_chain
from ..diffusion.schedule import Schedule
from ..ops.finite_diff import fd_stencils
from ..ops.resize import bicubic_up4
from .unet import WeatherUNet

ARCHS = ("sr3", "phydiff")


@dataclasses.dataclass
class DiffusionModel:
    """Binds a WeatherUNet with its architecture's diffusion wiring."""

    arch: str
    unet: WeatherUNet
    conditional: bool = True

    def __post_init__(self):
        if self.arch not in ARCHS:
            raise ValueError(f"arch {self.arch!r} is not ported (ported: {ARCHS})")

    def condition(self, batch: dict) -> torch.Tensor:
        """The image-space condition ('SR' slot semantics)."""
        sr = batch.get("SR")
        return sr if sr is not None else bicubic_up4(batch["LR"])

    @torch.no_grad()
    def generate_sr(
        self,
        batch: dict,
        schedule: Schedule,
        *,
        generator: Optional[torch.Generator] = None,
        clip_denoised: bool = True,
        sampler: str = "ddpm",
        ddim_steps: int = 50,
        ddim_eta: float = 0.0,
        tau_spacing: str = "linspace",
        init: Optional[torch.Tensor] = None,
        noises: Optional[Sequence[torch.Tensor]] = None,
    ) -> torch.Tensor:
        """Super-resolve an NHWC batch by the full reverse chain.

        The chain-constant conditioning (the DWT pyramid and the stencil
        maps) is computed once, outside the step loop. With a compute dtype
        on the UNet, its weights are cast once here, in place, before the
        loop. Noise comes from `generator`, or from `init` / `noises` (see
        diffusion/gaussian.py).
        """
        cond = self.condition(batch).float()
        kwargs: dict = {}
        if self.arch == "phydiff":
            kwargs = {"dwt_pyramid": self.unet.make_dwt_pyramid(cond),
                      "fd_maps": fd_stencils(cond)}
        if self.unet.dtype is not None:
            self.unet.to(self.unet.dtype)  # no-op once cast
        self.unet.eval()

        def denoise_fn(x_t, noise_level):
            x_in = torch.cat([cond, x_t], dim=-1) if self.conditional else x_t
            return self.unet(x_in, noise_level, **kwargs)

        common = dict(device=cond.device, generator=generator, init=init, noises=noises,
                      clip_denoised=clip_denoised)
        if sampler == "ddim":
            img = ddim_sample_chain(schedule, denoise_fn, tuple(cond.shape), steps=ddim_steps,
                                    eta=ddim_eta, tau_spacing=tau_spacing, **common)
        elif sampler == "ddpm":
            img = sample_chain(schedule, denoise_fn, tuple(cond.shape), **common)
        else:
            raise NotImplementedError(
                f"sampler {sampler!r} is not ported yet (DPM-Solver++: ROADMAP.md Queue 1 item 2)")
        if self.arch != "sr3":
            img = img + cond
        return img


def build_model(model_cfg: dict, dtype: Optional[torch.dtype] = None) -> DiffusionModel:
    """Construct a DiffusionModel from the reference config schema (opt["model"])."""
    arch = model_cfg.get("architecture", "sr3")
    unet_cfg = model_cfg.get("unet", {})
    diff_cfg = model_cfg.get("diffusion", {})
    channels = int(diff_cfg.get("channels", 1))
    if dtype == torch.float32:
        dtype = None
    unet = WeatherUNet(
        variant=arch,
        in_channel=int(unet_cfg.get("in_channel", 2 * channels)),
        out_channel=int(unet_cfg.get("out_channel", channels)),
        inner_channel=int(unet_cfg.get("inner_channel", 64)),
        norm_groups=int(unet_cfg.get("norm_groups", 32)),
        channel_mults=tuple(unet_cfg.get("channel_multiplier", (1, 2, 4, 8, 8))),
        attn_res=tuple(unet_cfg.get("attn_res", (16,))),
        res_blocks=int(unet_cfg.get("res_blocks", 2)),
        dropout=float(unet_cfg.get("dropout", 0.0)),
        image_height=int(diff_cfg.get("image_height", 128)),
        image_channels=int(diff_cfg.get("image_channels", channels)),
        dtype=dtype,
    )
    return DiffusionModel(arch=arch, unet=unet,
                          conditional=bool(diff_cfg.get("conditional", True)))
