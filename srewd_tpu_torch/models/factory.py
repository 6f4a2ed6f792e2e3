"""DiffusionModel: arch wiring for training and sampling (port of
srewd_tpu/models/factory.py).

Per-arch contract, as in the JAX package (batch is NHWC {"HR","LR","SR"};
"SR" is the bicubic x4 upsample of LR, computed on the device when absent):

  arch     x0 target   eps-net input              addback   conditioning
  sr3      HR          concat(SR, x_t)            —         —
  phydiff  HR - SR     concat(SR, x_t) + stencil  + SR      DWT(SR) 3-comp

Loss: the eps-prediction error of one draw (t, gamma, noise), L1 mean by
default, L2 selectable, with the UNet in train mode (dropout on).

Training runs in float32. `generate_sr` with a compute dtype on the UNet
casts its weights IN PLACE; a trainer must therefore never sample through
its own float32 model with a dtype set (the port's trainer samples through
a copy).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from ..diffusion.gaussian import ddim_sample_chain, draw_time_and_gamma, q_sample, sample_chain
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
    loss_type: str = "l1"

    def __post_init__(self):
        if self.arch not in ARCHS:
            raise ValueError(f"arch {self.arch!r} is not ported (ported: {ARCHS})")

    def condition(self, batch: dict) -> torch.Tensor:
        """The image-space condition ('SR' slot semantics)."""
        sr = batch.get("SR")
        return sr if sr is not None else bicubic_up4(batch["LR"])

    def _conditioning(self, cond: torch.Tensor) -> dict:
        """The UNet's chain-constant keyword inputs for this architecture."""
        if self.arch == "phydiff":
            return {"dwt_pyramid": self.unet.make_dwt_pyramid(cond), "fd_maps": fd_stencils(cond)}
        return {}

    def loss(
        self,
        batch: dict,
        schedule: Schedule,
        *,
        generator: Optional[torch.Generator] = None,
        t: Optional[torch.Tensor] = None,
        u: Optional[torch.Tensor] = None,
        noise: Optional[torch.Tensor] = None,
        train: bool = True,
    ) -> torch.Tensor:
        """Single-draw diffusion training loss (a scalar tensor on the device).

        t, gamma's uniforms `u` and the noise are drawn from `generator`
        unless handed in (tests feed the JAX draws); dropout draws from the
        device's default generator.
        """
        if self.unet.dtype is not None:
            raise NotImplementedError(
                "training runs in float32; bf16 training with float32 master weights "
                "is ROADMAP.md Queue 1 item 4")
        hr = batch["HR"]
        cond = self.condition(batch)
        x_start = hr if self.arch == "sr3" else hr - cond
        _, gamma = draw_time_and_gamma(schedule, hr.shape[0], generator=generator, t=t, u=u)
        if noise is None:
            noise = torch.randn(x_start.shape, generator=generator, device=x_start.device)
        x_noisy = q_sample(x_start, gamma, noise)
        x_in = torch.cat([cond, x_noisy], dim=-1) if self.conditional else x_noisy
        self.unet.train(train)
        eps = self.unet(x_in, gamma, **self._conditioning(cond))
        if self.loss_type == "l1":
            return (noise - eps).abs().mean()
        if self.loss_type == "l2":
            return (noise - eps).square().mean()
        raise NotImplementedError(self.loss_type)

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
        kwargs = self._conditioning(cond)
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
                f"sampler {sampler!r} is not ported yet (DPM-Solver++: ROADMAP.md Queue 1 item 1)")
        if self.arch != "sr3":
            img = img + cond
        return img


def build_model(model_cfg: dict, dtype: Optional[torch.dtype] = None) -> DiffusionModel:
    """Construct a DiffusionModel from the reference config schema (opt["model"])."""
    arch = model_cfg.get("architecture", "sr3")
    unet_cfg = model_cfg.get("unet", {})
    diff_cfg = model_cfg.get("diffusion", {})
    channels = int(diff_cfg.get("channels", 1))
    image_channels = int(diff_cfg.get("image_channels", channels))
    conditional = bool(diff_cfg.get("conditional", True))
    if dtype == torch.float32:
        dtype = None
    unet = WeatherUNet(
        variant=arch,
        # the UNet's input is concat(condition, x_t) (x_t alone when
        # unconditional), as flax infers it from the input; the config's
        # in_channel counts phydiff's stencil maps in some configs and not
        # in others, so it is not read
        in_channel=(2 if conditional else 1) * image_channels,
        out_channel=int(unet_cfg.get("out_channel", channels)),
        inner_channel=int(unet_cfg.get("inner_channel", 64)),
        norm_groups=int(unet_cfg.get("norm_groups", 32)),
        channel_mults=tuple(unet_cfg.get("channel_multiplier", (1, 2, 4, 8, 8))),
        attn_res=tuple(unet_cfg.get("attn_res", (16,))),
        res_blocks=int(unet_cfg.get("res_blocks", 2)),
        dropout=float(unet_cfg.get("dropout", 0.0)),
        image_height=int(diff_cfg.get("image_height", 128)),
        image_channels=image_channels,
        dtype=dtype,
    )
    return DiffusionModel(arch=arch, unet=unet, conditional=conditional,
                          loss_type=model_cfg.get("loss_type", "l1"))
