"""DiffusionModel: arch wiring for training and sampling (port of
srewd_tpu/models/factory.py).

Per-arch contract, as in the JAX package (batch is NHWC {"HR","LR","SR"};
"SR" is the bicubic x4 upsample of LR, computed on the device when absent):

  arch        x0 target   eps-net input              addback  conditioning
  sr3         HR          concat(SR, x_t)            —        —
  resdiff     HR - SR     concat(SR, x_t) -> spliter + SR     DWT(SR) summed
  phydiff     HR - SR     concat(SR, x_t) + stencil  + SR     DWT(SR) 3-comp
  srdiff      HR - SR     x_t                        + SR     RRDB(LR) taps
  physrdiff   HR - SR     concat(SR, x_t) -> spliter + SR     RRDB + DWT 3-comp

An encoder is optional for resdiff and phydiff (a SimpleCNN; with
`use_encoder_prediction` its output replaces SR as the condition) and
required for srdiff and physrdiff (an RRDBNet, whose feature taps condition
the UNet). A locked encoder runs without autograd; an unlocked RRDBNet also
adds l1(RRDB(LR), HR) to the loss (srdiff_diffusion.py:212-214).

Loss: the eps-prediction error of one draw (t, gamma, noise), L1 mean by
default, L2 selectable, with the UNet in train mode (dropout on).

Training runs in float32. `generate_sr` with a compute dtype on the UNet
casts the UNet's weights IN PLACE; the encoder computes in that dtype over
its float32 weights (cast per call, never in place), as JAX casts only the
UNet's params. A trainer must therefore never sample through its own
float32 model with a dtype set (the port's trainer samples through a copy).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Sequence

import torch
import torch.nn as nn

from ..diffusion.gaussian import (
    ddim_sample_chain,
    dpm_solver_chain,
    draw_time_and_gamma,
    q_sample,
    sample_chain,
)
from ..diffusion.schedule import Schedule
from ..ops.finite_diff import fd_stencils
from ..ops.resize import bicubic_up4
from .rrdb import RRDBNet
from .simple_cnn import SimpleCNN
from .unet import VARIANTS, WeatherUNet

ARCHS = VARIANTS
_RRDB_ARCHS = ("srdiff", "physrdiff")


@dataclasses.dataclass
class DiffusionModel:
    """Binds a WeatherUNet (and an optional encoder) with its architecture's
    diffusion wiring."""

    arch: str
    unet: WeatherUNet
    encoder: Optional[nn.Module] = None  # SimpleCNN (resdiff, phydiff) or RRDBNet
    conditional: bool = True
    loss_type: str = "l1"
    lock_encoder: bool = True
    use_encoder_prediction: bool = False

    def __post_init__(self):
        if self.arch not in ARCHS:
            raise ValueError(f"unknown arch {self.arch!r} (one of {ARCHS})")
        if self.arch in _RRDB_ARCHS and self.encoder is None:
            raise ValueError(f"{self.arch} requires an RRDB encoder (the reference's "
                             "no-encoder path is unrunnable: srdiff_diffusion.py:182)")

    def to(self, device) -> "DiffusionModel":
        self.unet.to(device)
        if self.encoder is not None:
            self.encoder.to(device)
        return self

    def _encoder_grad(self):
        return torch.no_grad() if self.lock_encoder else contextlib.nullcontext()

    def encode_rrdb(self, lr: torch.Tensor) -> tuple:
        """(the RRDBNet's SR output, its concatenated feature taps)."""
        with self._encoder_grad():
            sr_pred, feats = self.encoder(lr, get_fea=True)
        return sr_pred, self.unet.project_rrdb_features(feats)

    def condition(self, batch: dict) -> torch.Tensor:
        """The image-space condition ('SR' slot semantics)."""
        if (self.arch in ("resdiff", "phydiff") and self.encoder is not None
                and self.use_encoder_prediction):
            with self._encoder_grad():
                return self.encoder(batch["LR"])
        sr = batch.get("SR")
        return sr if sr is not None else bicubic_up4(batch["LR"])

    def _conditioning(self, cond: torch.Tensor) -> dict:
        """The UNet's chain-constant keyword inputs derived from the condition."""
        if self.unet.uses_ca:
            kw = {"dwt_pyramid": self.unet.make_dwt_pyramid(cond)}
            if self.arch == "phydiff":
                kw["fd_maps"] = fd_stencils(cond)
            return kw
        return {}

    def _x_in(self, cond: torch.Tensor, x_t: torch.Tensor) -> torch.Tensor:
        if self.arch == "srdiff" or not self.conditional:
            return x_t
        return torch.cat([cond, x_t], dim=-1)

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
        kwargs = self._conditioning(cond)
        rrdb_sr = None
        if self.arch in _RRDB_ARCHS:
            rrdb_sr, kwargs["rrdb_feats"] = self.encode_rrdb(batch["LR"])
        self.unet.train(train)
        eps = self.unet(self._x_in(cond, x_noisy), gamma, **kwargs)
        if self.loss_type == "l1":
            loss = (noise - eps).abs().mean()
        elif self.loss_type == "l2":
            loss = (noise - eps).square().mean()
        else:
            raise NotImplementedError(self.loss_type)
        if rrdb_sr is not None and not self.lock_encoder:
            loss = loss + (rrdb_sr - hr).abs().mean()
        return loss

    @torch.no_grad()
    def denoiser(self, batch: dict) -> tuple:
        """(condition, denoise_fn(x_t, noise_level) -> eps) of a reverse chain.

        The chain-constant conditioning (RRDB taps, DWT pyramid, the
        spliter's frequency maps, stencil maps) is computed here, once. With
        a compute dtype on the UNet, its weights are cast here, in place.
        """
        cond = self.condition(batch).float()
        kwargs = {}
        if self.arch in _RRDB_ARCHS:
            _, kwargs["rrdb_feats"] = self.encode_rrdb(batch["LR"])
        if self.unet.dtype is not None:
            self.unet.to(self.unet.dtype)  # no-op once cast
        self.unet.eval()
        kwargs.update(self._conditioning(cond))
        if hasattr(self.unet, "fd_spliter"):
            kwargs["cond_feats"] = self.unet(cond, cond_features_only=True)

        def denoise_fn(x_t, noise_level):
            return self.unet(self._x_in(cond, x_t), noise_level, **kwargs)

        return cond, denoise_fn

    @torch.no_grad()
    def generate_sr(
        self,
        batch: dict,
        schedule: Schedule,
        *,
        generator: Optional[torch.Generator] = None,
        clip_denoised: bool = True,
        keep_every: Optional[int] = None,
        sampler: str = "ddpm",
        ddim_steps: int = 50,
        ddim_eta: float = 0.0,
        tau_spacing: str = "linspace",
        init: Optional[torch.Tensor] = None,
        noises: Optional[Sequence[torch.Tensor]] = None,
    ):
        """Super-resolve an NHWC batch by the full reverse chain.

        sampler: "ddpm", "ddim" (`ddim_steps`, `ddim_eta`) or "dpm"
        (DPM-Solver++(2M), `ddim_steps` steps, deterministic). The
        conditioning is computed once, outside the step loop (`denoiser`).
        Noise comes from `generator`, or from `init` / `noises` (see
        diffusion/gaussian.py). keep_every:
        also return every keep_every-th intermediate field, residual added
        back, as [S // keep_every, B, H, W, C].
        """
        cond, denoise_fn = self.denoiser(batch)
        common = dict(device=cond.device, generator=generator, init=init,
                      clip_denoised=clip_denoised, keep_every=keep_every)
        shape = tuple(cond.shape)
        if sampler == "ddim":
            out = ddim_sample_chain(schedule, denoise_fn, shape, steps=ddim_steps, eta=ddim_eta,
                                    tau_spacing=tau_spacing, noises=noises, **common)
        elif sampler == "dpm":
            out = dpm_solver_chain(schedule, denoise_fn, shape, steps=ddim_steps,
                                   tau_spacing=tau_spacing, **common)
        elif sampler == "ddpm":
            out = sample_chain(schedule, denoise_fn, shape, noises=noises, **common)
        else:
            raise ValueError(f"unknown sampler {sampler!r} (ddpm, ddim, dpm)")
        img, frames = out if keep_every is not None else (out, None)
        if self.arch != "sr3":
            img = img + cond
            if frames is not None:
                frames = frames + cond[None]
        return img if frames is None else (img, frames)

    @torch.no_grad()
    def sample(
        self,
        batch_size: int,
        schedule: Schedule,
        *,
        device: torch.device | str,
        generator: Optional[torch.Generator] = None,
        clip_denoised: bool = True,
        init: Optional[torch.Tensor] = None,
        noises: Optional[Sequence[torch.Tensor]] = None,
    ) -> torch.Tensor:
        """Unconditional DDPM generation (diffusion.conditional false): the
        UNet sees x_t alone; [B, image_height, image_width, image_channels]."""
        if self.conditional:
            raise ValueError("unconditional sample() requires conditional=False")
        u = self.unet
        if u.dtype is not None:
            u.to(u.dtype)
        u.eval()
        shape = (batch_size, u.image_height, u.image_width, u.image_channels)
        return sample_chain(schedule, lambda x_t, lvl: u(x_t, lvl), shape, device=device,
                            generator=generator, init=init, noises=noises,
                            clip_denoised=clip_denoised)


def build_model(model_cfg: dict, dtype: Optional[torch.dtype] = None) -> DiffusionModel:
    """Construct a DiffusionModel from the reference config schema (opt["model"])."""
    arch = model_cfg.get("architecture", "sr3")
    unet_cfg = model_cfg.get("unet", {})
    diff_cfg = model_cfg.get("diffusion", {})
    pre_cfg = model_cfg.get("pretrained_model") or {}
    channels = int(diff_cfg.get("channels", 1))
    image_channels = int(diff_cfg.get("image_channels", channels))
    conditional = bool(diff_cfg.get("conditional", True))
    nf, nb = int(pre_cfg.get("hidden_size", 64)), int(pre_cfg.get("num_block", 17))
    if dtype == torch.float32:
        dtype = None
    unet = WeatherUNet(
        variant=arch,
        # the UNet's input is concat(condition, x_t), or x_t alone for srdiff
        # and unconditional sr3, as flax infers it from the input; the
        # config's in_channel counts phydiff's stencil maps (or the
        # spliter's stack) in some configs and not in others, so it is not
        # read
        in_channel=(2 if conditional and arch != "srdiff" else 1) * image_channels,
        out_channel=int(unet_cfg.get("out_channel", channels)),
        inner_channel=int(unet_cfg.get("inner_channel", 64)),
        norm_groups=int(unet_cfg.get("norm_groups", 32)),
        channel_mults=tuple(unet_cfg.get("channel_multiplier", (1, 2, 4, 8, 8))),
        attn_res=tuple(unet_cfg.get("attn_res", (16,))),
        res_blocks=int(unet_cfg.get("res_blocks", 2)),
        dropout=float(unet_cfg.get("dropout", 0.0)),
        image_height=int(diff_cfg.get("image_height", 128)),
        image_width=int(diff_cfg.get("image_width", 256)),
        image_channels=image_channels,
        rrdb_num_feats=nf,
        rrdb_num_blocks=nb,
        dtype=dtype,
    )
    encoder = None
    if arch in _RRDB_ARCHS:
        # the SR head feeds the unlocked encoder's aux loss against
        # sigma-scaled HR, which the reference's [0,1] clamp saturates
        encoder = RRDBNet(in_nc=channels, out_nc=channels, nf=nf, nb=nb, gc=nf // 2,
                          dtype=dtype, clamp_output=False)
    elif arch in ("resdiff", "phydiff") and (pre_cfg.get("model_path") is not None
                                             or bool(pre_cfg.get("enabled", False))):
        encoder = SimpleCNN(scale_factor=4, channels=channels, dtype=dtype)
    return DiffusionModel(
        arch=arch, unet=unet, encoder=encoder, conditional=conditional,
        loss_type=model_cfg.get("loss_type", "l1"),
        lock_encoder=bool(pre_cfg.get("lock_weights", True)),
        use_encoder_prediction=bool(pre_cfg.get("use_encoder_prediction", False)),
    )
