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

Compute dtype (`build_model(dtype=)`): the UNet and the encoder keep
float32 parameters and compute in the dtype, each layer casting its weights
per call (models/layers.py), as flax's `dtype` does; training therefore
steps float32 master weights with float32 gradients and moments. The loss
keeps the UNet's output in the compute dtype and takes `noise - eps` in
float32, as JAX promotes it. A reverse chain instead casts the UNet's
weights once, into a shadow copy of the UNet that `denoiser` refreshes from
the master weights at the start of each chain (the JAX package pre-casts
its params once, outside the scan); the master weights never change dtype.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
from typing import Optional, Sequence

import torch
import torch.nn as nn

from ..diffusion.gaussian import (
    ChainPlan,
    chain_plan,
    draw_time_and_gamma,
    q_sample,
    run_chain,
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
    # the UNet's weights in its compute dtype, for reverse chains (`_chain_unet`)
    _shadow: Optional[WeatherUNet] = dataclasses.field(default=None, init=False, repr=False)

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
        self._shadow = None
        return self

    def params(self) -> dict:
        """The weights as {"unet": state_dict, "encoder": state_dict}
        ("encoder" only where there is one), as the JAX param tree holds
        them; what the serving layer takes."""
        out = {"unet": self.unet.state_dict()}
        if self.encoder is not None:
            out["encoder"] = self.encoder.state_dict()
        return out

    @torch.no_grad()
    def with_params(self, params: dict, device) -> "DiffusionModel":
        """A new DiffusionModel of this one's structure on `device`, in eval
        mode without gradients, holding a copy of `params` (`params()`'s
        form): the serving layer's snapshot. On a card the copies are done
        when it returns, so another stream may read them at once."""
        device = torch.device(device)
        snap = dataclasses.replace(
            self, unet=copy.deepcopy(self.unet).to(device),
            encoder=None if self.encoder is None else copy.deepcopy(self.encoder).to(device))
        snap.unet.load_state_dict(params["unet"], strict=True)
        if snap.encoder is not None:
            snap.encoder.load_state_dict(params["encoder"], strict=True)
        for m in (snap.unet, snap.encoder):
            if m is not None:
                m.requires_grad_(False).eval()
        if device.type == "cuda":
            torch.cuda.current_stream(device).synchronize()
        return snap

    @torch.no_grad()
    def _chain_unet(self) -> WeatherUNet:
        """The UNet a reverse chain calls, in eval mode: the UNet itself in
        float32; with a compute dtype, a shadow copy whose parameters are the
        master weights cast to it, refreshed here (once per chain)."""
        dt = self.unet.dtype
        if dt is None:
            return self.unet.eval()
        params = list(self.unet.parameters())
        shadow = self._shadow
        if shadow is None or shadow.dtype != dt or params[0].device != next(
                shadow.parameters()).device:
            memo = {id(p): nn.Parameter(torch.empty_like(p, dtype=dt), requires_grad=False)
                    for p in params}
            shadow = self._shadow = copy.deepcopy(self.unet, memo)
        torch._foreach_copy_(list(shadow.parameters()), params)
        return shadow.eval()

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
        eps = self.unet(self._x_in(cond, x_noisy), gamma, **kwargs)  # in the compute dtype
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
    def chain_conditioning(self, batch: dict, unet: WeatherUNet) -> tuple:
        """(condition, consts): the condition image, float32, and the UNet's
        chain-constant keyword inputs (RRDB taps, DWT pyramid, stencil maps,
        the spliter's frequency maps) for `unet`, the chain's UNet
        (`_chain_unet`). Computed once per chain; the exported conditioning
        program is this function."""
        cond = self.condition(batch).float()
        consts = {}
        if self.arch in _RRDB_ARCHS:
            _, consts["rrdb_feats"] = self.encode_rrdb(batch["LR"])
        consts.update(self._conditioning(cond))
        if hasattr(unet, "fd_spliter"):
            consts["cond_feats"] = unet(cond, cond_features_only=True)
        return cond, consts

    def chain_eps(self, unet: WeatherUNet, cond: torch.Tensor, consts: dict,
                  x_t: torch.Tensor, noise_level: torch.Tensor) -> torch.Tensor:
        """One UNet call of a reverse chain: eps for (x_t, noise_level)."""
        return unet(self._x_in(cond, x_t), noise_level, **consts)

    @torch.no_grad()
    def denoiser(self, batch: dict) -> tuple:
        """(condition, denoise_fn(x_t, noise_level) -> eps) of a reverse chain.

        The chain-constant conditioning (`chain_conditioning`) is computed
        here, once, and so is the cast of the UNet's weights to its compute
        dtype (`_chain_unet`).
        """
        unet = self._chain_unet()
        cond, consts = self.chain_conditioning(batch, unet)

        def denoise_fn(x_t, noise_level):
            return self.chain_eps(unet, cond, consts, x_t, noise_level)

        return cond, denoise_fn

    def add_back(self, img: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        """The field from the chain's output: the residual archs add the
        condition back."""
        return img if self.arch == "sr3" else img + cond

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
        plan: Optional[ChainPlan] = None,
    ):
        """Super-resolve an NHWC batch by the full reverse chain.

        sampler: "ddpm", "ddim" (`ddim_steps`, `ddim_eta`) or "dpm"
        (DPM-Solver++(2M), `ddim_steps` steps, deterministic); `plan`, a
        `chain_plan` of them made beforehand, replaces the four (a service
        makes it once: it reads the schedule on the host). The
        conditioning is computed once, outside the step loop (`denoiser`).
        Noise comes from `generator`, or from `init` / `noises` (see
        diffusion/gaussian.py). keep_every:
        also return every keep_every-th intermediate field, residual added
        back, as [S // keep_every, B, H, W, C].
        """
        cond, denoise_fn = self.denoiser(batch)
        if plan is None:
            plan = chain_plan(schedule, sampler, steps=ddim_steps, eta=ddim_eta,
                              tau_spacing=tau_spacing, device=cond.device)
        out = run_chain(plan, denoise_fn, tuple(cond.shape), device=cond.device,
                        generator=generator, init=init, noises=noises,
                        clip_denoised=clip_denoised, keep_every=keep_every)
        img, frames = out if keep_every is not None else (out, None)
        img = self.add_back(img, cond)
        if frames is not None:
            frames = self.add_back(frames, cond[None])
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
        u = self._chain_unet()
        shape = (batch_size, u.image_height, u.image_width, u.image_channels)
        return run_chain(chain_plan(schedule, "ddpm", device=device), lambda x_t, lvl: u(x_t, lvl),
                         shape, device=device, generator=generator, init=init, noises=noises,
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
