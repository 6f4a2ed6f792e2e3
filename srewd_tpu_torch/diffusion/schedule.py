"""Beta schedules and diffusion constants (port of srewd_tpu/diffusion/schedule.py).

The math is float64 numpy; the stored constants are float32 tensors on the
chosen device, so the sampling loop indexes them there without a host
round trip.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def _warmup_beta(linear_start, linear_end, n_timestep, warmup_frac):
    betas = linear_end * np.ones(n_timestep, dtype=np.float64)
    warmup_time = int(n_timestep * warmup_frac)
    betas[:warmup_time] = np.linspace(linear_start, linear_end, warmup_time, dtype=np.float64)
    return betas


def make_beta_schedule(
    schedule: str,
    n_timestep: int,
    linear_start: float = 1e-4,
    linear_end: float = 2e-2,
    cosine_s: float = 8e-3,
) -> np.ndarray:
    """The reference's seven schedules, float64 numpy."""
    if schedule == "quad":
        betas = np.linspace(linear_start**0.5, linear_end**0.5, n_timestep, dtype=np.float64) ** 2
    elif schedule == "linear":
        betas = np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64)
    elif schedule == "warmup10":
        betas = _warmup_beta(linear_start, linear_end, n_timestep, 0.1)
    elif schedule == "warmup50":
        betas = _warmup_beta(linear_start, linear_end, n_timestep, 0.5)
    elif schedule == "const":
        betas = linear_end * np.ones(n_timestep, dtype=np.float64)
    elif schedule == "jsd":
        betas = 1.0 / np.linspace(n_timestep, 1, n_timestep, dtype=np.float64)
    elif schedule == "cosine":
        timesteps = np.arange(n_timestep + 1, dtype=np.float64) / n_timestep + cosine_s
        alphas = np.cos(timesteps / (1 + cosine_s) * math.pi / 2) ** 2
        alphas = alphas / alphas[0]
        betas = np.clip(1 - alphas[1:] / alphas[:-1], None, 0.999)
    else:
        raise NotImplementedError(schedule)
    return betas


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Diffusion constants as float32 tensors on one device."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod_prev: torch.Tensor  # length T+1
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    num_timesteps: int

    @classmethod
    def create(
        cls,
        schedule: str = "linear",
        n_timestep: int = 1000,
        linear_start: float = 1e-6,
        linear_end: float = 1e-2,
        cosine_s: float = 8e-3,
        device: torch.device | str = "cpu",
    ) -> "Schedule":
        betas = make_beta_schedule(schedule, n_timestep, linear_start, linear_end, cosine_s)
        alphas = 1.0 - betas
        alphas_cumprod = np.cumprod(alphas, axis=0)
        alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
        posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)

        def f32(a):
            return torch.tensor(np.asarray(a, np.float32), device=device)

        return cls(
            betas=f32(betas),
            alphas_cumprod=f32(alphas_cumprod),
            alphas_cumprod_prev=f32(alphas_cumprod_prev),
            sqrt_alphas_cumprod_prev=f32(np.sqrt(np.append(1.0, alphas_cumprod))),
            sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod)),
            sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod - 1.0)),
            posterior_variance=f32(posterior_variance),
            posterior_log_variance_clipped=f32(np.log(np.maximum(posterior_variance, 1e-20))),
            posterior_mean_coef1=f32(betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod)),
            posterior_mean_coef2=f32(
                (1.0 - alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - alphas_cumprod)
            ),
            num_timesteps=int(n_timestep),
        )

    @classmethod
    def from_config(cls, cfg: dict, device: torch.device | str = "cpu") -> "Schedule":
        return cls.create(
            schedule=cfg.get("schedule", "linear"),
            n_timestep=int(cfg.get("n_timestep", 1000)),
            linear_start=float(cfg.get("linear_start", 1e-6)),
            linear_end=float(cfg.get("linear_end", 1e-2)),
            cosine_s=float(cfg.get("cosine_s", 8e-3)),
            device=device,
        )

    def to(self, device: torch.device | str) -> "Schedule":
        """The same constants on `device` (self where they are there already):
        each serving replica indexes its own copy."""
        if self.betas.device == torch.device(device):
            return self
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device) for f in dataclasses.fields(self)
            if f.name != "num_timesteps"})
