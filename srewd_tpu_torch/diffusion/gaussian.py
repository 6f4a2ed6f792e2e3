"""Gaussian diffusion: the training draws and the reverse samplers (port of
srewd_tpu/diffusion/gaussian.py).

Training draws ONE integer t ~ U[1, T] per batch, then a continuous level
gamma ~ U(sqrt_acp_prev[t-1], sqrt_acp_prev[t]) per sample
(`draw_time_and_gamma`), and noises x0 to x_t = gamma x0 + sqrt(1 - gamma^2)
eps (`q_sample`). The draws stay on the device: t is a one-element tensor,
so nothing waits on the host.

The JAX `lax.scan` becomes a Python loop over tensors on the device; the
schedule constants are indexed there, so the loop never waits on the host.

Noise is an input. A chain draws its initial image and per-step noises from
`generator` (a `torch.Generator` on the device), unless the caller hands
them in: `init` is the initial image, and `noises[i]` the noise of step i,
where i is the timestep t for DDPM and the index into the DDIM timestep
sub-sequence for DDIM, exactly the integers the JAX chains `fold_in`. Tests
feed the noise JAX draws, so both chains see the same numbers.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .schedule import Schedule

# denoise_fn(x_t, noise_level[B]) -> predicted epsilon; conditioning closed over.
DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def q_sample(x_start: torch.Tensor, gamma: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Forward-noise x0 at the continuous level gamma ([B], per sample)."""
    g = gamma.reshape(-1, 1, 1, 1)
    return g * x_start + torch.sqrt(1.0 - g * g) * noise


def draw_time_and_gamma(
    schedule: Schedule,
    batch: int,
    *,
    generator: Optional[torch.Generator] = None,
    t: Optional[torch.Tensor] = None,
    u: Optional[torch.Tensor] = None,
):
    """(t, gamma): one t ~ U[1,T] per batch, gamma ~ U(s[t-1], s[t]) per sample,
    s = sqrt_alphas_cumprod_prev.

    `t` ([1] integer tensor) and `u` ([B] uniforms in [0, 1)) may be handed
    in instead of drawn from `generator`; gamma = max(lo, u (hi - lo) + lo),
    the form of jax.random.uniform(minval=lo, maxval=hi) in the JAX package.
    s falls with t, so lo > hi and that form gives gamma = lo for every
    sample; the reference's np.random.uniform(lo, hi) would spread gamma
    over the interval. The port keeps the JAX package's draw (ROADMAP.md
    Queue 3 records the difference).
    """
    device = schedule.betas.device
    if t is None:
        t = torch.randint(1, schedule.num_timesteps + 1, (1,), generator=generator,
                          device=device)
    if u is None:
        u = torch.rand(batch, generator=generator, device=device)
    t = t.to(device).reshape(1)
    lo = schedule.sqrt_alphas_cumprod_prev[t - 1]
    hi = schedule.sqrt_alphas_cumprod_prev[t]
    gamma = torch.maximum(lo, u.to(device) * (hi - lo) + lo)
    return t, gamma


def predict_start_from_noise(schedule: Schedule, x_t, t, eps):
    return (
        schedule.sqrt_recip_alphas_cumprod[t] * x_t
        - schedule.sqrt_recipm1_alphas_cumprod[t] * eps
    )


def q_posterior(schedule: Schedule, x_start, x_t, t):
    mean = schedule.posterior_mean_coef1[t] * x_start + schedule.posterior_mean_coef2[t] * x_t
    return mean, schedule.posterior_log_variance_clipped[t]


def _draw(shape, generator, device, noises, i):
    if noises is not None:
        return noises[i].to(device=device, dtype=torch.float32)
    return torch.randn(shape, generator=generator, device=device, dtype=torch.float32)


def p_sample_step(
    schedule: Schedule,
    denoise_fn: DenoiseFn,
    img: torch.Tensor,
    t: int,
    noise: Optional[torch.Tensor],
    clip_denoised: bool = True,
) -> torch.Tensor:
    """One reverse step x_t -> x_{t-1}. `noise` is unused at t == 0."""
    b = img.shape[0]
    # the denoiser sees the continuous level sqrt(acp_prev)[t + 1]
    noise_level = schedule.sqrt_alphas_cumprod_prev[t + 1].expand(b)
    eps = denoise_fn(img, noise_level).float()
    x_recon = predict_start_from_noise(schedule, img, t, eps)
    if clip_denoised:
        x_recon = x_recon.clamp(-1.0, 1.0)
    mean, log_var = q_posterior(schedule, x_recon, img, t)
    if t == 0:  # noise gated off at the last step
        return mean
    return mean + noise * torch.exp(0.5 * log_var)


def sample_chain(
    schedule: Schedule,
    denoise_fn: DenoiseFn,
    shape: tuple,
    *,
    device: torch.device | str,
    generator: Optional[torch.Generator] = None,
    init: Optional[torch.Tensor] = None,
    noises: Optional[Sequence[torch.Tensor]] = None,
    clip_denoised: bool = True,
) -> torch.Tensor:
    """Full T-step DDPM reverse chain from pure noise."""
    img = init.to(device=device, dtype=torch.float32) if init is not None else _draw(
        shape, generator, device, None, 0)
    for t in range(schedule.num_timesteps - 1, -1, -1):
        noise = _draw(shape, generator, device, noises, t) if t > 0 else None
        img = p_sample_step(schedule, denoise_fn, img, t, noise, clip_denoised)
    return img


def select_taus(schedule: Schedule, steps: int, spacing: str = "linspace") -> np.ndarray:
    """Timestep sub-sequence for DDIM (ascending, unique numpy int64).

    linspace: round(linspace(0, T-1, steps)); trailing: anchored at T-1;
    quad: denser near t=0; logsnr: uniform in half log-SNR, both endpoints
    pinned. Same definitions as srewd_tpu.diffusion.gaussian.select_taus.
    """
    t_total = schedule.num_timesteps
    steps = min(int(steps), t_total)
    if spacing == "linspace":
        taus = np.linspace(0, t_total - 1, steps).round()
    elif spacing == "trailing":
        taus = np.arange(t_total, 0, -t_total / steps).round() - 1
    elif spacing == "quad":
        taus = (np.linspace(0, np.sqrt(t_total - 1), steps) ** 2).round()
    elif spacing == "logsnr":
        acp = schedule.alphas_cumprod.double().cpu().numpy()
        lam = 0.5 * np.log(acp / np.maximum(1.0 - acp, 1e-20))
        targets = np.linspace(lam[-1], lam[0], steps)
        rev = lam[::-1]
        idx = np.clip(np.searchsorted(rev, targets), 1, t_total - 1)
        pick = np.where(np.abs(rev[idx] - targets) < np.abs(rev[idx - 1] - targets), idx, idx - 1)
        taus = np.concatenate([(t_total - 1) - pick, [0, t_total - 1]])
    else:
        raise ValueError(f"unknown tau spacing {spacing!r}")
    return np.unique(taus.astype(np.int64))


def ddim_sample_chain(
    schedule: Schedule,
    denoise_fn: DenoiseFn,
    shape: tuple,
    *,
    device: torch.device | str,
    steps: int = 50,
    eta: float = 0.0,
    clip_denoised: bool = True,
    tau_spacing: str = "linspace",
    generator: Optional[torch.Generator] = None,
    init: Optional[torch.Tensor] = None,
    noises: Optional[Sequence[torch.Tensor]] = None,
) -> torch.Tensor:
    """DDIM (arXiv:2010.02502) over a `steps`-long timestep sub-sequence."""
    taus = torch.as_tensor(select_taus(schedule, steps, tau_spacing), device=device)
    a_t = schedule.alphas_cumprod[taus]
    a_prev = torch.cat([a_t.new_ones(1), schedule.alphas_cumprod[taus[:-1]]])
    lvl_t = schedule.sqrt_alphas_cumprod_prev[taus + 1]  # sqrt(acp[tau])

    img = init.to(device=device, dtype=torch.float32) if init is not None else _draw(
        shape, generator, device, None, 0)
    b = shape[0]
    for i in range(len(taus) - 1, -1, -1):
        at, ap = a_t[i], a_prev[i]
        eps = denoise_fn(img, lvl_t[i].expand(b)).float()
        x0 = (img - torch.sqrt(1.0 - at) * eps) / torch.sqrt(at)
        if clip_denoised:
            x0 = x0.clamp(-1.0, 1.0)
            # implied eps after clipping keeps the update self-consistent
            eps = (img - torch.sqrt(at) * x0) / torch.sqrt(1.0 - at)
        sigma = (
            eta
            * torch.sqrt((1.0 - ap) / (1.0 - at))
            * torch.sqrt(torch.clamp(1.0 - at / ap, min=0.0))
        )
        dir_xt = torch.sqrt(torch.clamp(1.0 - ap - sigma**2, min=0.0)) * eps
        img = torch.sqrt(ap) * x0 + dir_xt
        if i > 0 and eta != 0.0:  # noise gated off at the last step
            img = img + sigma * _draw(shape, generator, device, noises, i)
    return img
