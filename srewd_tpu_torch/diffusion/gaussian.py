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
sub-sequence for DDIM, exactly the integers the JAX chains `fold_in`
(DPM-Solver++ is deterministic after `init`). Tests feed the noise JAX
draws, so both chains see the same numbers.

`keep_every=k` (the reference's `continous` mode) also returns the image
after every k-th step as [S // k, *shape], S the steps walked; the last
S mod k steps make no frame, as the JAX chains' segmented scans.
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


def _frames(img: torch.Tensor, frames: list, step: int, n_steps: int,
            keep_every: Optional[int]) -> None:
    """Keep `img` after step `step` (0-based) of `n_steps` when it closes one
    of the n_steps // keep_every whole segments."""
    if keep_every is not None and (step + 1) % keep_every == 0 \
            and step + 1 <= (n_steps // keep_every) * keep_every:
        frames.append(img)


def _result(img: torch.Tensor, frames: list, keep_every: Optional[int]):
    if keep_every is None:
        return img
    return img, (torch.stack(frames) if frames else img.new_zeros((0, *img.shape)))


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
    keep_every: Optional[int] = None,
):
    """Full T-step DDPM reverse chain from pure noise."""
    img = init.to(device=device, dtype=torch.float32) if init is not None else _draw(
        shape, generator, device, None, 0)
    n_steps = schedule.num_timesteps
    frames: list = []
    for step, t in enumerate(range(n_steps - 1, -1, -1)):
        noise = _draw(shape, generator, device, noises, t) if t > 0 else None
        img = p_sample_step(schedule, denoise_fn, img, t, noise, clip_denoised)
        _frames(img, frames, step, n_steps, keep_every)
    return _result(img, frames, keep_every)


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
    keep_every: Optional[int] = None,
):
    """DDIM (arXiv:2010.02502) over a `steps`-long timestep sub-sequence."""
    taus = torch.as_tensor(select_taus(schedule, steps, tau_spacing), device=device)
    a_t = schedule.alphas_cumprod[taus]
    a_prev = torch.cat([a_t.new_ones(1), schedule.alphas_cumprod[taus[:-1]]])
    lvl_t = schedule.sqrt_alphas_cumprod_prev[taus + 1]  # sqrt(acp[tau])

    img = init.to(device=device, dtype=torch.float32) if init is not None else _draw(
        shape, generator, device, None, 0)
    b = shape[0]
    n_steps = len(taus)
    frames: list = []
    for step, i in enumerate(range(n_steps - 1, -1, -1)):
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
        _frames(img, frames, step, n_steps, keep_every)
    return _result(img, frames, keep_every)


def _dpm_solver_coefficients(schedule: Schedule, steps: int, tau_spacing: str = "linspace"):
    """Per-step constants of DPM-Solver++(2M) in execution order (descending
    tau), float64 numpy from the float32 alphas_cumprod, as the JAX chain
    computes them: sigma_t / sigma_s, alpha_t, e^{-h} - 1, the multistep
    weight c, sqrt(acp_s), sigma_s and the noise level sqrt_acp_prev[tau+1].

    e^{-h} = (alpha_s sigma_t) / (sigma_s alpha_t) in closed form, so the
    final step to acp = 1 (sigma_t = 0) needs no infinite lambda; c[0] = 0
    (no previous x0) and c[-1] = 0 (first order at the end).
    """
    taus = select_taus(schedule, steps, tau_spacing)
    acp = schedule.alphas_cumprod.double().cpu().numpy()
    a_src = acp[taus[::-1]]
    a_dst = np.concatenate([a_src[1:], [1.0]])
    al_s, sg_s = np.sqrt(a_src), np.sqrt(1.0 - a_src)
    al_t, sg_t = np.sqrt(a_dst), np.sqrt(1.0 - a_dst)
    em1 = al_s * sg_t / (sg_s * al_t) - 1.0
    lam_s = 0.5 * np.log(a_src / (1.0 - a_src))
    with np.errstate(divide="ignore"):  # final lambda_t = +inf
        lam_t = 0.5 * np.log(a_dst / np.maximum(1.0 - a_dst, 0.0))
    h = lam_t - lam_s
    c = np.zeros_like(h)
    if len(h) > 2:
        c[1:-1] = h[1:-1] / (2.0 * h[:-2])
    lvl = schedule.sqrt_alphas_cumprod_prev.double().cpu().numpy()[taus[::-1] + 1]
    return np.stack([sg_t / sg_s, al_t, em1, c, np.sqrt(a_src), sg_s, lvl]).astype(np.float32)


def dpm_solver_chain(
    schedule: Schedule,
    denoise_fn: DenoiseFn,
    shape: tuple,
    *,
    device: torch.device | str,
    steps: int = 25,
    clip_denoised: bool = True,
    tau_spacing: str = "linspace",
    generator: Optional[torch.Generator] = None,
    init: Optional[torch.Tensor] = None,
    keep_every: Optional[int] = None,
):
    """DPM-Solver++(2M) (arXiv:2211.01095): the deterministic second-order
    multistep sampler in the x0 parameterization, over DDIM's timestep
    sub-sequence and noise levels; one denoiser call per step. The first
    and the last step are first order (the DDIM eta=0 update); the others
    extrapolate D = (1 + c) x0_i - c x0_{i-1}."""
    coef = torch.from_numpy(_dpm_solver_coefficients(schedule, steps, tau_spacing)).to(device)
    img = init.to(device=device, dtype=torch.float32) if init is not None else _draw(
        shape, generator, device, None, 0)
    prev_x0 = torch.zeros_like(img)
    b = shape[0]
    n_steps = coef.shape[1]
    frames: list = []
    for step in range(n_steps):
        sig_ratio, alpha_t, em1, c, sqrt_as, sig_s, lvl = coef[:, step]
        eps = denoise_fn(img, lvl.expand(b)).float()
        x0 = (img - sig_s * eps) / sqrt_as
        if clip_denoised:
            x0 = x0.clamp(-1.0, 1.0)
        d = (1.0 + c) * x0 - c * prev_x0
        img = sig_ratio * img - alpha_t * em1 * d
        prev_x0 = x0
        _frames(img, frames, step, n_steps, keep_every)
    return _result(img, frames, keep_every)
