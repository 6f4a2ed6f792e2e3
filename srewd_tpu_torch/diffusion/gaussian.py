"""Gaussian diffusion: the training draws and the reverse samplers (port of
srewd_tpu/diffusion/gaussian.py).

Training draws ONE integer t ~ U[1, T] per batch, then a continuous level
gamma ~ U(sqrt_acp_prev[t-1], sqrt_acp_prev[t]) per sample
(`draw_time_and_gamma`), and noises x0 to x_t = gamma x0 + sqrt(1 - gamma^2)
eps (`q_sample`). The draws stay on the device: t is a one-element tensor,
so nothing waits on the host.

The JAX `lax.scan`s of the three samplers (DDPM, DDIM, DPM-Solver++)
become one Python loop over tensors on the device (`run_chain`). A
sampler is a `ChainPlan` (`chain_plan`), its per-step constants as one
table on the device in execution order, and one step function,
`chain_step`: a pure tensor function of (the table, the step index as a
tensor, x, the denoiser, the step's noise, the previous x0). The eager
loop and the exported step program (serving/export.py) both call it, so
the two cannot drift apart. Where the JAX chains branch on the step (DDPM's and DDIM's
last step draw no noise), the table holds a gate that selects; where they
start differently (DPM-Solver++'s first step is first order), its
multistep weight is 0 there.

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

import dataclasses
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


def _draw(shape, generator, device, noises, i):
    if noises is not None:
        return noises[i].to(device=device, dtype=torch.float32)
    return torch.randn(shape, generator=generator, device=device, dtype=torch.float32)


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


@dataclasses.dataclass(frozen=True)
class ChainPlan:
    """One reverse chain's constants.

    kind: "ddpm", "ddim" or "dpm" (which update `chain_step` applies).
    coef: float32 [rows, n_steps] on the device, column s the constants of
      the s-th step taken; row 0 is the denoiser's noise level.
    noise_ids: per step, the index into `noises` of its noise (t for DDPM,
      the sub-sequence index for DDIM), or None where it draws none; a
      generator draws them in step order, after the initial image.
    """

    kind: str
    coef: torch.Tensor
    noise_ids: tuple

    @property
    def n_steps(self) -> int:
        return len(self.noise_ids)


def chain_plan(schedule: Schedule, sampler: str = "ddpm", *, steps: int = 50, eta: float = 0.0,
               tau_spacing: str = "linspace", device=None) -> ChainPlan:
    """The ChainPlan of `sampler`: "ddpm" (the full T-step chain), "ddim"
    (arXiv:2010.02502, `steps` of `tau_spacing`, stochasticity `eta`) or
    "dpm" (DPM-Solver++(2M), arXiv:2211.01095: the deterministic
    second-order multistep sampler in the x0 parameterization over DDIM's
    sub-sequence; the first and last steps first order, the others
    extrapolating D = (1 + c) x0_i - c x0_{i-1}). The DDPM and DDIM tables
    are gathered from the schedule on its device; DPM-Solver++'s are
    computed in float64 on the host, as the JAX chain computes them."""
    device = schedule.betas.device if device is None else torch.device(device)
    if sampler == "ddpm":
        n = schedule.num_timesteps
        t = torch.arange(n - 1, -1, -1, device=device)
        coef = torch.stack([
            schedule.sqrt_alphas_cumprod_prev[t + 1],  # the level sqrt(acp_prev)[t + 1]
            schedule.sqrt_recip_alphas_cumprod[t], schedule.sqrt_recipm1_alphas_cumprod[t],
            schedule.posterior_mean_coef1[t], schedule.posterior_mean_coef2[t],
            schedule.posterior_log_variance_clipped[t], (t > 0).float(),  # no noise at t = 0
        ])
        return ChainPlan("ddpm", coef,
                         tuple(ti if ti > 0 else None for ti in range(n - 1, -1, -1)))
    if sampler == "ddim":
        taus = torch.as_tensor(select_taus(schedule, steps, tau_spacing), device=device)
        n = len(taus)
        a_t = schedule.alphas_cumprod[taus]
        a_prev = torch.cat([a_t.new_ones(1), schedule.alphas_cumprod[taus[:-1]]])
        sigma = (eta * torch.sqrt((1.0 - a_prev) / (1.0 - a_t))
                 * torch.sqrt(torch.clamp(1.0 - a_t / a_prev, min=0.0)))
        noisy = [i > 0 and eta != 0.0 for i in range(n)]
        coef = torch.stack([
            schedule.sqrt_alphas_cumprod_prev[taus + 1],  # sqrt(acp[tau])
            torch.sqrt(1.0 - a_t), torch.sqrt(a_t), torch.sqrt(a_prev),
            torch.sqrt(torch.clamp(1.0 - a_prev - sigma**2, min=0.0)), sigma,
            torch.tensor(noisy, dtype=torch.float32).to(device),
        ]).flip(1)  # execution order: descending tau
        return ChainPlan("ddim", coef,
                         tuple(i if noisy[i] else None for i in range(n - 1, -1, -1)))
    if sampler == "dpm":
        coef = torch.from_numpy(_dpm_solver_coefficients(schedule, steps, tau_spacing)).to(device)
        return ChainPlan("dpm", coef, (None,) * coef.shape[1])
    raise ValueError(f"unknown sampler {sampler!r} (ddpm, ddim, dpm)")


def _noise_level(coef: torch.Tensor, i: torch.Tensor, batch: int) -> torch.Tensor:
    """The denoiser's noise level [batch] at step `i` (an integer tensor)."""
    return coef[0].index_select(0, i.reshape(1)).expand(batch)


def chain_step(kind: str, coef: torch.Tensor, i: torch.Tensor, x: torch.Tensor,
               denoise_fn: DenoiseFn, noise: torch.Tensor, prev_x0: torch.Tensor,
               clip_denoised: bool = True) -> tuple:
    """One reverse step of a ChainPlan's sampler: (x_next, x0).

    `i` is the step's column of `coef` as an integer tensor; `noise` the
    step's noise (read only where the plan's gate is on); `prev_x0` the x0
    of the previous step (read by DPM-Solver++ only; zeros at the first).
    """
    eps = denoise_fn(x, _noise_level(coef, i, x.shape[0])).float()
    c = coef.index_select(1, i.reshape(1)).squeeze(1).unbind(0)
    if kind == "ddpm":
        _, recip, recipm1, coef1, coef2, log_var, gate = c
        x0 = recip * x - recipm1 * eps
        if clip_denoised:
            x0 = x0.clamp(-1.0, 1.0)
        mean = coef1 * x0 + coef2 * x
        return torch.where(gate > 0, mean + noise * torch.exp(0.5 * log_var), mean), x0
    if kind == "ddim":
        _, sqrt_1m_at, sqrt_at, sqrt_ap, dir_coef, sigma, gate = c
        x0 = (x - sqrt_1m_at * eps) / sqrt_at
        if clip_denoised:
            x0 = x0.clamp(-1.0, 1.0)
            # implied eps after clipping keeps the update self-consistent
            eps = (x - sqrt_at * x0) / sqrt_1m_at
        img = sqrt_ap * x0 + dir_coef * eps
        return torch.where(gate > 0, img + sigma * noise, img), x0
    if kind == "dpm":
        _, sig_ratio, alpha_t, em1, w, sqrt_as, sig_s = c
        x0 = (x - sig_s * eps) / sqrt_as
        if clip_denoised:
            x0 = x0.clamp(-1.0, 1.0)
        d = (1.0 + w) * x0 - w * prev_x0
        return sig_ratio * x - alpha_t * em1 * d, x0
    raise ValueError(f"unknown chain kind {kind!r}")


def run_chain(
    plan: ChainPlan,
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
    """Walk `plan` from `init` (or a draw) with `chain_step`."""
    img = init.to(device=device, dtype=torch.float32) if init is not None else _draw(
        shape, generator, device, None, 0)
    zero = torch.zeros_like(img)
    prev_x0 = zero
    steps = torch.arange(plan.n_steps, device=device)
    frames: list = []
    for s, nid in enumerate(plan.noise_ids):
        noise = zero if nid is None else _draw(shape, generator, device, noises, nid)
        img, prev_x0 = chain_step(plan.kind, plan.coef, steps[s], img, denoise_fn, noise,
                                  prev_x0, clip_denoised)
        _frames(img, frames, s, plan.n_steps, keep_every)
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


def _dpm_solver_coefficients(schedule: Schedule, steps: int, tau_spacing: str = "linspace"):
    """Per-step constants of DPM-Solver++(2M) in execution order (descending
    tau), float64 numpy from the float32 alphas_cumprod, as the JAX chain
    computes them: the noise level sqrt_acp_prev[tau+1], sigma_t / sigma_s,
    alpha_t, e^{-h} - 1, the multistep weight c, sqrt(acp_s) and sigma_s.

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
    return np.stack([lvl, sg_t / sg_s, al_t, em1, c, np.sqrt(a_src), sg_s]).astype(np.float32)
