"""Plain reference of the diffusion parts: the beta schedule, the training
loss of one draw, the DDIM chain, and Adam.

The definitions are the configurations' (SR3's continuous noise level,
SRDiff's residual target and encoder loss, DDIM arXiv:2010.02502):
* schedule: linear betas over T steps in float64; the stored constants
  float32; the noise level of step t is sqrt(prod_{s<=t} alpha_s).
* training draw: one t ~ U{1..T} for the batch, then a level gamma per
  sample from uniforms u, gamma = max(lo, lo + u (hi - lo)) with lo, hi
  the levels at t-1 and t (the system's documented draw: hi < lo, so
  every sample takes lo), then x_t = gamma x0 + sqrt(1 - gamma^2) eps.
  t, u and eps come, in that order, from one generator; Dropout's masks
  from the device's default generator.
* target: HR minus the bicubic x4 of LR (both configurations are
  residual); loss: mean |eps - eps_hat|, plus mean |RRDB(LR) - HR| where
  the encoder trains with the UNet (SRDiff unlocked).
* DDIM with eta 0 over round(linspace(0, T-1, steps)): x0 clipped to
  [-1, 1] and eps taken again from the clipped x0; the field is the
  chain's output plus the condition.
"""

from __future__ import annotations

import numpy as np
import torch

from . import ops


class Schedule:
    def __init__(self, cfg: dict, device):
        betas = np.linspace(float(cfg["linear_start"]), float(cfg["linear_end"]),
                            int(cfg["n_timestep"]), dtype=np.float64)
        if cfg.get("schedule", "linear") != "linear":
            raise ValueError("the reference has the linear schedule only")
        acp = np.cumprod(1.0 - betas)
        self.T = len(betas)
        self.acp = torch.tensor(acp.astype(np.float32), device=device)
        self.level = torch.tensor(np.sqrt(np.append(1.0, acp)).astype(np.float32), device=device)


def draws(schedule: Schedule, n: int, shape: tuple, generator, device):
    """(t, u, eps) of one training step, drawn in the system's order."""
    t = torch.randint(1, schedule.T + 1, (1,), generator=generator, device=device)
    u = torch.rand((n,), generator=generator, device=device, dtype=torch.float32)
    eps = torch.randn((n, *shape), generator=generator, device=device, dtype=torch.float32)
    return t, u, eps


def loss(unet, encoder, batch: dict, schedule: Schedule, t, u, eps, train_encoder: bool):
    """The training loss of one draw (srdiff: x_t alone into the UNet and
    the RRDB taps as its condition; phydiff: concat(condition, x_t))."""
    hr, lr = batch["HR"], batch["LR"]
    cond = ops.bicubic_up4(lr)
    lo, hi = schedule.level[t - 1], schedule.level[t]
    gamma = torch.maximum(lo, u * (hi - lo) + lo).reshape(-1, 1, 1, 1)
    x_t = gamma * (hr - cond) + torch.sqrt(1.0 - gamma * gamma) * eps
    extra = 0.0
    if unet.variant == "srdiff":
        sr, taps = encoder(lr)
        eps_hat = unet(x_t, gamma.reshape(-1), rrdb_feats=taps)
        if train_encoder:
            extra = (sr - hr).abs().mean()
    else:
        eps_hat = unet(torch.cat([cond, x_t], dim=-1), gamma.reshape(-1), condition=cond)
    return (eps - eps_hat).abs().mean() + extra


@torch.no_grad()
def ddim_sample(unet, lr, init, schedule: Schedule, steps: int, rrdb=None):
    """The field of a DDIM chain with eta 0 from `init` (NHWC noise)."""
    cond = ops.bicubic_up4(lr)
    taps = rrdb(lr)[1] if rrdb is not None else None
    taus = np.unique(np.linspace(0, schedule.T - 1, steps).round().astype(np.int64))
    x = init
    b = x.shape[0]
    for i in range(len(taus) - 1, -1, -1):
        tau = int(taus[i])
        a_t = schedule.acp[tau]
        a_prev = schedule.acp[int(taus[i - 1])] if i > 0 else torch.ones_like(a_t)
        level = schedule.level[tau + 1].expand(b)
        if unet.variant == "srdiff":
            eps = unet(x, level, rrdb_feats=taps)
        else:
            eps = unet(torch.cat([cond, x], dim=-1), level, condition=cond)
        x0 = ((x - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)).clamp(-1.0, 1.0)
        eps = (x - torch.sqrt(a_t) * x0) / torch.sqrt(1.0 - a_t)
        x = torch.sqrt(a_prev) * x0 + torch.sqrt(1.0 - a_prev) * eps
    return x + cond


class Adam:
    """Adam (Kingma and Ba) with bias correction, eps outside the root."""

    def __init__(self, params, lr=1e-4, betas=(0.9, 0.999), eps=1e-8):
        self.params = list(params)
        self.lr, (self.b1, self.b2), self.eps = lr, betas, eps
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self):
        self.t += 1
        c1, c2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        for p, m, v in zip(self.params, self.m, self.v):
            if p.grad is None:
                continue
            m.mul_(self.b1).add_(p.grad, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(p.grad, p.grad, value=1.0 - self.b2)
            p.sub_(self.lr * (m / c1) / ((v / c2).sqrt() + self.eps))
