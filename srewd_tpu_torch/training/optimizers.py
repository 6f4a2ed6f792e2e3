"""Optimizer registry onto torch.optim (port of srewd_tpu/training/optimizers.py).

Each name maps to the optimizer it names, with optax's defaults where
torch's differ, so that one step here matches one optax step:
adam, amsgrad (Adam with amsgrad), adamw (weight decay 1e-4, optax's),
sgd and asgd (both plain SGD, as the JAX package maps them), rmsprop
(decay 0.9), adadelta, adagrad (initial accumulator 0.1, eps 1e-7), adamax.
lamb and lion have no torch.optim class and raise.

`clip_by_global_norm_` is optax.clip_by_global_norm: every gradient is
scaled by max_norm / ||g|| when ||g|| >= max_norm (torch's clip_grad_norm_
adds 1e-6 to the norm; this does not). `norm_parameters` is the
finetune_norm trainable set: the GroupNorm affine parameters only.
"""

from __future__ import annotations

import torch
import torch.nn as nn

_LATER = "ROADMAP.md Queue 1 item 10 (lamb and lion)"


def get_optimizer(name: str, params, lr: float, **kwargs) -> torch.optim.Optimizer:
    name = (name or "adam").lower()
    table = {
        "adam": lambda: torch.optim.Adam(params, lr, **kwargs),
        "amsgrad": lambda: torch.optim.Adam(params, lr, amsgrad=True, **kwargs),
        "adamw": lambda: torch.optim.AdamW(params, lr, **{"weight_decay": 1e-4, **kwargs}),
        "sgd": lambda: torch.optim.SGD(params, lr, **kwargs),
        "asgd": lambda: torch.optim.SGD(params, lr, **kwargs),
        "rmsprop": lambda: torch.optim.RMSprop(params, lr, **{"alpha": 0.9, **kwargs}),
        "adadelta": lambda: torch.optim.Adadelta(params, lr, **kwargs),
        "adagrad": lambda: torch.optim.Adagrad(
            params, lr, **{"initial_accumulator_value": 0.1, "eps": 1e-7, **kwargs}),
        "adamax": lambda: torch.optim.Adamax(params, lr, **kwargs),
    }
    if name in ("lamb", "lion"):
        raise NotImplementedError(f"optimizer {name!r} has no torch.optim class: {_LATER}")
    if name not in table:
        raise ValueError(f"unknown optimizer {name}; options: {sorted(table) + ['lamb', 'lion']}")
    return table[name]()


@torch.no_grad()
def clip_by_global_norm_(params, max_norm: float) -> torch.Tensor:
    """Scale the gradients in place as optax.clip_by_global_norm; returns the
    global norm (a device scalar, not read on the host)."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return torch.zeros(())
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


def norm_parameters(module: nn.Module) -> list:
    """(name, parameter) of every GroupNorm affine parameter in `module`."""
    from ..models.blocks import FusedGroupNorm

    out = []
    for mname, m in module.named_modules():
        if isinstance(m, FusedGroupNorm):
            out += [(f"{mname}.{pname}", p) for pname, p in m.named_parameters()]
    return out
