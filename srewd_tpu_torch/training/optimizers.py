"""Optimizer registry onto torch.optim (port of srewd_tpu/training/optimizers.py).

Each name maps to the optimizer it names, with optax's defaults where
torch's differ, so that one step here matches one optax step:
adam, amsgrad (Adam with amsgrad), adamw (weight decay 1e-4, optax's),
sgd and asgd (both plain SGD, as the JAX package maps them), rmsprop
(decay 0.9), adadelta, adagrad (initial accumulator 0.1, eps 1e-7), adamax,
and `Lamb` and `Lion` (below; torch.optim has neither): optax.lamb's and
optax.lion's math at their defaults, over the parameter list with
torch._foreach_* ops (no Python loop per tensor).

`clip_by_global_norm_` is optax.clip_by_global_norm: every gradient is
scaled by max_norm / ||g|| when ||g|| >= max_norm (torch's clip_grad_norm_
adds 1e-6 to the norm; this does not). `norm_parameters` is the
finetune_norm trainable set: the GroupNorm affine parameters only.

Sharded parameters (parallel/distributed.py ShardedModule) hold a rank's
rows of a leaf. Adam's and Lion's steps are elementwise and need nothing;
the norms of Lamb's trust ratio and of the clip are the full leaves',
which `leaf_norms(params, tensors)` gives: the local norms by default,
ShardedModule.leaf_norms under sharding.
"""

from __future__ import annotations

import torch
import torch.nn as nn


def local_leaf_norms(params: list, tensors: list) -> torch.Tensor:
    """The 2-norm of each tensor (`params` unused: the leaves are whole)."""
    return torch.stack(torch._foreach_norm(tensors))


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
        "lamb": lambda: Lamb(params, lr, **kwargs),
        "lion": lambda: Lion(params, lr, **kwargs),
    }
    if name not in table:
        raise ValueError(f"unknown optimizer {name}; options: {sorted(table)}")
    return table[name]()


def _grouped(group: dict, state: dict, names: tuple) -> tuple:
    """(params, grads, steps, [state tensors per name]) of the group's
    parameters that have a gradient; each parameter's state is made zero on
    its first step, its step count a float32 CPU scalar (torch.optim's form,
    which load_state_dict keeps on the CPU)."""
    params, grads, steps, bufs = [], [], [], [[] for _ in names]
    for p in group["params"]:
        if p.grad is None:
            continue
        st = state[p]
        if not st:
            st["step"] = torch.tensor(0.0)
            for n in names:
                st[n] = torch.zeros_like(p, memory_format=torch.preserve_format)
        st["step"] += 1
        params.append(p)
        grads.append(p.grad)
        steps.append(st["step"].item())
        for buf, n in zip(bufs, names):
            buf.append(st[n])
    return params, grads, steps, bufs


class Lamb(torch.optim.Optimizer):
    """optax.lamb: Adam's moments with bias correction (b1 0.9, b2 0.999,
    eps 1e-6 outside the root, eps_root 0 inside it), then + weight_decay * p
    (default 0), then each tensor's update scaled by its trust ratio
    ||p|| / ||u||, which is 1 where either norm is 0 (a zero-initialised
    bias, a zero update), then p -= lr * update. State per parameter:
    `exp_avg` (optax's mu), `exp_avg_sq` (nu) and `step` (count). The
    attribute `leaf_norms` gives the norms (module docstring)."""

    def __init__(self, params, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-6, eps_root: float = 0.0, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps, eps_root=eps_root,
                                      weight_decay=weight_decay))
        self.leaf_norms = local_leaf_norms

    @torch.no_grad()
    def step(self, closure=None):
        loss = None if closure is None else closure()
        for group in self.param_groups:
            params, grads, steps, (mu, nu) = _grouped(group, self.state,
                                                      ("exp_avg", "exp_avg_sq"))
            if not params:
                continue
            b1, b2 = group["b1"], group["b2"]
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, grads, alpha=1.0 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
            denom = torch._foreach_div(nu, [1.0 - b2 ** s for s in steps])
            if group["eps_root"]:
                torch._foreach_add_(denom, group["eps_root"])
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, group["eps"])
            update = torch._foreach_div(mu, [1.0 - b1 ** s for s in steps])
            torch._foreach_div_(update, denom)
            if group["weight_decay"]:
                torch._foreach_add_(update, params, alpha=group["weight_decay"])
            p_norm = self.leaf_norms(params, params)
            u_norm = self.leaf_norms(params, update)
            ratio = torch.where((p_norm == 0) | (u_norm == 0), torch.ones_like(p_norm),
                                p_norm / u_norm)
            torch._foreach_mul_(update, list(ratio.unbind()))
            torch._foreach_add_(params, update, alpha=-group["lr"])
        return loss


class Lion(torch.optim.Optimizer):
    """optax.lion: update = sign(b1 * m + (1 - b1) * g) + weight_decay * p
    (b1 0.9, weight decay 1e-3), p -= lr * update, then m = b2 * m +
    (1 - b2) * g (b2 0.99). sign(0) is 0: a parameter whose gradient and
    momentum are exactly zero moves by its weight decay alone. State per
    parameter: `exp_avg` (optax's mu) and `step` (count)."""

    def __init__(self, params, lr: float, b1: float = 0.9, b2: float = 0.99,
                 weight_decay: float = 1e-3):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None if closure is None else closure()
        for group in self.param_groups:
            params, grads, _, (mu,) = _grouped(group, self.state, ("exp_avg",))
            if not params:
                continue
            b1, b2 = group["b1"], group["b2"]
            update = torch._foreach_mul(mu, b1)
            torch._foreach_add_(update, grads, alpha=1.0 - b1)
            torch._foreach_sign_(update)
            if group["weight_decay"]:
                torch._foreach_add_(update, params, alpha=group["weight_decay"])
            torch._foreach_add_(params, update, alpha=-group["lr"])
            torch._foreach_mul_(mu, b2)
            torch._foreach_add_(mu, grads, alpha=1.0 - b2)
        return loss


@torch.no_grad()
def clip_by_global_norm_(params, max_norm: float,
                         leaf_norms=local_leaf_norms) -> torch.Tensor:
    """Scale the gradients in place as optax.clip_by_global_norm; returns the
    global norm (a device scalar, not read on the host)."""
    held = [p for p in params if p.grad is not None]
    if not held:
        return torch.zeros(())
    grads = [p.grad for p in held]
    norm = torch.linalg.vector_norm(leaf_norms(held, grads))
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
