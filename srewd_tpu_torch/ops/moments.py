"""Kernel <-> moment conversion (K2M / M2K) for physics-constrained kernels
(port of srewd_tpu/ops/moments.py).

The per-axis moment matrix is

    M[i, j] = (j - (l - 1)//2)^i / i!          (l = kernel size along axis)

so `k2m` contracts each trailing kernel axis with M (the kernel's moments
around its centre, scaled by 1/i!) and `m2k` with inv(M). For an exact
finite-difference stencil of derivative order (a, b) the (a, b) moment is 1
and the lower-order moments vanish, which `moment_constraint_loss` pins.
The matrices are built once per shape in float64 numpy (cached) and cast
to the input's dtype and device per call.
"""

from __future__ import annotations

from functools import lru_cache
from math import factorial

import numpy as np
import torch


@lru_cache(maxsize=None)
def _moment_matrices(shape: tuple) -> tuple:
    """(M, inv(M)) per axis, float64."""
    ms, invs = [], []
    for l in shape:
        grid = np.arange(l, dtype=np.float64) - (l - 1) // 2
        m = np.stack([grid**i / factorial(i) for i in range(l)])
        ms.append(m)
        invs.append(np.linalg.inv(m))
    return tuple(ms), tuple(invs)


def _apply_per_axis(x: torch.Tensor, mats, ndim: int) -> torch.Tensor:
    """Contract the trailing `ndim` axes of x with one matrix each."""
    for ax in range(ndim):
        axis = x.ndim - ndim + ax
        mat = torch.as_tensor(mats[ax], dtype=x.dtype, device=x.device)
        x = torch.movedim(torch.tensordot(mat, x, dims=([1], [axis])), 0, axis)
    return x


def k2m(kernel: torch.Tensor, ndim: int = 2) -> torch.Tensor:
    """Kernel -> moment matrix over the trailing `ndim` axes."""
    ms, _ = _moment_matrices(tuple(int(s) for s in kernel.shape[-ndim:]))
    return _apply_per_axis(kernel, ms, ndim)


def m2k(moments: torch.Tensor, ndim: int = 2) -> torch.Tensor:
    """Moment matrix -> kernel over the trailing `ndim` axes."""
    _, invs = _moment_matrices(tuple(int(s) for s in moments.shape[-ndim:]))
    return _apply_per_axis(moments, invs, ndim)


def moment_constraint_loss(kernels: torch.Tensor, target_moments: torch.Tensor) -> torch.Tensor:
    """Mean squared difference between the kernels' moments and the target
    derivative moments (an opt-in regularizer; nothing in the training
    path adds it, as in the JAX package)."""
    return torch.mean(torch.square(k2m(kernels) - target_moments))
