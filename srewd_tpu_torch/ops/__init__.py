"""Numeric ops of the port, and the routing between a kernel and its plain
version.

A kernel wrapper takes its plain PyTorch version only for a tensor on the
CPU, or inside `reference_ops()`; for a CUDA tensor it launches the kernel
or raises. `reference_ops()` exists for the whole-slice comparison of the
kernels against their plain versions (chip_smoke.py) and is never the
default.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

_FORCE_PLAIN = contextvars.ContextVar("srewd_torch_force_plain", default=False)


@contextlib.contextmanager
def reference_ops():
    """Force every kernel wrapper onto its plain PyTorch version."""
    token = _FORCE_PLAIN.set(True)
    try:
        yield
    finally:
        _FORCE_PLAIN.reset(token)


def use_plain(x: torch.Tensor) -> bool:
    """True when a wrapper must take its plain version for `x`.

    CPU tensors always do; CUDA tensors only inside `reference_ops()`. Any
    other device raises, so nothing quietly runs somewhere unexpected.
    """
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    return _FORCE_PLAIN.get()
