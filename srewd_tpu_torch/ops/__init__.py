"""Numeric ops of the port, and the routing between a kernel and its plain
version.

A kernel wrapper takes its plain PyTorch version only for a tensor on the
CPU, or inside `reference_ops()`; for a CUDA tensor it launches the kernel
or raises. `reference_ops()` exists for the whole-slice comparison of the
kernels against their plain versions (chip_smoke.py) and is never the
default.

The forwards of K1 and K3 are also `torch.library` custom ops,
`srewd::flash_attention` and `srewd::gn_swish`, each with a fake that runs
the CUDA route's shape, dtype and layout checks. While torch.export traces
a call (`use_op`), the wrapper calls its op, so the exported graph holds
the kernel as one node: its CUDA implementation is the wrapper's own
launch, counted like every launch, and its CPU implementation the plain
version. Eager calls keep the direct route (plain version or ctypes
launch), which adds no dispatcher time on the host.
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


def use_op(x: torch.Tensor) -> bool:
    """True when a kernel wrapper must call its custom op for `x`: while
    torch.export (or torch.compile) traces the call, outside
    `reference_ops()`, on the CPU or a card."""
    tracing = torch.compiler.is_exporting() or torch.compiler.is_compiling()
    return tracing and not _FORCE_PLAIN.get() and x.device.type in ("cpu", "cuda")


def use_plain(x: torch.Tensor) -> bool:
    """True when a wrapper must take its plain version for `x`.

    CPU tensors always do; CUDA tensors, and meta tensors (bench_train
    counts the plain path's FLOPs on them), only inside `reference_ops()`.
    Any other device raises, so nothing quietly runs somewhere unexpected.
    """
    if x.device.type == "cpu":
        return True
    if x.device.type == "meta" and _FORCE_PLAIN.get():
        return True
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    return _FORCE_PLAIN.get()
