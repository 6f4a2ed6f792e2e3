"""Image resampling with PyTorch `F.interpolate` parity, as matmuls.

Port of srewd_tpu/ops/resize.py. A 1-D resize from n_in to n_out is a dense
[n_out, n_in] matrix built in float64 numpy (Keys cubic kernel, A=-0.75,
half-pixel centres, edge-clamped taps); a 2-D resize is two float32
matmuls. The matrix is rebuilt here because the JAX module imports jax.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _cubic_kernel(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    ax = np.abs(x)
    ax2 = ax * ax
    ax3 = ax2 * ax
    return np.where(
        ax <= 1.0,
        (a + 2.0) * ax3 - (a + 3.0) * ax2 + 1.0,
        np.where(ax < 2.0, a * ax3 - 5.0 * a * ax2 + 8.0 * a * ax - 4.0 * a, 0.0),
    )


@functools.lru_cache(maxsize=None)
def resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """Dense 1-D bicubic resampling matrix W with out = W @ in (float32).

    The cache holds one small read-only matrix per (n_in, n_out); callers
    copy it into a tensor.
    """
    scale = n_in / n_out
    w = np.zeros((n_out, n_in), dtype=np.float64)
    for o in range(n_out):
        s = (o + 0.5) * scale - 0.5
        i = int(np.floor(s))
        frac = s - i
        taps = range(i - 1, i + 3)
        weights = _cubic_kernel(np.array([frac + 1.0, frac, frac - 1.0, frac - 2.0]))
        for tap, weight in zip(taps, weights):
            w[o, int(np.clip(tap, 0, n_in - 1))] += weight
    return w.astype(np.float32)


def bicubic_up4(x: torch.Tensor) -> torch.Tensor:
    """x4 bicubic upsample of NHWC fields: two float32 matmuls.

    On the card the caller keeps `torch.backends.cuda.matmul.allow_tf32`
    off, so these run in full float32 like the JAX HIGHEST-precision path.
    """
    _, h, w, _ = x.shape
    wh = torch.from_numpy(resize_matrix(h, 4 * h)).to(x.device)
    ww = torch.from_numpy(resize_matrix(w, 4 * w)).to(x.device)
    out = torch.einsum("oh,bhwc->bowc", wh, x.float())
    out = torch.einsum("ow,bhwc->bhoc", ww, out)
    return out.to(x.dtype)


def upsample_nearest2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour x2 upsample of NHWC (broadcast + reshape)."""
    b, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c)
    return x.reshape(b, 2 * h, 2 * w, c)
