"""SSIM with scikit-image `structural_similarity` default semantics (port of
srewd_tpu/ops/ssim.py).

Uniform 7x7 window, K1=0.01, K2=0.03, sample covariance (N/(N-1)), and the
mean taken over the VALID windows only (skimage's crop by (win_size-1)//2
on each side); per-image data range pred.max() - pred.min() by default.
The window means are a 7x7 average pool without padding. NHWC in and out.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_WIN = 7
_K1 = 0.01
_K2 = 0.03


def _window_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over all VALID 7x7 windows of NHWC input -> [B, H-6, W-6, C]."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), _WIN, stride=1).permute(0, 2, 3, 1)


def ssim_map(pred: torch.Tensor, target: torch.Tensor, data_range) -> torch.Tensor:
    """SSIM map over valid windows. pred/target NHWC, data_range [B] or scalar."""
    pred = pred.float()
    target = target.float()
    ux = _window_mean(pred)
    uy = _window_mean(target)
    uxx = _window_mean(pred * pred)
    uyy = _window_mean(target * target)
    uxy = _window_mean(pred * target)
    np_ = _WIN * _WIN
    cov_norm = np_ / (np_ - 1.0)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    dr = torch.as_tensor(data_range, dtype=torch.float32, device=pred.device)
    if dr.ndim == 1:
        dr = dr[:, None, None, None]
    c1 = (_K1 * dr) ** 2
    c2 = (_K2 * dr) ** 2
    a1 = 2.0 * ux * uy + c1
    a2 = 2.0 * vxy + c2
    b1 = ux * ux + uy * uy + c1
    b2 = vx + vy + c2
    return (a1 * a2) / (b1 * b2)


def ssim(pred: torch.Tensor, target: torch.Tensor, data_range=None) -> torch.Tensor:
    """Mean SSIM per image: NHWC inputs -> [B]."""
    if data_range is None:
        data_range = pred.amax(dim=(1, 2, 3)) - pred.amin(dim=(1, 2, 3))
    return ssim_map(pred, target, data_range).mean(dim=(1, 2, 3))
