"""Frequency- and wavelet-domain losses of SimpleCNN's pretraining (port of
srewd_tpu/ops/losses.py): alpha * FFT-MSE (ortho-normalised, real and
imaginary parts) + beta * the per-subband MSE of a 4-level Haar DWT.
NHWC; the FFT runs over H and W in complex64.
"""

from __future__ import annotations

import torch

from .wavelets import haar_dwt_pyramid


def fft_mse_loss(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """MSE between the real and imaginary parts of ortho-normed spatial FFTs."""
    f1 = torch.fft.fftn(img1.to(torch.complex64), dim=(1, 2), norm="ortho")
    f2 = torch.fft.fftn(img2.to(torch.complex64), dim=(1, 2), norm="ortho")
    return (f1.real - f2.real).square().mean() + (f1.imag - f2.imag).square().mean()


def dwt_mse_loss(x: torch.Tensor, y: torch.Tensor, levels: int = 4) -> torch.Tensor:
    """Sum over levels and subbands of the MSE between Haar detail coefficients."""
    total = x.new_zeros(())
    for bands_x, bands_y in zip(haar_dwt_pyramid(x, levels, combine="none"),
                                haar_dwt_pyramid(y, levels, combine="none")):
        for a, b in zip(bands_x, bands_y):
            total = total + (a - b).square().mean()
    return total


def image_compare_loss(x: torch.Tensor, y: torch.Tensor, alpha: float = 0.2,
                       beta: float = 0.1) -> torch.Tensor:
    return alpha * fft_mse_loss(x, y) + beta * dwt_mse_loss(x, y)


def l1_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """RRDBNet's pretraining criterion."""
    return (x - y).abs().mean()
