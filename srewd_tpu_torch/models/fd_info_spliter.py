"""FD_Info_Spliter, ResDiff's frequency-domain front end (port of
srewd_tpu/models/fd_info_spliter.py).

Splits the UNet input into (condition, noisy) and stacks five maps on the
channel axis: [noisy, condition, noise-suppressed noisy, low-frequency map,
|IFFT| high-frequency map]. The noise gate is a ResSE of the noise
embedding; the frequency maps come from a learned Gaussian high-pass of the
condition's spectrum.

As in the JAX module:
  - the FFT runs over H and W only, not over the batch (the reference's
    `fftn` without `dim` couples the samples of a batch; PARITY.md §2.5);
  - the distance grid is centred at (H/2, W/2) on an unshifted spectrum,
    the reference's quirk, kept for parity;
  - sigma is clamped to min(H, W) - 10;
  - the FFT runs in complex64 (cuFFT has no bfloat16), and its features
    are cast back to the condition's dtype.

The frequency maps depend on the condition only, so a sampling chain
computes them once (`cond_features`) and hands them to every step as
`cond_feats`. Attribute names are the reference's (`noise_func`,
`noise_resSE`, `sigma_resSE`, `HF_guided_resSE`, `channel_transform`),
which srewd_tpu/utils/torch_convert.py reads.

Tensors are NHWC. The Linear, the conv and the ResSE MLPs run in the
compute dtype `dtype` that the UNet hands in, over float32 parameters
(models/layers.py), as flax's `dtype` does; the stack keeps x's dtype.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from .blocks import ResSE
from .layers import Conv2d, Linear


class FDInfoSpliter(nn.Module):
    def __init__(self, image_channels: int, out_channels: int, noise_dim: int,
                 image_width: int):
        super().__init__()
        c = image_channels
        self.image_channels = c
        self.noise_func = Linear(noise_dim, image_width)
        self.noise_resSE = ResSE(c, reduction=1 if c == 1 else 2)
        self.sigma_resSE = ResSE(2 * c, reduction=2)
        self.HF_guided_resSE = ResSE(2 * c, reduction=2)
        self.channel_transform = Conv2d(2 * c, out_channels, 1)

    @staticmethod
    def out_channels(image_channels: int, out_channels: int) -> int:
        """Channels of the stack: four maps of C, and the low-frequency map
        (the condition times a map of out_channels, broadcast)."""
        return 4 * image_channels + max(image_channels, out_channels)

    def forward(self, x: torch.Tensor, noise_embed: torch.Tensor, dtype: torch.dtype,
                cond_feats: Optional[tuple] = None) -> torch.Tensor:
        """x [B,H,W,2C] = concat(condition, noisy) -> the [B,H,W,5C] stack."""
        c = self.image_channels
        cnn_x, xn = x[..., :c], x[..., c:]
        b, h, w, _ = x.shape
        ne = self.noise_func(noise_embed.to(dtype))
        ne = ne[:, None, :, None].expand(b, h, w, c).to(x.dtype)
        denoise_x = xn * self.noise_resSE(ne, dtype)
        if cond_feats is None:
            x_lf, x_hf = self.cond_features(cnn_x, dtype)
        else:
            x_lf, x_hf = (f.to(x.dtype) for f in cond_feats)
        return torch.cat([xn, cnn_x, denoise_x, x_lf, x_hf], dim=-1)

    def cond_features(self, cnn_x: torch.Tensor, dtype: torch.dtype) -> tuple:
        """The chain-invariant (low-frequency, high-frequency) maps of the
        condition [B,H,W,C]."""
        _, h, w, _ = cnn_x.shape
        spec = torch.fft.fftn(cnn_x.to(torch.complex64), dim=(1, 2))
        x_fd = torch.cat([spec.real, spec.imag], dim=-1).to(cnn_x.dtype)

        side = float(min(h, w))
        se = self.sigma_resSE(x_fd, dtype)
        sigma = torch.clamp(se.float().mean(dim=(1, 2, 3)).abs() + side / 2.0, max=side - 10.0)
        u = torch.arange(h, dtype=torch.float32, device=cnn_x.device) - h / 2.0
        v = torch.arange(w, dtype=torch.float32, device=cnn_x.device) - w / 2.0
        d2 = u[:, None] ** 2 + v[None, :] ** 2
        hp = 1.0 - torch.exp(-d2[None] / (2.0 * sigma[:, None, None] ** 2))  # [B,H,W]

        filtered = spec * hp[..., None].to(torch.complex64)
        x_fd_filtered = torch.cat([filtered.real, filtered.imag], dim=-1).to(cnn_x.dtype)
        hf_atten = self.HF_guided_resSE(x_fd_filtered, dtype)
        lf_map = self.channel_transform(hf_atten.to(dtype).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        x_lf = cnn_x * lf_map
        x_hf = torch.fft.ifftn(filtered, dim=(1, 2)).abs().to(cnn_x.dtype)
        return x_lf, x_hf
