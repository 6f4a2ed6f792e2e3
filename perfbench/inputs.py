"""Everything a run feeds both sides, made from `--seed`: the weights, the
fields, the chains' initial noise and the arrival schedule.

Every quantity draws from a seed of its own, `derive(seed, purpose,
index)`, so adding a draw never shifts another. Weights and fields are
made on the device by a torch.Generator there, in a few large calls.
"""

from __future__ import annotations

import numpy as np
import torch

_PURPOSES = ("weights", "fields", "noise", "order", "arrivals", "trainer", "service", "check")


def derive(seed: int, purpose: str, index: int = 0) -> int:
    """A 63-bit seed for (seed, purpose, index); any whole `seed` works."""
    if purpose not in _PURPOSES:
        raise ValueError(f"unknown purpose {purpose!r}")
    words = [abs(int(seed)) & 0xFFFFFFFFFFFFFFFF, int(seed < 0), _PURPOSES.index(purpose),
             int(index)]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0]) >> 1


def generator(seed: int, purpose: str, index: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, purpose, index))


@torch.no_grad()
def weights(module: torch.nn.Module, seed: int, part: int, device) -> dict:
    """A float32 state dict for `module`'s parameters (on any device, the
    meta device included): matrices and kernels N(0, 1/fan_in) with fan_in
    the size of one output row, GroupNorm scales 1, every other vector 0.
    One normal draw of all matrix entries, then views of it."""
    named = list(module.named_parameters())
    mats = [(n, p.shape) for n, p in named if len(p.shape) >= 2]
    total = sum(int(np.prod(s)) for _, s in mats)
    flat = torch.randn(total, generator=generator(seed, "weights", part, device), device=device,
                       dtype=torch.float32)
    out, at = {}, 0
    for n, shape in mats:
        size = int(np.prod(shape))
        fan_in = size // shape[0]
        out[n] = flat[at:at + size].view(shape).mul_(fan_in ** -0.5)
        at += size
    for n, p in named:
        if len(p.shape) < 2:
            is_scale = n.endswith("norm.weight") or n.endswith("block.0.weight")
            out[n] = torch.full(tuple(p.shape), 1.0 if is_scale else 0.0, device=device)
    return out


@torch.no_grad()
def fields(seed: int, index: int, n: int, lr_hw: tuple, device) -> tuple:
    """(HR [n, 4h, 4w, 1], LR [n, h, w, 1]) normalized fields: a smooth
    large-scale pattern (bilinear x8 of a coarse draw) plus small-scale
    detail, scaled to about unit spread; LR is HR's 4x4 block mean."""
    h, w = lr_hw
    g = generator(seed, "fields", index, device)
    coarse = torch.randn((n, 1, h // 2, w // 2), generator=g, device=device)
    fine = torch.randn((n, 1, 4 * h, 4 * w), generator=g, device=device)
    hr = torch.nn.functional.interpolate(coarse, scale_factor=8, mode="bilinear",
                                         align_corners=False)
    hr = 0.6 * hr + 0.1 * fine
    lr = torch.nn.functional.avg_pool2d(hr, 4)
    return hr.permute(0, 2, 3, 1).contiguous(), lr.permute(0, 2, 3, 1).contiguous()


def init_noise(seed: int, index: int, shape: tuple, device) -> torch.Tensor:
    """The initial image of chain `index`."""
    return torch.randn(shape, generator=generator(seed, "noise", index, device), device=device,
                       dtype=torch.float32)
