"""Sampling benchmark of the port: t2m SR fields/s on one GPU (twin of the
root bench.py, on its contract).

    python -m srewd_tpu_torch.bench

Runs the full reverse chain (by default 1000-step DDPM) of the sr3 UNet at
the reference problem size (t2m, LR 32x64 -> HR 128x256, inner 64, mults
1-2-4-8-8, attention at 16, two res blocks; the network of bench.py) with
seeded random weights (`cli.random_init_`; srdiff's and physrdiff's RRDB
unloaded) on the card, and prints one JSON line: `metric`, `value`
(fields/s: batch over the fastest of `BENCH_REPEATS` chains, each ending in
a synchronise, after one warm-up chain), `unit` and `vs_baseline`, plus the
card's name.

vs_baseline is the ratio to BASELINE_MEASURED.json's reference fields/s,
scaled to BENCH_T as bench.py scales it: that baseline is the reference
PyTorch code on a CPU, so the ratio is across hardware.

Knobs (environment): BENCH_BATCH (8), BENCH_T (1000), BENCH_DTYPE
(bf16|f32, bf16), BENCH_REPEATS (3), BENCH_ARCH (sr3|resdiff|phydiff|
srdiff|physrdiff, sr3), BENCH_SAMPLER (ddpm|ddim|dpm, ddpm),
BENCH_DDIM_STEPS (50). It runs on the card and raises without one; a fault
propagates, with no retry.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def bench_model_cfg(arch: str) -> dict:
    """bench.py's network: the reference problem size, RRDB unloaded."""
    return {
        "architecture": arch,
        "unet": {"in_channel": 1 if arch == "srdiff" else 2, "out_channel": 1,
                 "inner_channel": 64, "norm_groups": 32, "channel_multiplier": [1, 2, 4, 8, 8],
                 "attn_res": [16], "res_blocks": 2, "dropout": 0.0},
        "diffusion": {"image_height": 128, "image_width": 256, "image_channels": 1,
                      "channels": 1, "conditional": True},
        "pretrained_model": {"model_path": None, "lock_weights": True,
                             "hidden_size": 64, "num_block": 17},
    }


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else str(device)


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def baseline() -> dict | None:
    path = os.path.join(REPO, "BASELINE_MEASURED.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def run(model_cfg: dict, device: torch.device, *, batch: int = 8, n_t: int = 1000,
        dtype: str = "bf16", repeats: int = 3, sampler: str = "ddpm",
        ddim_steps: int = 50) -> dict:
    """Time `repeats` reverse chains of `model_cfg`'s model after a warm-up
    chain; print and return the JSON result."""
    from .cli import random_init_
    from .diffusion.schedule import Schedule
    from .models.factory import build_model

    arch = model_cfg["architecture"]
    d = model_cfg["diffusion"]
    h, w = int(d["image_height"]), int(d["image_width"])
    with torch.device(device):
        model = build_model(model_cfg, dtype=DTYPES[dtype])
    random_init_(model.unet, 0)
    if model.encoder is not None:
        random_init_(model.encoder, 1)
    schedule = Schedule.create("linear", n_timestep=n_t, linear_start=1e-6, linear_end=1e-2,
                               device=device)
    rng = np.random.default_rng(0)
    lr = torch.from_numpy(rng.standard_normal((batch, h // 4, w // 4, 1)).astype(np.float32))
    lr = lr.to(device)
    skw = {"sampler": sampler, "ddim_steps": ddim_steps} if sampler in ("ddim", "dpm") else {}

    def chain(seed: int) -> float:
        gen = torch.Generator(device=device).manual_seed(seed)
        synchronize(device)
        t0 = time.perf_counter()
        model.generate_sr({"LR": lr}, schedule, generator=gen, **skw)
        synchronize(device)
        return time.perf_counter() - t0

    chain(1)  # warm-up: kernel loading, cuDNN's plans, the allocator
    dt = min(chain(2 + i) for i in range(repeats))
    fields_per_sec = batch / dt
    ref = baseline()
    vs = (fields_per_sec / (ref["reference_fields_per_sec_T1000"] * (1000.0 / n_t))
          if ref else 0.0)
    tag = (f"{ddim_steps}-step {sampler.upper()}(T={n_t})" if sampler in ("ddim", "dpm")
           else f"{n_t}-step DDPM")
    out = {"metric": f"t2m SR fields/sec/chip ({tag}, {h}x{w}, {arch})",
           "value": fields_per_sec, "unit": "fields/sec/chip", "vs_baseline": vs,
           "dtype": dtype, "batch": batch, "chain_sec": dt, "device": device_name(device)}
    print(json.dumps(out), flush=True)
    return out


def main() -> int:
    from .cli import cuda_numerics, resolve_device

    device = resolve_device("cuda")
    cuda_numerics(device)
    e = os.environ
    run(bench_model_cfg(e.get("BENCH_ARCH", "sr3")), device,
        batch=int(e.get("BENCH_BATCH", "8")), n_t=int(e.get("BENCH_T", "1000")),
        dtype=e.get("BENCH_DTYPE", "bf16"), repeats=int(e.get("BENCH_REPEATS", "3")),
        sampler=e.get("BENCH_SAMPLER", "ddpm"), ddim_steps=int(e.get("BENCH_DDIM_STEPS", "50")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
