"""Serving throughput bench of the port: sustained fields/s through
SamplerService (twin of scripts/bench_serve.py, on its contract).

    python -m srewd_tpu_torch.bench_serve [--sampler dpm --steps 25] [--requests 24]

Sprays mixed-size requests (sizes (i % batch) + 1: 1..batch fields each)
at the service and times first submit to last resolve. Contrast: as many
device batches as the service ran, one after another, each ending in a
blocking copy to the host (what a naive sample.py-style loop does per
request); `pipeline_speedup_vs_serialized` is the ratio of the two rates.

Defaults are the JAX script's: sr3 at full width (inner 64, mults
1-2-4-8-8, attention at 16, 2 res blocks) with seeded random weights,
128x256 fields, bf16, DPM-Solver++(2M) 25 steps over T=1000, batch 8, 24
requests (108 fields). Prints one JSON line with the JAX script's keys plus
the device's name. `--device` defaults to the card and raises without one.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m srewd_tpu_torch.bench_serve")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--t", type=int, default=1000)
    p.add_argument("--sampler", choices=["ddpm", "ddim", "dpm"], default="dpm")
    p.add_argument("--steps", type=int, default=25, help="ddim/dpm step count")
    p.add_argument("--requests", type=int, default=24)
    p.add_argument("--hr-shape", type=int, nargs=2, default=(128, 256),
                   help="HR grid (smoke tests can shrink it)")
    p.add_argument("--inner-channel", type=int, default=64)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def model_cfg(hh: int, hw: int, inner_channel: int) -> dict:
    """The JAX script's sr3 network."""
    return {
        "architecture": "sr3",
        "unet": {"in_channel": 2, "out_channel": 1, "inner_channel": inner_channel,
                 "norm_groups": 32, "channel_multiplier": [1, 2, 4, 8, 8], "attn_res": [16],
                 "res_blocks": 2, "dropout": 0.0},
        "diffusion": {"image_height": hh, "image_width": hw, "image_channels": 1,
                      "channels": 1, "conditional": True},
    }


def run(args) -> dict:
    from .bench import device_name, synchronize
    from .cli import cuda_numerics, random_init_, resolve_device
    from .diffusion.schedule import Schedule
    from .models.factory import build_model
    from .serving.service import SamplerService

    device = resolve_device(args.device)
    cuda_numerics(device)
    hh, hw = args.hr_shape
    lh, lw = hh // 4, hw // 4
    with torch.device(device):
        model = build_model(model_cfg(hh, hw, args.inner_channel), dtype=torch.bfloat16)
    random_init_(model.unet, 0)
    schedule = Schedule.create("linear", n_timestep=args.t, linear_start=1e-6,
                               linear_end=1e-2, device=device)
    skw = ({"sampler": args.sampler, "ddim_steps": args.steps}
           if args.sampler in ("ddim", "dpm") else {})
    rng = np.random.default_rng(0)

    # mixed request sizes as production traffic would arrive
    sizes = [(i % args.batch) + 1 for i in range(args.requests)]
    reqs = [rng.standard_normal((n, lh, lw, 1)).astype(np.float32) for n in sizes]
    months = [np.ones(n, np.int32) for n in sizes]
    with SamplerService(model, model.params(), schedule, batch_size=args.batch, device=device,
                        sampler_kwargs=skw, linger_ms=1.0) as svc:
        svc.super_resolve(reqs[0], months[0])  # warm-up: kernels, cuDNN's plans, the allocator
        t0 = time.perf_counter()
        futs = [svc.submit(r, m) for r, m in zip(reqs, months)]
        for f in futs:
            f.result()
        dt_pipe = time.perf_counter() - t0
        stats = svc.stats()
    total_fields = sum(sizes)

    # serialized contrast: the same device-batch count, a blocking copy per batch
    n_batches = max(stats["device_batches"] - 1, 1)  # minus the warm-up
    full = torch.from_numpy(rng.standard_normal((args.batch, lh, lw, 1)).astype(np.float32))
    full = full.to(device)

    def chain(seed: int) -> torch.Tensor:
        gen = torch.Generator(device=device).manual_seed(seed)
        return model.generate_sr({"LR": full}, schedule, generator=gen, **skw)

    chain(9).cpu()  # warm
    synchronize(device)
    t0 = time.perf_counter()
    for i in range(n_batches):
        chain(10 + i).cpu()  # blocking copy, as a naive per-request loop does
    dt_serial = time.perf_counter() - t0

    tag = (f"{args.steps}-step {args.sampler.upper()}(T={args.t})"
           if args.sampler in ("ddim", "dpm") else f"{args.t}-step DDPM")
    served = total_fields / dt_pipe
    serial = n_batches * args.batch / dt_serial
    out = {
        "metric": f"served SR fields/sec/chip ({tag}, {hh}x{hw}, sr3, "
                  f"{args.requests} mixed-size requests)",
        "value": served,
        "unit": "fields/sec/chip",
        "serialized_fields_per_sec": serial,
        "pipeline_speedup_vs_serialized": served / serial,
        "device_batches": n_batches,
        "padded_fields": stats["padded_fields"],
        "latency_p50_ms": stats.get("latency_p50_ms"),
        "latency_p95_ms": stats.get("latency_p95_ms"),
        "fields": total_fields,
        "dtype": "bf16",
        "device": device_name(device),
    }
    print(json.dumps(out), flush=True)
    return out


def main(argv=None) -> dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
