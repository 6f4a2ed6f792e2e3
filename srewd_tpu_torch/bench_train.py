"""Training benchmark of the port: train steps/s on one GPU, with the model
FLOP/s and MFU (twin of scripts/bench_train.py).

    python -m srewd_tpu_torch.bench_train

Times the train step (bicubic SR, the diffusion loss, its gradients through
K1, K2, K3 and K3's backward, Adam 1e-4) of the sr3 trunk at the reference
problem size (bench.py's network), batch 16, on a linear 1e-6..1e-2 schedule
of T=1000, HR and LR from numpy.random.default_rng(0), made on the card
once. Two warm-up steps (the first times cuDNN's algorithms), then
BENCH_STEPS steps enqueued without reading a loss and one synchronise.

Prints one JSON line: `value` (steps/s), `samples_per_sec`, `vs_baseline`
(samples/s over BASELINE_MEASURED.json's reference, which is the PyTorch
reference on a CPU: a ratio across hardware), `model_tflops_per_sec`, `mfu`
and `flops_source`. The FLOPs are counted by torch.utils.flop_counter's
FlopCounterMode over one forward and backward of the step on the plain
path (`ops.reference_ops()`) on the meta device, so nothing runs: the
kernels are ctypes launches that the counter cannot see, and the plain
path is the same work whatever implements it. It counts convolutions and
matrix products (the attention's included), not elementwise operations.
The peak is the H100 SXM data sheet's, dense (utils/profiling.py):
989 TFLOP/s in bf16, 67 TFLOP/s in float32 (the port runs float32 with
TF32 off, on the CUDA cores).

Knobs (environment): BENCH_BATCH (16), BENCH_DTYPE (bf16|f32, bf16),
BENCH_STEPS (20), BENCH_ARCH (sr3). It runs on the card and raises without
one; a fault propagates, with no retry.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from .bench import DTYPES, baseline, bench_model_cfg, device_name, synchronize

FLOPS_SOURCE = ("torch.utils.flop_counter.FlopCounterMode, one forward and backward on the "
                "plain path (reference_ops) on the meta device: convolutions and matrix "
                "products, the attention's included; no elementwise operations")


def _schedule(device):
    from .diffusion.schedule import Schedule

    return Schedule.create("linear", n_timestep=1000, linear_start=1e-6, linear_end=1e-2,
                           device=device)


def build_trainer(model_cfg: dict, device: torch.device, dtype: str = "bf16"):
    """scripts/bench_train.py's trainer: seeded random weights, Adam 1e-4."""
    from .cli import random_init_
    from .models.factory import build_model
    from .training.trainer import DiffusionTrainer

    with torch.device(device):
        model = build_model(model_cfg, dtype=DTYPES[dtype])
    random_init_(model.unet, 0)
    if model.encoder is not None:
        random_init_(model.encoder, 1)
    sched = _schedule(device)
    return DiffusionTrainer(model, sched, sched, device=device, optimizer="adam", lr=1e-4)


def step_flops(model_cfg: dict, batch: int, dtype: str = "bf16") -> float:
    """FLOPs of one train step's forward and backward, counted on the plain
    path on the meta device (see the module's docstring)."""
    from torch.utils.flop_counter import FlopCounterMode

    from .models.factory import build_model
    from .ops import reference_ops

    meta = torch.device("meta")
    with meta:
        model = build_model(model_cfg, dtype=DTYPES[dtype])
        d = model_cfg["diffusion"]
        h, w = int(d["image_height"]), int(d["image_width"])
        b = {"HR": torch.empty(batch, h, w, 1), "LR": torch.empty(batch, h // 4, w // 4, 1)}
        draws = {"t": torch.full((1,), 500, dtype=torch.long), "u": torch.empty(batch),
                 "noise": torch.empty(batch, h, w, 1)}
    with reference_ops(), FlopCounterMode(display=False) as counter:
        model.loss(b, _schedule(meta), train=True, **draws).backward()
    return float(counter.get_total_flops())


def run(model_cfg: dict, device: torch.device, *, batch: int = 16, dtype: str = "bf16",
        steps: int = 20) -> dict:
    """Time `steps` train steps after two warm-up steps; print and return
    the JSON result."""
    from .utils.profiling import PEAK_FLOPS

    arch = model_cfg["architecture"]
    d = model_cfg["diffusion"]
    h, w = int(d["image_height"]), int(d["image_width"])
    trainer = build_trainer(model_cfg, device, dtype)
    rng = np.random.default_rng(0)
    b = trainer._device_batch({
        "HR": rng.standard_normal((batch, h, w, 1)).astype(np.float32),
        "LR": rng.standard_normal((batch, h // 4, w // 4, 1)).astype(np.float32)})
    trainer.train_on_batch(b)
    trainer.train_on_batch(b)
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(steps):
        trainer.train_on_batch_async(b)
    synchronize(device)
    dt = (time.perf_counter() - t0) / steps
    flops = step_flops(model_cfg, batch, dtype)
    out = {"metric": f"train steps/sec/chip ({arch} {h}x{w}, batch {batch})",
           "value": 1.0 / dt, "unit": "steps/sec/chip", "samples_per_sec": batch / dt}
    ref = baseline()
    if ref:
        ref_sps = ref["reference_train_steps_per_sec"] * ref["reference_train_batch"]
        out["vs_baseline"] = (batch / dt) / ref_sps
    out.update(model_tflops_per_sec=flops / dt / 1e12, mfu=flops / dt / PEAK_FLOPS[DTYPES[dtype]],
               flops_source=FLOPS_SOURCE, step_flops=flops, dtype=dtype, step_sec=dt,
               device=device_name(device))
    print(json.dumps(out), flush=True)
    return out


def main() -> int:
    from .cli import cuda_numerics, resolve_device

    device = resolve_device("cuda")
    cuda_numerics(device, training=True)
    e = os.environ
    run(bench_model_cfg(e.get("BENCH_ARCH", "sr3")), device,
        batch=int(e.get("BENCH_BATCH", "16")), dtype=e.get("BENCH_DTYPE", "bf16"),
        steps=int(e.get("BENCH_STEPS", "20")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
