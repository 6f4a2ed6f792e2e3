"""Bulk sampling in a closed loop: one chain after another.

The traffic file gives `dtype`, `batch` (fields a chain), `lr_batches`
(distinct seeded LR batches the chains cycle through), `check_chains`
(chains compared with the reference) and, for a traced run,
`traced_share` (the share of `--seconds` timed with the profiler off
before one profiled chain). The sampler is the configuration's
(`model.diffusion`: sampler, ddim_steps, ddim_eta).

Each chain is the sample CLI's call: `DiffusionModel.generate_sr` on a
batch of LR fields, its result copied to the host; its initial noise is
made from the seed and handed in (`init`). The window runs from the first
chain's start to the copy after the last chain that started within
`--seconds`. `sample_fields_per_s` is every field of those chains over
that time. Afterwards the reference runs the same LR and initial noise
through its own conditioning, UNet and DDIM chain for `check_chains`
chains drawn from the seed (the last one always among them).
"""

from __future__ import annotations

import time

import torch

from .. import inputs, work
from ..cell import LayerContext, Outcome
from ..reference import diffusion, numerics
from . import common

SPAN = "perfbench.chain"


def _sampler(model_cfg: dict) -> dict:
    d = model_cfg["diffusion"]
    if d.get("sampler") != "ddim" or float(d.get("ddim_eta", 0.0)) != 0.0:
        raise ValueError("the sample driver's reference is DDIM with eta 0")
    return {"sampler": "ddim", "ddim_steps": int(d["ddim_steps"]), "ddim_eta": 0.0}


def _lr_pool(cfg: dict, tr: dict, seed: int, device) -> torch.Tensor:
    d = cfg["model"]["diffusion"]
    hw = (int(d["image_height"]) // 4, int(d["image_width"]) // 4)
    b, n = int(tr["batch"]), int(tr["lr_batches"])
    lr = inputs.fields(seed, 0, b * n, hw, device)[1]
    return lr.reshape(n, b, *lr.shape[1:])


def _init(cfg: dict, tr: dict, seed: int, i: int, device) -> torch.Tensor:
    d = cfg["model"]["diffusion"]
    shape = (int(tr["batch"]), int(d["image_height"]), int(d["image_width"]), 1)
    return inputs.init_noise(seed, i, shape, device)


def reference_fields(cfg: dict, tr: dict, seed: int, chains: list, device,
                     mode: str = "f32") -> dict:
    """{chain: the reference's fields} for the given chains, computed in
    `mode` (numerics.py)."""
    lr = _lr_pool(cfg, tr, seed, device)
    unet, enc = common.reference_model(cfg["model"], seed, device)
    unet.eval()
    sched = diffusion.Schedule(cfg["model"]["beta_schedule"]["val"], device)
    steps = _sampler(cfg["model"])["ddim_steps"]
    out = {}
    with numerics.mode(mode):
        for i in chains:
            x = diffusion.ddim_sample(unet, lr[i % len(lr)], _init(cfg, tr, seed, i, device),
                                      sched, steps, rrdb=enc)
            out[i] = x.cpu().numpy()
    del unet, enc
    common.free(device)
    return out


def compare(got: dict, ref: dict) -> dict:
    gaps = [common.field_gaps(got[i], ref[i]) for i in ref]
    return {k: max(g[k] for g in gaps) for k in ("max_abs", "rel_rmse")}


def run(cell, *, seed: int, seconds: float, trace: bool, device, program=None) -> Outcome:
    """`program(model, lr, init, schedule, skw)`: the call a chain makes
    (the port's generate_sr unless a test plants a fault in it)."""
    from srewd_tpu_torch.cli import cuda_numerics
    from srewd_tpu_torch.diffusion.schedule import Schedule

    cfg, tr = cell.config, cell.traffic
    cuda_numerics(device)  # the sample CLI's: float32 with TF32 off
    model = common.program_model(cfg["model"], tr["dtype"], seed, device)
    schedule = Schedule.from_config(cfg["model"]["beta_schedule"]["val"], device=device)
    skw = _sampler(cfg["model"])
    lr = _lr_pool(cfg, tr, seed, device)
    call = program or (lambda m, x, init, s, kw: m.generate_sr({"LR": x}, s, init=init, **kw))

    def chain(i: int):
        with torch.profiler.record_function(SPAN):
            out = call(model, lr[i % len(lr)], _init(cfg, tr, seed, i, device), schedule, skw)
            return out.cpu().numpy()

    chain(0)  # warm-up: loads the kernels, every shape of the timed chains
    timed = seconds * (float(tr.get("traced_share", 0.5)) if trace else 1.0)
    outs = {}
    t0 = time.perf_counter()
    i = 1
    while time.perf_counter() - t0 < timed:
        outs[i] = chain(i)
        i += 1
    t1 = time.perf_counter()
    layer = None
    if trace:
        from .. import trace as tracing

        t = tracing.profile(lambda: outs.__setitem__(i, chain(i)), device)
        unit = work.sample_unit(cfg["model"], int(tr["batch"]))
        steps = skw["ddim_steps"]
        layer = LayerContext(
            trace=t, units=steps, timed_units=steps * (i - 1), timed_seconds=t1 - t0,
            unit_flops=unit["flops"] + unit["cond_flops"] / steps,
            kernel_work=work.kernel_work(unit["calls"], tr["dtype"], backward=False),
            dtype=tr["dtype"])
    peak = common.peak_bytes(device)
    b = int(tr["batch"])
    done = sorted(outs)
    failed = sum(1 for k in done if not torch.isfinite(torch.from_numpy(outs[k])).all())
    del model
    common.free(device)
    chosen = common.pick(seed, done, int(tr["check_chains"]), always=[done[-1]])
    gaps = compare({k: outs[k] for k in chosen},
                   reference_fields(cfg, tr, seed, chosen, device))
    lim = cell.limits["checks"]
    return Outcome(window_start=t0, metrics={"sample_fields_per_s": b * (i - 1) / (t1 - t0)},
                   attempted=b * len(done), failed=b * failed,
                   checks=[(k, gaps[k], lim[k]) for k in ("rel_rmse", "max_abs")],
                   memory_peak_bytes=peak, layer=layer)


def control(cell, *, seed: int, device, mode: str) -> dict:
    """The comparison numbers of the reference in `mode` put in the
    program's place, on the chains a run would check."""
    tr = cell.traffic
    n = max(int(tr["check_chains"]), 1)
    chains = list(range(1, n + 1))
    low = reference_fields(cell.config, tr, seed, chains, device, mode=mode)
    return compare(low, reference_fields(cell.config, tr, seed, chains, device))
