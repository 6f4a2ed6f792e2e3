"""Served maps on demand: an open loop of requests into SamplerService.

The traffic file gives `dtype`, `device_batch`, `linger_ms`,
`rate_fields_per_s` (the offered load, fixed in the cell), `sizes`
([[fields, share], ...]), `check_requests`, `drain_s` and, for a traced
run, `traced_share` and `traced_seconds`. The sampler is the
configuration's.

Set-up builds one service (one replica on the card) with the seeded
weights and Kelvin scalers per month (`scalers`), and sends five full
device batches through it at once (a run at 30 s that warmed one batch
read a 95th percentile ~1.7x that of a 51 s run: the first seconds of the
window paid for what the warm-up had not done). The schedule is fixed by the rate, the window
and the sizes: the same number of requests of each size and the same set
of gaps (quantiles of the exponential distribution, so arrivals are
Poisson-like) for every seed, the seed choosing their order, the months
and the fields. One thread submits each request at its due time; a
request is timed from when it was due to when its future resolved, so a
late submit counts. Requests are due over `--seconds`; the drain waits
`drain_s` more. A request that failed or never resolved counts as
missing (+inf). `serve_p95_ms` is the nearest-rank 95th percentile over
every request due in the window.

The check: `check_requests` requests drawn from the seed among those
answered, a 4-field one among them. The service packs fields into device
batches in FIFO order and seeds batch `seq`'s noise by (seed, seq); the
harness notes which slots each batch took (a wrapper around the service's
`_take_batch` that only records), so the reference repeats each checked
field's chain from its own LR (Kelvin to normalized by the month's
scaler), the same row of the same noise draw, and the inverse scaler.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from .. import inputs
from ..cell import LayerContext, Outcome
from ..reference import diffusion, numerics
from . import common


WARM_BATCHES = 5  # one more than the service's batches in flight a replica (_IN_FLIGHT)


def scalers() -> tuple:
    """(mean, std) [13, 1, 1, 1] float32 of 2-m temperature by month: a
    seasonal mean of 278 +- 12 K and a spread of 11 +- 3 K (month 0
    unused)."""
    m = np.arange(13, dtype=np.float64)
    mean = 278.0 - 12.0 * np.cos(2.0 * np.pi * (m - 1.0) / 12.0)
    std = 11.0 + 3.0 * np.cos(2.0 * np.pi * (m - 1.0) / 12.0)
    shape = (13, 1, 1, 1)
    return mean.astype(np.float32).reshape(shape), std.astype(np.float32).reshape(shape)


def member_seed(seed: int, member: int) -> int:
    """The service's noise seed of device batch `member` (the port's
    documented rule: member 0 is the seed itself)."""
    if member == 0:
        return int(seed)
    state = np.random.SeedSequence([int(seed), int(member)]).generate_state(1, np.uint64)
    return int(state[0]) >> 1


def schedule(tr: dict, seed: int, seconds: float, rate: float) -> dict:
    """The requests: due times (s from the window's start), sizes and
    months."""
    sizes = [(int(s), float(p)) for s, p in tr["sizes"]]
    mean = sum(s * p for s, p in sizes)
    n = max(1, int(round(rate * seconds / mean)))
    counts = [int(round(n * p)) for _, p in sizes]
    counts[0] += n - sum(counts)
    rng = np.random.default_rng(inputs.derive(seed, "arrivals"))
    size = rng.permutation(np.repeat([s for s, _ in sizes], counts))
    gaps = -np.log(1.0 - (np.arange(n) + 0.5) / n)
    gaps = rng.permutation(gaps) * (seconds / gaps.sum())
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    months = rng.integers(1, 13, n)
    return {"due": due, "size": size, "month": months}


def _lr_kelvin(cfg: dict, seed: int, sched: dict, device) -> list:
    d = cfg["model"]["diffusion"]
    hw = (int(d["image_height"]) // 4, int(d["image_width"]) // 4)
    n = len(sched["size"])
    lr = inputs.fields(seed, 2, n, hw, device)[1].cpu().numpy()
    mean, std = scalers()
    out = []
    for k in range(n):
        one = lr[k:k + 1] * std[sched["month"][k]] + mean[sched["month"][k]]
        out.append(np.repeat(one, sched["size"][k], axis=0).astype(np.float32))
    return out


def reference_kelvin(cfg: dict, seed: int, fields: list, device, mode: str = "f32"):
    """The reference's Kelvin fields of [(lr_kelvin [h, w, 1], month, seq,
    row)]: the noise of row `row` of device batch `seq`'s draw."""
    m = cfg["model"]
    d = m["diffusion"]
    mean, std = scalers()
    shape = (int(cfg["_batch"]), int(d["image_height"]), int(d["image_width"]), 1)
    svc_seed = inputs.derive(seed, "service")
    noise = {}
    for _, _, seq, _ in fields:
        if seq not in noise:
            g = torch.Generator(device=device).manual_seed(member_seed(svc_seed, seq))
            noise[seq] = torch.randn(shape, generator=g, device=device, dtype=torch.float32)
    mo = np.array([f[1] for f in fields])
    lr = (np.stack([f[0] for f in fields]) - mean[mo]) / std[mo]
    init = torch.stack([noise[seq][row] for _, _, seq, row in fields])
    unet, enc = common.reference_model(m, seed, device)
    unet.eval()
    sched = diffusion.Schedule(m["beta_schedule"]["val"], device)
    with numerics.mode(mode):
        x = diffusion.ddim_sample(unet, torch.from_numpy(lr.astype(np.float32)).to(device),
                                  init, sched, int(d["ddim_steps"]), rrdb=enc)
    del unet, enc
    common.free(device)
    return std[mo] * x.cpu().numpy() + mean[mo]


def compare(got: np.ndarray, ref: np.ndarray) -> dict:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if got.shape != ref.shape or not np.isfinite(got).all():
        return {"max_abs_kelvin": math.inf, "rmse_kelvin": math.inf}
    diff = got - ref
    return {"max_abs_kelvin": float(np.abs(diff).max()),
            "rmse_kelvin": float(np.sqrt((diff * diff).mean()))}


def p95(latencies: list) -> float:
    """The nearest-rank 95th percentile."""
    xs = sorted(latencies)
    return xs[max(0, math.ceil(0.95 * len(xs)) - 1)]


def run(cell, *, seed: int, seconds: float, trace: bool, device, rate: float = None,
        check: bool = True, alter=None) -> Outcome:
    """`rate` overrides the traffic's (the sweep for the knee); `check`
    False skips the reference; `alter(sr)`: a test's fault, applied to
    every device batch's fields where the service resolves them."""
    from srewd_tpu_torch.cli import cuda_numerics
    from srewd_tpu_torch.data.scalers import MonthlyScalerSet
    from srewd_tpu_torch.diffusion.schedule import Schedule
    from srewd_tpu_torch.serving.service import SamplerService

    cfg, tr = cell.config, cell.traffic
    m = cfg["model"]
    d = m["diffusion"]
    b = int(tr["device_batch"])
    cuda_numerics(device)  # the service's stack sets TF32 off
    model = common.program_model(m, tr["dtype"], seed, device)
    mean, std = scalers()
    sc = MonthlyScalerSet(mean, std, "GlobalStandardScaling")
    inverse = sc.inverse if alter is None else (lambda x, mo: alter(sc.inverse(x, mo)))
    svc = SamplerService(
        model, model.params(), Schedule.from_config(m["beta_schedule"]["val"], device=device),
        batch_size=b, devices=[device],
        sampler_kwargs={"sampler": d["sampler"], "ddim_steps": int(d["ddim_steps"]),
                        "ddim_eta": float(d.get("ddim_eta", 0.0))},
        transform_lr=sc.transform, inverse_hr=inverse, linger_ms=float(tr["linger_ms"]),
        seed=inputs.derive(seed, "service"))
    del model
    rate = float(tr["rate_fields_per_s"] if rate is None else rate)
    sched = schedule(tr, seed, seconds, rate)
    lr = _lr_kelvin(cfg, seed, sched, device)
    try:
        taken: dict = {}
        take = svc._take_batch

        def noted(rep):
            r = take(rep)
            if r is not None:
                taken[r[1]] = [(p.future, i) for p, i, _, _ in r[0]]
            return r

        # installed before the first batch is taken: the dispatcher's next
        # call after that one goes through it
        svc._take_batch = noted
        # warm-up: full device batches (the only shape the service runs),
        # enough at once to fill the replica's batches in flight, so the
        # allocator holds their memory before the window
        full = np.repeat(lr[0][:1], b, axis=0)
        for f in [svc.submit(full, np.full(b, 1)) for _ in range(WARM_BATCHES)]:
            f.result()
        before = svc.stats()
        n = len(sched["due"])
        futures, done_at = [None] * n, [math.inf] * n
        lateness = []
        prof, at_start, at_stop = None, None, None
        if trace:
            from ..trace import ScheduledProfiler

            t_on = seconds * float(tr.get("traced_share", 0.5))
            t_off = t_on + float(tr.get("traced_seconds", 5.0))
            k_on = int(np.searchsorted(sched["due"], t_on))
            k_off = int(np.searchsorted(sched["due"], t_off))
            prof = ScheduledProfiler(device, k_on + 1, k_off + 1)
        t0 = time.perf_counter() + 0.01
        for k in range(n):
            due = t0 + sched["due"][k]
            while (wait := due - time.perf_counter()) > 0:
                time.sleep(wait)
            if prof is not None:
                if k == k_off:
                    at_stop = svc.stats()
                prof.step()
                if k == k_on:
                    at_start = svc.stats()
            lateness.append(time.perf_counter() - due)
            futures[k] = svc.submit(lr[k], np.full(sched["size"][k], sched["month"][k]))
            futures[k].add_done_callback(
                lambda f, k=k: done_at.__setitem__(k, time.perf_counter()))
        if prof is not None:
            prof.close()
        results, failed = [None] * n, 0
        deadline = t0 + seconds + float(tr["drain_s"])
        for k, f in enumerate(futures):
            try:
                results[k] = f.result(timeout=max(0.0, deadline - time.perf_counter()))
            except Exception:  # noqa: BLE001 - a failed or late request counts as missing
                failed += 1
                done_at[k] = math.inf
        after = svc.stats()
        peak = common.peak_bytes(device)
    finally:
        svc.close()
    lat = [done_at[k] - (t0 + sched["due"][k]) for k in range(n)]
    metrics = {"serve_p95_ms": 1e3 * p95(lat)}
    counters = {k: after[k] - before[k] for k in ("device_batches", "padded_fields")}
    counters["batch_size"] = b
    extra = {"p50_ms": 1e3 * sorted(lat)[n // 2], "late_p95_ms": 1e3 * p95(lateness),
             "served_fields_per_s": sum(int(s) for s in sched["size"]) / (
                 max(x for x in done_at if math.isfinite(x)) - t0) if failed < n else 0.0,
             "requests": n, **counters}
    q = max(1, n // 5)
    if failed == 0:
        extra["latency_trend"] = float(np.mean(lat[-q:]) / np.mean(lat[:q]))
    layer = None
    if trace:
        steps = int(d["ddim_steps"])
        batches = at_stop["device_batches"] - at_start["device_batches"]
        layer = LayerContext(trace=prof.trace, units=batches * steps, timed_units=0,
                             timed_seconds=0.0, unit_flops=0.0, kernel_work={},
                             dtype=tr["dtype"], counters=counters)
    checks = []
    if check:
        where = {}
        for seq, slots in taken.items():
            for row, (fut, i) in enumerate(slots):
                where[(id(fut), i)] = (seq, row)
        answered = [k for k in range(n) if results[k] is not None]
        fours = [k for k in answered if sched["size"][k] == max(sched["size"])]
        chosen = common.pick(seed, answered, int(tr["check_requests"]), always=fours[-1:])
        fields, got = [], []
        for k in chosen:
            for i in range(int(sched["size"][k])):
                seq, row = where[(id(futures[k]), i)]
                fields.append((lr[k][i], int(sched["month"][k]), seq, row))
                got.append(results[k][i])
        cfg_b = dict(cfg, _batch=b)
        gaps = compare(np.stack(got), reference_kelvin(cfg_b, seed, fields, device))
        lim = cell.limits["checks"]
        checks = [(k, gaps[k], lim[k]) for k in ("rmse_kelvin", "max_abs_kelvin")]
    return Outcome(window_start=t0, metrics=metrics, attempted=n, failed=failed, checks=checks,
                   memory_peak_bytes=peak, layer=layer, extra=extra)


def control(cell, *, seed: int, device, mode: str, fields: int = 16) -> dict:
    """The comparison numbers of the reference in `mode` put in the
    program's place, on `fields` fields of the cell's schedule in
    distinct rows of the first device batches."""
    tr, cfg = cell.traffic, cell.config
    b = int(tr["device_batch"])
    sched = schedule(tr, seed, 30.0, float(tr["rate_fields_per_s"]))
    lr = _lr_kelvin(cfg, seed, sched, device)
    picked = [(lr[k][0], int(sched["month"][k]), k // b, k % b) for k in range(fields)]
    cfg_b = dict(cfg, _batch=b)
    low = reference_kelvin(cfg_b, seed, picked, device, mode=mode)
    return compare(low, reference_kelvin(cfg_b, seed, picked, device))
