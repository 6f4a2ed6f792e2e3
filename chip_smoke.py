#!/usr/bin/env python3
"""Drive the PyTorch port's phydiff sampling path on one CUDA card and check it.

    python3 chip_smoke.py              # the smoke run, phases 1-5
    python3 chip_smoke.py --profile    # phases 1-2, then the UNet profile

Phases, one JSON line each; any failure exits non-zero before the result:
  1. device   — a CUDA card must be present (else exit 2, no result).
  2. build    — nvcc builds csrc/flash_attention.cu into build/srewd_tpu_torch/,
                and the first Triton compile of the GroupNorm+Swish kernel.
  3. kernels  — each kernel against its plain PyTorch version at every shape
                one full-width phydiff UNet call gives it (found by hooks on
                one forward pass), batch 8, float32 (TF32 off) and bfloat16,
                with median CUDA-event times of both.
  4. slice    — `srewd_tpu_torch.sample.main` on a synthetic 128x256 / 32x64
                t2m tree with the shipped DDIM-50 phydiff config at full width:
                24 fields in float32. Both kernels' launch counts must be > 0
                and the plain versions must not run.
  5. compare  — generate_sr with the kernels against generate_sr inside
                `reference_ops()` (same weights, same noise, batch 2, DDIM-5,
                float32): relative RMSE of the chain output <= 1e-3; one
                bfloat16 batch must be finite.
  --profile — instead of 3-5: per dtype, one full-width UNet call by host
                clock and by torch.profiler's device time per kernel, the card's
                idle share, and one DDIM-50 generate_sr (see profile_unet).
Then the kernels' summary line, the card's name and power limit, and the
result line. In the summary line, `launches` counts the kernel's launches in
phase 4, and `ms` / `plain_ms` are the device time of one UNet call's worth
of that kernel's calls (per shape: calls per UNet call x median time of one
call), float32, batch 8.

Tolerances of phase 3 (max abs error against the plain version):
  float32:  1e-5 * max(1, max|plain|) — float32 sums in another order;
  bfloat16: two bf16 ulps of max|plain| — both round the output once, the
            plain attention also rounds P to bf16 before P V and the plain
            Swish multiplies in bf16, so one rounding can flip either way.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
BUILD = os.path.join(REPO, "build")
CONFIG = os.path.join(
    REPO, "configs", "experiment_configs", "phydiff", "resdiff+physics_ddim50_eval.json")
BATCH = 8


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_ms(torch, fn, reps: int) -> float:
    """Median device time of one call of `fn`, in ms, from CUDA events."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def tolerance(torch, ref, dtype) -> float:
    peak = ref.float().abs().max().item()
    if dtype == torch.float32:
        return 1e-5 * max(1.0, peak)
    return 2.0 * 2.0 ** (math.floor(math.log2(max(peak, 1e-30))) - 7)


def rel_rmse(a, b) -> float:
    a, b = a.double(), b.double()
    return ((a - b).pow(2).mean() / b.pow(2).mean()).sqrt().item()


def main_path_shapes(torch, model, device):
    """(attention (kind, N, D) -> calls, GN (shape, swish) -> calls) of one UNet call."""
    from collections import Counter

    from srewd_tpu_torch.models.blocks import CrossAttention, FusedGroupNorm, SelfAttention

    attn, gn = Counter(), Counter()
    hooks = []
    for m in model.unet.modules():
        if isinstance(m, (SelfAttention, CrossAttention)):
            kind = "cross" if isinstance(m, CrossAttention) else "self"
            hooks.append(m.register_forward_pre_hook(
                lambda mod, inp, kind=kind: attn.update([(kind, inp[0].shape[2] * inp[0].shape[3],
                                                          inp[0].shape[1])])))
        elif isinstance(m, FusedGroupNorm):
            hooks.append(m.register_forward_pre_hook(
                lambda mod, inp: gn.update([((inp[0].shape[0], inp[0].shape[2],
                                              inp[0].shape[3], inp[0].shape[1]),
                                             mod.num_groups, mod.with_swish)])))
    x = torch.randn(BATCH, 128, 256, 2, device=device)
    lvl = torch.rand(BATCH, device=device)
    with torch.no_grad():
        model.unet(x, lvl)
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    return attn, gn


def compare_kernels(torch, attn_shapes, gn_shapes, device):
    from srewd_tpu_torch.ops.flash_attention import attention_reference, flash_attention
    from srewd_tpu_torch.ops.fused_groupnorm import gn_swish, gn_swish_reference

    g = torch.Generator(device=device).manual_seed(0)
    summary = {}
    k1 = {"f32_err": 0.0, "bf16_err": 0.0, "ms": 0.0, "plain_ms": 0.0}
    for (kind, n, d), calls in sorted(attn_shapes.items()):
        for dtype in (torch.float32, torch.bfloat16):
            # the layouts the main path passes: SelfAttention slices q, k, v out
            # of one [B,N,3D] slab; CrossAttention has its own q and a [B,N,2D] k/v slab
            if kind == "self":
                qkv = torch.randn(BATCH, n, 3 * d, device=device, generator=g).to(dtype)
                q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
            else:
                q = torch.randn(BATCH, n, d, device=device, generator=g).to(dtype)
                kv = torch.randn(BATCH, n, 2 * d, device=device, generator=g).to(dtype)
                k, v = kv[..., :d], kv[..., d:]
            scale = 1.0 / math.sqrt(d)
            out = flash_attention(q, k, v, scale)
            torch.cuda.synchronize()
            ref = attention_reference(q, k, v, scale)
            err = (out.float() - ref.float()).abs().max().item()
            tol = tolerance(torch, ref, dtype)
            ms = cuda_ms(torch, lambda: flash_attention(q, k, v, scale), 10)
            plain_ms = cuda_ms(torch, lambda: attention_reference(q, k, v, scale), 10)
            name = "f32" if dtype == torch.float32 else "bf16"
            emit({"phase": "kernel", "kernel": "flash_attention", "layout": kind, "n": n, "d": d,
                  "batch": BATCH, "dtype": name, "calls_per_unet_call": calls,
                  "max_abs_err": err, "tol": tol, "ms": ms, "plain_ms": plain_ms})
            check(err <= tol, f"flash_attention {kind} N={n} D={d} {name}: err {err} > {tol}")
            k1[f"{name}_err"] = max(k1[f"{name}_err"], err)
            if dtype == torch.float32:
                k1["ms"] += calls * ms
                k1["plain_ms"] += calls * plain_ms
    summary["flash_attention"] = k1

    k3 = {"f32_err": 0.0, "bf16_err": 0.0, "ms": 0.0, "plain_ms": 0.0}
    for (shape, groups, swish), calls in sorted(gn_shapes.items()):
        c = shape[-1]
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.randn(shape, device=device, generator=g) * 3 + 1).to(dtype)
            w = torch.randn(c, device=device, generator=g).to(dtype)
            b = torch.randn(c, device=device, generator=g).to(dtype)
            out = gn_swish(x, w, b, groups, 1e-5, swish)
            torch.cuda.synchronize()
            ref = gn_swish_reference(x, w, b, groups, 1e-5, swish)
            err = (out.float() - ref.float()).abs().max().item()
            tol = tolerance(torch, ref, dtype)
            ms = cuda_ms(torch, lambda: gn_swish(x, w, b, groups, 1e-5, swish), 20)
            plain_ms = cuda_ms(torch, lambda: gn_swish_reference(x, w, b, groups, 1e-5, swish), 20)
            name = "f32" if dtype == torch.float32 else "bf16"
            emit({"phase": "kernel", "kernel": "gn_swish", "shape": list(shape),
                  "groups": groups, "swish": swish, "dtype": name, "calls_per_unet_call": calls,
                  "max_abs_err": err, "tol": tol, "ms": ms, "plain_ms": plain_ms})
            check(err <= tol, f"gn_swish {shape} swish={swish} {name}: err {err} > {tol}")
            k3[f"{name}_err"] = max(k3[f"{name}_err"], err)
            if dtype == torch.float32:
                k3["ms"] += calls * ms
                k3["plain_ms"] += calls * plain_ms
    summary["gn_swish"] = k3
    return summary


def run_slice(torch, workdir):
    """Phase 4: the port's entry point on a full-width phydiff DDIM-50 run."""
    import numpy as np

    from srewd_tpu.data.store import make_synthetic_weatherbench
    from srewd_tpu_torch import sample
    from srewd_tpu_torch.ops.flash_attention import attention_reference, flash_attention
    from srewd_tpu_torch.ops.fused_groupnorm import gn_swish, gn_swish_reference

    data = os.path.join(workdir, "data")
    make_synthetic_weatherbench(data, "2017-01-01-00", "2017-01-03-00", spectrum="t2m")
    with open(CONFIG) as f:
        cfg = json.load(f)
    cfg["data"].update(
        dataroot=data, train_min_date="2017-01-01-00", train_max_date="2017-01-02-00",
        val_min_date="2017-01-02-00", val_max_date="2017-01-03-00",
        months_subset=[1], transform_groups={"january": [1]}, num_workers=8,
    )
    cfg_path = os.path.join(workdir, "phydiff_ddim50_smoke.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    out = os.path.join(workdir, "out")

    flash_attention.launches = gn_swish.launches = 0
    attention_reference.calls = gn_swish_reference.calls = 0
    summary = sample.main([
        "-c", cfg_path, "--date-range", "2017-01-02-00", "2017-01-03-00",
        "--batch-size", str(BATCH), "--save-npy", "-o", out, "--device", "cuda",
    ])
    launches = {"flash_attention": flash_attention.launches, "gn_swish": gn_swish.launches}
    plain_calls = attention_reference.calls + gn_swish_reference.calls

    files = sorted(os.listdir(os.path.join(out, "sr")))
    fields = [np.load(os.path.join(out, "sr", f)) for f in files]
    finite = all(bool(np.all(np.isfinite(a))) for a in fields)
    lo = min(float(a.min()) for a in fields)
    hi = max(float(a.max()) for a in fields)
    emit({"phase": "slice", "fields_written": len(files), "summary": summary,
          "launches": launches, "plain_calls": plain_calls, "finite": finite,
          "kelvin_min": lo, "kelvin_max": hi})
    check(len(files) == 24 and summary["fields"] == 24, f"expected 24 fields, got {len(files)}")
    check(all(a.shape == (128, 256, 1) for a in fields), "field shape is not 128x256x1")
    check(finite, "non-finite values in the written fields")
    check(180.0 < lo and hi < 360.0, f"fields outside a plausible Kelvin range: [{lo}, {hi}]")
    check(launches["flash_attention"] > 0 and launches["gn_swish"] > 0,
          f"a kernel was not launched on the main path: {launches}")
    check(plain_calls == 0, f"the plain versions ran {plain_calls} times on the main path")
    return launches, summary


def compare_slice(torch, device):
    """Phase 5: generate_sr with the kernels against the plain versions."""
    from srewd_tpu_torch.cli import random_init_
    from srewd_tpu_torch.diffusion.schedule import Schedule
    from srewd_tpu_torch.models.factory import build_model
    from srewd_tpu_torch.ops import reference_ops
    from srewd_tpu.configs.config import load_commented_json

    opt = load_commented_json(CONFIG)
    model = build_model(opt["model"])
    random_init_(model.unet, 0)
    model.unet.to(device)
    sched = Schedule.from_config(opt["model"]["beta_schedule"]["val"], device=device)
    g = torch.Generator(device=device).manual_seed(1)
    lr = torch.randn(2, 32, 64, 1, device=device, generator=g)
    kw = dict(sampler="ddim", ddim_steps=5, ddim_eta=1.0)

    def run(seed):
        gen = torch.Generator(device=device).manual_seed(seed)
        return model.generate_sr({"LR": lr}, sched, generator=gen, **kw)

    cond = model.condition({"LR": lr})
    t0 = time.perf_counter()
    with_kernels = run(2)
    torch.cuda.synchronize()
    t_kernels = time.perf_counter() - t0
    with reference_ops():
        t0 = time.perf_counter()
        plain = run(2)
        torch.cuda.synchronize()
        t_plain = time.perf_counter() - t0
    err = rel_rmse(with_kernels - cond, plain - cond)

    bf16 = build_model(opt["model"], dtype=torch.bfloat16)
    bf16.unet.load_state_dict(model.unet.state_dict())
    bf16.unet.to(device)
    out_bf16 = bf16.generate_sr({"LR": lr}, sched,
                                generator=torch.Generator(device=device).manual_seed(2), **kw)
    bf16_finite = bool(torch.isfinite(out_bf16).all().item())
    bf16_vs_f32 = rel_rmse(out_bf16 - cond, with_kernels - cond)
    emit({"phase": "compare", "rel_rmse_kernels_vs_plain": err, "bound": 1e-3,
          "sec_kernels": t_kernels, "sec_plain": t_plain, "bf16_finite": bf16_finite,
          "rel_rmse_bf16_vs_f32": bf16_vs_f32})
    check(err <= 1e-3, f"whole-slice kernels vs plain rel RMSE {err} > 1e-3")
    check(bf16_finite, "bfloat16 generate_sr gave non-finite values")


def _device_kernels(torch, prof, calls: int) -> list:
    """[(kernel name, device ms per call, launches per call)] from a profile,
    device-side events only (the CPU ops that launched them are not summed)."""
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        rows.append((e.key, e.self_device_time_total / 1e3 / calls, e.count / calls))
    return sorted(rows, key=lambda r: -r[1])


def profile_unet(torch, device) -> None:
    """--profile: where one full-width phydiff UNet call spends its time.

    Per dtype: host-clock ms of one UNet call (10 calls between two
    synchronisations, after 2 warm-up calls), the device time of each kernel
    per call from torch.profiler over 3 calls, the idle share of the card
    (1 - device busy ms / host ms, a single stream), and one DDIM-50
    generate_sr of batch 8. The full kernel table goes to build/profile/.
    """
    from torch.profiler import ProfilerActivity, profile

    from srewd_tpu.configs.config import load_commented_json
    from srewd_tpu_torch.cli import random_init_
    from srewd_tpu_torch.diffusion.schedule import Schedule
    from srewd_tpu_torch.models.factory import build_model
    from srewd_tpu_torch.ops.finite_diff import fd_stencils

    out_dir = os.path.join(BUILD, "profile")
    os.makedirs(out_dir, exist_ok=True)
    opt = load_commented_json(CONFIG)
    sched = Schedule.from_config(opt["model"]["beta_schedule"]["val"], device=device)
    g = torch.Generator(device=device).manual_seed(1)
    lr = torch.randn(BATCH, 32, 64, 1, device=device, generator=g)
    for dtype in (torch.float32, torch.bfloat16):
        name = "f32" if dtype == torch.float32 else "bf16"
        model = build_model(opt["model"], dtype=dtype)
        random_init_(model.unet, 0)
        model.unet.to(device=device, dtype=dtype).eval()
        cond = model.condition({"LR": lr})
        x = torch.cat([cond, torch.randn(cond.shape, device=device, generator=g)], dim=-1)
        lvl = torch.rand(BATCH, device=device, generator=g)
        kw = {"dwt_pyramid": model.unet.make_dwt_pyramid(cond), "fd_maps": fd_stencils(cond)}

        @torch.no_grad()
        def call():
            model.unet(x, lvl, **kw)

        for _ in range(2):
            call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            call()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) / 10 * 1e3

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                call()
            torch.cuda.synchronize()
        rows = _device_kernels(torch, prof, 3)
        busy = sum(r[1] for r in rows)
        with open(os.path.join(out_dir, f"unet_{name}.json"), "w") as f:
            json.dump(rows, f, indent=0)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.generate_sr({"LR": lr}, sched, generator=torch.Generator(device=device).manual_seed(2),
                          sampler="ddim", ddim_steps=50, ddim_eta=0.0)
        torch.cuda.synchronize()
        ddim_sec = time.perf_counter() - t0
        emit({"phase": "profile", "dtype": name, "batch": BATCH, "unet_call_host_ms": host_ms,
              "device_busy_ms": busy, "idle_share": 1.0 - busy / host_ms,
              "flash_attention_ms": sum(r[1] for r in rows if "flash_fwd_kernel" in r[0]),
              "gn_swish_ms": sum(r[1] for r in rows if "_gn_swish_kernel" in r[0]),
              "ddim50_sec": ddim_sec, "ddim50_fields_per_sec": BATCH / ddim_sec,
              "top_kernels": [[k[:90], ms, n] for k, ms, n in rows[:12]]})
        del model
        torch.cuda.empty_cache()


def main(argv: list) -> int:
    if argv not in ([], ["--profile"]):
        print(f"chip_smoke: unknown arguments {argv}; the only option is --profile",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA card",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "srewd_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(BUILD, "triton"))
    # float32 numerics: full-precision convolutions and matmuls (no TF32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)

    smi = nvidia_smi()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    from srewd_tpu_torch.ops import _build
    from srewd_tpu_torch.ops.flash_attention import _library
    from srewd_tpu_torch.ops.fused_groupnorm import gn_swish

    t0 = time.perf_counter()
    _build.build("flash_attention")
    _library()
    t_nvcc = time.perf_counter() - t0
    t0 = time.perf_counter()
    x = torch.randn(2, 8, 16, 64, device=device)
    gn_swish(x, torch.ones(64, device=device), torch.zeros(64, device=device), 32, 1e-5, True)
    torch.cuda.synchronize()
    t_triton = time.perf_counter() - t0
    emit({"phase": "build", "nvcc_sec": t_nvcc, "triton_first_compile_sec": t_triton,
          "build_dir": os.path.relpath(_build.BUILD_DIR, REPO)})
    if argv:
        profile_unet(torch, device)
        print(smi, flush=True)
        return 0

    from srewd_tpu_torch.cli import random_init_
    from srewd_tpu_torch.models.factory import build_model
    from srewd_tpu.configs.config import load_commented_json

    model = build_model(load_commented_json(CONFIG)["model"])
    random_init_(model.unet, 0)
    model.unet.to(device).eval()
    attn_shapes, gn_shapes = main_path_shapes(torch, model, device)
    del model
    emit({"phase": "shapes", "attention": [[kind, n, d, c] for (kind, n, d), c in sorted(attn_shapes.items())],
          "gn_swish": [[list(s), g, sw, c] for (s, g, sw), c in sorted(gn_shapes.items())]})
    kernels = compare_kernels(torch, attn_shapes, gn_shapes, device)
    torch.cuda.empty_cache()

    os.makedirs(BUILD, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD) as workdir:
        launches, _ = run_slice(torch, workdir)
    compare_slice(torch, device)

    emit({"kernels": [
        {"name": "flash_attention", "route": "cuda",
         "source": "srewd_tpu_torch/csrc/flash_attention.cu",
         "replaces": "srewd_tpu/ops/flash_attention.py:95",
         "launches": launches["flash_attention"],
         "max_abs_err": kernels["flash_attention"]["f32_err"],
         "max_abs_err_bf16": kernels["flash_attention"]["bf16_err"],
         "ms": kernels["flash_attention"]["ms"],
         "plain_ms": kernels["flash_attention"]["plain_ms"]},
        {"name": "gn_swish", "route": "triton",
         "source": "srewd_tpu_torch/ops/fused_groupnorm.py",
         "replaces": "srewd_tpu/ops/pallas_fused.py:149",
         "launches": launches["gn_swish"],
         "max_abs_err": kernels["gn_swish"]["f32_err"],
         "max_abs_err_bf16": kernels["gn_swish"]["bf16_err"],
         "ms": kernels["gn_swish"]["ms"],
         "plain_ms": kernels["gn_swish"]["plain_ms"]},
    ]})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main(sys.argv[1:])
    except Exception:
        traceback.print_exc()
        rc = 1
    sys.exit(rc)
