#!/usr/bin/env python3
"""Drive the PyTorch port's phydiff sampling and training paths on one CUDA
card and check them.

    python3 chip_smoke.py              # the smoke run, phases 1-7
    python3 chip_smoke.py --profile    # phases 1-2, then the UNet profile

Phases, one JSON line each; any failure exits non-zero before the result:
  1. device   — a CUDA card must be present (else exit 2, no result).
  2. build    — nvcc builds csrc/flash_attention.cu (K1),
                csrc/flash_attention_bwd.cu (K2) and csrc/gn_swish.cu (K3
                forward and backward), all at once, into
                build/srewd_tpu_torch/. One line per CUDA kernel
                instantiation: registers, static shared memory and spill
                bytes from `nvcc -Xptxas -v`, and, where cuobjdump is found,
                the count of tensor-core (HMMA) instructions in its SASS,
                which must be > 0 for every K1 and K2 kernel but Δ's (the GN
                kernels have no product and use none by design: NO_HMMA).
  3. kernels  — each kernel against its plain PyTorch version at every shape
                one full-width phydiff UNet call gives it (found by hooks on
                one forward pass), float32 (TF32 off) and bfloat16, in the
                main path's layouts, with median CUDA-event times of the
                kernel, the plain version and, where one exists, the one
                PyTorch call that computes the same function (library_ms:
                scaled_dot_product_attention's forward for K1, its backward
                for K2, F.group_norm forward and backward on the channels_last
                NCHW view for K3's swish-less shapes; the port never calls
                them; at K3's Swish shapes F.silu(F.group_norm(...)) is timed
                as `torch_two_calls_ms`, a yardstick, not a library call). K1
                and K3 forward at batch 8 (the sampling batch); K2 and the K3
                backward at batch 4 (the training batch), with K1's row
                log-sum-exp checked beside it (same O as without it, LSE
                against torch.logsumexp of the plain scores). K2 and the K3
                backward run twice on the same inputs: their gradients must be
                the same bit for bit (no atomics, sums in a fixed order). K3's
                y must be the same with and without its statistics output, and
                its mean and rstd within 1e-5 relative of the plain version's.
                K3 rows also give device_ms (10 calls captured in a CUDA graph
                and replayed: no host time between calls, unlike ms, which
                times one call as the caller meets it), pct_of_bound
                (bound_ms / ms), device_pct_of_bound, and gn_plan's slice,
                cluster size and shared memory per block.
  4. slice    — `srewd_tpu_torch.sample.main` on a synthetic 128x256 / 32x64
                t2m tree with the shipped DDIM-50 phydiff config at full width:
                24 fields in float32. K1's and K3's launch counts must be > 0
                and the plain versions must not run.
  5. compare  — generate_sr with the kernels against generate_sr inside
                `reference_ops()` (same weights, same noise, batch 2, DDIM-5,
                float32): relative RMSE of the chain output <= 1e-3; one
                bfloat16 batch must be finite.
  6. train    — `srewd_tpu_torch.train.main` on the same tree with the shipped
                phydiff train-example config at full width (batch 4, float32,
                Adam 1e-4, dropout 0.2): 20 steps, a checkpoint at step 10, one
                DDIM-10 validation batch at step 20; then a second run resumed
                from the step-10 checkpoint to step 20. Checks: every loss
                finite; K1, K2, K3 and its backward launched, the plain
                versions never; the
                resumed losses of steps 11-20 equal the first run's (1e-6
                relative); validation metrics in Kelvin finite. Before the
                runs, one step of a trainer built as main builds it must leave
                a finite, not all-zero gradient on every UNet parameter (a
                kernel without a gradient would leave zeros upstream of it),
                and the step is timed (steps/s) and profiled (device ms of
                K1, K2, K3 per step, idle share).
  7. step     — one loss.backward() of the full-width phydiff model with the
                kernels against one inside reference_ops() (same weights,
                batch, t, gamma and noise, dropout 0, batch 2, float32): loss
                relative difference <= 1e-5, every parameter's gradient
                relative RMSE <= 1e-3 (leaves whose gradient norm is under
                1e-6 of the largest: absolute RMSE against the largest norm).
  --profile — instead of 3-7: per dtype, one full-width UNet call by host
                clock and by torch.profiler's device time per kernel, the card's
                idle share, and one DDIM-50 generate_sr (see profile_unet).
Then the kernels' summary line, the card's name and power limit, and the
result line. In the summary line, `launches` counts the kernel's launches in
the first run of phase 6 (`launches_sample`: in phase 4); `ms`, `plain_ms`,
`library_ms` and `bound_ms` are device time per main-path unit, float32:
one UNet call at batch 8 for K1 and K3, one training step at batch 4 for K2
and the K3 backward (per shape: calls x the median time of one call); K3's
`library_ms` sums its swish-less shapes only (`library_ms_covers`), and
`torch_two_calls_ms` the F.silu(F.group_norm) yardstick of the others. `bound_ms` is the least
time the card could take for that work: the larger of the bytes (each input
read once, each output written once) over 3.35 TB/s and the flops over a
peak rate (published H100 SXM figures). K1 and K2 run float32 on the tensor
cores as three TF32 products per float32 product (3xTF32), so their float32
peak is 495 / 3 = 165 TFLOP/s; `bound_ms_cuda_cores` beside it takes the
float32 CUDA-core peak of 67 TFLOP/s, the bound of the earlier CUDA-core
kernels' records.
K3 runs on the CUDA cores (67 TFLOP/s float32; 10 flops an element forward,
20 backward); bfloat16 takes 989 TFLOP/s. K3's bytes: x read and y written
(forward); x and dy read and dx written (backward).
The op counts are 4·B·N²·D for K1 and 10·B·N²·D for K2 (the TPU kernels'
algorithm; K2's recomputing design does 14).

Tolerances of phase 3 (max abs error against the plain version):
  K1, K3 float32: 1e-5 * max(1, max|plain|) — float32 sums in another order;
  K2, K3 backward float32: 1e-4 * max(1, max|plain|) — dK and dV sum over up
                  to 8192 query rows, dweight and dbias over B x HW, and dx
                  takes group means of B x HW x C/G terms, in another order;
  bfloat16:       two bf16 ulps of max|plain| — both round the output once,
                  the plain attention also rounds P to bf16 before P V, the
                  plain Swish multiplies in bf16, the plain GN backward sums
                  in another order, and K2 takes Δ from the
                  stored bf16 O (rowsum(dO ∘ O)) where the plain backward
                  sums P ∘ dP in float32, so one rounding can flip either way.
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
CONFIG_TRAIN = os.path.join(
    REPO, "configs", "experiment_configs", "phydiff", "resdiff+physics_train_example.json")
BATCH = 8
TRAIN_BATCH = 4
PEAK_F32 = 67e12  # float32 CUDA-core FLOP/s, H100 SXM
PEAK_TF32X3 = 495e12 / 3  # float32-accurate 3xTF32 on the tensor cores, H100 SXM
PEAK_BF16 = 989e12  # bf16 dense tensor-core FLOP/s, H100 SXM
HBM = 3.35e12  # bytes/s


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


def graph_ms(torch, fn, n: int = 10) -> float:
    """Device time of one call of `fn`, in ms: n calls captured in a CUDA
    graph, the graph replayed (median of 5, CUDA events), divided by n. No
    host time between the calls, unlike cuda_ms of a single call."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    ms = cuda_ms(torch, graph.replay, 5) / n
    del graph
    return ms


def tolerance(torch, ref, dtype, f32_rel: float = 1e-5) -> float:
    peak = ref.float().abs().max().item()
    if dtype == torch.float32:
        return f32_rel * max(1.0, peak)
    return 2.0 * 2.0 ** (math.floor(math.log2(max(peak, 1e-30))) - 7)


def bound(flops: float, nbytes: float, peak: float = PEAK_F32) -> tuple:
    """(least ms, what bounds it) for work of `flops` at `peak` moving `nbytes`."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def attention_inputs(torch, kind, b, n, d, dtype, device, g):
    """q, k, v in the main path's layouts: SelfAttention slices them out of one
    [B,N,3D] slab; CrossAttention has its own q and a [B,N,2D] k/v slab."""
    if kind == "self":
        qkv = torch.randn(b, n, 3 * d, device=device, generator=g).to(dtype)
        return qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
    q = torch.randn(b, n, d, device=device, generator=g).to(dtype)
    kv = torch.randn(b, n, 2 * d, device=device, generator=g).to(dtype)
    return q, kv[..., :d], kv[..., d:]


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


def _totals() -> dict:
    return {"f32_err": 0.0, "bf16_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
            "bound_ms": 0.0, "bound_by": None, "bound_ms_cuda_cores": 0.0}


def _add(tot: dict, calls: int, ms: float, plain_ms: float, library_ms, b: tuple,
         b_cuda_cores: float) -> None:
    tot["ms"] += calls * ms
    tot["plain_ms"] += calls * plain_ms
    tot["library_ms"] = None if library_ms is None else tot["library_ms"] + calls * library_ms
    tot["bound_ms"] += calls * b[0]
    tot["bound_ms_cuda_cores"] += calls * b_cuda_cores
    tot["bound_by"] = b[1] if tot["bound_by"] in (None, b[1]) else "operations and bytes"


def compare_attention(torch, attn_shapes, device) -> dict:
    """K1 (batch 8) and K2 (batch 4) against their plain versions."""
    import torch.nn.functional as F

    from srewd_tpu_torch.ops.flash_attention import (
        attention_backward_reference, attention_reference, flash_attention,
        flash_attention_backward)

    g = torch.Generator(device=device).manual_seed(0)
    k1, k2 = _totals(), _totals()
    for (kind, n, d), calls in sorted(attn_shapes.items()):
        scale = 1.0 / math.sqrt(d)
        for dtype in (torch.float32, torch.bfloat16):
            name = "f32" if dtype == torch.float32 else "bf16"
            f32 = dtype == torch.float32
            isz, peak = (4, PEAK_TF32X3) if f32 else (2, PEAK_BF16)
            q, k, v = attention_inputs(torch, kind, BATCH, n, d, dtype, device, g)
            out = flash_attention(q, k, v, scale)
            torch.cuda.synchronize()
            ref = attention_reference(q, k, v, scale)
            err = (out.float() - ref.float()).abs().max().item()
            tol = tolerance(torch, ref, dtype)
            del ref
            ms = cuda_ms(torch, lambda: flash_attention(q, k, v, scale), 10)
            plain_ms = cuda_ms(torch, lambda: attention_reference(q, k, v, scale), 10)
            lib_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v, scale=scale), 10)
            work = (4.0 * BATCH * n * n * d, 4.0 * BATCH * n * d * isz)
            b, b_cc = bound(*work, peak), bound(*work)[0] if f32 else None
            emit({"phase": "kernel", "kernel": "flash_attention", "layout": kind, "n": n, "d": d,
                  "batch": BATCH, "dtype": name, "calls_per_unet_call": calls,
                  "max_abs_err": err, "tol": tol, "ms": ms, "plain_ms": plain_ms,
                  "library_ms": lib_ms, "bound_ms": b[0], "bound_by": b[1],
                  "bound_ms_cuda_cores": b_cc})
            check(err <= tol, f"flash_attention {kind} N={n} D={d} {name}: err {err} > {tol}")
            k1[f"{name}_err"] = max(k1[f"{name}_err"], err)
            if f32:
                _add(k1, calls, ms, plain_ms, lib_ms, b, b_cc)
            del q, k, v, out

            # K2 at the training batch, with the forward's row log-sum-exp
            q, k, v = attention_inputs(torch, kind, TRAIN_BATCH, n, d, dtype, device, g)
            do = torch.randn(TRAIN_BATCH, n, d, device=device, generator=g).to(dtype)
            o_plain_fwd = flash_attention(q, k, v, scale)
            o, lse = flash_attention(q, k, v, scale, return_lse=True)
            s = torch.einsum("bid,bjd->bij", q.float(), k.float()) * scale
            lse_err = (lse - torch.logsumexp(s, dim=-1)).abs().max().item()
            del s
            same_o = bool(torch.equal(o, o_plain_fwd))
            dq, dk, dv = flash_attention_backward(q, k, v, o, lse, do, scale)
            again = flash_attention_backward(q, k, v, o, lse, do, scale)
            torch.cuda.synchronize()
            same_grads = all(bool(torch.equal(a, b)) for a, b in zip((dq, dk, dv), again))
            refs = attention_backward_reference(q, k, v, do, scale)
            errs = [(a.float() - r.float()).abs().max().item() for a, r in zip((dq, dk, dv), refs)]
            tols = [tolerance(torch, r, dtype, f32_rel=1e-4) for r in refs]
            del refs, dq, dk, dv, again
            ms2 = cuda_ms(torch, lambda: flash_attention_backward(q, k, v, o, lse, do, scale), 10)
            plain_ms2 = cuda_ms(
                torch, lambda: attention_backward_reference(q, k, v, do, scale), 5)
            ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
            lib_out = F.scaled_dot_product_attention(ql, kl, vl, scale=scale)
            lib_ms2 = cuda_ms(torch, lambda: torch.autograd.grad(
                lib_out, (ql, kl, vl), do, retain_graph=True), 5)
            del lib_out, ql, kl, vl
            work2 = (10.0 * TRAIN_BATCH * n * n * d,
                     8.0 * TRAIN_BATCH * n * d * isz + 4.0 * TRAIN_BATCH * n)
            b2, b2_cc = bound(*work2, peak), bound(*work2)[0] if f32 else None
            emit({"phase": "kernel", "kernel": "flash_attention_backward", "layout": kind,
                  "n": n, "d": d, "batch": TRAIN_BATCH, "dtype": name,
                  "calls_per_step": calls, "max_abs_err_dq_dk_dv": errs, "tol": tols,
                  "same_grads_twice": same_grads,
                  "lse_max_abs_err": lse_err, "o_same_with_lse": same_o, "ms": ms2,
                  "plain_ms": plain_ms2, "library_ms": lib_ms2, "bound_ms": b2[0],
                  "bound_by": b2[1], "bound_ms_cuda_cores": b2_cc})
            for nm, e, t in zip(("dq", "dk", "dv"), errs, tols):
                check(e <= t, f"flash_attention_backward {kind} N={n} D={d} {name} {nm}: "
                              f"err {e} > {t}")
            check(same_grads, f"K2 gave other gradients on the same inputs ({kind} N={n} D={d} "
                              f"{name})")
            check(same_o, f"K1 with the LSE output changed O ({kind} N={n} D={d} {name})")
            check(lse_err <= 1e-4 * max(1.0, lse.abs().max().item()),
                  f"K1's LSE is off by {lse_err} ({kind} N={n} D={d} {name})")
            k2[f"{name}_err"] = max(k2[f"{name}_err"], *errs)
            if f32:
                _add(k2, calls, ms2, plain_ms2, lib_ms2, b2, b2_cc)
            del q, k, v, do, o, lse, o_plain_fwd
            torch.cuda.empty_cache()
    return {"flash_attention": k1, "flash_attention_backward": k2}


def compare_gn(torch, gn_shapes, device) -> dict:
    """K3 forward (batch 8) and backward (batch 4) against their plain
    versions at every main-path shape, float32 and bfloat16."""
    import torch.nn.functional as F

    from srewd_tpu_torch.ops.fused_groupnorm import (
        gn_plan, gn_swish, gn_swish_backward, gn_swish_backward_reference, gn_swish_reference,
        max_active_clusters)

    g = torch.Generator(device=device).manual_seed(1)
    k3, k3b = _totals(), _totals()
    for tot in (k3, k3b):
        tot.update(library_ms=0.0, torch_two_calls_ms=0.0, device_ms=0.0,
                   library_ms_covers="the swish-less launches only (F.group_norm)")
    for (shape, groups, swish), calls in sorted(gn_shapes.items()):
        c = shape[-1]
        for dtype in (torch.float32, torch.bfloat16):
            name = "f32" if dtype == torch.float32 else "bf16"
            f32 = dtype == torch.float32
            peak = PEAK_F32 if f32 else PEAK_BF16
            w = torch.randn(c, device=device, generator=g).to(dtype)
            b = torch.randn(c, device=device, generator=g).to(dtype)

            def torch_gn(x_nhwc):
                """F.group_norm on the channels_last NCHW view the UNet holds
                (+ F.silu): timed as a yardstick, never called by the port."""
                y = F.group_norm(x_nhwc.permute(0, 3, 1, 2), groups, w, b, 1e-5)
                return F.silu(y) if swish else y

            # forward, batch 8
            x = (torch.randn(shape, device=device, generator=g) * 3 + 1).to(dtype)
            out = gn_swish(x, w, b, groups, 1e-5, swish)
            out_s, mean, rstd = gn_swish(x, w, b, groups, 1e-5, swish, return_stats=True)
            torch.cuda.synchronize()
            ref, mean_p, rstd_p = gn_swish_reference(x, w, b, groups, 1e-5, swish,
                                                      return_stats=True)
            err = (out.float() - ref.float()).abs().max().item()
            tol = tolerance(torch, ref, dtype)
            same_y = bool(torch.equal(out, out_s))
            stats_err = max(((mean - mean_p).abs() / mean_p.abs().clamp_min(1e-30)).max().item(),
                            ((rstd - rstd_p).abs() / rstd_p.abs()).max().item())
            del ref, out_s
            ms = cuda_ms(torch, lambda: gn_swish(x, w, b, groups, 1e-5, swish), 20)
            dev_ms = graph_ms(torch, lambda: gn_swish(x, w, b, groups, 1e-5, swish))
            plain_ms = cuda_ms(torch, lambda: gn_swish_reference(x, w, b, groups, 1e-5, swish), 20)
            torch_ms = cuda_ms(torch, lambda: torch_gn(x), 20)
            # x read once, y written once, weight and bias read once
            bd = bound(10.0 * x.numel(), 2.0 * x.numel() * x.element_size() + 2 * c * 4, peak)
            plan = gn_plan(shape, groups, dtype)
            emit({"phase": "kernel", "kernel": "gn_swish", "shape": list(shape),
                  "groups": groups, "swish": swish, "dtype": name, "calls_per_unet_call": calls,
                  "max_abs_err": err, "tol": tol, "y_same_with_stats": same_y,
                  "stats_max_rel_err": stats_err, "ms": ms, "device_ms": dev_ms,
                  "plain_ms": plain_ms,
                  "library_ms": None if swish else torch_ms,
                  "torch_two_calls_ms": torch_ms if swish else None,
                  "bound_ms": bd[0], "bound_by": bd[1], "pct_of_bound": 100.0 * bd[0] / ms,
                  "device_pct_of_bound": 100.0 * bd[0] / dev_ms,
                  "slice_channels": plan.slice_channels, "cluster": plan.cluster,
                  "bytes_per_cta": plan.bytes_per_cta, "blocks": plan.blocks,
                  "max_active_clusters": max_active_clusters(plan, dtype, False)})
            check(err <= tol, f"gn_swish {shape} swish={swish} {name}: err {err} > {tol}")
            check(same_y, f"gn_swish's y changed with the statistics output ({shape} {name})")
            check(stats_err <= 1e-5, f"gn_swish's mean/rstd off by {stats_err} relative "
                                     f"({shape} {name})")
            k3[f"{name}_err"] = max(k3[f"{name}_err"], err)
            if f32:
                _add(k3, calls, ms, plain_ms, 0.0, bd, bd[0])
                k3["device_ms"] += calls * dev_ms
                k3["library_ms" if not swish else "torch_two_calls_ms"] += calls * torch_ms
            del x, out, mean, rstd, mean_p, rstd_p

            # backward, batch 4: x, dy read once, dx written once
            bshape = (TRAIN_BATCH, *shape[1:])
            x = (torch.randn(bshape, device=device, generator=g) * 3 + 1).to(dtype)
            dy = torch.randn(bshape, device=device, generator=g).to(dtype)
            _, mean, rstd = gn_swish(x, w, b, groups, 1e-5, swish, return_stats=True)
            grads = gn_swish_backward(x, dy, w, b, mean, rstd, groups, swish)
            again = gn_swish_backward(x, dy, w, b, mean, rstd, groups, swish)
            torch.cuda.synchronize()
            same_grads = all(bool(torch.equal(p, q)) for p, q in zip(grads, again))
            refs = gn_swish_backward_reference(x, dy, w, b, groups, 1e-5, swish)
            errs = [(p.float() - r.float()).abs().max().item() for p, r in zip(grads, refs)]
            tols = [tolerance(torch, r, dtype, f32_rel=1e-4) for r in refs]
            del grads, again, refs
            ms2 = cuda_ms(torch, lambda: gn_swish_backward(x, dy, w, b, mean, rstd, groups,
                                                           swish), 20)
            dev_ms2 = graph_ms(torch, lambda: gn_swish_backward(x, dy, w, b, mean, rstd, groups,
                                                                swish))
            plain_ms2 = cuda_ms(torch, lambda: gn_swish_backward_reference(
                x, dy, w, b, groups, 1e-5, swish), 10)
            xl, wl, bl = (t.detach().clone().requires_grad_() for t in (x, w, b))
            yl = F.group_norm(xl.permute(0, 3, 1, 2), groups, wl, bl, 1e-5)
            yl = F.silu(yl) if swish else yl
            torch_ms2 = cuda_ms(torch, lambda: torch.autograd.grad(
                yl, (xl, wl, bl), dy.permute(0, 3, 1, 2), retain_graph=True), 10)
            del xl, wl, bl, yl
            bd2 = bound(20.0 * x.numel(), 3.0 * x.numel() * x.element_size() + 4 * c * 4, peak)
            plan2 = gn_plan(bshape, groups, dtype, backward=True)
            emit({"phase": "kernel", "kernel": "gn_swish_backward", "shape": list(bshape),
                  "groups": groups, "swish": swish, "dtype": name, "calls_per_step": calls,
                  "max_abs_err_dx_dw_db": errs, "tol": tols, "same_grads_twice": same_grads,
                  "ms": ms2, "device_ms": dev_ms2, "plain_ms": plain_ms2,
                  "library_ms": None if swish else torch_ms2,
                  "torch_two_calls_ms": torch_ms2 if swish else None,
                  "bound_ms": bd2[0], "bound_by": bd2[1], "pct_of_bound": 100.0 * bd2[0] / ms2,
                  "device_pct_of_bound": 100.0 * bd2[0] / dev_ms2,
                  "slice_channels": plan2.slice_channels, "cluster": plan2.cluster,
                  "bytes_per_cta": plan2.bytes_per_cta, "blocks": plan2.blocks,
                  "max_active_clusters": max_active_clusters(plan2, dtype, True)})
            for nm, e, t in zip(("dx", "dweight", "dbias"), errs, tols):
                check(e <= t, f"gn_swish_backward {bshape} swish={swish} {name} {nm}: "
                              f"err {e} > {t}")
            check(same_grads, f"the GN backward gave other gradients on the same inputs "
                              f"({bshape} swish={swish} {name})")
            k3b[f"{name}_err"] = max(k3b[f"{name}_err"], *errs)
            if f32:
                _add(k3b, calls, ms2, plain_ms2, 0.0, bd2, bd2[0])
                k3b["device_ms"] += calls * dev_ms2
                k3b["library_ms" if not swish else "torch_two_calls_ms"] += calls * torch_ms2
            del x, dy, mean, rstd
            torch.cuda.empty_cache()
    for tot in (k3, k3b):
        tot["pct_of_bound"] = 100.0 * tot["bound_ms"] / tot["ms"]
        tot["device_pct_of_bound"] = 100.0 * tot["bound_ms"] / tot["device_ms"]
    return {"gn_swish": k3, "gn_swish_backward": k3b}


def _counters():
    from srewd_tpu_torch.ops import flash_attention as fa
    from srewd_tpu_torch.ops import fused_groupnorm as gn

    kernels = {"flash_attention": fa.flash_attention,
               "flash_attention_backward": fa.flash_attention_backward,
               "gn_swish": gn.gn_swish,
               "gn_swish_backward": gn.gn_swish_backward}
    plain = {"attention_reference": fa.attention_reference,
             "attention_backward_reference": fa.attention_backward_reference,
             "gn_swish_reference": gn.gn_swish_reference,
             "gn_swish_backward_reference": gn.gn_swish_backward_reference}
    return kernels, plain


def reset_counts() -> None:
    kernels, plain = _counters()
    for f in kernels.values():
        f.launches = 0
    for f in plain.values():
        f.calls = 0


def read_counts() -> tuple:
    """({kernel: launches}, {plain version: calls}) since reset_counts()."""
    kernels, plain = _counters()
    return ({k: f.launches for k, f in kernels.items()}, {k: f.calls for k, f in plain.items()})


def data_settings(workdir) -> dict:
    """The synthetic 128x256 / 32x64 t2m tree (made once) and its date split."""
    from srewd_tpu_torch.data.store import make_synthetic_weatherbench

    data = os.path.join(workdir, "data")
    make_synthetic_weatherbench(data, "2017-01-01-00", "2017-01-03-00", spectrum="t2m")
    return dict(dataroot=data, train_min_date="2017-01-01-00", train_max_date="2017-01-02-00",
                val_min_date="2017-01-02-00", val_max_date="2017-01-03-00",
                months_subset=[1], transform_groups={"january": [1]}, num_workers=8)


def run_slice(torch, workdir):
    """Phase 4: the port's entry point on a full-width phydiff DDIM-50 run."""
    import numpy as np

    from srewd_tpu_torch import sample

    with open(CONFIG) as f:
        cfg = json.load(f)
    cfg["data"].update(data_settings(workdir))
    cfg_path = os.path.join(workdir, "phydiff_ddim50_smoke.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    out = os.path.join(workdir, "out")

    reset_counts()
    summary = sample.main([
        "-c", cfg_path, "--date-range", "2017-01-02-00", "2017-01-03-00",
        "--batch-size", str(BATCH), "--save-npy", "-o", out, "--device", "cuda",
    ])
    launches, plain_calls = read_counts()

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
    check(sum(plain_calls.values()) == 0,
          f"the plain versions ran on the main path: {plain_calls}")
    return launches, summary


def compare_slice(torch, device):
    """Phase 5: generate_sr with the kernels against the plain versions."""
    from srewd_tpu_torch.cli import random_init_
    from srewd_tpu_torch.diffusion.schedule import Schedule
    from srewd_tpu_torch.models.factory import build_model
    from srewd_tpu_torch.configs.config import load_commented_json
    from srewd_tpu_torch.ops import reference_ops

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
    device-side events only (the CPU ops that launched them are not summed,
    nor the device-side ranges of annotations such as Optimizer.step)."""
    rows = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA or getattr(e, "is_user_annotation", False):
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

    from srewd_tpu_torch.cli import random_init_
    from srewd_tpu_torch.configs.config import load_commented_json
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
              "gn_swish_ms": sum(r[1] for r in rows if "gn_fwd_kernel" in r[0]),
              "ddim50_sec": ddim_sec, "ddim50_fields_per_sec": BATCH / ddim_sec,
              "top_kernels": [[k[:90], ms, n] for k, ms, n in rows[:12]]})
        del model
        torch.cuda.empty_cache()


def train_config(workdir) -> str:
    """Phase 6's config: the shipped train example at full width, on the
    synthetic tree, cut to 20 steps with a DDIM-10 validation batch."""
    from srewd_tpu_torch.configs.config import load_commented_json

    cfg = load_commented_json(CONFIG_TRAIN)
    cfg["data"].update(data_settings(workdir))
    cfg["path"]["experiments_folder_path"] = workdir
    cfg["train"].update(n_iter=20, print_freq=5, save_checkpoint_freq=10, val_freq=20,
                        full_val_freq=1000)
    cfg["model"]["diffusion"].update(sampler="ddim", ddim_steps=10)
    path = os.path.join(workdir, "phydiff_train_smoke.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def check_step(torch, cfg_path, device) -> dict:
    """One step of a trainer built as train.main builds it: every UNet
    parameter gets a finite, not all-zero gradient. Then steps/s of 5 steps
    (host clock to a synchronise) and a torch.profiler window of 3 steps."""
    from torch.profiler import ProfilerActivity, profile

    from srewd_tpu_torch.cli import Config, build_data_handler, build_trainer, cuda_numerics

    cuda_numerics(device, training=True)  # as train.main sets them
    opt = Config(cfg_path, phase="train", experiment=False).get_opt()
    opt["path"]["checkpoint"] = None
    dh = build_data_handler(opt)
    trainer = build_trainer(opt, device)
    batches = list(dh.train_batches(epoch=1))
    t0 = time.perf_counter()
    trainer.train_on_batch(batches[0])  # also times cuDNN's algorithms per shape
    first_step_sec = time.perf_counter() - t0
    bad = []
    for name, p in trainer.model.unet.named_parameters():
        if p.grad is None or not bool(torch.isfinite(p.grad).all()) or not bool(p.grad.any()):
            bad.append(name)
    n_params = sum(1 for _ in trainer.model.unet.parameters())
    check(not bad, f"{len(bad)} of {n_params} UNet parameters got no finite nonzero gradient "
                   f"after the first step: {bad[:8]}")

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(5):
        trainer.train_on_batch_async(batches[(1 + i) % len(batches)])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 5 * 1e3
    per_step, _ = read_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(3):
            trainer.train_on_batch_async(batches[i % len(batches)])
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) / 3 * 1e3
    rows = _device_kernels(torch, prof, 3)
    with open(os.path.join(BUILD, "profile", "train_step_f32.json"), "w") as f:
        json.dump(rows, f, indent=0)
    busy = sum(r[1] for r in rows)
    k1 = sum(r[1] for r in rows if "flash_fwd_kernel" in r[0])
    k2 = sum(r[1] for r in rows if "flash_bwd_" in r[0])
    k3 = sum(r[1] for r in rows if "gn_fwd_kernel" in r[0])
    k3b = sum(r[1] for r in rows if "gn_bwd_kernel" in r[0] or "gn_wb_kernel" in r[0])
    out = {"phase": "train_step", "batch": TRAIN_BATCH, "dtype": "f32",
           "params_with_grad": n_params, "first_step_sec": first_step_sec,
           "step_host_ms": step_ms,
           "steps_per_sec": 1e3 / step_ms,
           "launches_per_step": {k: v / 5 for k, v in per_step.items()},
           "device_busy_ms": busy, "idle_share": 1.0 - busy / step_ms,
           "profiled_step_host_ms": window_ms, "idle_share_profiled": 1.0 - busy / window_ms,
           "flash_attention_ms": k1, "flash_attention_backward_ms": k2, "gn_swish_ms": k3,
           "gn_swish_backward_ms": k3b,
           "share_k1": k1 / step_ms, "share_k2": k2 / step_ms, "share_k3": k3 / step_ms,
           "share_k3_backward": k3b / step_ms,
           "top_kernels": [[k[:90], ms, n] for k, ms, n in rows[:12]]}
    emit(out)
    del trainer
    torch.cuda.empty_cache()
    return out


def run_train_slice(torch, workdir, device) -> dict:
    """Phase 6: train.main for 20 steps, then resumed from step 10."""
    import glob

    from srewd_tpu_torch import train

    cfg_path = train_config(workdir)
    step = check_step(torch, cfg_path, device)

    reset_counts()
    t0 = time.perf_counter()
    first = train.main(["-c", cfg_path, "--device", str(device)])
    sec = time.perf_counter() - t0
    launches, plain_calls = read_counts()
    ckpts = glob.glob(os.path.join(workdir, "experiments", "*", "checkpoint", "I10_E*"))
    check(len(ckpts) == 1, f"expected one step-10 checkpoint, found {ckpts}")
    with open(cfg_path) as f:
        cfg = json.load(f)
    cfg["path"]["resume_state"] = ckpts[0]
    resume_path = os.path.join(workdir, "phydiff_train_resume.json")
    with open(resume_path, "w") as f:
        json.dump(cfg, f)
    reset_counts()
    second = train.main(["-c", resume_path, "--device", str(device)])
    launches_resume, plain_resume = read_counts()

    losses = dict(first["losses"])
    resumed = dict(second["losses"])
    rel = max(abs(resumed[s] - losses[s]) / max(abs(losses[s]), 1e-30) for s in resumed)
    vals = first["val"][-1][1] if first["val"] else {}
    emit({"phase": "train", "steps": len(losses), "batch": TRAIN_BATCH, "dtype": "f32",
          "losses": [losses[s] for s in sorted(losses)], "sec_20_steps": sec,
          "steps_per_sec_run": first["steps_per_sec"], "launches": launches,
          "plain_calls": plain_calls, "resumed_steps": sorted(resumed),
          "resume_max_rel_diff": rel, "launches_resume": launches_resume,
          "val_kelvin": vals})
    check(sorted(losses) == list(range(1, 21)), f"steps logged: {sorted(losses)}")
    check(all(math.isfinite(v) for v in losses.values()), "a training loss is not finite")
    check(all(launches[k] > 0 for k in launches), f"a kernel was not launched: {launches}")
    check(sum(plain_calls.values()) + sum(plain_resume.values()) == 0,
          f"the plain versions ran on the training path: {plain_calls} {plain_resume}")
    check(sorted(resumed) == list(range(11, 21)), f"resumed steps: {sorted(resumed)}")
    check(rel <= 1e-6, f"resumed losses differ from the first run's by {rel} (relative)")
    check(bool(vals) and all(math.isfinite(v) for v in vals.values()),
          f"validation metrics in Kelvin not finite: {vals}")
    return {"launches": launches, "step": step}


def compare_train_step(torch, device) -> None:
    """Phase 7: one loss.backward() with the kernels against the plain versions."""
    import copy

    from srewd_tpu_torch.cli import random_init_
    from srewd_tpu_torch.configs.config import load_commented_json
    from srewd_tpu_torch.diffusion.schedule import Schedule
    from srewd_tpu_torch.models.factory import build_model
    from srewd_tpu_torch.ops import reference_ops

    opt = load_commented_json(CONFIG_TRAIN)
    model_cfg = copy.deepcopy(opt["model"])
    model_cfg["unet"]["dropout"] = 0.0
    model = build_model(model_cfg)
    random_init_(model.unet, 0)
    model.unet.to(device)
    sched = Schedule.from_config(opt["model"]["beta_schedule"]["train"], device=device)
    h, w = (int(model_cfg["diffusion"][k]) for k in ("image_height", "image_width"))
    g = torch.Generator(device=device).manual_seed(3)
    batch = {"HR": torch.randn(2, h, w, 1, device=device, generator=g),
             "LR": torch.randn(2, h // 4, w // 4, 1, device=device, generator=g)}
    draws = {"t": torch.tensor([500], device=device),
             "u": torch.rand(2, device=device, generator=g),
             "noise": torch.randn(2, h, w, 1, device=device, generator=g)}

    def run():
        model.unet.zero_grad(set_to_none=True)
        loss = model.loss(batch, sched, **draws)
        loss.backward()
        torch.cuda.synchronize()
        return loss.item(), {n: p.grad.detach().clone() for n, p in model.unet.named_parameters()}

    loss_k, grads_k = run()
    with reference_ops():
        loss_p, grads_p = run()
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    largest = max(gp.double().norm().item() for gp in grads_p.values())
    worst, worst_name, n_small = 0.0, None, 0
    for name, gp in grads_p.items():
        gk, gp = grads_k[name].double(), gp.double()
        if gp.norm().item() < 1e-6 * largest:
            n_small += 1
            err = (gk - gp).norm().item() / largest
        else:
            err = ((gk - gp).pow(2).mean() / gp.pow(2).mean()).sqrt().item()
        if err > worst:
            worst, worst_name = err, name
    emit({"phase": "step", "batch": 2, "dtype": "f32", "loss_kernels": loss_k,
          "loss_plain": loss_p, "loss_rel_diff": loss_rel, "grad_leaves": len(grads_p),
          "small_leaves": n_small, "worst_grad_rel_rmse": worst, "worst_leaf": worst_name,
          "bounds": {"loss": 1e-5, "grad": 1e-3}})
    check(loss_rel <= 1e-5, f"whole-step loss differs by {loss_rel} (relative)")
    check(worst <= 1e-3, f"gradient of {worst_name} differs by {worst} (relative RMSE)")
    del model
    torch.cuda.empty_cache()


def kernel_entry(name, route, source, replaces, tot, launches, launches_sample=None) -> dict:
    entry = {"name": name, "route": route, "source": source, "replaces": replaces,
             "launches": launches, "max_abs_err": tot["f32_err"],
             "max_abs_err_bf16": tot["bf16_err"], "ms": tot["ms"], "plain_ms": tot["plain_ms"],
             "bound_ms": tot["bound_ms"], "bound_by": tot["bound_by"],
             "bound_ms_cuda_cores": tot["bound_ms_cuda_cores"], "library_ms": tot["library_ms"]}
    for key in ("pct_of_bound", "device_ms", "device_pct_of_bound", "library_ms_covers",
                "torch_two_calls_ms"):
        if key in tot:
            entry[key] = tot[key]
    if launches_sample is not None:
        entry["launches_sample"] = launches_sample
    return entry


def kernel_name(demangled: str) -> str:
    """A demangled kernel signature without its return type, anonymous
    namespace and parameter list: `kernel<float, (int)64, ...>`."""
    name = demangled.removeprefix("void ")
    for anon in ("<unnamed>::", "(anonymous namespace)::"):
        name = name.replace(anon, "")
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
            if depth == 0:
                return name[:i + 1]
    return name.split("(")[0]


# Kernels that use no tensor cores by design: K2's Δ = rowsum(dO ∘ O), and
# K3 forward and backward (GroupNorm is bound by memory and has no product).
NO_HMMA = ("flash_bwd_delta_kernel", "gn_fwd_kernel", "gn_bwd_kernel", "gn_wb_kernel")


def needs_hmma(name: str) -> bool:
    """Whether phase 2 requires tensor-core instructions in kernel `name`."""
    return not name.startswith(NO_HMMA)


def report_cuda_kernels() -> None:
    """Phase 2's line per CUDA kernel instantiation: ptxas's registers,
    static shared memory and spills, and the HMMA count of its SASS."""
    from srewd_tpu_torch.ops import _build

    for source in _build.SOURCES:
        hmma = _build.sass_mma_counts(source)
        for r in _build.ptxas_report(source):
            name = kernel_name(r["name"])
            count = None if hmma is None else hmma.get(r["kernel"], 0)
            emit({"phase": "build", "source": source, "kernel": name,
                  "registers": r["registers"], "smem_static_bytes": r["smem_static"],
                  "spill_store_bytes": r["spill_stores"], "spill_load_bytes": r["spill_loads"],
                  "stack_bytes": r["stack"], "hmma": count})
            check(count is None or count > 0 or not needs_hmma(name),
                  f"{name} has no tensor-core instruction in its SASS")


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
    # float32 numerics: full-precision convolutions and matmuls (no TF32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)

    smi = nvidia_smi()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    from srewd_tpu_torch.ops import _build
    from srewd_tpu_torch.ops import fused_groupnorm
    from srewd_tpu_torch.ops.flash_attention import _bwd_library, _library

    t0 = time.perf_counter()
    _build.build_all()
    _library()
    _bwd_library()
    fused_groupnorm._library()
    t_nvcc = time.perf_counter() - t0
    emit({"phase": "build", "sources": list(_build.SOURCES), "nvcc_sec": t_nvcc,
          "build_dir": os.path.relpath(_build.BUILD_DIR, REPO)})
    report_cuda_kernels()
    os.makedirs(os.path.join(BUILD, "profile"), exist_ok=True)
    if argv:
        profile_unet(torch, device)
        print(smi, flush=True)
        return 0

    from srewd_tpu_torch.cli import random_init_
    from srewd_tpu_torch.configs.config import load_commented_json
    from srewd_tpu_torch.models.factory import build_model

    model = build_model(load_commented_json(CONFIG)["model"])
    random_init_(model.unet, 0)
    model.unet.to(device).eval()
    attn_shapes, gn_shapes = main_path_shapes(torch, model, device)
    del model
    emit({"phase": "shapes", "attention": [[kind, n, d, c] for (kind, n, d), c in sorted(attn_shapes.items())],
          "gn_swish": [[list(s), g, sw, c] for (s, g, sw), c in sorted(gn_shapes.items())]})
    kernels = {**compare_attention(torch, attn_shapes, device),
               **compare_gn(torch, gn_shapes, device)}
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(dir=BUILD) as workdir:
        launches_sample, _ = run_slice(torch, workdir)
        compare_slice(torch, device)
        torch.cuda.empty_cache()
        launches = run_train_slice(torch, workdir, device)["launches"]
    compare_train_step(torch, device)

    emit({"kernels": [
        kernel_entry("flash_attention", "cuda", "srewd_tpu_torch/csrc/flash_attention.cu",
                     "srewd_tpu/ops/flash_attention.py:95", kernels["flash_attention"],
                     launches["flash_attention"], launches_sample["flash_attention"]),
        kernel_entry("flash_attention_backward", "cuda",
                     "srewd_tpu_torch/csrc/flash_attention_bwd.cu",
                     "srewd_tpu/ops/flash_attention.py:173",
                     kernels["flash_attention_backward"],
                     launches["flash_attention_backward"]),
        kernel_entry("gn_swish", "cuda", "srewd_tpu_torch/csrc/gn_swish.cu",
                     "srewd_tpu/ops/pallas_fused.py:149", kernels["gn_swish"],
                     launches["gn_swish"], launches_sample["gn_swish"]),
        kernel_entry("gn_swish_backward", "cuda", "srewd_tpu_torch/csrc/gn_swish.cu",
                     "srewd_tpu/ops/pallas_fused.py:211", kernels["gn_swish_backward"],
                     launches["gn_swish_backward"]),
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
