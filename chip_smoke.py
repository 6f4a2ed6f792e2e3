#!/usr/bin/env python3
"""Drive the PyTorch port's sampling, training and pretraining paths of
every residual architecture on one CUDA card and check them.

    python3 chip_smoke.py                  # the smoke run, phases 1-15
    python3 chip_smoke.py --profile        # phases 1-2, then the UNet profile
    python3 chip_smoke.py --train-kernels  # phases 1-2, the shapes, the bf16 step's kernels
    python3 chip_smoke.py --stress N       # phases 1-6, then steps 7 and 10 N times each
    python3 chip_smoke.py --bf16-step N    # phases 1-2, then phase 11's step at N draw seeds
    python3 chip_smoke.py --serve          # phases 1-2, phase 3's shapes, phase 6, phase 13
    python3 chip_smoke.py --ddp            # phases 1-2, phase 6, phase 14
    python3 chip_smoke.py --quality        # phases 1-2, phase 6, phase 15

Phases, one JSON line each (`t_sec`: seconds since the start); any failure
exits non-zero before the result. Every line, and a failure's traceback,
is also written to chiprun_out/chip_smoke.jsonl (chip_smoke_<option>.jsonl
with an option), whole:
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
                one full-width UNet call of phydiff, resdiff, srdiff or
                physrdiff gives it (found by hooks on one call of each
                arch's sampling chain; the `shapes` line says how many shapes
                the other three add to phydiff's, whose call counts weigh
                the totals; a `unet_call` line per arch gives the host ms of
                one UNet call at batch 8, float32 and bfloat16), float32
                (TF32 off) and bfloat16, in the
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
                K1, K2, K3 per step, idle share). The first run's steps
                6-10 are timed as phase 14 times its runs
                (`run_step_host_ms_6_10`).
  7. step     — one loss.backward() of the full-width phydiff model with the
                kernels against one inside reference_ops() (same weights,
                batch, t, gamma and noise, dropout 0, batch 2, float32): loss
                relative difference <= 1e-5, every parameter's gradient
                relative RMSE <= 1e-3 (leaves whose gradient norm is under
                1e-6 of the largest: absolute RMSE against the largest norm).
                Beyond a bound, the line also gives the five worst leaves'
                gradients recomputed in float64 on the plain path and each
                side's distance to them (`float64`), before it fails.
  8. pretrain — `srewd_tpu_torch.pretrain.main` for one epoch of the shipped
                RRDBNet (nf 64, 17 blocks, batch 32, amsgrad) and SimpleCNN
                (batch 128) configs on a 7-day synthetic tree: losses and
                Kelvin metrics finite, the `pretrain_<name>_E0` checkpoint
                reloads into a fresh encoder, RRDB steps/s; no kernel and no
                plain version runs (the encoders are convolutions).
  9. archs    — resdiff (SimpleCNN prediction as condition), srdiff and
                physrdiff (RRDB), each shipped config at full width on phase
                8's encoders: `sample.main` with DPM-25 at batch 8 over 16
                fields, float32 and bfloat16 (physrdiff also over 8 fields
                as a float32 ensemble of 2, which writes sr_std/): fields
                finite, in a
                Kelvin range, K1 and K3 launched exactly (UNet calls) x
                (their calls per UNet call, phase 3) times, no backward
                kernel, no plain version. Then `train.main` of srdiff
                (unlocked RRDB), physrdiff (locked) and resdiff for 5 steps
                at batch 4 with EMA and a resume from step 3 that repeats
                steps 4-5; the first step of train.main's trainer must leave
                a finite gradient on every UNet parameter, nonzero but for
                DEAD_RELU_OK's, and on every encoder parameter when
                unlocked, none when locked (steps/s: 5 more steps on that
                trainer after the run); after it `sample.main -m
                <step-5 checkpoint> --use-ema` (DPM-5) must load the EMA
                (physrdiff, trained with EMA) or warn and take the raw
                weights (srdiff and resdiff, trained without).
                K1, K2, K3 and its backward launched, the plain versions
                never.
 10. compare_archs — full-width physrdiff, batch 2, the same weights,
                cuDNN untimed as the sample CLI meets it: DPM-10
                generate_sr with the kernels against
                `reference_ops()` (relative RMSE of the residual <= 1e-3),
                and one training step with the RRDB unlocked (loss <= 1e-5
                relative, every UNet and encoder gradient <= 1e-3 relative
                RMSE); the kernel sides launch K1 and K3 (and, in the step,
                K2 and the K3 backward) and call no plain version, the
                plain sides launch no kernel.
 11. bf16     — `cli.build_trainer(opt, device, dtype=bfloat16)` on phase 6's
                phydiff config and phase 9's srdiff with its RRDB unlocked,
                batch 4, EMA on: one step, then 5 timed (steps/s beside
                phases 6 and 9's float32 on the same settings); every
                parameter with a finite gradient, every parameter, Adam
                moment and EMA entry float32, the loss finite, K1, K2, K3 and
                its backward launched exactly (calls per UNet call, phase 3)
                per step and no plain version; a DPM-5 bf16 chain through the
                trained model leaves the master weights float32 and equal.
                Then phase 7's step in bf16, kernels against plain: loss
                within 2e-3 relative, every leaf |g_k - g_p| <= 3 max(|g_p -
                g_f32|, one bf16 ulp of g_p) (+1e-6 of the largest leaf),
                relative RMSE over all leaves <= 0.1 (tests/test_torch_port_bf16.py's
                rule against JAX, floored at bf16's resolution; PERF.md), with
                phase 7's float64 diagnostic beyond it.
 12. bench    — `srewd_tpu_torch.bench`'s run (DDIM-50, one timed chain, sr3
                bf16 and phydiff float32) and `bench_train`'s (sr3, batch 16,
                bf16, 10 steps, 0 < MFU < 1; its plain versions run once, on
                the meta device, for the FLOP count), then one more batch-16
                step with every kernel launch repeated and held against its
                plain version (bf16: two ulps); `run_training` of phydiff in
                bf16 for 6 steps with a torch.profiler window on steps 4-6
                under build/profile/ (the trace must show the 3 steps and
                K1, K2, K3 and its backward; busy ms and idle share of the
                window), and for 4 steps with `train.device_data_cache`
                against the same 4 through the prefetcher (losses equal bit
                for bit).
 13. serve    — the serving layer on phase 6's phydiff checkpoint, float32,
                DPM-25, batch 8 (`SamplerService.from_checkpoint`): its HTTP
                front end on localhost takes 24 fields from 7 concurrent
                clients (sizes 5 3 1 4 2 6 3); each device batch must match
                generate_sr of its packed batch (relative RMSE <= 1e-5:
                float32 sums in another order; `bit_identical` says whether
                it is exact), each served field its row (1e-3 K), inside a
                Kelvin range; K1 and K3 launched (device batches) x 25 x
                (their calls per UNet call), no plain version. Then
                `python -m srewd_tpu_torch.export_sampler` of the same
                checkpoint on the card (`export_sec`): the step program
                must hold one srewd::flash_attention and srewd::gn_swish
                node per K1 and K3 call of an eager UNet call, the
                conditioning program none; the artifact loaded in a fresh
                process at batch 3 and 8 must be within 1e-4 relative RMSE
                of generate_sr at the same seed (the residual, normalized),
                launch K1 and K3 25 x (calls per UNet call) times a call and
                import no model code. `op_dispatch`: host µs of one K1 and
                K3 call through the wrapper and through the custom op.
                Last, `python -m srewd_tpu_torch.bench_serve` at its
                full-width defaults (sr3, bf16, DPM-25, 108 fields), its
                JSON line passed through.
 14. ddp      — data parallelism. (a) `python -m torch.distributed.run
                --standalone --nproc_per_node=1` of `srewd_tpu_torch.train`'s
                main (wrapped by this script's `--worker train-main`, which
                reads the rank's own launch counters) on phase 6's config
                for 10 steps: the process group NCCL at world size 1, the
                loss under DistributedDataParallel, K1, K2, K3 and its
                backward launched in the rank and no plain version, the
                first loss within 1e-6 relative of phase 6's and the first
                10 within 1e-4 (a fresh process: cuDNN may time other
                algorithms). The rank first runs the same train.main with
                torchrun's WORLD_SIZE hidden (no process group, no DDP),
                where cuDNN times its algorithms; the host ms per step of
                steps 6-10 of each run, between two synchronisations, give
                DDP's cost at world size 1 (`ddp_overhead_ms`; phase 6's
                first run timed the same way beside them). (b) two ranks on
                the one card over gloo (NCCL refuses two ranks on one
                device; `--worker gloo-step`: started before (a), they read
                their data and wait for it to end; cuDNN's heuristic
                algorithms), phase 6's config at local
                batch 2 (dropout 0.2) for 5 steps, against this process at
                batch 4 on the same global batches and seed: the first
                step's reduced gradients by phase 7's rule (1e-3 relative
                RMSE per leaf, its float64 diagnostic beyond it), the 5
                losses within 1e-4 relative, both ranks' parameters bit for
                bit (SHA-256), and one gathered validation batch (DDIM-10)
                on the ranks' final weights against this process's on the
                same weights: the fields within 1e-4 relative RMSE, each
                Kelvin metric within 1e-4 relative. Its step time is a
                correctness run's, not a scaling number: gloo reduces
                through the host.
 15. quality  — the evaluation path on phase 6's checkpoint. (a) the
                checkpoint in the reference's `_gen.pth` layout
                (`denoise_fn.` + the UNet, the train schedule's twelve
                buffers) through `convert_torch_checkpoint.main` on the card:
                the UNet bit for bit, counters (20, epoch), a fresh Adam
                state. (b) `quality_e2e.main` in this process at full width
                (phydiff, 128x256) on a 7-day tree: 40 steps at batch 4
                (phase 6's shapes, whose cuDNN algorithms are timed), EMA 0.9
                from step 20, then the bicubic row and DDIM-50 and DPM-25
                rows, noclip and noclip-ema, on one val batch of 4: losses
                finite; K1, K2, K3 and its backward launched in the training,
                K1 and K3 exactly (UNet calls) x (their calls per UNet call,
                phase 3) in each row, no plain version; every row label with
                finite metrics; the bicubic row within 1e-5 relative of the
                same bicubic_metrics on the CPU; the dpm-25-noclip row again
                inside `reference_ops()` on the same weights and noise: the
                residual fields (SR minus bicubic) within 1e-3 relative RMSE,
                each Kelvin metric within 1e-3 relative (MR, a signed mean
                near 0 K, relative to max(|MR|, RMSE)). (c) `quality_e2e.main
                --reuse-checkpoint` of (a)'s converted checkpoint and of phase
                6's own, DPM-25 noclip: the fields bit for bit, the metrics
                equal.
  --profile — instead of 3-15: per dtype, one full-width UNet call by host
                clock and by torch.profiler's device time per kernel, the card's
                idle share, and one DDIM-50 generate_sr (see profile_unet).
  --train-kernels — instead of 3-15: per batch 4 and 16, bf16, K1 with its
                row LSE, K2, K3 with its statistics and K3's backward per
                phydiff training step, with plain and library times and the
                bound (see train_kernel_table); then a bf16 and a float32
                phydiff step profiled (profile_train_steps).
  --stress N — instead of 7-15, after phases 1-6 as in the smoke run:
                phase 7's and phase 10's training steps N times each with
                the cuDNN settings phase 6 leaves, every kernel
                launch repeated (bit-identical) and held against its plain
                version call by call, odd repeats in NaN-poisoned memory
                (see stress_step).
  --serve — phases 1-2, phase 3's shapes and `unet_call` lines, phase 6,
                then phase 13 (no kernels line).
  --ddp — phases 1-2, phase 6, then phase 14 (no kernels line).
  --quality — phases 1-2, phydiff's calls per UNet call (phase 3's hooks),
                phase 6, then phase 15 (no kernels line).
  --bf16-step N — instead of 3-15: phase 11's bf16 step, kernels against
                plain under the same bound, at draw seeds 3 .. N+2 (phase 11
                takes seed 3), with the cuDNN settings phase 11 meets.
Then the kernels' summary line, the card's name and power limit, and the
result line. In the summary line, `launches` counts the kernel's launches in
the main-path runs, each counted from 0: phase 4, the first run of phase 6,
phases 8, 9, 11, 12, 13, 14 and 15 (phase 13's loaded artifact and phase 14's
ranks counted in their own processes; `launches_by_phase` splits them; the
launches that
hold a kernel against its plain version are not among them); `ms`, `plain_ms`,
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

import contextlib
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
CONFIGS = os.path.join(REPO, "configs", "experiment_configs")
# the shipped sampling config of each residual architecture (phases 3 and 9)
ARCH_CONFIGS = {
    "phydiff": CONFIG,
    "resdiff": os.path.join(CONFIGS, "resdiff", "resdiff_pretrained_cnn.json"),
    "srdiff": os.path.join(CONFIGS, "srdiff", "srdiff+rrdb_locked.json"),
    "physrdiff": os.path.join(CONFIGS, "physrdiff", "physrdiff+rrdb_locked.json"),
}
# phase 9's training configs (srdiff's encoder unlocked)
ARCH_TRAIN_CONFIGS = {
    "srdiff": os.path.join(CONFIGS, "srdiff", "srdiff+rrdb_unlocked.json"),
    "physrdiff": ARCH_CONFIGS["physrdiff"],
    "resdiff": ARCH_CONFIGS["resdiff"],
}
# phase 8's encoder pretraining configs, by their checkpoints' names
PRETRAIN_CONFIGS = {
    "rrdb": os.path.join(CONFIGS, "rrdb", "pretrained_rrdb_17block_base.json"),
    "cnn": os.path.join(CONFIGS, "simplesr", "pretrained_cnn_base.json"),
}
ENCODER_OF = {"resdiff": "cnn", "srdiff": "rrdb", "physrdiff": "rrdb"}
BATCH = 8
LR_HW = (32, 64)  # the synthetic tree's LR fields; HR is 4x
ARCH_FIELDS = 16  # phase 9: two batches of 8, so a steady rate exists (ensemble: one)
DPM_STEPS = 25
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


T0 = time.perf_counter()
# every line the run prints, also kept whole in chiprun_out/chip_smoke.jsonl
# (opened once a card is found): a remote runner may return only the end of
# the output, and a failing run's phase lines are what tells its cause
KEEP = {"file": None}


def keep(line: str) -> None:
    if KEEP["file"] is not None:
        KEEP["file"].write(line + "\n")
        KEEP["file"].flush()


def say(line: str) -> None:
    print(line, flush=True)
    keep(line)


def emit(obj: dict) -> None:
    """One JSON line, with the seconds since the script started (t_sec)."""
    say(json.dumps({**obj, "t_sec": round(time.perf_counter() - T0, 1)}))


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
    """(attention (kind, N, D) -> calls, GN (shape, swish) -> calls) of one
    UNet call of a sampling chain (found by hooks; the encoder and the
    chain-constant conditioning run no kernel)."""
    from collections import Counter

    from srewd_tpu_torch.models.blocks import CrossAttention, FusedGroupNorm, SelfAttention

    attn, gn = Counter(), Counter()
    lr = torch.randn(BATCH, *LR_HW, 1, device=device)
    cond, denoise_fn = model.denoiser({"LR": lr})
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
    with torch.no_grad():
        denoise_fn(torch.randn_like(cond), torch.rand(BATCH, device=device))
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    return attn, gn


def full_width_model(torch, arch, device, dropout=None):
    """The shipped config's model of `arch` at full width, made on the card
    with seeded random weights (encoder included)."""
    from srewd_tpu_torch.cli import random_init_
    from srewd_tpu_torch.configs.config import load_commented_json
    from srewd_tpu_torch.models.factory import build_model

    model_cfg = load_commented_json(ARCH_CONFIGS[arch])["model"]
    if dropout is not None:
        model_cfg["unet"]["dropout"] = dropout
    with torch.device(device):
        model = build_model(model_cfg)
    random_init_(model.unet, 0)
    if model.encoder is not None:
        random_init_(model.encoder, 1)
    return model


def unet_call_ms(torch, model, device) -> float:
    """Host-clock ms of one UNet call of a sampling chain at batch 8: 10 calls
    between two synchronisations, after 2 warm-up calls."""
    g = torch.Generator(device=device).manual_seed(1)
    lr = torch.randn(BATCH, *LR_HW, 1, device=device, generator=g)
    cond, denoise_fn = model.denoiser({"LR": lr})
    x = torch.randn(cond.shape, device=device, generator=g)
    lvl = torch.rand(BATCH, device=device, generator=g)
    with torch.no_grad():
        for _ in range(2):
            denoise_fn(x, lvl)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            denoise_fn(x, lvl)
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / 10 * 1e3


def arch_shapes(torch, device) -> tuple:
    """Phase 3's shape set: the union of the four residual architectures'
    main-path shapes, with phydiff's call counts (the other archs' counts
    where a shape is theirs alone); per arch its counts and the ms of one
    full-width UNet call, float32 and bfloat16."""
    from collections import Counter

    attn, gn = Counter(), Counter()
    per_arch = {}
    for arch in ("phydiff", "resdiff", "srdiff", "physrdiff"):
        model = full_width_model(torch, arch, device)
        a, n = main_path_shapes(torch, model, device)
        f32_ms = unet_call_ms(torch, model, device)
        # the compute dtype build_model(dtype=bfloat16) sets: the next chain
        # casts the UNet's weights once into its shadow, the encoder per call
        for m in (model.unet, model.encoder):
            if m is not None:
                m.dtype = torch.bfloat16
        bf16_ms = unet_call_ms(torch, model, device)
        del model
        torch.cuda.empty_cache()
        added = [k for k in list(a) + list(n) if k not in attn and k not in gn]
        for k, c in a.items():
            attn[k] = attn.get(k) or c
        for k, c in n.items():
            gn[k] = gn.get(k) or c
        per_arch[arch] = {"attention_calls": sum(a.values()), "gn_calls": sum(n.values()),
                          "cross_attention_calls": sum(c for (kind, *_), c in a.items()
                                                       if kind == "cross"),
                          "unet_call_ms_f32": f32_ms, "unet_call_ms_bf16": bf16_ms,
                          "shapes_added": [list(map(str, k)) for k in added]
                          if arch != "phydiff" else None}
        emit({"phase": "unet_call", "arch": arch, "batch": BATCH, **per_arch[arch]})
    return attn, gn, per_arch


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

            # K2 at the training batch, with the forward's row log-sum-exp and
            # float32 O
            q, k, v = attention_inputs(torch, kind, TRAIN_BATCH, n, d, dtype, device, g)
            do = torch.randn(TRAIN_BATCH, n, d, device=device, generator=g).to(dtype)
            o_plain_fwd = flash_attention(q, k, v, scale)
            o, lse, o32 = flash_attention(q, k, v, scale, return_lse=True)
            s = torch.einsum("bid,bjd->bij", q.float(), k.float()) * scale
            lse_err = (lse - torch.logsumexp(s, dim=-1)).abs().max().item()
            del s
            same_o = bool(torch.equal(o, o_plain_fwd)) and bool(torch.equal(o32.to(dtype), o))
            dq, dk, dv = flash_attention_backward(q, k, v, o32, lse, do, scale)
            again = flash_attention_backward(q, k, v, o32, lse, do, scale)
            torch.cuda.synchronize()
            same_grads = all(bool(torch.equal(a, b)) for a, b in zip((dq, dk, dv), again))
            refs = attention_backward_reference(q, k, v, do, scale)
            errs = [(a.float() - r.float()).abs().max().item() for a, r in zip((dq, dk, dv), refs)]
            tols = [tolerance(torch, r, dtype, f32_rel=1e-4) for r in refs]
            del refs, dq, dk, dv, again
            ms2 = cuda_ms(torch, lambda: flash_attention_backward(q, k, v, o32, lse, do, scale),
                          10)
            plain_ms2 = cuda_ms(
                torch, lambda: attention_backward_reference(q, k, v, do, scale), 5)
            ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
            lib_out = F.scaled_dot_product_attention(ql, kl, vl, scale=scale)
            lib_ms2 = cuda_ms(torch, lambda: torch.autograd.grad(
                lib_out, (ql, kl, vl), do, retain_graph=True), 5)
            del lib_out, ql, kl, vl
            work2 = (10.0 * TRAIN_BATCH * n * n * d,  # O read in float32
                     (7.0 * isz + 4.0) * TRAIN_BATCH * n * d + 4.0 * TRAIN_BATCH * n)
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
            check(same_o, f"K1 with the LSE output changed O, or its float32 O does not round "
                          f"to it ({kind} N={n} D={d} {name})")
            check(lse_err <= 1e-4 * max(1.0, lse.abs().max().item()),
                  f"K1's LSE is off by {lse_err} ({kind} N={n} D={d} {name})")
            k2[f"{name}_err"] = max(k2[f"{name}_err"], *errs)
            if f32:
                _add(k2, calls, ms2, plain_ms2, lib_ms2, b2, b2_cc)
            del q, k, v, do, o, lse, o32, o_plain_fwd
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

    out_dir = os.path.join(BUILD, "profile")
    os.makedirs(out_dir, exist_ok=True)
    opt = load_commented_json(CONFIG)
    sched = Schedule.from_config(opt["model"]["beta_schedule"]["val"], device=device)
    g = torch.Generator(device=device).manual_seed(1)
    lr = torch.randn(BATCH, 32, 64, 1, device=device, generator=g)
    for dtype in (torch.float32, torch.bfloat16):
        name = "f32" if dtype == torch.float32 else "bf16"
        with torch.device(device):
            model = build_model(opt["model"], dtype=dtype)
        random_init_(model.unet, 0)
        cond, denoise_fn = model.denoiser({"LR": lr})  # the chain's UNet call
        x = torch.randn(cond.shape, device=device, generator=g)
        lvl = torch.rand(BATCH, device=device, generator=g)

        @torch.no_grad()
        def call():
            denoise_fn(x, lvl)

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
    with _timed_steps(torch) as timing:  # phase 14(a) times its run so
        first = train.main(["-c", cfg_path, "--device", str(device)])
    sec = time.perf_counter() - t0
    launches, plain_calls = read_counts()
    ckpts = glob.glob(os.path.join(workdir, "experiments", "*", "checkpoint", "I10_E*"))
    check(len(ckpts) == 1, f"expected one step-10 checkpoint, found {ckpts}")
    final = glob.glob(os.path.join(os.path.dirname(ckpts[0]), "I20_E*"))
    check(len(final) == 1, f"expected one step-20 checkpoint, found {final}")
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
          "steps_per_sec_run": first["steps_per_sec"],
          "run_step_host_ms_6_10": timing["step_host_ms"], "launches": launches,
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
    return {"launches": launches, "step": step, "config": cfg_path, "checkpoint": final[0],
            "losses": [losses[s] for s in sorted(losses)],
            "run_step_host_ms_6_10": timing["step_host_ms"]}


def _step_grads(torch, model, batch, sched, draws) -> tuple:
    """(loss, {name: gradient}) of one loss.backward(); the encoder's
    gradients (when it is unlocked) under "encoder." names."""
    modules = {"": model.unet}
    if model.encoder is not None and not model.lock_encoder:
        modules["encoder."] = model.encoder
    for m in modules.values():
        m.zero_grad(set_to_none=True)
    loss = model.loss(batch, sched, **draws)
    loss.backward()
    torch.cuda.synchronize()
    return loss.item(), {pre + n: p.grad.detach().clone()
                         for pre, m in modules.items() for n, p in m.named_parameters()}


def _grad_report(grads_k, grads_p) -> dict:
    """The worst gradient relative RMSE, kernels against plain (leaves whose
    plain gradient norm is under 1e-6 of the largest: absolute RMSE against
    the largest norm); the five worst leaves beside it."""
    largest = max(gp.double().norm().item() for gp in grads_p.values())
    errs, n_small = {}, 0
    for name, gp in grads_p.items():
        gk, gp = grads_k[name].double(), gp.double()
        if gp.norm().item() < 1e-6 * largest:
            n_small += 1
            errs[name] = (gk - gp).norm().item() / largest
        else:
            errs[name] = ((gk - gp).pow(2).mean() / gp.pow(2).mean()).sqrt().item()
    top = sorted(errs.items(), key=lambda kv: -kv[1])[:5]
    return {"grad_leaves": len(grads_p), "small_leaves": n_small,
            "worst_grad_rel_rmse": top[0][1], "worst_leaf": top[0][0],
            "worst_leaves": [[k, v] for k, v in top]}


def _float64_check(torch, model, batch, sched, draws, leaves, sides: dict,
                   dropout_seed=None) -> dict:
    """When a step breaks its bound: `leaves`' gradients recomputed in float64
    on the plain path (a float64 copy of the model: the same weights, batch,
    t, gamma and noise; the bicubic condition and the stencils stay float32,
    the spliter's FFT complex64; with `dropout_seed`, the card's default
    generator seeded with it first, so Dropout's float32 uniforms drop what
    the step dropped), and each side's relative RMSE to that answer per
    leaf: the side far from it is the wrong one."""
    import copy

    from srewd_tpu_torch.ops import reference_ops

    for part in (model.unet, model.encoder):
        if part is not None:
            part.zero_grad(set_to_none=True)
    m64 = copy.deepcopy(model)
    for part in (m64.unet, m64.encoder):
        if part is not None:
            part.double()
            part.dtype = torch.float64
    b64 = {k: v.double() for k, v in batch.items()}
    d64 = {**draws, "u": draws["u"].double(), "noise": draws["noise"].double()}
    if dropout_seed is not None:
        from srewd_tpu_torch.training.trainer import _seed_default_generator

        _seed_default_generator(batch["HR"].device, dropout_seed)
    with reference_ops():
        loss64, g64 = _step_grads(torch, m64, b64, sched, d64)
    del m64
    out = {"loss": loss64, "leaves": {}}
    for leaf in leaves:
        ref = g64[leaf]
        out["leaves"][leaf] = {side: rel_rmse(g[leaf], ref) for side, g in sides.items()}
    del g64
    torch.cuda.empty_cache()
    return out


def _step_draws(torch, model_cfg, device, seed) -> tuple:
    h, w = (int(model_cfg["diffusion"][k]) for k in ("image_height", "image_width"))
    g = torch.Generator(device=device).manual_seed(seed)
    batch = {"HR": torch.randn(2, h, w, 1, device=device, generator=g),
             "LR": torch.randn(2, h // 4, w // 4, 1, device=device, generator=g)}
    draws = {"t": torch.tensor([500], device=device),
             "u": torch.rand(2, device=device, generator=g),
             "noise": torch.randn(2, h, w, 1, device=device, generator=g)}
    return batch, draws


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
    batch, draws = _step_draws(torch, model_cfg, device, 3)
    loss_k, grads_k = _step_grads(torch, model, batch, sched, draws)
    with reference_ops():
        loss_p, grads_p = _step_grads(torch, model, batch, sched, draws)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    rep = _grad_report(grads_k, grads_p)
    over = loss_rel > 1e-5 or rep["worst_grad_rel_rmse"] > 1e-3
    emit({"phase": "step", "batch": 2, "dtype": "f32", "loss_kernels": loss_k,
          "loss_plain": loss_p, "loss_rel_diff": loss_rel, **rep,
          "bounds": {"loss": 1e-5, "grad": 1e-3},
          "float64": _float64_check(torch, model, batch, sched, draws,
                                    [k for k, _ in rep["worst_leaves"]],
                                    {"kernels": grads_k, "plain": grads_p}) if over else None})
    check(loss_rel <= 1e-5, f"whole-step loss differs by {loss_rel} (relative)")
    check(rep["worst_grad_rel_rmse"] <= 1e-3,
          f"gradient of {rep['worst_leaf']} differs by {rep['worst_grad_rel_rmse']} "
          "(relative RMSE)")
    del model
    torch.cuda.empty_cache()


def arch_data_settings(workdir) -> dict:
    """Phases 8-9's synthetic 128x256 / 32x64 t2m tree, 7 days (made once):
    6 to train on (144 fields: 4 RRDB batches of 32, one SimpleCNN batch of
    128), the 7th to evaluate and sample."""
    from srewd_tpu_torch.data.store import make_synthetic_weatherbench

    data = os.path.join(workdir, "data_archs")
    make_synthetic_weatherbench(data, "2017-01-01-00", "2017-01-08-00", spectrum="t2m")
    return dict(dataroot=data, train_min_date="2017-01-01-00", train_max_date="2017-01-07-00",
                val_min_date="2017-01-07-00", val_max_date="2017-01-08-00",
                months_subset=[1], transform_groups={"january": [1]}, num_workers=8)


def _write_config(workdir, name, cfg) -> str:
    path = os.path.join(workdir, f"{name}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def run_pretrain(torch, workdir, device) -> dict:
    """Phase 8: `python -m srewd_tpu_torch.pretrain` (its main) for one epoch
    of each shipped encoder config at full width; each checkpoint must
    reload into a fresh encoder that gives finite fields."""
    from srewd_tpu_torch import pretrain
    from srewd_tpu_torch.configs.config import load_commented_json
    from srewd_tpu_torch.training.pretrainer import (
        EncoderTrainer, get_encoder_and_criterion, load_encoder_params)

    ckpts = {}
    reset_counts()
    for name, src in PRETRAIN_CONFIGS.items():
        cfg = load_commented_json(src)
        cfg["data"].update(arch_data_settings(workdir))
        cfg["train"]["epoch"] = 1
        cfg["path"]["experiments_folder_path"] = workdir
        path = _write_config(workdir, f"pretrain_{name}", cfg)
        t0 = time.perf_counter()
        with _tap(torch, EncoderTrainer, "train_step") as tap:
            (rec,) = pretrain.main(["-c", path, "--device", str(device)])
        sec = time.perf_counter() - t0
        # steps/s on the trainer pretrain.main built, on the batches it took
        speed = (_steps_per_sec(torch, tap["obj"].train_step, tap["calls"])
                 if name == "rrdb" else None)
        del tap
        module, _ = get_encoder_and_criterion(cfg["model"])
        module.load_state_dict(load_encoder_params(rec["checkpoint"]), strict=True)
        module.to(device)
        with torch.no_grad():
            y = module(torch.randn(2, *LR_HW, 1, device=device))
        reloaded = bool(torch.isfinite(y).all()) and y.shape[1:3] == (4 * LR_HW[0], 4 * LR_HW[1])
        emit({"phase": "pretrain", "encoder": name, "config": os.path.relpath(src, REPO),
              "batch": int(cfg["data"]["batch_size"]), "steps": rec["steps"],
              "train_loss": rec["train_loss"], "val_kelvin": rec["val"],
              "checkpoint": os.path.basename(rec["checkpoint"]), "reloaded": reloaded,
              "sec_epoch": sec, "train_sec": rec["train_sec"], "speed": speed})
        check(rec["steps"] > 0 and math.isfinite(rec["train_loss"]),
              f"{name} pretraining: {rec['steps']} steps, loss {rec['train_loss']}")
        check(all(math.isfinite(v) for v in rec["val"].values()),
              f"{name} pretraining: validation metrics not finite: {rec['val']}")
        check(os.path.basename(rec["checkpoint"]) == f"pretrain_{name}_E0",
              f"unexpected checkpoint {rec['checkpoint']}")
        check(reloaded, f"the {name} checkpoint did not reload into a working encoder")
        ckpts[name] = rec["checkpoint"]
        del module
    launches, plain = read_counts()
    check(sum(plain.values()) == 0, f"a plain version ran during pretraining: {plain}")
    return {"checkpoints": ckpts, "launches": launches}


def _sample_defaults(torch) -> None:
    """cuDNN as the sample CLI meets it (heuristic algorithms), not as the
    training runs before leave it."""
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = False


def _check_fields(out, n, std=False) -> dict:
    import numpy as np

    sub = "sr_std" if std else "sr"
    files = sorted(os.listdir(os.path.join(out, sub)))
    fields = [np.load(os.path.join(out, sub, f)) for f in files]
    finite = all(bool(np.all(np.isfinite(a))) for a in fields)
    lo = min(float(a.min()) for a in fields)
    hi = max(float(a.max()) for a in fields)
    check(len(files) == n, f"expected {n} files in {sub}/, got {len(files)}")
    check(all(a.shape == (128, 256, 1) for a in fields), f"{sub}/ field shape is not 128x256x1")
    check(finite, f"non-finite values in {sub}/")
    if std:
        check(lo >= 0.0 and hi > 0.0, f"ensemble std out of range: [{lo}, {hi}]")
    else:
        check(180.0 < lo and hi < 360.0, f"fields outside a plausible Kelvin range: [{lo}, {hi}]")
    return {"min": lo, "max": hi}


def sample_arch(torch, workdir, arch, cfg_path, tag, extra, per_arch, fields) -> dict:
    """One `srewd_tpu_torch.sample.main` run of phase 9 with its checks: the
    fields, and K1 and K3 launched exactly (UNet calls) x (their calls per
    UNet call) times, the plain versions and the backward kernels never."""
    from srewd_tpu_torch import sample

    out = os.path.join(workdir, f"out_{arch}_{tag}")
    _sample_defaults(torch)
    reset_counts()
    t0 = time.perf_counter()
    summary = sample.main(["-c", cfg_path, "--date-range", "2017-01-07-00",
                           f"2017-01-07-{fields:02d}", "--batch-size", str(BATCH), "--save-npy",
                           "-o", out, "--device", "cuda", *extra])
    sec = time.perf_counter() - t0
    launches, plain = read_counts()
    n_ens = summary["ensemble"]
    steps = int(extra[extra.index("--ddim-steps") + 1])
    unet_calls = steps * (fields // BATCH) * n_ens
    kelvin = _check_fields(out, fields)
    std = _check_fields(out, fields, std=True) if n_ens > 1 else None
    line = {"phase": "archs_sample", "arch": arch, "run": tag, "sec": sec, "summary": summary,
            "unet_calls": unet_calls, "launches": launches, "plain_calls": plain,
            "kelvin": kelvin, "ensemble_std_kelvin": std}
    emit(line)
    check(launches["flash_attention"] == unet_calls * per_arch[arch]["attention_calls"],
          f"{arch} {tag}: K1 launched {launches['flash_attention']} times for {unet_calls} "
          f"UNet calls of {per_arch[arch]['attention_calls']} attention calls")
    check(launches["gn_swish"] == unet_calls * per_arch[arch]["gn_calls"],
          f"{arch} {tag}: K3 launched {launches['gn_swish']} times for {unet_calls} "
          f"UNet calls of {per_arch[arch]['gn_calls']} GN calls")
    check(launches["flash_attention_backward"] == 0 and launches["gn_swish_backward"] == 0,
          f"{arch} {tag}: a backward kernel ran while sampling: {launches}")
    check(sum(plain.values()) == 0, f"{arch} {tag}: the plain versions ran: {plain}")
    return line


# The spliter's noise gate at one image channel: a ResSE with a single hidden
# unit behind a ReLU, whose input (the mean of the noise embedding's map) has
# one sign for a whole batch, since the batch shares one gamma. When that
# unit is off, both weights' gradients are exactly zero (the JAX model's as
# well: tests/test_torch_port_archs.py holds every gradient leaf to it).
DEAD_RELU_OK = ("fd_spliter.noise_resSE.fc.",)


@contextlib.contextmanager
def _tap(torch, cls, method: str, on_first=None):
    """While open, the first object of class `cls` whose `method` runs (the
    trainer an entry point builds) is kept in the yielded dict ("obj"), with
    the arguments of each of its calls ("calls") and the time of its first
    call ("first_call_sec", to a synchronise; cuDNN times its algorithms
    there); `on_first(obj)` runs right after that call ("first")."""
    orig = getattr(cls, method)
    seen = {"obj": None, "calls": []}

    def call(self, *args):
        first = seen["obj"] is None
        if first:
            seen["obj"] = self
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        out = orig(self, *args)
        if first:
            torch.cuda.synchronize()
            seen["first_call_sec"] = time.perf_counter() - t0
            if on_first is not None:
                seen["first"] = on_first(self)
        if self is seen["obj"]:
            seen["calls"].append(args)
        return out

    setattr(cls, method, call)
    try:
        yield seen
    finally:
        setattr(cls, method, orig)


def _check_grads(torch, model) -> dict:
    """After a training step: every UNet parameter has a finite gradient,
    not all zero but for DEAD_RELU_OK's; every encoder parameter too when
    the encoder is unlocked, and none when it is locked (or absent)."""
    def bad(module):
        return [n for n, p in module.named_parameters() if p.grad is None
                or not bool(torch.isfinite(p.grad).all())
                or not (bool(p.grad.any()) or n.startswith(DEAD_RELU_OK))]

    bad_unet = bad(model.unet)
    zero_ok = [n for n, p in model.unet.named_parameters()
               if n.startswith(DEAD_RELU_OK) and not bool(p.grad.any())]
    enc = model.encoder
    n_enc = 0 if enc is None else sum(1 for _ in enc.parameters())
    if enc is None:
        bad_enc = []
    elif model.lock_encoder:
        bad_enc = [n for n, p in enc.named_parameters() if p.grad is not None]
    else:
        bad_enc = bad(enc)
    check(not bad_unet, f"{len(bad_unet)} UNet parameters got no finite nonzero gradient: "
                        f"{bad_unet[:8]}")
    check(not bad_enc, f"{len(bad_enc)} of {n_enc} encoder parameters break the "
                       f"{'locked' if model.lock_encoder else 'unlocked'} rule: {bad_enc[:8]}")
    return {"params_with_grad": sum(1 for _ in model.unet.parameters()),
            "zero_grads_behind_a_dead_relu": zero_ok, "encoder_params": n_enc,
            "encoder_locked": model.lock_encoder,
            "encoder_params_with_grad": 0 if model.lock_encoder else n_enc}


def _steps_per_sec(torch, step, calls) -> dict:
    """Steps/s of `step`: 5 calls between two synchronisations (host clock),
    on the arguments of `calls` in turn."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(5):
        step(*calls[i % len(calls)])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / 5 * 1e3
    return {"step_host_ms": ms, "steps_per_sec": 1e3 / ms}


def train_arch(torch, workdir, arch, ckpt, device) -> dict:
    """Phase 9's training of one arch: train.main for 5 steps at batch 4
    with a checkpoint at step 3 (its trainer's gradients checked after the
    first step, and 5 more steps timed on it after the run), a resume from
    the checkpoint to step 5 that must repeat steps 4-5, and a DPM-5 sample
    from the step-5 checkpoint with its EMA weights."""
    import glob

    from srewd_tpu_torch import sample, train
    from srewd_tpu_torch.configs.config import load_commented_json

    cfg = load_commented_json(ARCH_TRAIN_CONFIGS[arch])
    cfg["data"].update(arch_data_settings(workdir), batch_size=TRAIN_BATCH,
                       val_batch_size=BATCH)
    cfg["model"]["pretrained_model"]["model_path"] = ckpt
    cfg["path"]["experiments_folder_path"] = os.path.join(workdir, f"train_{arch}")
    cfg["train"].update(n_iter=5, print_freq=1, save_checkpoint_freq=3, val_freq=1000,
                        full_val_freq=1000)
    # EMA on physrdiff; the other two sample their checkpoint with --use-ema
    # and no EMA state, which warns and takes the raw weights
    ema = arch == "physrdiff"
    cfg["train"]["ema_scheduler"].update(enabled=ema, step_start_ema=0)
    cfg_path = _write_config(workdir, f"train_{arch}", cfg)

    from srewd_tpu_torch.training.trainer import DiffusionTrainer

    reset_counts()
    t0 = time.perf_counter()
    with _tap(torch, DiffusionTrainer, "train_on_batch_async",
              lambda trainer: _check_grads(torch, trainer.model)) as tap:
        first = train.main(["-c", cfg_path, "--device", str(device)])
    sec = {"train_main": time.perf_counter() - t0}
    launches, plain = read_counts()
    check("first" in tap, f"{arch}: train.main took no step")
    # steps/s on the trainer train.main built, after its 5 steps and save
    reset_counts()
    speed = _steps_per_sec(torch, tap["obj"].train_on_batch_async, tap["calls"])
    per_step, _ = read_counts()
    step = {**tap["first"], "first_step_sec": tap["first_call_sec"], **speed,
            "launches_per_step": {k: v / 5 for k, v in per_step.items()}}
    del tap
    torch.cuda.empty_cache()
    runs = glob.glob(os.path.join(workdir, f"train_{arch}", "experiments", "*", "checkpoint"))
    check(len(runs) == 1, f"{arch}: expected one training run, found {runs}")
    cfg["path"]["resume_state"] = os.path.join(runs[0], "I3_E1")
    resume_path = _write_config(workdir, f"train_{arch}_resume", cfg)
    reset_counts()
    t0 = time.perf_counter()
    second = train.main(["-c", resume_path, "--device", str(device)])
    sec["resume"] = time.perf_counter() - t0
    launches_resume, plain_resume = read_counts()
    losses, resumed = dict(first["losses"]), dict(second["losses"])
    rel = max(abs(resumed[s] - losses[s]) / max(abs(losses[s]), 1e-30) for s in resumed)

    out = os.path.join(workdir, f"out_{arch}_ema")
    _sample_defaults(torch)
    reset_counts()
    t0 = time.perf_counter()
    summary = sample.main(["-c", cfg_path, "-m", os.path.join(runs[0], "I5_E1"), "--use-ema",
                           "--sampler", "dpm", "--ddim-steps", "5", "--date-range",
                           "2017-01-07-00", "2017-01-07-08", "--batch-size", str(BATCH),
                           "--save-npy", "-o", out, "--device", "cuda"])
    sec["ema_sample"] = time.perf_counter() - t0
    launches_sample, plain_sample = read_counts()
    fields = _check_fields(out, BATCH)
    emit({"phase": "archs_train", "arch": arch, "batch": TRAIN_BATCH, "dtype": "f32",
          "step": step, "sec": sec, "losses": [losses[s] for s in sorted(losses)],
          "launches": launches, "plain_calls": plain, "resumed_steps": sorted(resumed),
          "resume_max_rel_diff": rel, "launches_resume": launches_resume,
          "ema_sample": {"summary": summary, "kelvin": fields, "launches": launches_sample}})
    check(sorted(losses) == [1, 2, 3, 4, 5], f"{arch}: steps logged {sorted(losses)}")
    check(all(math.isfinite(v) for v in losses.values()), f"{arch}: a loss is not finite")
    check(all(launches[k] > 0 for k in launches), f"{arch}: a kernel was not launched: {launches}")
    check(sum(plain.values()) + sum(plain_resume.values()) + sum(plain_sample.values()) == 0,
          f"{arch}: the plain versions ran: {plain} {plain_resume} {plain_sample}")
    check(sorted(resumed) == [4, 5], f"{arch}: resumed steps {sorted(resumed)}")
    check(rel <= 1e-6, f"{arch}: resumed losses differ by {rel} (relative)")
    check(summary["ema"] == ema, f"{arch}: the sample run's EMA use is {summary['ema']}, "
                                 f"the checkpoint's EMA state {ema}")
    check(launches_sample["flash_attention"] > 0 and launches_sample["gn_swish"] > 0,
          f"{arch}: K1/K3 not launched sampling the checkpoint: {launches_sample}")
    return {"launches": launches, "launches_resume": launches_resume,
            "launches_sample": launches_sample, "steps_per_sec": step["steps_per_sec"]}


def run_archs(torch, workdir, device, ckpts, per_arch) -> dict:
    """Phase 9: the three new architectures through the port's entry points
    at full width on the phase-8 encoders: DPM-25 sampling in float32 and
    bfloat16 (physrdiff also as an ensemble of 2), then training."""
    from collections import Counter

    from srewd_tpu_torch.configs.config import load_commented_json

    total = Counter()
    for arch in ("resdiff", "srdiff", "physrdiff"):
        cfg = load_commented_json(ARCH_CONFIGS[arch])
        cfg["data"].update(arch_data_settings(workdir))
        cfg["model"]["pretrained_model"]["model_path"] = ckpts[ENCODER_OF[arch]]
        cfg_path = _write_config(workdir, f"sample_{arch}", cfg)
        runs = [("f32", [], ARCH_FIELDS), ("bf16", ["--dtype", "bfloat16"], ARCH_FIELDS)]
        if arch == "physrdiff":
            runs.append(("f32_ensemble2", ["--ensemble", "2"], BATCH))
        for tag, extra, fields in runs:
            line = sample_arch(torch, workdir, arch, cfg_path, tag,
                               ["--sampler", "dpm", "--ddim-steps", str(DPM_STEPS), *extra],
                               per_arch, fields)
            total.update(line["launches"])
    speeds = {}
    for arch in ("srdiff", "physrdiff", "resdiff"):
        res = train_arch(torch, workdir, arch, ckpts[ENCODER_OF[arch]], device)
        for key in ("launches", "launches_resume", "launches_sample"):
            total.update(res[key])
        speeds[arch] = res["steps_per_sec"]
    return dict(total), speeds


def _side(torch, fn, plain: bool, uses: tuple) -> tuple:
    """fn()'s result, run with the kernels or inside reference_ops(), and
    its checked counts: with the kernels, each of `uses` launched and no
    plain version called; inside reference_ops(), no kernel launched."""
    from srewd_tpu_torch.ops import reference_ops

    reset_counts()
    with reference_ops() if plain else contextlib.nullcontext():
        out = fn()
    launches, calls = read_counts()
    if plain:
        check(sum(launches.values()) == 0, f"a kernel launched inside reference_ops(): {launches}")
    else:
        check(all(launches[k] > 0 for k in uses) and sum(calls.values()) == 0,
              f"the kernel side did not run on {uses} alone: {launches} {calls}")
    return out, launches


def compare_archs(torch, device) -> None:
    """Phase 10: full-width physrdiff (spliter, RRDB, cross-attention), batch
    2, the same weights: DPM-10 generate_sr with the kernels against the
    plain versions (relative RMSE of the residual <= 1e-3), and one training
    step with the encoder unlocked (loss <= 1e-5 relative, every UNet and
    encoder gradient <= 1e-3 relative RMSE). Each kernel side must launch
    its kernels and call no plain version; each plain side launches none.
    cuDNN as the sample CLI meets it (the step too: no algorithm timing)."""
    from srewd_tpu_torch.configs.config import load_commented_json
    from srewd_tpu_torch.diffusion.schedule import Schedule

    _sample_defaults(torch)
    model = full_width_model(torch, "physrdiff", device, dropout=0.0)
    model_cfg = load_commented_json(ARCH_CONFIGS["physrdiff"])["model"]
    sched = Schedule.from_config(model_cfg["beta_schedule"]["val"], device=device)
    g = torch.Generator(device=device).manual_seed(4)
    lr = torch.randn(2, *LR_HW, 1, device=device, generator=g)

    def run():
        gen = torch.Generator(device=device).manual_seed(5)
        return model.generate_sr({"LR": lr}, sched, generator=gen, sampler="dpm", ddim_steps=10)

    cond = model.condition({"LR": lr})
    sampling = ("flash_attention", "gn_swish")
    with_kernels, launches_sample = _side(torch, run, False, sampling)
    plain, _ = _side(torch, run, True, sampling)
    err = rel_rmse(with_kernels - cond, plain - cond)

    model.lock_encoder = False
    batch, draws = _step_draws(torch, model_cfg, device, 6)
    training = ("flash_attention", "flash_attention_backward", "gn_swish", "gn_swish_backward")
    (loss_k, grads_k), launches_step = _side(
        torch, lambda: _step_grads(torch, model, batch, sched, draws), False, training)
    (loss_p, grads_p), _ = _side(
        torch, lambda: _step_grads(torch, model, batch, sched, draws), True, training)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    rep = _grad_report(grads_k, grads_p)
    n_enc = sum(1 for k in grads_p if k.startswith("encoder."))
    emit({"phase": "compare_archs", "arch": "physrdiff", "batch": 2, "dtype": "f32",
          "dpm_steps": 10, "rel_rmse_kernels_vs_plain": err, "loss_kernels": loss_k,
          "loss_plain": loss_p, "loss_rel_diff": loss_rel, "encoder_grad_leaves": n_enc, **rep,
          "launches_sample": launches_sample, "launches_step": launches_step,
          "bounds": {"sample": 1e-3, "loss": 1e-5, "grad": 1e-3}})
    check(err <= 1e-3, f"physrdiff DPM-10 kernels vs plain rel RMSE {err} > 1e-3")
    check(n_enc > 0, "the unlocked encoder's gradients are missing")
    check(loss_rel <= 1e-5, f"physrdiff step loss differs by {loss_rel} (relative)")
    check(rep["worst_grad_rel_rmse"] <= 1e-3,
          f"gradient of {rep['worst_leaf']} differs by {rep['worst_grad_rel_rmse']}")
    del model
    torch.cuda.empty_cache()


# bf16 training (phase 11): tests/test_torch_port_bf16.py's tolerances. The
# two sides of a bf16 step carry their own rounding noise, uncorrelated, so a
# leaf is held to BF16_GRAD_FACTOR times the plain side's own bf16 error (its
# distance to the float32 gradient of the same weights), not to a fixed
# relative RMSE; a leaf that is a cancelling sum (a final bias) can sit at a
# relative RMSE of several between any two bf16 runs. A leaf's gradient is the
# float32 image of a bf16 tensor, so the plain side's distance to float32
# counts as no less than one bf16 ulp of its own value: under the L1 loss the
# final conv's bias gradient is a sign count, (n+ - n-) / N, which rounds to a
# multiple of 64 / N, and the plain side can round onto the float32 count
# exactly, which would leave that leaf a bound of 1e-6 of the largest leaf, a
# 670th of one ulp.
BF16_LOSS_REL = 2e-3
BF16_GRAD_FACTOR = 3.0
BF16_GRAD_REL_ALL = 0.1
FINAL_BIAS = "final_conv.block.3.bias"


def bf16_ulp(torch, g):
    """One bf16 ulp of each element of g (0 where g is 0): 2^(e - 8) for
    |g| in [2^(e-1), 2^e), bf16 carrying 8 significant bits."""
    a = g.double().abs()
    _, e = torch.frexp(a)
    return torch.where(a > 0, torch.ldexp(torch.ones_like(a), e - 8), torch.zeros_like(a))


def _bf16_report(torch, grads_k, grads_p, grads_f) -> dict:
    """Kernels against plain in bf16: per leaf |g_k - g_p| over its bound
    BF16_GRAD_FACTOR max(|g_p - g_f|, |ulp(g_p)|) + 1e-6 largest (g_f: the
    plain float32 gradient; ulp: bf16's, element by element), the worst five,
    the worst raw relative RMSE, the relative RMSE over all leaves, and the
    leaves whose bound the ulp sets, each with |g_p - g_f| / |ulp(g_p)|."""
    largest = max(g.double().norm().item() for g in grads_p.values())
    over, rel, floored = {}, {}, {}
    for name, gp in grads_p.items():
        gk, gp, gf = grads_k[name].double(), gp.double(), grads_f[name].double()
        dist, ulp = (gp - gf).norm().item(), bf16_ulp(torch, gp).norm().item()
        if dist < ulp:
            floored[name] = dist / ulp
        bound = BF16_GRAD_FACTOR * max(dist, ulp) + 1e-6 * largest
        over[name] = (gk - gp).norm().item() / bound
        rel[name] = rel_rmse(gk, gp) if gp.norm().item() > 0 else 0.0
    top = sorted(over.items(), key=lambda kv: -kv[1])[:5]
    cat = [torch.cat([g[k].double().flatten() for k in sorted(grads_p)])
           for g in (grads_k, grads_p)]
    return {"grad_leaves": len(grads_p), "ulp_floored_leaves": len(floored),
            "ulp_floored": sorted(floored.items(), key=lambda kv: kv[1]),
            "worst_err_over_bound": top[0][1],
            "worst_leaf": top[0][0], "worst_leaves": [[k, v, rel[k]] for k, v in top],
            "worst_grad_rel_rmse": max(rel.values()),
            "worst_grad_rel_rmse_leaf": max(rel, key=rel.get),
            "grad_rel_rmse_all_leaves": rel_rmse(*cat)}


def compare_bf16_step(torch, device, seed: int = 3) -> dict:
    """Phase 11's comparison: one bf16 loss.backward() of phase 7's model
    (full-width phydiff, batch 2, dropout 0, phase 7's draws at seed 3) with
    the kernels against inside reference_ops(), and the plain float32 step of
    the same master weights as the yardstick of bf16's own error. The line
    also gives the final conv's bias gradient of each side times the number
    of output elements: under the L1 loss, a count of signs."""
    import copy

    from srewd_tpu_torch.cli import random_init_
    from srewd_tpu_torch.configs.config import load_commented_json
    from srewd_tpu_torch.diffusion.schedule import Schedule
    from srewd_tpu_torch.models.factory import build_model

    opt = load_commented_json(CONFIG_TRAIN)
    model_cfg = copy.deepcopy(opt["model"])
    model_cfg["unet"]["dropout"] = 0.0
    with torch.device(device):
        model = build_model(model_cfg, dtype=torch.bfloat16)
    random_init_(model.unet, 0)
    sched = Schedule.from_config(opt["model"]["beta_schedule"]["train"], device=device)
    batch, draws = _step_draws(torch, model_cfg, device, seed)
    training = ("flash_attention", "flash_attention_backward", "gn_swish", "gn_swish_backward")
    (loss_k, grads_k), launches = _side(
        torch, lambda: _step_grads(torch, model, batch, sched, draws), False, training)
    (loss_p, grads_p), _ = _side(
        torch, lambda: _step_grads(torch, model, batch, sched, draws), True, training)
    model.unet.dtype = None  # float32 compute over the same master weights
    (loss_f, grads_f), _ = _side(
        torch, lambda: _step_grads(torch, model, batch, sched, draws), True, training)
    model.unet.dtype = torch.bfloat16
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    rep = _bf16_report(torch, grads_k, grads_p, grads_f)
    over = (loss_rel > BF16_LOSS_REL or rep["worst_err_over_bound"] > 1.0
            or rep["grad_rel_rmse_all_leaves"] > BF16_GRAD_REL_ALL)
    n_out = draws["noise"].numel()
    line = {"phase": "bf16_step", "arch": "phydiff", "batch": 2, "dtype": "bf16",
            "draw_seed": seed, "final_bias_times_n": [
                g[FINAL_BIAS].item() * n_out for g in (grads_k, grads_p, grads_f)],
            "loss_kernels": loss_k, "loss_plain": loss_p, "loss_plain_f32": loss_f,
            "loss_rel_diff": loss_rel, **rep, "launches": launches,
            "bounds": {"loss": BF16_LOSS_REL, "grad_factor": BF16_GRAD_FACTOR,
                       "grad_all_leaves": BF16_GRAD_REL_ALL},
            "float64": _float64_check(torch, model, batch, sched, draws,
                                      [k for k, *_ in rep["worst_leaves"]],
                                      {"kernels": grads_k, "plain": grads_p})
            if over else None}
    emit(line)
    check(loss_rel <= BF16_LOSS_REL, f"bf16 step loss differs by {loss_rel} (relative)")
    check(rep["worst_err_over_bound"] <= 1.0,
          f"bf16 gradient of {rep['worst_leaf']} is {rep['worst_err_over_bound']} times its "
          f"bound ({BF16_GRAD_FACTOR} x the plain side's distance to float32, at least "
          "one bf16 ulp)")
    check(rep["grad_rel_rmse_all_leaves"] <= BF16_GRAD_REL_ALL,
          f"bf16 gradients differ by {rep['grad_rel_rmse_all_leaves']} over all leaves")
    del model
    torch.cuda.empty_cache()
    return line


def train_kernel_table(torch, attn_shapes, gn_shapes, device) -> None:
    """--train-kernels: the bf16 training step's kernels per main-path unit
    (one phydiff step: phase 3's shapes with phydiff's calls per UNet call)
    at batch 4 (the trainer's) and 16 (bench_train's): calls x the median
    CUDA-event ms of one call of K1 with its row log-sum-exp, K2, K3 with
    its statistics and K3's backward, of their plain versions and of the
    library calls (SDPA's forward and backward; F.group_norm forward and
    backward on the channels_last NCHW view at the swish-less shapes, as in
    phase 3, and F.silu(F.group_norm) at the others as torch_two_calls_ms),
    beside the bound at 989 TFLOP/s and 3.35 TB/s (phase 3's op and byte
    counts). One line per kernel and batch; timing only, phase 3 holds the
    results."""
    import torch.nn.functional as F

    from srewd_tpu_torch.ops.flash_attention import (
        attention_backward_reference, attention_reference, flash_attention,
        flash_attention_backward)
    from srewd_tpu_torch.ops.fused_groupnorm import (
        gn_swish, gn_swish_backward, gn_swish_backward_reference, gn_swish_reference)

    dt = torch.bfloat16
    g = torch.Generator(device=device).manual_seed(2)
    for b in (TRAIN_BATCH, 16):
        rows = {k: {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                    "torch_two_calls_ms": 0.0, "bound_ms": 0.0, "bound_by": None, "calls": 0}
                for k in ("flash_attention", "flash_attention_backward", "gn_swish",
                          "gn_swish_backward")}

        def add(name, calls, ms, plain_ms, lib_ms, bd, dev_ms, two_calls=False):
            r = rows[name]
            r["calls"] += calls
            r["ms"] += calls * ms
            r["device_ms"] += calls * dev_ms
            r["plain_ms"] += calls * plain_ms
            r["torch_two_calls_ms" if two_calls else "library_ms"] += calls * lib_ms
            r["bound_ms"] += calls * bd[0]
            r["bound_by"] = bd[1] if r["bound_by"] in (None, bd[1]) else "operations and bytes"

        for (kind, n, d), calls in sorted(attn_shapes.items()):
            scale = 1.0 / math.sqrt(d)
            q, k, v = attention_inputs(torch, kind, b, n, d, dt, device, g)
            do = torch.randn(b, n, d, device=device, generator=g).to(dt)
            o, lse, o32 = flash_attention(q, k, v, scale, return_lse=True)
            add("flash_attention", calls,
                cuda_ms(torch, lambda: flash_attention(q, k, v, scale, return_lse=True), 10),
                cuda_ms(torch, lambda: attention_reference(q, k, v, scale), 5),
                cuda_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v, scale=scale), 10),
                bound(4.0 * b * n * n * d, 4.0 * b * n * d * 2 + 4.0 * b * n * d + 4.0 * b * n,
                      PEAK_BF16),
                graph_ms(torch, lambda: flash_attention(q, k, v, scale, return_lse=True)))
            ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
            lib_out = F.scaled_dot_product_attention(ql, kl, vl, scale=scale)
            add("flash_attention_backward", calls,
                cuda_ms(torch, lambda: flash_attention_backward(q, k, v, o32, lse, do, scale), 10),
                cuda_ms(torch, lambda: attention_backward_reference(q, k, v, do, scale), 3),
                cuda_ms(torch, lambda: torch.autograd.grad(lib_out, (ql, kl, vl), do,
                                                           retain_graph=True), 5),
                bound(10.0 * b * n * n * d, 7.0 * b * n * d * 2 + 4.0 * b * n * d + 4.0 * b * n,
                      PEAK_BF16),
                graph_ms(torch, lambda: flash_attention_backward(q, k, v, o32, lse, do, scale)))
            del q, k, v, do, o, lse, o32, ql, kl, vl, lib_out
            torch.cuda.empty_cache()
        for (shape, groups, swish), calls in sorted(gn_shapes.items()):
            shape = (b, *shape[1:])
            c = shape[-1]
            w = torch.randn(c, device=device, generator=g).to(dt)
            bias = torch.randn(c, device=device, generator=g).to(dt)
            x = (torch.randn(shape, device=device, generator=g) * 3 + 1).to(dt)
            dy = torch.randn(shape, device=device, generator=g).to(dt)
            _, mean, rstd = gn_swish(x, w, bias, groups, 1e-5, swish, return_stats=True)

            def torch_gn():
                y = F.group_norm(x.permute(0, 3, 1, 2), groups, w, bias, 1e-5)
                return F.silu(y) if swish else y

            add("gn_swish", calls,
                cuda_ms(torch, lambda: gn_swish(x, w, bias, groups, 1e-5, swish,
                                                return_stats=True), 20),
                cuda_ms(torch, lambda: gn_swish_reference(x, w, bias, groups, 1e-5, swish), 10),
                cuda_ms(torch, torch_gn, 20),
                bound(10.0 * x.numel(), 2.0 * x.numel() * 2 + 2 * c * 2, PEAK_BF16),
                graph_ms(torch, lambda: gn_swish(x, w, bias, groups, 1e-5, swish,
                                                 return_stats=True)), swish)
            xl, wl, bl = (t.detach().clone().requires_grad_() for t in (x, w, bias))
            yl = F.group_norm(xl.permute(0, 3, 1, 2), groups, wl, bl, 1e-5)
            yl = F.silu(yl) if swish else yl
            add("gn_swish_backward", calls,
                cuda_ms(torch, lambda: gn_swish_backward(x, dy, w, bias, mean, rstd, groups,
                                                         swish), 20),
                cuda_ms(torch, lambda: gn_swish_backward_reference(x, dy, w, bias, groups, 1e-5,
                                                                   swish), 5),
                cuda_ms(torch, lambda: torch.autograd.grad(yl, (xl, wl, bl),
                                                           dy.permute(0, 3, 1, 2),
                                                           retain_graph=True), 10),
                bound(20.0 * x.numel(), 3.0 * x.numel() * 2 + 4 * c * 2, PEAK_BF16),
                graph_ms(torch, lambda: gn_swish_backward(x, dy, w, bias, mean, rstd, groups,
                                                          swish)), swish)
            del x, dy, w, bias, mean, rstd, xl, wl, bl, yl
            torch.cuda.empty_cache()
        for name, r in rows.items():
            emit({"phase": "train_kernels", "kernel": name, "dtype": "bf16", "batch": b,
                  "unit": "one phydiff training step", **r,
                  "pct_of_bound": 100.0 * r["bound_ms"] / r["ms"],
                  "device_pct_of_bound": 100.0 * r["bound_ms"] / r["device_ms"]})


def profile_train_steps(torch, workdir, device) -> None:
    """--train-kernels: one phydiff training step at batch 4 (phase 6's
    config, trainer as build_trainer makes it), bf16 and float32: host ms of
    5 steps to a synchronise after 3 warm-up steps, then torch.profiler over
    3 steps: device busy ms, idle share, kernel launches and the top kernels
    and host operations per step."""
    from torch.profiler import ProfilerActivity, profile

    from srewd_tpu_torch.cli import Config, build_data_handler, build_trainer, cuda_numerics

    cuda_numerics(device, training=True)
    opt = Config(train_config(workdir), phase="train", experiment=False).get_opt()
    opt["path"]["checkpoint"] = None
    batches = list(build_data_handler(opt).train_batches(epoch=1))
    for dtype in (torch.bfloat16, None):
        trainer = build_trainer(opt, device, dtype=dtype)
        for i in range(3):
            trainer.train_on_batch(batches[i])
        speed = _steps_per_sec(torch, trainer.train_on_batch_async, [(b,) for b in batches])
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(3):
                trainer.train_on_batch_async(batches[i])
            torch.cuda.synchronize()
        rows = _device_kernels(torch, prof, 3)
        host = sorted(((e.key, e.self_cpu_time_total / 3e3, e.count / 3)
                       for e in prof.key_averages()), key=lambda r: -r[1])
        busy = sum(r[1] for r in rows)
        emit({"phase": "train_step_profile", "arch": "phydiff", "batch": TRAIN_BATCH,
              "dtype": "bf16" if dtype else "f32", **speed, "device_busy_ms": busy,
              "idle_share": 1.0 - busy / speed["step_host_ms"],
              "kernel_launches": sum(r[2] for r in rows),
              "top_kernels": [[k[:90], ms, n] for k, ms, n in rows[:15]],
              "top_host_ops": [[k[:60], ms, n] for k, ms, n in host[:12]]})
        del trainer
        torch.cuda.empty_cache()


def _float_state(trainer) -> dict:
    """The dtypes of every trainable parameter, Adam moment and EMA entry."""
    moments = [v for st in trainer.optimizer.state.values() for v in st.values()
               if v.is_floating_point() and v.ndim > 0]
    ema = list((trainer.ema or {}).values()) + list((trainer.ema_encoder or {}).values())
    return {"parameters": sorted({str(p.dtype) for p in trainer.trainable}),
            "moments": sorted({str(v.dtype) for v in moments}), "n_moments": len(moments),
            "ema": sorted({str(v.dtype) for v in ema}), "n_ema": len(ema)}


def bf16_train_config(workdir, arch, ckpts) -> str:
    """Phase 11's config: phase 6's (phydiff) or phase 9's srdiff+rrdb_unlocked
    at batch 4 on phase 8's RRDB, with EMA from step 0."""
    from srewd_tpu_torch.configs.config import load_commented_json

    if arch == "phydiff":
        cfg = load_commented_json(train_config(workdir))
    else:
        cfg = load_commented_json(ARCH_TRAIN_CONFIGS[arch])
        cfg["data"].update(arch_data_settings(workdir), batch_size=TRAIN_BATCH,
                           val_batch_size=BATCH)
        cfg["model"]["pretrained_model"]["model_path"] = ckpts["rrdb"]
        cfg["path"]["experiments_folder_path"] = os.path.join(workdir, f"bf16_{arch}")
    cfg["train"]["ema_scheduler"].update(enabled=True, step_start_ema=0)
    return _write_config(workdir, f"bf16_train_{arch}", cfg)


def train_bf16(torch, workdir, arch, device, per_arch, ckpts, f32_speed) -> dict:
    """Phase 11 for one arch: build_trainer(dtype=bfloat16) as train.main
    builds it, one step (gradients, launches), 5 timed steps, the float32
    state, a DPM-5 bf16 chain through the trained model."""
    from srewd_tpu_torch.cli import Config, build_data_handler, build_trainer

    opt = Config(bf16_train_config(workdir, arch, ckpts), phase="train",
                 experiment=False).get_opt()
    opt["path"]["checkpoint"] = None
    dh = build_data_handler(opt)
    batches = list(dh.train_batches(epoch=1))[:6]
    trainer = build_trainer(opt, device, dtype=torch.bfloat16)
    per_step = {"flash_attention": per_arch[arch]["attention_calls"],
                "flash_attention_backward": per_arch[arch]["attention_calls"],
                "gn_swish": per_arch[arch]["gn_calls"],
                "gn_swish_backward": per_arch[arch]["gn_calls"]}
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [trainer.train_on_batch(batches[0])]  # cuDNN times its bf16 algorithms here
    first_step_sec = time.perf_counter() - t0
    launches, plain = read_counts()
    grads = _check_grads(torch, trainer.model)
    check(launches == per_step and sum(plain.values()) == 0,
          f"{arch} bf16 step: launches {launches} (expected {per_step}), plain calls {plain}")
    reset_counts()
    speed = _steps_per_sec(torch, trainer.train_on_batch_async, [(b,) for b in batches[1:]])
    launches5, plain5 = read_counts()
    check(launches5 == {k: 5 * v for k, v in per_step.items()} and sum(plain5.values()) == 0,
          f"{arch} bf16 steps: launches {launches5}, plain calls {plain5}")
    state = _float_state(trainer)
    check(all(v == ["torch.float32"] for k, v in state.items() if not k.startswith("n_"))
          and state["n_moments"] == 2 * len(trainer.trainable) and state["n_ema"] > 0,
          f"{arch} bf16 training state is not all float32: {state}")
    check(all(math.isfinite(v) for v in losses), f"{arch} bf16 loss {losses}")

    model = trainer.model
    masters = {f"{pre}{n}": p.detach().clone() for pre, m in (("", model.unet),
                                                              ("encoder.", model.encoder))
               if m is not None for n, p in m.named_parameters()}
    lr = torch.as_tensor(batches[0]["LR"]).to(device)
    reset_counts()
    sr = model.generate_sr({"LR": lr}, trainer.schedule_val, sampler="dpm", ddim_steps=5,
                           generator=torch.Generator(device=device).manual_seed(7))
    torch.cuda.synchronize()
    launches_sample, plain_sample = read_counts()
    now = {f"{pre}{n}": p for pre, m in (("", model.unet), ("encoder.", model.encoder))
           if m is not None for n, p in m.named_parameters()}
    unchanged = all(p.dtype == torch.float32 and torch.equal(p, masters[n])
                    for n, p in now.items())
    line = {"phase": "bf16_train", "arch": arch, "batch": TRAIN_BATCH, "dtype": "bf16",
            "first_step_sec": first_step_sec, **speed,
            "steps_per_sec_f32_same_settings": f32_speed,
            "bf16_over_f32": speed["steps_per_sec"] / f32_speed, "losses": losses,
            "launches_per_step": launches, "state_dtypes": state, **grads,
            "dpm5_finite": bool(torch.isfinite(sr).all()), "launches_sample": launches_sample,
            "masters_float32_unchanged": unchanged}
    emit(line)
    check(line["dpm5_finite"], f"{arch}: the bf16 DPM-5 chain gave non-finite values")
    check(launches_sample["flash_attention"] == 5 * per_step["flash_attention"]
          and launches_sample["gn_swish"] == 5 * per_step["gn_swish"]
          and sum(plain_sample.values()) == 0,
          f"{arch}: the bf16 chain's launches {launches_sample}, plain calls {plain_sample}")
    check(unchanged, f"{arch}: the bf16 chain changed the master weights or their dtype")
    del trainer, model, masters
    torch.cuda.empty_cache()
    launches_all = {k: launches[k] + launches5[k] + launches_sample[k] for k in launches}
    return {"launches": launches_all, "steps_per_sec": speed["steps_per_sec"]}


def run_bf16_training(torch, workdir, device, per_arch, ckpts, f32_speed) -> dict:
    """Phase 11: bf16 training of phydiff (phase 6's config) and srdiff with
    its RRDB unlocked (phase 9's), then phase 7's step in bf16, kernels
    against plain."""
    from collections import Counter

    from srewd_tpu_torch.cli import cuda_numerics

    cuda_numerics(device, training=True)
    total = Counter()
    for arch in ("phydiff", "srdiff"):
        total.update(train_bf16(torch, workdir, arch, device, per_arch, ckpts,
                                f32_speed[arch])["launches"])
    compare_bf16_step(torch, device)
    return dict(total)


def trace_summary(path: str) -> dict:
    """From a run_training Chrome trace: the window from the first traced
    step's start to the last kernel's end, the card's busy time in it (the
    union of kernel intervals) and idle share, and per kernel family the
    device ms and launches."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel" and e.get("ph") == "X"]
    steps = [e for e in events if e.get("name") == "train_step"
             and e.get("cat") == "user_annotation"]
    check(bool(kernels) and bool(steps), f"the trace {path} holds no kernels or no train_step")
    t0 = min(e["ts"] for e in steps)
    t1 = max(e["ts"] + e["dur"] for e in kernels)
    busy, end = 0.0, t0
    for e in sorted(kernels, key=lambda e: e["ts"]):
        lo, hi = max(e["ts"], end), min(e["ts"] + e["dur"], t1)
        if hi > lo:
            busy += hi - lo
        end = max(end, e["ts"] + e["dur"])
    families = {"flash_attention": ("flash_fwd_kernel",),
                "flash_attention_backward": ("flash_bwd_",),
                "gn_swish": ("gn_fwd_kernel",), "gn_swish_backward": ("gn_bwd_kernel",
                                                                      "gn_wb_kernel")}
    per = {}
    for fam, keys in families.items():
        mine = [e for e in kernels if any(k in e["name"] for k in keys)]
        per[fam] = {"device_ms": sum(e["dur"] for e in mine) / 1e3, "launches": len(mine)}
    return {"steps": len(steps), "window_ms": (t1 - t0) / 1e3, "busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / (t1 - t0), "kernels": per}


def run_bench_twins(torch, workdir, device) -> dict:
    """Phase 12: `srewd_tpu_torch.bench` (DDIM-50, one timed chain: sr3 bf16,
    phydiff float32) and `bench_train` (sr3, batch 16, bf16, 10 steps, 0 <
    MFU < 1) through their run functions, one more bench_train step with
    every kernel launch repeated and held against its plain version; then
    run_training of phydiff in bf16: 6 steps with a profiler window on steps
    4-6 under build/, and 4 steps with train.device_data_cache against the
    same 4 through the prefetcher (losses equal bit for bit)."""
    import copy
    import io
    from collections import Counter

    from srewd_tpu_torch import bench, bench_train
    from srewd_tpu_torch.cli import Config, build_data_handler, build_trainer, cuda_numerics
    from srewd_tpu_torch.configs.config import load_commented_json
    from srewd_tpu_torch.training.trainer import DiffusionTrainer, run_training

    total = Counter()
    for arch, dtype in (("sr3", "bf16"), ("phydiff", "f32")):
        _sample_defaults(torch)  # as the sample CLI meets cuDNN
        out = io.StringIO()
        reset_counts()
        with contextlib.redirect_stdout(out):
            res = bench.run(bench.bench_model_cfg(arch), device, batch=BATCH, dtype=dtype,
                            repeats=1, sampler="ddim", ddim_steps=50)
        launches, plain = read_counts()
        total.update(launches)
        emit({"phase": "bench", "arch": arch, "dtype": dtype, "result": res,
              "launches": launches, "plain_calls": plain})
        check(out.getvalue().strip() == json.dumps(res), f"bench printed {out.getvalue()!r}")
        check(res["value"] > 0 and math.isfinite(res["vs_baseline"]), f"bench {arch}: {res}")
        check(launches["flash_attention"] > 0 and launches["gn_swish"] > 0
              and launches["flash_attention_backward"] == launches["gn_swish_backward"] == 0
              and sum(plain.values()) == 0, f"bench {arch}: {launches} {plain}")

    cuda_numerics(device, training=True)
    out = io.StringIO()
    reset_counts()
    with _tap(torch, DiffusionTrainer, "train_on_batch_async") as tap, \
            contextlib.redirect_stdout(out):
        res = bench_train.run(bench.bench_model_cfg("sr3"), device, batch=16, dtype="bf16",
                              steps=10)
    launches, plain = read_counts()
    total.update(launches)
    log = {}
    unwrap = _watch_kernels(torch, log)
    try:  # launches made to hold the kernels against their plain versions: not counted
        tap["obj"].train_on_batch_async(*tap["calls"][0])
        torch.cuda.synchronize()
    finally:
        unwrap()
    del tap
    torch.cuda.empty_cache()
    emit({"phase": "bench_train", "result": res, "launches": launches, "plain_calls": plain,
          "watched_step": log})
    check(out.getvalue().strip() == json.dumps(res), f"bench_train printed {out.getvalue()!r}")
    check(0.0 < res["mfu"] < 1.0, f"bench_train MFU {res['mfu']} outside (0, 1)")
    # 12 steps on the card; the plain versions ran once each per call of a
    # step, on the meta device, where bench_train counts the step's FLOPs
    steps = 12
    one_plain_step = {"attention_reference": launches["flash_attention"] // steps,
                      "attention_backward_reference": launches["flash_attention_backward"] // steps,
                      "gn_swish_reference": launches["gn_swish"] // steps,
                      "gn_swish_backward_reference": launches["gn_swish_backward"] // steps}
    check(all(launches[k] > 0 and launches[k] % steps == 0 for k in launches)
          and plain == one_plain_step, f"bench_train: {launches} {plain}")
    check(set(log) == set(launches) and all(
        r["differ_on_repeat"] == r["nonfinite"] == r["over_tol"] == 0 for r in log.values()),
          f"bench_train's batch-16 launches against their plain versions: {log}")

    cfg = load_commented_json(train_config(workdir))
    trace_dir = os.path.join(BUILD, "profile", "run_training_bf16")
    cfg["train"].update(n_iter=6, print_freq=6, profile_trace_dir=trace_dir, profile_start=3,
                        profile_steps=3)
    runs = {}
    for name, extra in (("traced", {}), ("device_cache", {"n_iter": 4, "device_data_cache": True,
                                                           "profile_trace_dir": None}),
                        ("prefetcher", {"n_iter": 4, "profile_trace_dir": None})):
        c = copy.deepcopy(cfg)
        c["train"].update(extra)
        opt = Config(_write_config(workdir, f"run_training_{name}", c), phase="train",
                     experiment=False).get_opt()
        opt["path"]["checkpoint"] = None
        reset_counts()
        t0 = time.perf_counter()
        runs[name] = run_training(opt, build_data_handler(opt),
                                  build_trainer(opt, device, dtype=torch.bfloat16))
        runs[name]["sec"] = time.perf_counter() - t0
        launches, plain = read_counts()
        total.update(launches)
        check(all(launches[k] > 0 for k in launches) and sum(plain.values()) == 0,
              f"run_training {name}: {launches} {plain}")
    summary = trace_summary(runs["traced"]["trace"])
    cached = [v for _, v in runs["device_cache"]["losses"]]
    streamed = [v for _, v in runs["prefetcher"]["losses"]]
    emit({"phase": "run_training_bf16", "trace": os.path.relpath(runs["traced"]["trace"], REPO),
          "trace_bytes": os.path.getsize(runs["traced"]["trace"]), **summary,
          "losses_traced": [v for _, v in runs["traced"]["losses"]],
          "losses_device_cache": cached, "losses_prefetcher": streamed,
          "sec": {k: r["sec"] for k, r in runs.items()},
          "steps_per_sec": {k: r["steps_per_sec"] for k, r in runs.items()}})
    check(summary["steps"] == 3 and all(summary["kernels"][k]["launches"] > 0
                                        for k in summary["kernels"]),
          f"the trace does not show 3 steps of K1, K2, K3 and its backward: {summary}")
    check(len(cached) == 4 and cached == streamed,
          f"device_data_cache losses {cached} differ from the prefetcher's {streamed}")
    return dict(total)


def _watch_kernels(torch, log: dict):
    """Wrap the four kernel wrappers (module globals, which the autograd
    Functions look up at each call) so that every launch is made twice on
    the same inputs, whose results must be the same bit for bit, and is held
    against its plain version on those inputs (phase 3's tolerances for the
    result's dtype). `log` collects per kernel the calls, the repeats that
    differ, the non-finite results, the worst error over its tolerance and
    the first few bad calls. Returns the function that unwraps them."""
    from srewd_tpu_torch.ops import flash_attention as fa
    from srewd_tpu_torch.ops import fused_groupnorm as gn
    from srewd_tpu_torch.ops import use_plain

    def note(name, shape, outs, again, pairs, rel):
        rec = log.setdefault(name, {"calls": 0, "differ_on_repeat": 0, "nonfinite": 0,
                                    "over_tol": 0, "worst_err_over_tol": 0.0, "bad": []})
        rec["calls"] += 1
        same = all(torch.equal(a, b) for a, b in zip(outs, again))
        finite = all(bool(torch.isfinite(a).all()) for a in outs)
        ratio = max((a.double() - r.double()).abs().max().item()
                    / tolerance(torch, r, a.dtype, f32_rel=rel) for a, r in pairs)
        rec["differ_on_repeat"] += not same
        rec["nonfinite"] += not finite
        rec["over_tol"] += ratio > 1.0
        rec["worst_err_over_tol"] = max(rec["worst_err_over_tol"], ratio)
        if (not same or not finite or ratio > 1.0) and len(rec["bad"]) < 6:
            rec["bad"].append({"shape": list(shape), "same_on_repeat": same, "finite": finite,
                               "err_over_tol": ratio})

    orig = {"k1": fa.flash_attention, "k2": fa.flash_attention_backward,
            "k3": gn.gn_swish, "k3b": gn.gn_swish_backward}

    def k1(q, k, v, scale, return_lse=False):
        res = orig["k1"](q, k, v, scale, return_lse=return_lse)
        if use_plain(q):
            return res
        again = orig["k1"](q, k, v, scale, return_lse=return_lse)
        outs, again = (res, again) if return_lse else ((res,), (again,))
        note("flash_attention", q.shape, outs, again,
             [(outs[0], fa.attention_reference(q, k, v, scale))], 1e-5)
        return res

    def k2(q, k, v, o, lse, do, scale):
        res = orig["k2"](q, k, v, o, lse, do, scale)
        again = orig["k2"](q, k, v, o, lse, do, scale)
        note("flash_attention_backward", q.shape, res, again,
             list(zip(res, fa.attention_backward_reference(q, k, v, do, scale))), 1e-4)
        return res

    def k3(x, weight, bias, num_groups=32, eps=1e-5, apply_swish=True, return_stats=False):
        res = orig["k3"](x, weight, bias, num_groups, eps, apply_swish, return_stats)
        if use_plain(x):
            return res
        again = orig["k3"](x, weight, bias, num_groups, eps, apply_swish, return_stats)
        outs, again = (res, again) if return_stats else ((res,), (again,))
        note("gn_swish", x.shape, outs, again,
             [(outs[0], gn.gn_swish_reference(x, weight, bias, num_groups, eps, apply_swish))],
             1e-5)
        return res

    def k3b(x, dy, weight, bias, mean, rstd, num_groups=32, apply_swish=True):
        res = orig["k3b"](x, dy, weight, bias, mean, rstd, num_groups, apply_swish)
        again = orig["k3b"](x, dy, weight, bias, mean, rstd, num_groups, apply_swish)
        ref = gn.gn_swish_backward_reference(x, dy, weight, bias, num_groups, 1e-5, apply_swish)
        note("gn_swish_backward", x.shape, res, again, list(zip(res, ref)), 1e-4)
        return res

    for wrapper in (k1, k2, k3, k3b):
        wrapper.launches = 0  # the wrapped functions count under their module name
    fa.flash_attention, fa.flash_attention_backward = k1, k2
    gn.gn_swish, gn.gn_swish_backward = k3, k3b

    def unwrap():
        fa.flash_attention, fa.flash_attention_backward = orig["k1"], orig["k2"]
        gn.gn_swish, gn.gn_swish_backward = orig["k3"], orig["k3b"]
    return unwrap


def _poison_allocator(torch, device) -> None:
    """Hand the caching allocator back ~6 GiB of large blocks and ~1 GiB of
    small ones filled with NaN, so that buffers it hands out next start as
    NaN: a kernel that reads memory nobody wrote gives NaN."""
    torch.cuda.empty_cache()
    big = [torch.full((64 << 20,), float("nan"), device=device) for _ in range(24)]
    small = [torch.full((64 << 10,), float("nan"), device=device) for _ in range(4096)]
    torch.cuda.synchronize()
    del big, small


def stress_step(torch, device, repeats: int) -> None:
    """--stress N, after phases 1-6: phase 7's step (phydiff) and phase 10's
    (physrdiff, RRDB unlocked), each N times, under phase 6's cuDNN settings
    (deterministic, algorithms timed: `cli.cuda_numerics(training=True)`),
    with every kernel launch watched (_watch_kernels) from repeat 1 on; odd
    repeats run in NaN-poisoned memory.
    One line per repeat: the step's kernels-vs-plain loss and worst gradient
    as phases 7 and 10 report them, whether each side's gradients equal its
    first repeat's bit for bit, and the kernels' per-call records."""
    import copy

    from srewd_tpu_torch.cli import cuda_numerics, random_init_
    from srewd_tpu_torch.configs.config import load_commented_json
    from srewd_tpu_torch.diffusion.schedule import Schedule
    from srewd_tpu_torch.models.factory import build_model
    from srewd_tpu_torch.ops import reference_ops

    cuda_numerics(device, training=True)
    opt = load_commented_json(CONFIG_TRAIN)
    model_cfg = copy.deepcopy(opt["model"])
    model_cfg["unet"]["dropout"] = 0.0
    phydiff = build_model(model_cfg)
    random_init_(phydiff.unet, 0)
    phydiff.unet.to(device)
    phy_sched = Schedule.from_config(opt["model"]["beta_schedule"]["train"], device=device)
    physr = full_width_model(torch, "physrdiff", device, dropout=0.0)
    physr.lock_encoder = False
    physr_cfg = load_commented_json(ARCH_CONFIGS["physrdiff"])["model"]
    cases = {"phase7_phydiff": (phydiff, phy_sched, *_step_draws(torch, model_cfg, device, 3)),
             "phase10_physrdiff": (physr, Schedule.from_config(
                 physr_cfg["beta_schedule"]["val"], device=device),
                 *_step_draws(torch, physr_cfg, device, 6))}
    totals = {}
    for case, (model, sched, batch, draws) in cases.items():
        first = {}
        worst = []
        for r in range(repeats):
            poisoned = r % 2 == 1
            if poisoned:
                _poison_allocator(torch, device)
            log = {}
            # repeat 0 is the phase's own step: no launch watched
            unwrap = _watch_kernels(torch, log) if r else (lambda: None)
            try:
                loss_k, grads_k = _step_grads(torch, model, batch, sched, draws)
            finally:
                unwrap()
            with reference_ops():
                loss_p, grads_p = _step_grads(torch, model, batch, sched, draws)
            rep = _grad_report(grads_k, grads_p)
            same = {}
            for side, grads in (("kernels", grads_k), ("plain", grads_p)):
                if side not in first:
                    first[side] = grads
                same[side] = all(torch.equal(grads[k], first[side][k]) for k in grads)
            nonfinite = [k for k, g in grads_k.items() if not bool(torch.isfinite(g).all())]
            line = {"phase": "stress", "case": case, "repeat": r, "poisoned": poisoned,
                    "loss_rel_diff": abs(loss_k - loss_p) / abs(loss_p), **rep,
                    "kernel_grads_same_as_repeat_0": same["kernels"],
                    "plain_grads_same_as_repeat_0": same["plain"],
                    "nonfinite_kernel_grads": nonfinite[:8], "kernels": log}
            emit(line)
            worst.append(rep["worst_grad_rel_rmse"])
            for name, rec in log.items():
                tot = totals.setdefault(name, {"calls": 0, "differ_on_repeat": 0, "nonfinite": 0,
                                               "over_tol": 0, "worst_err_over_tol": 0.0})
                for key in ("calls", "differ_on_repeat", "nonfinite", "over_tol"):
                    tot[key] += rec[key]
                tot["worst_err_over_tol"] = max(tot["worst_err_over_tol"],
                                                rec["worst_err_over_tol"])
            totals.setdefault("steps", {})[case] = {
                "repeats": r + 1, "worst_grad_rel_rmse_max": max(worst),
                "worst_grad_rel_rmse_min": min(worst),
                "over_bound": sum(w > 1e-3 for w in worst)}
    emit({"phase": "stress_summary", **totals})
    bad = {k: v for k, v in totals.items() if k != "steps"
           and (v["differ_on_repeat"] or v["nonfinite"] or v["over_tol"])}
    check(not bad, f"a kernel launch repeated differently, gave non-finite values or broke "
                   f"its tolerance: {bad}")
    check(all(v["over_bound"] == 0 for v in totals["steps"].values()),
          f"a step broke the 1e-3 gradient bound: {totals['steps']}")


SERVE_REQUESTS = (5, 3, 1, 4, 2, 6, 3)  # phase 13: 24 fields from concurrent clients
SERVE_SEED = 11


def _post_b64(url: str, lr, months) -> "np.ndarray":
    import urllib.request

    from srewd_tpu_torch.serving.http import _b64_decode, _b64_encode

    body = json.dumps({"lr_b64": _b64_encode(lr), "months": [int(m) for m in months]}).encode()
    req = urllib.request.Request(url + "/v1/super_resolve", data=body,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return _b64_decode(json.loads(r.read())["sr_b64"])


def op_dispatch_us(torch, device, attn_shapes, gn_shapes) -> dict:
    """Host µs of one call of K1's and K3's forward through the wrapper (the
    eager route) and through the custom op (the exported program's route),
    at the smallest main-path shapes in bf16, where a call's host time
    exceeds its device time: 200 calls enqueued, then one synchronise."""
    from srewd_tpu_torch.ops import flash_attention as fa
    from srewd_tpu_torch.ops import fused_groupnorm as gn

    g = torch.Generator(device=device).manual_seed(3)
    kind, n, d = min(attn_shapes, key=lambda a: a[1] * a[2])
    q, k, v = attention_inputs(torch, kind, BATCH, n, d, torch.bfloat16, device, g)
    shape, groups, swish = min(gn_shapes, key=lambda s: math.prod(s[0]))
    x = torch.randn(shape, device=device, generator=g).to(torch.bfloat16)
    w = torch.ones(shape[-1], device=device, dtype=torch.bfloat16)
    scale = 1.0 / math.sqrt(d)
    calls = {
        "k1_direct": lambda: fa.flash_attention(q, k, v, scale),
        "k1_op": lambda: torch.ops.srewd.flash_attention(q, k, v, scale),
        "k3_direct": lambda: gn.gn_swish(x, w, w, groups, 1e-5, swish),
        "k3_op": lambda: torch.ops.srewd.gn_swish(x, w, w, groups, 1e-5, swish),
    }
    out = {}
    for _ in range(2):  # the second round is kept: both routes warm, in turns
        for name, fn in calls.items():
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                fn()
            torch.cuda.synchronize()
            out[name] = (time.perf_counter() - t0) / 200 * 1e6
    out["shapes"] = {"k1": [kind, BATCH, n, d], "k3": [list(shape), groups, swish]}
    return out


def run_serving(torch, workdir, device, phase6, per_arch, attn_shapes, gn_shapes) -> dict:
    """Phase 13: the serving layer on phase 6's phydiff checkpoint (float32,
    DPM-25, batch 8): SamplerService.from_checkpoint behind make_server on
    localhost, 24 fields from 7 concurrent clients, each device batch held
    against generate_sr of its packed batch and each field against its row;
    the export_sampler entry point (K1 and K3 as custom-op nodes: per step
    program as many as one eager UNet call launches); the artifact loaded in
    a fresh process at batch 3 and 8 against generate_sr at the same seed;
    then bench_serve at its full-width defaults. Launches: the service's,
    the artifact's (in its process) and bench_serve's."""
    import io
    import threading
    from collections import Counter

    import numpy as np

    from srewd_tpu_torch import bench_serve
    from srewd_tpu_torch import export_sampler as export_cli
    from srewd_tpu_torch.serving.http import make_server
    from srewd_tpu_torch.serving.service import SamplerService, load_stack
    from srewd_tpu_torch.utils.seeding import member_seed

    t_phase = time.perf_counter()
    _sample_defaults(torch)
    cfg, ckpt = phase6["config"], phase6["checkpoint"]
    dpm = {"sampler": "dpm", "ddim_steps": DPM_STEPS}
    calls = per_arch["phydiff"]
    total = Counter()

    # the service over HTTP
    t0 = time.perf_counter()
    stack = load_stack(cfg, ckpt, diffusion_overrides=dpm, device=device)
    stack_sec = time.perf_counter() - t0
    lr_sc, hr_sc = stack.lr_scaler, stack.hr_scaler
    rng = np.random.default_rng(SERVE_SEED)
    reqs = [lr_sc.inverse(rng.standard_normal((n, *LR_HW, 1)).astype(np.float32),
                          np.ones(n, np.int32)) for n in SERVE_REQUESTS]
    t0 = time.perf_counter()
    svc = SamplerService.from_checkpoint(cfg, ckpt, diffusion_overrides=dpm, device=device,
                                         batch_size=BATCH, linger_ms=50.0, seed=SERVE_SEED)
    service_sec = time.perf_counter() - t0
    batches = []  # (normalized packed LR, seq, the service's raw output) per device batch
    enqueue = svc._enqueue

    def tapped(model, lr, seq):
        host, event = enqueue(model, lr, seq)
        batches.append((lr, seq, host, event))
        return host, event

    svc._enqueue = tapped
    server = make_server(svc, port=0)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    serve_thread = threading.Thread(target=server.serve_forever, daemon=True)
    serve_thread.start()
    results, errors = [None] * len(reqs), []

    def client(i):
        try:
            results[i] = _post_b64(url, reqs[i], np.ones(len(reqs[i]), np.int32))
        except Exception as e:  # reported below, after every client has ended
            errors.append(repr(e))

    reset_counts()
    t0 = time.perf_counter()
    try:
        clients = [threading.Thread(target=client, args=(i,)) for i in range(len(reqs))]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=600)
        serve_sec = time.perf_counter() - t0
        stats = svc.stats()
    finally:
        server.shutdown()
        server.server_close()
        svc.close()
        serve_thread.join(timeout=60)
    served_launches, served_plain = read_counts()
    total.update(served_launches)
    check(not errors and all(r is not None for r in results), f"HTTP clients failed: {errors}")

    # each device batch against generate_sr of its packed batch (not counted)
    t0 = time.perf_counter()
    model, schedule = stack.model, stack.schedule
    batch_err, rows = [], {}
    for lr, seq, host, event in batches:
        event.synchronize()
        gen = torch.Generator(device=device).manual_seed(member_seed(SERVE_SEED, seq))
        direct = model.generate_sr({"LR": torch.from_numpy(lr).to(device)}, schedule,
                                   generator=gen, **dpm).cpu()
        batch_err.append({"seq": seq, "bit_identical": bool(torch.equal(host, direct)),
                          "rel_rmse": rel_rmse(host, direct)})
        for r in range(BATCH):
            rows.setdefault(lr[r].tobytes(), direct[r].numpy())
    field_err = 0.0
    lo, hi = math.inf, -math.inf
    for req, sr in zip(reqs, results):
        months = np.ones(len(req), np.int32)
        norm = lr_sc.transform(req, months)
        want = hr_sc.inverse(np.stack([rows[f.tobytes()] for f in norm]), months)
        field_err = max(field_err, float(np.abs(sr - want).max()))
        lo, hi = min(lo, float(sr.min())), max(hi, float(sr.max()))
    emit({"phase": "serve", "requests": list(SERVE_REQUESTS), "fields": sum(SERVE_REQUESTS),
          "stats": stats, "sec": serve_sec, "fields_per_sec": sum(SERVE_REQUESTS) / serve_sec,
          "stack_sec": stack_sec, "service_setup_sec": service_sec,
          "direct_sec": time.perf_counter() - t0,
          "device_batches": batch_err, "max_abs_kelvin_vs_direct": field_err,
          "kelvin_min": lo, "kelvin_max": hi, "launches": served_launches,
          "plain_calls": served_plain})
    n_batches = stats["device_batches"]
    check(stats["fields"] == sum(SERVE_REQUESTS) and len(batches) == n_batches >= 3,
          f"serve stats {stats}, {len(batches)} batches tapped")
    # bound: float32 sums in another order (the same kernels and cuDNN's
    # heuristics on both sides make it exact in practice)
    check(all(b["rel_rmse"] <= 1e-5 for b in batch_err),
          f"a device batch differs from generate_sr of its packed batch: {batch_err}")
    check(field_err <= 1e-3, f"a served field differs from its row by {field_err} K")
    check(180.0 < lo and hi < 360.0,
          f"served fields outside a plausible Kelvin range: [{lo}, {hi}]")
    check(served_launches["flash_attention"] == n_batches * DPM_STEPS * calls["attention_calls"]
          and served_launches["gn_swish"] == n_batches * DPM_STEPS * calls["gn_calls"]
          and served_launches["flash_attention_backward"] == 0
          and served_launches["gn_swish_backward"] == 0 and sum(served_plain.values()) == 0,
          f"serve launches {served_launches} for {n_batches} batches, plain {served_plain}")

    # the exported sampler: the entry point, then a fresh process that loads it,
    # counts its custom-op nodes and runs it, while this one computes the
    # eager references (its chains come after its ~20 s of imports and loading)
    path = os.path.join(workdir, "phydiff_dpm25.srexport")
    out = io.StringIO()
    reset_counts()
    with contextlib.redirect_stdout(out):
        exported = export_cli.main(["-c", cfg, "-m", ckpt, "-o", path, "--sampler", "dpm",
                                    "--ddim-steps", str(DPM_STEPS), "--device", str(device)])
    export_launches, _ = read_counts()
    check(out.getvalue().startswith("EXPORT OK "), f"export_sampler printed {out.getvalue()!r}")
    check(sum(export_launches.values()) == 0, f"exporting launched kernels: {export_launches}")
    lrs = {b: lr_sc.inverse(rng.standard_normal((b, *LR_HW, 1)).astype(np.float32),
                            np.ones(b, np.int32)) for b in (3, 8)}
    for b, lr in lrs.items():
        np.save(os.path.join(workdir, f"serve_lr{b}.npy"), lr)
    code = f"""
import json, sys, time
t_start = time.perf_counter()
from collections import Counter
import numpy as np
sys.path.insert(0, {REPO!r})
from srewd_tpu_torch.ops import flash_attention as fa, fused_groupnorm as gn
from srewd_tpu_torch.serving.export import load_sampler
t0 = time.perf_counter()
fn = load_sampler({path!r})
out = {{"load_sec": time.perf_counter() - t0, "launches": {{}}, "call_sec": {{}}}}
out["graph_nodes"] = {{name: dict(Counter(str(n.target) for n in ep.graph.nodes
                                          if str(n.target).startswith("srewd.")))
                      for name, ep in (("condition", fn.exported.condition),
                                       ("step", fn.exported.step))}}
for b in (3, 8):
    lr = np.load({workdir!r} + f"/serve_lr{{b}}.npy")
    before = fa.flash_attention.launches, gn.gn_swish.launches
    t0 = time.perf_counter()
    sr = fn(lr, np.ones(b, np.int32), seed={SERVE_SEED}).cpu().numpy()
    out["call_sec"][b] = time.perf_counter() - t0
    np.save({workdir!r} + f"/serve_sr{{b}}.npy", sr)
    out["launches"][b] = [fa.flash_attention.launches - before[0],
                          gn.gn_swish.launches - before[1]]
out["plain_calls"] = fa.attention_reference.calls + gn.gn_swish_reference.calls
model_code = tuple("srewd_tpu_torch." + p for p in ("models", "configs", "diffusion", "training"))
out["model_modules"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "srewd_tpu")
                              or m.startswith(model_code))
out["process_sec"] = time.perf_counter() - t_start
print(json.dumps(out))
"""
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=REPO)
    try:
        wants = {}
        for b, lr_k in lrs.items():  # the eager references (not counted)
            months = np.ones(b, np.int32)
            gen = torch.Generator(device=device).manual_seed(SERVE_SEED)
            x = torch.from_numpy(lr_sc.transform(lr_k, months)).to(device)
            sr = model.generate_sr({"LR": x}, schedule, generator=gen, **dpm)
            wants[b] = (sr.cpu().numpy(), model.condition({"LR": x}).float().cpu().numpy())
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    load_sec = time.perf_counter() - t0
    del model, stack
    torch.cuda.empty_cache()
    check(proc.returncode == 0, f"the artifact's process failed: {stderr[-3000:]}")
    sub = json.loads(stdout.strip().splitlines()[-1])
    nodes = sub["graph_nodes"]
    emit({"phase": "export", "export_sec": exported["export_sec"], "mb": exported["mb"],
          "header": {k: v for k, v in exported.items() if k not in ("noise_ids",)},
          "graph_nodes": nodes, "launches_while_exporting": export_launches})
    want_nodes = {"srewd.flash_attention.default": calls["attention_calls"],
                  "srewd.gn_swish.default": calls["gn_calls"]}
    check(nodes["step"] == want_nodes and not nodes["condition"],
          f"the step program's custom-op nodes {nodes} are not one UNet call's "
          f"{calls['attention_calls']} K1 and {calls['gn_calls']} K3 calls")
    errs = {}
    for b in (3, 8):
        months = np.ones(b, np.int32)
        got = hr_sc.transform(np.load(os.path.join(workdir, f"serve_sr{b}.npy")), months)
        want, cond = wants[b]
        errs[b] = rel_rmse(torch.from_numpy(got - cond), torch.from_numpy(want - cond))
    per_call = [DPM_STEPS * calls["attention_calls"], DPM_STEPS * calls["gn_calls"]]
    emit({"phase": "load_sampler", "sec": load_sec, "process_sec": sub["process_sec"],
          "load_sampler_sec": sub["load_sec"], "call_sec": sub["call_sec"],
          "rel_rmse_vs_generate_sr": errs, "launches": sub["launches"],
          "plain_calls": sub["plain_calls"], "model_modules": sub["model_modules"]})
    check(all(e <= 1e-4 for e in errs.values()),
          f"the loaded artifact is off generate_sr by {errs} (relative RMSE, bound 1e-4)")
    check(all(v == per_call for v in sub["launches"].values()) and sub["plain_calls"] == 0,
          f"the artifact's launches {sub['launches']} are not {per_call} per call, "
          f"or the plain versions ran ({sub['plain_calls']})")
    check(not sub["model_modules"], f"loading the artifact imported {sub['model_modules']}")
    total["flash_attention"] += sum(v[0] for v in sub["launches"].values())
    total["gn_swish"] += sum(v[1] for v in sub["launches"].values())

    dispatch = op_dispatch_us(torch, device, attn_shapes, gn_shapes)
    emit({"phase": "op_dispatch", "host_us_per_call": dispatch,
          "extra_ms_per_phydiff_unet_call_via_ops": (
              calls["attention_calls"] * (dispatch["k1_op"] - dispatch["k1_direct"])
              + calls["gn_calls"] * (dispatch["k3_op"] - dispatch["k3_direct"])) / 1e3})

    out = io.StringIO()
    reset_counts()
    with contextlib.redirect_stdout(out):
        res = bench_serve.main([])
    launches, plain = read_counts()
    total.update(launches)
    say(out.getvalue().strip())
    emit({"phase": "bench_serve", "result": res, "launches": launches, "plain_calls": plain,
          "phase_sec": time.perf_counter() - t_phase})
    check(out.getvalue().strip() == json.dumps(res), f"bench_serve printed {out.getvalue()!r}")
    check(res["value"] > 0 and res["fields"] == 108, f"bench_serve: {res}")
    check(launches["flash_attention"] > 0 and launches["gn_swish"] > 0
          and launches["flash_attention_backward"] == launches["gn_swish_backward"] == 0
          and sum(plain.values()) == 0, f"bench_serve: {launches} {plain}")
    return dict(total)


# ------------------------------------------------------------------- phase 14
DDP_STEPS = 10  # 14(a): train.main under torchrun, world size 1
DDP_RANKS, DDP_LOCAL_BATCH, DDP_GLOO_STEPS = 2, 2, 5  # 14(b): two gloo ranks on the card


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _first_grads(trainer) -> dict:
    """The gradients the first optimizer step of `trainer` sees (after the
    ranks' reduction), filled when it runs."""
    grads = {}

    def hook(optimizer, args, kwargs):
        if not grads:
            grads.update({n: p.grad.detach().clone()
                          for n, p in trainer.model.unet.named_parameters()})

    trainer.optimizer.register_step_pre_hook(hook)
    return grads


@contextlib.contextmanager
def _outputs(cls, method: str):
    """While open, every value `cls.method` returns is appended to the
    yielded list."""
    orig = getattr(cls, method)
    got = []

    def call(self, *args, **kwargs):
        got.append(orig(self, *args, **kwargs))
        return got[-1]

    setattr(cls, method, call)
    try:
        yield got
    finally:
        setattr(cls, method, orig)


@contextlib.contextmanager
def _timed_steps(torch, on_first=None):
    """While open, DiffusionTrainer.train_on_batch_async is timed as an entry
    point calls it: the yielded dict gets the first call's seconds, to a
    synchronise ("first_step_sec"; cuDNN times its algorithms there), and the
    host ms per step of calls 6..DDP_STEPS, between synchronisations after
    calls 5 and DDP_STEPS ("step_host_ms"); `on_first(trainer)` runs before
    the first call."""
    from srewd_tpu_torch.training.trainer import DiffusionTrainer

    out, marks = {}, []
    orig = DiffusionTrainer.train_on_batch_async

    def step(self, batch):
        n = len(marks) + 1
        if n == 1:
            if on_first is not None:
                on_first(self)
            torch.cuda.synchronize()
            out["t0"] = time.perf_counter()
        loss = orig(self, batch)
        if n in (1, 5, DDP_STEPS):
            torch.cuda.synchronize()
        marks.append(time.perf_counter())
        if n == 1:
            out["first_step_sec"] = marks[0] - out.pop("t0")
        if n == DDP_STEPS:
            out["step_host_ms"] = (marks[-1] - marks[4]) / (DDP_STEPS - 5) * 1e3
        return loss

    DiffusionTrainer.train_on_batch_async = step
    try:
        yield out
    finally:
        DiffusionTrainer.train_on_batch_async = orig


def worker_train_main(out: str, no_ddp_cfg: str, argv: list) -> int:
    """Phase 14(a)'s rank, started by torchrun. First `train.main` of
    `no_ddp_cfg` (the same run in another directory) with torchrun's
    WORLD_SIZE hidden, so without a process group: cuDNN times its
    algorithms there, and the DDP run meets the same ones in this process.
    Then `srewd_tpu_torch.train.main(argv)` with this process's launch
    counters from 0. Both timed by `_timed_steps`. Writes to `out` as JSON:
    the process group's backend and size as the DDP run's first step meets
    them, its loss module (DistributedDataParallel), its launches and plain
    calls, both runs' losses and step times, and the seconds from this
    process's start to each run and to the end."""
    import torch
    import torch.distributed as dist

    from srewd_tpu_torch import train
    from srewd_tpu_torch.parallel import rank, world_size

    info = {"sec_start_to_runs": time.perf_counter() - T0}
    no_ddp_argv = [no_ddp_cfg if a == argv[argv.index("-c") + 1] else a for a in argv]
    hidden = os.environ.pop("WORLD_SIZE")
    try:
        with _timed_steps(torch) as timing:
            first = train.main(no_ddp_argv)
    finally:
        os.environ["WORLD_SIZE"] = hidden
    info.update(no_ddp_losses=[v for _, v in first["losses"]],
                no_ddp=timing, sec_start_to_ddp_run=time.perf_counter() - T0)

    def on_first(trainer):
        info.update(backend=dist.get_backend(), world_size=world_size(), rank=rank(),
                    loss_module=type(trainer._loss).__name__, device=str(trainer.device))

    reset_counts()
    with _timed_steps(torch, on_first) as timing:
        summary = train.main(argv)
    launches, plain = read_counts()
    info.update(launches=launches, plain_calls=plain,
                losses=[v for _, v in summary["losses"]], ddp=timing,
                sec_start_to_end=time.perf_counter() - T0)
    with open(out, "w") as f:
        json.dump(info, f)
    return 0


def worker_gloo_step(workdir: str, cfg_path: str) -> int:
    """Phase 14(b)'s rank (RANK, WORLD_SIZE, MASTER_* given by the parent).
    It builds its stride of the data, then waits for a line on its standard
    input (the parent sends it once 14(a) is done with the card), joins the
    gloo group on the card's cuda:0, as the other rank does (NCCL refuses
    two ranks on one card), with cuDNN deterministic and its algorithms
    chosen by heuristics (no time spent timing them: the comparison allows
    another algorithm per process). DDP_GLOO_STEPS trainer steps on this
    rank's stride, then one gathered validation batch. Writes
    ddp_gloo_rank<r>.json (losses, the ranks' mean; launches; the
    validation metrics; a SHA-256 of the parameters' bytes; seconds per
    stage) and, on rank 0, ddp_gloo_rank0.pt (the first step's reduced
    gradients, the final parameters and the validation batch's gathered
    fields, normalised)."""
    import hashlib

    import torch

    from srewd_tpu_torch.cli import Config, build_data_handler, build_trainer
    from srewd_tpu_torch.parallel import all_gather_rows, init_distributed, mean_across, shutdown
    from srewd_tpu_torch.training.trainer import DiffusionTrainer, run_validation

    opt = Config(cfg_path, phase="train", experiment=False).get_opt()
    opt["path"]["checkpoint"] = None
    r = int(os.environ["RANK"])
    dh = build_data_handler(opt, process_index=r, process_count=DDP_RANKS)
    batches = [b for _, b in zip(range(DDP_GLOO_STEPS), dh.train_batches(epoch=1))]
    stages = {"ready": time.perf_counter() - T0}
    sys.stdin.readline()
    t_go = time.perf_counter()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    init_distributed("gloo")
    try:
        trainer = build_trainer(opt, device)
        grads = _first_grads(trainer)
        stages["built"] = time.perf_counter() - t_go
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = [trainer.train_on_batch_async(b) for b in batches]
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / len(batches) * 1e3
        launches, plain = read_counts()
        losses = mean_across(torch.stack(losses)).tolist()
        with _outputs(DiffusionTrainer, "sample_batch") as fields:
            val = run_validation(opt, dh, trainer, max_batches=1)
        sr = all_gather_rows(fields[0])
        stages["trained_and_validated"] = time.perf_counter() - t_go
        params = {k: v.detach().cpu() for k, v in trainer.model.unet.state_dict().items()}
        digest = hashlib.sha256()
        for k in sorted(params):
            digest.update(params[k].numpy().tobytes())
        if r == 0:
            torch.save({"grads": {k: v.cpu() for k, v in grads.items()}, "params": params,
                        "sr": sr.cpu()}, os.path.join(workdir, "ddp_gloo_rank0.pt"))
        stages["saved"] = time.perf_counter() - t_go
        with open(os.path.join(workdir, f"ddp_gloo_rank{r}.json"), "w") as f:
            json.dump({"losses": losses, "launches": launches, "plain_calls": plain,
                       "val": val, "params_sha256": digest.hexdigest(),
                       "n_train": len(dh.train_timestamps), "step_host_ms": step_ms,
                       "stages_sec": stages}, f)
    finally:
        shutdown()
    return 0


class _GlobalVal:
    """The ranks' validation handlers seen as one process: each batch rank
    0's rows, then rank 1's."""

    def __init__(self, parts):
        self.parts = parts

    def val_batches(self):
        import numpy as np

        for bs in zip(*(p.val_batches() for p in self.parts)):
            yield {k: np.concatenate([b[k] for b in bs]) for k in bs[0]}

    def inverse_transform(self, data, months):
        return self.parts[0].inverse_transform(data, months)


def run_ddp_nccl(torch, workdir, phase6) -> dict:
    """Phase 14(a): `python -m torch.distributed.run --standalone
    --nproc_per_node=1` of worker_train_main: train.main of phase 6's config
    for DDP_STEPS steps, without and then with the process group (NCCL)."""
    with open(phase6["config"]) as f:
        cfg = json.load(f)
    # one checkpoint, at the end: phase 6 checks the saving and the resume
    cfg["train"].update(n_iter=DDP_STEPS, save_checkpoint_freq=1000)
    paths = {}
    for name in ("ddp_nccl", "ddp_nccl_no_ddp"):
        cfg["path"]["experiments_folder_path"] = os.path.join(workdir, name)
        paths[name] = _write_config(workdir, name, cfg)
    out = os.path.join(workdir, "ddp_nccl_rank0.json")
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=1",
         os.path.join(REPO, "chip_smoke.py"), "--worker", "train-main", out,
         paths["ddp_nccl_no_ddp"], "-p", "train", "-c", paths["ddp_nccl"], "--device", "cuda"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    sec = time.perf_counter() - t0
    check(r.returncode == 0, f"torchrun train.main failed (rc {r.returncode}):\n"
                             f"{r.stderr[-3000:]}")
    with open(out) as f:
        a = json.load(f)
    ref = phase6["losses"][:DDP_STEPS]
    first_rel = abs(a["losses"][0] - ref[0]) / abs(ref[0])
    max_rel = max(abs(x - y) / abs(y) for x, y in zip(a["losses"], ref))
    ddp, no_ddp = a["ddp"], a["no_ddp"]
    line = {"phase": "ddp_nccl", "sec": sec, **{k: a[k] for k in (
                "backend", "world_size", "loss_module", "device", "launches", "plain_calls",
                "sec_start_to_runs", "sec_start_to_ddp_run", "sec_start_to_end")},
            "first_step_sec": ddp["first_step_sec"],
            "no_ddp_first_step_sec": no_ddp["first_step_sec"],
            "step_host_ms": ddp["step_host_ms"], "steps_per_sec": 1e3 / ddp["step_host_ms"],
            "no_ddp_step_host_ms": no_ddp["step_host_ms"],
            "no_ddp_steps_per_sec": 1e3 / no_ddp["step_host_ms"],
            "ddp_overhead_ms": ddp["step_host_ms"] - no_ddp["step_host_ms"],
            "phase6_step_host_ms": phase6["run_step_host_ms_6_10"],
            "phase6_steps_per_sec": 1e3 / phase6["run_step_host_ms_6_10"],
            "losses": a["losses"], "phase6_losses": ref, "first_loss_rel_diff": first_rel,
            "max_loss_rel_diff": max_rel,
            "no_ddp_max_loss_rel_diff": max(abs(x - y) / abs(y) for x, y in zip(
                a["losses"], a["no_ddp_losses"])),
            "bounds": {"first": 1e-6, "all": 1e-4}}
    emit(line)
    check(a["backend"] == "nccl" and a["world_size"] == 1, f"not NCCL at world size 1: {a}")
    check(a["loss_module"] == "DistributedDataParallel", f"the loss ran as {a['loss_module']}")
    check(len(a["losses"]) == DDP_STEPS, f"{len(a['losses'])} losses logged")
    check(all(v > 0 for v in a["launches"].values()),
          f"a kernel was not launched in the rank: {a['launches']}")
    check(sum(a["plain_calls"].values()) == 0, f"the plain versions ran: {a['plain_calls']}")
    check(first_rel <= 1e-6, f"the first loss differs from phase 6's by {first_rel}")
    check(max_rel <= 1e-4, f"the first {DDP_STEPS} losses differ from phase 6's by {max_rel}")
    return a["launches"]


def _start_gloo_ranks(workdir, cfg_path) -> list:
    """Phase 14(b)'s two ranks (worker_gloo_step), each logging to
    ddp_gloo_rank<r>.log; they read their data, then wait for a line on
    their standard input."""
    port = _free_port()
    procs = []
    for r in range(DDP_RANKS):
        env = {**os.environ, "RANK": str(r), "LOCAL_RANK": str(r),
               "WORLD_SIZE": str(DDP_RANKS), "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}
        with open(os.path.join(workdir, f"ddp_gloo_rank{r}.log"), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.join(REPO, "chip_smoke.py"), "--worker", "gloo-step",
                 workdir, cfg_path], cwd=REPO, env=env, stdin=subprocess.PIPE, stdout=log,
                stderr=subprocess.STDOUT, text=True))
    return procs


def run_ddp_gloo(torch, workdir, device, cfg_path, procs) -> dict:
    """Phase 14(b): the two gloo ranks on the one card, local batch 2,
    against this process at batch 4 on the same global batches and seed,
    phase 6's config (dropout 0.2)."""
    import numpy as np

    from srewd_tpu_torch.cli import Config, build_data_handler, build_trainer
    from srewd_tpu_torch.training.trainer import DiffusionTrainer, run_validation, step_seed

    t0 = time.perf_counter()
    for p in procs:
        p.stdin.write("go\n")
        p.stdin.close()
    opt = Config(cfg_path, phase="train", experiment=False).get_opt()
    opt["path"]["checkpoint"] = None
    parts = [build_data_handler(opt, process_index=i, process_count=DDP_RANKS)
             for i in range(DDP_RANKS)]
    trainer = build_trainer(opt, device)
    grads = _first_grads(trainer)
    batches = [{k: np.concatenate([b[k] for b in bs]) for k in bs[0]}
               for _, bs in zip(range(DDP_GLOO_STEPS),
                                zip(*(p.train_batches(epoch=1) for p in parts)))]
    losses = [trainer.train_on_batch(b) for b in batches]
    sec_one_process = time.perf_counter() - t0
    for p in procs:
        p.wait(timeout=240)
    sec = time.perf_counter() - t0
    for r, p in enumerate(procs):
        with open(os.path.join(workdir, f"ddp_gloo_rank{r}.log")) as f:
            check(p.returncode == 0, f"gloo rank {r} failed (rc {p.returncode}):\n"
                                     f"{f.read()[-3000:]}")
    ranks = []
    for r in range(DDP_RANKS):
        with open(os.path.join(workdir, f"ddp_gloo_rank{r}.json")) as f:
            ranks.append(json.load(f))
    saved = torch.load(os.path.join(workdir, "ddp_gloo_rank0.pt"), map_location=device)
    rep = _grad_report(saved["grads"], grads)
    loss_rel = max(abs(x - y) / abs(y) for x, y in zip(ranks[0]["losses"], losses))
    diag = None
    if rep["worst_grad_rel_rmse"] > 1e-3:
        # the first step's draws, as train_on_batch_async makes them at step 0
        # (the world-1 draws at batch 4: t, gamma's uniforms, the noise)
        g = torch.Generator(device=device).manual_seed(step_seed(trainer.seed, 0))
        b0 = trainer._device_batch(batches[0])
        draws = {"t": torch.randint(1, trainer.schedule_train.num_timesteps + 1, (1,),
                                    generator=g, device=device),
                 "u": torch.rand(len(batches[0]["HR"]), generator=g, device=device),
                 "noise": torch.randn(b0["HR"].shape, generator=g, device=device)}
        model = build_trainer(opt, device).model  # the first step's weights
        diag = _float64_check(torch, model, b0, trainer.schedule_train, draws,
                              [k for k, _ in rep["worst_leaves"]],
                              {"ddp": saved["grads"], "one_process": grads},
                              dropout_seed=step_seed(trainer.seed, 0, 1))
    # the validation of the ranks' final weights, gathered, against this
    # process's on the same weights and global batch
    trainer.model.unet.load_state_dict(saved["params"], strict=True)
    with _outputs(DiffusionTrainer, "sample_batch") as fields:
        val = run_validation(opt, _GlobalVal(parts), trainer, max_batches=1)
    val_rel = max(abs(ranks[r]["val"][k] - v) / max(abs(v), 1e-30)
                  for r in range(DDP_RANKS) for k, v in val.items())
    sr_rel = rel_rmse(saved["sr"], fields[0])
    line = {"phase": "ddp_gloo", "backend": "gloo", "ranks": DDP_RANKS, "device": "cuda:0",
            "why_gloo": "NCCL refuses two ranks on one card",
            "batch_per_rank": DDP_LOCAL_BATCH, "global_batch": DDP_RANKS * DDP_LOCAL_BATCH,
            "steps": DDP_GLOO_STEPS, "sec": sec, "sec_one_process": sec_one_process,
            "rank_stages_sec": [x["stages_sec"] for x in ranks],
            "losses": ranks[0]["losses"], "one_process_losses": losses,
            "loss_rel_diff": loss_rel, **rep,
            "params_bit_identical": ranks[0]["params_sha256"] == ranks[1]["params_sha256"],
            "val": ranks[0]["val"], "one_process_val": val, "val_rel_diff": val_rel,
            "val_fields_rel_rmse": sr_rel,
            "rank_step_host_ms": [x["step_host_ms"] for x in ranks],
            "step_host_ms_note": "a correctness run: gloo reduces through the host",
            "launches": [x["launches"] for x in ranks],
            "plain_calls": [x["plain_calls"] for x in ranks],
            "bounds": {"loss": 1e-4, "grad": 1e-3, "val": 1e-4, "val_fields": 1e-4},
            "float64": diag}
    emit(line)
    check(all(x["n_train"] == ranks[0]["n_train"] for x in ranks), "the ranks' strides differ")
    check(loss_rel <= 1e-4, f"the 2-rank losses differ from one process's by {loss_rel}")
    check(rep["worst_grad_rel_rmse"] <= 1e-3,
          f"the reduced gradient of {rep['worst_leaf']} differs by "
          f"{rep['worst_grad_rel_rmse']} (relative RMSE)")
    check(line["params_bit_identical"], "the two ranks' parameters differ")
    check(sr_rel <= 1e-4, f"the gathered validation fields differ by {sr_rel} (relative RMSE)")
    check(val_rel <= 1e-4, f"the gathered validation's metrics differ by {val_rel}")
    for x in ranks:
        check(all(v > 0 for v in x["launches"].values()),
              f"a kernel was not launched in a rank: {x['launches']}")
        check(sum(x["plain_calls"].values()) == 0, f"the plain versions ran: {x['plain_calls']}")
    del trainer, saved
    torch.cuda.empty_cache()
    return {k: sum(x["launches"][k] for x in ranks) for k in ranks[0]["launches"]}


def run_ddp(torch, workdir, device, phase6) -> dict:
    """Phase 14: (b)'s ranks start and read their data while (a) runs, then
    (b); the launches of (a)'s DDP run and (b)'s ranks, summed (a main-path
    run)."""
    with open(phase6["config"]) as f:
        cfg = json.load(f)
    cfg["data"].update(batch_size=DDP_LOCAL_BATCH, val_batch_size=DDP_LOCAL_BATCH)
    cfg_b = _write_config(workdir, "ddp_gloo", cfg)
    procs = _start_gloo_ranks(workdir, cfg_b)
    try:
        a = run_ddp_nccl(torch, workdir, phase6)
        b = run_ddp_gloo(torch, workdir, device, cfg_b, procs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return {k: a[k] + b[k] for k in a}


# phase 15: the evaluation path on phase 6's checkpoint and a week's tree
QUALITY_DATES = ["--data-min", "2017-01-01-00", "--data-max", "2017-01-08-00",
                 "--train-min", "2017-01-01-00", "--train-max", "2017-01-07-00",
                 "--val-min", "2017-01-07-00", "--val-max", "2017-01-08-00"]
# batch 4, phase 6's: cuDNN times its algorithms once per shape (phase 6's
# first step, ~25 s), and a new training batch would time them again (40 s
# of 72 s on an H100 at batch 8: PERF.md, the evaluation path)
QUALITY_ARGS = ["--arch", "phydiff", "--batch", str(TRAIN_BATCH), "--val-batches", "1",
                *QUALITY_DATES]


def migrate_phase6(torch, workdir, device, phase6) -> dict:
    """15(a): phase 6's step-20 checkpoint in the reference's layout
    (`denoise_fn.` + the UNet, the twelve schedule buffers of the train
    schedule) as I20_E<epoch>_gen.pth, through
    `convert_torch_checkpoint.main` on the card: the UNet bit for bit,
    the counters, a fresh Adam state."""
    from srewd_tpu_torch import convert_torch_checkpoint
    from srewd_tpu_torch.configs.config import load_commented_json
    from srewd_tpu_torch.training.checkpoint import CheckpointManager
    from srewd_tpu_torch.utils.torch_convert import reference_checkpoint

    step, epoch = CheckpointManager.parse_counters(phase6["checkpoint"])
    state = CheckpointManager.restore(phase6["checkpoint"], map_location="cpu")
    opt = load_commented_json(phase6["config"])
    gen = os.path.join(workdir, "reference", f"I{step}_E{epoch}_gen.pth")
    os.makedirs(os.path.dirname(gen), exist_ok=True)
    torch.save(reference_checkpoint("phydiff", state["params"],
                                    opt["model"]["beta_schedule"]["train"]), gen)
    t0 = time.perf_counter()
    path = convert_torch_checkpoint.main(["-c", phase6["config"], "--gen", gen, "--out",
                                          os.path.join(workdir, "converted"),
                                          "--device", str(device)])
    sec = time.perf_counter() - t0
    conv = CheckpointManager.restore(path, map_location="cpu")
    differ = [k for k, v in state["params"].items()
              if k not in conv["params"] or not torch.equal(conv["params"][k], v)]
    line = {"phase": "quality_migrate", "gen": os.path.relpath(gen, workdir),
            "checkpoint": os.path.relpath(path, workdir), "sec": sec,
            "tensors": len(state["params"]), "tensors_differing": differ[:8],
            "counters": [conv["step"], conv["epoch"]], "adam_state_entries": len(
                conv["opt_state"]["state"]), "ema": conv.get("ema_params") is not None}
    emit(line)
    check(set(conv["params"]) == set(state["params"]) and not differ,
          f"the migrated UNet differs from phase 6's: {differ[:8]}")
    check((conv["step"], conv["epoch"]) == (step, epoch) == (20, epoch),
          f"counters {conv['step']}, {conv['epoch']}, expected 20, {epoch}")
    check(not conv["opt_state"]["state"], "the migrated checkpoint's Adam state is not fresh")
    return {"checkpoint": path}


@contextlib.contextmanager
def _recorded_rows(torch):
    """While open, quality_e2e's `evaluate` and `bicubic_metrics` calls are
    recorded as main makes them: each row's settings, unrounded metrics, SR
    fields (through `sample=`, the call it makes by default), launches and
    plain calls; the bicubic row's data handler and the launches before it
    (the training's)."""
    from srewd_tpu_torch import quality_e2e

    seen = {"rows": []}
    orig_eval, orig_bic = quality_e2e.evaluate, quality_e2e.bicubic_metrics

    def counts():
        torch.cuda.synchronize()
        return read_counts()

    def evaluate(trainer, dh, sampler_kwargs, **kw):
        fields = []

        def sample(batch, fold, use_ema):
            out = trainer.sample_batch(batch, use_ema=use_ema, fold=fold)
            fields.append(out.clone())
            return out

        (k0, p0), t0 = counts(), time.perf_counter()
        out = orig_eval(trainer, dh, sampler_kwargs, sample=sample, **kw)
        (k1, p1), sec = counts(), time.perf_counter() - t0
        seen["trainer"] = trainer
        seen["rows"].append({"kw": dict(sampler_kwargs), **kw, "metrics": out["metrics"],
                             "fields": fields, "sec": sec,
                             "launches": {k: k1[k] - k0[k] for k in k1},
                             "plain": {k: p1[k] - p0[k] for k in p1}})
        return out

    def bicubic_metrics(dh, n_batches, device):
        seen["train_launches"], seen["train_plain"] = counts()
        seen["dh"], seen["n_batches"] = dh, n_batches
        seen["bicubic"] = orig_bic(dh, n_batches, device)
        return seen["bicubic"]

    quality_e2e.evaluate, quality_e2e.bicubic_metrics = evaluate, bicubic_metrics
    try:
        yield seen
    finally:
        quality_e2e.evaluate, quality_e2e.bicubic_metrics = orig_eval, orig_bic


def metric_rel(got: dict, want: dict) -> dict:
    """Relative difference of each Kelvin metric; MR, a signed mean that can
    sit near 0 K, relative to max(|MR|, RMSE) (|MR| <= RMSE always)."""
    return {k: abs(got[k] - v) / max(abs(v), want["RMSE"] if k == "MR" else 0.0, 1e-30)
            for k, v in want.items()}


def _unet_calls(row, schedule) -> int:
    """UNet calls of a DDIM or DPM row: one per step of its plan (the tau
    spacing can merge steps), a chain per batch and member."""
    from srewd_tpu_torch.diffusion.gaussian import chain_plan

    kw = row["kw"]
    plan = chain_plan(schedule, kw["sampler"], steps=int(kw["ddim_steps"]),
                      eta=float(kw.get("ddim_eta", 0.0)),
                      tau_spacing=kw.get("tau_spacing", "linspace"))
    return plan.n_steps * row["n_batches"] * row["ensemble"]


def run_quality(torch, workdir, device, phase6, per_call) -> dict:
    """Phase 15: the evaluation path. (a) migrate_phase6. (b)
    `quality_e2e.main` at full width (phydiff, 128x256): 40 steps at batch
    4, EMA from step 20, then the bicubic, DDIM-50 and DPM-25 rows (noclip,
    noclip-ema) on one val batch; every loss finite, K1, K2, K3 and its
    backward launched in the training and K1 and K3 exactly (UNet calls) x
    (their calls per UNet call) in each row, no plain version; every JAX
    row label with finite metrics; the bicubic row within 1e-5 relative of
    bicubic_metrics on the CPU; the dpm-25-noclip row recomputed inside
    reference_ops() on the same weights and noise: the residual fields
    within 1e-3 relative RMSE, each Kelvin metric within 1e-3 relative
    (`metric_rel`).
    (c) `--reuse-checkpoint` of (a)'s converted and of phase 6's own
    checkpoint, DPM-25 noclip: the two rows' fields bit for bit and their
    metrics equal. `per_call`: K1 and K3 calls per phydiff UNet call."""
    from srewd_tpu_torch import quality_e2e
    from srewd_tpu_torch.ops import reference_ops
    from srewd_tpu_torch.ops.resize import bicubic_up4

    t_start = time.perf_counter()
    migrated = migrate_phase6(torch, workdir, device, phase6)
    args = [*QUALITY_ARGS, "--device", str(device)]
    qwork = os.path.join(workdir, "quality")
    torch.cuda.empty_cache()

    reset_counts()
    t0 = time.perf_counter()
    with _recorded_rows(torch) as seen:
        out = quality_e2e.main(
            [*args, "--iters", "40", "--samplers", "ddim,dpm", "--variants", "noclip,ema",
             "--ema-start", "20", "--ema-decay", "0.9", "--workdir", qwork,
             "--out", os.path.join(qwork, "QUALITY_smoke.json")])
    sec_main = time.perf_counter() - t0
    launches, plain = read_counts()
    labels = ["ddim-50-noclip", "ddim-50-noclip-ema", f"dpm-{DPM_STEPS}-noclip",
              f"dpm-{DPM_STEPS}-noclip-ema"]
    rows = dict(zip(labels, seen["rows"]))
    trainer, dh = seen["trainer"], seen["dh"]
    train_launches = seen["train_launches"]
    bic_cpu = quality_e2e.bicubic_metrics(dh, seen["n_batches"], "cpu")
    bic_rel = metric_rel(seen["bicubic"], bic_cpu)
    row_counts = {}
    for label, r in rows.items():
        calls = _unet_calls(r, trainer.schedule_val)
        row_counts[label] = {"unet_calls": calls, "launches": r["launches"],
                             "plain": r["plain"], "sec": r["sec"]}
        check(r["launches"]["flash_attention"] == calls * per_call["attention_calls"]
              and r["launches"]["gn_swish"] == calls * per_call["gn_calls"],
              f"{label}: K1 {r['launches']['flash_attention']} and K3 "
              f"{r['launches']['gn_swish']} launches for {calls} UNet calls of "
              f"{per_call['attention_calls']} / {per_call['gn_calls']}")
        check(r["launches"]["flash_attention_backward"] == 0
              and r["launches"]["gn_swish_backward"] == 0,
              f"{label}: a backward kernel ran while sampling: {r['launches']}")
        check(sum(r["plain"].values()) == 0, f"{label}: the plain versions ran: {r['plain']}")

    # the dpm-25-noclip row again, inside reference_ops(), same weights and seed
    dpm = rows[f"dpm-{DPM_STEPS}-noclip"]
    plain_fields = []

    def plain_sample(batch, fold, use_ema):
        sr = trainer.sample_batch(batch, use_ema=use_ema, fold=fold)
        plain_fields.append(sr)
        return sr

    reset_counts()
    t0 = time.perf_counter()
    with reference_ops():
        ref = quality_e2e.evaluate(trainer, dh, dpm["kw"], use_ema=False, n_batches=1,
                                   sample=plain_sample)
    torch.cuda.synchronize()
    sec_plain = time.perf_counter() - t0
    launches_plain_side, plain_side = read_counts()
    batch = next(iter(dh.val_batches()))
    cond = bicubic_up4(torch.as_tensor(batch["LR"]).to(device))
    field_err = rel_rmse(dpm["fields"][0] - cond, plain_fields[0] - cond)
    metrics_vs_plain = metric_rel(dpm["metrics"], ref["metrics"])

    # (c) the converted checkpoint and phase 6's own, scored the same way
    scored = {}
    reset_counts()
    for name, path in (("converted", migrated["checkpoint"]), ("phase6", phase6["checkpoint"])):
        with _recorded_rows(torch) as seen_c:
            res = quality_e2e.main([*args, "--samplers", "dpm", "--variants", "noclip",
                                    "--reuse-checkpoint", path, "--workdir", qwork,
                                    "--out", os.path.join(qwork, f"QUALITY_{name}.json")])
        scored[name] = (res["samplers"][f"dpm-{DPM_STEPS}-noclip"], seen_c["rows"][0])
    launches_c, plain_c = read_counts()
    (row_conv, rec_conv), (row_own, rec_own) = scored["converted"], scored["phase6"]
    same_fields = all(torch.equal(a, b) for a, b in zip(rec_conv["fields"], rec_own["fields"]))

    total = {k: launches[k] + launches_c[k] for k in launches}
    line = {"phase": "quality", "sec_main": sec_main, "train_wall_sec": out["train_wall_sec"],
            "train_steps_per_sec": out["train_steps_per_sec"],
            "train_loss_mean100": out["train_loss_mean100"], "train_launches": train_launches,
            "rows": row_counts, "samplers": out["samplers"], "bicubic": out["bicubic"],
            "rmse_vs_bicubic": out["rmse_vs_bicubic"], "bicubic_rel_vs_cpu": bic_rel,
            "plain_side": {"sec": sec_plain, "launches": launches_plain_side,
                           "plain_calls": plain_side},
            "rel_rmse_residual_kernels_vs_plain": field_err, "bound": 1e-3,
            "metric_rel_kernels_vs_plain": metrics_vs_plain,
            "reuse": {"converted": row_conv, "phase6": row_own, "fields_equal": same_fields},
            "launches": total, "plain_calls": {k: plain[k] + plain_c[k] for k in plain},
            "sec": time.perf_counter() - t_start}
    emit(line)
    check(all(math.isfinite(v) for v in out["train_loss_mean100"]) and out["train_loss_mean100"],
          f"training losses not finite: {out['train_loss_mean100']}")
    check(all(train_launches[k] > 0 for k in train_launches),
          f"a kernel was not launched in the training: {train_launches}")
    check(sum(seen["train_plain"].values()) == 0,
          f"the plain versions ran in the training: {seen['train_plain']}")
    check(list(out["samplers"]) == labels, f"rows {list(out['samplers'])}, expected {labels}")
    check(set(out["rmse_vs_bicubic"]) == set(labels) and all(
        math.isfinite(v) for v in out["rmse_vs_bicubic"].values()),
        f"rmse_vs_bicubic: {out['rmse_vs_bicubic']}")
    check(all(math.isfinite(v) for r in (out["bicubic"], *out["samplers"].values())
              for v in r["metrics"].values()), "a row's metrics are not finite")
    check(max(bic_rel.values()) <= 1e-5, f"bicubic row vs the CPU's: {bic_rel}")
    check(sum(launches_plain_side.values()) == 0 and plain_side["attention_reference"] > 0
          and plain_side["gn_swish_reference"] > 0,
          f"the plain side launched {launches_plain_side}, called {plain_side}")
    check(field_err <= 1e-3, f"dpm-{DPM_STEPS}-noclip fields, kernels vs plain: {field_err}")
    check(max(metrics_vs_plain.values()) <= 1e-3,
          f"dpm-{DPM_STEPS}-noclip metrics: {metrics_vs_plain}")
    check(same_fields and row_conv["metrics"] == row_own["metrics"],
          f"the converted checkpoint scores {row_conv}, phase 6's {row_own}")
    check(sum(plain_c.values()) == 0, f"the plain versions ran in (c): {plain_c}")
    return total


def kernel_entry(name, route, source, replaces, tot, launches_by_phase) -> dict:
    """The kernels line's entry: `launches` sums the main-path runs (phases
    4, 6, 8, 9, 11, 12, 13, 14 and 15, each counted from 0), `launches_by_phase`
    splits them."""
    entry = {"name": name, "route": route, "source": source, "replaces": replaces,
             "launches": sum(launches_by_phase.values()),
             "launches_by_phase": launches_by_phase, "max_abs_err": tot["f32_err"],
             "max_abs_err_bf16": tot["bf16_err"], "ms": tot["ms"], "plain_ms": tot["plain_ms"],
             "bound_ms": tot["bound_ms"], "bound_by": tot["bound_by"],
             "bound_ms_cuda_cores": tot["bound_ms_cuda_cores"], "library_ms": tot["library_ms"]}
    for key in ("pct_of_bound", "device_ms", "device_pct_of_bound", "library_ms_covers",
                "torch_two_calls_ms"):
        if key in tot:
            entry[key] = tot[key]
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
    stress = argv[1] if len(argv) == 2 and argv[0] == "--stress" else None
    bf16_steps = argv[1] if len(argv) == 2 and argv[0] == "--bf16-step" else None
    worker = argv[1] if len(argv) >= 3 and argv[0] == "--worker" else None
    if argv not in ([], ["--profile"], ["--train-kernels"], ["--serve"], ["--ddp"],
                    ["--quality"]) and not (
            (stress or bf16_steps or "").isdigit()) and worker not in ("train-main", "gloo-step"):
        print(f"chip_smoke: unknown arguments {argv}; the options are --profile, "
              "--train-kernels, --serve, --ddp, --quality, --stress N and --bf16-step N",
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
    if worker == "train-main":  # phase 14's ranks: no lines of their own
        return worker_train_main(argv[2], argv[3], argv[4:])
    if worker == "gloo-step":
        return worker_gloo_step(*argv[2:])
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    mode = "".join("_" + a.lstrip("-") for a in argv)  # one file per mode
    KEEP["file"] = open(os.path.join(REPO, "chiprun_out", f"chip_smoke{mode}.jsonl"), "w")
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
    if argv == ["--profile"]:
        profile_unet(torch, device)
        say(smi)
        return 0
    if bf16_steps:
        from srewd_tpu_torch.cli import cuda_numerics

        cuda_numerics(device, training=True)
        for seed in range(3, 3 + int(bf16_steps)):
            compare_bf16_step(torch, device, seed)
        say(smi)
        return 0
    if argv == ["--ddp"]:
        with tempfile.TemporaryDirectory(dir=BUILD) as workdir:
            phase6 = run_train_slice(torch, workdir, device)
            run_ddp(torch, workdir, device, phase6)
        say(smi)
        return 0
    if argv == ["--quality"]:
        a, n = main_path_shapes(torch, full_width_model(torch, "phydiff", device), device)
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory(dir=BUILD) as workdir:
            phase6 = run_train_slice(torch, workdir, device)
            run_quality(torch, workdir, device, phase6,
                        {"attention_calls": sum(a.values()), "gn_calls": sum(n.values())})
        say(smi)
        return 0

    attn_shapes, gn_shapes, per_arch = arch_shapes(torch, device)
    emit({"phase": "shapes", "archs": list(per_arch),
          "attention": [[kind, n, d, c] for (kind, n, d), c in sorted(attn_shapes.items())],
          "gn_swish": [[list(s), g, sw, c] for (s, g, sw), c in sorted(gn_shapes.items())],
          "added_by_resdiff_srdiff_physrdiff": sum(
              len(per_arch[a]["shapes_added"]) for a in ("resdiff", "srdiff", "physrdiff"))})
    if argv == ["--train-kernels"]:
        train_kernel_table(torch, attn_shapes, gn_shapes, device)
        with tempfile.TemporaryDirectory(dir=BUILD) as workdir:
            profile_train_steps(torch, workdir, device)
        say(smi)
        return 0
    if argv == ["--serve"]:
        with tempfile.TemporaryDirectory(dir=BUILD) as workdir:
            phase6 = run_train_slice(torch, workdir, device)
            run_serving(torch, workdir, device, phase6, per_arch, attn_shapes, gn_shapes)
        say(smi)
        return 0
    kernels = {**compare_attention(torch, attn_shapes, device),
               **compare_gn(torch, gn_shapes, device)}
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(dir=BUILD) as workdir:
        launches_sample, _ = run_slice(torch, workdir)
        compare_slice(torch, device)
        torch.cuda.empty_cache()
        phase6 = run_train_slice(torch, workdir, device)
        if stress:
            stress_step(torch, device, int(stress))
            say(smi)
            return 0
        compare_train_step(torch, device)
        pre = run_pretrain(torch, workdir, device)
        launches_archs, f32_speed = run_archs(torch, workdir, device, pre["checkpoints"],
                                              per_arch)
        compare_archs(torch, device)
        f32_speed["phydiff"] = phase6["step"]["steps_per_sec"]
        launches_bf16 = run_bf16_training(torch, workdir, device, per_arch, pre["checkpoints"],
                                          f32_speed)
        launches_bench = run_bench_twins(torch, workdir, device)
        launches_serve = run_serving(torch, workdir, device, phase6, per_arch, attn_shapes,
                                     gn_shapes)
        launches_ddp = run_ddp(torch, workdir, device, phase6)
        torch.cuda.empty_cache()
        launches_quality = run_quality(torch, workdir, device, phase6, per_arch["phydiff"])

    by_phase = {"sample_phydiff": launches_sample, "train_phydiff": phase6["launches"],
                "pretrain": pre["launches"], "archs": launches_archs,
                "train_bf16": launches_bf16, "bench": launches_bench, "serve": launches_serve,
                "ddp": launches_ddp, "quality": launches_quality}

    def entry(name, source, replaces):
        return kernel_entry(name, "cuda", source, replaces, kernels[name],
                            {k: v.get(name, 0) for k, v in by_phase.items()})

    emit({"kernels": [
        entry("flash_attention", "srewd_tpu_torch/csrc/flash_attention.cu",
              "srewd_tpu/ops/flash_attention.py:95"),
        entry("flash_attention_backward", "srewd_tpu_torch/csrc/flash_attention_bwd.cu",
              "srewd_tpu/ops/flash_attention.py:173"),
        entry("gn_swish", "srewd_tpu_torch/csrc/gn_swish.cu",
              "srewd_tpu/ops/pallas_fused.py:149"),
        entry("gn_swish_backward", "srewd_tpu_torch/csrc/gn_swish.cu",
              "srewd_tpu/ops/pallas_fused.py:211"),
    ]})
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main(sys.argv[1:])
    except Exception:
        traceback.print_exc()
        keep(traceback.format_exc())
        rc = 1
    sys.exit(rc)
