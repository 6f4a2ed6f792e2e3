"""End-to-end quality run of the port: a trained model's super-resolution
against bicubic interpolation, in Kelvin (twin of scripts/quality_e2e.py).

    python -m srewd_tpu_torch.quality_e2e [--arch phydiff] [--iters 3000] \\
        [--out build/QUALITY_torch.json] [--device cuda]
    python -m srewd_tpu_torch.quality_e2e --reuse-checkpoint <dir>/I{iter}_E{epoch} ...

Trains the full-size model (`sr3_base_train.json` with `--arch`, dropout 0)
on the synthetic WeatherBench tree (data/store.py
make_synthetic_weatherbench; HR carries sub-grid structure that LR's 4x
block mean keeps recoverable and bicubic smears), with the train split
resident on the device (data/device_cache.py) and the steps dispatched
without waiting (`train_on_batch_async`, one read per 100 losses). Then it
scores held-out dates with the six validation metrics in Kelvin: the
bicubic x4 row (`bicubic_metrics`), and for each sampler (ddpm over the
val schedule, ddim, dpm) the reference's x0 clamp (`clip`), `noclip`, and
noclip with the EMA weights (`noclip-ema`); optionally a DDPM ensemble-mean
row and an EMA sweep over the fast samplers' steps, spacings and eta
(`--sweep-fast`). Each row is `evaluate`; the JSON (keys and row labels of
the JAX script, plus `device`) is rewritten atomically after every row, so
`scripts/summarize_quality.py` renders it, partial or whole.

`--reuse-params` reads `<workdir>/params.pt` of an earlier run (the port's
format: the UNet's state dict under `params`, the EMA's under
`ema_params`, and the encoder's under `encoder_params` /
`ema_encoder_params` where there is one); `--reuse-checkpoint` reads a port
checkpoint directory, trained by `srewd_tpu_torch.train` or converted by
`srewd_tpu_torch.convert_torch_checkpoint`. Without EMA weights in the file
the EMA rows are left out.

Noise: batch i of a row samples at fold i + 1 (`DiffusionTrainer.sample_batch`);
member e of batch i of an ensemble at `ensemble_fold(i, e, ...)`, a fold of
its own for every (batch, member) pair (the JAX script's (i + 1) * 131 + e
repeats beyond 131 members). `evaluate(sample=)` replaces the sampling call
(tests pass in the JAX package's draws).

`--device` defaults to the card; a CUDA request without one raises.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m srewd_tpu_torch.quality_e2e")
    ap.add_argument("--iters", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--val-batches", type=int, default=4)
    ap.add_argument("--arch", default="sr3")
    ap.add_argument("--tval", type=int, default=1000,
                    help="val-schedule n_timestep (ddpm chain length)")
    ap.add_argument("--ddim-steps", type=int, default=50)
    ap.add_argument("--dpm-steps", type=int, default=25)
    ap.add_argument("--hr-shape", type=int, nargs=2, default=(128, 256),
                    help="HR grid (smoke tests can shrink it)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--workdir", default=None,
                    help="pin the work directory (default: fresh tempdir)")
    ap.add_argument("--reuse-params", default=None,
                    help="skip training; load the weights (+EMA) from this .pt "
                         "(written by a previous run as <workdir>/params.pt)")
    ap.add_argument("--reuse-checkpoint", default=None,
                    help="skip training; load the weights (+EMA) from a port "
                         "I{iter}_E{epoch} checkpoint dir (trained or converted)")
    ap.add_argument("--spectrum", default="t2m",
                    help="synthetic HR texture mode (data/store.py): t2m or tiles")
    ap.add_argument("--spacing", default="logsnr",
                    help="fast-sampler timestep spacing for the ddim/dpm rows "
                         "(gaussian.select_taus): logsnr|linspace|quad|trailing")
    ap.add_argument("--eta", type=float, default=0.0,
                    help="DDIM eta for the ddim rows (1.0 = ancestral-like)")
    ap.add_argument("--sweep-fast", action="store_true",
                    help="add an EMA-noclip sweep grid over the fast samplers: "
                         "{ddim,dpm} x --sweep-steps x --sweep-spacings (+ eta=1 for ddim)")
    ap.add_argument("--sweep-steps", default="25,50",
                    help="comma list of step counts for the --sweep-fast grid")
    ap.add_argument("--sweep-spacings", default="linspace,quad,logsnr,trailing",
                    help="comma list of tau spacings for the --sweep-fast grid")
    ap.add_argument("--data-min", default="2017-01-01-00")
    ap.add_argument("--data-max", default="2017-02-01-00")
    ap.add_argument("--train-min", default="2017-01-01-00")
    ap.add_argument("--train-max", default="2017-01-26-00")
    ap.add_argument("--val-min", default="2017-01-26-00")
    ap.add_argument("--val-max", default="2017-01-31-23")
    ap.add_argument("--ema-decay", type=float, default=0.999,
                    help="EMA decay for the -ema eval rows")
    ap.add_argument("--ema-start", type=int, default=None,
                    help="EMA start step (default iters//2)")
    ap.add_argument("--variants", default="clip,noclip,ema",
                    help="comma subset of clip,noclip,ema eval rows")
    ap.add_argument("--samplers", default="ddpm,ddim,dpm",
                    help="comma subset of the header sampler rows")
    ap.add_argument("--ensemble-row", type=int, default=0,
                    help="if >1, add a ddpm-noclip-ema ensemble-mean row averaging "
                         "N independent chains per batch")
    ap.add_argument("--inner-channel", type=int, default=None,
                    help="shrink the UNet trunk (CPU smoke runs)")
    ap.add_argument("--res-blocks", type=int, default=None)
    ap.add_argument("--pretrained-model", default=None,
                    help="encoder pretrain checkpoint (srdiff/physrdiff need one to "
                         "build the RRDB; --reuse-checkpoint then overwrites it)")
    ap.add_argument("--pretrained-num-block", type=int, default=None,
                    help="RRDB depth matching the encoder checkpoint")
    ap.add_argument("--out", default="build/QUALITY_torch.json")
    return ap.parse_args(argv)


def build_opt(args, dataroot: str) -> dict:
    """`sr3_base_train.json` patched as the JAX script patches it: the
    architecture, dropout 0, the encoder, the widths, the data split, months
    and one scaler group per month of the generated range, the val schedule,
    the EMA window and the HR shape. The trainer writes no checkpoint."""
    from .configs.config import load_commented_json
    from .data.timeindex import hourly_range, months_of

    hr_shape = tuple(args.hr_shape)
    opt = load_commented_json(str(REPO / "configs/experiment_configs/sr3/sr3_base_train.json"))
    opt["model"]["architecture"] = args.arch
    opt["model"]["unet"]["dropout"] = 0.0
    if args.pretrained_model:
        opt["model"]["pretrained_model"] = {
            "model_path": args.pretrained_model, "lock_weights": True}
        if args.pretrained_num_block:
            opt["model"]["pretrained_model"]["num_block"] = args.pretrained_num_block
    if args.inner_channel:
        opt["model"]["unet"]["inner_channel"] = args.inner_channel
    if args.res_blocks:
        opt["model"]["unet"]["res_blocks"] = args.res_blocks
    opt["data"].update(
        dataroot=dataroot, batch_size=args.batch, val_batch_size=args.batch,
        train_min_date=args.train_min, train_max_date=args.train_max,
        val_min_date=args.val_min, val_max_date=args.val_max)
    months = sorted(set(months_of(hourly_range(args.data_min, args.data_max)).tolist()))
    opt["data"]["months_subset"] = months
    opt["data"]["transform_groups"] = [[m] for m in months]
    opt["model"]["beta_schedule"]["val"]["n_timestep"] = args.tval
    opt["train"]["ema_scheduler"] = {
        "enabled": True,
        "step_start_ema": args.ema_start if args.ema_start is not None else args.iters // 2,
        "update_ema_every": 1,
        "ema_decay": args.ema_decay,
    }
    opt["model"]["diffusion"]["image_height"] = hr_shape[0]
    opt["model"]["diffusion"]["image_width"] = hr_shape[1]
    opt["data"]["height"] = hr_shape[0]
    opt["path"]["checkpoint"] = None
    return opt


def ensemble_fold(i: int, e: int, n_batches: int, ensemble: int) -> int:
    """The sampling fold of member e of val batch i in an ensemble row of
    n_batches batches: n_batches + 1 + i * ensemble + e. One fold per
    (batch, member) pair, none of them a single-chain row's (1..n_batches)."""
    return n_batches + 1 + i * ensemble + e


def _val_batches(dh, n_batches: int):
    for i, batch in enumerate(dh.val_batches()):
        if i >= n_batches:
            break
        yield i, batch


def _numpy(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def bicubic_metrics(dh, n_batches: int, device) -> dict:
    """The six metrics in Kelvin of bicubic x4 (ops/resize.bicubic_up4 on
    `device`) over the first n_batches val batches: the baseline row."""
    from .ops.resize import bicubic_up4
    from .training.metrics import ValidationMetrics, create_metric_dict

    vm = ValidationMetrics(create_metric_dict())
    for _, batch in _val_batches(dh, n_batches):
        inf = _numpy(bicubic_up4(torch.as_tensor(np.asarray(batch["LR"])).to(device)))
        inv = dh.inverse_transform({"INF": inf, "HR": np.asarray(batch["HR"])}, batch["months"])
        vm.update(inv["HR"], inv["INF"])
    return vm.compute_metrics()


def evaluate(trainer, dh, sampler_kwargs: dict, *, use_ema: bool = False, ensemble: int = 1,
             n_batches: int, sample=None) -> dict:
    """One row: the six metrics in Kelvin of `trainer`'s super-resolution
    with `sampler_kwargs` (set on trainer.sampler_kwargs) over the first
    n_batches val batches, as {"metrics", "wall_sec"}. With ensemble > 1
    each batch's SR is the mean of that many chains. sample(batch, fold,
    use_ema) -> SR replaces `trainer.sample_batch`."""
    from .training.metrics import ValidationMetrics, create_metric_dict

    trainer.sampler_kwargs = dict(sampler_kwargs)
    if sample is None:
        def sample(batch, fold, use_ema):
            return trainer.sample_batch(batch, use_ema=use_ema, fold=fold)

    vm = ValidationMetrics(create_metric_dict())
    t0 = time.time()
    for i, batch in _val_batches(dh, n_batches):
        if ensemble > 1:
            sr = np.mean([_numpy(sample(batch, ensemble_fold(i, e, n_batches, ensemble), use_ema))
                          for e in range(ensemble)], axis=0)
        else:
            sr = _numpy(sample(batch, i + 1, use_ema))
        inv = dh.inverse_transform({"SR": sr, "HR": np.asarray(batch["HR"])}, batch["months"])
        vm.update(inv["HR"], inv["SR"])
    return {"metrics": vm.compute_metrics(), "wall_sec": time.time() - t0}


def load_weights(trainer, state: dict) -> None:
    """The weights (and EMA) of a checkpoint or params.pt into `trainer`;
    its EMA is None where the file has none, so no EMA row scores the init."""
    model = trainer.model
    model.unet.load_state_dict(state["params"], strict=True)
    if model.encoder is not None and state.get("encoder_params") is not None:
        model.encoder.load_state_dict(state["encoder_params"], strict=True)
    ema, ema_enc = state.get("ema_params"), state.get("ema_encoder_params")
    trainer.ema = None if ema is None else {k: v.detach().clone() for k, v in ema.items()}
    trainer.ema_encoder = (None if ema is None or ema_enc is None
                           else {k: v.detach().clone() for k, v in ema_enc.items()})


def train(trainer, dh, iters: int, device, log: list) -> None:
    """`iters` steps on the device-resident train split; appends the mean of
    each 100 losses (and of the rest) to `log`."""
    from .data.device_cache import DeviceDataset

    cache = DeviceDataset(dh, device, "train")
    print(f"[train] device cache {cache.nbytes / 1e6:.0f} MB ({len(cache)} fields)", flush=True)
    t0 = time.time()
    pending = []
    step, epoch = 0, 0
    while step < iters:
        for batch in cache.batches(epoch):
            pending.append(trainer.train_on_batch_async(batch))
            step += 1
            if len(pending) >= 100:
                log.append(round(float(torch.stack(pending).mean()), 4))
                pending = []
                print(f"[train] step {step:5d}  loss(mean100) {log[-1]:.4f}"
                      f"  {step / (time.time() - t0):.2f} steps/s", flush=True)
            if step >= iters:
                break
        epoch += 1
    if pending:
        log.append(round(float(torch.stack(pending).mean()), 4))


def main(argv=None) -> dict:
    """Train (or load), score every requested row, write the JSON; returns it."""
    args = parse_args(argv)
    from .cli import build_data_handler, build_trainer, cuda_numerics, resolve_device, set_seeds
    from .data.store import make_synthetic_weatherbench
    from .training.checkpoint import CheckpointManager

    device = resolve_device(args.device)
    cuda_numerics(device, training=True)
    set_seeds(0)
    hr_shape = tuple(args.hr_shape)
    if args.workdir:
        work = Path(args.workdir)
        work.mkdir(parents=True, exist_ok=True)
    else:
        work = Path(tempfile.mkdtemp(prefix="srewd_quality_"))
    print(f"[workdir] {work}", flush=True)
    dataroot = make_synthetic_weatherbench(
        str(work / "data"), args.data_min, args.data_max,
        lr_shape=(hr_shape[0] // 4, hr_shape[1] // 4), hr_shape=hr_shape, spectrum=args.spectrum)
    opt = build_opt(args, dataroot)
    dh = build_data_handler(opt)
    trainer = build_trainer(opt, device)

    # ------------------------------------------------------------- train
    t0 = time.time()
    loss_log: list = []
    if args.reuse_checkpoint:
        state = CheckpointManager.restore(args.reuse_checkpoint, map_location=device)
        load_weights(trainer, state)
        print(f"[train] skipped — reusing {args.reuse_checkpoint} (step {state.get('step')})",
              flush=True)
    elif args.reuse_params:
        load_weights(trainer, torch.load(args.reuse_params, map_location=device,
                                         weights_only=True))
        print(f"[train] skipped — reusing {args.reuse_params}", flush=True)
    else:
        train(trainer, dh, args.iters, device, loss_log)
        state = {"params": trainer.model.unet.state_dict(), "ema_params": trainer.ema}
        if trainer.model.encoder is not None:
            state.update(encoder_params=trainer.model.encoder.state_dict(),
                         ema_encoder_params=trainer.ema_encoder)
        torch.save(state, work / "params.pt.tmp")
        os.replace(work / "params.pt.tmp", work / "params.pt")
        print(f"[train] params saved -> {work / 'params.pt'}", flush=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    train_wall = time.time() - t0

    # -------------------------------------------------------------- eval
    def rounded(metrics: dict) -> dict:
        return {k: round(v, 5) for k, v in metrics.items()}

    def eval_row(label: str, sampler_kwargs: dict, use_ema: bool = False,
                 ensemble: int = 1) -> dict:
        row = evaluate(trainer, dh, sampler_kwargs, use_ema=use_ema, ensemble=ensemble,
                       n_batches=args.val_batches)
        row = {"metrics": rounded(row["metrics"]), "wall_sec": round(row["wall_sec"], 1)}
        print(f"[eval:{label}] {row['metrics']} | wall {row['wall_sec']}s", flush=True)
        return row

    bic = rounded(bicubic_metrics(dh, args.val_batches, device))
    print(f"[eval:bicubic] {bic}", flush=True)

    sp = args.spacing
    rows: dict = {}

    def write_out(partial: bool) -> dict:
        # rewritten after every row, atomically: a run cut short keeps its rows
        out = {
            "arch": args.arch,
            "partial": partial,
            "metrics_note": (
                "RMSE/MAE/MR are the stable cross-run columns (Kelvin). "
                "PSNR/SSIM keep the reference's streaming semantics "
                "(training/metrics.py): data_range derives from the "
                "predictions, so they are parity-faithful but noisy across runs."
            ),
            "accuracy_gate_note": (
                "The port is held to the JAX package by the CPU tests "
                "(tests/test_torch_port_*.py) and its kernels to their plain "
                "versions by chip_smoke.py, not by this artifact; bicubic "
                "interpolation is the trained-quality baseline here."
            ),
            "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                       else str(device)),
            "spectrum": args.spectrum,
            "tau_spacing": sp,
            "ddim_eta": args.eta,
            "train_range": [args.train_min, args.train_max],
            "val_range": [args.val_min, args.val_max],
            "reused": args.reuse_checkpoint or args.reuse_params,
            "iters": args.iters,
            "batch": args.batch,
            "val_fields": args.val_batches * args.batch,
            "train_wall_sec": round(train_wall, 1),
            "train_steps_per_sec": round(args.iters / max(train_wall, 1e-9), 2),
            "train_loss_mean100": loss_log,
            "bicubic": {"metrics": bic},
            "samplers": rows,
            # best first: the leading row is the headline number
            "rmse_vs_bicubic": dict(sorted(
                ((label, round(r["metrics"]["RMSE"] / bic["RMSE"], 4))
                 for label, r in rows.items()),
                key=lambda kv: kv[1])),
        }
        out_path = Path(args.out)
        out_path.parent.mkdir(parents=True, exist_ok=True)
        tmp = out_path.with_suffix(".tmp")
        tmp.write_text(json.dumps(out, indent=1) + "\n")
        os.replace(tmp, out_path)
        return out

    wanted = set(args.samplers.split(","))
    samplers = {
        f"ddpm-{args.tval}": {},
        f"ddim-{args.ddim_steps}": {"sampler": "ddim", "ddim_steps": args.ddim_steps,
                                    "ddim_eta": args.eta, "tau_spacing": sp},
        f"dpm-{args.dpm_steps}": {"sampler": "dpm", "ddim_steps": args.dpm_steps,
                                  "tau_spacing": sp},
    }
    samplers = {k: v for k, v in samplers.items() if (v.get("sampler") or "ddpm") in wanted}
    # the reference's x0 clamp to [-1, 1] (clip), without it (noclip), and
    # without it on the EMA weights
    variants = set(args.variants.split(","))
    seen_ema: dict = {}  # frozen sampler kwargs -> row label, for the sweep's dedup
    for label, kw in samplers.items():
        if "clip" in variants:
            rows[label] = eval_row(label, kw)
            write_out(partial=True)
        if "noclip" in variants:
            rows[label + "-noclip"] = eval_row(label + "-noclip", {**kw, "clip_denoised": False})
            write_out(partial=True)
        if "ema" in variants and trainer.ema is not None:
            ekw = {**kw, "clip_denoised": False}
            rows[label + "-noclip-ema"] = eval_row(label + "-noclip-ema", ekw, use_ema=True)
            seen_ema[frozenset(ekw.items())] = label + "-noclip-ema"
            write_out(partial=True)

    if args.ensemble_row > 1 and trainer.ema is not None and "ddpm" in wanted:
        n = args.ensemble_row
        label = f"ddpm-{args.tval}-noclip-ema-ens{n}"
        rows[label] = eval_row(label, {"clip_denoised": False}, use_ema=True, ensemble=n)
        write_out(partial=True)

    if args.sweep_fast and trainer.ema is not None:
        grid = {}
        for steps in (int(s) for s in args.sweep_steps.split(",")):
            for spacing in args.sweep_spacings.split(","):
                for eta in (0, 1):
                    grid[f"ddim-{steps}-{spacing}-eta{eta}"] = {
                        "sampler": "ddim", "ddim_steps": steps, "tau_spacing": spacing,
                        "ddim_eta": float(eta)}
                grid[f"dpm-{steps}-{spacing}"] = {
                    "sampler": "dpm", "ddim_steps": steps, "tau_spacing": spacing}
        for label, kw in grid.items():
            ekw = {**kw, "clip_denoised": False}
            key = frozenset(ekw.items())
            if key in seen_ema:  # the same settings as a row already scored
                print(f"[sweep] skip {label} (== {seen_ema[key]})", flush=True)
                continue
            rows[label + "-noclip-ema"] = eval_row(label + "-noclip-ema", ekw, use_ema=True)
            seen_ema[key] = label + "-noclip-ema"
            write_out(partial=True)

    out = write_out(partial=False)
    print(json.dumps(out["rmse_vs_bicubic"]))
    print(f"QUALITY OK -> {args.out}")
    return out


if __name__ == "__main__":
    main()
