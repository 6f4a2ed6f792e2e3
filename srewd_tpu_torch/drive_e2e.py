"""End-to-end drive of the port's entry points on synthetic data (twin of
scripts/drive_e2e.py):

    python -m srewd_tpu_torch.drive_e2e [--device cpu] [--keep] [--workdir DIR]

A 5-day 32x64 / 8x16 synthetic tree -> a toy sr3 config (inner 16, EMA on,
`train.save_visualizations`) -> `train` for 16 steps (the checkpoint, the
loss lines and the validation plates under results/) -> `sample -d` from
the checkpoint, plain, `--use-ema` and `--sampler ddim` (PNG maps that
decode, a Kelvin field in a plausible range) -> `export_sampler` and
`load_sampler` (a field of 3 from the artifact) -> `train -p val` from the
checkpoint (metrics in val.log, plates at 220-315 K) -> SimpleCNN
pretraining for 2 epochs (the E1 checkpoint and its result plates) -> RRDB
pretraining for an epoch and an srdiff run of 4 steps conditioned on it.
Prints `E2E DRIVE OK ...` and returns a summary.

Each entry point's `main` runs in this process, as `python -m` would run
it. `--device` defaults to the card, as every entry point does.
"""

from __future__ import annotations

import argparse
import copy
import glob
import json
import os
import shutil
import tempfile

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m srewd_tpu_torch.drive_e2e")
    p.add_argument("--device", default="cuda")
    p.add_argument("--keep", action="store_true", help="keep the temp working directory")
    p.add_argument("--workdir", default=None, help="work here (default: a new temp dir)")
    return p.parse_args(argv)


def toy_config(work: str, dataroot: str) -> dict:
    return {
        "name": "e2e_drive",
        "phase": "train",
        "path": {"experiments_folder_path": os.path.join(work, "experiments"),
                 "log": "logs", "tb_logger": "tb_logger", "results": "results",
                 "checkpoint": "checkpoint", "resume_state": None},
        "data": {
            "name": "WeatherBench", "dataroot": dataroot,
            "batch_size": 8, "val_batch_size": 4, "num_workers": 0, "use_shuffle": True,
            "train_min_date": "2017-01-01-00", "train_max_date": "2017-01-04-00",
            "transformation": "GlobalStandardScaling",
            "months_subset": [1], "transform_groups": {"january": [1]},
            "val_min_date": "2017-01-04-00", "val_max_date": "2017-01-04-08",
            "variables": ["t2m"], "height": 32,
        },
        "model": {
            "model_name": "diffusion", "architecture": "sr3", "finetune_norm": False,
            "unet": {"in_channel": 2, "out_channel": 1, "inner_channel": 16,
                     "norm_groups": 8, "channel_multiplier": [1, 2],
                     "attn_res": [16], "res_blocks": 1, "dropout": 0.0},
            "beta_schedule": {
                "train": {"schedule": "linear", "n_timestep": 30,
                          "linear_start": 1e-6, "linear_end": 0.01},
                "val": {"schedule": "linear", "n_timestep": 30,
                        "linear_start": 1e-6, "linear_end": 0.01}},
            "diffusion": {"image_height": 32, "image_width": 64,
                          "image_channels": 1, "channels": 1, "conditional": True},
            "pretrained_model": {"model_path": None, "lock_weights": True},
        },
        "train": {"save_visualizations": True, "n_iter": 16, "val_freq": 16,
                  "full_val_freq": 16, "save_checkpoint_freq": 16, "print_freq": 8,
                  "optimizer": {"type": "adam", "lr": 0.001},
                  "ema_scheduler": {"enabled": True, "ema_decay": 0.99,
                                    "step_start_ema": 0, "use_for_val": True}},
    }


def _write(work: str, name: str, cfg: dict) -> str:
    path = os.path.join(work, f"{name}.json")
    with open(path, "w") as f:
        json.dump(cfg, f, indent=2)
    return path


def _run_dir(work: str, name: str) -> str:
    runs = sorted(glob.glob(os.path.join(work, "experiments", "experiments", f"{name}_*")))
    if not runs:
        raise RuntimeError(f"no experiment directory for {name}")
    return runs[-1]


def _check_pngs(paths: list, shape: tuple) -> None:
    from .training.visualization import read_plate

    if not paths:
        raise RuntimeError("no PNG written")
    for path in paths:
        pixels, layout = read_plate(path)
        if pixels.shape[0] != shape[0] or any(
                (p["h"], p["w"]) != shape for p in layout["panels"]):
            raise RuntimeError(f"{path}: {pixels.shape}, panels {layout['panels']}")


def drive(work: str, device: str) -> dict:
    from . import export_sampler, make_synthetic_data, pretrain, sample, train
    from .serving.export import load_sampler
    from .training.visualization import read_plate

    dataroot = os.path.join(work, "data")
    make_synthetic_data.main(["--root", dataroot, "--min-date", "2017-01-01-00",
                              "--max-date", "2017-01-06-00", "--lr", "8", "16",
                              "--hr", "32", "64"])
    cfg = toy_config(work, dataroot)
    cfg_path = _write(work, "e2e", cfg)
    dev = ["--device", device]

    run = train.main(["-p", "train", "-c", cfg_path, *dev])
    exp = _run_dir(work, "e2e_drive")
    ckpts = sorted(glob.glob(os.path.join(exp, "checkpoint", "I*_E*")))
    if not ckpts:
        raise RuntimeError(f"no checkpoint written under {exp}")
    with open(os.path.join(exp, "logs", "train.log")) as f:
        if "l_pix" not in f.read():
            raise RuntimeError("the train log has no loss lines")
    plates = sorted(glob.glob(os.path.join(exp, "results", "*", "*_16_1_*.png")))
    _check_pngs(plates, (32, 64))

    kelvin = {}
    renders = {"plain": [], "ema": ["--use-ema"], "ddim": ["--sampler", "ddim",
                                                          "--ddim-steps", "10"]}
    for tag, extra in renders.items():
        out = sample.main(["-c", cfg_path, "-m", ckpts[-1], "-d", "2017-01-05-00",
                           "-o", os.path.join(work, f"samples_{tag}"), *extra, *dev])
        _check_pngs(out["saved"], (32, 64))
        sr = out["kelvin"]["SR"]
        if sr.shape != (1, 32, 64, 1) or not np.isfinite(sr).all() or not (
                180 < sr.min() and sr.max() < 360):
            raise RuntimeError(f"sample -d {tag}: SR {sr.shape} in [{sr.min()}, {sr.max()}]")
        kelvin[tag] = [float(sr.min()), float(sr.max())]

    art = os.path.join(work, "e2e.srexport")
    export_sampler.main(["-c", cfg_path, "-m", ckpts[-1], "-o", art, *dev])
    fn = load_sampler(art)
    lr = 278 + 8 * np.random.default_rng(0).standard_normal((3, 8, 16, 1)).astype("float32")
    sr = fn(lr, months=np.ones(3, "int32"), seed=1).cpu().numpy()
    if sr.shape != (3, 32, 64, 1) or not np.isfinite(sr).all():
        raise RuntimeError(f"the loaded artifact gave {sr.shape}")

    vcfg = copy.deepcopy(cfg)
    vcfg["name"] = "e2e_val"
    vcfg["path"]["resume_state"] = ckpts[-1]
    val = train.main(["-p", "val", "-c", _write(work, "e2e_val", vcfg), *dev])
    with open(os.path.join(exp, "logs", "val.log")) as f:
        if "RMSE" not in f.read():
            raise RuntimeError("the val phase wrote no metrics")
    # the val phase renders at the same epoch and step as the run's last
    # validation, over its plates, at the fixed 220-315 K range
    val_plates = sorted(glob.glob(os.path.join(exp, "results", "*", "*_16_1_SR_0.png")))
    _check_pngs(val_plates, (32, 64))
    if any((p["vmin"], p["vmax"]) != (220, 315)
           for p in read_plate(val_plates[-1])[1]["panels"]):
        raise RuntimeError("the val phase's plates are not at 220-315 K")

    pcfg = copy.deepcopy(cfg)
    pcfg["name"] = "e2e_pretrain"
    pcfg["model"] = {"name": "SimpleSR", "in_channel": 1, "out_channel": 1}
    pcfg["train"]["epoch"] = 2
    records = pretrain.main(["-p", "train", "-c", _write(work, "e2e_pretrain", pcfg), *dev])
    pexp = _run_dir(work, "e2e_pretrain")
    if not glob.glob(os.path.join(pexp, "checkpoint", "pretrain_*_E1")):
        raise RuntimeError(f"no pretrain checkpoint under {pexp}")
    result_plates = sorted(glob.glob(os.path.join(pexp, "results", "result_*.png")))
    _check_pngs(result_plates, (32, 64))

    rcfg = copy.deepcopy(cfg)
    rcfg["name"] = "e2e_rrdb"
    rcfg["model"] = {"name": "RRDBNet", "in_channel": 1, "out_channel": 1,
                     "hidden_size": 32, "num_block": 2}
    rcfg["train"]["epoch"] = 1
    (rrdb,) = pretrain.main(["-p", "train", "-c", _write(work, "e2e_rrdb", rcfg), *dev])

    scfg = copy.deepcopy(cfg)
    scfg["name"] = "e2e_srdiff"
    scfg["model"]["architecture"] = "srdiff"
    scfg["model"]["unet"]["in_channel"] = 1
    scfg["model"]["pretrained_model"] = {"model_path": rrdb["checkpoint"], "lock_weights": True,
                                         "hidden_size": 32, "num_block": 2}
    scfg["train"].update(n_iter=4, val_freq=4, full_val_freq=4, save_checkpoint_freq=4,
                         print_freq=2, save_visualizations=False)
    srdiff = train.main(["-p", "train", "-c", _write(work, "e2e_srdiff", scfg), *dev])
    if not glob.glob(os.path.join(_run_dir(work, "e2e_srdiff"), "checkpoint", "I4_E*")):
        raise RuntimeError("the srdiff run wrote no step-4 checkpoint")

    summary = {"experiment": exp, "train_losses": [v for _, v in run["losses"]],
               "train_plates": len(plates), "sample_kelvin": kelvin,
               "val_rmse": val["RMSE"], "val_plates": len(val_plates),
               "pretrain_losses": [r["train_loss"] for r in records],
               "pretrain_plates": len(result_plates),
               "srdiff_losses": [v for _, v in srdiff["losses"]]}
    print(f"E2E DRIVE OK — experiment: {exp}, {len(plates)} train plates, "
          f"{len(val_plates)} val plates, pretrain: {len(result_plates)} plates, "
          "srdiff+rrdb handoff OK", flush=True)
    return summary


def main(argv=None) -> dict:
    args = parse_args(argv)
    work = args.workdir or tempfile.mkdtemp(prefix="srewd_torch_e2e_")
    os.makedirs(work, exist_ok=True)
    try:
        return drive(work, args.device)
    finally:
        if not args.keep and args.workdir is None:
            shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
