"""Reference-scale training run of the port (twin of
scripts/run_reference_scale.py): the reference's 200k-iteration recipe
(configs/experiment_configs/phydiff/resdiff+physics_train_example.json:
n_iter 200000, validation and a checkpoint every 10k, Adam 1e-4, EMA 0.9999
from step 5000) run through `python -m srewd_tpu_torch.train` on the
synthetic t2m WeatherBench tree.

    python -m srewd_tpu_torch.run_reference_scale --workdir W [--arch phydiff] [--device cuda]

  1. the synthetic tree under W/data (made once: a `.complete` marker);
  2. the patched config, W/config.json (`--config-only` stops here);
  3. `os.execv` of `python -m srewd_tpu_torch.train -c W/config.json -p train
     --device <device>`.

The run writes W/experiments/experiments/<name>_<ts>/{logs,checkpoint,results};
checkpoints rotate (train.checkpoint_keep), the train split is resident on
the device (train.device_data_cache) unless `--no-device-cache`, and
validation runs on the EMA weights (ema_scheduler.use_for_val).
`path.resume_state` is "auto", so a relaunch of the same command resumes
from the newest checkpoint of the experiment name. The config keeps
`save_visualizations: true`, which the port's trainer logs and skips (PNG
renders are not ported). Evaluate afterwards:

    python -m srewd_tpu_torch.quality_e2e --arch phydiff --reuse-checkpoint \\
        W/experiments/experiments/<run>/checkpoint/I200000_E<n> --sweep-fast ...
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m srewd_tpu_torch.run_reference_scale")
    ap.add_argument("--arch", default="phydiff")
    ap.add_argument("--iters", type=int, default=200000)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--val-batch", type=int, default=8)
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--spectrum", default="t2m")
    ap.add_argument("--data-min", default="2017-01-01-00")
    ap.add_argument("--data-max", default="2017-05-01-00")
    ap.add_argument("--train-min", default="2017-01-01-00")
    ap.add_argument("--train-max", default="2017-04-28-00")
    ap.add_argument("--val-min", default="2017-04-28-00")
    ap.add_argument("--val-max", default="2017-04-30-00")
    ap.add_argument("--val-freq", type=int, default=10000)
    ap.add_argument("--save-freq", type=int, default=10000)
    ap.add_argument("--print-freq", type=int, default=500)
    ap.add_argument("--checkpoint-keep", type=int, default=3)
    ap.add_argument("--ema-decay", type=float, default=0.9999,
                    help="the reference recipe's 0.9999 needs >=50k steps past "
                         "--ema-start; short runs should use 0.999")
    ap.add_argument("--ema-start", type=int, default=5000)
    ap.add_argument("--grad-clip", type=float, default=None,
                    help="global-norm gradient clip (train.optimizer.grad_clip)")
    ap.add_argument("--dropout", type=float, default=0.0,
                    help="the reference example uses 0.2")
    ap.add_argument("--pretrained-model", default=None,
                    help="encoder checkpoint path (srdiff/physrdiff)")
    ap.add_argument("--pretrained-num-block", type=int, default=None,
                    help="RRDB trunk depth of the pretrained encoder (default 17)")
    ap.add_argument("--pretrained-hidden-size", type=int, default=None)
    ap.add_argument("--config-only", action="store_true",
                    help="generate data + config, skip the training run")
    ap.add_argument("--hr-shape", type=int, nargs=2, default=(128, 256),
                    help="HR grid (CPU smoke tests can shrink it)")
    ap.add_argument("--inner-channel", type=int, default=None,
                    help="shrink the UNet trunk (CPU smoke tests)")
    ap.add_argument("--res-blocks", type=int, default=None)
    ap.add_argument("--device", default="cuda", help="forwarded to srewd_tpu_torch.train")
    ap.add_argument("--no-device-cache", action="store_true",
                    help="stream batches from the host instead of keeping the "
                         "normalized train split on the device")
    return ap.parse_args(argv)


def ensure_data(dataroot: Path, args) -> None:
    """The synthetic tree at `dataroot`, made once (its `.complete` marker)."""
    from .data.store import make_synthetic_weatherbench

    marker = dataroot / ".complete"
    if marker.exists():
        print(f"[data] reusing {dataroot}", flush=True)
        return
    print(f"[data] generating {args.spectrum} tree {args.data_min}..{args.data_max} "
          f"-> {dataroot}", flush=True)
    hh, hw = args.hr_shape
    make_synthetic_weatherbench(str(dataroot), args.data_min, args.data_max,
                                spectrum=args.spectrum, hr_shape=(hh, hw),
                                lr_shape=(hh // 4, hw // 4))
    marker.write_text("ok\n")


def build_config(args, work: Path) -> dict:
    """`sr3_base_train.json` patched to the reference recipe at --arch."""
    from .configs.config import load_commented_json
    from .data.timeindex import hourly_range, months_of

    opt = load_commented_json(str(REPO / "configs/experiment_configs/sr3/sr3_base_train.json"))
    months = sorted(set(months_of(hourly_range(args.data_min, args.data_max)).tolist()))
    opt["name"] = f"{args.arch}_refscale_{args.iters // 1000}k"
    opt["path"]["experiments_folder_path"] = str(work / "experiments")
    # a relaunch resumes from the newest I{iter}_E{epoch} of this experiment
    # name (configs/config.py); the first launch finds none and starts fresh
    opt["path"]["resume_state"] = "auto"
    opt["model"]["architecture"] = args.arch
    opt["model"]["unet"]["dropout"] = args.dropout
    if args.inner_channel:
        opt["model"]["unet"]["inner_channel"] = args.inner_channel
    if args.res_blocks:
        opt["model"]["unet"]["res_blocks"] = args.res_blocks
    opt["model"]["diffusion"]["image_height"] = args.hr_shape[0]
    opt["model"]["diffusion"]["image_width"] = args.hr_shape[1]
    opt["data"]["height"] = args.hr_shape[0]
    if args.pretrained_model:
        pre = {"model_path": args.pretrained_model, "lock_weights": True}
        if args.pretrained_num_block:
            pre["num_block"] = args.pretrained_num_block
        if args.pretrained_hidden_size:
            pre["hidden_size"] = args.pretrained_hidden_size
        opt["model"]["pretrained_model"] = pre
    opt["data"].update(
        dataroot=str(work / "data"),
        batch_size=args.batch,
        val_batch_size=args.val_batch,
        train_min_date=args.train_min,
        train_max_date=args.train_max,
        val_min_date=args.val_min,
        val_max_date=args.val_max,
        months_subset=months,
        transform_groups={f"m{m}": [m] for m in months},
    )
    if args.grad_clip:
        opt["train"]["optimizer"]["grad_clip"] = args.grad_clip
    opt["train"].update(
        n_iter=args.iters,
        val_freq=args.val_freq,
        full_val_freq=args.val_freq,
        save_checkpoint_freq=args.save_freq,
        print_freq=args.print_freq,
        save_visualizations=True,
        checkpoint_keep=args.checkpoint_keep,
        device_data_cache=not args.no_device_cache,
        ema_scheduler={
            "enabled": True,
            "step_start_ema": args.ema_start,
            "update_ema_every": 1,
            "ema_decay": args.ema_decay,
            "use_for_val": True,
        },
    )
    return opt


def main(argv=None) -> None:
    args = parse_args(argv)
    work = Path(args.workdir).resolve()
    work.mkdir(parents=True, exist_ok=True)
    ensure_data(work / "data", args)
    cfg_path = work / "config.json"
    cfg_path.write_text(json.dumps(build_config(args, work), indent=2) + "\n")
    print(f"[config] -> {cfg_path}", flush=True)
    if args.config_only:
        return
    cmd = [sys.executable, "-m", "srewd_tpu_torch.train", "-c", str(cfg_path), "-p", "train",
           "--device", args.device]
    print("[run]", " ".join(cmd), flush=True)
    os.execv(sys.executable, cmd)


if __name__ == "__main__":
    main()
