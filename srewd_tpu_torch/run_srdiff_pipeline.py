"""SRDiff pipeline of the port (twin of scripts/run_srdiff_pipeline.py):
RRDB pretraining, then diffusion training on the locked, pretrained encoder.

    python -m srewd_tpu_torch.run_srdiff_pipeline --workdir W [--device cuda]

  0. the synthetic t2m tree under W/data (made once: a `.complete` marker);
  1. RRDB pretraining, `python -m srewd_tpu_torch.pretrain` in a subprocess,
     on the reference recipe (rrdb/pretrained_rrdb_17block_base.json: Adam
     amsgrad 2e-4, L1, a checkpoint per epoch) under W/pretrain;
  2. the newest `checkpoint/pretrain_*_E{k}` by epoch, written to
     W/encoder_checkpoint.txt;
  3. srdiff training through `python -m srewd_tpu_torch.run_reference_scale`
     in W/diffusion (the tree linked in as W/diffusion/data) with
     `--pretrained-model` and `--pretrained-num-block`.

Evaluate afterwards:

    python -m srewd_tpu_torch.quality_e2e --arch srdiff \\
        --reuse-checkpoint W/diffusion/experiments/.../I<N>_E<M> \\
        --pretrained-model W/pretrain/.../checkpoint/pretrain_<name>_E<K> --sweep-fast

`--device` defaults to the card; both stages get it.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m srewd_tpu_torch.run_srdiff_pipeline")
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--dataroot", default=None,
                    help="existing synthetic tree (default: generate one under <workdir>/data)")
    ap.add_argument("--pretrain-epochs", type=int, default=40,
                    help="the reference recipe is 200 epochs; the synthetic tree "
                         "converges much earlier")
    ap.add_argument("--pretrain-batch", type=int, default=32)
    ap.add_argument("--iters", type=int, default=30000)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--ema-decay", type=float, default=0.999,
                    help="diffusion-stage EMA decay (0.999: the short pipeline's window)")
    ap.add_argument("--ema-start", type=int, default=None,
                    help="diffusion-stage EMA start (default iters//2)")
    ap.add_argument("--val-freq", type=int, default=None,
                    help="diffusion-stage val/ckpt cadence (default min(10000, iters))")
    ap.add_argument("--num-block", type=int, default=17)
    ap.add_argument("--spectrum", default="t2m")
    ap.add_argument("--data-min", default="2017-01-01-00")
    ap.add_argument("--data-max", default="2017-05-01-00")
    ap.add_argument("--train-min", default="2017-01-01-00")
    ap.add_argument("--train-max", default="2017-04-28-00")
    ap.add_argument("--val-min", default="2017-04-28-00")
    ap.add_argument("--val-max", default="2017-04-30-00")
    ap.add_argument("--hr-shape", type=int, nargs=2, default=(128, 256))
    ap.add_argument("--inner-channel", type=int, default=None)
    ap.add_argument("--res-blocks", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--skip-pretrain", action="store_true",
                    help="reuse <workdir>/pretrain's newest checkpoint")
    return ap.parse_args(argv)


def newest_encoder(pre_dir: Path) -> Path:
    """The `checkpoint/pretrain_*_E{k}` under `pre_dir` with the largest k."""
    cands = sorted(pre_dir.rglob("checkpoint/pretrain_*"),
                   key=lambda p: int(p.name.rsplit("_E", 1)[1]))
    if not cands:
        raise SystemExit(f"no pretrain checkpoints under {pre_dir}")
    return cands[-1]


def pretrain_config(args, dataroot: Path, pre_dir: Path) -> dict:
    """The RRDB recipe on the tree, months and groups from the date range."""
    from .configs.config import load_commented_json
    from .data.timeindex import hourly_range, months_of

    months = sorted(set(months_of(hourly_range(args.data_min, args.data_max)).tolist()))
    opt = load_commented_json(
        str(REPO / "configs/experiment_configs/rrdb/pretrained_rrdb_17block_base.json"))
    opt["name"] = "rrdb_srdiff_pipeline"
    opt["path"]["experiments_folder_path"] = str(pre_dir / "experiments")
    opt["model"]["num_block"] = args.num_block
    opt["data"].update(
        dataroot=str(dataroot),
        batch_size=args.pretrain_batch,
        val_batch_size=8,
        train_min_date=args.train_min,
        train_max_date=args.train_max,
        val_min_date=args.val_min,
        val_max_date=args.val_max,
        months_subset=months,
        transform_groups={f"m{m}": [m] for m in months},
        height=args.hr_shape[0],
    )
    opt["train"]["epoch"] = args.pretrain_epochs
    return opt


def main(argv=None) -> None:
    args = parse_args(argv)
    from .run_reference_scale import ensure_data

    work = Path(args.workdir).resolve()
    work.mkdir(parents=True, exist_ok=True)
    dataroot = Path(args.dataroot).resolve() if args.dataroot else work / "data"
    ensure_data(dataroot, args)

    pre_dir = work / "pretrain"
    if not args.skip_pretrain:
        pre_dir.mkdir(parents=True, exist_ok=True)
        cfg = pre_dir / "pretrain_config.json"
        cfg.write_text(json.dumps(pretrain_config(args, dataroot, pre_dir), indent=2) + "\n")
        cmd = [sys.executable, "-m", "srewd_tpu_torch.pretrain", "-c", str(cfg), "-p", "train",
               "--device", args.device]
        print("[pretrain]", " ".join(cmd), flush=True)
        subprocess.run(cmd, check=True)
    enc_ckpt = newest_encoder(pre_dir)
    print(f"[pretrain] encoder checkpoint: {enc_ckpt}", flush=True)
    (work / "encoder_checkpoint.txt").write_text(str(enc_ckpt) + "\n")

    diff_work = work / "diffusion"
    freq = str(args.val_freq or min(10000, args.iters))
    cmd = [
        sys.executable, "-m", "srewd_tpu_torch.run_reference_scale",
        "--workdir", str(diff_work), "--arch", "srdiff",
        "--iters", str(args.iters), "--batch", str(args.batch),
        "--spectrum", args.spectrum,
        "--data-min", args.data_min, "--data-max", args.data_max,
        "--train-min", args.train_min, "--train-max", args.train_max,
        "--val-min", args.val_min, "--val-max", args.val_max,
        "--val-freq", freq, "--save-freq", freq,
        "--hr-shape", str(args.hr_shape[0]), str(args.hr_shape[1]),
        "--pretrained-model", str(enc_ckpt),
        "--pretrained-num-block", str(args.num_block),
        "--ema-decay", str(args.ema_decay),
        "--ema-start", str(args.ema_start if args.ema_start is not None else args.iters // 2),
        "--device", args.device,
    ]
    if args.inner_channel:
        cmd += ["--inner-channel", str(args.inner_channel)]
    if args.res_blocks:
        cmd += ["--res-blocks", str(args.res_blocks)]
    # share the tree: linked into the diffusion workdir, whose marker it carries
    diff_work.mkdir(parents=True, exist_ok=True)
    link = diff_work / "data"
    if not link.exists():
        link.symlink_to(dataroot)
    print("[diffusion]", " ".join(cmd), flush=True)
    subprocess.run(cmd, check=True)


if __name__ == "__main__":
    main()
