"""Bulk date-range sampling with the port (counterpart of the root sample.py).

Super-resolves every hour of [START, END) in fixed-size batches on one
device and writes each field in Kelvin as <out>/sr/<YYYY-MM-DD-HH>.npy, plus
<out>/summary.json with the throughput:

    python -m srewd_tpu_torch.sample -c <cfg>.json [-m <checkpoint> [--use-ema]] \
        --date-range 2017-01-01-00 2017-02-01-00 --batch-size 8 --save-npy \
        [--sampler ddpm|ddim|dpm] [--ddim-steps N] [--ddim-eta E] \
        [--spacing linspace|trailing|quad|logsnr] [--no-clip-denoised] \
        [--ensemble N] --device cuda [--dtype bfloat16]

`-m` takes a checkpoint directory written by `python -m
srewd_tpu_torch.train` (UNet, encoder and EMA), or srewd_tpu params as an
.npz whose keys are the tree paths joined by '/' (utils/jax_params.py);
without it the UNet gets seeded random weights and the encoder those of
`pretrained_model.model_path`. `--use-ema` samples with the checkpoint's
EMA weights; without EMA state it warns and uses the raw weights.
`--ensemble N` draws N members per field, each from its own generator
stream: each member is inverse-transformed to Kelvin, their mean is
written to sr/ and their standard deviation to sr_std/. `--sampler dpm` is
DPM-Solver++(2M) with `--ddim-steps` steps. Date-targeted PNG rendering
(`-d`) is not ported (it needs matplotlib).

On a CUDA device the float32 path runs convolutions and matmuls in full
float32: TF32 is switched off, so the port's numbers stay comparable with
the JAX reference. bfloat16 is the path for speed.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time

import numpy as np
import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m srewd_tpu_torch.sample")
    p.add_argument("-c", "--config", required=True)
    p.add_argument("-m", "--model_path", default=None,
                   help="a port checkpoint directory, or srewd_tpu params as .npz")
    p.add_argument("--date-range", nargs=2, metavar=("START", "END"), required=True,
                   help="super-resolve every hour in [START, END)")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--save-npy", action="store_true",
                   help="write SR fields (Kelvin) as <out>/sr/<timestamp>.npy")
    p.add_argument("--ensemble", type=int, default=1,
                   help="N members per field: their Kelvin mean to sr/, std to sr_std/")
    p.add_argument("--use-ema", action="store_true",
                   help="sample with the checkpoint's EMA weights")
    p.add_argument("-o", "--output", default="samples_out")
    p.add_argument("--sampler", choices=["ddpm", "ddim", "dpm"], default=None,
                   help="override model.diffusion.sampler (dpm = DPM-Solver++(2M), "
                        "--ddim-steps is its step count)")
    p.add_argument("--ddim-steps", type=int, default=None)
    p.add_argument("--ddim-eta", type=float, default=None)
    p.add_argument("--spacing", choices=["linspace", "trailing", "quad", "logsnr"],
                   default=None, help="fast-sampler timestep spacing")
    p.add_argument("--no-clip-denoised", action="store_true",
                   help="no clamp of the x0 estimate to [-1,1]")
    p.add_argument("--device", default="cuda")
    p.add_argument("--dtype", choices=sorted(_DTYPES), default="float32")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    from .cli import (
        Config, build_data_handler, cuda_numerics, denormalize, init_weights,
        load_model_weights, resolve_device, sampler_kwargs, set_seeds,
    )
    from .data.timeindex import format_date, months_of, parse_date
    from .diffusion.schedule import Schedule
    from .models.factory import build_model
    from .utils.seeding import member_seed

    device = resolve_device(args.device)
    cuda_numerics(device)
    logging.basicConfig(level=logging.INFO)
    logger = logging.getLogger("base")

    set_seeds(0)
    opt = Config(args.config, phase="val", experiment=False).get_opt()
    seed = int(opt.get("seed", 0))
    start, end = args.date_range
    ts_all = np.arange(parse_date(start), parse_date(end), np.timedelta64(1, "h"))
    if len(ts_all) == 0:
        raise SystemExit(f"empty date range [{start}, {end})")
    months = sorted(int(m) for m in set(months_of(ts_all)))
    dh = build_data_handler(opt, val_min_date=start, val_max_date=end,
                            months_subset=months, val_batch_size=int(args.batch_size))
    ts_all = dh.val_timestamps
    if len(ts_all) == 0:
        raise SystemExit("no data in the requested window")

    dcfg = opt["model"].setdefault("diffusion", {})
    if args.sampler:
        dcfg["sampler"] = args.sampler
    if args.ddim_steps is not None:
        dcfg["ddim_steps"] = args.ddim_steps
    if args.ddim_eta is not None:
        dcfg["ddim_eta"] = args.ddim_eta
    if args.spacing:
        dcfg["tau_spacing"] = args.spacing
    if args.no_clip_denoised:
        dcfg["clip_denoised"] = False
    skw = sampler_kwargs(opt)

    with torch.device(device):  # parameters made on the device, not copied there
        model = build_model(opt["model"], dtype=_DTYPES[args.dtype])
    init_weights(model, opt)
    used_ema = False
    if args.model_path:
        used_ema = load_model_weights(model, args.model_path, use_ema=args.use_ema)
    elif args.use_ema:
        logger.warning("--use-ema requested without -m: sampling with the seeded weights")
    bs_cfg = opt["model"]["beta_schedule"]
    schedule = Schedule.from_config(bs_cfg.get("val", bs_cfg["train"]), device=device)
    n_ens = max(1, int(args.ensemble))
    generators = [torch.Generator(device=device).manual_seed(member_seed(seed, e))
                  for e in range(n_ens)]
    hr_scalers = dh.batch_scalers["hr"]

    bs = int(args.batch_size)
    sr_dir = os.path.join(args.output, "sr")
    std_dir = os.path.join(args.output, "sr_std")
    if args.save_npy:
        os.makedirs(sr_dir, exist_ok=True)
        if n_ens > 1:
            os.makedirs(std_dir, exist_ok=True)
    n_done = 0
    t_start = time.perf_counter()
    t_after_first = None
    for lo in range(0, len(ts_all), bs):
        chunk = ts_all[lo:lo + bs]
        pad = bs - len(chunk)  # pad the last batch by repeating its last hour
        ts_batch = np.concatenate([chunk, np.repeat(chunk[-1:], pad)]) if pad else chunk
        batch = dh.assemble(ts_batch)
        lr = torch.from_numpy(batch["LR"]).to(device)
        members = np.stack([
            denormalize(hr_scalers,
                        model.generate_sr({"LR": lr}, schedule, generator=g, **skw).cpu().numpy(),
                        batch["months"])
            for g in generators])  # [E, B, H, W, C], Kelvin
        kelvin = members.mean(axis=0)
        if args.save_npy:
            for i, ts in enumerate(chunk):  # pad rows dropped
                np.save(os.path.join(sr_dir, f"{format_date(ts)}.npy"), kelvin[i])
                if n_ens > 1:
                    np.save(os.path.join(std_dir, f"{format_date(ts)}.npy"),
                            members[:, i].std(axis=0))
        n_done += len(chunk)
        if t_after_first is None:
            t_after_first = time.perf_counter()
        logger.info(f"sampled {n_done}/{len(ts_all)} fields")
    t_end = time.perf_counter()
    steady = (n_done - bs) / (t_end - t_after_first) if n_done > bs else None
    summary = {
        "fields": int(n_done),
        "ensemble": n_ens,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else str(device),
        "dtype": args.dtype,
        "arch": model.arch,
        "sampler": skw.get("sampler", "ddpm"),
        "ema": used_ema,
        "total_sec": t_end - t_start,
        "fields_per_sec_total": n_done / (t_end - t_start),
        "fields_per_sec_steady": steady,
        "output": sr_dir if args.save_npy else None,
    }
    os.makedirs(args.output, exist_ok=True)
    with open(os.path.join(args.output, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    logger.info(f"bulk sampling done: {json.dumps(summary)}")
    return summary


if __name__ == "__main__":
    main()
