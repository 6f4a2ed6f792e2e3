"""Bulk date-range sampling with the port (counterpart of the root sample.py).

Super-resolves every hour of [START, END) in fixed-size batches on one
device and writes each field in Kelvin as <out>/sr/<YYYY-MM-DD-HH>.npy, plus
<out>/summary.json with the throughput:

    python -m srewd_tpu_torch.sample -c <cfg>.json [-m params.npz] \
        --date-range 2017-01-01-00 2017-02-01-00 --batch-size 8 --save-npy \
        --device cuda [--dtype bfloat16]

`-m` takes srewd_tpu UNet params as an .npz whose keys are the tree paths
joined by '/' (utils/jax_params.py); without it the UNet gets seeded random
weights. Date-targeted PNG rendering is not ported (it needs matplotlib).

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
                   help="srewd_tpu UNet params as .npz ('/'-joined tree paths)")
    p.add_argument("--date-range", nargs=2, metavar=("START", "END"), required=True,
                   help="super-resolve every hour in [START, END)")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--save-npy", action="store_true",
                   help="write SR fields (Kelvin) as <out>/sr/<timestamp>.npy")
    p.add_argument("-o", "--output", default="samples_out")
    p.add_argument("--sampler", choices=["ddpm", "ddim"], default=None,
                   help="override model.diffusion.sampler")
    p.add_argument("--ddim-steps", type=int, default=None)
    p.add_argument("--ddim-eta", type=float, default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--dtype", choices=sorted(_DTYPES), default="float32")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    from .cli import (
        Config, build_data_handler, cuda_numerics, denormalize, load_unet_weights,
        random_init_, resolve_device, sampler_kwargs, set_seeds,
    )
    from .data.timeindex import format_date, months_of, parse_date
    from .diffusion.schedule import Schedule
    from .models.factory import build_model

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
    skw = sampler_kwargs(opt)

    model = build_model(opt["model"], dtype=_DTYPES[args.dtype])
    if args.model_path:
        load_unet_weights(model.unet, args.model_path)
    else:
        random_init_(model.unet, seed)
    model.unet.to(device)
    bs_cfg = opt["model"]["beta_schedule"]
    schedule = Schedule.from_config(bs_cfg.get("val", bs_cfg["train"]), device=device)
    generator = torch.Generator(device=device).manual_seed(seed)
    hr_scalers = dh.batch_scalers["hr"]

    bs = int(args.batch_size)
    sr_dir = os.path.join(args.output, "sr")
    if args.save_npy:
        os.makedirs(sr_dir, exist_ok=True)
    n_done = 0
    t_start = time.perf_counter()
    t_after_first = None
    for lo in range(0, len(ts_all), bs):
        chunk = ts_all[lo:lo + bs]
        pad = bs - len(chunk)  # pad the last batch by repeating its last hour
        ts_batch = np.concatenate([chunk, np.repeat(chunk[-1:], pad)]) if pad else chunk
        batch = dh.assemble(ts_batch)
        lr = torch.from_numpy(batch["LR"]).to(device)
        sr = model.generate_sr({"LR": lr}, schedule, generator=generator, **skw)
        kelvin = denormalize(hr_scalers, sr.cpu().numpy(), batch["months"])
        if args.save_npy:
            for i, ts in enumerate(chunk):  # pad rows dropped
                np.save(os.path.join(sr_dir, f"{format_date(ts)}.npy"), kelvin[i])
        n_done += len(chunk)
        if t_after_first is None:
            t_after_first = time.perf_counter()
        logger.info(f"sampled {n_done}/{len(ts_all)} fields")
    t_end = time.perf_counter()
    steady = (n_done - bs) / (t_end - t_after_first) if n_done > bs else None
    summary = {
        "fields": int(n_done),
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else str(device),
        "dtype": args.dtype,
        "sampler": skw.get("sampler", "ddpm"),
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
