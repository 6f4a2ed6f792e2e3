"""Sampling with the port (counterpart of the root sample.py), in its three
modes.

The reference's mode renders one date, or the first validation batch, as
PNG maps in Kelvin (training/visualization.py; no matplotlib needed):

    python -m srewd_tpu_torch.sample -c <cfg>.json -m <checkpoint> -d 2017-01-01-00 \
        [-i SR HR INTERPOLATED DELTA AE AE_INTER] [-cm heat_vibrant] [-o out] --device cuda

`-d` restricts the data to that date as the root sample.py does: its month
(months_subset and one transform group), a one-hour validation window, and
the train window, where the config sets none, defaulting to that hour (the
scalers are fitted on it). Without `-d` the first validation batch is
rendered. `-i` picks the types (default: every field but LR; aliases
INTERPOLATED, DELTA, AE, AE_INTER) and `-cm` the map of the main fields;
the range is the fixed 220-315 K, DELTA takes abs_color at [-25, 25] and
the AE maps ae_color at [0, 21]. Files: <out>/<date or val0>_<type>_0.png.
INF is the bicubic x4 of LR.

Bulk mode super-resolves every hour of [START, END) in fixed-size batches
and writes each field in Kelvin as <out>/sr/<YYYY-MM-DD-HH>.npy, plus
<out>/summary.json with the throughput:

    python -m srewd_tpu_torch.sample -c <cfg>.json [-m <checkpoint> [--use-ema]] \
        --date-range 2017-01-01-00 2017-02-01-00 --batch-size 8 --save-npy \
        [--sampler ddpm|ddim|dpm] [--ddim-steps N] [--ddim-eta E] \
        [--spacing linspace|trailing|quad|logsnr] [--no-clip-denoised] \
        [--ensemble N] --device cuda [--dtype bfloat16]

`-m` takes a checkpoint directory written by `python -m
srewd_tpu_torch.train` (UNet, encoder and EMA), or srewd_tpu params as an
.npz whose keys are the tree paths joined by '/' (utils/jax_params.py).
Without it the config's `path.resume_state` is loaded, as the root
sample.py does; with neither, the UNet gets seeded random weights and the
encoder those of `pretrained_model.model_path`. The load is strict, and
tolerant under `model.finetune_norm` (`cli.load_sampling_weights`).
`--use-ema` samples with the checkpoint's EMA weights; without EMA state
(or under the tolerant load) it warns and uses the raw weights.
`--ensemble N` draws N members per field, each from its own generator
stream: in bulk mode each member is inverse-transformed to Kelvin, their
mean is written to sr/ and their standard deviation to sr_std/; with `-d`
the maps show the members' mean. `--sampler dpm` is DPM-Solver++(2M) with
`--ddim-steps` steps.

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
                   help="a port checkpoint directory, or srewd_tpu params as .npz "
                        "(overrides path.resume_state)")
    mode = p.add_mutually_exclusive_group()
    mode.add_argument("-d", "--date", default=None,
                      help="render this hour (%%Y-%%m-%%d-%%H); neither -d nor --date-range: "
                           "the first validation batch")
    mode.add_argument("--date-range", nargs=2, metavar=("START", "END"), default=None,
                      help="bulk mode: super-resolve every hour in [START, END)")
    p.add_argument("-i", "--image_types", nargs="*", default=None,
                   help="the types to render (SR HR INF/INTERPOLATED DELTA AE AE_INTER ...)")
    p.add_argument("-cm", "--cmap", default="heat_vibrant",
                   help="the colormap of the main fields")
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
        load_sampling_weights, resolve_device, sampler_kwargs, set_seeds,
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
    if args.date_range:
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
    else:
        dh = build_data_handler(opt, **date_overrides(opt, args.date))

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
    used_ema = load_sampling_weights(model, opt, args.model_path, use_ema=args.use_ema)
    bs_cfg = opt["model"]["beta_schedule"]
    schedule = Schedule.from_config(bs_cfg.get("val", bs_cfg["train"]), device=device)
    n_ens = max(1, int(args.ensemble))
    generators = [torch.Generator(device=device).manual_seed(member_seed(seed, e))
                  for e in range(n_ens)]
    if not args.date_range:
        return render(args, dh, model, schedule, skw, generators, used_ema, device, logger)
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


def date_overrides(opt: dict, date) -> dict:
    """The DataHandler overrides of `-d DATE` (none without a date): the
    date's month as the only month and transform group, a one-hour
    validation window, and the train window defaulting to that hour."""
    from .data.timeindex import format_date, months_of, parse_date

    if not date:
        return {}
    ts = parse_date(date)
    nxt = format_date(ts + np.timedelta64(1, "h"))
    month = int(months_of(np.array([ts]))[0])
    data = opt["data"]
    return dict(months_subset=[month], groups=[[month]], val_min_date=date, val_max_date=nxt,
                val_batch_size=1, train_min_date=data.get("train_min_date") or date,
                train_max_date=data.get("train_max_date") or nxt)


def render(args, dh, model, schedule, skw, generators, used_ema, device, logger) -> dict:
    """The reference's mode: super-resolve the `-d` hour (or the first
    validation batch; with an ensemble, the members' mean in normalized
    units), then render the chosen types in Kelvin at the fixed 220-315 K
    range. Returns {"saved": [paths], "kelvin": {SR, HR, LR, INF, ...}, "tag",
    "ensemble", "ema", "sample_sec", "render_sec"}."""
    from .ops.resize import bicubic_up4
    from .training.visualization import ImageContainer

    batch = dh.get_data_by_date(args.date) if args.date else next(iter(dh.val_batches()))
    lr = torch.from_numpy(batch["LR"]).to(device)
    t0 = time.perf_counter()
    members = [model.generate_sr({"LR": lr}, schedule, generator=g, **skw)
               for g in generators]
    sr = (torch.stack(members).mean(0) if len(members) > 1 else members[0]).float().cpu()
    sample_sec = time.perf_counter() - t0
    if len(members) > 1:
        logger.info(f"ensemble of {len(members)}: mean member spread "
                    f"{torch.stack(members).float().std(0).mean().item():.4f} (normalized units)")
    images = {"SR": sr.numpy(), "HR": batch["HR"], "LR": batch["LR"],
              "INF": bicubic_up4(lr).cpu().numpy()}
    kelvin = dh.inverse_transform(images, batch["months"])

    t0 = time.perf_counter()
    os.makedirs(args.output, exist_ok=True)
    container = ImageContainer(kelvin, n_images=1)
    container.set_min_max(220, 315)  # the fixed Kelvin range
    tag = args.date or "val0"
    saved = container.save_all_images(os.path.join(args.output, tag),
                                      image_types=args.image_types, cmap=args.cmap)
    render_sec = time.perf_counter() - t0
    logger.info(f"Saved {len(saved)} images to {args.output}")
    return {"saved": saved, "kelvin": kelvin, "tag": tag, "ensemble": len(generators),
            "ema": used_ema, "sample_sec": sample_sec, "render_sec": render_sec}


if __name__ == "__main__":
    main()
