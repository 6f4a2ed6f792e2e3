"""Diffusion train / val entry point of the port (counterpart of the root train.py):

    python -m srewd_tpu_torch.train -p train -c <cfg>.json [--device cuda]
    python -m srewd_tpu_torch.train -p val   -c <cfg>.json   (validation only)

The config is the JAX package's schema. A run creates
experiments/<name>_<yymmdd_HHMMSS>/{logs,results,checkpoint,...}; with
`path.resume_state` set (a `.../checkpoint/I{iter}_E{epoch}` directory, or
"auto" for the newest of this experiment name) it resumes there. The UNet
gets seeded random weights from the config's `seed` (default 0).

Training runs in float32. On a CUDA device TF32 is switched off and cuDNN
is held to deterministic algorithms, chosen by timing on each shape's first
call (cli.cuda_numerics), so a resumed run in the same process repeats the
steps of the run it resumes. `--device` defaults to the card; a CUDA
request without one raises.
"""

from __future__ import annotations

import argparse
import logging


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m srewd_tpu_torch.train")
    p.add_argument("-c", "--config", required=True,
                   help="JSON file for configuration (// comments allowed)")
    p.add_argument("-p", "--phase", choices=["train", "val"], default="train")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the phase; returns run_training's summary (train) or the
    validation metrics (val)."""
    args = parse_args(argv)
    from .cli import (
        Config, build_data_handler, build_trainer, cuda_numerics, resolve_device, set_seeds)
    from .configs.config import dict2str
    from .training.trainer import run_training, run_validation
    from .utils.logging import setup_logger

    device = resolve_device(args.device)
    cuda_numerics(device, training=True)
    set_seeds(0)
    opt = Config(args.config, phase=args.phase).get_opt()
    setup_logger(None, opt["path"]["log"], "train", screen=True)
    setup_logger("val", opt["path"]["log"], "val")
    logger = logging.getLogger("base")
    logger.info(dict2str(opt))

    logger.info("Creating datasets.")
    dh = build_data_handler(opt)
    logger.info("Building model and trainer.")
    trainer = build_trainer(opt, device)
    if args.phase == "train":
        return run_training(opt, dh, trainer, logger)
    return run_validation(opt, dh, trainer, logging.getLogger("val"))


if __name__ == "__main__":
    main()
