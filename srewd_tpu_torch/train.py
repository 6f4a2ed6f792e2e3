"""Diffusion train / val entry point of the port (counterpart of the root train.py):

    python -m srewd_tpu_torch.train -p train -c <cfg>.json [--device cuda]
    python -m srewd_tpu_torch.train -p val   -c <cfg>.json   (validation only)

The config is the JAX package's schema. A run creates
experiments/<name>_<yymmdd_HHMMSS>/{logs,results,checkpoint,...}; with
`path.resume_state` set (a `.../checkpoint/I{iter}_E{epoch}` directory, or
"auto" for the newest of this experiment name) it resumes there. The UNet
gets seeded random weights from the config's `seed` (default 0).

With `train.save_visualizations`, each validation renders its first batch
in Kelvin as PNG plates into results/<epoch>/<epoch>_<step>_1_<type>_0.png
(`ImageContainer.save_all_images`; `-p val` at the fixed 220-315 K range),
and, with a `wandb` section in the config and the package installed
(utils/wandb_logger.py), logs the losses, the metrics and the IT/SR/HR
plate to Weights & Biases. Under several ranks only rank 0 logs and renders.

Training runs in float32 here; bf16 over float32 master weights is
`cli.build_trainer(opt, device, dtype=torch.bfloat16)` (the JAX package's
train.py has no dtype flag either; `bench_train` reaches it). On a CUDA
device TF32 is switched off and cuDNN
is held to deterministic algorithms, chosen by timing on each shape's first
call (cli.cuda_numerics), so a resumed run in the same process repeats the
steps of the run it resumes. `--device` defaults to the card; a CUDA
request without one raises.

Data parallelism: run it under torchrun, one process per card,

    python -m torch.distributed.run --nproc_per_node=N -m srewd_tpu_torch.train -c <cfg>.json
    python -m torch.distributed.run --nproc_per_node=2 -m srewd_tpu_torch.train -c <cfg>.json --device cpu

Each rank joins the process group from torchrun's environment (NCCL on
cuda:LOCAL_RANK; gloo with `--device cpu`), reads its stride of the index
and trains under DistributedDataParallel. `data.batch_size` is per process:
the global batch is N times it, as the JAX package's per-host batch. Rank 0
creates the run's directories, writes the checkpoints and logs to the
screen; the other ranks log to train_rank<r>.log.
"""

from __future__ import annotations

import argparse
import logging
import os


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
    from .cli import build_data_handler, build_trainer, training_run
    from .configs.config import dict2str
    from .parallel import rank, world_size
    from .training.trainer import run_training, run_validation
    from .training.visualization import ImageContainer
    from .utils.wandb_logger import WandbLogger

    with training_run(args.config, args.phase, args.device) as (opt, device):
        logger = logging.getLogger("base")
        logger.info(dict2str(opt))
        logger.info(f"Rank {rank()} of {world_size()} on {device}.")
        lead = rank() == 0  # the one rank that logs and renders
        wandb_logger = WandbLogger(opt, enabled=None if lead else False)

        logger.info("Creating datasets.")
        dh = build_data_handler(opt)
        logger.info("Building model and trainer.")
        trainer = build_trainer(opt, device)
        results_dir = opt["path"].get("results", "results")

        def visualize_fn(kelvin, epoch, step):
            out_dir = os.path.join(results_dir, str(epoch))
            os.makedirs(out_dir, exist_ok=True)
            container = ImageContainer(kelvin, n_images=1)
            if args.phase == "val":
                container.set_min_max(220, 315)  # the fixed Kelvin range
            if wandb_logger.enabled:
                wandb_logger.log_sr_hr_it_image(container.make_wandb_plot(), commit=False,
                                                step=step)
            container.save_all_images(os.path.join(out_dir, f"{epoch}_{step}_1"))

        vis = visualize_fn if lead else None
        if args.phase == "train":
            return run_training(opt, dh, trainer, logger, wandb_logger, visualize_fn=vis)
        return run_validation(opt, dh, trainer, logging.getLogger("val"), wandb_logger,
                              visualize_fn=vis)

if __name__ == "__main__":
    main()
