"""Encoder pretraining entry point of the port (counterpart of the root pretrain.py):

    python -m srewd_tpu_torch.pretrain -p train -c <cfg>.json [--device cuda]
    python -m srewd_tpu_torch.pretrain -p val   -c <cfg>.json   (evaluate only)

Trains SimpleCNN (model.name "SimpleSR", FFT + DWT loss) or RRDBNet
("RRDBNet", L1) on LR -> HR regression and writes one
`pretrain_<diffusion.name>_E{epoch}` checkpoint per epoch under the run's
checkpoint directory; diffusion configs name one as
`pretrained_model.model_path`. After the last epoch it writes the IT/SR/HR
plates of the first 15 validation batches (results/result_{i}.png), and,
with a `wandb` section in the config and the package installed, logs each
epoch to Weights & Biases (rank 0 alone writes the plates and logs).
`train.optimizer.amsgrad: true` with type adam selects amsgrad, as the root
pretrain.py does. With `path.resume_state` set to such a checkpoint,
training continues after its epoch. The encoder gets seeded random weights
from the config's `seed` (default 0).

On a CUDA device TF32 is off and cuDNN runs deterministic algorithms chosen
by timing (cli.cuda_numerics). `--device` defaults to the card; a CUDA
request without one raises.

Under torchrun (`python -m torch.distributed.run --nproc_per_node=N -m
srewd_tpu_torch.pretrain -c <cfg>.json [--device cpu]`) every rank trains
its stride of the index under DistributedDataParallel, `data.batch_size`
per process, as `srewd_tpu_torch.train` does; rank 0 writes the
checkpoints.
"""

from __future__ import annotations

import argparse
import logging


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m srewd_tpu_torch.pretrain")
    p.add_argument("-c", "--config", required=True,
                   help="JSON file for configuration (// comments allowed)")
    p.add_argument("-p", "--phase", choices=["train", "val"], default="train")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    """Run the phase; returns run_pretraining's per-epoch records (train) or
    the validation metrics (val)."""
    args = parse_args(argv)
    from .cli import build_data_handler, random_init_, training_run
    from .configs.config import dict2str
    from .parallel import rank
    from .training.pretrainer import EncoderTrainer, get_encoder_and_criterion, run_pretraining
    from .utils.wandb_logger import WandbLogger

    with training_run(args.config, args.phase, args.device) as (opt, device):
        logger = logging.getLogger("base")
        logger.info(dict2str(opt))

        logger.info("Creating datasets.")
        dh = build_data_handler(opt)
        module, criterion = get_encoder_and_criterion(opt["model"])
        random_init_(module.to(device), int(opt.get("seed", 0)))
        ocfg = opt["train"]["optimizer"]
        name = ocfg.get("type", "adam")
        if bool(ocfg.get("amsgrad", False)) and name == "adam":
            name = "amsgrad"  # the reference's Adam(amsgrad=...)
        trainer = EncoderTrainer(
            module, criterion, device=device, optimizer=name, lr=float(ocfg.get("lr", 1e-4)),
            checkpoint_dir=opt["path"].get("checkpoint"),
            name=(opt.get("diffusion") or {}).get("name", opt.get("name", "encoder")),
        )
        if opt["path"].get("resume_state"):
            trainer.resume(opt["path"]["resume_state"])
        if args.phase == "train":
            logger.info("Start training")
            lead = rank() == 0  # the one rank that logs and renders
            wandb_logger = WandbLogger(opt, enabled=None if lead else False)
            return run_pretraining(opt, dh, trainer, logger, wandb_logger,
                                   results_dir=opt["path"].get("results") if lead else None)
        logger.info("Start testing")
        val = trainer.evaluate(dh)
        logger.info("Val PSNR: {PSNR:.4f}, SSIM: {SSIM:.4f}, RMSE: {RMSE:.4f}, "
                    "MSE: {MSE:.4f}, MAE: {MAE:.4f}, MR: {MR:.4f}".format(**val))
        return val

if __name__ == "__main__":
    main()
