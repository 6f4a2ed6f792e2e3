"""Migrate a reference PyTorch checkpoint into a port checkpoint (twin of
scripts/convert_torch_checkpoint.py):

    python -m srewd_tpu_torch.convert_torch_checkpoint \\
        -c configs/experiment_configs/<arch>/<cfg>.json \\
        --gen /path/to/I200000_E31_gen.pth [--out DIR] [--device cuda]

    python -m srewd_tpu_torch.train -p val -c <cfg>.json   # path.resume_state -> DIR/I...

The reference's `I{iter}_E{epoch}_gen.pth` (the <Arch>Diffusion state dict)
is split into the UNet and the encoder (utils/torch_convert.py), merged
over the fresh model the config builds (physrdiff's spliter, which the
reference lacks, keeps its init; every leaf's shape is checked), and
written by the trainer as the port's checkpoint directory
`DIR/I{iter}_E{epoch}`: fresh Adam state (the reference's moments are not
migrated), the EMA equal to the weights where the config enables it, and
the counters parsed from the file name. `path.resume_state`, `sample -m`
and `quality_e2e --reuse-checkpoint` read it.

With `--encoder`, the file is a pretrain-era SimpleCNN or RRDBNet
checkpoint (`pretrain_<name>_E{e}_gen.pth`); it is written as the directory
`DIR/pretrain_<name>_E{e}` that `model.pretrained_model.model_path` names
(host work: its tensors stay on the CPU).

`--device` defaults to the card; a CUDA request without one raises.
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m srewd_tpu_torch.convert_torch_checkpoint")
    p.add_argument("-c", "--config", required=True,
                   help="experiment config JSON naming the target architecture")
    p.add_argument("--gen", required=True, help="reference *_gen.pth path")
    p.add_argument("--out", default=None,
                   help="output checkpoint dir (default: <gen dir>/converted)")
    p.add_argument("--encoder", action="store_true",
                   help="the .pth is a SimpleCNN/RRDB pretrain checkpoint, not a diffusion one")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> str:
    """Convert; returns the checkpoint directory written."""
    args = parse_args(argv)
    import torch

    from .cli import Config, build_trainer, resolve_device
    from .training.checkpoint import STATE_FILE, CheckpointManager
    from .utils.torch_convert import convert_encoder_state, load_reference_checkpoint

    device = resolve_device(args.device)
    sd = torch.load(args.gen, map_location="cpu", weights_only=True)
    out_dir = os.path.abspath(
        args.out or os.path.join(os.path.dirname(os.path.abspath(args.gen)), "converted"))

    if args.encoder:
        _, enc = convert_encoder_state(sd)
        name = os.path.basename(args.gen).removesuffix(".pth").removesuffix("_gen")
        path = os.path.join(out_dir, name)
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, STATE_FILE + ".tmp")
        torch.save({"params": enc}, tmp)
        os.replace(tmp, os.path.join(path, STATE_FILE))
        print(f"encoder checkpoint written: {path}\n"
              f"use it as model.pretrained_model.model_path")
        return path

    opt = Config(args.config, phase="val", experiment=False).get_opt()
    # a fresh trainer at the config's shapes (no resume during conversion)
    opt["path"]["resume_state"] = None
    opt["path"]["checkpoint"] = out_dir
    trainer = build_trainer(opt, device)
    mults = opt["model"].get("unet", {}).get("channel_multiplier", (1, 2, 4, 8, 8))
    load_reference_checkpoint(trainer.model, sd, n_boundaries=len(mults) - 1)
    trainer.reset_ema()
    step, epoch = CheckpointManager.parse_counters(args.gen)
    trainer.step, trainer.epoch = step, epoch
    path = trainer.save()
    print(f"checkpoint written: {path}\n"
          f"resume with path.resume_state = \"{path}\" "
          f"(iter {step}, epoch {epoch}, fresh optimizer state)")
    return path


if __name__ == "__main__":
    main()
