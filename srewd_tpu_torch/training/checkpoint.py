"""Checkpoints: torch.save of the whole train state (port of
srewd_tpu/training/checkpoint.py).

One directory `I{iter}_E{epoch}` per checkpoint, as the JAX package's orbax
directories, holding `state.pt`: the UNet state_dict, the optimizer's
state_dict, the EMA weights (when on), step and epoch. `latest()` resolves
the newest by step, and `resume_state` paths of reference-style configs
(`.../checkpoint/I{iter}_E{epoch}`) resolve directly; `keep` rotates old
checkpoints out. `parse_counters` reads (iter, epoch) off such a name, and
off the reference's `I{iter}_E{epoch}_gen.pth` files. `load_tolerant` is
the finetune_norm load of one module's weights.
"""

from __future__ import annotations

import os
import re
import shutil

import torch

_CKPT_RE = re.compile(r"^I(\d+)_E(\d+)$")
STATE_FILE = "state.pt"


def load_tolerant(module: torch.nn.Module, state: dict, name: str) -> None:
    """`state` into `module` by the JAX trainer's tolerant merge
    (load_params_tolerant, the finetune_norm load): a tensor on both sides
    takes the checkpoint's value, one missing from `state` keeps the
    module's, an extra one is ignored, and a shape mismatch raises."""
    own = module.state_dict()
    for k, v in state.items():
        if k in own and tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(f"checkpoint shape mismatch at {name}.{k}: {tuple(v.shape)} vs "
                             f"{tuple(own[k].shape)}")
    module.load_state_dict({k: v for k, v in state.items() if k in own}, strict=False)


class CheckpointManager:
    def __init__(self, directory: str, keep: int | None = None):
        """keep: retain only the newest `keep` checkpoints after each save;
        None keeps all."""
        self.directory = os.path.abspath(directory)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)

    def path_for(self, step: int, epoch: int) -> str:
        return os.path.join(self.directory, f"I{step}_E{epoch}")

    def save(self, state: dict, step: int, epoch: int) -> str:
        path = self.path_for(step, epoch)
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, f"{STATE_FILE}.tmp")
        torch.save(state, tmp)
        os.replace(tmp, os.path.join(path, STATE_FILE))
        if self.keep is not None:
            for _, _, old in self.all_checkpoints()[: -self.keep]:
                if os.path.abspath(old) != os.path.abspath(path):
                    shutil.rmtree(old, ignore_errors=True)
        return path

    @staticmethod
    def restore(path: str, map_location=None) -> dict:
        """The state saved at `path` (a checkpoint directory), tensors on
        `map_location`. Reads only files this program wrote. The file is
        memory-mapped: its tensors are read once, on their way to
        `map_location` (or where the caller copies them), not first into
        host buffers of their own."""
        return torch.load(os.path.join(os.path.abspath(path), STATE_FILE),
                          map_location=map_location, weights_only=True, mmap=True)

    def all_checkpoints(self) -> list[tuple[int, int, str]]:
        out = []
        if not os.path.isdir(self.directory):
            return out
        for d in os.listdir(self.directory):
            m = _CKPT_RE.match(d)
            if m and os.path.isdir(os.path.join(self.directory, d)):
                out.append((int(m.group(1)), int(m.group(2)), os.path.join(self.directory, d)))
        return sorted(out)

    def latest(self) -> str | None:
        cps = self.all_checkpoints()
        return cps[-1][2] if cps else None

    @staticmethod
    def parse_counters(path: str) -> tuple[int, int]:
        """(iter, epoch) of a checkpoint directory `I{iter}_E{epoch}` or a
        reference file `I{iter}_E{epoch}_gen.pth` (`_opt.pth`). Raises on a
        name without the counters (the JAX package's returns (0, 0))."""
        name = os.path.basename(os.path.normpath(path))
        for suffix in ("_gen.pth", "_opt.pth"):
            name = name.removesuffix(suffix)
        m = _CKPT_RE.match(name)
        if not m:
            raise ValueError(f"{path}: the name carries no I{{iter}}_E{{epoch}} counters")
        return int(m.group(1)), int(m.group(2))
