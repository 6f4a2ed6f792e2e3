"""EncoderTrainer: epoch-based LR -> HR regression pretraining of the
conditioning encoders (port of srewd_tpu/training/pretrainer.py).

SimpleCNN trains on the FFT + DWT `image_compare_loss`, RRDBNet on plain L1
(pretrain.py:141-164). Each epoch ends with an evaluation in Kelvin (the
six validation metrics) and a checkpoint `pretrain_<name>_E{epoch}`, the
directory a diffusion config's `pretrained_model.model_path` names. The
checkpoint is the port's own: `state.pt` with the encoder's state_dict,
the optimizer's state, the epoch and the step count.

Unlike the JAX trainer, which restores params only and reruns every epoch,
`resume` also restores the optimizer and `run_pretraining` continues with
the epoch after the checkpoint's. After the last epoch, `save_results`
writes the IT/SR/HR plates of the first 15 validation batches as
`result_{i}.png` into `path.results` (training/visualization.py), and each
epoch's loss and metrics go to a WandbLogger when one is given.

Under torchrun (parallel/) the encoder trains under DistributedDataParallel
on each rank's stride of the index: the gradients are averaged over the
ranks, the epoch's loss is the ranks' mean, the evaluation gathers SR, HR
and months before the metrics, and rank 0 alone writes the checkpoint
(every rank waits for it).
"""

from __future__ import annotations

import logging
import os
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn as nn

from ..models.rrdb import RRDBNet
from ..models.simple_cnn import SimpleCNN
from ..ops.losses import image_compare_loss, l1_loss
from ..ops.resize import bicubic_up4
from ..parallel import all_gather_rows, barrier, data_parallel, mean_across, rank
from .checkpoint import STATE_FILE, CheckpointManager
from .metrics import ValidationMetrics, create_metric_dict
from .optimizers import get_optimizer


def get_encoder_and_criterion(model_cfg: dict, dtype: Optional[torch.dtype] = None):
    """pretrain.py's get_model: the config's opt["model"] -> (module, criterion)."""
    name = model_cfg.get("name", "SimpleSR")
    if name == "SimpleSR":
        return (SimpleCNN(scale_factor=4, channels=int(model_cfg.get("in_channel", 1)),
                          dtype=dtype), image_compare_loss)
    if name == "RRDBNet":
        nf = int(model_cfg.get("hidden_size", 64))
        # pretraining targets are sigma-scaled: no [0,1] clamp (see RRDBNet)
        return (RRDBNet(in_nc=int(model_cfg.get("in_channel", 1)),
                        out_nc=int(model_cfg.get("out_channel", 1)), nf=nf,
                        nb=int(model_cfg.get("num_block", 17)), gc=nf // 2, dtype=dtype,
                        clamp_output=False), l1_loss)
    raise ValueError(f"unknown pretrain model name: {name}")


def load_encoder_params(path: str, map_location=None) -> dict:
    """An encoder state_dict from a `pretrain_*_E*` checkpoint directory."""
    return CheckpointManager.restore(path, map_location=map_location)["params"]


class EncoderTrainer:
    def __init__(
        self,
        module: nn.Module,
        criterion: Callable,
        *,
        device: torch.device,
        optimizer: str = "adam",
        lr: float = 1e-4,
        checkpoint_dir: Optional[str] = None,
        name: str = "encoder",
    ):
        self.device = torch.device(device)
        self.module = module.to(self.device)
        self._train_module = data_parallel(self.module, self.device)
        self.criterion = criterion
        self.optimizer = get_optimizer(optimizer, list(module.parameters()), lr)
        self.checkpoint_dir = checkpoint_dir
        self.name = name
        self.iteration = 0
        self.epoch = 0  # the next epoch to run

    def _put(self, arr) -> torch.Tensor:
        return torch.as_tensor(np.asarray(arr)).to(self.device, non_blocking=True)

    def train_step(self, lr_img: torch.Tensor, hr_img: torch.Tensor) -> torch.Tensor:
        """One optimizer step; returns the loss as a device scalar."""
        self.module.train()
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.criterion(self._train_module(lr_img), hr_img)
        loss.backward()
        self.optimizer.step()
        self.iteration += 1
        return loss.detach()

    def train_epoch(self, data_handler, epoch: int) -> tuple:
        """(mean loss over the ranks, steps) of one pass over the train split;
        the losses are read from the device once, at the end."""
        losses = [self.train_step(self._put(b["LR"]), self._put(b["HR"]))
                  for b in data_handler.train_batches(epoch=epoch)]
        if not losses:
            return float("nan"), 0
        return float(mean_across(torch.stack(losses).mean())), len(losses)

    @torch.no_grad()
    def predict(self, lr_img: torch.Tensor) -> torch.Tensor:
        self.module.eval()
        return self.module(lr_img)

    def evaluate(self, data_handler) -> dict:
        """The six metrics in Kelvin over the val split (pretrain.py's
        argument order: SR first), of the global batches under several ranks."""
        metrics = ValidationMetrics(create_metric_dict())
        for batch in data_handler.val_batches():
            out = self.predict(self._put(batch["LR"])).float()
            hr, months = (torch.as_tensor(np.asarray(batch[k])) for k in ("HR", "months"))
            out, hr, months = (all_gather_rows(t) for t in (out, hr, months))
            inv = data_handler.inverse_transform(
                {"SR": out.cpu().numpy(), "HR": hr.numpy()}, months.numpy())
            metrics.update(inv["SR"], inv["HR"])
        return metrics.compute_metrics()

    def save_results(self, data_handler, out_dir: str, max_batches: int = 15) -> int:
        """The IT/SR/HR plate of the first sample of each of the first
        `max_batches` validation batches, in Kelvin, as `result_{i}.png`;
        returns how many were written."""
        from .visualization import ImageContainer

        os.makedirs(out_dir, exist_ok=True)
        saved = 0
        for i, batch in enumerate(data_handler.val_batches()):
            if i >= max_batches:
                break
            lr = self._put(batch["LR"])
            images = {"SR": self.predict(lr).float().cpu().numpy(), "HR": batch["HR"],
                      "INF": bicubic_up4(lr).cpu().numpy()}
            inv = data_handler.inverse_transform(images, batch["months"])
            ImageContainer(inv, n_images=1).save_it_sr_hr_plot(
                os.path.join(out_dir, f"result_{i}.png"))
            saved += 1
        return saved

    def save(self, epoch: int) -> Optional[str]:
        """Rank 0 writes `pretrain_<name>_E{epoch}`; every rank waits for it."""
        if not self.checkpoint_dir:
            return None
        path = os.path.abspath(os.path.join(self.checkpoint_dir,
                                            f"pretrain_{self.name}_E{epoch}"))
        if rank() == 0:
            os.makedirs(path, exist_ok=True)
            tmp = os.path.join(path, f"{STATE_FILE}.tmp")
            torch.save({"params": self.module.state_dict(),
                        "opt_state": self.optimizer.state_dict(),
                        "epoch": int(epoch), "iteration": self.iteration}, tmp)
            os.replace(tmp, os.path.join(path, STATE_FILE))
        barrier()
        return path

    def resume(self, path: str) -> None:
        """Params, optimizer state and counters; training goes on with the
        epoch after the checkpoint's."""
        state = CheckpointManager.restore(path, map_location=self.device)
        self.module.load_state_dict(state["params"], strict=True)
        self.optimizer.load_state_dict(state["opt_state"])
        self.iteration = int(state["iteration"])
        self.epoch = int(state["epoch"]) + 1


def run_pretraining(opt: dict, data_handler, trainer: EncoderTrainer,
                    logger: Optional[logging.Logger] = None, wandb_logger=None,
                    results_dir: Optional[str] = None) -> list:
    """pretrain.py's epoch loop: train, evaluate, log (and to `wandb_logger`:
    the epoch, the train loss and the validation metrics), save; then, with
    `results_dir`, write the result plates there (pretrain.py passes
    `path.results` and the logger on rank 0 only). Returns one record per
    epoch: {"epoch", "train_loss", "steps", "train_sec", "val",
    "checkpoint"}."""
    logger = logger or logging.getLogger("base")
    epochs = int(opt["train"]["epoch"])
    records = []
    while trainer.epoch < epochs:
        epoch = trainer.epoch
        t0 = time.perf_counter()
        train_loss, steps = trainer.train_epoch(data_handler, epoch)
        train_sec = time.perf_counter() - t0
        val = trainer.evaluate(data_handler)
        logger.info(
            f"Epoch [{epoch + 1}/{epochs}], Iter {trainer.iteration}, "
            f"Train Loss: {train_loss:.4f}, Val PSNR: {val['PSNR']:.4f}, "
            f"SSIM: {val['SSIM']:.4f}, RMSE: {val['RMSE']:.4f}, MSE: {val['MSE']:.4f}")
        if wandb_logger:
            step = trainer.iteration
            wandb_logger.log_metrics({"epoch": epoch + 1}, commit=False, step=step)
            wandb_logger.log_train_metrics({"loss": train_loss}, commit=False, step=step)
            wandb_logger.log_val_metrics(val, commit=False, step=step)
            wandb_logger.commit(step=step)
        path = trainer.save(epoch)
        trainer.epoch = epoch + 1
        records.append({"epoch": epoch, "train_loss": train_loss, "steps": steps,
                        "train_sec": train_sec, "val": val, "checkpoint": path})
    if results_dir:
        n = trainer.save_results(data_handler, results_dir)
        logger.info(f"Saved {n} IT/SR/HR result plates to {results_dir}.")
    return records
