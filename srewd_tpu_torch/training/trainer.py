"""DiffusionTrainer: the train step, EMA, checkpoints and resume, and the
train / validation driver loops (port of srewd_tpu/training/trainer.py).

One train step: the loss of one draw (t, gamma, noise, dropout), backward
through the kernels (K1 forward with the row log-sum-exp, K2 backward, K3
with its recompute backward), optional global-norm clipping, the optimizer
step, then the EMA update. Steps are dispatched without waiting for the
card: the loss stays a device scalar, and `run_training` reads the pending
losses once per `print_freq` steps (one host read per interval).

Step randomness is a function of (seed, step), as the JAX step folds the
step into its key: t, gamma's uniforms and the noise come from a generator
seeded per step, and the device's default generator, which nn.Dropout draws
from, is seeded per step too. A resumed run therefore repeats the first
run's steps without any saved generator state; `run_training` also resumes
inside an epoch, skipping the batches the checkpoint's steps consumed.

The encoder (srdiff, physrdiff, and resdiff/phydiff with one) is part of
the trainer's state: in the optimizer only when unlocked, and always in the
checkpoint, in resume and in the EMA (JAX's EMA maps over the whole params
tree). The UNet's entries keep their names (`params`, `ema_params`); the
encoder's are `encoder_params` and `ema_encoder_params`.

Validation samples through a separate copy of the model, loaded with the
trainer's weights or the EMA, never through the trainer's own modules.
Left out (ROADMAP.md Queue 1): the device data cache and prefetcher, wandb,
PNG visualisation.
"""

from __future__ import annotations

import copy
import logging
import time
from typing import Optional

import numpy as np
import torch

from ..diffusion.schedule import Schedule
from ..models.factory import DiffusionModel
from ..utils.profiling import StepTimer
from .checkpoint import CheckpointManager
from .metrics import TrainMetrics, ValidationMetrics, create_metric_dict
from .optimizers import clip_by_global_norm_, get_optimizer, norm_parameters

_VAL_STREAM = 2_000_000_000  # the JAX trainer's fold for validation keys


def step_seed(seed: int, step: int, stream: int = 0) -> int:
    """A well-mixed 63-bit seed for (seed, step, stream)."""
    state = np.random.SeedSequence([int(seed), int(step), int(stream)]).generate_state(1, np.uint64)
    return int(state[0]) >> 1


def _seed_default_generator(device: torch.device, seed: int) -> None:
    """Seed the default generator of `device` (the one nn.Dropout draws from)."""
    if device.type == "cuda":
        idx = device.index if device.index is not None else torch.cuda.current_device()
        torch.cuda.default_generators[idx].manual_seed(seed)
    else:
        torch.default_generator.manual_seed(seed)


class DiffusionTrainer:
    def __init__(
        self,
        model: DiffusionModel,
        schedule_train: Schedule,
        schedule_val: Schedule,
        *,
        device: torch.device,
        optimizer: str = "adam",
        lr: float = 1e-4,
        grad_clip: Optional[float] = None,
        finetune_norm: bool = False,
        ema_decay: Optional[float] = None,
        ema_start: int = 0,
        seed: int = 0,
        checkpoint_dir: Optional[str] = None,
        checkpoint_keep: Optional[int] = None,
        sampler_kwargs: Optional[dict] = None,
    ):
        self.model = model
        self.device = torch.device(device)
        self.schedule_train = schedule_train
        self.schedule_val = schedule_val
        self.sampler_kwargs = dict(sampler_kwargs or {})
        self.grad_clip = float(grad_clip) if grad_clip else None
        self.ema_decay = ema_decay
        self.ema_start = ema_start
        self.seed = int(seed)
        self.step = 0
        self.epoch = 0
        model.to(self.device)
        unet, encoder = model.unet, model.encoder
        # finetune_norm: only the GroupNorm affine parameters are stepped
        self.trainable = ([p for _, p in norm_parameters(unet)] if finetune_norm
                          else list(unet.parameters()))
        if encoder is not None and not model.lock_encoder and not finetune_norm:
            self.trainable += list(encoder.parameters())
        if encoder is not None and model.lock_encoder:
            encoder.requires_grad_(False)
        self.optimizer = get_optimizer(optimizer, self.trainable, lr)
        self.ema = self.ema_encoder = None
        if ema_decay is not None:
            self.ema = _copy_state(unet)
            self.ema_encoder = _copy_state(encoder) if encoder is not None else None
        self.ckpt = CheckpointManager(checkpoint_dir, keep=checkpoint_keep) if checkpoint_dir else None
        self._generator = torch.Generator(device=self.device)
        self._val_model: Optional[DiffusionModel] = None

    # ------------------------------------------------------------------ state
    def state(self) -> dict:
        state = {"params": self.model.unet.state_dict(),
                 "opt_state": self.optimizer.state_dict(),
                 "step": self.step, "epoch": self.epoch}
        if self.model.encoder is not None:
            state["encoder_params"] = self.model.encoder.state_dict()
        if self.ema is not None:
            state["ema_params"] = self.ema
        if self.ema_encoder is not None:
            state["ema_encoder_params"] = self.ema_encoder
        return state

    def save(self) -> Optional[str]:
        if self.ckpt is None:
            return None
        return self.ckpt.save(self.state(), self.step, self.epoch)

    def resume(self, path: str) -> None:
        """Restore params, optimizer state, EMA, step and epoch."""
        state = CheckpointManager.restore(path, map_location=self.device)
        self.model.unet.load_state_dict(state["params"], strict=True)
        encoder = self.model.encoder
        if encoder is not None:
            encoder.load_state_dict(state["encoder_params"], strict=True)
        self.optimizer.load_state_dict(state["opt_state"])
        if self.ema is not None:
            src = state.get("ema_params") or state["params"]
            self.ema = {k: v.detach().clone().to(self.device) for k, v in src.items()}
        if self.ema_encoder is not None:
            src = state.get("ema_encoder_params") or state["encoder_params"]
            self.ema_encoder = {k: v.detach().clone().to(self.device) for k, v in src.items()}
        self.step = int(state["step"])
        self.epoch = int(state["epoch"])

    def load_params_tolerant(self, path: str) -> None:
        """Params only, non-strict (the finetune_norm load): tensors present
        in both take the checkpoint's values, the rest keep their init;
        optimizer state and counters start fresh."""
        loaded = CheckpointManager.restore(path, map_location=self.device)
        loaded = loaded.get("params", loaded)
        own = self.model.unet.state_dict()
        for k, v in loaded.items():
            if k in own and v.shape != own[k].shape:
                raise ValueError(f"checkpoint shape mismatch at {k}: {tuple(v.shape)} vs "
                                 f"{tuple(own[k].shape)}")
        self.model.unet.load_state_dict({k: v for k, v in loaded.items() if k in own},
                                        strict=False)
        if self.ema is not None:
            self.ema = _copy_state(self.model.unet)

    # ------------------------------------------------------------------ steps
    def _device_batch(self, batch: dict) -> dict:
        return {k: torch.as_tensor(batch[k]).to(self.device, non_blocking=True)
                for k in ("HR", "LR")}

    def train_on_batch_async(self, batch: dict) -> torch.Tensor:
        """One train step; returns the loss as a device scalar without reading it."""
        b = self._device_batch(batch)
        self._generator.manual_seed(step_seed(self.seed, self.step))
        _seed_default_generator(self.device, step_seed(self.seed, self.step, 1))
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.model.loss(b, self.schedule_train, generator=self._generator, train=True)
        loss.backward()
        if self.grad_clip is not None:
            clip_by_global_norm_(self.trainable, self.grad_clip)
        self.optimizer.step()
        self.step += 1
        if self.ema is not None and self.step >= self.ema_start:
            self._ema_update()
        return loss.detach()

    def train_on_batch(self, batch: dict) -> float:
        return float(self.train_on_batch_async(batch))

    @torch.no_grad()
    def _ema_update(self) -> None:
        """ema = ema * decay + params * (1 - decay), leaf by leaf, over the
        UNet and the encoder."""
        pairs = [(self.ema, self.model.unet)]
        if self.ema_encoder is not None:
            pairs.append((self.ema_encoder, self.model.encoder))
        for ema_state, module in pairs:
            params = module.state_dict()
            keys = [k for k, v in params.items() if v.is_floating_point()]
            ema = [ema_state[k] for k in keys]
            torch._foreach_mul_(ema, self.ema_decay)
            torch._foreach_add_(ema, [params[k] for k in keys], alpha=1.0 - self.ema_decay)

    @torch.no_grad()
    def sample_batch(self, batch: dict, use_ema: bool = False) -> torch.Tensor:
        """Super-resolve a batch with the trainer's sampler settings, through a
        copy of the model loaded with the current weights (or the EMA)."""
        val = self._val_model
        if val is None:
            val = self._val_model = copy.deepcopy(self.model)
            for module in (m for m in (val.unet, val.encoder) if m is not None):
                for p in module.parameters():
                    p.grad = None
                    p.requires_grad_(False)
        ema = use_ema and self.ema is not None
        val.unet.load_state_dict(self.ema if ema else self.model.unet.state_dict(), strict=True)
        if val.encoder is not None:
            val.encoder.load_state_dict(
                self.ema_encoder if ema else self.model.encoder.state_dict(), strict=True)
        b = self._device_batch(batch)
        gen = torch.Generator(device=self.device).manual_seed(
            step_seed(self.seed, _VAL_STREAM + self.step))
        return val.generate_sr({"LR": b["LR"]}, self.schedule_val, generator=gen,
                               **self.sampler_kwargs)


def _copy_state(module) -> dict:
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def run_training(opt: dict, data_handler, trainer: DiffusionTrainer,
                 logger: Optional[logging.Logger] = None) -> dict:
    """The train driver loop at the reference's cadence: n_iter steps; every
    print_freq, read the pending losses and log them; every val_freq,
    validate (one batch, or the whole val set when full_val_freq divides
    the step); every save_checkpoint_freq, save. Returns
    {"losses": [(step, loss)], "val": [(step, metrics)], "steps_per_sec"}.
    """
    logger = logger or logging.getLogger("base")
    tcfg = opt["train"]
    n_iter = int(tcfg["n_iter"])
    print_freq = int(tcfg.get("print_freq", 100))
    val_freq = int(tcfg.get("val_freq", 10000))
    full_val_freq = int(tcfg.get("full_val_freq", val_freq))
    save_freq = int(tcfg.get("save_checkpoint_freq", 10000))
    ema_val = bool((tcfg.get("ema_scheduler") or {}).get("use_for_val", False))

    train_metrics = TrainMetrics()
    timer = StepTimer()
    losses: list = []
    vals: list = []
    pending: list = []  # (step, device loss) not read yet

    def flush_losses() -> None:
        if not pending:
            return
        values = torch.stack([v for _, v in pending]).cpu().tolist()
        for (step, _), v in zip(pending, values):
            losses.append((step, v))
            train_metrics.update({"l_pix": v})
        pending.clear()

    # resume inside an epoch: skip the batches the checkpoint's steps consumed
    spe = data_handler.steps_per_epoch("train")
    if spe == 0:
        raise ValueError("the train split holds less than one batch")
    skip = trainer.step - (trainer.epoch - 1) * spe if trainer.epoch > 0 else 0
    if 0 < skip < spe:
        trainer.epoch -= 1
    else:
        skip = 0
    timer.start()
    while trainer.step < n_iter:
        trainer.epoch += 1
        for batch in data_handler.train_batches(epoch=trainer.epoch, skip=skip):
            if trainer.step >= n_iter:
                break
            pending.append((trainer.step + 1, trainer.train_on_batch_async(batch)))
            timer.tick()
            if trainer.step % print_freq == 0:
                flush_losses()
                logger.info(
                    f"Epoch: {trainer.epoch:5}  |  Iteration: {trainer.step:8} |"
                    f" {train_metrics.metrics2str()} | {timer.summary_str()}"
                )
                train_metrics.reset()
            if trainer.step % val_freq == 0:
                full = trainer.step % full_val_freq == 0
                metrics = run_validation(opt, data_handler, trainer, logging.getLogger("val"),
                                         max_batches=None if full else 1, use_ema=ema_val)
                vals.append((trainer.step, metrics))
            if trainer.step % save_freq == 0:
                logger.info("Saving models and training states.")
                trainer.save()
        skip = 0
    flush_losses()
    logger.info("End of training.")
    trainer.save()
    return {"losses": losses, "val": vals, "steps_per_sec": timer.steps_per_sec}


def run_validation(opt: dict, data_handler, trainer: DiffusionTrainer,
                   logger: Optional[logging.Logger] = None, max_batches: Optional[int] = None,
                   use_ema: bool = False) -> dict:
    """Sample, inverse-transform to Kelvin, and stream the metrics."""
    logger = logger or logging.getLogger("val")
    val_metrics = ValidationMetrics(create_metric_dict())
    t0 = time.time()
    for i, batch in enumerate(data_handler.val_batches()):
        if max_batches is not None and i >= max_batches:
            break
        sr = trainer.sample_batch(batch, use_ema=use_ema)
        images = {"SR": sr.cpu().numpy(), "HR": np.asarray(batch["HR"])}
        inv = data_handler.inverse_transform(images, batch["months"])
        val_metrics.update(inv["HR"], inv["SR"])
    val_time = time.time() - t0
    metrics = val_metrics.compute_metrics()
    logger.info(
        f"Epoch: {trainer.epoch:5}  |  Iteration: {trainer.step:8} |"
        f" {val_metrics.metrics2str()} | val_time: {val_time:.1f}s"
    )
    return metrics
