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
seeded per step, and the device's default generator, which the UNet's
Dropout (models/layers.py) draws from, is seeded per step too. A resumed
run therefore repeats the first run's steps without any saved generator
state; `run_training` also resumes inside an epoch, skipping the batches
the checkpoint's steps consumed.

The encoder (srdiff, physrdiff, and resdiff/phydiff with one) is part of
the trainer's state: in the optimizer only when unlocked, and always in the
checkpoint, in resume and in the EMA (JAX's EMA maps over the whole params
tree). The UNet's entries keep their names (`params`, `ema_params`); the
encoder's are `encoder_params` and `ema_encoder_params`.

With a compute dtype on the model (`cli.build_trainer(dtype=)`), the
parameters, their gradients, Adam's moments and the EMA stay float32: each
layer casts its weights per call (models/layers.py).

Validation samples through a separate copy of the model, loaded with the
trainer's weights or the EMA, never through the trainer's own modules.

Data parallelism (under torchrun, parallel/): the loss is the forward of a
small module (`_Loss`) wrapped in DistributedDataParallel, so the backward
averages the gradients over the ranks; clipping, Adam, the EMA and the bf16
shadow then see the reduced gradients and identical weights on every rank.
Each rank trains on its stride of the index (`data.batch_size` rows, the
global batch world_size() times that, as the JAX package's per-host batch)
and draws over the global batch (diffusion/gaussian.py), so W ranks step
as one process at W times the batch. Rank 0 alone writes checkpoints, then
every rank passes a barrier; every rank resumes from the same one. Logged
losses are averaged over the ranks when they are read, and validation
gathers SR, HR and months before the metrics (`run_validation`).

`run_training` feeds the steps from `train.device_data_cache`'s
DeviceDataset (the split resident on the device; one process only) or else
through a DevicePrefetcher (host batches assembled and copied ahead in a
background thread), and captures a torch.profiler trace of `train.profile_steps` steps
from `train.profile_start` into `train.profile_trace_dir` when it is set.
Left out (ROADMAP.md Queue 1): wandb, PNG visualisation.
"""

from __future__ import annotations

import copy
import logging
import time
from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from ..data.device_cache import DeviceDataset
from ..data.prefetch import DevicePrefetcher, PinnedCopy
from ..diffusion.schedule import Schedule
from ..models.factory import DiffusionModel
from ..parallel import all_gather_rows, barrier, data_parallel, mean_across, rank, world_size
from ..utils.profiling import StepTimer, annotate, trace
from ..utils.seeding import member_seed
from .checkpoint import CheckpointManager
from .metrics import TrainMetrics, ValidationMetrics, create_metric_dict
from .optimizers import clip_by_global_norm_, get_optimizer, norm_parameters

_VAL_STREAM = 2_000_000_000  # the JAX trainer's fold for validation keys


def step_seed(seed: int, step: int, stream: int = 0) -> int:
    """A well-mixed 63-bit seed for (seed, step, stream)."""
    state = np.random.SeedSequence([int(seed), int(step), int(stream)]).generate_state(1, np.uint64)
    return int(state[0]) >> 1


def _seed_default_generator(device: torch.device, seed: int) -> None:
    """Seed the default generator of `device` (the one Dropout draws from)."""
    if device.type == "cuda":
        idx = device.index if device.index is not None else torch.cuda.current_device()
        torch.cuda.default_generators[idx].manual_seed(seed)
    else:
        torch.default_generator.manual_seed(seed)


class _Loss(nn.Module):
    """The training loss as a module's forward, the form DistributedDataParallel
    takes: it hooks `forward`, and DiffusionModel is no module. Holds the
    UNet and the encoder as submodules, so DDP reduces their gradients (a
    locked encoder's parameters need none)."""

    def __init__(self, model: DiffusionModel, schedule: Schedule):
        super().__init__()
        self.unet = model.unet
        if model.encoder is not None:
            self.encoder = model.encoder
        self.model = model
        self.schedule = schedule

    def forward(self, batch: dict, generator: torch.Generator) -> torch.Tensor:
        return self.model.loss(batch, self.schedule, generator=generator, train=True)


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
        self._loss = data_parallel(_Loss(model, schedule_train), self.device)
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
        """Rank 0 writes the checkpoint; every rank waits for it and gets its path."""
        if self.ckpt is None:
            return None
        if rank() == 0:
            path = self.ckpt.save(self.state(), self.step, self.epoch)
        else:
            path = self.ckpt.path_for(self.step, self.epoch)
        barrier()
        return path

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

    def reset_ema(self) -> None:
        """Where the EMA is on: set it to the current weights, UNet and encoder
        (the state of weights loaded from elsewhere)."""
        if self.ema is not None:
            self.ema = _copy_state(self.model.unet)
        if self.ema_encoder is not None:
            self.ema_encoder = _copy_state(self.model.encoder)

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
        self.reset_ema()

    # ------------------------------------------------------------------ steps
    def _device_batch(self, batch: dict) -> dict:
        """HR and LR on the trainer's device; a tensor already there is taken
        as it is (DeviceDataset's and DevicePrefetcher's batches)."""
        return {k: torch.as_tensor(batch[k]).to(self.device, non_blocking=True)
                for k in ("HR", "LR")}

    def prefetch(self, batches, depth: int = 2) -> DevicePrefetcher:
        """`batches` put on the trainer's device `depth` ahead, in a background
        thread: on the card by pinned, non-blocking copies on a side stream."""
        if self.device.type == "cuda":
            pinned = PinnedCopy(self.device)
            return DevicePrefetcher(batches, pinned.put, depth, take_fn=pinned.take)
        return DevicePrefetcher(batches, self._device_batch, depth)

    def train_on_batch_async(self, batch: dict) -> torch.Tensor:
        """One train step; returns the loss as a device scalar without reading it."""
        b = self._device_batch(batch)
        self._generator.manual_seed(step_seed(self.seed, self.step))
        _seed_default_generator(self.device, step_seed(self.seed, self.step, 1))
        self.optimizer.zero_grad(set_to_none=True)
        with annotate("loss"):
            loss = self._loss(b, self._generator)
        with annotate("backward"):
            loss.backward()
        with annotate("optimizer"):
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
    def sample_batch(self, batch: dict, use_ema: bool = False, fold: int = 0) -> torch.Tensor:
        """Super-resolve a batch with the trainer's sampler settings, through a
        copy of the model loaded with the current weights (or the EMA). The
        batch is this rank's rows: the chain draws over the global batch.

        The chain's noise is a function of (seed, step, fold): `fold` 0 is
        the validation stream, every other fold a stream of its own
        (`member_seed` over it), so the batches of one evaluation, or the
        members of an ensemble, at one step draw different noise, as the
        JAX trainer's `fold_in(key, fold)`."""
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
            member_seed(step_seed(self.seed, _VAL_STREAM + self.step), fold))
        return val.generate_sr({"LR": b["LR"]}, self.schedule_val, generator=gen,
                               **self.sampler_kwargs)


def _copy_state(module) -> dict:
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def run_training(opt: dict, data_handler, trainer: DiffusionTrainer,
                 logger: Optional[logging.Logger] = None) -> dict:
    """The train driver loop at the reference's cadence: n_iter steps; every
    print_freq, read the pending losses and log them; every val_freq,
    validate (one batch, or the whole val set when full_val_freq divides
    the step); every save_checkpoint_freq, save. Batches come from the
    device-resident split (`train.device_data_cache`) or a DevicePrefetcher.
    With `train.profile_trace_dir`, steps [profile_start, profile_start +
    profile_steps) are traced there (defaults 10 and 5). Returns
    {"losses": [(step, loss)], "val": [(step, metrics)], "steps_per_sec",
    "trace": the trace file or None}; the losses are the ranks' mean.
    """
    logger = logger or logging.getLogger("base")
    tcfg = opt["train"]
    n_iter = int(tcfg["n_iter"])
    print_freq = int(tcfg.get("print_freq", 100))
    val_freq = int(tcfg.get("val_freq", 10000))
    full_val_freq = int(tcfg.get("full_val_freq", val_freq))
    save_freq = int(tcfg.get("save_checkpoint_freq", 10000))
    ema_val = bool((tcfg.get("ema_scheduler") or {}).get("use_for_val", False))
    profile_dir = tcfg.get("profile_trace_dir")
    profile_start = int(tcfg.get("profile_start", 10))
    profile_steps = int(tcfg.get("profile_steps", 5))
    if tcfg.get("save_visualizations"):
        logger.info("train.save_visualizations is set; the port renders no PNG yet "
                    "(ROADMAP.md Queue 1 item 10), so the run writes none.")

    train_metrics = TrainMetrics()
    timer = StepTimer()
    losses: list = []
    vals: list = []
    pending: list = []  # (step, device loss) not read yet
    window = None  # the open capture: (its context, the profiler, its last step)
    trace_path = None

    def flush_losses() -> None:
        if not pending:
            return
        values = mean_across(torch.stack([v for _, v in pending])).cpu().tolist()
        for (step, _), v in zip(pending, values):
            losses.append((step, v))
            train_metrics.update({"l_pix": v})
        pending.clear()

    def close_window() -> None:
        nonlocal window, trace_path
        flush_losses()  # the traced steps have run once their losses are read
        if trainer.device.type == "cuda":
            torch.cuda.synchronize(trainer.device)
        (cm, prof, last), window = window, None
        cm.__exit__(None, None, None)
        trace_path = prof.trace_path
        logger.info(f"Profiler trace to step {last} written to {trace_path}.")

    device_cache = None
    if tcfg.get("device_data_cache") and world_size() == 1:
        device_cache = DeviceDataset(data_handler, trainer.device, "train")
        logger.info(f"Device data cache: {device_cache.nbytes / 1e6:.0f} MB "
                    f"({len(device_cache)} fields) resident on {trainer.device}.")

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
    try:
        while trainer.step < n_iter:
            trainer.epoch += 1
            if device_cache is not None:
                batches = device_cache.batches(epoch=trainer.epoch, skip=skip)
            else:
                batches = trainer.prefetch(
                    data_handler.train_batches(epoch=trainer.epoch, skip=skip))
            try:
                for batch in batches:
                    if trainer.step >= n_iter:
                        break
                    if profile_dir and trainer.step >= profile_start:
                        cm = trace(profile_dir)
                        window = (cm, cm.__enter__(), trainer.step + profile_steps)
                        profile_dir = None  # one capture per run
                    with annotate("train_step"):
                        pending.append((trainer.step + 1, trainer.train_on_batch_async(batch)))
                    timer.tick()
                    if window is not None and trainer.step >= window[2]:
                        close_window()
                    if trainer.step % print_freq == 0:
                        flush_losses()
                        logger.info(
                            f"Epoch: {trainer.epoch:5}  |  Iteration: {trainer.step:8} |"
                            f" {train_metrics.metrics2str()} | {timer.summary_str()}"
                        )
                        train_metrics.reset()
                    if trainer.step % val_freq == 0:
                        full = trainer.step % full_val_freq == 0
                        with annotate("validation"):
                            metrics = run_validation(
                                opt, data_handler, trainer, logging.getLogger("val"),
                                max_batches=None if full else 1, use_ema=ema_val)
                        vals.append((trainer.step, metrics))
                    if trainer.step % save_freq == 0:
                        logger.info("Saving models and training states.")
                        trainer.save()
            finally:
                if isinstance(batches, DevicePrefetcher):
                    batches.close()
            skip = 0
        if window is not None:  # training ended inside the window
            close_window()
    finally:
        if window is not None:  # an exception inside the window
            window[0].__exit__(None, None, None)
    flush_losses()
    logger.info("End of training.")
    trainer.save()
    return {"losses": losses, "val": vals, "steps_per_sec": timer.steps_per_sec,
            "trace": trace_path}


def run_validation(opt: dict, data_handler, trainer: DiffusionTrainer,
                   logger: Optional[logging.Logger] = None, max_batches: Optional[int] = None,
                   use_ema: bool = False) -> dict:
    """Sample, inverse-transform to Kelvin, and stream the metrics. Each rank
    samples its rows of a batch; SR, HR and months are gathered, so every
    rank computes the metrics of the global batches."""
    logger = logger or logging.getLogger("val")
    val_metrics = ValidationMetrics(create_metric_dict())
    t0 = time.time()
    for i, batch in enumerate(data_handler.val_batches()):
        if max_batches is not None and i >= max_batches:
            break
        sr = trainer.sample_batch(batch, use_ema=use_ema)
        hr, months = (torch.as_tensor(np.asarray(batch[k])) for k in ("HR", "months"))
        sr, hr, months = (all_gather_rows(t) for t in (sr, hr, months))
        images = {"SR": sr.cpu().numpy(), "HR": hr.numpy()}
        inv = data_handler.inverse_transform(images, months.numpy())
        val_metrics.update(inv["HR"], inv["SR"])
    val_time = time.time() - t0
    metrics = val_metrics.compute_metrics()
    logger.info(
        f"Epoch: {trainer.epoch:5}  |  Iteration: {trainer.step:8} |"
        f" {val_metrics.metrics2str()} | val_time: {val_time:.1f}s"
    )
    return metrics
