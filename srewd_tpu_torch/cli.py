"""Shared CLI plumbing of the port (counterpart of srewd_tpu/cli.py): the
commented-JSON config, the npy data pipeline with month-grouped scalers,
seeding, the model's weights (seeded random, the pretrained encoder, a
checkpoint), the trainer's construction and the device choice.
"""

from __future__ import annotations

import logging

import numpy as np
import torch
import torch.nn as nn

from .configs.config import Config
from .data.pipeline import DataHandler
from .training.checkpoint import CheckpointManager
from .utils.jax_params import load_npz, unet_state_from_jax
from .utils.seeding import set_seeds

__all__ = ["Config", "build_data_handler", "build_trainer", "sampler_kwargs", "set_seeds",
           "init_weights", "load_model_weights", "random_init_", "resolve_device",
           "denormalize"]


def build_data_handler(opt: dict, storage_root: str | None = None, **overrides) -> DataHandler:
    """DataHandler from opt["data"], single-process (no jax process count)."""
    d = opt["data"]
    kw = dict(
        dataroot=d["dataroot"],
        variables=d["variables"],
        months_subset=d.get("months_subset"),
        groups=d.get("transform_groups"),
        transformation=d.get("transformation", "GlobalStandardScaling"),
        train_min_date=d.get("train_min_date"),
        train_max_date=d.get("train_max_date"),
        val_min_date=d.get("val_min_date"),
        val_max_date=d.get("val_max_date"),
        train_date_ranges=d.get("train_date_ranges"),
        val_date_ranges=d.get("val_date_ranges"),
        train_batch_size=int(d.get("batch_size", 4)),
        val_batch_size=int(d.get("val_batch_size", 8)),
        shuffle=bool(d.get("use_shuffle", True)),
        lead_time=int(d.get("lead_time", 0) or 0),
        delays=d.get("delays"),
        storage_root=storage_root or d["dataroot"],
        read_threads=int(d.get("num_workers", 16)),
    )
    kw.update(overrides)
    return DataHandler(**kw).process_data()


def sampler_kwargs(opt: dict) -> dict:
    """Sampler settings from opt["model"]["diffusion"], as srewd_tpu.cli takes them."""
    dcfg = opt["model"].get("diffusion") or {}
    kw: dict = {}
    if dcfg.get("sampler"):
        kw = {
            "sampler": dcfg["sampler"],
            "ddim_steps": int(dcfg.get("ddim_steps", 50)),
            # eta defaults to 1 only where the key is absent (srewd_tpu/cli.py)
            "ddim_eta": float(dcfg.get("ddim_eta", 1.0)),
        }
        if dcfg.get("tau_spacing"):
            kw["tau_spacing"] = str(dcfg["tau_spacing"])
    if "clip_denoised" in dcfg:
        kw["clip_denoised"] = bool(dcfg["clip_denoised"])
    return kw


def build_trainer(opt: dict, device: torch.device):
    """The DiffusionTrainer of opt (counterpart of srewd_tpu.cli.build_trainer,
    without the multihost branch): float32 model with seeded random weights,
    the encoder from `pretrained_model.model_path` when the config names one
    (after init, before resume), the optimizer with optional global-norm
    clipping and finetune_norm, EMA, checkpoints, the sampler settings, and
    resume."""
    from .diffusion.schedule import Schedule
    from .models.factory import build_model
    from .training.trainer import DiffusionTrainer

    with torch.device(device):  # parameters made on the device, not copied there
        model = build_model(opt["model"])
    init_weights(model, opt)
    bs = opt["model"]["beta_schedule"]
    ocfg = opt["train"]["optimizer"]
    ema_cfg = opt["train"].get("ema_scheduler") or {}
    finetune_norm = bool(opt["model"].get("finetune_norm"))
    keep = opt["train"].get("checkpoint_keep")
    trainer = DiffusionTrainer(
        model,
        Schedule.from_config(bs["train"], device=device),
        Schedule.from_config(bs.get("val", bs["train"]), device=device),
        device=device,
        optimizer=ocfg.get("type", "adam"),
        lr=float(ocfg.get("lr", 1e-4)),
        grad_clip=ocfg.get("grad_clip"),
        finetune_norm=finetune_norm,
        ema_decay=(float(ema_cfg.get("ema_decay", 0.9999))
                   if ema_cfg.get("enabled", False) else None),
        ema_start=int(ema_cfg.get("step_start_ema", 0)),
        seed=int(opt.get("seed", 0)),
        checkpoint_dir=opt["path"].get("checkpoint"),
        checkpoint_keep=int(keep) if keep else None,
        sampler_kwargs=sampler_kwargs(opt),
    )
    resume = opt["path"].get("resume_state")
    if resume:
        if finetune_norm:
            trainer.load_params_tolerant(resume)
        else:
            trainer.resume(resume)
    return trainer


def cuda_numerics(device: torch.device, training: bool = False) -> None:
    """Full float32 on the card: TF32 off for matmuls and convolutions. For
    training, also deterministic cuDNN algorithms (so that a resumed run
    repeats the steps of the run it resumes) chosen by timing them on the
    first call of each shape (cudnn.benchmark): cuDNN's heuristics pick
    FFT-tiled float32 algorithms for some backward convolutions, ~3x slower
    per step (PERF.md, PR 2)."""
    if device.type != "cuda":
        return
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if training:
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = True


def resolve_device(name: str) -> torch.device:
    """The requested device; a CUDA request without a card raises."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name} requested but torch.cuda.is_available() is False")
    return device


def random_init_(module: nn.Module, seed: int) -> None:
    """Seeded random weights: orthogonal conv/linear kernels and zero biases
    (the JAX package's initialisers), GroupNorm scale 1 and bias 0.

    nn.init.orthogonal_'s algorithm: normal draws from a CPU generator, made
    orthogonal by a QR decomposition, which runs on the parameters' device
    (a full-width model's QRs take seconds on the host; on the card they do
    not). Move the module before calling it; on the CPU the weights are
    exactly nn.init.orthogonal_'s.
    """
    g = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.ndim >= 2:
                rows, cols = p.shape[0], p.numel() // p.shape[0]
                a = torch.empty(rows, cols).normal_(0, 1, generator=g).to(p.device)
                q, r = torch.linalg.qr(a if rows >= cols else a.t())
                q = q * torch.diagonal(r).sign()
                p.copy_((q if rows >= cols else q.t()).reshape(p.shape))
            elif name.endswith(".weight"):  # GroupNorm scale
                p.fill_(1.0)
            else:
                p.zero_()


def init_weights(model, opt: dict) -> None:
    """Seeded random weights for the UNet and the encoder (from the config's
    `seed`, on the device the model is on), then the encoder from
    `pretrained_model.model_path` when the config names one."""
    from .training.pretrainer import load_encoder_params

    seed = int(opt.get("seed", 0))
    random_init_(model.unet, seed)
    if model.encoder is None:
        return
    random_init_(model.encoder, seed + 1)
    path = (opt["model"].get("pretrained_model") or {}).get("model_path")
    if path:
        model.encoder.load_state_dict(load_encoder_params(path), strict=True)


def load_model_weights(model, path: str, use_ema: bool = False) -> bool:
    """Load a model's weights from `path`: a checkpoint directory written by
    the port's trainer (UNet, encoder and, with `use_ema`, their EMA), or a
    `.npz` of srewd_tpu UNet params (keys = tree paths joined by '/').
    Returns whether the EMA weights were loaded: False when asked for and
    absent."""
    if path.endswith(".npz"):
        unet_sd, enc_sd, ema = unet_state_from_jax(load_npz(path)), None, False
    else:
        state = CheckpointManager.restore(path, map_location="cpu")
        ema = use_ema and state.get("ema_params") is not None
        unet_sd = state["ema_params" if ema else "params"]
        enc_sd = state.get("ema_encoder_params" if ema else "encoder_params")
    model.unet.load_state_dict(unet_sd, strict=True)
    if enc_sd is not None:
        if model.encoder is None:
            raise ValueError(f"{path} holds encoder weights, but the config builds no encoder")
        model.encoder.load_state_dict(enc_sd, strict=True)
    if use_ema and not ema:
        logging.getLogger("base").warning(
            "--use-ema requested but %s carries no EMA state (train with "
            "train.ema_scheduler.enabled); sampling with the raw weights instead", path)
    return ema


def denormalize(scalers, x: np.ndarray, months: np.ndarray) -> np.ndarray:
    """Kelvin fields: std[m] * x + mean[m] (MonthlyScalerSet semantics)."""
    if scalers.identity:
        return x
    m = np.asarray(months, np.int32)
    return scalers.std[m] * x + scalers.mean[m]
