"""Reference PyTorch checkpoints into the port (counterpart of
srewd_tpu/utils/torch_convert.py).

The reference's `I{iter}_E{epoch}_gen.pth` is the state dict of its
<Arch>Diffusion module (DDPM.save_network, model.py:183-186): `denoise_fn.*`
is the UNet, `cnn.*` a SimpleCNN encoder (resdiff_diffusion.py:50),
`rrdb_encoder.*` an RRDBNet (srdiff_diffusion.py:69), and twelve schedule
buffers that the port derives from the config instead. The port's modules
carry the reference's member names (models/unet.py, simple_cnn.py,
rrdb.py), so a UNet or encoder state dict needs no renaming and no
re-layout: converting is splitting the keys, dropping what the model does
not define, filling what the reference lacks from the model's fresh init,
and checking every leaf's shape against the model.

  * The reference registers J=4 `hf_ca_list` modules (resdiff/unet.py:72-76)
    but uses len(channel_multiplier) - 1 of them; the rest are dropped
    (`drop_unused_cross_attention`).
  * physrdiff's reference UNet never defines its `fd_spliter`
    (physrdiff/unet.py:150): the port's keeps its init (`merge_with_init`).

Pretrain-era encoder files (`pretrain_<name>_E{e}_gen.pth`, pretrain.py:
255-256) are a bare SimpleCNN or RRDBNet state dict: `convert_encoder_state`.
`reference_checkpoint` writes the other way: a port model's weights in the
reference's `_gen.pth` layout.
"""

from __future__ import annotations

import re
from collections import OrderedDict
from collections.abc import Mapping

import numpy as np
import torch

from ..diffusion.schedule import make_beta_schedule
from ..models.rrdb import RRDBNet
from ..models.simple_cnn import SimpleCNN
from ..models.unet import VARIANTS

# Registered by the reference's GaussianDiffusion (diffusion.py:49-96);
# derived from the beta schedule here, never loaded.
SCHEDULE_BUFFERS = (
    "betas", "alphas_cumprod", "alphas_cumprod_prev",
    "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod",
    "log_one_minus_alphas_cumprod", "sqrt_recip_alphas_cumprod",
    "sqrt_recipm1_alphas_cumprod", "posterior_variance",
    "posterior_log_variance_clipped", "posterior_mean_coef1",
    "posterior_mean_coef2",
)
_ENCODER_PREFIX = {"SimpleSR": "cnn.", "RRDBNet": "rrdb_encoder."}
_ENCODER_ARCHS = {"SimpleSR": ("resdiff", "phydiff"), "RRDBNet": ("srdiff", "physrdiff")}


def convert_diffusion_checkpoint(state_dict: Mapping, arch: str) -> dict:
    """A reference `_gen.pth` state dict -> {"unet": state dict, "encoder":
    state dict or None}, split on the reference's member names. Schedule
    buffers are dropped; any other key, an encoder the architecture does not
    take, or a file without `denoise_fn.*` raises."""
    if arch not in VARIANTS:
        raise ValueError(f"unknown architecture {arch!r} (one of {VARIANTS})")
    parts = {"unet": OrderedDict(), "SimpleSR": OrderedDict(), "RRDBNet": OrderedDict()}
    prefixes = {"denoise_fn.": "unet", **{p: n for n, p in _ENCODER_PREFIX.items()}}
    for k, v in state_dict.items():
        prefix = next((p for p in prefixes if k.startswith(p)), None)
        if prefix is not None:
            parts[prefixes[prefix]][k[len(prefix):]] = v
        elif k not in SCHEDULE_BUFFERS:
            raise ValueError(f"unrecognized checkpoint key: {k}")
    if not parts["unet"]:
        raise ValueError(
            "no denoise_fn.* keys — is this a _gen.pth diffusion checkpoint? "
            "(for encoder pretrain checkpoints use convert_encoder_state, or "
            "convert_torch_checkpoint --encoder)")
    encoder = None
    for name in ("SimpleSR", "RRDBNet"):
        if parts[name]:
            if arch not in _ENCODER_ARCHS[name]:
                raise ValueError(f"{_ENCODER_PREFIX[name]}* keys ({name}) in a checkpoint "
                                 f"converted as {arch}")
            encoder = parts[name]
    return {"unet": parts["unet"], "encoder": encoder}


def drop_unused_cross_attention(unet_state: Mapping, n_boundaries: int) -> OrderedDict:
    """The UNet state without `hf_ca_list.{i}.*` for i >= n_boundaries
    (len(channel_multiplier) - 1): registered by the reference, never used."""
    def unused(key):
        m = re.match(r"hf_ca_list\.(\d+)\.", key)
        return m is not None and int(m.group(1)) >= n_boundaries

    return OrderedDict((k, v) for k, v in unet_state.items() if not unused(k))


def merge_with_init(converted: Mapping, init: Mapping) -> OrderedDict:
    """`init` (a model's state dict) with the converted tensors in place:
    a key the model lacks, or a leaf of another shape, raises and names it;
    a key the checkpoint lacks keeps the model's value."""
    extra = sorted(set(converted) - set(init))
    if extra:
        raise ValueError(f"converted params not in model: {extra}")
    for k, v in converted.items():
        if tuple(v.shape) != tuple(init[k].shape):
            raise ValueError(f"shape mismatch at {k}: checkpoint {tuple(v.shape)}, "
                             f"model {tuple(init[k].shape)}")
    return OrderedDict((k, converted.get(k, v)) for k, v in init.items())


def load_reference_checkpoint(model, state_dict: Mapping, n_boundaries: int) -> dict:
    """Load a reference `_gen.pth` state dict into a DiffusionModel in place
    (UNet, and the encoder where the file holds one); returns the converted
    parts. n_boundaries: len(channel_multiplier) - 1 of the model's config."""
    converted = convert_diffusion_checkpoint(state_dict, model.arch)
    unet = drop_unused_cross_attention(converted["unet"], n_boundaries)
    model.unet.load_state_dict(merge_with_init(unet, model.unet.state_dict()), strict=True)
    if converted["encoder"] is not None:
        if model.encoder is None:
            raise ValueError(f"the checkpoint holds encoder weights, but the config builds "
                             f"no encoder for {model.arch}")
        model.encoder.load_state_dict(
            merge_with_init(converted["encoder"], model.encoder.state_dict()), strict=True)
    return converted


def encoder_kind(state_dict: Mapping) -> str:
    """"RRDBNet" when the state dict has `RRDB_trunk.*`, else "SimpleSR"."""
    return "RRDBNet" if any(k.startswith("RRDB_trunk.") for k in state_dict) else "SimpleSR"


def convert_encoder_state(state_dict: Mapping) -> tuple:
    """A reference pretrain checkpoint -> (kind, state dict), checked by
    loading it into a fresh encoder of the shapes the file gives (an
    RRDBNet's depth and widths are read off its keys). A missing,
    unexpected or misshapen key raises."""
    kind = encoder_kind(state_dict)
    if kind == "RRDBNet":
        nb = len({k.split(".")[1] for k in state_dict if k.startswith("RRDB_trunk.")})
        first = state_dict["conv_first.weight"]
        module = RRDBNet(in_nc=first.shape[1], out_nc=state_dict["conv_last.weight"].shape[0],
                         nf=first.shape[0], nb=nb,
                         gc=state_dict["RRDB_trunk.0.RDB1.conv1.weight"].shape[0],
                         clamp_output=False)
    else:
        module = SimpleCNN(channels=state_dict["conv1.weight"].shape[1])
    module.load_state_dict(state_dict, strict=True)
    return kind, OrderedDict((k, v) for k, v in state_dict.items())


def schedule_buffers(cfg: dict) -> "OrderedDict[str, torch.Tensor]":
    """The reference's twelve schedule buffers of a beta-schedule config
    (diffusion.py:49-96), float32."""
    betas = make_beta_schedule(cfg.get("schedule", "linear"), int(cfg.get("n_timestep", 1000)),
                               float(cfg.get("linear_start", 1e-6)),
                               float(cfg.get("linear_end", 1e-2)),
                               float(cfg.get("cosine_s", 8e-3)))
    acp = np.cumprod(1.0 - betas)
    acp_prev = np.append(1.0, acp[:-1])
    post_var = betas * (1.0 - acp_prev) / (1.0 - acp)
    values = (betas, acp, acp_prev, np.sqrt(acp), np.sqrt(1.0 - acp), np.log(1.0 - acp),
              np.sqrt(1.0 / acp), np.sqrt(1.0 / acp - 1), post_var,
              np.log(np.maximum(post_var, 1e-20)), betas * np.sqrt(acp_prev) / (1.0 - acp),
              (1.0 - acp_prev) * np.sqrt(1.0 - betas) / (1.0 - acp))
    return OrderedDict((k, torch.from_numpy(np.asarray(v, np.float32)))
                       for k, v in zip(SCHEDULE_BUFFERS, values))


def reference_checkpoint(arch: str, unet_state: Mapping, schedule_cfg: dict,
                         encoder_state: Mapping | None = None) -> "OrderedDict[str, torch.Tensor]":
    """A DiffusionModel's weights in the reference's `_gen.pth` layout: the
    UNet's state under `denoise_fn.` (physrdiff's without its spliter, which
    the reference never defines), the encoder's under `cnn.` or
    `rrdb_encoder.`, and the schedule buffers of `schedule_cfg`. Tensors on
    the CPU."""
    out = OrderedDict()
    for k, v in unet_state.items():
        if not (arch == "physrdiff" and k.startswith("fd_spliter.")):
            out["denoise_fn." + k] = v.detach().cpu()
    if encoder_state is not None:
        prefix = _ENCODER_PREFIX[encoder_kind(encoder_state)]
        for k, v in encoder_state.items():
            out[prefix + k] = v.detach().cpu()
    out.update(schedule_buffers(schedule_cfg))
    return out
