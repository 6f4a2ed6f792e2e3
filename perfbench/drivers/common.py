"""Set-up shared by the drivers: the system under test and the plain
reference, each loaded with the same seeded weights, and the comparison
numbers."""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import inputs
from ..reference import nets

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def seeded_states(model_cfg: dict, seed: int, device) -> tuple:
    """(unet state, encoder state or None) of the seeded weights, made on
    `device` from the reference's parameter list."""
    unet, enc = nets.build(model_cfg, "meta")
    return (inputs.weights(unet, seed, 0, device),
            None if enc is None else inputs.weights(enc, seed, 1, device))


def program_model(model_cfg: dict, dtype: str, seed: int, device):
    """The port's DiffusionModel (`build_model`, the entry every CLI uses)
    on `device` in the compute dtype, holding the seeded weights."""
    from srewd_tpu_torch.models.factory import build_model

    with torch.device(device):
        model = build_model(model_cfg, dtype=DTYPES[dtype])
    u, e = seeded_states(model_cfg, seed, device)
    model.unet.load_state_dict(u, strict=True)
    if e is not None:
        model.encoder.load_state_dict(e, strict=True)
    return model


def reference_model(model_cfg: dict, seed: int, device) -> tuple:
    """(unet, encoder) of the plain reference with the same seeded weights."""
    unet, enc = nets.build(model_cfg, device)
    u, e = seeded_states(model_cfg, seed, device)
    unet.load_state_dict(u, strict=True)
    if enc is not None:
        enc.load_state_dict(e, strict=True)
    return unet, enc


def field_gaps(got: np.ndarray, ref: np.ndarray) -> dict:
    """max |got - ref| and the RMS of (got - ref) over the RMS of ref,
    float64; NaN or a shape mismatch reads inf."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if got.shape != ref.shape or not np.isfinite(got).all():
        return {"max_abs": math.inf, "rel_rmse": math.inf}
    d = got - ref
    return {"max_abs": float(np.abs(d).max()),
            "rel_rmse": float(np.sqrt((d * d).mean() / (ref * ref).mean()))}


def free(device) -> None:
    import gc

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def pick(seed: int, population: list, k: int, always: list = ()) -> list:
    """k members of `population` drawn from the seed, `always` among them."""
    rng = np.random.default_rng(inputs.derive(seed, "check"))
    rest = [p for p in population if p not in always]
    take = list(always) + [rest[i] for i in rng.permutation(len(rest))[:max(0, k - len(always))]]
    return sorted(take)


def peak_bytes(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if torch.device(
        device).type == "cuda" else 0

