"""Migration of reference PyTorch checkpoints into the port, against the JAX
package's converter, and `python -m srewd_tpu_torch.convert_torch_checkpoint`
on the CPU.

No reference checkpoint is in the repository, so the reference's
`I{iter}_E{epoch}_gen.pth` layout is built from a toy port model
(`reference_checkpoint`: `denoise_fn.` + the UNet, `cnn.` or
`rrdb_encoder.` + the encoder, the twelve schedule buffers; physrdiff
without the spliter the reference never defines, and with the reference's
unused `hf_ca_list` entries added). JAX's `convert_diffusion_checkpoint` and
`drop_unused_cross_attention`, mapped back to the port's names through
utils/jax_params, must give the port's conversion bit for bit: the port's
module names are the reference's.
"""

import json
import os

import numpy as np
import pytest
import torch

from srewd_tpu.utils.torch_convert import (
    convert_diffusion_checkpoint as jax_convert_diffusion_checkpoint,
    drop_unused_cross_attention as jax_drop_unused_cross_attention)
from srewd_tpu_torch import convert_torch_checkpoint, train
from srewd_tpu_torch.cli import random_init_
from srewd_tpu_torch.data.store import make_synthetic_weatherbench
from srewd_tpu_torch.models.factory import build_model
from srewd_tpu_torch.models.rrdb import RRDBNet
from srewd_tpu_torch.models.simple_cnn import SimpleCNN
from srewd_tpu_torch.training.checkpoint import CheckpointManager
from srewd_tpu_torch.training.pretrainer import load_encoder_params
from srewd_tpu_torch.utils.jax_params import encoder_state_from_jax, unet_state_from_jax
from srewd_tpu_torch.utils.torch_convert import (
    SCHEDULE_BUFFERS, convert_diffusion_checkpoint, drop_unused_cross_attention,
    load_reference_checkpoint, reference_checkpoint)

from test_torch_port_model import one_torch_thread, toy_model_cfg  # noqa: F401

SCHED = {"schedule": "linear", "n_timestep": 1000, "linear_start": 1e-6, "linear_end": 1e-2}
ARCHS = ["sr3", "phydiff", "resdiff", "srdiff", "physrdiff"]
N_BOUNDARIES = len(toy_model_cfg("sr3")["unet"]["channel_multiplier"]) - 1
ENCODER = {
    "resdiff": {"enabled": True, "lock_weights": True, "use_encoder_prediction": True},
    "srdiff": {"hidden_size": 8, "num_block": 2, "lock_weights": True},
    "physrdiff": {"hidden_size": 8, "num_block": 2, "lock_weights": True},
}


def model_cfg(arch):
    cfg = toy_model_cfg(arch)
    if arch in ENCODER:
        cfg["pretrained_model"] = ENCODER[arch]
    return cfg


def toy_model(arch, seed):
    model = build_model(model_cfg(arch))
    random_init_(model.unet, seed)
    if model.encoder is not None:
        random_init_(model.encoder, seed + 1)
    with torch.no_grad():  # nonzero biases and norms, so every leaf is told apart
        g = torch.Generator().manual_seed(seed)
        for m in (model.unet, model.encoder):
            for p in (m.parameters() if m is not None else ()):
                if p.ndim == 1:
                    p.add_(0.1 * torch.randn(p.shape, generator=g))
    return model


def reference_file(model):
    """The reference layout of `model`, with the unused cross-attention
    modules the reference registers (J=4; the toy UNet uses two)."""
    ref = reference_checkpoint(model.arch, model.unet.state_dict(), SCHED,
                               None if model.encoder is None else model.encoder.state_dict())
    if model.unet.uses_ca:
        last = N_BOUNDARIES - 1
        for i in range(N_BOUNDARIES, 4):
            for k in [k for k in ref if k.startswith(f"denoise_fn.hf_ca_list.{last}.")]:
                ref[k.replace(f"hf_ca_list.{last}.", f"hf_ca_list.{i}.")] = ref[k] + i
    return ref


def assert_same(got, want):
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


@pytest.mark.parametrize("arch", ARCHS)
def test_conversion_matches_jax_converter(arch):
    model = toy_model(arch, 3)
    ref = reference_file(model)
    assert sum(k in ref for k in SCHEDULE_BUFFERS) == 12
    if arch == "physrdiff":
        assert not any(k.startswith("denoise_fn.fd_spliter.") for k in ref)

    jtree = jax_convert_diffusion_checkpoint(ref, arch)
    jtree["unet"] = jax_drop_unused_cross_attention(jtree["unet"], N_BOUNDARIES)
    got = convert_diffusion_checkpoint(ref, arch)
    unet = drop_unused_cross_attention(got["unet"], N_BOUNDARIES)
    assert_same(unet, unet_state_from_jax(jtree["unet"]))
    if model.encoder is None:
        assert got["encoder"] is None and "encoder" not in jtree
    else:
        assert_same(got["encoder"], encoder_state_from_jax(jtree["encoder"]))

    # loaded into a model of other weights: the original ones, but physrdiff's
    # spliter, which the reference lacks: that keeps the model's init
    fresh = toy_model(arch, 11)
    init = {k: v.clone() for k, v in fresh.unet.state_dict().items()}
    load_reference_checkpoint(fresh, ref, N_BOUNDARIES)
    for k, v in fresh.unet.state_dict().items():
        want = init[k] if arch == "physrdiff" and k.startswith("fd_spliter.") \
            else model.unet.state_dict()[k]
        assert torch.equal(v, want), k
    if arch == "physrdiff":
        assert any(k.startswith("fd_spliter.") for k in init)
    if model.encoder is not None:
        assert_same(fresh.encoder.state_dict(), model.encoder.state_dict())


@pytest.fixture(scope="module")
def phydiff_ref():
    model = toy_model("phydiff", 3)
    return model, reference_file(model)


def test_unknown_key_raises(phydiff_ref):
    _, ref = phydiff_ref
    with pytest.raises(ValueError, match="stray_module.weight"):
        convert_diffusion_checkpoint({**ref, "stray_module.weight": torch.zeros(1)}, "phydiff")


def test_file_without_unet_raises(phydiff_ref):
    _, ref = phydiff_ref
    buffers = {k: ref[k] for k in SCHEDULE_BUFFERS}
    with pytest.raises(ValueError, match="no denoise_fn"):
        convert_diffusion_checkpoint(buffers, "phydiff")


def test_shape_mismatch_raises_naming_the_leaf(phydiff_ref):
    model, ref = phydiff_ref
    leaf = "denoise_fn.final_conv.block.3.weight"
    bad = {**ref, leaf: torch.zeros(3, *ref[leaf].shape[1:])}
    with pytest.raises(ValueError, match="final_conv.block.3.weight"):
        load_reference_checkpoint(toy_model("phydiff", 5), bad, N_BOUNDARIES)


def test_encoder_of_another_arch_raises():
    ref = reference_file(toy_model("srdiff", 3))
    with pytest.raises(ValueError, match="rrdb_encoder"):
        convert_diffusion_checkpoint(ref, "phydiff")


@pytest.mark.parametrize("name,want", [
    ("I200000_E31_gen.pth", (200000, 31)), ("I5_E1_opt.pth", (5, 1)),
    ("/x/checkpoint/I20_E3", (20, 3)), ("/x/checkpoint/I20_E3/", (20, 3))])
def test_parse_counters(name, want):
    assert CheckpointManager.parse_counters(name) == want


def test_parse_counters_raises_without_counters():
    with pytest.raises(ValueError, match="counters"):
        CheckpointManager.parse_counters("/x/model_gen.pth")


# ------------------------------------------------------------------ the CLI
@pytest.fixture(scope="module")
def cli_config(tmp_path_factory):
    """A toy phydiff experiment config over a 32x64 synthetic tree, EMA on,
    a 4-step val schedule (so `-p val` is quick)."""
    root = tmp_path_factory.mktemp("migrate")
    make_synthetic_weatherbench(str(root / "data"), "2017-01-01-00", "2017-01-01-12",
                                lr_shape=(8, 16), hr_shape=(32, 64), spectrum="t2m")
    sched_val = {**SCHED, "n_timestep": 4}
    cfg = {
        "name": "migrate", "phase": "train",
        "path": {"experiments_folder_path": str(root), "log": "logs", "results": "results",
                 "checkpoint": "checkpoint", "resume_state": None},
        "data": {"dataroot": str(root / "data"), "batch_size": 2, "val_batch_size": 2,
                 "num_workers": 2, "use_shuffle": False, "variables": ["t2m"],
                 "months_subset": [1], "transform_groups": [[1]],
                 "train_min_date": "2017-01-01-00", "train_max_date": "2017-01-01-08",
                 "val_min_date": "2017-01-01-08", "val_max_date": "2017-01-01-12"},
        "model": {**model_cfg("phydiff"), "beta_schedule": {"train": SCHED, "val": sched_val}},
        "train": {"n_iter": 1, "optimizer": {"type": "adam", "lr": 1e-4},
                  "ema_scheduler": {"enabled": True, "ema_decay": 0.99, "step_start_ema": 0}},
    }
    path = root / "config.json"
    path.write_text(json.dumps(cfg))
    return root, cfg, str(path)


def test_cli_writes_a_checkpoint_that_resumes_into_validation(cli_config, tmp_path):
    root, cfg, cfg_path = cli_config
    model = toy_model("phydiff", 3)
    gen = tmp_path / "I20_E3_gen.pth"
    torch.save(reference_file(model), gen)
    out = tmp_path / "checkpoint"
    path = convert_torch_checkpoint.main(
        ["-c", cfg_path, "--gen", str(gen), "--out", str(out), "--device", "cpu"])
    assert path == str(out / "I20_E3")
    state = CheckpointManager.restore(path)
    assert (state["step"], state["epoch"]) == (20, 3)
    assert state["opt_state"]["state"] == {}  # fresh Adam
    assert_same(state["params"], model.unet.state_dict())
    assert_same(state["ema_params"], model.unet.state_dict())

    resumed = dict(cfg, path={**cfg["path"], "resume_state": path})
    resumed_path = tmp_path / "resume.json"
    resumed_path.write_text(json.dumps(resumed))
    metrics = train.main(["-c", str(resumed_path), "-p", "val", "--device", "cpu"])
    assert set(metrics) == {"MSE", "RMSE", "MAE", "MR", "PSNR", "SSIM"}
    assert all(np.isfinite(v) for v in metrics.values())
    with open(tmp_path / "logs" / "val.log") as f:
        assert "Epoch:     3  |  Iteration:       20 |" in f.read()


@pytest.mark.parametrize("kind", ["RRDBNet", "SimpleSR"])
def test_cli_converts_encoder_checkpoints(cli_config, tmp_path, kind):
    _, _, cfg_path = cli_config
    module = RRDBNet(nf=8, nb=2, gc=4) if kind == "RRDBNet" else SimpleCNN()
    random_init_(module, 7)
    gen = tmp_path / f"pretrain_{kind}_E26_gen.pth"
    torch.save(module.state_dict(), gen)
    path = convert_torch_checkpoint.main(
        ["-c", cfg_path, "--gen", str(gen), "--out", str(tmp_path), "--encoder",
         "--device", "cpu"])
    assert os.path.basename(path) == f"pretrain_{kind}_E26"
    assert_same(load_encoder_params(path), module.state_dict())
    bad = {**module.state_dict()}
    bad.popitem()
    torch.save(bad, gen)
    with pytest.raises(RuntimeError, match="Missing key"):
        convert_torch_checkpoint.main(["-c", cfg_path, "--gen", str(gen), "--out",
                                       str(tmp_path), "--encoder", "--device", "cpu"])
