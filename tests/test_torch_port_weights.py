"""Which weights the port's sampling entry points load, and how, on the CPU.

`python -m srewd_tpu_torch.sample` takes `-m`, else the config's
`path.resume_state`, as the root sample.py does (it puts `-m` into
`path.resume_state` and loads through build_trainer): strictly, and
tolerantly under `model.finetune_norm` (`cli.load_sampling_weights`, shared
with the serving layer's `load_stack`). The tolerant load takes the UNet
and the encoder by the JAX trainer's merge (`load_params_tolerant`, called
here on the JAX side with an orbax checkpoint of the same trees). Last, the
kernels' launch counters under threads (`ops.count`).
"""

import os
import sys
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srewd_tpu.models.factory import build_model as jax_build_model
from srewd_tpu.training.checkpoint import CheckpointManager as JCheckpointManager
from srewd_tpu.training.trainer import DiffusionTrainer as JDiffusionTrainer
from srewd_tpu_torch import ops, sample
from srewd_tpu_torch.cli import load_model_weights, load_sampling_weights, random_init_
from srewd_tpu_torch.diffusion.schedule import Schedule
from srewd_tpu_torch.models.factory import build_model
from srewd_tpu_torch.ops import flash_attention as fa
from srewd_tpu_torch.ops import fused_groupnorm as gn
from srewd_tpu_torch.training.checkpoint import CheckpointManager
from srewd_tpu_torch.training.trainer import DiffusionTrainer
from srewd_tpu_torch.utils.jax_params import (
    _encoder_key_map, _key_map, encoder_state_from_jax, unet_state_from_jax)

from test_torch_port_archs import arch_cfg, seeded_tree
from test_torch_port_model import H, W, one_torch_thread  # noqa: F401
from test_torch_port_sample_date import DATE, config, tree, write  # noqa: F401

MISSING = "downs.0.weight"  # the UNet's first conv kernel: its init value is not zero


def _save(root, name, params, **extra) -> str:
    """A port checkpoint directory holding `params` (and `extra` entries)."""
    return CheckpointManager(str(root / name)).save({"params": params, **extra}, 1, 0)


def _seeded_unet(cfg, seed):
    model = build_model(cfg["model"])
    random_init_(model.unet, seed)
    return model.unet.state_dict()


def _kelvin(out_dir, ts):
    return np.stack([np.load(os.path.join(out_dir, "sr", f"{t}.npy")) for t in ts])


@pytest.fixture(scope="module")
def weights(tree, tmp_path_factory):  # noqa: F811
    """The toy sr3 config over the sampling tree, and a checkpoint of
    seeded weights other than the config's own."""
    root = tmp_path_factory.mktemp("weights")
    cfg = config(tree)
    return root, cfg, _save(root, "ck", _seeded_unet(cfg, 11))


@pytest.mark.parametrize("mode", ["bulk", "date"])
def test_sample_takes_path_resume_state_without_m(weights, tmp_path, mode):
    """No -m: the fields of path.resume_state's weights, the same as `-m`
    of that path, not the seeded weights'."""
    root, cfg, ckpt = weights
    with_resume = dict(cfg, path={**cfg["path"], "resume_state": ckpt})
    args = (["--date-range", "2017-01-31-00", "2017-01-31-03", "--save-npy"]
            if mode == "bulk" else ["-d", DATE])
    ts = ["2017-01-31-00", "2017-01-31-01", "2017-01-31-02"]

    def run(name, c, *extra):
        out = sample.main(["-c", write(tmp_path, name, c), *args, *extra,
                           "-o", str(tmp_path / name), "--device", "cpu"])
        return _kelvin(tmp_path / name, ts) if mode == "bulk" else out["kelvin"]["SR"]

    resumed = run("resumed", with_resume)
    explicit = run("explicit", cfg, "-m", ckpt)
    seeded = run("seeded", cfg)
    assert np.isfinite(resumed).all()
    np.testing.assert_array_equal(resumed, explicit)
    assert not np.allclose(resumed, seeded)


def test_finetune_norm_sample_loads_tolerantly(weights, tmp_path):
    """Under model.finetune_norm, a checkpoint lacking a UNet tensor (and
    holding an extra one) loads: the tensor keeps its init, the rest are
    the checkpoint's, so the fields are those of `-m` of a whole checkpoint
    that holds the init value there. Without finetune_norm the load is
    strict and raises."""
    root, cfg, _ = weights
    full = _seeded_unet(cfg, 11)
    init = _seeded_unet(cfg, int(cfg["seed"]))  # init_weights' UNet seed
    partial = {k: v for k, v in full.items() if k != MISSING}
    partial["stray.weight"] = torch.zeros(3)
    ck_partial = _save(tmp_path, "partial", partial)
    ck_expected = _save(tmp_path, "expected", {**full, MISSING: init[MISSING]})
    assert not torch.equal(full[MISSING], init[MISSING])

    tolerant = dict(cfg, model={**cfg["model"], "finetune_norm": True},
                    path={**cfg["path"], "resume_state": ck_partial})
    got = sample.main(["-c", write(tmp_path, "tolerant", tolerant), "-d", DATE,
                       "-o", str(tmp_path / "t"), "--device", "cpu"])["kelvin"]["SR"]
    want = sample.main(["-c", write(tmp_path, "plain", cfg), "-d", DATE, "-m", ck_expected,
                        "-o", str(tmp_path / "w"), "--device", "cpu"])["kelvin"]["SR"]
    np.testing.assert_array_equal(got, want)

    strict = dict(cfg, path={**cfg["path"], "resume_state": ck_partial})
    with pytest.raises(RuntimeError, match="Missing key"):
        sample.main(["-c", write(tmp_path, "strict", strict), "-d", DATE,
                     "-o", str(tmp_path / "s"), "--device", "cpu"])


def test_load_sampling_weights_rule(weights, caplog):
    """-m over path.resume_state; neither keeps the seeded weights (and
    --use-ema warns); the tolerant load warns that it takes no EMA."""
    root, cfg, ckpt = weights
    other = _save(root, "other", _seeded_unet(cfg, 12),
                  ema_params=_seeded_unet(cfg, 13))

    def loaded(opt, model_path=None, use_ema=False):
        model = build_model(cfg["model"])
        random_init_(model.unet, 0)
        ema = load_sampling_weights(model, opt, model_path, use_ema=use_ema)
        return model.unet.state_dict(), ema

    resume = dict(cfg, path={"resume_state": ckpt})
    for opt, path, want_seed in ((resume, None, 11), (resume, other, 12), (cfg, None, 0)):
        got, ema = loaded(opt, path)
        want = _seeded_unet(cfg, want_seed)
        assert not ema and all(torch.equal(got[k], want[k]) for k in want), want_seed
    got, ema = loaded(cfg, other, use_ema=True)
    assert ema and torch.equal(got[MISSING], _seeded_unet(cfg, 13)[MISSING])
    caplog.clear()
    assert loaded(cfg, None, use_ema=True)[1] is False
    assert "without -m or path.resume_state" in caplog.text
    tolerant = dict(cfg, model={**cfg["model"], "finetune_norm": True})
    got, ema = loaded(tolerant, other, use_ema=True)
    assert not ema and torch.equal(got[MISSING], _seeded_unet(cfg, 12)[MISSING])
    assert "loaded tolerantly" in caplog.text


# --------------------------------------------- the tolerant merge, against JAX
def _jax_tolerant(path: str, init: dict) -> dict:
    """JAX's DiffusionTrainer.load_params_tolerant on `init` (its state
    around the method: no checkpoint manager, no mesh, no EMA)."""
    stub = types.SimpleNamespace(ckpt=None, params=init, ema_params=None,
                                 _place=lambda t: t)
    JDiffusionTrainer.load_params_tolerant(stub, path)
    return jax.tree.map(np.asarray, stub.params)


def _drop(tree: dict, path: tuple) -> dict:
    """A copy of `tree` without the leaf at `path`."""
    if len(path) == 1:
        return {k: v for k, v in tree.items() if k != path[0]}
    return {**tree, path[0]: _drop(tree[path[0]], path[1:])}


def test_tolerant_load_takes_the_encoder_by_jax_merge(tmp_path):
    """srdiff: the checkpoint's UNet and encoder lack one tensor each and
    the encoder holds an extra one. JAX's merge of the same trees, and the
    port's trainer load and cli load, give the same weights bit for bit:
    the missing tensors keep their init, the rest are the checkpoint's; the
    trainer's EMA starts from the loaded weights; a shape mismatch raises."""
    cfg = arch_cfg("srdiff")
    jmodel = jax_build_model(cfg)
    batch = {"HR": jnp.zeros((1, H, W, 1)), "LR": jnp.zeros((1, H // 4, W // 4, 1))}
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), batch)
    init = seeded_tree(shapes, np.random.default_rng(1))
    ckpt = seeded_tree(shapes, np.random.default_rng(2))
    unet_map, enc_map = _key_map(init["unet"]), _encoder_key_map(init["encoder"])
    gone = {"unet": "downs.1.res_block.block1.block.0.weight", "encoder": "conv_first.bias"}
    ckpt_unet = unet_state_from_jax(ckpt["unet"])
    ckpt_enc = encoder_state_from_jax(ckpt["encoder"])
    del ckpt_unet[gone["unet"]], ckpt_enc[gone["encoder"]]
    ckpt_enc["stray.weight"] = torch.ones(2)
    port_path = _save(tmp_path / "port", "ck", ckpt_unet, encoder_params=ckpt_enc)

    jax_ckpt = {"unet": _drop(ckpt["unet"], unet_map[gone["unet"]][0]),
                "encoder": {**_drop(ckpt["encoder"], enc_map[gone["encoder"]][0]),
                            "Stray_0": {"kernel": np.ones((1, 2), np.float32)}}}
    jax_path = JCheckpointManager(str(tmp_path / "jax")).save({"params": jax_ckpt}, 1, 0)
    merged = _jax_tolerant(jax_path, init)
    want_unet = unet_state_from_jax(merged["unet"])
    want_enc = encoder_state_from_jax(merged["encoder"])
    init_unet, init_enc = unet_state_from_jax(init["unet"]), encoder_state_from_jax(init["encoder"])
    for part, key in gone.items():  # JAX kept the init of the missing tensors
        want = want_unet if part == "unet" else want_enc
        assert torch.equal(want[key], (init_unet if part == "unet" else init_enc)[key])

    def port_model():
        model = build_model(cfg)
        model.unet.load_state_dict(init_unet, strict=True)
        model.encoder.load_state_dict(init_enc, strict=True)
        return model

    sched = Schedule.from_config({"schedule": "linear", "n_timestep": 10})
    trainer = DiffusionTrainer(port_model(), sched, sched, device=torch.device("cpu"),
                               finetune_norm=True, ema_decay=0.999)
    trainer.load_params_tolerant(port_path)
    by_cli = port_model()
    load_model_weights(by_cli, port_path, tolerant=True)
    for model in (trainer.model, by_cli):
        for got, want in ((model.unet.state_dict(), want_unet),
                          (model.encoder.state_dict(), want_enc)):
            assert got.keys() == want.keys()
            for k, v in want.items():
                assert torch.equal(got[k], v), k
    for ema, module in ((trainer.ema, trainer.model.unet),
                        (trainer.ema_encoder, trainer.model.encoder)):
        assert all(torch.equal(ema[k], v) for k, v in module.state_dict().items())

    bad = dict(ckpt_enc, **{"conv_first.weight": torch.zeros(1, 1, 1, 1)})
    bad_path = _save(tmp_path / "bad", "ck", ckpt_unet, encoder_params=bad)
    with pytest.raises(ValueError, match="shape mismatch at encoder.conv_first.weight"):
        trainer.load_params_tolerant(bad_path)


# -------------------------------------------------------- the launch counters
def test_launch_counters_are_exact_under_threads():
    """4 threads x 10^4 increments through `ops.count` (what every wrapper
    and plain version calls) give exactly 4 x 10^4 on each counter, with
    the interpreter switching threads as often as it can."""
    counters = [(fa.flash_attention, "launches"), (gn.gn_swish, "launches"),
                (fa.attention_reference, "calls")]
    before = [getattr(f, name) for f, name in counters]
    n_threads, n = 4, 10_000

    def work():
        for _ in range(n):
            for f, name in counters:
                ops.count(f, name)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    for (f, name), b in zip(counters, before):
        assert getattr(f, name) - b == n_threads * n, f.__name__
