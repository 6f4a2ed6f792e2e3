"""The port's encoders, their pretraining step and losses, and unconditional
sampling, against the JAX package, on the CPU.

SimpleCNN and RRDBNet (nf 16, 5 blocks: six feature taps) forward; the FFT +
DWT `image_compare_loss` and the Haar pyramid's "sum" and "none" forms; one
EncoderTrainer Adam step (RRDB at 2 blocks); unconditional sr3 DDPM on a
small UNet (inner 8, mults (1, 2)). JAX params come from `jax.eval_shape`
and a seeded numpy fill, as in tests/test_torch_port_model.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from srewd_tpu.diffusion.schedule import Schedule as JSchedule
from srewd_tpu.models.factory import build_model as jax_build_model
from srewd_tpu.models.rrdb import RRDBNet as JRRDBNet
from srewd_tpu.ops import losses as jlosses
from srewd_tpu.ops import wavelets as jwave
from srewd_tpu.parallel.mesh import make_mesh
from srewd_tpu.training.pretrainer import EncoderTrainer as JEncoderTrainer
from srewd_tpu.training.pretrainer import get_encoder_and_criterion as jax_encoder_and_criterion
from srewd_tpu_torch.diffusion.schedule import Schedule
from srewd_tpu_torch.models.factory import build_model
from srewd_tpu_torch.models.rrdb import RRDBNet
from srewd_tpu_torch.ops import losses
from srewd_tpu_torch.ops import wavelets as twave
from srewd_tpu_torch.training.pretrainer import EncoderTrainer, get_encoder_and_criterion
from srewd_tpu_torch.utils.jax_params import (
    encoder_state_from_jax, jax_tree_from_encoder_state, unet_state_from_jax)

from test_torch_port_model import (  # noqa: F401  (one_torch_thread: autouse)
    H, W, _jax_noise, one_torch_thread, rel_rmse, toy_model_cfg)

SCHED = {"schedule": "linear", "n_timestep": 1000, "linear_start": 1e-6, "linear_end": 1e-2}


def flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def seeded_tree(shapes, rng):
    """A tree of `shapes` filled with seeded values of the weights' own scale."""
    leaves, treedef = jax.tree.flatten(shapes)
    vals = [(rng.standard_normal(s.shape) / np.sqrt(max(1, np.prod(s.shape[:-1]))))
            .astype(np.float32) for s in leaves]
    return jax.tree.unflatten(treedef, vals)


def _batch(rng, b=2):
    return {"HR": rng.standard_normal((b, H, W, 1)).astype(np.float32),
            "LR": rng.standard_normal((b, H // 4, W // 4, 1)).astype(np.float32)}


# ------------------------------------------------------------------ encoders
@pytest.mark.parametrize("name", ["SimpleSR", "RRDBNet"])
def test_encoder_forward_matches_jax(name):
    cfg = {"name": name, "in_channel": 1, "out_channel": 1, "hidden_size": 16, "num_block": 5}
    jmod, _ = jax_encoder_and_criterion(cfg)
    rng = np.random.default_rng(4)
    lr = rng.standard_normal((2, 8, 16, 1)).astype(np.float32)
    kw = {"get_fea": True} if name == "RRDBNet" else {}
    params = seeded_tree(jax.eval_shape(lambda k: jmod.init(k, lr, **kw),
                                        jax.random.PRNGKey(0)), rng)
    want = jmod.apply(params, lr, **kw)
    port, _ = get_encoder_and_criterion(cfg)
    port.load_state_dict(encoder_state_from_jax(params["params"]), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(lr), **kw)
    if name == "RRDBNet":
        (got, feats), (want, feats_j) = got, want
        assert len(feats) == len(feats_j) == 6
        for f, fj in zip(feats, feats_j):
            assert rel_rmse(f.numpy(), fj) <= 1e-5
        # clamp_output, the reference's, on by default outside the training paths
        clamped = RRDBNet(nf=16, nb=5, gc=8)
        clamped.load_state_dict(port.state_dict())
        with torch.no_grad():
            np.testing.assert_allclose(
                clamped(torch.from_numpy(lr)).numpy(),
                np.asarray(JRRDBNet(nf=16, nb=5, gc=8).apply(params, lr)), atol=1e-5)
    assert got.shape == (2, 32, 64, 1)
    assert rel_rmse(got.numpy(), want) <= 1e-5


def test_image_compare_loss_and_pyramids_match_jax():
    rng = np.random.default_rng(5)
    x, y = (rng.standard_normal((2, 32, 64, 1)).astype(np.float32) for _ in range(2))
    for fn, jfn in ((losses.fft_mse_loss, jlosses.fft_mse_loss),
                    (losses.dwt_mse_loss, jlosses.dwt_mse_loss),
                    (losses.image_compare_loss, jlosses.image_compare_loss)):
        got = fn(torch.from_numpy(x), torch.from_numpy(y)).item()
        assert got == pytest.approx(float(jfn(jnp.asarray(x), jnp.asarray(y))), rel=1e-5)
    for combine in ("sum", "none"):
        want = jwave.haar_dwt_pyramid(jnp.asarray(x), levels=3, combine=combine)
        got = twave.haar_dwt_pyramid(torch.from_numpy(x), levels=3, combine=combine)
        flat_w = jax.tree.leaves(want)
        flat_g = [t for level in got for t in (level if combine == "none" else (level,))]
        assert len(flat_g) == len(flat_w)
        for g, w in zip(flat_g, flat_w):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


@pytest.mark.parametrize("name", ["SimpleSR", "RRDBNet"])
def test_encoder_trainer_adam_step_matches_jax(name):
    """One EncoderTrainer step (criterion, Adam 1e-3) from the same weights
    and batch: the loss and every updated parameter."""
    cfg = {"name": name, "in_channel": 1, "out_channel": 1, "hidden_size": 16, "num_block": 2}
    jmod, jcrit = jax_encoder_and_criterion(cfg)
    rng = np.random.default_rng(6)
    batch = {"LR": rng.standard_normal((2, 8, 16, 1)).astype(np.float32),
             "HR": rng.standard_normal((2, 32, 64, 1)).astype(np.float32)}
    params = seeded_tree(jax.eval_shape(jmod.init, jax.random.PRNGKey(0), batch["LR"]),
                         rng)["params"]
    jt = JEncoderTrainer(jmod, jcrit, optax.adam(1e-3), mesh=make_mesh(1))
    new, _, loss_j = jt._train_step(params, jt.tx.init(params), jnp.asarray(batch["LR"]),
                                    jnp.asarray(batch["HR"]))

    module, crit = get_encoder_and_criterion(cfg)
    module.load_state_dict(encoder_state_from_jax(params), strict=True)
    pt = EncoderTrainer(module, crit, device=torch.device("cpu"), optimizer="adam", lr=1e-3)
    loss_p = pt.train_step(torch.from_numpy(batch["LR"]), torch.from_numpy(batch["HR"]))
    assert loss_p.item() == pytest.approx(float(loss_j), rel=1e-5)
    assert pt.iteration == 1
    got = flat(jax_tree_from_encoder_state(module.state_dict(), like=params))
    for k, w in flat(new).items():
        np.testing.assert_allclose(got[k], np.asarray(w), rtol=1e-5, atol=2e-6, err_msg=k)


# ------------------------------------------------------------------ samplers
def _small_sr3_unconditional():
    cfg = toy_model_cfg("sr3")
    cfg["unet"].update(inner_channel=8, norm_groups=4, channel_multiplier=[1, 2], attn_res=[],
                       dropout=0.0)
    cfg["diffusion"]["conditional"] = False
    return cfg


def test_unconditional_sample_matches_jax():
    cfg = _small_sr3_unconditional()
    jmodel = jax_build_model(cfg)
    rng = np.random.default_rng(8)
    params = seeded_tree(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                                        {k: jnp.asarray(v) for k, v in _batch(rng).items()}), rng)
    port = build_model(cfg)
    port.unet.load_state_dict(unet_state_from_jax(params["unet"]), strict=True)
    sched = {**SCHED, "n_timestep": 4}
    key = jax.random.PRNGKey(3)
    js = JSchedule.from_config(sched)
    want = np.asarray(jax.jit(lambda p, k: jmodel.sample(p, 2, k, js))(params, key))
    init, noises = _jax_noise(key, (2, H, W, 1), 4)
    got = port.sample(2, Schedule.from_config(sched), device="cpu",
                      init=torch.from_numpy(init), noises=[torch.from_numpy(n) for n in noises])
    assert got.shape == (2, H, W, 1)
    assert rel_rmse(got.numpy(), want) <= 1e-3
