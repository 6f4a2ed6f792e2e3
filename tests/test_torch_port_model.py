"""The port's weight bridge, WeatherUNet and generate_sr against the JAX package.

Toy widths (inner 16, 8 groups, mults (1, 2, 4), one res block, attention
at 8x16) over 32x64 fields, so both sides run in seconds on the CPU. The
JAX params are not drawn by flax's slow init: a seeded numpy value fills
each leaf of the tree that `jax.eval_shape` of the init gives, so the tree
has exactly the model's structure. Under the test harness's 8 virtual CPU
devices the JAX attention takes its chunked XLA path (no mesh in scope),
which computes the same exact softmax as the Pallas kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srewd_tpu.diffusion.schedule import Schedule as JSchedule
from srewd_tpu.models.factory import build_model as jax_build_model
from srewd_tpu.ops.resize import bicubic_up4 as jax_bicubic_up4
from srewd_tpu.utils.torch_convert import convert_unet_state
from srewd_tpu_torch.diffusion.schedule import Schedule
from srewd_tpu_torch.models.factory import build_model
from srewd_tpu_torch.ops.flash_attention import attention_reference
from srewd_tpu_torch.ops.fused_groupnorm import gn_swish_reference
from srewd_tpu_torch.utils.jax_params import unet_state_from_jax

H, W = 32, 64


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while a module of these tests runs (the modules
    that import this fixture too): the toy-size ops gain nothing from more,
    and the suite's other workers keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def toy_model_cfg(arch):
    return {
        "architecture": arch,
        "unet": {"in_channel": 2, "out_channel": 1, "inner_channel": 16,
                 "norm_groups": 8, "channel_multiplier": [1, 2, 4],
                 "attn_res": [8], "res_blocks": 1, "dropout": 0.2},
        "diffusion": {"image_height": H, "image_width": W, "image_channels": 1,
                      "channels": 1, "conditional": True},
    }


def rel_rmse(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.sqrt(np.mean((got - want) ** 2) / np.mean(want**2))


def _batch(seed, b=2):
    rng = np.random.default_rng(seed)
    lr = rng.standard_normal((b, H // 4, W // 4, 1)).astype(np.float32)
    return {"HR": np.zeros((b, H, W, 1), np.float32), "LR": lr}


@pytest.fixture(scope="module", params=["sr3", "phydiff"])
def pair(request):
    """(arch, JAX model, JAX unet params, port model with the same weights)."""
    arch = request.param
    jmodel = jax_build_model(toy_model_cfg(arch))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            {k: jnp.asarray(v) for k, v in _batch(0).items()})["unet"]
    rng = np.random.default_rng(1)
    leaves, treedef = jax.tree.flatten(shapes)
    # values of the weights' own scale, so activations stay O(1) through the net
    vals = [(rng.standard_normal(s.shape) / np.sqrt(max(1, np.prod(s.shape[:-1]))))
            .astype(np.float32) for s in leaves]
    tree = jax.tree.unflatten(treedef, vals)
    port = build_model(toy_model_cfg(arch))
    port.unet.load_state_dict(unet_state_from_jax(tree), strict=True)
    port.unet.eval()
    return arch, jmodel, tree, port


def test_bridge_consumes_every_leaf_and_round_trips(pair):
    arch, _, tree, port = pair
    sd = port.unet.state_dict()
    back = convert_unet_state(sd, arch)  # port state_dict -> JAX tree
    flat_in = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_leaves_with_path(tree)}
    flat_back = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_leaves_with_path(back)}
    assert flat_in.keys() == flat_back.keys()
    for k, v in flat_in.items():
        np.testing.assert_array_equal(flat_back[k], v, err_msg=k)
    n_tree = len(flat_in)
    assert n_tree == len(sd), (n_tree, len(sd))


def test_bridge_rejects_unused_leaves(pair):
    _, _, tree, _ = pair
    extra = dict(tree)
    extra["Stray_0"] = {"kernel": np.zeros((1, 1), np.float32)}
    with pytest.raises(ValueError, match="not consumed"):
        unet_state_from_jax(extra)


def test_unet_forward_matches_jax(pair):
    arch, jmodel, tree, port = pair
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, H, W, 2)).astype(np.float32)
    lvl = np.asarray([0.3, 0.9], np.float32)
    want = jax.jit(lambda p, a, n: jmodel.unet.apply({"params": p}, a, n))(tree, x, lvl)
    attention_reference.calls = gn_swish_reference.calls = 0
    with torch.no_grad():
        got = port.unet(torch.from_numpy(x), torch.from_numpy(lvl))
    # float32 convolutions summed in another order on each side
    assert rel_rmse(got.numpy(), want) <= 1e-5
    assert gn_swish_reference.calls > 0 and attention_reference.calls > 0


def _jax_noise(key, shape, n):
    """The initial image and per-step noises the JAX chains draw from `key`."""
    k_init, k_chain = jax.random.split(key)
    init = np.asarray(jax.random.normal(k_init, shape))
    noises = [np.asarray(jax.random.normal(jax.random.fold_in(k_chain, i), shape))
              for i in range(n)]
    return init, noises


@pytest.mark.parametrize("sampler", ["ddim", "ddpm"])
def test_generate_sr_matches_jax(pair, sampler):
    arch, jmodel, tree, port = pair
    batch = _batch(3)
    # DDPM over an 8-step schedule; DDIM walks 4 steps of a 1000-step one
    n_t = 8 if sampler == "ddpm" else 1000
    sched_cfg = {"schedule": "linear", "n_timestep": n_t,
                 "linear_start": 1e-6, "linear_end": 1e-2}
    kw = dict(sampler="ddim", ddim_steps=4, ddim_eta=1.0) if sampler == "ddim" else {}
    key = jax.random.PRNGKey(7)
    jbatch = {"HR": jnp.asarray(batch["HR"]), "LR": jnp.asarray(batch["LR"])}
    jbatch["SR"] = jax_bicubic_up4(jbatch["LR"])
    want = np.asarray(jax.jit(
        lambda p, b, k: jmodel.generate_sr(p, b, k, JSchedule.from_config(sched_cfg), **kw)
    )({"unet": tree}, jbatch, key))

    shape = batch["HR"].shape
    init, noises = _jax_noise(key, shape, 4 if sampler == "ddim" else n_t)
    got = port.generate_sr(
        {"LR": torch.from_numpy(batch["LR"])}, Schedule.from_config(sched_cfg),
        init=torch.from_numpy(init), noises=[torch.from_numpy(n) for n in noises], **kw,
    ).numpy()
    assert got.shape == want.shape
    cond = np.asarray(jbatch["SR"]) if arch != "sr3" else 0.0
    # the bar of BASELINE.md, on the chain's own output (the residual for phydiff)
    assert rel_rmse(got - cond, want - cond) <= 1e-3
