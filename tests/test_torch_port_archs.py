"""resdiff, srdiff and physrdiff of the port against the JAX package, on the
CPU: the weight bridge, the UNet forward, generate_sr with DPM-Solver++(2M),
DDIM and DDPM and their `keep_every` frames, the loss with every gradient
leaf, and the spliter's hoist.

Toy widths (inner 16, 8 groups, mults (1, 2, 4), one res block, attention
at 8x16) over 32x64 fields; RRDB nf 16 with 5 blocks, so `feats[2::3]`
concatenates two taps. JAX params come from `jax.eval_shape` of the init
and a seeded numpy fill, as in tests/test_torch_port_model.py; the JAX
attention takes its chunked XLA path (no mesh in scope). resdiff carries a
SimpleCNN whose prediction is its condition (the shipped
resdiff_pretrained_cnn config); srdiff's RRDB is unlocked, so its loss
holds the encoder's L1 term and its gradients reach the encoder. Dropout 0
where JAX is compared.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srewd_tpu.diffusion.schedule import Schedule as JSchedule
from srewd_tpu.models.factory import build_model as jax_build_model
from srewd_tpu.utils.torch_convert import (
    convert_rrdb_state, convert_simple_cnn_state, convert_unet_state)
from srewd_tpu_torch.diffusion.schedule import Schedule
from srewd_tpu_torch.models.factory import ARCHS, build_model
from srewd_tpu_torch.ops.flash_attention import attention_reference
from srewd_tpu_torch.ops.fused_groupnorm import gn_swish_reference
from srewd_tpu_torch.utils.jax_params import (
    encoder_state_from_jax, jax_tree_from_encoder_state, jax_tree_from_unet_state,
    unet_state_from_jax)

from test_torch_port_model import (  # noqa: F401  (one_torch_thread: autouse)
    H, W, _jax_noise, one_torch_thread, rel_rmse, toy_model_cfg)

SCHED = {"schedule": "linear", "n_timestep": 1000, "linear_start": 1e-6, "linear_end": 1e-2}
RRDB = {"hidden_size": 16, "num_block": 5}


def arch_cfg(arch):
    cfg = toy_model_cfg(arch)
    cfg["unet"]["dropout"] = 0.0
    cfg["pretrained_model"] = {
        "resdiff": {"enabled": True, "lock_weights": True, "use_encoder_prediction": True},
        "srdiff": {**RRDB, "lock_weights": False},
        "physrdiff": {**RRDB, "lock_weights": True},
    }[arch]
    return cfg


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


@pytest.fixture(scope="module", params=["resdiff", "srdiff", "physrdiff"])
def pair(request):
    """(arch, JAX model, JAX params {unet, encoder}, port model, batch)."""
    arch = request.param
    jmodel = jax_build_model(arch_cfg(arch))
    rng = np.random.default_rng(1)
    batch = _batch(rng)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            {k: jnp.asarray(v) for k, v in batch.items()})
    params = seeded_tree(shapes, rng)
    port = build_model(arch_cfg(arch))
    port.unet.load_state_dict(unet_state_from_jax(params["unet"]), strict=True)
    port.encoder.load_state_dict(encoder_state_from_jax(params["encoder"]), strict=True)
    return arch, jmodel, params, port, batch


def _cond(port, batch):
    with torch.no_grad():
        return port.condition({"LR": torch.from_numpy(batch["LR"])}).numpy()


def test_bridge_round_trips_and_matches_torch_convert(pair):
    """Port state_dict -> JAX tree by srewd_tpu's own converters (the
    reference's names) and by the inverse bridge: both give the tree back."""
    arch, _, params, port, _ = pair
    want_u, want_e = flat(params["unet"]), flat(params["encoder"])
    enc_convert = convert_rrdb_state if arch != "resdiff" else convert_simple_cnn_state
    for got_u, got_e in (
            (convert_unet_state(port.unet.state_dict(), arch),
             enc_convert(port.encoder.state_dict())),
            (jax_tree_from_unet_state(port.unet.state_dict(), like=params["unet"]),
             jax_tree_from_encoder_state(port.encoder.state_dict(), like=params["encoder"]))):
        for got, want in ((flat(got_u), want_u), (flat(got_e), want_e)):
            assert got.keys() == want.keys()
            for k, v in want.items():
                np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert len(want_u) == len(port.unet.state_dict())
    assert len(want_e) == len(port.encoder.state_dict())


def test_bridge_rejects_unused_leaves(pair):
    _, _, params, _, _ = pair
    for tree, fn in ((params["unet"], unet_state_from_jax),
                     (params["encoder"], encoder_state_from_jax)):
        with pytest.raises(ValueError, match="not consumed"):
            fn({**tree, "Stray_0": {"kernel": np.zeros((1, 1), np.float32)}})


def test_unet_forward_matches_jax(pair):
    arch, jmodel, params, port, _ = pair
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, H, W, 1 if arch == "srdiff" else 2)).astype(np.float32)
    lvl = np.asarray([0.3, 0.9], np.float32)
    kw = {}
    if arch != "resdiff":  # the two concatenated RRDB taps at LR size
        kw["rrdb_feats"] = rng.standard_normal((2, H // 4, W // 4, 32)).astype(np.float32)
    want = jax.jit(lambda p, a, n, k: jmodel.unet.apply({"params": p}, a, n, **k))(
        params["unet"], x, lvl, kw)
    attention_reference.calls = gn_swish_reference.calls = 0
    with torch.no_grad():
        got = port.unet(torch.from_numpy(x), torch.from_numpy(lvl),
                        **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert rel_rmse(got.numpy(), want) <= 1e-5
    assert gn_swish_reference.calls > 0 and attention_reference.calls > 0


@pytest.mark.parametrize("sampler", ["dpm", "ddim", "ddpm"])
def test_generate_sr_matches_jax(pair, sampler):
    """DPM-8 and DDIM-8 on a 1000-step schedule, DDPM on an 8-step one, with
    the JAX noise, keeping every 3rd field: 2 frames, the last 2 steps make
    none, the residual added back to each."""
    arch, jmodel, params, port, batch = pair
    keep = 3
    sched = {**SCHED, "n_timestep": 8} if sampler == "ddpm" else SCHED
    kw = {} if sampler == "ddpm" else dict(sampler=sampler, ddim_steps=8, ddim_eta=1.0)
    key = jax.random.PRNGKey(7)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    js = JSchedule.from_config(sched)  # concrete: the DPM coefficients are numpy
    want = jax.jit(lambda p, b, k: jmodel.generate_sr(p, b, k, js, keep_every=keep, **kw))(
        params, jbatch, key)
    init, noises = _jax_noise(key, batch["HR"].shape, 8)
    got = port.generate_sr(
        {"LR": torch.from_numpy(batch["LR"])}, Schedule.from_config(sched), keep_every=keep,
        init=torch.from_numpy(init), noises=[torch.from_numpy(n) for n in noises], **kw)
    cond = _cond(port, batch)
    (got, frames), (want, frames_j) = got, want
    assert frames.shape == frames_j.shape == (2, *batch["HR"].shape)
    for f, fj in zip(frames.numpy(), np.asarray(frames_j)):
        assert rel_rmse(f - cond, fj - cond) <= 1e-3
    # the bar of BASELINE.md, on the chain's own output (the residual)
    assert rel_rmse(got.numpy() - cond, np.asarray(want) - cond) <= 1e-3


def test_loss_and_every_gradient_leaf_match_jax(pair):
    arch, jmodel, params, port, batch = pair
    js = JSchedule.from_config(SCHED)
    rng = jax.random.PRNGKey(5)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, jbatch, rng, js, True)))(params)
    k_t, k_noise, _ = jax.random.split(rng, 3)  # the draws JAX took inside loss
    kt, kg = jax.random.split(k_t)
    t = int(jax.random.randint(kt, (), 1, js.num_timesteps + 1))
    u = np.array(jax.random.uniform(kg, (2,)))
    noise = np.array(jax.random.normal(k_noise, batch["HR"].shape))

    port.unet.zero_grad(set_to_none=True)
    port.encoder.zero_grad(set_to_none=True)
    loss_p = port.loss({k: torch.from_numpy(v) for k, v in batch.items()},
                       Schedule.from_config(SCHED), t=torch.tensor([t]),
                       u=torch.from_numpy(u), noise=torch.from_numpy(noise))
    loss_p.backward()
    assert abs(loss_p.item() - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    want = dict(unet_state_from_jax(grads_j["unet"]))
    got = {n: p.grad for n, p in port.unet.named_parameters()}
    if arch == "srdiff":  # unlocked: the encoder's gradients too
        want.update({f"encoder.{k}": v for k, v in
                     encoder_state_from_jax(grads_j["encoder"]).items()})
        got.update({f"encoder.{n}": p.grad for n, p in port.encoder.named_parameters()})
    else:  # locked (or frozen in the chain): no gradient reaches the encoder
        assert all(p.grad is None for p in port.encoder.parameters())
    assert got.keys() == want.keys()
    largest = max(float(np.linalg.norm(w.numpy())) for w in want.values())
    for name, w in want.items():
        w = w.numpy()
        if np.linalg.norm(w) < 1e-6 * largest:
            assert np.linalg.norm(got[name].numpy() - w) <= 1e-6 * largest, name
        else:
            assert rel_rmse(got[name].numpy(), w) <= 1e-3, name


def test_spliter_inline_matches_hoisted_and_jax_cond_only(pair):
    """The spliter's frequency maps computed inside the UNet call equal those
    handed in from the cond_features_only call, which equal JAX's cond_only."""
    arch, jmodel, params, port, _ = pair
    if arch == "srdiff":
        assert not hasattr(port.unet, "fd_spliter") and "FDInfoSpliter_0" not in params["unet"]
        return
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, H, W, 2)).astype(np.float32)
    lvl = torch.tensor([0.4, 0.8])
    xt = torch.from_numpy(x)
    kw = {} if arch == "resdiff" else {
        "rrdb_feats": torch.from_numpy(rng.standard_normal((2, 8, 16, 32)).astype(np.float32))}
    with torch.no_grad():
        feats = port.unet(xt[..., :1], cond_features_only=True)
        inline = port.unet(xt, lvl, **kw)
        hoisted = port.unet(xt, lvl, cond_feats=feats, **kw)
    torch.testing.assert_close(hoisted, inline, rtol=0, atol=0)
    want = jmodel.unet.apply({"params": params["unet"]}, jnp.asarray(x[..., :1]),
                             cond_features_only=True)
    for g, w in zip(feats, want):
        assert rel_rmse(g.numpy(), w) <= 1e-5


# --------------------------------------------------------------- the factory
def test_build_model_builds_all_five_architectures():
    assert ARCHS == ("sr3", "resdiff", "phydiff", "srdiff", "physrdiff")
    for arch in ARCHS:
        cfg = toy_model_cfg(arch)
        cfg["pretrained_model"] = dict(RRDB)
        m = build_model(cfg)
        assert m.arch == arch and m.unet.variant == arch
        assert (m.encoder is not None) == (arch in ("srdiff", "physrdiff"))
    with pytest.raises(ValueError, match="unknown sampler"):
        build_model(toy_model_cfg("sr3")).generate_sr(
            {"LR": torch.zeros(1, H // 4, W // 4, 1)}, Schedule.create("linear", 8),
            sampler="plms")
