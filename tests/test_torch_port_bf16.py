"""bf16 training of the port against the JAX package's, on the CPU.

The JAX package trains in bf16 through flax's `dtype` over float32 params
(`build_model(dtype=jnp.bfloat16)`); the port through `build_model(dtype=
torch.bfloat16)`, whose layers cast their float32 weights per call. Same
weights, the same JAX draws (t, gamma's uniforms, noise), dropout 0: the
loss and every gradient leaf of phydiff and of physrdiff with its RRDB
unlocked (spliter, ResSE, cond_proj and the encoder on the gradient path),
one optimizer step of `cli.build_trainer(dtype=)`, the chains' shadow of
the weights, a bf16-trained checkpoint sampled in float32, ResSE's compute
dtype, and `train.optimizer.grad_clip` end to end (float32).

Tolerances. bf16 keeps 8 bits: the two frameworks round at the same ops
but sum in other orders, and XLA's bf16 sigmoid is not correctly rounded
where torch's is, so each side's bf16 gradient carries its own rounding
noise, ~3-4 % relative RMSE over all leaves against the float32 gradient
(measured at these widths), uncorrelated between the sides. Hence:
  loss:      relative difference <= 2e-3 (half a bf16 ulp, 2**-8);
  gradients: every leaf within BF16_GRAD_FACTOR = 3 times JAX's own bf16
             error on it, |g_port - g_jax| <= 3 |g_jax - g_float32|, where
             g_float32 is the port's float32 gradient (test_torch_port_
             train.py and _archs.py hold it to JAX's float32 one within
             1e-3); over all leaves, relative RMSE <= 0.1;
  dtype:     every convolution and linear layer of the UNet and of the
             encoder receives bf16 input, and every parameter and gradient
             is float32.
chip_smoke.py phase 11 holds a bf16 step of the kernels against the plain
versions with the same factor, the plain side's error counted as at least
one bf16 ulp of its gradient (test_chip_bf16_bound_floors_at_one_ulp).
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from srewd_tpu.diffusion.schedule import Schedule as JSchedule
from srewd_tpu.models.blocks import ResSE as JaxResSE
from srewd_tpu.models.factory import build_model as jax_build_model
from srewd_tpu_torch.cli import build_trainer, load_model_weights
from srewd_tpu_torch.diffusion.schedule import Schedule
from srewd_tpu_torch.models import layers
from srewd_tpu_torch.models.blocks import ResSE
from srewd_tpu_torch.models.factory import DiffusionModel, build_model
from srewd_tpu_torch.utils.jax_params import (
    encoder_state_from_jax, jax_tree_from_unet_state, optimizer_moments, unet_state_from_jax)

from test_torch_port_archs import RRDB, seeded_tree
from test_torch_port_model import (  # noqa: F401  (one_torch_thread: autouse)
    H, W, one_torch_thread, rel_rmse, toy_model_cfg)

SCHED = {"schedule": "linear", "n_timestep": 1000, "linear_start": 1e-6, "linear_end": 1e-2}
LOSS_REL = 2e-3
BF16_GRAD_FACTOR = 3.0
GRAD_REL_ALL = 0.1


def model_cfg(arch):
    cfg = toy_model_cfg(arch)
    cfg["unet"]["dropout"] = 0.0
    if arch == "physrdiff":
        cfg["pretrained_model"] = {**RRDB, "lock_weights": False}
    return cfg


def jax_draws(key, js, shape):
    """The (t, u, noise) JAX's loss takes from `key` (factory.py:162-164)."""
    k_t, k_noise, _ = jax.random.split(key, 3)
    kt, kg = jax.random.split(k_t)
    t = int(jax.random.randint(kt, (), 1, js.num_timesteps + 1))
    u = np.array(jax.random.uniform(kg, (shape[0],)))
    noise = np.array(jax.random.normal(k_noise, shape))
    return {"t": torch.tensor([t]), "u": torch.from_numpy(u), "noise": torch.from_numpy(noise)}


def port_model(arch, params, dtype=None):
    m = build_model(model_cfg(arch), dtype=dtype)
    m.unet.load_state_dict(unet_state_from_jax(params["unet"]), strict=True)
    if m.encoder is not None:
        m.encoder.load_state_dict(encoder_state_from_jax(params["encoder"]), strict=True)
    return m


def port_grads(m, batch, draws):
    """(loss, {name: gradient}) of one loss.backward(); the unlocked encoder's
    under "encoder." names."""
    mods = {"": m.unet}
    if m.encoder is not None and not m.lock_encoder:
        mods["encoder."] = m.encoder
    for mod in mods.values():
        mod.zero_grad(set_to_none=True)
    loss = m.loss({k: torch.from_numpy(v) for k, v in batch.items()},
                  Schedule.from_config(SCHED), **draws)
    loss.backward()
    return loss, {pre + n: p.grad for pre, mod in mods.items() for n, p in mod.named_parameters()}


def jax_grads_by_name(grads, arch):
    want = dict(unet_state_from_jax(grads["unet"]))
    if arch == "physrdiff":
        want.update({f"encoder.{k}": v for k, v in encoder_state_from_jax(grads["encoder"]).items()})
    return {k: v.numpy() for k, v in want.items()}


@pytest.fixture(scope="module", params=["phydiff", "physrdiff"])
def case(request):
    """(arch, params, batch, draws, JAX's bf16 loss and gradients by port name)."""
    arch = request.param
    jmodel = jax_build_model(model_cfg(arch), dtype=jnp.bfloat16)
    rng = np.random.default_rng(1)
    batch = {"HR": rng.standard_normal((2, H, W, 1)).astype(np.float32),
             "LR": rng.standard_normal((2, H // 4, W // 4, 1)).astype(np.float32)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    params = seeded_tree(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jbatch), rng)
    js = JSchedule.from_config(SCHED)
    key = jax.random.PRNGKey(5)
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, jbatch, key, js, True)))(params)
    return {"arch": arch, "params": params, "batch": batch,
            "draws": jax_draws(key, js, batch["HR"].shape), "loss": float(loss_j),
            "grads": jax_grads_by_name(grads_j, arch)}


def test_bf16_loss_and_every_gradient_leaf_match_jax(case):
    arch = case["arch"]
    m = port_model(arch, case["params"], torch.bfloat16)
    seen = []
    mods = [mod for part in (m.unet, m.encoder) if part is not None for mod in part.modules()
            if isinstance(mod, (layers.Conv2d, layers.ConvTranspose2d, layers.Linear))]
    hooks = [mod.register_forward_pre_hook(lambda mod, inp: seen.append((mod, inp[0].dtype)))
             for mod in mods]
    loss, got = port_grads(m, case["batch"], case["draws"])
    for h in hooks:
        h.remove()
    # every layer computed in bf16, over float32 parameters with float32 gradients
    assert {id(mod) for mod, _ in seen} == {id(mod) for mod in mods}
    assert {dt for _, dt in seen} == {torch.bfloat16}
    assert {p.dtype for p in m.unet.parameters()} == {torch.float32}
    assert {g.dtype for g in got.values()} == {torch.float32}
    assert abs(loss.item() - case["loss"]) <= LOSS_REL * abs(case["loss"])

    _, f32 = port_grads(port_model(arch, case["params"]), case["batch"], case["draws"])
    want = case["grads"]
    assert got.keys() == want.keys() == f32.keys()
    largest = max(np.linalg.norm(w) for w in want.values())
    for name, w in want.items():
        g, gf = got[name].numpy(), f32[name].numpy()
        assert (np.linalg.norm(g - w)
                <= BF16_GRAD_FACTOR * np.linalg.norm(w - gf) + 1e-6 * largest), name
    cat = lambda d: np.concatenate([np.asarray(d[k]).ravel() for k in sorted(d)])  # noqa: E731
    assert rel_rmse(cat({k: v.numpy() for k, v in got.items()}), cat(want)) <= GRAD_REL_ALL


def _opt(arch, **optimizer):
    return {"model": {**model_cfg(arch), "beta_schedule": {"train": SCHED}},
            "train": {"optimizer": {"type": "adam", "lr": 1e-4, **optimizer},
                      "ema_scheduler": {"enabled": True, "step_start_ema": 0,
                                        "ema_decay": 0.999}},
            "path": {}, "seed": 0}


def _trainer(case, dtype=None, **optimizer):
    """cli.build_trainer on the CPU with the case's weights; its loss takes
    the case's JAX draws."""
    trainer = build_trainer(_opt(case["arch"], **optimizer), torch.device("cpu"), dtype=dtype)
    m = trainer.model
    m.unet.load_state_dict(unet_state_from_jax(case["params"]["unet"]), strict=True)
    if m.encoder is not None:
        m.encoder.load_state_dict(encoder_state_from_jax(case["params"]["encoder"]), strict=True)
    trainer.ema = {k: v.detach().clone() for k, v in m.unet.state_dict().items()}
    m.loss = functools.partial(DiffusionModel.loss, m, **case["draws"])
    return trainer


def _state_dtypes(trainer):
    opt_state = [v for s in trainer.optimizer.state.values() for v in s.values()
                 if torch.is_tensor(v) and v.is_floating_point() and v.ndim > 0]
    return ({p.dtype for p in trainer.trainable} | {v.dtype for v in opt_state}
            | {v.dtype for v in trainer.ema.values()}), len(opt_state)


@pytest.mark.parametrize("case", ["phydiff"], indirect=True)
def test_bf16_step_keeps_float32_state_and_matches_jax(case):
    """One step of build_trainer(dtype=bf16): parameters, Adam's moments and
    the EMA stay float32; the moments are optax's from JAX's bf16 gradients
    within the gradient tolerance, and so is the update, over all leaves."""
    trainer = _trainer(case, torch.bfloat16)
    before = {n: p.detach().clone() for n, p in trainer.model.unet.named_parameters()}
    trainer.train_on_batch(case["batch"])
    dtypes, n_moments = _state_dtypes(trainer)
    assert dtypes == {torch.float32} and n_moments == 2 * len(trainer.trainable)
    f32 = _trainer(case)
    f32.train_on_batch(case["batch"])

    tree = case["params"]["unet"]
    jgrads = jax_tree_from_unet_state({k: torch.from_numpy(v) for k, v in case["grads"].items()},
                                      like=tree)
    updates, state = optax_step(optax.adam(1e-4), jgrads, tree)
    mu = unet_state_from_jax(state[0].mu)
    update_j = unet_state_from_jax(updates)
    got_mu = optimizer_moments(trainer.optimizer, trainer.model.unet)["exp_avg"]
    f32_mu = optimizer_moments(f32.optimizer, f32.model.unet)["exp_avg"]
    after_f32 = dict(f32.model.unet.named_parameters())
    diffs = []
    for name, p in trainer.model.unet.named_parameters():
        # the first moment is 0.1 g: the gradient's tolerance
        m, mj, mf = got_mu[name].numpy(), mu[name].numpy(), f32_mu[name].numpy()
        assert np.linalg.norm(m - mj) <= BF16_GRAD_FACTOR * np.linalg.norm(mj - mf) + 1e-12, name
        dp = p.detach().numpy() - before[name].numpy()
        df = after_f32[name].detach().numpy() - before[name].numpy()
        diffs.append((np.sum((dp - update_j[name].numpy()) ** 2),
                      np.sum((update_j[name].numpy() - df) ** 2)))
    # the update: Adam's first is -lr g / (|g| + eps), about lr sign(g) per
    # element, so the steps differ where the two sides' bf16 gradients
    # straddle zero; over all leaves, within the factor of JAX's own bf16
    # step's distance to the float32 step
    port_vs_jax, jax_vs_f32 = np.sqrt(np.sum(diffs, axis=0))
    assert port_vs_jax <= BF16_GRAD_FACTOR * jax_vs_f32
    for k, v in trainer.ema.items():  # EMA: 0.999 ema + 0.001 params, in float32
        torch.testing.assert_close(v, 0.999 * before[k] + 0.001 * trainer.model.unet.state_dict()[k],
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("case", ["phydiff"], indirect=True)
def test_bf16_chains_leave_the_master_weights_unchanged(case, tmp_path):
    """Two bf16 chains cast the weights into the chain's shadow, never in
    place: the master weights stay float32 and equal bit for bit, and the
    second chain gives the first's fields. A checkpoint of a bf16 trainer
    holds float32 weights that a float32 model samples."""
    m = port_model(case["arch"], case["params"], torch.bfloat16)
    master = {n: p.detach().clone() for n, p in m.unet.named_parameters()}
    lr = {"LR": torch.from_numpy(case["batch"]["LR"])}
    kw = dict(sampler="ddim", ddim_steps=3, ddim_eta=1.0)
    a = m.generate_sr(lr, Schedule.from_config(SCHED), generator=torch.Generator().manual_seed(3),
                      **kw)
    b = m.generate_sr(lr, Schedule.from_config(SCHED), generator=torch.Generator().manual_seed(3),
                      **kw)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert a.dtype == torch.float32 and bool(torch.isfinite(a).all())
    for n, p in m.unet.named_parameters():
        assert p.dtype == torch.float32 and torch.equal(p, master[n]), n
    assert {p.dtype for p in m._shadow.parameters()} == {torch.bfloat16}
    # the shadow follows the master weights into the next chain
    with torch.no_grad():
        m.unet.final_conv.block[3].bias.add_(1.0)
    c = m.generate_sr(lr, Schedule.from_config(SCHED), generator=torch.Generator().manual_seed(3),
                      **kw)
    assert not torch.equal(a, c)

    opt = _opt(case["arch"])
    opt["path"]["checkpoint"] = str(tmp_path / "ckpt")
    trainer = build_trainer(opt, torch.device("cpu"), dtype=torch.bfloat16)
    trainer.train_on_batch(case["batch"])
    path = trainer.save()
    f32 = build_model(model_cfg(case["arch"]))
    load_model_weights(f32, path)
    for n, p in f32.unet.named_parameters():
        assert p.dtype == torch.float32
        assert torch.equal(p, trainer.model.unet.get_parameter(n)), n
    out = f32.generate_sr(lr, Schedule.from_config(SCHED),
                          generator=torch.Generator().manual_seed(3), **kw)
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())


@pytest.mark.parametrize("channels,reduction", [(4, 2), (2, 2)])
def test_res_se_computes_in_the_compute_dtype(channels, reduction):
    """ResSE's MLP runs in the compute dtype, as JAX's ResSE(dtype=bf16),
    over float32 weights; x * y + x promotes to x's float32. The MLP's own
    output is checked for bf16 (the old ResSE ran it in its weights'
    float32), and the result against JAX's within one bf16 ulp of y per
    element (XLA's bf16 sigmoid is off by up to one ulp where torch's is
    correctly rounded)."""
    rng = np.random.default_rng(channels)
    x = (rng.standard_normal((2, 8, 16, channels)) * 2 + 0.3).astype(np.float32)
    jm = JaxResSE(reduction=reduction, dtype=jnp.bfloat16)
    params = seeded_tree(jax.eval_shape(jm.init, jax.random.PRNGKey(0), x), rng)
    want = np.asarray(jm.apply(params, x))
    m = ResSE(channels, reduction)
    with torch.no_grad():
        for i, name in ((0, "Dense_0"), (2, "Dense_1")):
            m.fc[i].weight.copy_(torch.from_numpy(np.asarray(params["params"][name]["kernel"]).T))
    mlp_out = []
    m.fc.register_forward_hook(lambda mod, inp, out: mlp_out.append(out))
    with torch.no_grad():
        got = m(torch.from_numpy(x), torch.bfloat16)
    assert mlp_out[0].dtype == torch.bfloat16 and got.dtype == torch.float32
    assert {p.dtype for p in m.parameters()} == {torch.float32}
    ulp = 2.0 ** -8  # y in (0, 1): its bf16 spacing is at most 2**-8
    assert np.all(np.abs(got.numpy() - want) <= ulp * np.abs(x) * (1 + 1e-6))


# ---------------------------------------------------------- grad_clip, float32
@pytest.fixture(scope="module")
def f32_case():
    """phydiff in float32: params, batch, draws and JAX's loss gradients."""
    arch = "phydiff"
    jmodel = jax_build_model(model_cfg(arch))
    rng = np.random.default_rng(11)
    batch = {"HR": rng.standard_normal((2, H, W, 1)).astype(np.float32),
             "LR": rng.standard_normal((2, H // 4, W // 4, 1)).astype(np.float32)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    params = seeded_tree(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jbatch), rng)
    js = JSchedule.from_config(SCHED)
    key = jax.random.PRNGKey(6)
    grads = jax.jit(jax.grad(lambda p: jmodel.loss(p, jbatch, key, js, True)))(params)
    return {"arch": arch, "params": params, "batch": batch,
            "draws": jax_draws(key, js, batch["HR"].shape), "grads_tree": grads["unet"]}


def test_grad_clip_is_applied_end_to_end(f32_case):
    """train.optimizer.grad_clip through cli.build_trainer: one step matches
    optax.chain(clip_by_global_norm(c), adam) on JAX's gradients, through the
    bridge (parameters and both moments), and differs from the unclipped
    step, with c a quarter of the gradient's global norm."""
    tree, grads = f32_case["params"]["unet"], f32_case["grads_tree"]
    norm = float(jax.jit(optax.global_norm)(grads))
    clip = norm / 4
    steps = {}
    for c in (clip, None):
        tx = optax.adam(1e-4)
        if c is not None:
            tx = optax.chain(optax.clip_by_global_norm(c), tx)
        updates, state = optax_step(tx, grads, tree)
        adam = state[-1][0] if c is not None else state[0]
        trainer = _trainer(f32_case, **({"grad_clip": c} if c is not None else {}))
        assert trainer.grad_clip == c
        trainer.train_on_batch(f32_case["batch"])
        steps[c] = (trainer, optax.apply_updates(tree, updates), adam)
    for c, (trainer, want_params, adam) in steps.items():
        unet = trainer.model.unet
        got = jax_tree_from_unet_state(unet.state_dict(), like=tree)
        for key, w in _flat(want_params).items():
            np.testing.assert_allclose(_flat(got)[key], np.asarray(w), rtol=0, atol=2e-5,
                                       err_msg=f"clip={c} {key}")
        moments = optimizer_moments(trainer.optimizer, unet)
        for torch_key, optax_tree, floor in (("exp_avg", adam.mu, 1e-9),
                                             ("exp_avg_sq", adam.nu, 1e-15)):
            back = _flat(jax_tree_from_unet_state(moments[torch_key], like=tree))
            for key, w in _flat(optax_tree).items():
                w = np.asarray(w)
                assert np.linalg.norm(back[key] - w) <= 1e-3 * np.linalg.norm(w) + floor, (
                    c, torch_key, key)
    clipped, unclipped = (optimizer_moments(steps[c][0].optimizer, steps[c][0].model.unet)
                          for c in (clip, None))
    for k, v in clipped["exp_avg"].items():  # clipped by a quarter
        torch.testing.assert_close(v, unclipped["exp_avg"][k] / 4, rtol=1e-5, atol=1e-12)
    assert any(not torch.equal(a, b) for a, b in zip(
        steps[clip][0].model.unet.parameters(), steps[None][0].model.unet.parameters()))


def optax_step(tx, grads, params):
    """(updates, state) of tx's first step, jitted (eager optax compiles
    every leaf's ops one by one)."""
    return jax.jit(lambda g, p: tx.update(g, tx.init(p), p))(grads, params)


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def test_unet_layers_cast_per_call_and_keep_their_names():
    """Every convolution and linear layer of the UNet and of both encoders
    is a per-call-cast layer; the state_dict keys are those of a float32
    build; no parameter is cast by building in bf16."""
    for arch in ("physrdiff", "resdiff"):
        cfg = model_cfg(arch)
        if arch == "resdiff":
            cfg["pretrained_model"] = {"enabled": True}
        m16, m32 = build_model(cfg, dtype=torch.bfloat16), build_model(cfg)
        for part in (m16.unet, m16.encoder):
            for mod in part.modules():
                if isinstance(mod, (torch.nn.Conv2d, torch.nn.ConvTranspose2d, torch.nn.Linear)):
                    assert type(mod) in (layers.Conv2d, layers.ConvTranspose2d, layers.Linear)
        for a, b in ((m16.unet, m32.unet), (m16.encoder, m32.encoder)):
            assert list(a.state_dict()) == list(b.state_dict())
            assert {p.dtype for p in a.parameters()} == {torch.float32}
    copy.deepcopy(m16)  # the shadow field copies with the model


def test_chip_bf16_bound_floors_at_one_ulp():
    """chip_smoke.py phase 11's per-leaf bound. bf16_ulp is the gap to the
    next bf16 number. A one-element sign-count leaf (the final bias under
    the L1 loss: (n+ - n-) / N, here N = 65536) whose plain bf16 side
    rounds onto the float32 count holds a kernel side one ulp away at a
    third of its bound and fails one four ulps away; a leaf whose plain
    error exceeds its ulp keeps the bound 3 |g_p - g_f32|."""
    import chip_smoke

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(4096) * 10.0 ** rng.integers(-8, 3, 4096))
    xb = x.to(torch.bfloat16)
    up = (xb.abs().view(torch.int16) + 1).view(torch.bfloat16)
    assert torch.equal(chip_smoke.bf16_ulp(torch, xb), up.double() - xb.abs().double())
    assert chip_smoke.bf16_ulp(torch, torch.zeros(3)).abs().sum() == 0

    n = 65536.0
    big = torch.from_numpy(rng.standard_normal(64)).float()
    grads_p = {"bias": torch.tensor([-10304 / n]), "w": big}
    grads_f = {"bias": torch.tensor([-10304 / n]), "w": big + 0.05}
    for ulps, ratio in ((1, 1 / 3), (4, 4 / 3)):
        grads_k = {"bias": torch.tensor([(-10304 + 64 * ulps) / n]), "w": big + 0.01}
        rep = chip_smoke._bf16_report(torch, grads_k, grads_p, grads_f)
        got = dict((k, v) for k, v, _ in rep["worst_leaves"])
        assert got["bias"] == pytest.approx(ratio, rel=1e-2)  # + 1e-6 of the largest leaf
        assert got["w"] == pytest.approx(0.01 / (3 * 0.05), rel=1e-3)
        assert [k for k, _ in rep["ulp_floored"]] == ["bias"]
