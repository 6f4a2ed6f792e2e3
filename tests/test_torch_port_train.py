"""The port's training slice against the JAX package, on the CPU.

K2 (FlashAttentionFn's backward) against jax.grad of the Pallas
`flash_attention_trainable` in interpret mode; K3's gradient (GNSwishFn)
against jax.vjp of `_pure_gn_swish`; the training draws and q_sample; the
loss and every gradient leaf of sr3 and phydiff against
jax.value_and_grad(model.loss) with the same weights, batch and draws;
one optimizer step against optax; the EMA formula; checkpoints and resume;
and the `python -m srewd_tpu_torch.train` entry point.

Toy widths as tests/test_torch_port_model.py (inner 16, 8 groups, mults
(1, 2, 4), one res block, attention at 8x16, 32x64 fields), dropout 0
where JAX is compared.
"""

import copy
import glob
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from srewd_tpu.diffusion import gaussian as jax_gaussian
from srewd_tpu.diffusion.schedule import Schedule as JSchedule
from srewd_tpu.models.factory import build_model as jax_build_model
from srewd_tpu.ops.flash_attention import flash_attention_trainable as jax_flash_trainable
from srewd_tpu.ops.pallas_fused import _pure_gn_swish
from srewd_tpu.ops.ssim import ssim as jax_ssim
from srewd_tpu.training.metrics import ValidationMetrics as JaxValidationMetrics
from srewd_tpu.training.metrics import create_metric_dict as jax_metric_dict
from srewd_tpu.training.optimizers import norm_param_mask
from srewd_tpu_torch.diffusion.gaussian import draw_time_and_gamma, q_sample
from srewd_tpu_torch.diffusion.schedule import Schedule
from srewd_tpu_torch.models.factory import build_model
from srewd_tpu_torch.ops.flash_attention import (
    FlashAttentionFn, attention_backward_reference, attention_reference,
    flash_attention_backward)
from srewd_tpu_torch.ops.fused_groupnorm import (
    GNSwishFn, gn_swish, gn_swish_backward, gn_swish_backward_reference, gn_swish_reference)
from srewd_tpu_torch.ops.ssim import ssim
from srewd_tpu_torch.training.checkpoint import CheckpointManager
from srewd_tpu_torch.training.metrics import ValidationMetrics, create_metric_dict
from srewd_tpu_torch.training.optimizers import (
    clip_by_global_norm_, get_optimizer, norm_parameters)
from srewd_tpu_torch.training.trainer import DiffusionTrainer
from srewd_tpu_torch.utils.jax_params import (
    _key_map, jax_tree_from_unet_state, optimizer_moments, unet_state_from_jax)

from test_torch_port_model import (  # noqa: F401  (one_torch_thread: autouse)
    H, W, one_torch_thread, toy_model_cfg)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCHED = {"schedule": "linear", "n_timestep": 1000, "linear_start": 1e-6, "linear_end": 1e-2}


def rel_rmse(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.sqrt(np.mean((got - want) ** 2) / np.mean(want**2))


def flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


# --------------------------------------------------------------------- kernels
@pytest.mark.parametrize("shape", [(2, 512, 64), (1, 128, 512)])
def test_flash_attention_grads_match_jax_pallas_backward(shape):
    b, n, d = shape
    rng = np.random.default_rng(3)
    q, k, v, co = (rng.standard_normal(shape).astype(np.float32) for _ in range(4))
    scale = 1.0 / math.sqrt(d)

    def loss(q_, k_, v_):
        return jnp.sum(jax_flash_trainable(q_, k_, v_, scale, True) * co)

    want = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    attention_backward_reference.calls = 0
    out = FlashAttentionFn.apply(qt, kt, vt, scale)
    got = torch.autograd.grad((out * torch.from_numpy(co)).sum(), (qt, kt, vt))
    assert attention_backward_reference.calls == 1  # a CPU tensor takes the plain version
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-4, err_msg=f"d{name}")


def test_attention_backward_reference_is_the_gradient_of_attention_reference():
    rng = np.random.default_rng(4)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((2, 96, 32)).astype(np.float32))
                   for _ in range(4))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    want = torch.autograd.grad((attention_reference(q, k, v, 0.2) * do).sum(), (q, k, v))
    got = attention_backward_reference(q.detach(), k.detach(), v.detach(), do, 0.2)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-6, rtol=1e-5)


def test_flash_attention_backward_refuses_cpu_tensors():
    x = torch.zeros(1, 8, 64)
    with pytest.raises(RuntimeError, match="CUDA kernel"):
        flash_attention_backward(x, x, x, x, torch.zeros(1, 8), x, 0.1)


@pytest.mark.parametrize("swish", [True, False])
def test_gn_swish_grads_match_jax_vjp(swish):
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((2, 8, 16, 64)) * 2 + 0.5).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    g = rng.standard_normal((2, 8, 16, 64)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, s, c: _pure_gn_swish(a, s, c, 8, 1e-5, swish), x, w, bias)
    want = vjp(g)
    ins = [torch.from_numpy(a).requires_grad_() for a in (x, w, bias)]
    gn_swish_reference.calls = gn_swish_backward_reference.calls = 0
    gn_swish.launches = gn_swish_backward.launches = 0
    y = GNSwishFn.apply(*ins, 8, 1e-5, swish)
    got = torch.autograd.grad(y, ins, torch.from_numpy(g))
    # a CPU tensor takes both plain versions, each once; no kernel launches
    assert gn_swish_reference.calls == 1 and gn_swish_backward_reference.calls == 1
    assert gn_swish.launches == 0 and gn_swish_backward.launches == 0
    for gt, wt in zip(got, want):
        np.testing.assert_allclose(gt.numpy(), np.asarray(wt), rtol=1e-4, atol=1e-4)


def _bf16_values(a):
    """a rounded to bfloat16, as float32 numpy."""
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("swish", [True, False])
def test_gn_swish_backward_reference_matches_jax_vjp(swish, dtype):
    # the plain backward the kernel is held to: dx, dweight, dbias against
    # jax.vjp of _pure_gn_swish. bfloat16: the port in bf16 against JAX in
    # float32 on the same bf16-valued inputs, within two bf16 ulps of the
    # largest value (the Swish's gradient chain rounds in bf16; JAX's own bf16
    # VJP rounds at other places and is itself ~2 ulps off the float32 one)
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((2, 8, 16, 64)) * 3 + 1).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    g = rng.standard_normal((2, 8, 16, 64)).astype(np.float32)
    arrays = (x, w, bias, g) if dtype == torch.float32 else tuple(
        _bf16_values(a) for a in (x, w, bias, g))
    _, vjp = jax.vjp(lambda a, s, c: _pure_gn_swish(a, s, c, 32, 1e-5, swish), *arrays[:3])
    want = [np.asarray(t) for t in vjp(arrays[3])]
    ins = [torch.from_numpy(a).to(dtype) for a in arrays]
    gn_swish_backward_reference.calls = 0
    got = gn_swish_backward_reference(ins[0], ins[3], ins[1], ins[2], 32, 1e-5, swish)
    assert gn_swish_backward_reference.calls == 1
    for gt, wt, name in zip(got, want, ("dx", "dweight", "dbias")):
        assert gt.dtype == dtype
        gt = gt.float().numpy()
        if dtype == torch.float32:
            np.testing.assert_allclose(gt, wt, rtol=1e-4, atol=1e-4, err_msg=name)
        else:
            tol = 2.0 * 2.0 ** (np.floor(np.log2(np.abs(wt).max())) - 7)
            assert np.abs(gt - wt).max() <= tol, (name, np.abs(gt - wt).max(), tol)


def test_gn_swish_backward_refuses_cpu_tensors():
    x = torch.zeros(1, 4, 4, 64)
    w = torch.ones(64)
    stats = torch.zeros(1, 32)
    with pytest.raises(RuntimeError, match="CUDA kernel"):
        gn_swish_backward(x, x, w, w, stats, stats, 32, True)


# ----------------------------------------------------------------------- draws
def test_draws_and_q_sample_match_jax():
    """JAX's (t, gamma, noise) regenerated with the loss's own splits
    (factory.py:162-164, gaussian.py:42-46); the port's formula given them."""
    js = JSchedule.from_config(SCHED)
    ps = Schedule.from_config(SCHED)
    rng = jax.random.PRNGKey(11)
    k_t, k_noise, _ = jax.random.split(rng, 3)
    t_j, gamma_j = jax_gaussian.draw_time_and_gamma(k_t, js, 3)
    kt, kg = jax.random.split(k_t)
    t_draw = np.asarray(jax.random.randint(kt, (), 1, js.num_timesteps + 1))
    u = np.array(jax.random.uniform(kg, (3,)))
    assert int(t_draw) == int(t_j)
    t_p, gamma_p = draw_time_and_gamma(ps, 3, t=torch.tensor([int(t_draw)]),
                                       u=torch.from_numpy(u))
    assert int(t_p) == int(t_j)
    np.testing.assert_allclose(gamma_p.numpy(), np.asarray(gamma_j), rtol=1e-6)
    x0 = np.random.default_rng(0).standard_normal((3, 4, 8, 1)).astype(np.float32)
    noise = np.array(jax.random.normal(k_noise, x0.shape))
    want = jax_gaussian.q_sample(x0, gamma_j, noise)
    got = q_sample(torch.from_numpy(x0), torch.from_numpy(np.array(gamma_j)),
                   torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    # drawn on the port's side: t in [1, T]; sqrt_acp_prev falls with t, so
    # lo > hi and the form of jax.random.uniform clamps every gamma to lo,
    # as the JAX package draws it (ROADMAP.md Queue 3)
    t2, g2 = draw_time_and_gamma(ps, 64, generator=torch.Generator().manual_seed(0))
    lo = ps.sqrt_alphas_cumprod_prev[t2 - 1]
    assert 1 <= int(t2) <= 1000 and bool((g2 == lo).all())
    np.testing.assert_array_equal(np.asarray(gamma_j), np.full(3, np.asarray(gamma_j)[0]))


# ------------------------------------------------------------------ loss, grads
def _cfg(arch, dropout=0.0):
    cfg = toy_model_cfg(arch)
    cfg["unet"]["dropout"] = dropout
    return cfg


@pytest.fixture(scope="module", params=["sr3", "phydiff"])
def pair(request):
    arch = request.param
    jmodel = jax_build_model(_cfg(arch))
    rng = np.random.default_rng(1)
    batch = {"HR": rng.standard_normal((2, H, W, 1)).astype(np.float32),
             "LR": rng.standard_normal((2, H // 4, W // 4, 1)).astype(np.float32)}
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            {k: jnp.asarray(v) for k, v in batch.items()})["unet"]
    leaves, treedef = jax.tree.flatten(shapes)
    vals = [(rng.standard_normal(s.shape) / np.sqrt(max(1, np.prod(s.shape[:-1]))))
            .astype(np.float32) for s in leaves]
    tree = jax.tree.unflatten(treedef, vals)
    port = build_model(_cfg(arch))
    port.unet.load_state_dict(unet_state_from_jax(tree), strict=True)
    return arch, jmodel, tree, port, batch


def test_loss_and_every_gradient_leaf_match_jax(pair):
    arch, jmodel, tree, port, batch = pair
    js = JSchedule.from_config(SCHED)
    rng = jax.random.PRNGKey(5)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, jbatch, rng, js, True)))({"unet": tree})
    # the draws JAX took inside loss (factory.py:162-164)
    k_t, k_noise, _ = jax.random.split(rng, 3)
    kt, kg = jax.random.split(k_t)
    t = int(jax.random.randint(kt, (), 1, js.num_timesteps + 1))
    u = np.array(jax.random.uniform(kg, (2,)))
    noise = np.array(jax.random.normal(k_noise, batch["HR"].shape))

    port.unet.zero_grad(set_to_none=True)
    loss_p = port.loss({k: torch.from_numpy(v) for k, v in batch.items()},
                       Schedule.from_config(SCHED), t=torch.tensor([t]),
                       u=torch.from_numpy(u), noise=torch.from_numpy(noise))
    loss_p.backward()
    assert abs(loss_p.item() - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    want = unet_state_from_jax(grads_j["unet"])  # JAX grads by the port's names
    got = {n: p.grad for n, p in port.unet.named_parameters()}
    assert got.keys() == want.keys()
    largest = max(float(np.linalg.norm(w.numpy())) for w in want.values())
    for name, w in want.items():
        w = w.numpy()
        if np.linalg.norm(w) < 1e-6 * largest:  # no signal: compare against the largest
            assert np.linalg.norm(got[name].numpy() - w) <= 1e-6 * largest, name
        else:
            assert rel_rmse(got[name].numpy(), w) <= 1e-3, name
    # and the other way: the port's grads as a JAX tree, leaf by leaf
    back = flat(jax_tree_from_unet_state(got, like=tree))
    for key, w in flat(grads_j["unet"]).items():
        assert back[key].shape == w.shape, key


def test_bridge_round_trips_params_and_moments(pair):
    _, _, tree, port, _ = pair
    back = jax_tree_from_unet_state(port.unet.state_dict(), like=tree)
    for key, v in flat(tree).items():
        np.testing.assert_array_equal(flat(back)[key], v, err_msg=key)
    with pytest.raises(ValueError, match="keys differ"):
        jax_tree_from_unet_state({"stray": torch.zeros(1)}, like=tree)


def test_loss_uses_dropout_in_train_mode():
    port = build_model(_cfg("phydiff", dropout=0.2))
    rng = np.random.default_rng(2)
    batch = {"HR": torch.from_numpy(rng.standard_normal((2, H, W, 1)).astype(np.float32)),
             "LR": torch.from_numpy(rng.standard_normal((2, H // 4, W // 4, 1)).astype(np.float32))}
    draws = dict(t=torch.tensor([300]), u=torch.tensor([0.2, 0.7]),
                 noise=torch.zeros(2, H, W, 1).normal_(generator=torch.Generator().manual_seed(1)))
    with torch.no_grad():
        torch.manual_seed(0)
        a = port.loss(batch, Schedule.from_config(SCHED), **draws)
        torch.manual_seed(1)
        b = port.loss(batch, Schedule.from_config(SCHED), **draws)
        c = port.loss(batch, Schedule.from_config(SCHED), train=False, **draws)
        d = port.loss(batch, Schedule.from_config(SCHED), train=False, **draws)
    assert a.item() != b.item() and c.item() == d.item()
    port_l2 = build_model({**_cfg("sr3"), "loss_type": "l2"})
    assert port_l2.loss_type == "l2"


# ------------------------------------------------------------------ optimizers
@pytest.mark.parametrize("clip", [None, 0.5])
def test_adam_step_matches_optax(clip):
    rng = np.random.default_rng(6)
    params = {f"p{i}": rng.standard_normal(s).astype(np.float32)
              for i, s in enumerate([(3, 4), (5,), (2, 2, 3)])}
    grads = {k: (3 * rng.standard_normal(v.shape)).astype(np.float32) for k, v in params.items()}
    tx = optax.adam(1e-3)
    if clip:
        tx = optax.chain(optax.clip_by_global_norm(clip), tx)
    state = tx.init(params)
    updates, state = tx.update(grads, state, params)
    want = optax.apply_updates(params, updates)

    tp = [torch.from_numpy(params[k].copy()).requires_grad_() for k in params]
    for p, k in zip(tp, params):
        p.grad = torch.from_numpy(grads[k].copy())
    opt = get_optimizer("adam", tp, 1e-3)
    if clip:
        norm = clip_by_global_norm_(tp, clip)
        assert norm.item() > clip  # the clip is exercised
    opt.step()
    for p, k in zip(tp, params):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-7)
    adam_state = state[-1][0] if clip else state[0]
    for p, k in zip(tp, params):
        np.testing.assert_allclose(opt.state[p]["exp_avg"].numpy(), np.asarray(adam_state.mu[k]),
                                   rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(opt.state[p]["exp_avg_sq"].numpy(),
                                   np.asarray(adam_state.nu[k]), rtol=1e-6, atol=1e-8)


def test_adam_step_on_the_unet_matches_optax_through_the_bridge(pair):
    """Gradients go in through the bridge, moments come back out of it."""
    _, _, tree, port, _ = pair
    rng = np.random.default_rng(7)
    grads = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), tree)
    tx = optax.adam(1e-3)
    state = tx.init(tree)
    updates, state = tx.update(grads, state, tree)
    want = optax.apply_updates(tree, updates)

    unet = copy.deepcopy(port.unet)
    for name, g in unet_state_from_jax(grads).items():
        unet.get_parameter(name).grad = g
    opt = get_optimizer("adam", list(unet.parameters()), 1e-3)
    opt.step()
    got = flat(jax_tree_from_unet_state(unet.state_dict(), like=tree))
    for key, w in flat(want).items():
        np.testing.assert_allclose(got[key], np.asarray(w), rtol=1e-6, atol=1e-7, err_msg=key)
    moments = optimizer_moments(opt, unet)
    for torch_key, optax_tree in (("exp_avg", state[0].mu), ("exp_avg_sq", state[0].nu)):
        back = flat(jax_tree_from_unet_state(moments[torch_key], like=tree))
        for key, w in flat(optax_tree).items():
            np.testing.assert_allclose(back[key], np.asarray(w), rtol=1e-6, atol=1e-9,
                                       err_msg=f"{torch_key} {key}")


def test_optimizer_names():
    p = [torch.zeros(2, requires_grad=True)]
    kinds = {"adam": torch.optim.Adam, "amsgrad": torch.optim.Adam, "adamw": torch.optim.AdamW,
             "sgd": torch.optim.SGD, "asgd": torch.optim.SGD, "rmsprop": torch.optim.RMSprop,
             "adadelta": torch.optim.Adadelta, "adagrad": torch.optim.Adagrad,
             "adamax": torch.optim.Adamax}
    for name, cls in kinds.items():
        assert type(get_optimizer(name, p, 1e-3)) is cls
    assert get_optimizer("amsgrad", p, 1e-3).defaults["amsgrad"]
    for name in ("lamb", "lion"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item"):
            get_optimizer(name, p, 1e-3)
    with pytest.raises(ValueError, match="unknown optimizer"):
        get_optimizer("nope", p, 1e-3)


def test_finetune_norm_trains_exactly_the_groupnorm_affines(pair):
    _, _, tree, port, _ = pair
    mask = flat(norm_param_mask(tree))
    spec = _key_map(tree)
    want = {k for k, (path, _) in spec.items()
            if mask[jax.tree_util.keystr(tuple(jax.tree_util.DictKey(p) for p in path))]}
    got = {name for name, _ in norm_parameters(port.unet)}
    assert got == want and got


def test_ema_update_matches_jax_formula(tmp_path):
    model = build_model(_cfg("sr3"))
    sched = Schedule.from_config(SCHED)
    trainer = DiffusionTrainer(model, sched, sched, device=torch.device("cpu"), ema_decay=0.999)
    rng = np.random.default_rng(8)
    ema0 = {k: torch.from_numpy(rng.standard_normal(v.shape).astype(np.float32))
            for k, v in trainer.ema.items()}
    trainer.ema = {k: v.clone() for k, v in ema0.items()}
    trainer._ema_update()
    params = model.unet.state_dict()
    for k, e in ema0.items():
        want = jnp.asarray(e.numpy()) * 0.999 + jnp.asarray(params[k].numpy()) * (1.0 - 0.999)
        np.testing.assert_allclose(trainer.ema[k].numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------ checkpoints, CLI
@pytest.fixture(scope="module")
def toy_run(tmp_path_factory):
    """A 32x64 synthetic tree and a toy phydiff train config over it."""
    from srewd_tpu_torch.configs.config import load_commented_json
    from srewd_tpu_torch.data.store import make_synthetic_weatherbench

    root = tmp_path_factory.mktemp("port_train")
    make_synthetic_weatherbench(str(root / "data"), "2017-01-01-00", "2017-01-03-00",
                                lr_shape=(8, 16), hr_shape=(32, 64), spectrum="t2m")
    cfg = load_commented_json(os.path.join(
        REPO, "configs/experiment_configs/phydiff/resdiff+physics_train_example.json"))
    cfg["data"].update(dataroot=str(root / "data"), num_workers=2,
                       train_min_date="2017-01-01-00", train_max_date="2017-01-02-00",
                       val_min_date="2017-01-02-00", val_max_date="2017-01-03-00")
    cfg["model"]["unet"].update(_cfg("phydiff", dropout=0.2)["unet"])
    cfg["model"]["diffusion"].update(image_height=H, image_width=W, sampler="ddim", ddim_steps=2)
    cfg["path"]["experiments_folder_path"] = str(root)
    cfg["train"].update(n_iter=3, print_freq=1, val_freq=3, save_checkpoint_freq=2,
                        full_val_freq=1000)
    cfg["train"]["ema_scheduler"].update(enabled=True, step_start_ema=1)
    (root / "cfg.json").write_text(json.dumps(cfg))
    return root


def test_checkpoint_resume_repeats_the_next_step(toy_run):
    from srewd_tpu_torch.cli import Config, build_data_handler, build_trainer

    opt = Config(str(toy_run / "cfg.json"), phase="train", experiment=False).get_opt()
    ckpt_dir = str(toy_run / "ckpt_direct")
    opt["path"]["checkpoint"] = ckpt_dir
    opt["train"]["checkpoint_keep"] = 2
    dh = build_data_handler(opt)
    batches = list(dh.train_batches(epoch=1))
    a = build_trainer(opt, torch.device("cpu"))
    for i in range(3):
        a.train_on_batch(batches[i])
        a.save()
    mgr = CheckpointManager(ckpt_dir)
    assert [s for s, _, _ in mgr.all_checkpoints()] == [2, 3]  # keep=2 rotated I1 out
    assert mgr.latest().endswith("I3_E0")
    opt["path"]["resume_state"] = mgr.latest()
    b = build_trainer(opt, torch.device("cpu"))
    assert b.step == 3
    for k, v in a.ema.items():
        torch.testing.assert_close(b.ema[k], v, rtol=0, atol=0)
    assert b.train_on_batch(batches[3]) == a.train_on_batch(batches[3])


def test_train_entry_point_on_cpu(toy_run):
    r = subprocess.run(
        [sys.executable, "-m", "srewd_tpu_torch.train", "-p", "train",
         "-c", str(toy_run / "cfg.json"), "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=REPO,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    runs = glob.glob(str(toy_run / "experiments" / "*"))
    assert len(runs) == 1
    ckpts = sorted(os.listdir(os.path.join(runs[0], "checkpoint")))
    assert ckpts == ["I2_E1", "I3_E1"]
    log = open(os.path.join(runs[0], "logs", "train.log")).read()
    assert log.count("l_pix") == 3 and "End of training." in log
    val = open(os.path.join(runs[0], "logs", "val.log")).read()
    assert "Iteration:        3" in val and "SSIM" in val


def test_train_cuda_request_without_card_raises(toy_run):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA path is driven by chip_smoke.py")
    from srewd_tpu_torch.train import main

    with pytest.raises(RuntimeError, match="cuda"):
        main(["-c", str(toy_run / "cfg.json"), "--device", "cuda"])


# --------------------------------------------------------------------- metrics
def test_validation_metrics_match_jax():
    rng = np.random.default_rng(9)
    hr = (280 + 5 * rng.standard_normal((3, 32, 64, 1))).astype(np.float32)
    sr = (hr + rng.standard_normal(hr.shape)).astype(np.float32)
    np.testing.assert_allclose(ssim(torch.from_numpy(sr), torch.from_numpy(hr)).numpy(),
                               np.asarray(jax_ssim(jnp.asarray(sr), jnp.asarray(hr))),
                               rtol=1e-5)
    vm_j, vm_p = JaxValidationMetrics(jax_metric_dict()), ValidationMetrics(create_metric_dict())
    for i in range(2):
        vm_j.update(hr[i:i + 2], sr[i:i + 2])
        vm_p.update(hr[i:i + 2], sr[i:i + 2])
    want, got = vm_j.compute_metrics(), vm_p.compute_metrics()
    assert want.keys() == got.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-5), k
