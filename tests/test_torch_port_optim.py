"""The port's Lamb and Lion against optax.lamb and optax.lion, on the CPU.

Five steps on a small seeded tree, with one leaf initialised to zero (its
trust ratio is 1) and one leaf whose gradient is exactly zero at every step
(Lion's sign is 0 there), at optax's defaults and with weight decay, under
grad_clip's chain (optax.chain(clip_by_global_norm, tx) against
`clip_by_global_norm_` before the step) and under finetune_norm's mask
(JAX's `finetune_norm_optimizer` against an optimizer over the norm leaves
only). Parameters and moments within 1e-6 relative (+1e-7 absolute for
entries near zero) after every step. Then optax's state carried into the
port's optimizer mid-run, and the port's into optax's, and exact resume of a
toy trainer through `cli.build_trainer`.
"""

import json
import os

import numpy as np
import optax
import pytest
import torch
import torch.nn as nn

from srewd_tpu.training.optimizers import finetune_norm_optimizer
from srewd_tpu_torch.training.optimizers import Lamb, Lion, clip_by_global_norm_, get_optimizer
from srewd_tpu_torch.utils.jax_params import load_optax_state, optax_state

from test_torch_port_model import one_torch_thread, toy_model_cfg  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-6, 1e-7
SHAPES = {"Conv_0/kernel": (3, 3, 2, 4), "Conv_0/bias": (4,),
          "FusedGroupNorm_0/scale": (4,), "FusedGroupNorm_0/bias": (4,),
          "Dense_0/kernel": (4, 5), "Dense_0/bias": (5,)}
ZERO_INIT = ("Conv_0/bias", "FusedGroupNorm_0/bias")  # zero at init: ||p|| = 0
ZERO_GRAD = "Dense_0/bias"  # an exactly zero gradient at every step
NORM = ("FusedGroupNorm_0/scale", "FusedGroupNorm_0/bias")


def nested(flat: dict) -> dict:
    out: dict = {}
    for key, v in flat.items():
        a, b = key.split("/")
        out.setdefault(a, {})[b] = np.asarray(v, np.float32)
    return out


def flatten(tree: dict) -> dict:
    return {f"{a}/{b}": np.asarray(v) for a, sub in tree.items() for b, v in sub.items()}


def to_tree(tensors: dict) -> dict:
    return nested({k: v.detach().numpy() for k, v in tensors.items()})


def from_tree(tree: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in flatten(tree).items()}


def init_params(seed=0) -> dict:
    rng = np.random.default_rng(seed)
    return {k: (np.zeros(s) if k in ZERO_INIT else rng.standard_normal(s)).astype(np.float32)
            for k, s in SHAPES.items()}


def grad_draws(n, seed=1) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        g = {k: (2 * rng.standard_normal(s)).astype(np.float32) for k, s in SHAPES.items()}
        g[ZERO_GRAD][:] = 0.0
        out.append(g)
    return out


def optax_tx(name, wd, clip, finetune):
    kw = {} if wd is None else {"weight_decay": wd}
    tx = (optax.lamb if name == "lamb" else optax.lion)(1e-2, **kw)
    if clip:
        tx = optax.chain(optax.clip_by_global_norm(clip), tx)
    return finetune_norm_optimizer(tx) if finetune else tx


def port_side(name, wd, params, finetune):
    module = nn.ParameterDict({k: nn.Parameter(torch.from_numpy(v.copy()))
                               for k, v in params.items()})
    trainable = [p for k, p in module.items() if not finetune or k in NORM]
    kw = {} if wd is None else {"weight_decay": wd}
    return module, trainable, get_optimizer(name, trainable, 1e-2, **kw)


def port_step(module, trainable, opt, grads, clip):
    for k, p in module.items():
        p.grad = torch.from_numpy(grads[k].copy())
    if clip:
        clip_by_global_norm_(trainable, clip)
    opt.step()


def inner_state(name, state, clip, finetune):
    """optax's ScaleByAdamState / ScaleByLionState inside the chain."""
    if finetune:
        state = state[0].inner_state
    if clip:
        state = state[1]
    return state[0]


def assert_close(got: dict, want: dict, what: str):
    for k, w in want.items():
        np.testing.assert_allclose(got[k], np.asarray(w), rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what} {k}")


CASES = [("defaults", None, None, False), ("weight_decay", 0.05, None, False),
         ("grad_clip", None, 1.0, False), ("finetune_norm", 0.05, 1.0, True)]


@pytest.mark.parametrize("name", ["lamb", "lion"])
@pytest.mark.parametrize("case,wd,clip,finetune", CASES, ids=[c[0] for c in CASES])
def test_five_steps_match_optax(name, case, wd, clip, finetune):
    params = init_params()
    tx = optax_tx(name, wd, clip, finetune)
    tree = nested(params)
    state = tx.init(tree)
    module, trainable, opt = port_side(name, wd, params, finetune)
    assert type(opt) is (Lamb if name == "lamb" else Lion)
    for step, grads in enumerate(grad_draws(5)):
        updates, state = tx.update(nested(grads), state, tree)
        tree = optax.apply_updates(tree, updates)
        port_step(module, trainable, opt, grads, clip)
        assert_close({k: p.detach().numpy() for k, p in module.items()}, flatten(tree),
                     f"step {step + 1} params")
        inner = inner_state(name, state, clip, finetune)
        got = optax_state(opt, module, to_tree)
        assert got["count"] == int(inner.count) == step + 1
        fields = ("mu", "nu") if name == "lamb" else ("mu",)
        assert sorted(f for f in got if f != "count") == sorted(fields)
        for f in fields:
            want = {k: v for k, v in flatten(getattr(inner, f)).items()
                    if not finetune or k in NORM}
            assert_close(flatten(got[f]), want, f"step {step + 1} {f}")
    if finetune:  # the other leaves never move
        for k, p in module.items():
            if k not in NORM:
                np.testing.assert_array_equal(p.detach().numpy(), params[k])
    if name == "lion" and not finetune:
        # sign(0) = 0: the zero-gradient leaf moves by its weight decay alone
        decay = (1.0 - 1e-2 * (1e-3 if wd is None else wd)) ** 5
        np.testing.assert_allclose(module[ZERO_GRAD].detach().numpy(),
                                   params[ZERO_GRAD] * decay, rtol=RTOL)
        assert not opt.state[module[ZERO_GRAD]]["exp_avg"].any()


@pytest.mark.parametrize("name", ["lamb", "lion"])
def test_state_carries_both_ways_mid_run(name):
    """Three optax steps, its state into the port's optimizer, two more steps
    each side; and three port steps, its state into optax's, two more."""
    draws = grad_draws(5, seed=2)
    tx = optax_tx(name, 0.05, None, False)

    # optax -> port
    tree = nested(init_params(3))
    state = tx.init(tree)
    for g in draws[:3]:
        updates, state = tx.update(nested(g), state, tree)
        tree = optax.apply_updates(tree, updates)
    module, trainable, opt = port_side(name, 0.05, flatten(tree), False)
    load_optax_state(opt, module, state[0]._asdict(), from_tree)
    for g in draws[3:]:
        updates, state = tx.update(nested(g), state, tree)
        tree = optax.apply_updates(tree, updates)
        port_step(module, trainable, opt, g, None)
    assert_close({k: p.detach().numpy() for k, p in module.items()}, flatten(tree), "optax->port")
    assert optax_state(opt, module, to_tree)["count"] == 5

    # port -> optax
    module, trainable, opt = port_side(name, 0.05, init_params(3), False)
    for g in draws[:3]:
        port_step(module, trainable, opt, g, None)
    tree = to_tree(dict(module.items()))
    state = tx.init(tree)
    carried = optax_state(opt, module, to_tree)
    fields = {f: carried[f] for f in state[0]._fields if f != "count"}
    state = (state[0]._replace(count=np.int32(carried["count"]), **fields), *state[1:])
    for g in draws[3:]:
        updates, state = tx.update(nested(g), state, tree)
        tree = optax.apply_updates(tree, updates)
        port_step(module, trainable, opt, g, None)
    assert_close({k: p.detach().numpy() for k, p in module.items()}, flatten(tree), "port->optax")


@pytest.mark.parametrize("name", ["lamb", "lion"])
def test_resume_through_build_trainer_repeats_the_next_step(name, tmp_path):
    """A toy phydiff trainer with optimizer.type lamb / lion: three steps
    with a checkpoint after each; the trainer resumed from step 3 takes the
    same fourth step, bit for bit, moments and counts included."""
    from srewd_tpu_torch.cli import Config, build_data_handler, build_trainer
    from srewd_tpu_torch.configs.config import load_commented_json
    from srewd_tpu_torch.data.store import make_synthetic_weatherbench

    make_synthetic_weatherbench(str(tmp_path / "data"), "2017-01-01-00", "2017-01-02-12",
                                lr_shape=(8, 16), hr_shape=(32, 64), spectrum="t2m")
    cfg = load_commented_json(os.path.join(
        REPO, "configs/experiment_configs/phydiff/resdiff+physics_train_example.json"))
    cfg["data"].update(dataroot=str(tmp_path / "data"), num_workers=2,
                       train_min_date="2017-01-01-00", train_max_date="2017-01-02-00",
                       val_min_date="2017-01-02-00", val_max_date="2017-01-02-12")
    cfg["model"]["unet"].update(toy_model_cfg("phydiff")["unet"])
    cfg["model"]["diffusion"].update(image_height=32, image_width=64)
    cfg["train"]["optimizer"].update(type=name, lr=1e-3, grad_clip=1.0)
    cfg["train"]["ema_scheduler"].update(enabled=True, step_start_ema=1)
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    opt = Config(str(tmp_path / "cfg.json"), phase="train", experiment=False).get_opt()
    opt["path"]["checkpoint"] = str(tmp_path / "ckpt")
    dh = build_data_handler(opt)
    batches = list(dh.train_batches(epoch=1))
    a = build_trainer(opt, torch.device("cpu"))
    assert type(a.optimizer) is (Lamb if name == "lamb" else Lion)
    for i in range(3):
        a.train_on_batch(batches[i])
    path = a.save()
    opt["path"]["resume_state"] = path
    b = build_trainer(opt, torch.device("cpu"))
    assert b.step == 3 and type(b.optimizer) is type(a.optimizer)
    assert b.train_on_batch(batches[3]) == a.train_on_batch(batches[3])
    for (n, pa), pb in zip(a.model.unet.named_parameters(), b.model.unet.parameters()):
        torch.testing.assert_close(pb, pa, rtol=0, atol=0, msg=n)
        for key, va in a.optimizer.state[pa].items():
            torch.testing.assert_close(b.optimizer.state[pb][key], va, rtol=0, atol=0)
    assert int(a.optimizer.state[pa]["step"]) == 4
