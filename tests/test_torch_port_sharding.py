"""Parameter sharding over a "model" mesh axis on the CPU: two gloo ranks as a
(data=1, model=2) mesh against one process, and the sharded leaf set
against the JAX package's `param_placement`.

Two ranks are spawned once for the module (`ranks`); they run every
rank-side case (`_rank_cases`) while this process runs the same trainers
unsharded at the global batch. The weights are JAX's (a seeded fill of the
toy UNet's tree, bridged by utils/jax_params.py), the draws the trainer's
own over the global batch, so the two sides compute the same math:
  * the placement at min_shard_dim=8: the set of sharded leaves equals the
    JAX `param_placement`'s on a (1, 2) mesh, through the bridge's name map;
    each sharded leaf and its Adam moments hold half the rows on each rank;
  * 3 steps with Adam, with Lamb (its trust ratio takes each leaf's full
    norm) and with Adam under a `grad_clip` that binds: the losses within
    2e-4 relative and the gathered parameters within rtol 2e-3, atol 2e-5 of
    one process's (JAX's own bounds, tests/test_training.py TestTensorParallel);
    the EMA, sharded, within the same bounds of one process's;
  * `sample_batch` at step 0 (the same weights) gathered from the ranks
    against one process's: rtol 1e-4, atol 1e-5 (float32 sums over 2 rows
    against 4); `SamplerService.from_trainer` serves the gathered weights
    and EMA bit for bit;
  * a sharded checkpoint resumes into a sharded trainer and into an
    unsharded one, and an unsharded checkpoint into a sharded trainer, with
    every parameter, moment and EMA entry equal bit for bit; the tolerant
    (finetune_norm) load into a sharded trainer likewise;
  * make_mesh raises where JAX's does (a world not divisible by the model
    axis), and without a process group.

The rank side imports no JAX (this module imports it inside the test that
needs it), so a rank starts in seconds. Toy widths as
tests/test_torch_port_model.py.
"""

import multiprocessing as mp
import os
import socket

import numpy as np
import pytest
import torch

from srewd_tpu_torch.diffusion.schedule import Schedule
from srewd_tpu_torch.models.factory import build_model
from srewd_tpu_torch.parallel import (init_distributed, make_mesh, mean_across, rank, rows,
                                      shutdown)
from srewd_tpu_torch.serving.service import SamplerService
from srewd_tpu_torch.training.checkpoint import CheckpointManager
from srewd_tpu_torch.training.trainer import DiffusionTrainer

WORLD, B, H, W = 2, 2, 32, 64
MIN_DIM, STEPS, LR = 8, 3, 1e-3
CLIP = 1e-2  # below the toy model's first gradient norms: the clip binds
SCHED = {"schedule": "linear", "n_timestep": 1000, "linear_start": 1e-6, "linear_end": 1e-2}
CFG = {"architecture": "phydiff",
       "unet": {"in_channel": 2, "out_channel": 1, "inner_channel": 16, "norm_groups": 8,
                "channel_multiplier": [1, 2, 4], "attn_res": [8], "res_blocks": 1,
                "dropout": 0.2},
       "diffusion": {"image_height": H, "image_width": W, "image_channels": 1, "channels": 1,
                     "conditional": True}}
RUNS = {"adam": {"optimizer": "adam"}, "lamb": {"optimizer": "lamb"},
        "clip": {"optimizer": "adam", "grad_clip": CLIP}}
LOSS_REL, P_RTOL, P_ATOL = 2e-4, 2e-3, 2e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def global_batch(seed, n=WORLD * B):
    rng = np.random.default_rng(seed)
    return {"HR": rng.standard_normal((n, H, W, 1)).astype(np.float32),
            "LR": rng.standard_normal((n, H // 4, W // 4, 1)).astype(np.float32)}


def trainer_for(state, ckpt=None, shard=True, **kw):
    model = build_model(CFG)
    model.unet.load_state_dict(state, strict=True)
    sched = Schedule.from_config(SCHED)
    return DiffusionTrainer(model, sched, sched, device=torch.device("cpu"), lr=LR,
                            ema_decay=0.9, seed=0, checkpoint_dir=ckpt,
                            sampler_kwargs={"sampler": "ddim", "ddim_steps": 2},
                            model_shard_min_dim=MIN_DIM if shard else None, **kw)


def _local(batch):
    return {k: v[rows(B)] for k, v in batch.items()}


# ----------------------------------------------------------------- rank side
def _rank_entry(r, port, out, spec_path):
    os.environ.update(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(WORLD),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    init_distributed("gloo", model_parallel=2)
    try:
        _rank_cases(out, spec_path)
    finally:
        shutdown()


def _rank_cases(out, spec_path):
    spec = torch.load(spec_path, weights_only=False)
    res = {}
    for name, kw in RUNS.items():
        ckpt = os.path.join(out, f"ckpt_{name}") if name == "adam" else None
        t = trainer_for(spec["state"], ckpt, **kw)
        if name == "adam":
            res["sample0"] = t.sample_batch(_local(spec["batches"][0]))
            res["placement"] = dict(t._sharded.dims)
        losses = [float(mean_across(t.train_on_batch_async(_local(b))))
                  for b in spec["batches"]]
        res[name] = {"losses": losses, "state": t.state()}
        if name == "adam":
            for use_ema in (False, True):  # every rank gathers: a collective
                with SamplerService.from_trainer(t, use_ema=use_ema, devices="cpu") as svc:
                    res[f"served_ema{int(use_ema)}"] = svc.params()
            params = dict(t._sharded.module.named_parameters())
            res["shards"] = {n: params[n].detach().clone() for n in t._sharded.dims}
            res["moments"] = {n: t.optimizer.state[params[n]]["exp_avg"].shape
                              for n in t._sharded.dims if params[n] in t.optimizer.state}
            res["ema_shards"] = {k: v.shape for k, v in t.ema.items()
                                 if "unet." + k in t._sharded.dims}
            res["saved"] = t.save()
            again = trainer_for(spec["state"], **kw)
            again.resume(res["saved"])
            res["resumed_sharded"] = again.state()
    back = trainer_for(spec["state"])
    back.resume(spec["unsharded_ckpt"])
    res["resumed_from_unsharded"] = back.state()
    tolerant = trainer_for(spec["state"])
    tolerant.load_params_tolerant(spec["unsharded_ckpt"])
    res["tolerant"] = tolerant.state()
    torch.save(res, os.path.join(out, f"rank{rank()}.pt"))


# ------------------------------------------------------------ the module run
@pytest.fixture(scope="module")
def toy_state():
    """The JAX toy UNet's tree (a seeded fill of its shapes) and the port's
    state bridged from it."""
    import jax
    import jax.numpy as jnp

    from srewd_tpu.models.factory import build_model as jax_build_model
    from srewd_tpu_torch.utils.jax_params import unet_state_from_jax

    jmodel = jax_build_model(CFG)
    b = {k: jnp.asarray(v[:1]) for k, v in global_batch(0).items()}
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), b)["unet"]
    rng = np.random.default_rng(1)
    leaves, treedef = jax.tree.flatten(shapes)
    vals = [(rng.standard_normal(s.shape) / np.sqrt(max(1, np.prod(s.shape[:-1]))))
            .astype(np.float32) for s in leaves]
    tree = jax.tree.unflatten(treedef, vals)
    return tree, unet_state_from_jax(tree)


@pytest.fixture(scope="module")
def ranks(toy_state, tmp_path_factory):
    """(the ranks' results, one process's at the global batch, the unsharded
    checkpoint the ranks resumed)."""
    _, state = toy_state
    out = tmp_path_factory.mktemp("sharding")
    batches = [global_batch(s) for s in range(STEPS)]
    one = trainer_for(state, str(out / "unsharded"), shard=False)
    one.train_on_batch(batches[0])
    spec = {"state": state, "batches": batches, "unsharded_ckpt": one.save()}
    torch.save(spec, out / "spec.pt")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_entry, args=(r, port, str(out), str(out / "spec.pt")))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        ref = {}
        for name, kw in RUNS.items():
            t = trainer_for(state, shard=False, **kw)
            if name == "adam":
                ref["sample0"] = t.sample_batch(batches[0])
            ref[name] = {"losses": [t.train_on_batch(b) for b in batches], "state": t.state()}
    finally:
        for p in procs:
            p.join(300)
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
    assert not alive and [p.exitcode for p in procs] == [0] * WORLD, [p.exitcode for p in procs]
    got = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return got, ref, spec["unsharded_ckpt"]


def assert_same(a: dict, b: dict):
    """Two states (nested dicts of tensors) equal bit for bit."""
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            assert_same(a[k], b[k])
        elif torch.is_tensor(a[k]):
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


# ---------------------------------------------------------------------- tests
def test_sharded_leaves_are_jax_param_placement(ranks, toy_state):
    """The ranks' sharded set at min_shard_dim=8 on a model axis of 2 equals
    JAX's param_placement over the same tree, leaf by leaf through the
    bridge's name map; both ranks agree."""
    from srewd_tpu.parallel.mesh import make_mesh, param_placement
    from srewd_tpu_torch.utils.jax_params import _key_map

    tree, _ = toy_state
    placed = param_placement(tree, make_mesh(2, model_parallel=2), MIN_DIM)
    want = set()
    for key, (path, _) in _key_map(tree).items():
        node = placed
        for p in path:
            node = node[p]
        if "model" in tuple(node.spec):
            want.add("unet." + key)
    got, _, _ = ranks
    assert want and got[0]["placement"] == got[1]["placement"]
    assert set(got[0]["placement"]) == want
    assert len(want) < len(got[0]["adam"]["state"]["params"])  # some leaves stay whole
    for name, d in got[0]["placement"].items():  # the bridge's output-feature dim
        assert d == (1 if name == "unet.cond_proj.weight" else 0)


def test_each_rank_holds_half_the_rows_of_leaves_and_moments(ranks):
    got, _, _ = ranks
    full = got[0]["adam"]["state"]["params"]
    assert got[0]["moments"].keys() == got[0]["placement"].keys()
    for name, d in got[0]["placement"].items():
        shape = full[name.removeprefix("unet.")].shape
        halves = [g["shards"][name] for g in got]
        for h, g in zip(halves, got):
            assert h.shape[d] == shape[d] // 2
            assert g["moments"][name] == h.shape
        assert torch.equal(torch.cat(halves, d), full[name.removeprefix("unet.")])
    assert got[0]["ema_shards"].keys() == {n.removeprefix("unet.") for n in got[0]["placement"]}
    for k, shape in got[0]["ema_shards"].items():
        d = got[0]["placement"]["unet." + k]
        assert shape[d] * 2 == full[k].shape[d]


@pytest.mark.parametrize("run", list(RUNS))
def test_two_ranks_match_one_process(ranks, run):
    """Losses, gathered parameters and the gathered EMA after 3 steps, with
    Adam, Lamb and a binding grad_clip; the ranks' gathered states equal."""
    got, ref, _ = ranks
    for g in got:
        np.testing.assert_allclose(g[run]["losses"], ref[run]["losses"], rtol=LOSS_REL)
    assert_same(got[0][run]["state"]["params"], got[1][run]["state"]["params"])
    for key in ("params", "ema_params"):
        for k, want in ref[run]["state"][key].items():
            np.testing.assert_allclose(got[0][run]["state"][key][k].numpy(), want.numpy(),
                                       rtol=P_RTOL, atol=P_ATOL, err_msg=f"{key} {k}")


def test_sample_batch_matches_one_process(ranks):
    got, ref, _ = ranks
    sr = torch.cat([g["sample0"] for g in got])
    np.testing.assert_allclose(sr.numpy(), ref["sample0"].numpy(), rtol=1e-4, atol=1e-5)


def test_service_from_a_sharded_trainer_serves_whole_weights(ranks):
    """SamplerService.from_trainer on the ranks snapshots the gathered
    weights (and the gathered EMA), not a rank's rows."""
    got, _, _ = ranks
    for g in got:
        state = g["adam"]["state"]
        assert_same(g["served_ema0"]["unet"], state["params"])
        assert_same(g["served_ema1"]["unet"], state["ema_params"])


def test_sharded_checkpoint_resumes_sharded_and_unsharded(ranks):
    got, _, _ = ranks
    saved = CheckpointManager.restore(got[0]["saved"])
    assert_same(got[0]["resumed_sharded"], got[0]["adam"]["state"])
    assert_same(saved, got[0]["adam"]["state"])
    one = trainer_for(got[0]["adam"]["state"]["params"], shard=False)
    one.resume(got[0]["saved"])
    assert_same(one.state(), got[0]["adam"]["state"])


def test_unsharded_checkpoint_resumes_sharded(ranks):
    got, _, unsharded = ranks
    want = CheckpointManager.restore(unsharded)
    for g in got:
        assert_same(g["resumed_from_unsharded"], want)


def test_tolerant_load_into_a_sharded_trainer(ranks):
    """The finetune_norm load takes the checkpoint's weights into the shards
    and restarts the EMA from them; the step count stays 0."""
    got, _, unsharded = ranks
    want = CheckpointManager.restore(unsharded)["params"]
    for g in got:
        assert_same(g["tolerant"]["params"], want)
        assert_same(g["tolerant"]["ema_params"], want)
        assert g["tolerant"]["step"] == 0


def test_make_mesh_refuses_what_jax_refuses():
    with pytest.raises(ValueError, match="not divisible"):
        make_mesh(3, model_parallel=2)
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(2, model_parallel=2)
