"""The port's data parallelism against the JAX package, on the CPU.

* Striding: the port's DataHandler at (process_index, process_count) =
  (0..2, 3) and (0..1, 2) on a synthetic tree whose splits (25 and 23
  hours) are no multiple of the counts: the strides are disjoint, cover the
  index trimmed to a multiple of the count, give every rank the same batch
  count, and each equals the JAX DataHandler's stride (built directly, no
  jax.distributed) cut to the common length. The JAX package does not trim
  (srewd_tpu/data/pipeline.py:158-159), so its strides differ in length.
* The slice (the twin of tests/test_multihost.py): two gloo ranks at local
  batch 4 take 2 DiffusionTrainer steps (DDP, Adam 1e-4, dropout 0) of sr3
  and phydiff on the JAX weights bridged through utils/jax_params.py, each
  loss handed JAX's draws for the global batch of 8; against JAX's single
  process, jax.value_and_grad(model.loss) and optax on the global batch.
  Tolerances of tests/test_torch_port_train.py's one-step comparison: the
  losses within 1e-5 relative, the first step's reduced gradients leaf by
  leaf within 1e-3 relative RMSE (a leaf without signal, under 1e-6 of the
  largest norm: absolute against the largest); the parameters after 2 steps
  leaf by leaf within 1e-5 relative (norm); both ranks bit for bit.

The ranks run tests/test_torch_port_ddp.py's `rank_jax_slice` (that module
imports no JAX) while this process computes JAX's steps. Toy widths as
tests/test_torch_port_model.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from srewd_tpu.data.pipeline import DataHandler as JaxDataHandler
from srewd_tpu.diffusion.schedule import Schedule as JSchedule
from srewd_tpu.models.factory import build_model as jax_build_model
from srewd_tpu_torch.data.pipeline import DataHandler
from srewd_tpu_torch.data.store import make_synthetic_weatherbench
from srewd_tpu_torch.utils.jax_params import unet_state_from_jax

from test_torch_port_ddp import join_ranks, norm_rel, rank_jax_slice, start_ranks
from test_torch_port_model import H, W, one_torch_thread, toy_model_cfg  # noqa: F401

SCHED = {"schedule": "linear", "n_timestep": 1000, "linear_start": 1e-6, "linear_end": 1e-2}
B_GLOBAL, STEPS, LR = 8, 2, 1e-4


# ------------------------------------------------------------------- striding
@pytest.fixture(scope="module")
def handler_kw(tmp_path_factory):
    root = tmp_path_factory.mktemp("ddp_strides")
    make_synthetic_weatherbench(str(root), "2017-01-01-00", "2017-01-03-00",
                                lr_shape=(8, 16), hr_shape=(32, 64), spectrum="t2m")
    return dict(dataroot=str(root), variables=["t2m"], months_subset=[1], groups=[[1]],
                train_min_date="2017-01-01-00", train_max_date="2017-01-02-01",
                val_min_date="2017-01-02-01", val_max_date="2017-01-03-00",
                train_batch_size=2, val_batch_size=2)


@pytest.fixture(scope="module")
def port_handlers(handler_kw):
    """{(index, count): the port's DataHandler}, (0, 1) the whole index."""
    pairs = [(0, 1), (0, 2), (1, 2), (0, 3), (1, 3), (2, 3)]
    return {(i, c): DataHandler(**handler_kw, process_index=i, process_count=c).process_data()
            for i, c in pairs}


@pytest.mark.parametrize("count", [2, 3])
def test_strides_are_disjoint_trimmed_and_even(port_handlers, count):
    whole = port_handlers[0, 1]
    for split in ("train", "val"):
        full = getattr(whole, f"{split}_timestamps")
        assert len(full) in (25, 23) and len(full) % count
        strides = [getattr(port_handlers[i, count], f"{split}_timestamps") for i in range(count)]
        union = np.concatenate(strides)
        assert len(set(union.tolist())) == len(union)  # disjoint
        assert set(union.tolist()) == set(full[:len(full) // count * count].tolist())
        assert {len(s) for s in strides} == {len(full) // count}
        assert len({port_handlers[i, count].steps_per_epoch(split) for i in range(count)}) == 1


@pytest.mark.parametrize("index,count", [(0, 3), (1, 3), (2, 3), (0, 2), (1, 2)])
def test_stride_is_jaxs_cut_to_the_common_length(port_handlers, handler_kw, index, count):
    jax_dh = JaxDataHandler(**handler_kw, process_index=index,
                            process_count=count).process_data()
    port = port_handlers[index, count]
    for split in ("train", "val"):
        n = len(getattr(port_handlers[0, 1], f"{split}_timestamps")) // count
        ours, theirs = (getattr(h, f"{split}_timestamps") for h in (port, jax_dh))
        assert len(ours) == n and len(theirs) in (n, n + 1)
        np.testing.assert_array_equal(ours, theirs[:n])


# ------------------------------------------------------------------ the slice
def _jax_case(arch, out_dir):
    """JAX's single-process steps at the global batch, and what the ranks need."""
    cfg = toy_model_cfg(arch)
    cfg["unet"]["dropout"] = 0.0
    jmodel = jax_build_model(cfg)
    rng = np.random.default_rng(3)
    batches = [{"HR": rng.standard_normal((B_GLOBAL, H, W, 1)).astype(np.float32),
                "LR": rng.standard_normal((B_GLOBAL, H // 4, W // 4, 1)).astype(np.float32)}
               for _ in range(STEPS)]
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            {k: jnp.asarray(v) for k, v in batches[0].items()})["unet"]
    leaves, treedef = jax.tree.flatten(shapes)
    vals = [(rng.standard_normal(s.shape) / np.sqrt(max(1, np.prod(s.shape[:-1]))))
            .astype(np.float32) for s in leaves]
    tree = jax.tree.unflatten(treedef, vals)
    js = JSchedule.from_config(SCHED)
    keys = [jax.random.PRNGKey(20 + i) for i in range(STEPS)]
    draws = []
    for key, batch in zip(keys, batches):  # the draws JAX takes inside loss
        k_t, k_noise, _ = jax.random.split(key, 3)
        kt, kg = jax.random.split(k_t)
        draws.append({
            "t": np.asarray([int(jax.random.randint(kt, (), 1, js.num_timesteps + 1))]),
            "u": np.array(jax.random.uniform(kg, (B_GLOBAL,))),
            "noise": np.array(jax.random.normal(k_noise, batch["HR"].shape))})
    case = {"cfg": cfg, "state": unet_state_from_jax(tree), "batches": batches, "draws": draws}
    return case, (jmodel, tree, js, keys, batches)


def _jax_steps(jmodel, tree, js, keys, batches):
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, b, k: jmodel.loss(p, b, k, js, True)))
    tx = optax.adam(LR)
    params = {"unet": tree}
    state = tx.init(params)
    losses, first = [], None
    for key, batch in zip(keys, batches):
        loss, grads = grad_fn(params, {k: jnp.asarray(v) for k, v in batch.items()}, key)
        first = first or grads
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        losses.append(float(loss))
    return {"losses": losses, "grads": unet_state_from_jax(first["unet"]),
            "params": unet_state_from_jax(params["unet"])}


@pytest.fixture(scope="module")
def slice_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("ddp_jax")
    cases, jax_inputs = {}, {}
    for arch in ("sr3", "phydiff"):
        cases[arch], jax_inputs[arch] = _jax_case(arch, out)
    torch.save({"archs": cases, "sched": SCHED, "lr": LR}, out / "spec.pt")
    procs = start_ranks(rank_jax_slice, str(out), str(out / "spec.pt"))
    try:
        want = {arch: _jax_steps(*inputs) for arch, inputs in jax_inputs.items()}
    finally:
        join_ranks(procs)
    got = [torch.load(out / f"jax_rank{r}.pt", weights_only=False) for r in range(2)]
    return got, want


@pytest.mark.parametrize("arch", ["sr3", "phydiff"])
def test_two_ranks_step_as_jax_at_the_global_batch(slice_run, arch):
    got, want = slice_run
    got, want = [g[arch] for g in got], want[arch]
    for g in got:
        for a, b in zip(g["losses"], want["losses"]):
            assert abs(a - b) <= 1e-5 * abs(b)
    largest = max(float(np.linalg.norm(w.numpy())) for w in want["grads"].values())
    assert got[0]["grads"].keys() == want["grads"].keys()
    for name, w in want["grads"].items():
        g, w = got[0]["grads"][name].numpy(), w.numpy()
        if np.linalg.norm(w) < 1e-6 * largest:  # no signal: against the largest
            assert np.linalg.norm(g - w) <= 1e-6 * largest, name
        else:
            assert np.sqrt(np.mean((g - w) ** 2) / np.mean(w ** 2)) <= 1e-3, name
    for name, w in want["params"].items():
        assert norm_rel(got[0]["params"][name], w) <= 1e-5, name
        torch.testing.assert_close(got[1]["params"][name], got[0]["params"][name],
                                   rtol=0, atol=0)
