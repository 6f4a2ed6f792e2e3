"""The port's quality script (`python -m srewd_tpu_torch.quality_e2e`) against
the JAX package's scripts/quality_e2e.py, on the CPU.

* `DiffusionTrainer.sample_batch(fold=)`: fold 0 is the validation stream
  as before, every other fold a stream of its own; quality_e2e's ensemble
  folds are unique per (batch, member), where the JAX script's
  (i + 1) * 131 + e repeats beyond 131 members (a reference-side fault,
  shown here, not repaired in the JAX package).
* The bicubic row against JAX's bicubic_up4 + ValidationMetrics +
  inverse_transform on the same synthetic tree (byte-identical trees).
* Sampler rows at toy width (phydiff, HR 32x64, inner 8, one res block,
  batch 2, one val batch): the JAX trainer's weights go through
  utils/jax_params into the port, and the noise of JAX's
  `trainer.sample_batch(batch, fold=, use_ema=)` (the key
  fold_in(fold_in(base_key, 2_000_000_000 + step), fold), split as the JAX
  chains split it) is fed to the port's chain through `evaluate(sample=)`.
* The JSON: JAX's keys and row labels, rendered by
  scripts/summarize_quality.py; `--reuse-params` and `--reuse-checkpoint`
  load the weights and EMA that were saved. (scripts/quality_e2e.py itself
  is not run here: its trainer's init compiles for over a minute on the
  CPU, beyond this file's budget.)
"""

import copy
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srewd_tpu.cli import build_data_handler as jax_build_data_handler
from srewd_tpu.data.store import make_synthetic_weatherbench as jax_make_synthetic
from srewd_tpu.ops.resize import bicubic_up4 as jax_bicubic_up4
from srewd_tpu.training.metrics import ValidationMetrics as JaxValidationMetrics
from srewd_tpu.training.metrics import create_metric_dict as jax_create_metric_dict
from srewd_tpu_torch import quality_e2e
from srewd_tpu_torch.cli import build_data_handler, build_trainer
from srewd_tpu_torch.data.store import make_synthetic_weatherbench
from srewd_tpu_torch.training.checkpoint import CheckpointManager
from srewd_tpu_torch.training.trainer import _VAL_STREAM, step_seed
from srewd_tpu_torch.utils.jax_params import unet_state_from_jax
from srewd_tpu_torch.utils.seeding import member_seed

from test_torch_port_model import _jax_noise, one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
from summarize_quality import table  # noqa: E402

DATES = dict(data_min="2017-01-01-00", data_max="2017-01-02-00",
             train_min="2017-01-01-00", train_max="2017-01-01-12",
             val_min="2017-01-01-12", val_max="2017-01-01-23")
DATE_FLAGS = [x for k, v in DATES.items() for x in ("--" + k.replace("_", "-"), v)]
METRICS = ("MSE", "RMSE", "MAE", "MR", "PSNR", "SSIM")
TVAL, K = 8, 4  # the DDPM chain length; the DDIM and DPM steps


def toy_args(**kw):
    """quality_e2e's arguments at toy size (parse_args of the flags)."""
    flags = ["--arch", "phydiff", "--hr-shape", "32", "64", "--batch", "2",
             "--val-batches", "1", "--tval", str(TVAL), "--iters", "2", *DATE_FLAGS]
    for k, v in kw.items():
        flags += [f"--{k.replace('_', '-')}", str(v)]
    return quality_e2e.parse_args(flags)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """quality_e2e's synthetic tree, made by both packages: byte-identical."""
    root = tmp_path_factory.mktemp("quality")
    kw = dict(lr_shape=(8, 16), hr_shape=(32, 64), spectrum="t2m")
    port = make_synthetic_weatherbench(str(root / "port"), DATES["data_min"],
                                       DATES["data_max"], **kw)
    jax_make_synthetic(str(root / "jax"), DATES["data_min"], DATES["data_max"], **kw)
    return root, port


def test_synthetic_trees_are_byte_identical(tree):
    root, _ = tree
    files = []
    for dirpath, _, names in os.walk(root / "jax"):
        for name in names:
            a = os.path.join(dirpath, name)
            b = os.path.join(root / "port", os.path.relpath(a, root / "jax"))
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), name
            files.append(name)
    assert sum(f.endswith(".npy") for f in files) >= 2 * 24


@pytest.fixture(scope="module")
def opt(tree):
    """quality_e2e's config at toy width: inner 8 in 8 groups, one res block."""
    _, dataroot = tree
    opt = quality_e2e.build_opt(toy_args(), dataroot)
    opt["model"]["unet"].update(inner_channel=8, norm_groups=8, res_blocks=1)
    return opt


def rel(got, want):
    return abs(got - want) / max(abs(want), 1e-30)


# SSIM takes window variances as E[x^2] - E[x]^2 of float32 Kelvin fields
# (~280 K), which cancels: one-ulp differences in its inputs, or its sums
# in another order, move it ~1e-5 relative (test_torch_port_train.py
# test_validation_metrics_match_jax holds the port's SSIM to JAX's at 1e-5)
BICUBIC_BOUND = {**{k: 1e-6 for k in METRICS}, "SSIM": 1e-5}


def test_bicubic_row_matches_jax(opt):
    from srewd_tpu_torch.ops.resize import bicubic_up4

    dh = build_data_handler(opt)
    got = quality_e2e.bicubic_metrics(dh, 2, "cpu")
    jdh = jax_build_data_handler(copy.deepcopy(opt))
    vm = JaxValidationMetrics(jax_create_metric_dict())
    for i, (batch, pbatch) in enumerate(zip(jdh.val_batches(), dh.val_batches())):
        if i >= 2:
            break
        inf = np.asarray(jax_bicubic_up4(jnp.asarray(batch["LR"])))
        # the row's field: within float32 round-off of JAX's (matrix products
        # summed in another order)
        pinf = bicubic_up4(torch.from_numpy(pbatch["LR"])).numpy()
        assert np.abs(pinf - inf).max() <= 1e-6 * np.abs(inf).max()
        inv = jdh.inverse_transform({"INF": inf, "HR": np.asarray(batch["HR"])},
                                    batch["months"])
        vm.update(inv["HR"], inv["INF"])
    want = vm.compute_metrics()
    assert set(got) == set(METRICS)
    for k in METRICS:
        assert rel(got[k], want[k]) <= BICUBIC_BOUND[k], (k, got[k], want[k])


# ---------------------------------------------------------------- the folds
@pytest.fixture(scope="module")
def pair(opt):
    """(JAX trainer, port trainer, JAX and port data handlers), both holding
    the same seeded weights and an EMA of other weights. The JAX trainer is
    srewd_tpu's DiffusionTrainer as srewd_tpu.cli.build_trainer makes it,
    on a one-device mesh (the batch of 2 need not tile the harness's 8
    virtual devices), its params filled from `jax.eval_shape` of the init
    (tests/test_torch_port_archs.py's seeded_tree: flax's init compiles
    for a minute here)."""
    from srewd_tpu.diffusion.schedule import Schedule as JaxSchedule
    from srewd_tpu.models.factory import build_model as jax_build_model
    from srewd_tpu.parallel.mesh import make_mesh
    from srewd_tpu.training.optimizers import get_optimizer
    from srewd_tpu.training.trainer import DiffusionTrainer as JaxTrainer
    from test_torch_port_archs import seeded_tree

    jmodel = jax_build_model(opt["model"])
    bs = opt["model"]["beta_schedule"]
    jt = JaxTrainer(jmodel, JaxSchedule.from_config(bs["train"]),
                    JaxSchedule.from_config(bs["val"]), get_optimizer("adam", 1e-4),
                    mesh=make_mesh(1), ema_decay=0.999, seed=int(opt.get("seed", 0)))
    jdh = jax_build_data_handler(copy.deepcopy(opt))
    example = next(iter(jdh.train_batches(0)))
    shapes = jax.eval_shape(jmodel.init, jt.base_key,
                            {k: jnp.asarray(example[k]) for k in ("HR", "LR")})
    rng = np.random.default_rng(5)
    jt.params = seeded_tree(shapes, rng)
    jt.ema_params = jax.tree.map(
        lambda x: x * (1 + 0.05 * rng.standard_normal(x.shape)).astype(np.float32), jt.params)
    pt = build_trainer(copy.deepcopy(opt), torch.device("cpu"))
    pt.model.unet.load_state_dict(unet_state_from_jax(jt.params["unet"]), strict=True)
    pt.ema = dict(unet_state_from_jax(jt.ema_params["unet"]))
    return jt, pt, jdh, build_data_handler(opt)


def test_fold_zero_is_the_validation_stream(pair):
    _, pt, _, dh = pair
    batch = next(iter(dh.val_batches()))
    pt.sampler_kwargs = {"sampler": "dpm", "ddim_steps": K, "clip_denoised": False}
    got = pt.sample_batch(batch)
    gen = torch.Generator().manual_seed(step_seed(pt.seed, _VAL_STREAM + pt.step))
    want = pt.model.generate_sr({"LR": torch.from_numpy(batch["LR"])}, pt.schedule_val,
                                generator=gen, **pt.sampler_kwargs)
    assert torch.equal(got, want)
    assert torch.equal(pt.sample_batch(batch, fold=0), want)


def test_folds_give_distinct_fields(pair):
    _, pt, _, dh = pair
    batch = next(iter(dh.val_batches()))
    pt.sampler_kwargs = {"sampler": "dpm", "ddim_steps": K, "clip_denoised": False}
    fields = [pt.sample_batch(batch, fold=f) for f in range(4)]
    for a in range(4):
        for b in range(a + 1, 4):
            assert not torch.equal(fields[a], fields[b]), (a, b)


def test_ensemble_folds_are_unique_where_jax_repeats():
    n_batches, members = 8, 200
    folds = [quality_e2e.ensemble_fold(i, e, n_batches, members)
             for i in range(n_batches) for e in range(members)]
    assert len(set(folds)) == n_batches * members
    assert not set(folds) & set(range(1, n_batches + 1))  # the single-chain rows' folds
    base = step_seed(0, _VAL_STREAM)
    seeds = {member_seed(base, f) for f in folds + list(range(n_batches + 1))}
    assert len(seeds) == n_batches * members + n_batches + 1
    # scripts/quality_e2e.py:289 folds (i + 1) * 131 + e: member 131 of
    # batch i is member 0 of batch i + 1 (the JAX package is left as it is)
    jax_folds = [(i + 1) * 131 + e for i in range(n_batches) for e in range(members)]
    assert len(set(jax_folds)) < len(jax_folds)
    assert (0 + 1) * 131 + 131 == (1 + 1) * 131 + 0


# ---------------------------------------------------- sampler rows against JAX
ROWS = {  # label: (sampler kwargs, use_ema, ensemble)
    f"ddim-{K}-noclip": ({"sampler": "ddim", "ddim_steps": K, "ddim_eta": 0.0,
                          "tau_spacing": "logsnr", "clip_denoised": False}, False, 1),
    f"dpm-{K}-noclip": ({"sampler": "dpm", "ddim_steps": K, "tau_spacing": "logsnr",
                         "clip_denoised": False}, False, 1),
    f"dpm-{K}-noclip-ema": ({"sampler": "dpm", "ddim_steps": K, "tau_spacing": "logsnr",
                             "clip_denoised": False}, True, 1),
    f"ddpm-{TVAL}-noclip-ema-ens2": ({"clip_denoised": False}, True, 2),
}


def _jax_row(jt, jdh, kw, use_ema, ensemble, n_batches=1):
    """scripts/quality_e2e.py's eval_sampler, with its folds."""
    jt.sampler_kwargs = dict(kw)
    jt._build_steps()
    vm = JaxValidationMetrics(jax_create_metric_dict())
    for i, batch in enumerate(jdh.val_batches()):
        if i >= n_batches:
            break
        if ensemble > 1:
            sr = np.mean([np.asarray(jt.sample_batch(batch, fold=(i + 1) * 131 + e,
                                                     use_ema=use_ema))
                          for e in range(ensemble)], axis=0)
        else:
            sr = jt.sample_batch(batch, fold=i + 1, use_ema=use_ema)
        inv = jdh.inverse_transform({"SR": np.asarray(sr), "HR": np.asarray(batch["HR"])},
                                    batch["months"])
        vm.update(inv["HR"], inv["SR"])
    return vm.compute_metrics()


def _jax_noise_hook(jt, pt, ensemble, n_batches=1):
    """evaluate's `sample`: the port's chain on the noise JAX's sample_batch
    draws at the JAX script's fold for the same (batch, member)."""
    models = {False: pt.model, True: copy.deepcopy(pt.model)}
    models[True].unet.load_state_dict(pt.ema, strict=True)
    jax_fold = {i + 1: i + 1 for i in range(n_batches)}
    jax_fold.update({quality_e2e.ensemble_fold(i, e, n_batches, ensemble): (i + 1) * 131 + e
                     for i in range(n_batches) for e in range(ensemble)} if ensemble > 1 else {})

    def sample(batch, fold, use_ema):
        key = jax.random.fold_in(jt.base_key, 2_000_000_000 + pt.step)
        key = jax.random.fold_in(key, jax_fold[fold])
        kw = pt.sampler_kwargs
        n = kw.get("ddim_steps", 0) if kw.get("sampler") else pt.schedule_val.num_timesteps
        init, noises = _jax_noise(key, batch["HR"].shape, n)
        with torch.no_grad():
            return models[use_ema].generate_sr(
                {"LR": torch.from_numpy(batch["LR"])}, pt.schedule_val,
                init=torch.from_numpy(init), noises=[torch.from_numpy(x) for x in noises],
                **kw)

    return sample


@pytest.mark.parametrize("label", list(ROWS))
def test_sampler_row_matches_jax(pair, label):
    jt, pt, jdh, dh = pair
    kw, use_ema, ensemble = ROWS[label]
    want = _jax_row(jt, jdh, kw, use_ema, ensemble)
    got = quality_e2e.evaluate(pt, dh, kw, use_ema=use_ema, ensemble=ensemble, n_batches=1,
                               sample=_jax_noise_hook(jt, pt, ensemble))
    assert pt.sampler_kwargs == kw
    assert set(got["metrics"]) == set(METRICS)
    # float32 chains summed in another order on each side
    for k in METRICS:
        assert rel(got["metrics"][k], want[k]) <= 1e-4, (k, got["metrics"][k], want[k])


# ------------------------------------------------------------ the JSON, reuse
CLI = ["--device", "cpu", "--inner-channel", "32", "--res-blocks", "1",
       "--samplers", "dpm", "--dpm-steps", "2", "--variants", "noclip,ema", "--ema-start", "0",
       "--ema-decay", "0.5"]
JAX_KEYS = {"arch", "partial", "metrics_note", "accuracy_gate_note", "spectrum", "tau_spacing",
            "ddim_eta", "train_range", "val_range", "reused", "iters", "batch", "val_fields",
            "train_wall_sec", "train_steps_per_sec", "train_loss_mean100", "bicubic",
            "samplers", "rmse_vs_bicubic"}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One toy run of quality_e2e.main: 2 steps, dpm rows with and without EMA."""
    work = tmp_path_factory.mktemp("quality_run")
    out = quality_e2e.main(["--arch", "phydiff", "--hr-shape", "32", "64", "--batch", "2",
                            "--val-batches", "1", "--iters", "2", "--workdir", str(work),
                            "--out", str(work / "Q.json"), *DATE_FLAGS, *CLI])
    return work, out


def test_json_has_jax_keys_and_labels(trained):
    work, out = trained
    on_disk = json.loads((work / "Q.json").read_text())
    assert on_disk == out
    assert set(out) == JAX_KEYS | {"device"} and out["device"] == "cpu"
    assert list(out["samplers"]) == ["dpm-2-noclip", "dpm-2-noclip-ema"]
    assert set(out["rmse_vs_bicubic"]) == set(out["samplers"])
    assert not out["partial"] and out["iters"] == 2 and out["val_fields"] == 2
    assert len(out["train_loss_mean100"]) == 1
    for row in (out["bicubic"], *out["samplers"].values()):
        assert set(row["metrics"]) == set(METRICS)
        assert all(np.isfinite(v) for v in row["metrics"].values())
    md = table(str(work / "Q.json"))
    assert "| bicubic ×4 |" in md and all(f"| {label} |" in md for label in out["samplers"])


def _loaded_trainer(monkeypatch):
    seen = {}
    orig = quality_e2e.evaluate

    def evaluate(trainer, *a, **kw):
        seen.setdefault("trainer", trainer)
        return orig(trainer, *a, **kw)

    monkeypatch.setattr(quality_e2e, "evaluate", evaluate)
    return seen


def _same(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_reuse_params_loads_weights_and_ema(trained, monkeypatch):
    work, _ = trained
    saved = torch.load(work / "params.pt", weights_only=True)
    seen = _loaded_trainer(monkeypatch)
    out = quality_e2e.main(["--arch", "phydiff", "--hr-shape", "32", "64", "--batch", "2",
                            "--val-batches", "1", "--workdir", str(work), "--reuse-params",
                            str(work / "params.pt"), "--out", str(work / "R.json"),
                            *DATE_FLAGS, *CLI])
    _same(seen["trainer"].model.unet.state_dict(), saved["params"])
    _same(seen["trainer"].ema, saved["ema_params"])
    assert out["reused"] == str(work / "params.pt") and out["train_loss_mean100"] == []


@pytest.mark.parametrize("with_ema", [True, False])
def test_reuse_checkpoint_loads_weights_and_ema(trained, monkeypatch, tmp_path, with_ema):
    work, _ = trained
    saved = torch.load(work / "params.pt", weights_only=True)
    state = {"params": saved["params"], "opt_state": {}, "step": 7, "epoch": 1}
    if with_ema:
        state["ema_params"] = saved["ema_params"]
    path = CheckpointManager(str(tmp_path)).save(state, 7, 1)
    seen = _loaded_trainer(monkeypatch)
    out = quality_e2e.main(["--arch", "phydiff", "--hr-shape", "32", "64", "--batch", "2",
                            "--val-batches", "1", "--workdir", str(work), "--reuse-checkpoint",
                            path, "--out", str(tmp_path / "C.json"), *DATE_FLAGS, *CLI])
    _same(seen["trainer"].model.unet.state_dict(), saved["params"])
    if with_ema:
        _same(seen["trainer"].ema, saved["ema_params"])
        assert list(out["samplers"]) == ["dpm-2-noclip", "dpm-2-noclip-ema"]
    else:  # no EMA in the file: no EMA row, as in the JAX script
        assert seen["trainer"].ema is None
        assert list(out["samplers"]) == ["dpm-2-noclip"]
