"""The port's entry point: `python -m srewd_tpu_torch.sample` on the CPU.

A toy phydiff config over a 32x64 / 8x16 synthetic tree, with UNet params
written as an .npz from a JAX param tree, must give finite Kelvin fields
and a summary; the package must import without jax; a CUDA request with no
card must raise.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srewd_tpu.data.store import make_synthetic_weatherbench
from srewd_tpu.models.factory import build_model as jax_build_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def save_npz(tree, path):
    """Write a JAX param tree as an .npz whose keys are '/'-joined tree paths."""
    flat = {"/".join(k.key for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}
    np.savez(path, **flat)


@pytest.fixture(scope="module")
def env_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_cli")
    make_synthetic_weatherbench(
        str(root / "data"), min_date="2017-01-01-00", max_date="2017-01-03-00",
        lr_shape=(8, 16), hr_shape=(32, 64), spectrum="t2m",
    )
    with open(os.path.join(
            REPO, "configs/experiment_configs/phydiff/resdiff+physics_ddim50_eval.json")) as f:
        cfg = json.load(f)
    cfg["data"].update(
        dataroot=str(root / "data"), num_workers=2,
        train_min_date="2017-01-01-00", train_max_date="2017-01-02-00",
        val_min_date="2017-01-02-00", val_max_date="2017-01-03-00",
        months_subset=[1], transform_groups={"january": [1]},
    )
    cfg["model"]["unet"].update(inner_channel=16, norm_groups=8,
                                channel_multiplier=[1, 2, 4], attn_res=[8], res_blocks=1)
    cfg["model"]["diffusion"].update(image_height=32, image_width=64, ddim_steps=3)
    (root / "cfg.json").write_text(json.dumps(cfg))

    jmodel = jax_build_model(cfg["model"])
    batch = {"HR": jnp.zeros((1, 32, 64, 1)), "LR": jnp.zeros((1, 8, 16, 1))}
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), batch)["unet"]
    rng = np.random.default_rng(0)
    tree = jax.tree.map(
        lambda s: (0.1 * rng.standard_normal(s.shape)).astype(np.float32), shapes)
    save_npz(tree, str(root / "params.npz"))
    return root


def test_import_leaves_jax_out():
    """Neither jax nor any module of the JAX package (srewd_tpu) is loaded by
    the port's entry points."""
    code = ("import sys, srewd_tpu_torch.sample, srewd_tpu_torch.train, srewd_tpu_torch.cli\n"
            "print('jax' in sys.modules, sorted(m for m in sys.modules "
            "if m.split('.')[0] == 'srewd_tpu'))")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       cwd=REPO, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "False []"


def test_sample_cli_writes_kelvin_fields(env_root):
    out = env_root / "out"
    r = subprocess.run(
        [sys.executable, "-m", "srewd_tpu_torch.sample", "-c", str(env_root / "cfg.json"),
         "-m", str(env_root / "params.npz"),
         "--date-range", "2017-01-02-00", "2017-01-02-06", "--batch-size", "4",
         "--save-npy", "-o", str(out), "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=REPO,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    files = sorted(os.listdir(out / "sr"))
    # 6 hours in 2 batches of 4: the pad rows of the last batch are dropped
    assert files == [f"2017-01-02-{h:02d}.npy" for h in range(6)]
    for name in files:
        a = np.load(out / "sr" / name)
        assert a.shape == (32, 64, 1) and np.all(np.isfinite(a))
        assert 200.0 < a.min() and a.max() < 340.0  # plausible 2-m temperature, K
    summary = json.loads((out / "summary.json").read_text())
    assert summary["fields"] == 6 and summary["sampler"] == "ddim"
    assert summary["device"] == "cpu" and summary["fields_per_sec_steady"] > 0


def test_cuda_request_without_card_raises(env_root):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA path is driven by chip_smoke.py")
    from srewd_tpu_torch.sample import main

    with pytest.raises(RuntimeError, match="cuda"):
        main(["-c", str(env_root / "cfg.json"), "--date-range", "2017-01-02-00",
              "2017-01-02-01", "--device", "cuda"])


def test_sampler_settings_from_config():
    from srewd_tpu_torch.cli import sampler_kwargs

    def opt(d):
        return {"model": {"diffusion": d}}

    assert sampler_kwargs(opt({})) == {}
    assert sampler_kwargs(opt({"sampler": "ddim"})) == {
        "sampler": "ddim", "ddim_steps": 50, "ddim_eta": 1.0}
    assert sampler_kwargs(opt({"sampler": "ddim", "ddim_eta": 0.0, "ddim_steps": 25,
                               "clip_denoised": False})) == {
        "sampler": "ddim", "ddim_steps": 25, "ddim_eta": 0.0, "clip_denoised": False}


def _toy_data(cfg, root, batch_size):
    cfg["data"].update(
        dataroot=str(root / "data"), num_workers=2, batch_size=batch_size,
        val_batch_size=batch_size, train_min_date="2017-01-01-00",
        train_max_date="2017-01-02-00", val_min_date="2017-01-02-00",
        val_max_date="2017-01-03-00", months_subset=[1], transform_groups={"january": [1]})


@pytest.fixture
def single_thread_env():
    """One intra-op thread for a test of toy-size CLI runs: they gain nothing
    from more, and the suite's other workers keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield {**os.environ, "OMP_NUM_THREADS": "1"}
    torch.set_num_threads(n)


def test_pretrain_then_srdiff_train_then_ensemble_sample(env_root, single_thread_env):
    """The RRDB pretrained by `python -m srewd_tpu_torch.pretrain` conditions
    an srdiff trained by the port; `sample -m <checkpoint> --use-ema
    --sampler dpm --ensemble 2` writes the members' Kelvin mean to sr/ and
    their Kelvin std to sr_std/. Member 0 draws from the stream a single
    run draws from, so with two members std = |mean - member 0|."""
    from srewd_tpu_torch import pretrain, sample, train
    from srewd_tpu_torch.cli import Config, build_trainer
    from srewd_tpu_torch.configs.config import load_commented_json
    from srewd_tpu_torch.training.pretrainer import load_encoder_params

    cfgs = os.path.join(REPO, "configs", "experiment_configs")
    pre = load_commented_json(os.path.join(cfgs, "rrdb", "pretrained_rrdb_17block_base.json"))
    _toy_data(pre, env_root, 8)
    pre["model"].update(hidden_size=8, num_block=2)
    pre["train"]["epoch"] = 1
    pre["path"]["experiments_folder_path"] = str(env_root / "pre")
    (env_root / "pre.json").write_text(json.dumps(pre))
    records = pretrain.main(["-c", str(env_root / "pre.json"), "--device", "cpu"])
    assert len(records) == 1 and records[0]["steps"] == 3  # 24 train hours at batch 8
    assert np.isfinite(records[0]["train_loss"]) and np.isfinite(records[0]["val"]["RMSE"])
    ckpt = records[0]["checkpoint"]
    assert os.path.basename(ckpt) == "pretrain_rrdb_E0"
    # resumed with a second epoch: the optimizer and the counters come back
    pre["train"]["epoch"] = 2
    pre["path"]["resume_state"] = ckpt
    (env_root / "pre_resume.json").write_text(json.dumps(pre))
    (again,) = pretrain.main(["-c", str(env_root / "pre_resume.json"), "--device", "cpu"])
    assert again["epoch"] == 1 and again["steps"] == 3
    assert again["checkpoint"] == ckpt.replace("_E0", "_E1")
    assert torch.load(os.path.join(again["checkpoint"], "state.pt"))["iteration"] == 6

    cfg = load_commented_json(os.path.join(cfgs, "srdiff", "srdiff+rrdb_unlocked.json"))
    _toy_data(cfg, env_root, 2)
    cfg["model"]["unet"].update(inner_channel=16, norm_groups=8, channel_multiplier=[1, 2, 4],
                                attn_res=[8], res_blocks=1)
    cfg["model"]["diffusion"].update(image_height=32, image_width=64)
    cfg["model"]["pretrained_model"].update(model_path=ckpt, hidden_size=8, num_block=2)
    cfg["path"]["experiments_folder_path"] = str(env_root / "srdiff")
    cfg["train"].update(n_iter=2, print_freq=1, val_freq=100, save_checkpoint_freq=2)
    cfg["train"]["ema_scheduler"].update(enabled=True, step_start_ema=0, ema_decay=0.5)
    (env_root / "srdiff.json").write_text(json.dumps(cfg))

    opt = Config(str(env_root / "srdiff.json"), phase="train", experiment=False).get_opt()
    trainer = build_trainer(opt, torch.device("cpu"))  # the encoder comes from the pretrain
    for k, v in load_encoder_params(ckpt).items():
        torch.testing.assert_close(trainer.model.encoder.state_dict()[k], v, rtol=0, atol=0)
    result = train.main(["-c", str(env_root / "srdiff.json"), "--device", "cpu"])
    assert [s for s, _ in result["losses"]] == [1, 2]
    assert all(np.isfinite(v) for _, v in result["losses"])
    (run,) = [p for p in (env_root / "srdiff" / "experiments").iterdir()]
    model_ckpt = str(run / "checkpoint" / "I2_E1")

    common = ["-c", str(env_root / "srdiff.json"), "-m", model_ckpt, "--use-ema",
              "--sampler", "dpm", "--ddim-steps", "2", "--date-range", "2017-01-02-00",
              "2017-01-02-03", "--batch-size", "2", "--save-npy", "--device", "cpu"]
    out = env_root / "ens"
    r = subprocess.run([sys.executable, "-m", "srewd_tpu_torch.sample", *common,
                        "--ensemble", "2", "-o", str(out)],
                       capture_output=True, text=True, timeout=300, cwd=REPO,
                       env=single_thread_env)
    assert r.returncode == 0, r.stderr[-3000:]
    summary = json.loads((out / "summary.json").read_text())
    assert summary["ema"] and summary["ensemble"] == 2 and summary["sampler"] == "dpm"
    single = sample.main([*common, "-o", str(env_root / "single")])
    assert single["ema"] and single["fields"] == 3
    names = [f"2017-01-02-{h:02d}.npy" for h in range(3)]
    assert sorted(os.listdir(out / "sr")) == names == sorted(os.listdir(out / "sr_std"))
    for name in names:
        mean, std = np.load(out / "sr" / name), np.load(out / "sr_std" / name)
        member0 = np.load(env_root / "single" / "sr" / name)
        assert mean.shape == std.shape == (32, 64, 1)
        assert np.all(np.isfinite(mean)) and 200.0 < mean.min() and mean.max() < 340.0
        assert std.max() > 0  # the members differ
        np.testing.assert_allclose(std, np.abs(mean - member0), atol=1e-3)
