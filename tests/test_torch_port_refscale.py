"""The port's reference-scale entry points on the CPU: `python -m
srewd_tpu_torch.run_reference_scale` against scripts/run_reference_scale.py
(the same config.json but for its paths), its training run and a relaunch
that resumes ("auto"), and `python -m srewd_tpu_torch.run_srdiff_pipeline`
(RRDB pretraining, then srdiff on the locked encoder) at toy width.

The entry points exec or start other processes, so they run as processes
here, on one intra-op thread each. The pipeline's RRDB has 2 blocks: the
UNet takes the RRDB's feature taps feats[2::3], and one block gives none.
"""

import glob
import json
import os
import subprocess
import sys

import pytest

from srewd_tpu_torch import run_reference_scale

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATES = ["--data-min", "2017-01-01-00", "--data-max", "2017-01-02-00",
         "--train-min", "2017-01-01-00", "--train-max", "2017-01-01-12",
         "--val-min", "2017-01-01-12", "--val-max", "2017-01-01-16"]
TOY = ["--hr-shape", "32", "64", "--inner-channel", "32", "--res-blocks", "1", *DATES]
ENV = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1", PYTHONPATH=REPO)
PATH_FIELDS = (("path", "experiments_folder_path"), ("data", "dataroot"))


def run(*args, timeout=240):
    return subprocess.run([sys.executable, *args], check=True, env=ENV, cwd=REPO,
                          capture_output=True, text=True, timeout=timeout)


def without_paths(cfg: dict, work) -> dict:
    cfg = json.loads(json.dumps(cfg))
    for section, key in PATH_FIELDS:
        assert cfg[section][key].startswith(str(work)), (section, key, cfg[section][key])
        cfg[section][key] = None
    return cfg


@pytest.mark.parametrize("extra", [
    [],
    ["--arch", "srdiff", "--pretrained-model", "/x/pretrain_rrdb_E3",
     "--pretrained-num-block", "2", "--pretrained-hidden-size", "32", "--grad-clip", "1.0",
     "--no-device-cache", "--iters", "30000", "--ema-decay", "0.999"],
])
def test_config_matches_jax_script(tmp_path, extra):
    run(os.path.join(REPO, "scripts", "run_reference_scale.py"), "--workdir",
        str(tmp_path / "jax"), "--config-only", *TOY, *extra)
    run_reference_scale.main(["--workdir", str(tmp_path / "port"), "--config-only", *TOY,
                              *extra])
    want = json.loads((tmp_path / "jax" / "config.json").read_text())
    got = json.loads((tmp_path / "port" / "config.json").read_text())
    assert without_paths(got, tmp_path / "port") == without_paths(want, tmp_path / "jax")
    assert got["path"]["resume_state"] == "auto" and got["train"]["save_visualizations"]
    assert (tmp_path / "port" / "data" / ".complete").exists()


def _checkpoints(work, name):
    return sorted(glob.glob(os.path.join(work, "experiments", "experiments", f"{name}_*",
                                         "checkpoint", "I*_E*")))


def test_training_run_and_relaunch_resume(tmp_path):
    args = ["-m", "srewd_tpu_torch.run_reference_scale", "--workdir", str(tmp_path),
            "--device", "cpu", *TOY, "--batch", "2", "--val-batch", "2", "--val-freq", "1000",
            "--save-freq", "2", "--print-freq", "1"]
    first = run(*args, "--iters", "2")
    assert "[data] generating" in first.stdout
    assert [os.path.basename(p) for p in _checkpoints(tmp_path, "phydiff_refscale_0k")] \
        == ["I2_E1"]
    again = run(*args, "--iters", "4")
    assert "[data] reusing" in again.stdout
    ckpts = _checkpoints(tmp_path, "phydiff_refscale_0k")
    assert [os.path.basename(p) for p in ckpts] == ["I2_E1", "I4_E1"]
    assert len({os.path.dirname(p) for p in ckpts}) == 1  # resumed into the same run
    log = open(os.path.join(os.path.dirname(os.path.dirname(ckpts[0])), "logs",
                            "train.log")).read()  # the relaunch's: it starts at step 3
    assert "Iteration:        3 " in log and "Iteration:        1 " not in log
    assert "renders no PNG" in log


def test_srdiff_pipeline(tmp_path):
    out = run("-m", "srewd_tpu_torch.run_srdiff_pipeline", "--workdir", str(tmp_path),
              "--device", "cpu", "--hr-shape", "32", "64", *DATES, "--num-block", "2",
              "--pretrain-epochs", "2", "--pretrain-batch", "4", "--iters", "2", "--batch", "2",
              "--val-freq", "1000", "--inner-channel", "32", "--res-blocks", "1")
    encoders = sorted(glob.glob(str(tmp_path / "pretrain" / "**" / "checkpoint" /
                                    "pretrain_*"), recursive=True))
    assert [os.path.basename(p) for p in encoders] == ["pretrain_rrdb_E0", "pretrain_rrdb_E1"]
    named = (tmp_path / "encoder_checkpoint.txt").read_text().strip()
    assert named == encoders[-1] and f"encoder checkpoint: {named}" in out.stdout
    cfg = json.loads((tmp_path / "diffusion" / "config.json").read_text())
    assert cfg["model"]["architecture"] == "srdiff"
    assert cfg["model"]["pretrained_model"] == {"model_path": named, "lock_weights": True,
                                                "num_block": 2}
    assert os.path.realpath(tmp_path / "diffusion" / "data") == str(tmp_path / "data")
    assert [os.path.basename(p) for p in _checkpoints(tmp_path / "diffusion",
                                                      "srdiff_refscale_0k")] == ["I2_E1"]
