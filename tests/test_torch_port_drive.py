"""The port's end-to-end drive and its visualisation and wandb hooks, on the
CPU (the port alone: no JAX computation).

`python -m srewd_tpu_torch.drive_e2e --device cpu` in this process (train,
`sample -d` plain / EMA / DDIM, export and load, `-p val`, SimpleCNN
pretraining with its plates, the RRDB -> srdiff handoff); `run_training`'s
cadence of wandb calls and `visualize_fn` (JAX's: the last and mean loss
every print_freq, a commit every step, the validation metrics and time, the
first validation batch in Kelvin with LR and the bicubic INF); the
pretrainer's `save_results` and its wandb calls; and
`make_synthetic_data`.
"""

import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from srewd_tpu_torch import drive_e2e, make_synthetic_data
from srewd_tpu_torch.training.visualization import read_plate
from srewd_tpu_torch.utils.wandb_logger import WandbLogger

from test_torch_port_model import one_torch_thread, toy_model_cfg  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_drive_e2e_on_cpu(tmp_path):
    out = drive_e2e.main(["--device", "cpu", "--workdir", str(tmp_path)])
    assert len(out["train_losses"]) == 16 and np.isfinite(out["train_losses"]).all()
    assert out["train_plates"] == 7 and out["val_plates"] == 1
    assert out["pretrain_plates"] == 2 and len(out["srdiff_losses"]) == 4
    for lo, hi in out["sample_kelvin"].values():
        assert 180 < lo < hi < 360


class _Recorder(types.ModuleType):
    def __init__(self):
        super().__init__("wandb")
        self.calls = []

    def init(self, **kw):
        pass

    def log(self, data, commit=None, step=None):
        self.calls.append((sorted(data), commit, step))

    def Image(self, x):  # noqa: N802 (wandb's name)
        return x


@pytest.fixture
def toy(tmp_path, monkeypatch):
    from srewd_tpu_torch.cli import Config, build_data_handler
    from srewd_tpu_torch.configs.config import load_commented_json
    from srewd_tpu_torch.data.store import make_synthetic_weatherbench

    fake = _Recorder()
    monkeypatch.setitem(sys.modules, "wandb", fake)
    make_synthetic_weatherbench(str(tmp_path / "data"), "2017-01-01-00", "2017-01-02-00",
                                lr_shape=(8, 16), hr_shape=(32, 64), spectrum="t2m")
    cfg = load_commented_json(os.path.join(
        REPO, "configs/experiment_configs/phydiff/resdiff+physics_train_example.json"))
    cfg["data"].update(dataroot=str(tmp_path / "data"), num_workers=2,
                       train_min_date="2017-01-01-00", train_max_date="2017-01-01-16",
                       val_min_date="2017-01-01-16", val_max_date="2017-01-02-00",
                       val_batch_size=4)
    cfg["model"]["unet"].update(toy_model_cfg("phydiff")["unet"])
    cfg["model"]["diffusion"].update(image_height=32, image_width=64, sampler="ddim",
                                     ddim_steps=2)
    cfg["path"]["experiments_folder_path"] = str(tmp_path)
    cfg["train"].update(n_iter=4, print_freq=2, val_freq=4, full_val_freq=1000,
                        save_checkpoint_freq=1000, save_visualizations=True)
    cfg["wandb"] = {"project": "p", "entity": "e"}
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    opt = Config(str(tmp_path / "cfg.json"), phase="train", experiment=False).get_opt()
    opt["path"].update(checkpoint=None, results=str(tmp_path / "results"))
    return opt, build_data_handler(opt), fake


def test_run_training_logs_and_renders_at_jaxs_cadence(toy):
    from srewd_tpu_torch.cli import build_trainer
    from srewd_tpu_torch.training.trainer import run_training

    opt, dh, fake = toy
    seen = []
    run_training(opt, dh, build_trainer(opt, torch.device("cpu")), None, WandbLogger(opt),
                 visualize_fn=lambda kelvin, epoch, step: seen.append((kelvin, epoch, step)))
    train = [(s, c) for keys, c, s in fake.calls if keys and keys[0].startswith("train")]
    assert train == [(2, False), (2, False), (4, False), (4, False)]
    assert ([k for k, _, s in fake.calls if s == 2 and k][:2]
            == [["train/l_pix"], ["train_mean/l_pix"]])
    val = [keys for keys, _, s in fake.calls if s == 4 and keys and keys[0].startswith("val")]
    assert val == [[f"val/{k}" for k in sorted(("MAE", "MR", "MSE", "PSNR", "RMSE", "SSIM"))],
                   ["val/val_time"]]
    commits = [s for keys, c, s in fake.calls if not keys and c]
    assert commits == [1, 2, 3, 4, 4]  # every step, and after the validation
    ((kelvin, epoch, step),) = seen
    assert step == 4 and epoch >= 1
    assert sorted(kelvin) == ["HR", "INF", "LR", "SR"]
    assert kelvin["INF"].shape == kelvin["SR"].shape == (4, 32, 64, 1)  # the val batch
    assert kelvin["LR"].shape == (4, 8, 16, 1)
    assert 200 < kelvin["HR"].mean() < 330  # Kelvin, not normalized units


def test_pretrainer_writes_result_plates_and_logs_each_epoch(toy, tmp_path):
    from srewd_tpu_torch.training.pretrainer import (
        EncoderTrainer, get_encoder_and_criterion, run_pretraining)

    opt, dh, fake = toy
    opt["train"]["epoch"] = 2
    module, criterion = get_encoder_and_criterion({"name": "SimpleSR", "in_channel": 1})
    trainer = EncoderTrainer(module, criterion, device=torch.device("cpu"))
    records = run_pretraining(opt, dh, trainer, None, WandbLogger(opt),
                              results_dir=opt["path"]["results"])
    assert len(records) == 2
    logged = [keys for keys, _, _ in fake.calls if keys]
    assert logged[:3] == [["epoch"], ["train/loss"],
                          [f"val/{k}" for k in sorted(("MAE", "MR", "MSE", "PSNR", "RMSE",
                                                       "SSIM"))]]
    plates = sorted(os.listdir(opt["path"]["results"]))
    assert plates == ["result_0.png", "result_1.png"]  # one per val batch
    pixels, layout = read_plate(os.path.join(opt["path"]["results"], "result_0.png"))
    assert [p["key"] for p in layout["panels"]] == ["INF", "SR", "HR"]
    assert trainer.save_results(dh, str(tmp_path / "one"), max_batches=1) == 1


def test_make_synthetic_data_writes_a_readable_tree(tmp_path):
    from srewd_tpu_torch.data.store import WeatherStore

    root = make_synthetic_data.main(["--root", str(tmp_path / "d"), "--min-date",
                                     "2017-01-01-00", "--max-date", "2017-01-01-05",
                                     "--lr", "4", "8", "--hr", "16", "32"])
    store = WeatherStore(os.path.join(root, "hr", "t2m"))
    assert len(store.timestamps) == 5 and store.read(store.timestamps[0]).shape == (16, 32, 1)
