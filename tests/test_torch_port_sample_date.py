"""The port's date-targeted sampling (`python -m srewd_tpu_torch.sample -d`)
against the root sample.py and the JAX package, on the CPU.

`-d`'s DataHandler (months, the one transform group, the one-hour val
window, the train window defaulting to the date) against JAX's DataHandler
built with the overrides the root sample.py computes for `-d`, on the same
synthetic tree: the batch, its months, the scalers and both indexes equal.
Then `sample.main -d` at toy width: the file names JAX's `save_all_images`
gives the same Kelvin fields and `-i`, each SR / INF panel equal to
matplotlib's colormap of the returned field at 220-315 K, INF equal to JAX's
bicubic x4 of the batch's LR in Kelvin; the first validation batch without
`-d` ("val0") with an ensemble of 2; and `-d` with `--date-range` refused.
"""

import json
import os

import numpy as np
import pytest
from matplotlib.colors import Normalize

import jax.numpy as jnp
from srewd_tpu.cli import build_data_handler as jax_build_data_handler
from srewd_tpu.data.timeindex import format_date as jax_format_date
from srewd_tpu.data.timeindex import months_of as jax_months_of
from srewd_tpu.data.timeindex import parse_date as jax_parse_date
from srewd_tpu.ops.resize import bicubic_up4 as jax_bicubic_up4
from srewd_tpu.training.visualization import CMAPS as JAX_CMAPS
from srewd_tpu.training.visualization import ImageContainer as JaxImageContainer
from srewd_tpu_torch import sample
from srewd_tpu_torch.cli import build_data_handler
from srewd_tpu_torch.training.visualization import crop, read_plate

from test_torch_port_model import one_torch_thread, toy_model_cfg  # noqa: F401

DATE = "2017-02-01-05"


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    from srewd_tpu_torch.data.store import make_synthetic_weatherbench

    root = tmp_path_factory.mktemp("sample_date")
    make_synthetic_weatherbench(str(root / "data"), "2017-01-30-00", "2017-02-02-00",
                                lr_shape=(8, 16), hr_shape=(32, 64), spectrum="t2m")
    return root


def config(root, train_window=True) -> dict:
    model = toy_model_cfg("sr3")
    model["unet"]["dropout"] = 0.0
    model["beta_schedule"] = {"train": {"schedule": "linear", "n_timestep": 100,
                                        "linear_start": 1e-6, "linear_end": 1e-2}}
    model["diffusion"].update(sampler="ddim", ddim_steps=3)
    data = {"dataroot": str(root / "data"), "variables": ["t2m"], "num_workers": 2,
            "months_subset": [1, 2], "transform_groups": [[1, 2]],
            "transformation": "GlobalStandardScaling", "batch_size": 2, "val_batch_size": 2,
            "val_min_date": "2017-01-31-00", "val_max_date": "2017-01-31-06"}
    if train_window:
        data.update(train_min_date="2017-01-30-00", train_max_date="2017-02-01-12")
    return {"name": "sample_date", "phase": "val", "seed": 3, "model": model, "data": data,
            "path": {"experiments_folder_path": str(root)}}


def write(root, name, cfg) -> str:
    path = root / f"{name}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def root_sample_overrides(opt: dict, date: str) -> dict:
    """What the root sample.py passes to build_data_handler for `-d date`."""
    month = int(jax_months_of(np.array([jax_parse_date(date)]))[0])
    nxt = jax_parse_date(date) + np.timedelta64(1, "h")
    overrides = dict(months_subset=[month], groups=[[month]], val_min_date=date,
                     val_max_date=jax_format_date(nxt), val_batch_size=1)
    tm = opt["data"]
    overrides["train_min_date"] = tm.get("train_min_date") or date
    overrides["train_max_date"] = tm.get("train_max_date") or jax_format_date(nxt)
    return overrides


@pytest.mark.parametrize("train_window", [True, False])
def test_date_data_handler_matches_the_root_sample_py(tree, tmp_path, train_window):
    opt = config(tree, train_window)
    jax_dh = jax_build_data_handler(opt, storage_root=str(tmp_path / "jax"),
                                    **root_sample_overrides(opt, DATE))
    port_dh = build_data_handler(opt, storage_root=str(tmp_path / "port"),
                                 **sample.date_overrides(opt, DATE))
    assert port_dh.months_subset == jax_dh.months_subset == [2]
    assert port_dh.groups == jax_dh.groups == [[2]]
    for split in ("train_timestamps", "val_timestamps"):
        np.testing.assert_array_equal(getattr(port_dh, split), getattr(jax_dh, split))
    assert list(port_dh.val_timestamps) == [np.datetime64("2017-02-01T05", "h")]
    for t in ("lr", "hr"):
        a, b = port_dh.batch_scalers[t], jax_dh.batch_scalers[t]
        np.testing.assert_array_equal(a.mean, b.mean)
        np.testing.assert_array_equal(a.std, b.std)
    got, want = port_dh.get_data_by_date(DATE), jax_dh.get_data_by_date(DATE)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["months"].tolist() == [2]


TYPES = ["SR", "HR", "INTERPOLATED", "DELTA", "AE", "AE_INTER"]


def test_sample_date_renders_what_the_root_sample_py_renders(tree, tmp_path):
    cfg = write(tmp_path, "cfg", config(tree))
    out = sample.main(["-c", cfg, "-d", DATE, "-i", *TYPES, "-cm", "heat_vibrant",
                       "-o", str(tmp_path / "port"), "--device", "cpu"])
    kelvin = out["kelvin"]
    assert out["tag"] == DATE and out["ensemble"] == 1
    assert kelvin["SR"].shape == (1, 32, 64, 1) and np.isfinite(kelvin["SR"]).all()

    jax_c = JaxImageContainer(kelvin, n_images=1)
    jax_c.set_min_max(220, 315)
    want = jax_c.save_all_images(os.path.join(str(tmp_path / "jax"), DATE), image_types=TYPES,
                                 cmap="heat_vibrant")
    assert [os.path.basename(p) for p in out["saved"]] == [os.path.basename(p) for p in want]
    assert len(want) == 6
    norm = Normalize(220, 315)
    for name, key in (("SR", "SR"), ("INTERPOLATED", "INF")):
        pixels, layout = read_plate(os.path.join(str(tmp_path / "port"), f"{DATE}_{name}_0.png"))
        (box,) = layout["panels"]
        expect = JAX_CMAPS["heat_vibrant"](norm(kelvin[key][0, :, :, 0]), bytes=True)
        np.testing.assert_array_equal(crop(pixels, box)[::-1], expect)

    # INF: the batch's LR bicubic x4, in Kelvin with the HR scalers, as JAX computes it
    opt = config(tree)
    jax_dh = jax_build_data_handler(opt, storage_root=str(tmp_path / "jax_dh"),
                                    **root_sample_overrides(opt, DATE))
    batch = jax_dh.get_data_by_date(DATE)
    inf = jax_dh.inverse_transform(
        {"INF": np.asarray(jax_bicubic_up4(jnp.asarray(batch["LR"])))}, batch["months"])["INF"]
    np.testing.assert_allclose(kelvin["INF"], inf, rtol=0, atol=1e-4)
    hr = jax_dh.inverse_transform({"HR": batch["HR"]}, batch["months"])["HR"]
    np.testing.assert_allclose(kelvin["HR"], hr, rtol=0, atol=1e-4)


def test_sample_without_a_date_renders_the_first_val_batch(tree, tmp_path):
    cfg = write(tmp_path, "cfg", config(tree))
    out = sample.main(["-c", cfg, "-i", "SR", "AE", "-o", str(tmp_path), "--device", "cpu",
                       "--ensemble", "2", "--sampler", "dpm", "--ddim-steps", "2"])
    assert out["tag"] == "val0" and out["ensemble"] == 2
    assert [os.path.basename(p) for p in out["saved"]] == ["val0_SR_0.png", "val0_AE_0.png"]
    assert out["kelvin"]["SR"].shape == (2, 32, 64, 1)  # the val batch of 2
    assert np.isfinite(out["kelvin"]["SR"]).all()


def test_date_and_date_range_are_exclusive(tree, tmp_path):
    cfg = write(tmp_path, "cfg", config(tree))
    with pytest.raises(SystemExit):
        sample.parse_args(["-c", cfg, "-d", DATE, "--date-range", DATE, "2017-02-01-08"])
