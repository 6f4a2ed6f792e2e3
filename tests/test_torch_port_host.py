"""The port's own copies of the host modules against the JAX package's, and
the guard that the port imports nothing of the JAX package.

The copies (configs, data, native, utils.{seeding,logging}) must give the
same arrays as the originals: the same synthetic tree, the same config and
the same seed give the same batches, scalers and timestamps.
"""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from srewd_tpu.configs.config import load_commented_json as jax_load_commented_json
from srewd_tpu.data import timeindex as jax_timeindex
from srewd_tpu.data.pipeline import DataHandler as JaxDataHandler
from srewd_tpu.data.store import make_synthetic_weatherbench as jax_make_synthetic
from srewd_tpu_torch import native
from srewd_tpu_torch.configs.config import Config, load_commented_json
from srewd_tpu_torch.data import timeindex
from srewd_tpu_torch.data.pipeline import DataHandler
from srewd_tpu_torch.data.store import WeatherStore, make_synthetic_weatherbench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "srewd_tpu_torch")
TRAIN_CFG = os.path.join(REPO, "configs/experiment_configs/phydiff/resdiff+physics_train_example.json")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("host_tree")
    jax_make_synthetic(str(root / "data"), "2017-01-01-00", "2017-01-03-00",
                       lr_shape=(8, 16), hr_shape=(32, 64), spectrum="t2m", constants=("orog",))
    return root


def _handler_kwargs(root, storage):
    return dict(dataroot=str(root / "data"), variables=["t2m", "orog"], months_subset=[1],
                groups=[[1]], train_min_date="2017-01-01-00", train_max_date="2017-01-02-00",
                val_min_date="2017-01-02-00", val_max_date="2017-01-03-00",
                train_batch_size=4, val_batch_size=5, read_threads=2, delays=[1],
                storage_root=str(root / storage))


@pytest.mark.parametrize("spectrum", ["t2m", "tiles"])
def test_synthetic_tree_matches(tmp_path, spectrum):
    kw = dict(min_date="2017-01-01-00", max_date="2017-01-01-06", lr_shape=(8, 16),
              hr_shape=(32, 64), spectrum=spectrum, seed=3)
    jax_make_synthetic(str(tmp_path / "jax"), **kw)
    make_synthetic_weatherbench(str(tmp_path / "port"), **kw)
    for dirpath, _, files in os.walk(tmp_path / "jax"):
        rel = os.path.relpath(dirpath, tmp_path / "jax")
        for f in files:
            a, b = os.path.join(dirpath, f), os.path.join(tmp_path / "port", rel, f)
            if f.endswith(".npy"):
                np.testing.assert_array_equal(np.load(a), np.load(b), err_msg=f)
            else:
                with open(a) as fa, open(b) as fb:
                    assert fa.read() == fb.read(), f


@pytest.mark.parametrize("transformation", ["GlobalStandardScaling", "LocalStandardScaling"])
def test_data_handler_batches_match(tree, transformation):
    """Same tree, same settings, same seed: identical batches, scalers and
    Kelvin inverse. Each side fits its own scalers (separate caches)."""
    jdh = JaxDataHandler(**_handler_kwargs(tree, f"jax_{transformation}"),
                         transformation=transformation)
    pdh = DataHandler(**_handler_kwargs(tree, f"port_{transformation}"),
                      transformation=transformation)
    if transformation == "LocalStandardScaling":  # not defined for a constant field
        jdh.variables = pdh.variables = ["t2m"]
        del jdh.stores["orog"], pdh.stores["orog"]
    jdh.process_data()
    pdh.process_data()
    np.testing.assert_array_equal(jdh.train_timestamps, pdh.train_timestamps)
    np.testing.assert_array_equal(jdh.val_timestamps, pdh.val_timestamps)
    for t in ("lr", "hr"):
        np.testing.assert_array_equal(jdh.batch_scalers[t].mean, pdh.batch_scalers[t].mean)
        np.testing.assert_array_equal(jdh.batch_scalers[t].std, pdh.batch_scalers[t].std)
    assert jdh.steps_per_epoch() == pdh.steps_per_epoch() > 0
    for epoch in (1, 2):
        for jb, pb in zip(jdh.train_batches(epoch), pdh.train_batches(epoch), strict=True):
            for k in ("HR", "LR", "months"):
                np.testing.assert_array_equal(jb[k], pb[k], err_msg=k)
    for jb, pb in zip(jdh.val_batches(), pdh.val_batches(), strict=True):
        np.testing.assert_array_equal(jb["HR"], pb["HR"])
        nv = len(pdh.variables)  # the channels of offset 0 (delays concat more)
        inv_j = jdh.inverse_transform({k: jb[k][..., :nv] for k in ("HR", "LR")}, jb["months"])
        inv_p = pdh.inverse_transform({k: pb[k][..., :nv] for k in ("HR", "LR")}, pb["months"])
        for k in ("HR", "LR"):
            np.testing.assert_array_equal(np.asarray(inv_j[k]), inv_p[k])


def test_train_batches_skip_resumes_inside_an_epoch(tree):
    pdh = DataHandler(**_handler_kwargs(tree, "port_skip")).process_data()
    full = list(pdh.train_batches(epoch=3))
    tail = list(pdh.train_batches(epoch=3, skip=2))
    assert len(tail) == len(full) - 2
    for a, b in zip(full[2:], tail):
        np.testing.assert_array_equal(a["HR"], b["HR"])


def test_timeindex_matches():
    spans = [("2016-12-31-20", "2017-01-01-04"), ("2017-03-01-00", "2017-03-01-05")]
    for name in ("union_hourly_ranges",):
        np.testing.assert_array_equal(getattr(jax_timeindex, name)(spans),
                                      getattr(timeindex, name)(spans))
    ts = timeindex.union_hourly_ranges(spans)
    np.testing.assert_array_equal(jax_timeindex.months_of(ts), timeindex.months_of(ts))
    np.testing.assert_array_equal(jax_timeindex.select_months(ts, [1, 3]),
                                  timeindex.select_months(ts, [1, 3]))
    assert timeindex.format_date(ts[0]) == jax_timeindex.format_date(ts[0]) == "2016-12-31-20"
    assert timeindex.month_to_group([[12, 1], [3]]) == jax_timeindex.month_to_group([[12, 1], [3]])
    with pytest.raises(ValueError, match="not covered"):
        timeindex.validate_groups([1, 2], [[1]])


def test_config_copy_matches(tmp_path):
    assert load_commented_json(TRAIN_CFG) == jax_load_commented_json(TRAIN_CFG)
    cfg = load_commented_json(TRAIN_CFG)
    cfg["path"]["experiments_folder_path"] = str(tmp_path)
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    opt = Config(str(path), phase="train").get_opt()
    root = opt["path"]["experiments_root"]
    assert os.path.basename(root).startswith(cfg["name"] + "_")
    for sub in ("log", "results", "checkpoint", "tb_logger"):
        assert os.path.isdir(opt["path"][sub]) and opt["path"][sub].startswith(root)
    assert opt["data"]["transform_groups"] == [[1]]
    # resume_state "auto": the newest I{iter}_E{epoch} of this experiment name
    os.makedirs(os.path.join(opt["path"]["checkpoint"], "I7_E2"))
    os.makedirs(os.path.join(opt["path"]["checkpoint"], "I12_E3"))
    cfg["path"]["resume_state"] = "auto"
    path.write_text(json.dumps(cfg))
    again = Config(str(path), phase="train").get_opt()
    assert again["path"]["resume_state"].endswith("I12_E3")
    assert again["path"]["experiments_root"] == root


def test_native_reader_builds_outside_the_package(tree):
    store = WeatherStore(str(tree / "data" / "hr" / "t2m"))
    ts = store.timestamps[:5]
    paths = [store._sample_path(t) for t in ts]
    got = native.read_batch(paths, (32, 64), threads=2)
    if native.get_lib() is None:
        pytest.skip("no C++ compiler here: the reader falls back to numpy")
    np.testing.assert_array_equal(got, np.stack([np.load(p) for p in paths]))
    lib_path = native._lib_path()
    assert os.path.exists(lib_path)
    assert os.path.dirname(lib_path) == os.path.join(REPO, "build", "srewd_tpu_torch")
    assert not [f for f in os.listdir(os.path.join(PORT, "native")) if f.endswith(".so")]


def _port_sources():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PORT):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return files


def test_no_module_of_the_port_imports_jax_or_srewd_tpu():
    """AST scan of every .py of the port and of chip_smoke.py."""
    bad = []
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "flax", "optax", "orbax", "srewd_tpu"):
                    bad.append(f"{os.path.relpath(path, REPO)}:{node.lineno} {name}")
    assert not bad, bad


def test_import_scan_covers_the_modules_of_every_architecture():
    """The scans above walk the whole package; the modules of the encoders,
    the spliter, the losses and the pretraining entry point are among them."""
    scanned = {os.path.relpath(p, PORT) for p in _port_sources() if p.startswith(PORT)}
    for rel in ("models/fd_info_spliter.py", "models/simple_cnn.py", "models/rrdb.py",
                "ops/losses.py", "training/pretrainer.py", "pretrain.py"):
        assert rel.replace("/", os.sep) in scanned, rel


def test_importing_the_whole_port_loads_no_jax_package_module():
    mods = sorted(
        os.path.relpath(p, REPO)[:-3].replace(os.sep, ".").removesuffix(".__init__")
        for p in _port_sources() if p.startswith(PORT))
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods) +
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'srewd_tpu')]\nprint(len(bad), bad)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO,
                       timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "0 []", r.stdout
    assert len(mods) > 20
