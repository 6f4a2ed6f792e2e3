"""The port's device-resident data, its prefetcher and the trainer's profiler
window, on the CPU.

DeviceDataset (the split uploaded once, each batch gathered on the device)
must give DataHandler's batches bit for bit; DevicePrefetcher keeps the
order, raises the producer's error on the consumer's side and stops after a
partial consumption; `run_training` gives the same losses with
`train.device_data_cache` on and off (the prefetcher), and with
`train.profile_trace_dir` writes a torch.profiler trace holding the
trainer's `annotate` spans. A 32x64 synthetic t2m tree and the toy phydiff
UNet of tests/test_torch_port_model.py.
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from srewd_tpu_torch.cli import Config, build_data_handler, build_trainer
from srewd_tpu_torch.configs.config import load_commented_json
from srewd_tpu_torch.data.device_cache import DeviceDataset
from srewd_tpu_torch.data.pipeline import DataHandler
from srewd_tpu_torch.data.prefetch import DevicePrefetcher
from srewd_tpu_torch.data.store import make_synthetic_weatherbench
from srewd_tpu_torch.training.trainer import run_training
from srewd_tpu_torch.utils.profiling import StepTimer

from test_torch_port_model import (  # noqa: F401  (one_torch_thread: autouse)
    H, W, one_torch_thread, toy_model_cfg)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_CFG = os.path.join(REPO, "configs/experiment_configs/phydiff/resdiff+physics_train_example.json")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("device_data")
    make_synthetic_weatherbench(str(root / "data"), "2017-01-01-00", "2017-01-03-00",
                                lr_shape=(H // 4, W // 4), hr_shape=(H, W), spectrum="t2m")
    return root


def _handler(tree, **kw):
    return DataHandler(dataroot=str(tree / "data"), variables=["t2m"], months_subset=[1],
                       groups=[[1]], train_min_date="2017-01-01-00",
                       train_max_date="2017-01-02-00", val_min_date="2017-01-02-00",
                       val_max_date="2017-01-03-00", read_threads=2,
                       storage_root=str(tree / "scalers"), **kw).process_data()


def _equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("chunk", [256, 5])
def test_device_dataset_batches_equal_the_data_handlers(tree, chunk):
    """Two shuffled epochs, a resume inside an epoch (skip) and the val split;
    chunk 5 does not divide the split's fields, 256 holds them in one."""
    dh = _handler(tree, train_batch_size=4, val_batch_size=3)
    train = DeviceDataset(dh, "cpu", "train", chunk=chunk)
    assert len(train) == len(dh.train_timestamps) and len(train) % 5
    assert train.nbytes == len(train) * (H * W + (H // 4) * (W // 4)) * 4
    for epoch in (1, 2):
        got, want = list(train.batches(epoch)), list(dh.train_batches(epoch))
        assert len(got) == len(want) == dh.steps_per_epoch("train")
        for g, w in zip(got, want):
            _equal(g, w)
    for g, w in zip(train.batches(2, skip=3), dh.train_batches(2, skip=3), strict=True):
        _equal(g, w)
    val = DeviceDataset(dh, "cpu", "val", chunk=chunk)
    for g, w in zip(val.batches(), dh.val_batches(), strict=True):
        _equal(g, w)
    # shuffled: the two epochs differ
    assert not np.array_equal(next(train.batches(1))["HR"], next(train.batches(2))["HR"])


def test_prefetcher_keeps_order_and_puts_ahead():
    put_thread = set()

    def put(x):
        put_thread.add(threading.get_ident())
        return x * 10

    got = list(DevicePrefetcher(iter(range(7)), put, depth=2, take_fn=lambda x: x + 1))
    assert got == [x * 10 + 1 for x in range(7)]
    assert put_thread and threading.get_ident() not in put_thread


def test_prefetcher_raises_the_producers_error_on_the_consumers_side():
    def batches():
        yield 1
        yield 2
        raise ValueError("bad batch 3")

    pf = DevicePrefetcher(batches(), lambda x: x)
    seen = []
    with pytest.raises(ValueError, match="bad batch 3"):
        for x in pf:
            seen.append(x)
    assert seen == [1, 2]
    assert not pf._thread.is_alive()


def test_prefetcher_closes_after_a_partial_consumption():
    produced = []

    def batches():
        for i in range(1000):
            produced.append(i)
            yield i

    pf = DevicePrefetcher(batches(), lambda x: x, depth=2)
    it = iter(pf)
    assert [next(it), next(it)] == [0, 1]
    pf.close()
    pf._thread.join(timeout=5)
    assert not pf._thread.is_alive()
    assert len(produced) < 10  # bounded: at most depth batches ahead


def test_step_timer_ticks_and_device_batch_takes_device_tensors_as_they_are(tree, tmp_path):
    timer = StepTimer()
    timer.start()
    time.sleep(0.01)
    assert timer.tick(block=torch.zeros(1)) >= 0.01
    trainer = build_trainer(_opt(tree, tmp_path), torch.device("cpu"))
    hr, lr = torch.zeros(2, H, W, 1), torch.zeros(2, H // 4, W // 4, 1)
    b = trainer._device_batch({"HR": hr, "LR": lr})
    assert b["HR"] is hr and b["LR"] is lr


def _opt(tree, tmp_path, **train):
    cfg = load_commented_json(TRAIN_CFG)
    cfg["data"].update(dataroot=str(tree / "data"), num_workers=2, months_subset=[1],
                       transform_groups={"january": [1]}, train_min_date="2017-01-01-00",
                       train_max_date="2017-01-02-00", val_min_date="2017-01-02-00",
                       val_max_date="2017-01-03-00")
    cfg["model"]["unet"].update(toy_model_cfg("phydiff")["unet"])
    cfg["model"]["diffusion"].update(image_height=H, image_width=W)
    cfg["path"]["experiments_folder_path"] = str(tmp_path)
    cfg["train"].update(n_iter=3, print_freq=1, val_freq=1000, save_checkpoint_freq=1000,
                        full_val_freq=1000, **train)
    path = tmp_path / f"cfg_{len(os.listdir(tmp_path))}.json"
    path.write_text(json.dumps(cfg))
    opt = Config(str(path), phase="train", experiment=False).get_opt()
    opt["path"]["checkpoint"] = None
    return opt


def _run(tree, tmp_path, **train):
    opt = _opt(tree, tmp_path, **train)
    return run_training(opt, build_data_handler(opt), build_trainer(opt, torch.device("cpu")))


def test_run_training_same_losses_with_the_device_cache_and_the_prefetcher(tree, tmp_path):
    cached = _run(tree, tmp_path, device_data_cache=True)
    streamed = _run(tree, tmp_path)
    assert [s for s, _ in cached["losses"]] == [1, 2, 3]
    assert cached["losses"] == streamed["losses"]
    assert cached["trace"] is None


@pytest.mark.parametrize("start,steps", [(1, 1), (2, 5)])
def test_run_training_writes_a_trace_with_the_annotated_spans(tree, tmp_path, start, steps):
    """Steps [start, start + steps) are traced; (2, 5) runs past the 3 steps
    of training, so the window closes when training ends."""
    logdir = tmp_path / "trace"
    res = _run(tree, tmp_path, profile_trace_dir=str(logdir), profile_start=start,
               profile_steps=steps)
    assert res["trace"] is not None and os.path.dirname(res["trace"]) == str(logdir)
    with open(res["trace"]) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name") for e in events]
    n_steps = min(steps, 3 - start)
    for span in ("train_step", "loss", "backward", "optimizer"):
        assert names.count(span) == n_steps, span
    assert [s for s, _ in res["losses"]] == [1, 2, 3]
