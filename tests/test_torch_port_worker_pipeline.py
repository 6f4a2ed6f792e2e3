"""The worker-process input pipeline (data/worker_pipeline.py, the twin of
the JAX package's grain_batches) on the CPU.

  * the val split's batches from `worker_batches` equal the JAX
    DataHandler's own batches over the same synthetic tree, bit for bit;
  * two worker processes give the in-process batches bit for bit, and the
    train order is a permutation seeded by the epoch (epochs 0 and 1 differ,
    each covers the epoch's drop_last prefix);
  * two ranks' shards of a handler that did not stride are disjoint
    contiguous blocks with the remainder dropped; a strided handler is not
    sharded again.

Workers start by `spawn` (no fork of this process, which has imported JAX);
they import the port's data modules only.
"""

import numpy as np
import pytest

from srewd_tpu.data.pipeline import DataHandler as JaxDataHandler
from srewd_tpu_torch.data import worker_pipeline
from srewd_tpu_torch.data.pipeline import DataHandler
from srewd_tpu_torch.data.store import make_synthetic_weatherbench
from srewd_tpu_torch.data.worker_pipeline import sample_order, worker_batches


@pytest.fixture(scope="module")
def handler_kw(tmp_path_factory):
    root = tmp_path_factory.mktemp("worker_pipeline")
    make_synthetic_weatherbench(str(root), "2017-01-01-00", "2017-01-04-00",
                                lr_shape=(8, 16), hr_shape=(32, 64), spectrum="t2m")
    return dict(dataroot=str(root), variables=["t2m"], train_min_date="2017-01-01-00",
                train_max_date="2017-01-03-01", val_min_date="2017-01-03-01",
                val_max_date="2017-01-04-00", train_batch_size=4, val_batch_size=4)


@pytest.fixture(scope="module")
def handler(handler_kw):
    return DataHandler(**handler_kw, shuffle=True).process_data()


def _equal(a: list, b: list):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert set(x) == {"HR", "LR", "months"} == set(y)
        for k in x:
            assert x[k].dtype == y[k].dtype and x[k].shape == y[k].shape
            np.testing.assert_array_equal(x[k], y[k])


def test_val_batches_equal_jax_datahandler(handler, handler_kw):
    jdh = JaxDataHandler(**handler_kw, shuffle=False).process_data()
    _equal(list(worker_batches(handler, split="val")), list(jdh.val_batches()))


def test_workers_equal_in_process(handler):
    in_process = list(worker_batches(handler, split="train", epoch=1))
    assert len(in_process) == len(handler.train_timestamps) // handler.train_batch_size
    _equal(list(worker_batches(handler, split="train", epoch=1, worker_count=2)), in_process)


def test_train_order_is_a_permutation_seeded_by_epoch(handler):
    e0 = [b["HR"] for b in worker_batches(handler, epoch=0)]
    e1 = [b["HR"] for b in worker_batches(handler, epoch=1)]
    assert not np.array_equal(e0[0], e1[0])
    n = len(handler.train_timestamps)
    orders = [sample_order(n, True, handler.seed + 7919 * e, True) for e in (0, 1)]
    assert orders[0] != orders[1] and sorted(orders[0]) == list(range(n))
    assert sample_order(n, False, 0, True) == list(range(n))


def test_rank_shards_are_disjoint_and_drop_the_remainder(handler, monkeypatch):
    n = len(handler.train_timestamps)
    assert n % 2  # 49 hours: a remainder to drop
    monkeypatch.setattr(worker_pipeline, "world_size", lambda: 2)
    shards = []
    for r in range(2):
        monkeypatch.setattr(worker_pipeline, "rank", lambda r=r: r)
        shards.append(sample_order(n, True, 3, True))
        assert sorted(shards[-1]) == list(range(r * (n // 2), (r + 1) * (n // 2)))
        months = [b["months"] for b in worker_batches(handler, epoch=0)]
        assert len(months) == (n // 2) // handler.train_batch_size
    assert not set(shards[0]) & set(shards[1])
    assert len(shards[0]) + len(shards[1]) == n - 1
    # a handler that strided its index already is not sharded again
    assert sample_order(n, False, 0, shard=False) == list(range(n))
