"""SamplerService over several replicas, on the CPU (`devices=["cpu",
"cpu"]`): each replica a whole copy of the weights behind the shared FIFO,
`seq` counter, stats and front end.

Toy sr3 (inner 8, 4 groups, mults (1, 2), attention at 8x16, one res
block) over 16x32 fields, T = 6 DDPM, seeded weights. Two replicas must
serve the fields of one, bit for bit, for the same request order and seed;
a hot swap lands between two `seq`s on both replicas; a failure on one
replica fails only its batch's requests; close() drains both. Where a test
needs each replica to take a batch, its enqueue waits at a barrier of two,
so the batches run in pairs, one on each replica.
"""

import json
import threading

import numpy as np
import pytest
import torch

from srewd_tpu_torch import bench_serve
from srewd_tpu_torch import serve as serve_cli
from srewd_tpu_torch.cli import random_init_, resolve_devices
from srewd_tpu_torch.diffusion.schedule import Schedule
from srewd_tpu_torch.models.factory import build_model
from srewd_tpu_torch.serving.service import SamplerService
from srewd_tpu_torch.utils.seeding import member_seed

from test_torch_port_model import one_torch_thread  # noqa: F401  (autouse)

H, W = 16, 32
LH, LW = H // 4, W // 4
CPU = torch.device("cpu")
TWO = [CPU, CPU]
SCHED = {"schedule": "linear", "n_timestep": 6, "linear_start": 1e-6, "linear_end": 1e-2}
SEED = 7


def _model(seed):
    model = build_model({
        "architecture": "sr3",
        "unet": {"in_channel": 2, "out_channel": 1, "inner_channel": 8, "norm_groups": 4,
                 "channel_multiplier": [1, 2], "attn_res": [8], "res_blocks": 1,
                 "dropout": 0.0},
        "diffusion": {"image_height": H, "image_width": W, "image_channels": 1,
                      "channels": 1, "conditional": True}})
    random_init_(model.unet, seed)
    return model


@pytest.fixture(scope="module")
def stack():
    model = _model(1)
    return model, model.params(), Schedule.from_config(SCHED)


def _lr(n, seed=0):
    return np.random.default_rng(seed).standard_normal((n, LH, LW, 1)).astype(np.float32)


def _direct(model, sched, lr, seq):
    g = torch.Generator().manual_seed(member_seed(SEED, seq))
    return model.generate_sr({"LR": torch.from_numpy(lr)}, sched, generator=g).numpy()


def _tap(svc, before=None):
    """Record (seq, replica index, packed LR) of every enqueued batch;
    `before(index, seq)` runs first (a barrier, an injected failure)."""
    log = []
    enqueue = svc._enqueue

    def tapped(rep, model, lr, seq):
        i = svc._replicas.index(rep)
        log.append((seq, i, lr.copy()))
        if before is not None:
            before(i, seq)
        return enqueue(rep, model, lr, seq)

    svc._enqueue = tapped
    return log


def _pairs():
    """A `before` that makes the batches run in pairs, one on each replica."""
    barrier = threading.Barrier(2, timeout=60)
    return lambda i, seq: barrier.wait()


def _serve(stack, devices, sizes, linger_ms):
    """The fields of requests of `sizes` submitted in order from one
    thread, each batch's (seq, replica, LR), and the stats."""
    with SamplerService(*stack, batch_size=4, devices=devices, seed=SEED,
                        linger_ms=linger_ms) as svc:
        log = _tap(svc)
        futs = [svc.submit(_lr(n, seed=10 + i), np.ones(n, np.int32))
                for i, n in enumerate(sizes)]
        out = [f.result(timeout=300) for f in futs]
        stats = svc.stats()
    return out, sorted(log, key=lambda b: b[0]), stats


@pytest.mark.parametrize("sizes, linger_ms", [((10,), 2.0), ((3, 5, 2, 6), 30_000.0)],
                         ids=["one_request", "in_order"])
def test_two_replicas_serve_the_fields_of_one(stack, sizes, linger_ms):
    """One request over three device batches (the last padded), and four
    requests that fill four (a linger longer than their submission: every
    batch is taken full, whatever the timing): the same fields bit for
    bit, each device batch with the same seq and LR; the stats summed over
    the replicas."""
    one, log1, stats1 = _serve(stack, [CPU], sizes, linger_ms)
    two, log2, stats2 = _serve(stack, TWO, sizes, linger_ms)
    for a, b in zip(one, two):
        np.testing.assert_array_equal(a, b)
    assert [s for s, _, _ in log1] == [s for s, _, _ in log2] == list(range(len(log1)))
    for (_, _, a), (_, _, b) in zip(log1, log2):
        np.testing.assert_array_equal(a, b)
    model, _, sched = stack
    for seq, _, lr in log2:  # and each batch is generate_sr of its packed batch
        rows = [i for i in range(4) if seq * 4 + i < sum(sizes)]
        flat = np.concatenate(two)[seq * 4 + np.array(rows)]
        np.testing.assert_array_equal(flat, _direct(model, sched, lr, seq)[rows])
    for stats, n in ((stats1, 1), (stats2, 2)):
        assert stats["requests"] == len(sizes) and stats["fields"] == sum(sizes)
        assert stats["device_batches"] == len(log1) == -(-sum(sizes) // 4)
        assert stats["padded_fields"] == 4 * len(log1) - sum(sizes)
        assert stats["replicas"] == ["cpu"] * n
        per = stats["device_batches_per_replica"]
        assert len(per) == n and sum(per) == stats["device_batches"]
        assert per == [sum(1 for _, r, _ in (log1 if n == 1 else log2) if r == i)
                       for i in range(n)]


def test_each_replica_counts_its_batches(stack):
    """Batches in pairs: each replica takes one of each pair, and stats say so."""
    with SamplerService(*stack, batch_size=4, devices=TWO, seed=SEED) as svc:
        log = _tap(svc, _pairs())
        sr = svc.super_resolve(_lr(16, seed=3), np.ones(16, np.int32))
        stats = svc.stats()
    assert sr.shape == (16, H, W, 1)
    assert stats["device_batches_per_replica"] == [2, 2] and stats["device_batches"] == 4
    assert sorted(r for _, r, _ in log) == [0, 0, 1, 1]


def test_hot_swap_lands_between_two_seqs_on_both_replicas(stack):
    """Two batches taken (one per replica) and held before they run; the
    swap; then they finish on the old weights, and the next two, one per
    replica, run on the new weights."""
    model, _, sched = stack
    new = _model(42)
    held, go = threading.Barrier(3, timeout=60), threading.Event()

    def hold(i, seq):
        if seq < 2:
            held.wait()
            go.wait(timeout=60)

    with SamplerService(*stack, batch_size=4, devices=TWO, seed=SEED) as svc:
        pairs = _pairs()
        log = _tap(svc, lambda i, seq: (hold(i, seq), pairs(i, seq)))
        old_lr, new_lr = _lr(8, seed=20), _lr(8, seed=21)
        fut = svc.submit(old_lr, np.ones(8, np.int32))
        held.wait()  # both replicas took a batch of the first request
        svc.update_params(new.params())
        go.set()
        before = fut.result(timeout=300)
        after = svc.super_resolve(new_lr, np.ones(8, np.int32))
    assert {r for s, r, _ in log if s < 2} == {r for s, r, _ in log if s >= 2} == {0, 1}
    for seq in (0, 1):
        np.testing.assert_array_equal(before[4 * seq:4 * seq + 4],
                                      _direct(model, sched, old_lr[4 * seq:4 * seq + 4], seq))
    for seq in (2, 3):
        k = seq - 2
        np.testing.assert_array_equal(after[4 * k:4 * k + 4],
                                      _direct(new, sched, new_lr[4 * k:4 * k + 4], seq))


def test_a_failure_on_one_replica_fails_only_its_requests(stack):
    """Replica 1's first batch raises: its request fails; the request of the
    batch replica 0 ran beside it resolves; the service keeps serving."""
    model, _, sched = stack
    pairs = _pairs()
    boom = {"armed": True}

    def before(i, seq):
        if seq < 2:
            pairs(i, seq)
        if i == 1 and boom.pop("armed", False):
            raise RuntimeError("replica 1 exploded")

    with SamplerService(*stack, batch_size=4, devices=TWO, seed=SEED) as svc:
        log = _tap(svc, before)
        lrs = [_lr(4, seed=30), _lr(4, seed=31)]
        futs = [svc.submit(lr, np.ones(4, np.int32)) for lr in lrs]
        errors = [f.exception(timeout=300) for f in futs]
        later = svc.super_resolve(_lr(4, seed=32), np.ones(4, np.int32))
        stats = svc.stats()
    replica = {s: r for s, r, _ in log}
    assert sorted(replica[s] for s in (0, 1)) == [0, 1]
    for seq, (lr, err) in enumerate(zip(lrs, errors)):
        if replica[seq] == 1:
            assert isinstance(err, RuntimeError) and "exploded" in str(err)
        else:
            assert err is None
            np.testing.assert_array_equal(futs[seq].result(), _direct(model, sched, lr, seq))
    np.testing.assert_array_equal(later, _direct(model, sched, _lr(4, seed=32), 2))
    assert stats["device_batches"] == 3


def test_close_drains_both_replicas(stack):
    svc = SamplerService(*stack, batch_size=4, devices=TWO, seed=SEED, linger_ms=0.0)
    log = _tap(svc, _pairs())
    futs = [svc.submit(_lr(4, seed=40 + i), np.ones(4, np.int32)) for i in range(6)]
    svc.close()
    assert not any(t.is_alive() for t in svc._threads)
    assert all(f.done() and f.exception() is None for f in futs)
    assert sorted(r for _, r, _ in log) == [0, 0, 0, 1, 1, 1]
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit(_lr(1), np.ones(1, np.int32))


def test_device_lists_parse(stack):
    """The serving entry points' --device: a comma-separated list, one
    replica each; a card named twice holds two; `cuda` (the default) is
    every visible card and raises without one."""
    assert resolve_devices("cpu") == [CPU]
    assert resolve_devices("cpu, cpu") == resolve_devices(["cpu", CPU]) == TWO
    assert serve_cli.parse_args(["-c", "x.json", "--device", "cuda:0,cuda:0"]).device == \
        "cuda:0,cuda:0"
    assert serve_cli.parse_args(["-c", "x.json"]).device == "cuda"
    with SamplerService(*stack, batch_size=2, devices="cpu,cpu") as svc:
        assert svc.stats()["replicas"] == ["cpu", "cpu"]
    if not torch.cuda.is_available():
        for spec in (None, "cuda", "cuda:0,cuda:1"):
            with pytest.raises(RuntimeError, match="cuda"):
                resolve_devices(spec)
        with pytest.raises(RuntimeError, match="cuda"):
            SamplerService(*stack)


def test_bench_serve_over_two_replicas(capsys):
    """bench_serve --device cpu,cpu at toy size: its line adds the replica
    count and their devices; the warm-up ran a batch on each replica (else
    it raises), and the timed batches' slots are its fields and padding."""
    out = bench_serve.main(["--device", "cpu,cpu", "--hr-shape", "32", "64",
                            "--inner-channel", "32", "--t", "10", "--steps", "2",
                            "--requests", "3", "--batch", "2"])
    assert json.loads(capsys.readouterr().out.strip()) == json.loads(json.dumps(out))
    assert out["replicas"] == 2 and out["devices"] == ["cpu", "cpu"]
    assert out["fields"] == 4 and out["value"] > 0 and out["device"] == "cpu"
    assert 2 * out["device_batches"] == 4 + out["padded_fields"]
