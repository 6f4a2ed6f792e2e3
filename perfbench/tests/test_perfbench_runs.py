"""Whole runs of each cell's driver on the CPU at a toy size: the port
against the plain reference, the controls, the faults a run must catch,
and the result line.

These skip the harness's look for a card and call the drivers as
`run.py` does, with the cell's own configuration cut to a toy size
(`tiny.py`). The port runs its kernels' plain versions on the CPU.
"""

import json
import math

import numpy as np
import pytest
import torch

from perfbench import report
from perfbench.drivers import serve as serve_driver
from perfbench.tests.tiny import tiny_cell

CPU = torch.device("cpu")
SEED = 2 ** 31 + 977


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(name, **kw):
    c = tiny_cell(name, **kw.pop("traffic", {}))
    return c, c.driver.run(c, seed=SEED, seconds=kw.pop("seconds", 0.5), trace=False,
                           device=CPU, **kw)


def _worst(out):
    return {n: v for n, v, _ in out.checks}


@pytest.mark.parametrize("name", ["phydiff-sample-f32", "srdiff-train-f32", "srdiff-train-bf16",
                                  "phydiff-serve-bf16"])
def test_the_port_agrees_with_the_reference(name):
    traffic = {"device_batch": 4, "rate_fields_per_s": 8.0} if "serve" in name else {}
    c, out = _run(name, traffic=traffic, seconds=1.5 if "serve" in name else 0.5)
    assert out.attempted > 0 and out.failed == 0
    gaps = _worst(out)
    assert all(math.isfinite(v) for v in gaps.values()), gaps
    if name.endswith("f32"):  # float32 on both sides: within the cell's limits
        assert report.correct(out), out.checks
        assert max(gaps.values()) < 1e-4, gaps
    # bf16 at a toy size on the CPU is held against its control below


@pytest.mark.parametrize("name,mode", [("phydiff-sample-f32", "tf32"),
                                       ("srdiff-train-f32", "tf32"),
                                       ("srdiff-train-bf16", "fp8"),
                                       ("phydiff-serve-bf16", "fp8")])
def test_the_control_reads_far_above_the_program(name, mode):
    """The reference one precision lower, in the program's place, reads at
    least three times what the program reads on the same inputs."""
    traffic = {"device_batch": 4, "rate_fields_per_s": 8.0} if "serve" in name else {}
    c, out = _run(name, traffic=traffic, seconds=1.5 if "serve" in name else 0.5)
    low = c.driver.control(c, seed=SEED, device=CPU, mode=mode)
    prog = _worst(out)
    assert any(low[k] >= 3.0 * prog[k] for k in prog), (low, prog)


def _state_unchanged(kind, coef, i, x, *a, **k):
    """chain_step that returns its state: (x, x0 = x)."""
    return x, x


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_sampling_faults_are_caught(fault, monkeypatch):
    from srewd_tpu_torch.diffusion import gaussian

    program = None
    if fault == "unchanged":
        monkeypatch.setattr(gaussian, "chain_step", _state_unchanged)
    elif fault == "half_batch":
        def program(m, x, init, s, kw):
            h = x.shape[0] // 2
            out = m.generate_sr({"LR": x[:h]}, s, init=init[:h], **kw)
            return torch.cat([out, out])
    else:
        def program(m, x, init, s, kw):
            out = m.generate_sr({"LR": x}, s, init=init, **kw).clone()
            out[0, 3, 5, 0] += 0.05
            return out
    _, out = _run("phydiff-sample-f32", program=program)
    assert not report.correct(out), out.checks


@pytest.mark.parametrize("name", ["srdiff-train-f32", "srdiff-train-bf16"])
@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_training_faults_are_caught(name, fault):
    """The fault fails the cell's limits, and moves some number at least
    threefold over the same run without it (a toy bf16 run on the CPU can
    read above the limits set at the cell's size on the chip)."""
    def plant(trainer):
        if fault == "unchanged":
            trainer.optimizer.step = lambda *a, **k: None
        else:
            loss = trainer._loss.forward

            def half(batch, generator):
                h = batch["HR"].shape[0] // 2
                return loss({k: v[:h] for k, v in batch.items()}, generator)

            trainer._loss.forward = half
    _, sound = _run(name)
    _, out = _run(name, plant=plant)
    assert not report.correct(out), out.checks
    before, after = _worst(sound), _worst(out)
    assert any(after[k] >= 3.0 * before[k] for k in after), (before, after)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_serving_faults_are_caught(fault, monkeypatch):
    from srewd_tpu_torch.diffusion import gaussian

    if fault == "unchanged":
        monkeypatch.setattr(gaussian, "chain_step", _state_unchanged)

    def alter(sr):
        sr = np.array(sr)
        if fault == "unchanged":
            pass
        elif fault == "altered":  # the batch's first field shifted by a pixel
            sr[0] = np.roll(sr[0], 1, axis=1)
        else:
            sr[len(sr) // 2:] = sr[:len(sr) - len(sr) // 2][:len(sr) // 2]
        return sr
    _, out = _run("phydiff-serve-bf16", traffic={"device_batch": 4, "rate_fields_per_s": 8.0},
                  seconds=1.5, alter=alter)
    assert not report.correct(out), out.checks


def test_the_schedule_repeats_from_a_seed_and_keeps_the_work():
    c = tiny_cell("phydiff-serve-bf16")
    a = serve_driver.schedule(c.traffic, 5, 30.0, 20.0)
    b = serve_driver.schedule(c.traffic, 5, 30.0, 20.0)
    other = serve_driver.schedule(c.traffic, 6, 30.0, 20.0)
    for k in a:
        assert np.array_equal(a[k], b[k])
    assert not np.array_equal(a["due"], other["due"])
    assert sorted(a["size"]) == sorted(other["size"])  # the same work in another order
    assert np.allclose(np.sort(np.diff(a["due"])), np.sort(np.diff(other["due"])), atol=0.2)
    assert a["due"][0] == 0.0 and a["due"][-1] < 30.0


def test_a_late_request_is_timed_from_when_it_was_due(monkeypatch):
    """A submitter held up by 0.3 s: every request's latency counts the hold."""
    import time as _time

    from srewd_tpu_torch.serving import service

    real = service.SamplerService.submit
    state = {"n": 0}

    def slow(self, lr, months):
        state["n"] += 1
        if state["n"] == serve_driver.WARM_BATCHES + 1:  # the first request after the warm-up
            _time.sleep(0.3)
        return real(self, lr, months)

    monkeypatch.setattr(service.SamplerService, "submit", slow)
    _, out = _run("phydiff-serve-bf16", traffic={"device_batch": 4, "rate_fields_per_s": 8.0},
                  seconds=1.5)
    assert out.extra["late_p95_ms"] >= 250.0 or out.extra["requests"] < 20
    assert out.metrics["serve_p95_ms"] >= 300.0


def test_the_result_line_has_the_contract_keys():
    c, out = _run("phydiff-sample-f32")
    dev = {"platform": "gpu", "kind": "x", "count": 1, "memory_peak_bytes": 0}
    monkey = report.torch.cuda.get_device_name
    try:
        report.torch.cuda.get_device_name = lambda d: "x"
        line = report.result(c, out, setup_s=1.0, trace=False, device=CPU)
    finally:
        report.torch.cuda.get_device_name = monkey
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["device"] == dev
    assert set(line["metrics"]) == {"sample_fields_per_s", "setup_s"}
    assert all(set(v) == {"value", "unit"} for v in line["metrics"].values())
    assert all(set(v) == {"value", "limit"} for v in line["checks"].values())
    assert json.loads(json.dumps(line)) == line
    assert all(math.isfinite(v["value"]) for v in line["metrics"].values())
