"""The port's bench twins on the CPU, at toy width: `bench` and
`bench_train` print one JSON line on the contracts of the root bench.py and
scripts/bench_train.py, a fault propagates without a retry, and the FLOP
count behind bench_train's MFU equals a hand count of the step's
convolutions, matrix products and attention products.

The numbers themselves are the CPU's and mean nothing for the card; the
card's come from chip_smoke.py phase 12 and the twins run there (PERF.md).
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from srewd_tpu_torch import bench, bench_all, bench_train
from srewd_tpu_torch.diffusion.schedule import Schedule
from srewd_tpu_torch.models import blocks, layers
from srewd_tpu_torch.models.factory import build_model
from srewd_tpu_torch.utils.profiling import PEAK_FLOPS

from test_torch_port_model import (  # noqa: F401  (one_torch_thread: autouse)
    H, W, one_torch_thread, toy_model_cfg)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def toy(arch="sr3"):
    cfg = toy_model_cfg(arch)
    cfg["unet"]["dropout"] = 0.0
    return cfg


def _one_json_line(capsys) -> dict:
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1, lines
    return json.loads(lines[0])


@pytest.mark.parametrize("sampler", ["ddpm", "ddim"])
def test_bench_prints_one_json_line_on_the_contract(capsys, sampler):
    out = bench.run(toy(), CPU, batch=2, n_t=6, dtype="bf16", repeats=2, sampler=sampler,
                    ddim_steps=3)
    line = _one_json_line(capsys)
    assert line == json.loads(json.dumps(out))
    assert {"metric", "value", "unit", "vs_baseline"} <= set(line)
    assert line["unit"] == "fields/sec/chip" and line["device"] == "cpu"
    tag = "6-step DDPM" if sampler == "ddpm" else "3-step DDIM(T=6)"
    assert line["metric"] == f"t2m SR fields/sec/chip ({tag}, {H}x{W}, sr3)"
    assert line["value"] == pytest.approx(2 / line["chain_sec"])
    with open(os.path.join(REPO, "BASELINE_MEASURED.json")) as f:
        ref = json.load(f)["reference_fields_per_sec_T1000"]
    assert line["vs_baseline"] == pytest.approx(line["value"] / (ref * 1000 / 6))


def test_bench_train_prints_the_contract_with_mfu(capsys):
    out = bench_train.run(toy("phydiff"), CPU, batch=2, dtype="bf16", steps=2)
    line = _one_json_line(capsys)
    assert line == json.loads(json.dumps(out))
    for key in ("metric", "value", "unit", "samples_per_sec", "vs_baseline",
                "model_tflops_per_sec", "mfu", "flops_source"):
        assert key in line, key
    assert line["value"] == pytest.approx(1 / line["step_sec"])
    assert line["samples_per_sec"] == pytest.approx(2 * line["value"])
    assert line["step_flops"] == bench_train.step_flops(toy("phydiff"), 2, "bf16") > 0
    assert line["mfu"] == pytest.approx(
        line["step_flops"] / line["step_sec"] / PEAK_FLOPS[torch.bfloat16])
    assert "FlopCounterMode" in line["flops_source"] and "elementwise" in line["flops_source"]


@pytest.mark.parametrize("module", ["bench", "bench_train"])
def test_bench_entry_points_need_the_card_and_do_not_retry(module):
    """Without a card the entry point fails once: no result line, no retry."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py phase 12 drives the bench twins")
    r = subprocess.run([sys.executable, "-m", f"srewd_tpu_torch.{module}"], capture_output=True,
                       text=True, timeout=120, cwd=REPO)
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "torch.cuda.is_available() is False" in r.stderr
    assert "retry" not in r.stderr.lower() and r.stderr.count("Traceback") == 1


def test_a_fault_in_the_measurement_propagates_once(monkeypatch):
    calls = []

    def fault(*args, **kwargs):
        calls.append(1)
        raise RuntimeError("kernel fault")

    monkeypatch.setattr("srewd_tpu_torch.cli.resolve_device", lambda name: CPU)
    for mod in (bench, bench_train):
        monkeypatch.setattr(mod, "run", fault)
        with pytest.raises(RuntimeError, match="kernel fault"):
            mod.main()
    assert len(calls) == 2


def test_bench_all_covers_the_jax_sweep_and_writes_under_build(tmp_path, monkeypatch):
    assert [bench_all.tag(r) for r in bench_all.RUNS] == [
        "sr3", "resdiff", "phydiff", "srdiff", "physrdiff", "sr3-ddim50", "sr3-dpm25"]
    seen = []

    class Done:
        returncode, stderr = 0, ""
        stdout = '{"value": 1.5}\n'

    def fake_run(cmd, env, **kw):
        seen.append((cmd[-1], env["BENCH_ARCH"], env.get("BENCH_SAMPLER")))
        return Done()

    monkeypatch.setattr(bench_all.subprocess, "run", fake_run)
    out = tmp_path / "sweep.json"
    assert bench_all.main(["-o", str(out), "sr3-dpm25", "phydiff"]) == 0
    assert seen == [("srewd_tpu_torch.bench", "phydiff", None),
                    ("srewd_tpu_torch.bench", "sr3", "dpm")]
    assert [e["run"] for e in json.load(open(out))] == ["phydiff", "sr3-dpm25"]
    # by default under the gitignored build/, never the JAX record BENCH_ARCHS.json
    assert bench_all.OUT == os.path.join(REPO, "build", "bench_archs_torch.json")


def _hand_count(cfg, batch):
    """FLOPs of one train step of `cfg`'s toy UNet, counted by hand from the
    shapes each layer meets in a CPU run: a convolution 2 B Cout Hout Wout
    Cin kh kw forward, as much again for its weight's gradient and for its
    input's when the input needs one; a linear layer likewise; each
    attention 4 B N^2 D forward and 10 B N^2 D backward (the recomputed
    scores, dP, dQ, dK, dV); and the bicubic x4 condition's two products."""
    model = build_model(cfg)
    total = [0]

    def layer(mod, inp, out):
        x = inp[0]
        k = mod.weight[0].numel()  # Cin/groups x kh x kw, or in_features
        flops = 2 * out.numel() * k
        total[0] += flops * (2 + x.requires_grad)

    def attention(mod, inp, out):
        b, c, h, w = inp[0].shape
        total[0] += 14 * b * (h * w) ** 2 * c

    for mod in model.unet.modules():
        if isinstance(mod, (layers.Conv2d, layers.Linear)):
            mod.register_forward_hook(layer)
        elif isinstance(mod, (blocks.SelfAttention, blocks.CrossAttention)):
            mod.register_forward_hook(attention)
    g = torch.Generator().manual_seed(0)
    b = {"HR": torch.randn(batch, H, W, 1, generator=g),
         "LR": torch.randn(batch, H // 4, W // 4, 1, generator=g)}
    model.loss(b, Schedule.create("linear", 1000), generator=g).backward()
    h, w = H // 4, W // 4
    total[0] += 2 * (4 * h) * h * batch * w + 2 * (4 * w) * w * batch * (4 * h)
    return total[0]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_step_flops_equal_a_hand_count(dtype):
    cfg = toy("sr3")
    assert bench_train.step_flops(cfg, 2, dtype) == _hand_count(cfg, 2)
