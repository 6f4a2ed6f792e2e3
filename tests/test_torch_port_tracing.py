"""The port's spans at its layer boundaries, on the CPU.

`utils/profiling.annotate` records a span (record_function) only while a
profiler records, and is one shared null context otherwise. Under
torch.profiler a reverse chain records `chain` ⊃ `conditioning` and
`chain` ⊃ `chain.step` ⊃ `unet`, once per step; a train step records
`train_step` ⊃ `loss` ⊃ `conditioning` (⊃ `encoder` for the RRDB archs)
and `loss` ⊃ `unet`. The readers of perfbench/metrics that read these
spans give their known values on a hand-built trace, and None where their
span is missing.
"""

import contextlib
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from perfbench import cell as cells
from perfbench.cell import LayerContext
from perfbench.trace import DeviceOp, Span, Trace
from srewd_tpu_torch.diffusion.schedule import Schedule
from srewd_tpu_torch.models.factory import build_model
from srewd_tpu_torch.serving.export import export_sampler
from srewd_tpu_torch.training.trainer import DiffusionTrainer
from srewd_tpu_torch.utils.profiling import annotate

from test_torch_port_device_data import _run, tree  # noqa: F401  (a module fixture)
from test_torch_port_model import H, W, one_torch_thread, toy_model_cfg  # noqa: F401

SCHED = {"schedule": "linear", "n_timestep": 50, "linear_start": 1e-4, "linear_end": 2e-2}
SPANS = ("chain", "conditioning", "chain.step", "unet", "encoder", "train_step", "loss",
         "backward", "optimizer")


def _model(arch):
    cfg = toy_model_cfg(arch)
    if arch == "srdiff":
        cfg["pretrained_model"] = {"hidden_size": 8, "num_block": 2, "lock_weights": False}
    torch.manual_seed(0)
    return build_model(cfg)


def _batch(b=2):
    g = torch.Generator().manual_seed(1)
    return {"HR": torch.randn(b, H, W, 1, generator=g),
            "LR": torch.randn(b, H // 4, W // 4, 1, generator=g)}


def _spans(fn) -> list:
    """(name, start, end) of the port's spans recorded while fn() runs."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.name in SPANS), key=lambda s: s[1])


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def _within(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_annotate_is_one_shared_null_context_with_the_profiler_off():
    a, b = annotate("chain"), annotate("unet")
    assert a is b and isinstance(a, contextlib.nullcontext)
    with profile(activities=[ProfilerActivity.CPU]):
        assert isinstance(annotate("chain"), torch.profiler.record_function)
    assert annotate("chain") is a


@pytest.mark.parametrize("steps", [3, 5])
def test_a_ddim_chain_records_its_spans_nested(steps):
    model = _model("phydiff")
    sched = Schedule.from_config(SCHED)
    spans = _spans(lambda: model.generate_sr({"LR": _batch()["LR"]}, sched, sampler="ddim",
                                             ddim_steps=steps))
    (chain,), (cond,) = _named(spans, "chain"), _named(spans, "conditioning")
    step, unet = _named(spans, "chain.step"), _named(spans, "unet")
    assert len(step) == len(unet) == steps and not _named(spans, "encoder")
    assert _within(cond, chain) and all(_within(s, chain) for s in step)
    assert all(_within(u, s) for u, s in zip(unet, step))
    assert cond[2] <= step[0][1]  # once, before the first step


@pytest.mark.parametrize("arch", ["srdiff", "phydiff"])
def test_a_train_step_records_its_spans_nested(arch):
    model = _model(arch)
    sched = Schedule.from_config(SCHED)
    trainer = DiffusionTrainer(model, sched, sched, device=torch.device("cpu"), seed=3)
    trainer.train_on_batch_async(_batch())  # the first step builds Adam's state
    spans = _spans(lambda: [trainer.train_on_batch_async(_batch()) for _ in range(2)])
    steps = _named(spans, "train_step")
    assert len(steps) == 2
    for name in ("loss", "backward", "optimizer", "conditioning", "unet"):
        got = _named(spans, name)
        assert len(got) == 2 and all(_within(s, t) for s, t in zip(got, steps)), name
    loss, cond = _named(spans, "loss"), _named(spans, "conditioning")
    assert all(_within(c, s) for c, s in zip(cond, loss))
    assert all(_within(u, s) for u, s in zip(_named(spans, "unet"), loss))
    enc = _named(spans, "encoder")
    if arch == "srdiff":
        assert len(enc) == 2 and all(_within(e, c) for e, c in zip(enc, cond))
    else:
        assert not enc


def test_an_exported_sampler_holds_no_profiler_op():
    model = _model("phydiff")
    ex = export_sampler(model, model.params(), Schedule.from_config(SCHED), (H // 4, W // 4, 1),
                        sampler_kwargs={"sampler": "ddim", "ddim_steps": 3},
                        device=torch.device("cpu"))
    for prog in (ex.condition, ex.step):
        targets = [str(n.target) for n in prog.graph.nodes if n.op == "call_function"]
        assert targets and not [t for t in targets if "profiler" in t or "record_function" in t]


def test_run_training_writes_one_train_step_span_per_step(tree, tmp_path):  # noqa: F811
    res = _run(tree, tmp_path, profile_trace_dir=str(tmp_path / "trace"), profile_start=1,
               profile_steps=2)
    with open(res["trace"]) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("cat") == "user_annotation"]
    steps = [e for e in events if e["name"] == "train_step"]
    assert len(steps) == 2
    for name in ("loss", "conditioning", "unet", "backward", "optimizer"):
        inner = [e for e in events if e["name"] == name]
        assert len(inner) == 2, name
        for e, s in zip(sorted(inner, key=lambda e: e["ts"]), sorted(steps, key=lambda e: e["ts"])):
            assert s["ts"] <= e["ts"] and e["ts"] + e["dur"] <= s["ts"] + s["dur"], name


def _trace(spans: list) -> Trace:
    """A stretch of 100 us on the device: three operations (busy 0-10,
    30-40, 70-80; idle gaps 10-30 and 40-70) launched at 5, 25 and 65."""
    ops = [DeviceOp("k0", "kernel", 0.0, 10.0, 5.0), DeviceOp("k1", "kernel", 30.0, 10.0, 25.0),
           DeviceOp("k2", "kernel", 70.0, 10.0, 65.0), DeviceOp("w", "kernel", 99.0, 1.0, 95.0)]
    return Trace(ops, [Span(*s) for s in spans], (0.0, 100.0))


def _ctx(trace):
    return LayerContext(trace=trace, units=1, timed_units=1, timed_seconds=1.0, unit_flops=1.0,
                        kernel_work={}, dtype="float32")


# spans: a chain over everything, two train steps, conditioning (with the
# encoder inside it) around the launch at 5, a unet call around the launch
# at 25, and another, nested in a chain.step, around the launch at 65
HAND = [("chain", 0.0, 96.0), ("train_step", 0.0, 50.0), ("train_step", 50.0, 46.0),
        ("conditioning", 1.0, 10.0), ("encoder", 4.0, 2.0), ("unet", 20.0, 10.0),
        ("chain.step", 60.0, 10.0), ("unet", 62.0, 5.0)]


@pytest.mark.parametrize("metric,want", [
    # the operations launched inside conditioning: k0, 10 us, over one chain
    ("conditioning_ms_per_chain.sample", 10e-3),
    # unet's waits: the gaps ended by k1 (20 us) and k2 (30 us), over 2 calls
    ("unet_wait_ms_per_call.sample", 25e-3),
    # the same 50 us over 2 train steps
    ("unet_wait_ms_per_step.train", 25e-3),
    # the encoder launched k0, 10 us, over 2 steps; k0 ends no gap
    ("encoder_ms_per_step.train", 5e-3),
    ("encoder_wait_ms_per_step.train", 0.0),
])
def test_each_span_reader_reads_its_known_value(metric, want):
    assert cells.reader(metric)(_ctx(_trace(HAND))) == pytest.approx(want, abs=1e-12)


@pytest.mark.parametrize("metric,missing", [
    ("conditioning_ms_per_chain.sample", "conditioning"),
    ("conditioning_ms_per_chain.sample", "chain"),
    ("unet_wait_ms_per_call.sample", "unet"),
    ("unet_wait_ms_per_step.train", "train_step"),
    ("encoder_ms_per_step.train", "encoder"),
    ("encoder_wait_ms_per_step.train", "encoder"),
])
def test_a_span_reader_reads_none_where_its_span_is_missing(metric, missing):
    spans = [s for s in HAND if s[0] != missing]
    assert cells.reader(metric)(_ctx(_trace(spans))) is None
