"""Finding a cell's pieces by name, and what a driver hands back.

A cell of BENCHMARK.json names a configuration and a traffic mix. The
harness finds each piece in a file of its own:
* the configuration: the `file` of its `configs` entry (a JSON object
  with the shipped `model` section and the `train` and `data` settings the
  cells read);
* the traffic mix: `perfbench/traffic/<traffic>.json`, whose `driver`
  names the general generator that reads it (`perfbench/drivers/<driver>.py`);
* the limits of the correctness check: `perfbench/limits/<cell>.json`;
* a per-layer metric: its reader, `perfbench/metrics/<metric>.py`.
A later cell, mix or metric is a new file and a new entry, and no file
here changes.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
from typing import Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    chips: int
    end_to_end: list  # the cell's end-to-end metric entries
    per_layer: list  # the cell's per-layer metric entries

    @property
    def driver(self):
        return importlib.import_module(f"perfbench.drivers.{self.traffic['driver']}")


def _applies(metric: dict, cell: str, reported: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in reported


def find(name: str, bench_path: Optional[str] = None) -> Cell:
    """The cell `name` of BENCHMARK.json with its pieces loaded; raises
    KeyError for a name the file does not hold, FileNotFoundError for a
    piece that is missing."""
    bench = load_json(bench_path or os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (has {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    if w["config"] not in configs:
        raise KeyError(f"workload {name!r} names no known config {w['config']!r}")
    config = load_json(os.path.join(ROOT, configs[w["config"]]["file"]))
    traffic = load_json(os.path.join(HERE, "traffic", f"{w['traffic']}.json"))
    limits = load_json(os.path.join(HERE, "limits", f"{name}.json"))
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _applies(m, name, reported)]
    return Cell(name, config, traffic, limits, int(w["chips"]), e2e, per_layer)


def reader(metric: str):
    """The `read(ctx)` function of a per-layer metric's reader file."""
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no reader for per-layer metric {metric!r} at {path}")
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Outcome:
    """What a driver's run hands back to `run.py`."""

    window_start: float  # perf_counter at the window's start
    metrics: dict  # end-to-end {name: value}
    attempted: int
    failed: int
    checks: list  # [(name, value, limit)]; correct when each value <= its limit
    memory_peak_bytes: int
    layer: Optional["LayerContext"] = None
    extra: dict = dataclasses.field(default_factory=dict)  # printed to stderr only


@dataclasses.dataclass
class LayerContext:
    """What a per-layer reader reads, from a `--trace 1` run.

    trace: the profiled stretch (perfbench.trace.Trace); units: UNet calls
    (sampling, serving) or train steps in it; timed_units / timed_seconds:
    the same counted over the unprofiled stretch before it; unit_flops: the
    reference's operations of one unit; kernel_work: {kernel: (flops,
    bytes)} of one unit (work/); dtype: "float32" or "bfloat16"; counters:
    the program's counters over the window, where the driver reads any."""

    trace: object
    units: int
    timed_units: int
    timed_seconds: float
    unit_flops: float
    kernel_work: dict
    dtype: str
    counters: dict = dataclasses.field(default_factory=dict)
