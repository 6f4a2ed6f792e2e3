"""The result line of a run (see run.py)."""

from __future__ import annotations

import math

import torch

from .cell import reader


def correct(out) -> bool:
    """Every request answered and every compared number within its limit."""
    return (out.attempted > 0 and out.failed == 0
            and all(math.isfinite(v) and v <= lim for _, v, lim in out.checks))


def result(cell, out, *, setup_s: float, trace: bool, device) -> dict:
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if trace:
        values = {}
        for m in cell.per_layer:
            v = reader(m["name"])(out.layer)
            if v is not None:
                values[m["name"]] = v
    else:
        values = dict(out.metrics, setup_s=setup_s)
        missing = {m["name"] for m in cell.end_to_end} - set(values)
        if missing:
            raise RuntimeError(f"{cell.name}: the driver reported no {sorted(missing)}")
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": cell.chips,
           "memory_peak_bytes": int(out.memory_peak_bytes)}
    line = {"correct": correct(out), "attempted": int(out.attempted), "failed": int(out.failed),
            "metrics": {k: {"value": float(v), "unit": units[k]} for k, v in values.items()},
            "device": dev}
    if trace:
        t = out.layer.trace
        dev.update(busy_s=t.busy_s, window_s=t.window_s)
        line["breakdown"] = t.breakdown()
    line["checks"] = {n: {"value": v if math.isfinite(v) else str(v), "limit": lim}
                      for n, v, lim in out.checks}
    return line
