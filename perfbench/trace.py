"""The traced stretch of a `--trace 1` run: torch.profiler over CPU and CUDA
activity around a callable, read back from its Chrome trace.

`profile(fn)` returns a `Trace`: the device operations (kernels, copies
and sets, with the host time their launch was made), the host's named
spans (record_function: the harness's own and the program's), and the
window. The window is marked by two tiny device operations, each
launched inside a span `perfbench.window`, at the start and after the
end of the stretch; it runs from the first marker's start to the second's
end on the device's clock. (In a stretch where other threads launch the
work and the profiling thread mostly waits, the host-side timestamps of
the trace have been seen to shrink a 5 s stretch to a few ms, while the
device's stay true; the spans' own times are the fallback on the CPU.)
Kernel and launch are paired by the trace's correlation ids.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from typing import NamedTuple

import torch

WINDOW = "perfbench.window"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class DeviceOp(NamedTuple):
    name: str
    cat: str
    start: float  # us, host clock
    dur: float  # us
    launch: float  # us, host clock of its launch (or start when unknown)


class Span(NamedTuple):
    name: str
    start: float
    dur: float


class Trace:
    def __init__(self, ops: list, spans: list, window: tuple):
        self.window = window
        lo, hi = window
        self.ops = [o for o in ops if o.start < hi and o.start + o.dur > lo]
        self.spans = spans
        self.kernels = [o for o in self.ops if o.cat == "kernel"]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_intervals(self) -> list:
        """The union of the device operations' intervals inside the window."""
        lo, hi = self.window
        ivs = sorted((max(o.start, lo), min(o.start + o.dur, hi)) for o in self.ops)
        merged: list = []
        for a, b in ivs:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def kernel_seconds(self, *prefixes: str) -> float:
        """Device seconds of the kernels whose name starts with a prefix
        (after any return type and namespaces)."""
        return sum(o.dur for o in self.kernels if _base(o.name).startswith(prefixes)) / 1e6

    def seconds_under(self, span_name: str) -> float:
        """Device seconds of the operations launched inside a host span."""
        spans = sorted((s.start, s.start + s.dur) for s in self.spans if s.name == span_name)
        starts = [a for a, _ in spans]
        total = 0.0
        for o in self.ops:
            i = bisect.bisect_right(starts, o.launch) - 1
            if i >= 0 and o.launch <= spans[i][1]:
                total += o.dur
        return total / 1e6

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps
        summed by the innermost host span around the launch that ends each
        gap (what the host was doing while the device waited)."""
        by_op: dict = defaultdict(float)
        for o in self.ops:
            by_op[_short(o.name)] += o.dur / 1e6
        gaps: dict = defaultdict(float)
        busy = self.busy_intervals()
        lo, hi = self.window
        firsts = sorted(self.ops, key=lambda o: o.start)
        starts = [o.start for o in firsts]
        edges = [(lo, busy[0][0] if busy else hi)] + [
            (busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
        if busy:
            edges.append((busy[-1][1], hi))
        spans = self.spans
        for a, b in edges:
            if b <= a:
                continue
            i = bisect.bisect_left(starts, b)
            label = "window end" if i >= len(firsts) else _innermost(spans, firsts[i].launch)
            gaps[label] += (b - a) / 1e6
        order = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]  # noqa: E731
        return {"device_ops": [[k, v] for k, v in order(by_op)],
                "idle_gaps": [[k, v] for k, v in order(gaps)]}


def _innermost(spans: list, t: float) -> str:
    best = None
    for s in spans:
        if s.start <= t <= s.start + s.dur and (best is None or s.dur < best.dur):
            best = s
    return best.name if best is not None else "outside any span"


def _short(name: str) -> str:
    return name.replace("(anonymous namespace)::", "")[:120]


def _base(name: str) -> str:
    """A kernel's name without its return type, namespaces and template
    arguments."""
    head = name.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0]
    return head.split()[-1].split("::")[-1] if head.split() else name


class Profiler:
    """torch.profiler over CPU and CUDA activity between `start()` and
    `stop()`, called on one thread; `stop` returns the parsed Trace and
    deletes the trace's file. With `sync`, stop waits for the device
    first."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._flag = torch.zeros(1, device=self.device)

    def _mark(self) -> None:
        with torch.profiler.record_function(WINDOW):
            self._flag.add_(1.0)  # the marker: one small kernel on the current stream

    def start(self) -> None:
        from torch.profiler import ProfilerActivity

        self._prof = torch.profiler.profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._mark()

    def stop(self, sync: bool = True) -> "Trace":
        if sync and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._mark()
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()  # the marker has run
        self._prof.__exit__(None, None, None)
        return _export(self._prof)


class ScheduledProfiler(Profiler):
    """A Profiler for an open loop: made (and the profiler prepared, which
    held the host for about 10 s in a serving run on the chip) before the
    loop, so the loop's own thread pays only the start of recording.
    `trace` holds the parsed Trace once recording has stopped (exporting
    it holds the loop's thread too, after the traced stretch)."""

    def __init__(self, device, start_at: int, stop_at: int):
        from torch.profiler import ProfilerActivity

        super().__init__(device)
        self.start_at, self.stop_at, self.calls, self.trace = start_at, stop_at, 0, None
        sched = torch.profiler.schedule(wait=0, warmup=start_at, active=stop_at - start_at,
                                        repeat=1)
        self._prof = torch.profiler.profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], schedule=sched,
            on_trace_ready=self._ready)
        self._prof.__enter__()

    def _ready(self, prof) -> None:
        self.trace = _export(prof)

    def step(self) -> None:
        """Call before each request: recording runs from the `start_at`-th
        call to the `stop_at`-th (counting from 1), each end marked."""
        n = self.calls + 1
        if n == self.stop_at:
            self._mark()
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
        if n <= self.stop_at:
            self._prof.step()
        if n == self.start_at:
            self._mark()
        self.calls = n

    def close(self) -> None:
        self._prof.__exit__(None, None, None)


def _export(prof) -> "Trace":
    fd, path = tempfile.mkstemp(suffix=".pt.trace.json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return parse(events)


def profile(fn, device) -> "Trace":
    """Run `fn()` under the Profiler, stopping after a synchronise."""
    p = Profiler(device)
    p.start()
    fn()
    return p.stop()


def parse(events: list) -> Trace:
    launches, runtime = {}, []
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = float(e["ts"])
            runtime.append((float(e["ts"]), e["args"]["correlation"]))
    ops, spans, marks = [], [], []
    for e in events:
        cat = e.get("cat")
        if e.get("ph") != "X":
            continue
        if cat in _DEVICE_CATS:
            corr = e.get("args", {}).get("correlation")
            ts = float(e["ts"])
            ops.append(DeviceOp(e.get("name", ""), cat, ts, float(e.get("dur", 0.0)),
                                launches.get(corr, ts)))
        elif cat == "user_annotation":
            s = Span(e["name"], float(e["ts"]), float(e.get("dur", 0.0)))
            (marks if s.name == WINDOW else spans).append(s)
    if len(marks) != 2:
        raise RuntimeError(f"the trace holds {len(marks)} {WINDOW} marks, not 2")
    marks.sort(key=lambda m: m.start)
    by_corr = {}
    for e in events:
        if e.get("cat") in _DEVICE_CATS and e.get("ph") == "X":
            by_corr[e.get("args", {}).get("correlation")] = e
    dev = []
    for m in marks:  # the marker kernel launched inside each mark
        corr = [c for t, c in runtime if m.start <= t <= m.start + m.dur and c in by_corr]
        dev.append(by_corr[corr[-1]] if corr else None)
    if all(dev):
        window = (float(dev[0]["ts"]), float(dev[1]["ts"]) + float(dev[1].get("dur", 0.0)))
    else:
        window = (marks[0].start, marks[1].start + marks[1].dur)
    return Trace(ops, spans, window)
