"""Profiling and step timing (port of srewd_tpu/utils/profiling.py).

  * `trace(logdir)`: a torch.profiler capture of the CPU and, with a card,
    CUDA activity, written into `logdir` as a Chrome trace on exit
    (chrome://tracing, Perfetto, or TensorBoard's torch plugin).
  * `annotate(name)`: a named span in that trace (record_function) while a
    profiler records on this thread, and otherwise a shared null context.
  * `StepTimer`: rolling wall-clock step statistics. Steps are dispatched
    without waiting for the card, so `tick()` times the host's dispatch;
    over many steps that agrees with the card's pace, because the loss
    reads bound the queue ahead of the card. `tick(block=t)` synchronises
    with t's device first, and then times the card.
  * The H100's published peaks, for the roofline and MFU figures of
    `bench_train` and `chip_smoke.py`.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import deque

import torch

# NVIDIA H100 SXM data sheet, dense: bf16 on the tensor cores, float32 on
# the CUDA cores (the port runs float32 with TF32 off), and HBM3's rate
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
HBM_BYTES_PER_SEC = 3.35e12


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a torch.profiler trace into `logdir` (`trace_<pid>_<ms>.pt.trace.json`).

    Yields the profiler; its `trace_path` is set once the file is written.
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        prof.trace_path = os.path.join(
            logdir, f"trace_{os.getpid()}_{int(time.time() * 1e3)}.pt.trace.json")
        prof.export_chrome_trace(prof.trace_path)


_NO_SPAN = contextlib.nullcontext()


def annotate(name: str):
    """A named span in the profiler's trace while a profiler records on this
    thread; otherwise the one shared null context, so that a span costs a
    check (record_function alone costs an operator call) and puts no
    profiler op into a graph that torch.export traces."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


class StepTimer:
    def __init__(self, window: int = 200):
        self.window = window
        self.times = deque(maxlen=window)
        self._last = None

    def start(self) -> None:
        self._last = time.perf_counter()

    def tick(self, block: torch.Tensor | None = None) -> float:
        """Record one step; with `block`, first wait until its device is done."""
        if block is not None and block.device.type == "cuda":
            torch.cuda.synchronize(block.device)
        now = time.perf_counter()
        dt = 0.0 if self._last is None else now - self._last
        if self._last is not None:
            self.times.append(dt)
        self._last = now
        return dt

    @property
    def steps_per_sec(self) -> float:
        if not self.times:
            return 0.0
        return len(self.times) / sum(self.times)

    def summary(self) -> dict:
        if not self.times:
            return {"steps_per_sec": 0.0, "mean_s": 0.0, "p50_s": 0.0, "p95_s": 0.0}
        xs = sorted(self.times)
        n = len(xs)
        return {
            "steps_per_sec": self.steps_per_sec,
            "mean_s": sum(xs) / n,
            "p50_s": xs[n // 2],
            "p95_s": xs[min(n - 1, int(0.95 * n))],
        }

    def summary_str(self) -> str:
        s = self.summary()
        return (
            f"{s['steps_per_sec']:.2f} steps/s (mean {s['mean_s'] * 1e3:.1f} ms, "
            f"p50 {s['p50_s'] * 1e3:.1f} ms, p95 {s['p95_s'] * 1e3:.1f} ms)"
        )
