"""StepTimer: rolling wall-clock step statistics (port of the StepTimer of
srewd_tpu/utils/profiling.py; a torch.profiler capture is later work).

Steps are dispatched without waiting for the card, so `tick()` times the
host's dispatch; over many steps that agrees with the card's pace, because
the loss reads bound the queue ahead of the card.
"""

from __future__ import annotations

import time
from collections import deque


class StepTimer:
    def __init__(self, window: int = 200):
        self.window = window
        self.times = deque(maxlen=window)
        self._last = None

    def start(self) -> None:
        self._last = time.perf_counter()

    def tick(self) -> float:
        """Record one step."""
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
