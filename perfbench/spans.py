"""The program's own spans in a traced stretch (`utils/profiling.annotate`
in the port: record_function, on the profiler's clock), read for the
per-layer metrics: how many a stretch holds, the device time of what was
launched inside them, and the idle time they kept the card waiting.

A wait: the card's idle gaps are the gaps between the intervals of
`Trace.busy_intervals()`. The operation that starts at a gap's end ends
it, and the gap is a wait of span X when that operation's launch lies
inside a span named X, at any depth.
"""

from __future__ import annotations

import bisect
from typing import Callable, Optional


def count(trace, name: str) -> int:
    """The number of spans named `name`."""
    return sum(1 for s in trace.spans if s.name == name)


def _union(trace, name: str) -> tuple:
    """(starts, ends) of the union of the spans named `name`, in order."""
    merged: list = []
    for a, b in sorted((s.start, s.start + s.dur) for s in trace.spans if s.name == name):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [a for a, _ in merged], [b for _, b in merged]


def _inside(union: tuple, t: float) -> bool:
    starts, ends = union
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t <= ends[i]


def wait_seconds(trace, name: str) -> float:
    """Seconds of the idle gaps that are waits of a span `name`."""
    union = _union(trace, name)
    busy = trace.busy_intervals()
    ops = sorted(trace.ops, key=lambda o: o.start)
    starts = [o.start for o in ops]
    total = 0.0
    for (_, a), (b, _) in zip(busy, busy[1:]):
        i = bisect.bisect_left(starts, b)
        if b > a and i < len(ops) and _inside(union, ops[i].launch):
            total += b - a
    return total / 1e6


def device_seconds(trace, name: str) -> float:
    """Device seconds of the operations launched inside a span `name`."""
    return trace.seconds_under(name)


def ms_per(trace, seconds: Callable, name: str, per: str) -> Optional[float]:
    """1e3 * seconds(trace, name) over the number of spans `per`; None
    where the stretch holds no span `name` or none `per`."""
    n = count(trace, per)
    if n == 0 or count(trace, name) == 0:
        return None
    return 1e3 * seconds(trace, name) / n
