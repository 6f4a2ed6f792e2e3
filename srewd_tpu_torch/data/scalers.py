"""Normalization: streaming standard scaling with exact Welford-merge math
(copy of srewd_tpu/data/scalers.py).

  * GlobalStandardScaling: scalar per-channel mean/std over (time, lat, lon);
  * LocalStandardScaling: per-pixel mean/std over the time dim;
  * unbiased std (count - 1), float64 accumulation, and the parallel merge
        M2 += M2_b + (mean_b - mean)^2 * (n_b * n / (n + n_b))
        mean = (n * mean + n_b * mean_b) / (n + n_b);
  * scalers are fitted per (variable, lr/hr, month GROUP) on the training
    range only, then mapped month -> fitted scaler.

The fitted set is dense arrays indexed by month (`MonthlyScalerSet`), so the
month-keyed transform and inverse are a gather. Fitted stats are cached on
disk keyed by (store path, date range, months, kind).
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

from .store import WeatherStore
from .timeindex import month_to_group, months_of, select_months, union_hourly_ranges, validate_groups


class WelfordAccumulator:
    """Streaming mean / sum-of-squared-differences with exact parallel merge."""

    def __init__(self, axis: tuple[int, ...]):
        self.axis = axis
        self.count = 0.0
        self.mean = None
        self.m2 = None

    def update(self, batch: np.ndarray) -> None:
        """batch: [N,H,W,C] float; stats over self.axis (keepdims)."""
        b = batch.astype(np.float64)
        n = float(np.prod([b.shape[a] for a in self.axis]))
        mean = b.mean(axis=self.axis, keepdims=True)
        m2 = np.sum(np.square(b - mean), axis=self.axis, keepdims=True)
        if self.mean is None:
            self.count, self.mean, self.m2 = n, mean, m2
            return
        new_count = self.count + n
        self.m2 = self.m2 + m2 + (mean - self.mean) ** 2 * (n * self.count / new_count)
        self.mean = (self.count * self.mean + n * mean) / new_count
        self.count = new_count

    def finalize(self, unbiased: bool = True):
        if self.mean is None:
            raise ValueError("no data accumulated")
        denom = self.count - (1.0 if unbiased else 0.0)
        std = np.sqrt(self.m2 / denom)
        return self.mean[0], std[0]  # drop the time axis keepdim


_KIND_AXES = {
    "GlobalStandardScaling": (0, 1, 2),  # time, lat, lon -> per-channel scalar
    "LocalStandardScaling": (0,),  # time -> per-pixel map
}


class MonthlyScalerSet:
    """Dense month-indexed (1..12) mean/std arrays for one (variable, type).

    mean/std have shape [13, ...] broadcastable against [B,H,W,C] batches;
    the month-0 row is unused.
    """

    def __init__(self, mean: np.ndarray, std: np.ndarray, kind: str):
        self.mean = mean.astype(np.float32)
        self.std = std.astype(np.float32)
        self.kind = kind

    @property
    def identity(self) -> bool:
        return self.kind == "IdentityTransform"

    def transform(self, batch: np.ndarray, months: np.ndarray) -> np.ndarray:
        if self.identity:
            return batch
        m = np.asarray(months, np.int32)
        return (batch - self.mean[m]) / self.std[m]

    def inverse(self, batch: np.ndarray, months) -> np.ndarray:
        if self.identity:
            return batch
        m = np.asarray(months, np.int32)
        return self.std[m] * batch + self.mean[m]

    @classmethod
    def identity_set(cls) -> "MonthlyScalerSet":
        z = np.zeros((13, 1, 1, 1), np.float32)
        return cls(z, z + 1.0, "IdentityTransform")

    def save(self, path: str) -> None:
        """Write `path` whole or not at all (ranks of one run share the cache:
        one may read while another writes)."""
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            np.savez(f, mean=self.mean, std=self.std, kind=np.array(self.kind))
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "MonthlyScalerSet":
        with np.load(path, allow_pickle=False) as z:
            return cls(z["mean"], z["std"], str(z["kind"]))


def fit_monthly_scalers(
    store: WeatherStore,
    min_date: str,
    max_date: str,
    months_subset,
    groups,
    kind: str = "GlobalStandardScaling",
    chunk: int = 1024,
    cache_dir: str | None = None,
    extra_ranges=None,
) -> MonthlyScalerSet:
    """Fit one scaler per month GROUP over [min_date, max_date) training data,
    plus `extra_ranges` (more (min, max) pairs), memoized in `cache_dir`."""
    if kind == "IdentityTransform":
        return MonthlyScalerSet.identity_set()
    if kind not in _KIND_AXES:
        raise ValueError(f"unknown transformation {kind}")
    validate_groups(months_subset, groups)

    if not store.time_variate:
        # a constant field (e.g. orography) is fitted once, on its one sample
        if kind == "LocalStandardScaling":
            raise ValueError(
                "LocalStandardScaling cannot be fitted to a constant field "
                f"({store.path}): per-pixel variance over a single sample is "
                "undefined. Use GlobalStandardScaling or IdentityTransform."
            )
        acc = WelfordAccumulator(_KIND_AXES[kind])
        acc.update(store.read(None)[None])
        m, s = acc.finalize(unbiased=True)
        mean = np.broadcast_to(m, (13,) + m.shape).copy()
        std = np.broadcast_to(s, (13,) + s.shape).copy()
        return MonthlyScalerSet(mean, std, kind)

    spans = ([(min_date, max_date)] if min_date is not None and max_date is not None
             else []) + [tuple(r) for r in (extra_ranges or [])]

    cache_path = None
    if cache_dir:
        key = repr((os.path.abspath(store.path),
                    tuple((str(a), str(b)) for a, b in spans),
                    tuple(sorted(months_subset or range(1, 13))),
                    tuple(tuple(g) for g in groups), kind))
        digest = hashlib.sha256(key.encode()).hexdigest()[:24]
        os.makedirs(cache_dir, exist_ok=True)
        cache_path = os.path.join(cache_dir, f"scaler_{store.name}_{digest}.npz")
        if os.path.isfile(cache_path):
            return MonthlyScalerSet.load(cache_path)

    ts = select_months(union_hourly_ranges(spans), months_subset)
    months = months_of(ts)
    m2g = month_to_group(groups)
    axes = _KIND_AXES[kind]

    accs: dict[int, WelfordAccumulator] = {}
    for gi in sorted(set(m2g.values())):
        sel = ts[np.isin(months, [m for m, g in m2g.items() if g == gi])]
        if len(sel) == 0:
            continue
        acc = WelfordAccumulator(axes)
        for lo in range(0, len(sel), chunk):
            acc.update(store.read_many(sel[lo : lo + chunk]))
        accs[gi] = acc

    sample = store.read(ts[0])
    stat_shape = (1, 1, sample.shape[-1]) if kind == "GlobalStandardScaling" else sample.shape
    mean = np.zeros((13,) + stat_shape, np.float64)
    std = np.ones((13,) + stat_shape, np.float64)
    for month, gi in m2g.items():
        if gi in accs:
            m, s = accs[gi].finalize(unbiased=True)
            mean[month], std[month] = m, s
    out = MonthlyScalerSet(mean, std, kind)
    if cache_path:
        out.save(cache_path)
    return out
