"""Date/time index math for WeatherBench hourly data (copy of srewd_tpu/data/timeindex.py).

The sample index is a flat sorted np.datetime64[h] array and every range /
month-subset operation is a vectorized mask.

Conventions:
  * datetime string format "%Y-%m-%d-%H";
  * temporal resolution 1 hour;
  * a [min_date, max_date) range EXCLUDES max_date.
"""

from __future__ import annotations

from datetime import datetime

import numpy as np

DATETIME_FORMAT = "%Y-%m-%d-%H"
HOUR = np.timedelta64(1, "h")


def parse_date(date: str | np.datetime64 | datetime) -> np.datetime64:
    """'%Y-%m-%d-%H' string (or datetime) -> np.datetime64[h]."""
    if isinstance(date, np.datetime64):
        return date.astype("datetime64[h]")
    if isinstance(date, datetime):
        return np.datetime64(date).astype("datetime64[h]")
    return np.datetime64(datetime.strptime(date, DATETIME_FORMAT)).astype("datetime64[h]")


def format_date(ts: np.datetime64) -> str:
    return ts.astype("datetime64[h]").item().strftime(DATETIME_FORMAT)


def hourly_range(min_date, max_date) -> np.ndarray:
    """[min_date, max_date) at 1h resolution (max excluded)."""
    lo = parse_date(min_date)
    hi = parse_date(max_date)
    if hi <= lo:
        raise ValueError(f"empty date range [{lo}, {hi})")
    return np.arange(lo, hi, HOUR)


def union_hourly_ranges(spans) -> np.ndarray:
    """Sorted union of [min, max) hourly ranges (overlapping spans coalesce)."""
    parts = [hourly_range(lo, hi) for lo, hi in spans]
    if not parts:
        return np.array([], dtype="datetime64[h]")
    out = parts[0]
    for p in parts[1:]:
        out = np.union1d(out, p)
    return out.astype("datetime64[h]")


def months_of(ts: np.ndarray) -> np.ndarray:
    """Calendar month (1..12) of each timestamp."""
    return (ts.astype("datetime64[M]").astype(int) % 12 + 1).astype(np.int32)


def select_months(ts: np.ndarray, months_subset) -> np.ndarray:
    """Subset timestamps whose calendar month is in months_subset (None = all)."""
    if months_subset is None:
        return ts
    subset = set(int(m) for m in months_subset)
    if not subset <= set(range(1, 13)):
        raise ValueError(f"invalid months subset {months_subset}")
    if subset == set(range(1, 13)):
        return ts
    mask = np.isin(months_of(ts), sorted(subset))
    return ts[mask]


def validate_groups(months_subset, groups) -> None:
    """Every month of the subset must belong to exactly one transform group."""
    if groups is None:
        raise ValueError("transform groups must be provided")
    flat = [m for g in groups for m in g]
    if len(flat) != len(set(flat)):
        raise ValueError(f"months appear in multiple groups: {groups}")
    if months_subset is not None:
        missing = set(int(m) for m in months_subset) - set(flat)
        if missing:
            raise ValueError(f"months {sorted(missing)} not covered by groups {groups}")


def month_to_group(groups) -> dict[int, int]:
    """month (1..12) -> group index (0-based) mapping."""
    return {int(m): gi for gi, g in enumerate(groups) for m in g}
