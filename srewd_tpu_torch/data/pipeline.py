"""DataHandler: fitting, batching and date lookup for train/val (copy of
srewd_tpu/data/pipeline.py).

Batch contract (NHWC numpy):

    {"HR": [B,H,W,C_total], "LR": [B,h,w,C_total], "months": int32 [B]}

with variables concatenated channel-wise in config order. The bicubic x4
"SR" slot is not produced here: the model computes it on the device.

Fitting: per (variable x lr/hr x month group) global or local standard
scaling on the train range only, cached on disk (scalers.py). Validation
reuses the fitted train transforms.

Several processes (`process_count` > 1, one per rank): every process fits
the same scalers and takes a disjoint stride of each split's index,
`process_index::process_count`, after trimming the index to a multiple of
the count. Every rank then has the same number of batches, so no rank waits
in a collective that another never reaches. (The JAX package strides
without the trim, and its strides can differ by one timestamp.)
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from .scalers import MonthlyScalerSet, fit_monthly_scalers
from .store import WeatherStore
from .timeindex import months_of, parse_date, select_months, union_hourly_ranges

_TYPES = ("lr", "hr")


def _concat_scalers(sets: list[MonthlyScalerSet]) -> MonthlyScalerSet:
    """Channel-concat per-variable scaler sets into one set for the batch."""
    if all(s.identity for s in sets):
        return MonthlyScalerSet.identity_set()
    kinds = {s.kind for s in sets}
    if len(kinds) != 1:
        raise ValueError(f"mixed scaler kinds across variables: {kinds}")
    mean = np.concatenate([s.mean for s in sets], axis=-1)
    std = np.concatenate([s.std for s in sets], axis=-1)
    return MonthlyScalerSet(mean, std, sets[0].kind)


@dataclass
class DataHandler:
    dataroot: str
    variables: list
    months_subset: list | None = None
    groups: list | None = None
    transformation: str = "GlobalStandardScaling"
    train_min_date: str | None = None
    train_max_date: str | None = None
    val_min_date: str | None = None
    val_max_date: str | None = None
    # extra (min, max) date-range pairs unioned into the index (config keys
    # data.train_date_ranges / data.val_date_ranges); extra train ranges
    # also feed scaler fitting
    train_date_ranges: list | None = None
    val_date_ranges: list | None = None
    train_batch_size: int = 4
    val_batch_size: int = 8
    shuffle: bool = True
    lead_time: int = 0  # hours added to every read timestamp
    delays: list | None = None  # extra per-sample time offsets, channel-concat
    storage_root: str | None = None
    read_threads: int = 16
    seed: int = 0
    process_index: int = 0
    process_count: int = 1

    stores: dict = field(default_factory=dict, init=False)
    scalers: dict = field(default_factory=dict, init=False)  # (var, type) -> set
    batch_scalers: dict = field(default_factory=dict, init=False)  # type -> set
    train_timestamps: np.ndarray | None = field(default=None, init=False)
    val_timestamps: np.ndarray | None = field(default=None, init=False)

    def __post_init__(self):
        if not 0 <= self.process_index < self.process_count:
            raise ValueError(f"process_index {self.process_index} is not in "
                             f"[0, {self.process_count})")
        if self.groups is None:
            self.groups = [list(range(1, 13))]
        if self.delays is not None:
            d = [int(x) for x in self.delays]
            if 0 not in d:
                d = [0] + d
            if len(d) != len(set(d)):
                raise ValueError("delays must be unique")
            self.delays = d
        for var in self.variables:
            self.stores[var] = {
                t: WeatherStore(os.path.join(self.dataroot, t, var)) for t in _TYPES
            }

    def process_data(self) -> "DataHandler":
        cache_dir = os.path.join(self.storage_root, "scaler_cache") if self.storage_root else None
        for var in self.variables:
            for t in _TYPES:
                self.scalers[(var, t)] = fit_monthly_scalers(
                    self.stores[var][t],
                    self.train_min_date,
                    self.train_max_date,
                    self.months_subset,
                    self.groups,
                    kind=self.transformation,
                    cache_dir=cache_dir,
                    extra_ranges=self.train_date_ranges,
                )
        for t in _TYPES:
            self.batch_scalers[t] = _concat_scalers([self.scalers[(v, t)] for v in self.variables])
        self.train_timestamps = self._index(
            self.train_min_date, self.train_max_date, self.train_date_ranges)
        self.val_timestamps = self._index(
            self.val_min_date, self.val_max_date, self.val_date_ranges)
        return self

    def _index(self, min_date, max_date, extra_ranges=None) -> np.ndarray | None:
        spans = []
        if min_date is not None and max_date is not None:
            spans.append((min_date, max_date))
        spans.extend(tuple(r) for r in (extra_ranges or []))
        if not spans:
            return None
        ts = select_months(union_hourly_ranges(spans), self.months_subset)
        # intersect with every store's available range, shifted so that every
        # lead/delay offset stays readable
        offs = [self.lead_time + d for d in (self.delays or [0])]
        lo_off, hi_off = min(offs + [0]), max(offs + [0])
        for var in self.variables:
            for t in _TYPES:
                st = self.stores[var][t]
                if not st.time_variate:
                    continue  # constant fields are valid at every timestamp
                ts = ts[
                    (ts + np.timedelta64(lo_off, "h") >= st.timestamps[0])
                    & (ts + np.timedelta64(hi_off, "h") <= st.timestamps[-1])
                ]
        if self.process_count > 1:
            ts = ts[:len(ts) - len(ts) % self.process_count]
            ts = ts[self.process_index::self.process_count]
        return ts

    def assemble(self, ts_batch: np.ndarray, normalized: bool = True) -> dict:
        """Read and normalize one batch of timestamps. Every offset slice is
        scaled with the BASE timestamp's month scaler."""
        months = months_of(ts_batch)
        out = {"months": months.astype(np.int32)}
        offsets = [self.lead_time + d for d in (self.delays or [0])]
        for t, key in (("hr", "HR"), ("lr", "LR")):
            per_off = []
            for off in offsets:
                ts_off = ts_batch + np.timedelta64(off, "h") if off else ts_batch
                per_var = [self.stores[v][t].read_many(ts_off, self.read_threads)
                           for v in self.variables]
                batch = per_var[0] if len(per_var) == 1 else np.concatenate(per_var, axis=-1)
                if normalized:
                    batch = self.batch_scalers[t].transform(batch, months)
                per_off.append(batch)
            batch = per_off[0] if len(per_off) == 1 else np.concatenate(per_off, axis=-1)
            out[key] = batch.astype(np.float32)
        return out

    def _batches(self, ts: np.ndarray, batch_size: int, shuffle: bool, epoch: int,
                 skip: int = 0):
        n = (len(ts) // batch_size) * batch_size  # drop_last
        if n == 0:
            return
        order = np.arange(len(ts))
        if shuffle:
            np.random.default_rng(self.seed + 7919 * epoch).shuffle(order)
        for lo in range(skip * batch_size, n, batch_size):
            yield self.assemble(ts[order[lo : lo + batch_size]])

    def train_batches(self, epoch: int = 0, skip: int = 0):
        """The epoch's shuffled batches, from its `skip`-th on (a resume
        inside an epoch skips the batches already trained on, unread)."""
        yield from self._batches(self.train_timestamps, self.train_batch_size, self.shuffle,
                                 epoch, skip)

    def val_batches(self):
        yield from self._batches(self.val_timestamps, self.val_batch_size, False, 0)

    def steps_per_epoch(self, split: str = "train") -> int:
        ts = self.train_timestamps if split == "train" else self.val_timestamps
        bs = self.train_batch_size if split == "train" else self.val_batch_size
        return len(ts) // bs

    def get_data_by_date(self, date) -> dict:
        """The one-sample batch of the hour `date` (`sample -d`)."""
        return self.assemble(np.array([parse_date(date)], dtype="datetime64[h]"))

    def inverse_transform(self, data: dict, months) -> dict:
        """De-normalize a dict of batches to Kelvin: 'LR' with the lr
        scalers, every other key (HR, SR, INF, ...) with the hr scalers."""
        months = np.asarray(months, np.int32)
        return {key: self.batch_scalers["lr" if key == "LR" else "hr"].inverse(val, months)
                for key, val in data.items()}
