"""Offline NetCDF -> per-hour .npy conversion, and the LMDB export (copy of
srewd_tpu/data/conversions.py).

`netcdf_to_npy` explodes NetCDF dataset(s) into the WeatherStore layout
(data/store.py) that DataHandler reads: every batch of timestamps (the
reference's converter wrote only the first), constant variables beside
the time-variate ones. `netcdf_to_lmdb` writes the reference exporter's
records: one per time step of each time-variate variable, keyed by the
timestamp as %Y-%m-%d-%H, the value the step's raw array bytes; a key
written twice raises. Nothing reads LMDB back; it exists for export parity.

xarray and lmdb are optional: they are imported inside the functions, which
raise ImportError naming the package when it is missing.
"""

from __future__ import annotations

import json
import os

import numpy as np

from .store import CONSTANT_FILE, META_DIR, META_FILE, SAMPLES_DIR
from .timeindex import format_date, parse_date


def netcdf_to_npy(
    source: str | list[str], target_dir: str, batch_size: int = 1024
) -> None:
    """Explode NetCDF dataset(s) into the WeatherStore on-disk layout."""
    try:
        import xarray as xr
    except ImportError as e:  # pragma: no cover
        raise ImportError("netcdf_to_npy requires xarray (not in this environment)") from e

    ds = xr.open_mfdataset(source) if isinstance(source, (list, tuple)) else xr.open_dataset(source)
    os.makedirs(target_dir, exist_ok=True)
    for var_name in ds.data_vars:
        var = ds[var_name]
        base = os.path.join(target_dir, str(var_name))
        os.makedirs(os.path.join(base, META_DIR), exist_ok=True)
        samples = os.path.join(base, SAMPLES_DIR)
        os.makedirs(samples, exist_ok=True)

        meta = {
            "name": str(var_name),
            "time_variate": "time" in var.dims,
            "dims": [d for d in var.dims if d != "time"],
            "shape": [
                int(n) for d, n in zip(var.dims, var.shape) if d != "time"
            ],
            "coords": [
                {
                    "name": str(k),
                    "values": np.asarray(ds.coords[k].values).tolist(),
                    "dims": [str(d) for d in ds.coords[k].dims],
                }
                for k in ds.coords
                if k != "time"
            ],
            "attrs": {**{k: str(v) for k, v in ds.attrs.items()},
                      **{k: str(v) for k, v in var.attrs.items()}},
        }
        with open(os.path.join(base, META_DIR, META_FILE), "w") as f:
            json.dump(meta, f)

        if "time" not in var.dims:
            np.save(os.path.join(samples, CONSTANT_FILE), var.values)
            continue

        stamps = var["time"].values
        t_axis = tuple(var.dims).index("time")
        n = len(stamps)
        for lo in range(0, n, batch_size):  # every batch
            chunk_ts = stamps[lo : lo + batch_size]
            chunk = var.isel(time=slice(lo, lo + len(chunk_ts))).values
            for i, ts in enumerate(chunk_ts):
                ts = parse_date(ts)
                year_dir = os.path.join(samples, str(ts.item().year))
                os.makedirs(year_dir, exist_ok=True)
                np.save(
                    os.path.join(year_dir, format_date(ts) + ".npy"),
                    np.take(chunk, i, axis=t_axis),
                )


def netcdf_to_lmdb(
    source: str | list[str],
    target_dir: str,
    map_size: float = 1e12,
    batch_size: int = 1024,
) -> int:
    """Export NetCDF dataset(s) into a timestamp-keyed LMDB database.

    Record semantics match the reference exporter exactly
    (netcdf_to_lmdb.py:70-88): for every time-variate variable, one record
    per time step with key = UTC timestamp formatted as the data-config
    datetime format (`%Y-%m-%d-%H`), value = the raw `tobytes()` of the
    per-step array. Time-invariant variables are skipped, as the reference's
    `if "time" in var_data.dims` does. Returns the record count.

    Improvements over the reference: steps stream in `batch_size` chunks
    instead of one `.sel()` per timestamp (one dask materialization per
    chunk), and duplicate keys across variables raise instead of silently
    overwriting (the reference keys records by timestamp ONLY, so a second
    variable clobbers the first — documented quirk, made loud here).
    """
    try:
        import lmdb
    except ImportError as e:  # pragma: no cover
        raise ImportError("netcdf_to_lmdb requires lmdb (not in this environment)") from e
    try:
        import xarray as xr
    except ImportError as e:  # pragma: no cover
        raise ImportError("netcdf_to_lmdb requires xarray (not in this environment)") from e

    ds = xr.open_mfdataset(source) if isinstance(source, (list, tuple)) else xr.open_dataset(source)
    env = lmdb.open(target_dir, map_size=int(map_size), writemap=True)
    written = 0
    try:
        for var_name in ds.data_vars:
            var = ds[var_name]
            if "time" not in var.dims:
                continue
            stamps = var["time"].values
            t_axis = tuple(var.dims).index("time")
            for lo in range(0, len(stamps), batch_size):
                chunk_ts = stamps[lo : lo + batch_size]
                chunk = np.asarray(
                    var.isel(time=slice(lo, lo + len(chunk_ts))).values
                )
                # one write txn per chunk: bounds dirty-page growth for
                # large exports (the reference commits per batch too,
                # netcdf_to_lmdb.py:66-84); duplicate detection still spans
                # the whole export since committed keys persist in the db
                with env.begin(write=True) as txn:
                    for i, ts in enumerate(chunk_ts):
                        key = format_date(parse_date(ts)).encode("utf-8")
                        if not txn.put(
                            key, np.take(chunk, i, axis=t_axis).tobytes(),
                            overwrite=False,
                        ):
                            raise ValueError(
                                f"duplicate LMDB key {key!r} (variable {var_name}): "
                                "the reference's timestamp-only keying overwrites "
                                "earlier variables; export one variable per database"
                            )
                        written += 1
    finally:
        env.close()
    return written
