"""The port's NetCDF conversions against the JAX package's, on the CPU.

xarray and lmdb are absent here, as on the card's machine: both packages are
stubbed as tests/test_errors_and_utils.py stubs them (a dataset of named
variables with dims, coords, attrs, `["time"].values` and `isel`; an LMDB
environment over a dict). `netcdf_to_npy` and `netcdf_to_lmdb` of the port
and of JAX write the same files and records byte for byte, and the port's
DataHandler reads the converted tree back; without the packages both raise
the same ImportError.
"""

import os
import sys
import types

import numpy as np
import pytest

from srewd_tpu.data import conversions as jax_conversions
from srewd_tpu_torch.data import conversions
from srewd_tpu_torch.data.pipeline import DataHandler

from test_errors_and_utils import _FakeEnv


class _Values:
    def __init__(self, values, dims=()):
        self.values = values
        self.dims = dims


class _Var:
    """An xarray.DataArray's surface that the converters read."""

    def __init__(self, dims, data, stamps=None, attrs=None):
        self.dims, self._data, self._stamps = tuple(dims), data, stamps
        self.shape, self.values, self.attrs = data.shape, data, attrs or {}

    def __getitem__(self, key):
        assert key == "time"
        return _Values(self._stamps, ("time",))

    def isel(self, time):
        return _Values(np.take(self._data, np.arange(len(self._stamps))[time],
                               axis=self.dims.index("time")))


class _Dataset:
    def __init__(self, variables: dict, coords: dict, attrs=None):
        self.data_vars = dict.fromkeys(variables)
        self._vars, self.coords, self.attrs = variables, coords, attrs or {}

    def __getitem__(self, key):
        return self._vars[key]


def dataset(h, w, n=30, seed=0, lmdb_only=False) -> _Dataset:
    rng = np.random.default_rng(seed)
    stamps = np.arange(np.datetime64("2016-12-31T20"), np.datetime64("2016-12-31T20") + n,
                       np.timedelta64(1, "h")).astype("datetime64[ns]")
    t2m = (280 + 5 * rng.standard_normal((n, h, w))).astype(np.float32)
    lat, lon = np.linspace(-90, 90, h), np.linspace(0, 360, w, endpoint=False)
    variables = {"t2m": _Var(("time", "lat", "lon"), t2m, stamps, {"units": "K"})}
    if not lmdb_only:
        variables["lsm"] = _Var(("lat", "lon"), rng.random((h, w)).astype(np.float32))
        variables["u10"] = _Var(("lat", "time", "lon"),  # time not the first axis
                                rng.standard_normal((h, n, w)).astype(np.float32), stamps)
    coords = {"time": _Values(stamps, ("time",)), "lat": _Values(lat, ("lat",)),
              "lon": _Values(lon, ("lon",))}
    return _Dataset(variables, coords, {"source": "synthetic"})


def install(monkeypatch, ds, store=None):
    fake_xr = types.ModuleType("xarray")
    fake_xr.open_dataset = lambda src: ds
    fake_xr.open_mfdataset = lambda src: ds
    monkeypatch.setitem(sys.modules, "xarray", fake_xr)
    if store is not None:
        fake_lmdb = types.ModuleType("lmdb")
        fake_lmdb.open = lambda path, map_size=0, writemap=False: _FakeEnv(store)
        monkeypatch.setitem(sys.modules, "lmdb", fake_lmdb)


def tree_bytes(root) -> dict:
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            path = os.path.join(dirpath, n)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


@pytest.mark.parametrize("batch_size", [7, 1024])
def test_netcdf_to_npy_writes_what_jax_writes(monkeypatch, tmp_path, batch_size):
    install(monkeypatch, dataset(4, 8))
    jax_conversions.netcdf_to_npy("in.nc", str(tmp_path / "jax"), batch_size=batch_size)
    conversions.netcdf_to_npy(["a.nc", "b.nc"], str(tmp_path / "port"), batch_size=batch_size)
    want, got = tree_bytes(tmp_path / "jax"), tree_bytes(tmp_path / "port")
    assert sorted(got) == sorted(want)
    assert len(want) == 3 + 2 * 30 + 1  # a metadata.json each, 30 steps of two, a constant
    for k in want:
        assert got[k] == want[k], k


def test_the_converted_tree_reads_back_through_the_ports_data_handler(monkeypatch, tmp_path):
    for kind, (h, w), seed in (("hr", (16, 32), 1), ("lr", (4, 8), 2)):
        ds = dataset(h, w, seed=seed)
        install(monkeypatch, ds)
        conversions.netcdf_to_npy("in.nc", str(tmp_path / kind))
    dh = DataHandler(dataroot=str(tmp_path), variables=["t2m", "u10"], months_subset=[1],
                     train_min_date="2017-01-01-00", train_max_date="2017-01-01-12",
                     val_min_date="2017-01-01-12", val_max_date="2017-01-02-02",
                     train_batch_size=4, val_batch_size=2, read_threads=2).process_data()
    assert len(dh.train_timestamps) == 12 and len(dh.val_timestamps) == 14
    batch = dh.assemble(dh.val_timestamps[:2], normalized=False)
    hr = dataset(16, 32, seed=1)
    i = 16  # 2017-01-01-12 is 16 steps after 2016-12-31-20
    np.testing.assert_array_equal(batch["HR"][..., 0], hr["t2m"].values[i:i + 2])
    np.testing.assert_array_equal(batch["HR"][..., 1],
                                  np.moveaxis(hr["u10"].values, 1, 0)[i:i + 2])
    assert batch["LR"].shape == (2, 4, 8, 2) and batch["months"].tolist() == [1, 1]
    assert np.isfinite(next(iter(dh.train_batches(epoch=1)))["HR"]).all()


@pytest.mark.parametrize("batch_size", [3, 1024])
def test_netcdf_to_lmdb_writes_what_jax_writes(monkeypatch, tmp_path, batch_size):
    stores = []
    for mod in (jax_conversions, conversions):
        store = {}
        install(monkeypatch, dataset(2, 3, n=5, lmdb_only=True), store)
        assert mod.netcdf_to_lmdb("in.nc", str(tmp_path / "db"), batch_size=batch_size) == 5
        stores.append(store)
    assert stores[1] == stores[0]
    assert sorted(stores[1])[0] == b"2016-12-31-20"


def test_duplicate_lmdb_keys_raise_as_in_jax(monkeypatch, tmp_path):
    store = {}
    install(monkeypatch, dataset(2, 3, n=2), store)  # t2m and u10 share timestamps
    with pytest.raises(ValueError, match="duplicate LMDB key"):
        conversions.netcdf_to_lmdb("in.nc", str(tmp_path / "db"))


@pytest.mark.parametrize("fn,package", [("netcdf_to_npy", "xarray"),
                                        ("netcdf_to_lmdb", "lmdb")])
def test_missing_packages_raise_the_same_error(monkeypatch, tmp_path, fn, package):
    monkeypatch.setitem(sys.modules, "xarray", None)
    monkeypatch.setitem(sys.modules, "lmdb", None)
    errors = []
    for mod in (jax_conversions, conversions):
        with pytest.raises(ImportError, match=package) as e:
            getattr(mod, fn)("in.nc", str(tmp_path / "out"))
        errors.append(str(e.value))
    assert errors[1] == errors[0]
