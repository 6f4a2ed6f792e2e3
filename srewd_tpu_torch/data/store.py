"""WeatherStore: reader for the WeatherBench per-hour .npy layout, and the
synthetic tree generator (copy of srewd_tpu/data/store.py).

On-disk contract:

    <dataroot>/<lr|hr>/<variable>/
        meta/metadata.json     {name, time_variate, dims, shape, coords, attrs}
        samples/<year>/<YYYY-MM-DD-HH>.npy     (time-variate)
        samples/constant.npy                   (constant fields, e.g. orography)

Reads return NHWC float32 numpy ([H,W,C] per sample); `read_many` reads a
batch through the native reader (srewd_tpu_torch.native) or a thread pool.
The hourly completeness of a variable's samples is checked on open.
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from datetime import datetime

import numpy as np

from .timeindex import DATETIME_FORMAT, HOUR, format_date, hourly_range, months_of, parse_date

META_DIR = "meta"
META_FILE = "metadata.json"
SAMPLES_DIR = "samples"
CONSTANT_FILE = "constant.npy"


class WeatherStore:
    """Read one WeatherBench variable directory."""

    def __init__(self, path: str, domain_dimension: int = 2):
        if not os.path.isdir(path):
            raise FileNotFoundError(f"<{path}> is not a directory")
        self.path = os.path.abspath(path)
        self.domain_dimension = domain_dimension
        meta_path = os.path.join(self.path, META_DIR, META_FILE)
        if not os.path.isfile(meta_path):
            raise FileNotFoundError(f"missing {meta_path}")
        with open(meta_path) as f:
            self.meta_data = json.load(f)
        self.name = self.meta_data["name"]
        self.time_variate = bool(self.meta_data["time_variate"])
        self._constant = None
        self.timestamps = None
        self._scan_samples()

    def _scan_samples(self) -> None:
        samples = os.path.join(self.path, SAMPLES_DIR)
        if not self.time_variate:
            self._constant = self._to_nhwc(np.load(os.path.join(samples, CONSTANT_FILE)))
            return
        stamps = []
        for sub in sorted(os.listdir(samples)):
            subdir = os.path.join(samples, sub)
            if not os.path.isdir(subdir):
                continue
            for f in os.listdir(subdir):
                if not f.endswith(".npy") or f.count(".") != 1:
                    continue
                try:
                    ts = np.datetime64(datetime.strptime(f[:-4], DATETIME_FORMAT))
                except ValueError:
                    continue
                stamps.append(ts.astype("datetime64[h]"))
        if not stamps:
            raise FileNotFoundError(f"no samples under {samples}")
        ts = np.sort(np.array(stamps, dtype="datetime64[h]"))
        expected = int((ts[-1] - ts[0]) / HOUR) + 1
        if len(ts) != expected or not np.all(np.diff(ts) == HOUR):
            raise ValueError(f"missing hourly samples under {samples}")
        self.timestamps = ts

    def _sample_path(self, ts: np.datetime64) -> str:
        d = ts.astype("datetime64[h]").item()
        return os.path.join(self.path, SAMPLES_DIR, str(d.year), format_date(ts) + ".npy")

    def _to_nhwc(self, data: np.ndarray) -> np.ndarray:
        """raw array -> [H, W, C] float32 (leading dims flattened to channels)."""
        if data.ndim == self.domain_dimension:
            return np.ascontiguousarray(data[..., None], dtype=np.float32)
        lead = int(np.prod(data.shape[: -self.domain_dimension]))
        h, w = data.shape[-2:]
        chw = data.reshape(lead, h, w)
        return np.ascontiguousarray(np.transpose(chw, (1, 2, 0)), dtype=np.float32)

    @property
    def channels(self) -> int:
        count = 1
        for n in self.meta_data["shape"][: -self.domain_dimension]:
            count *= int(n)
        return count

    @property
    def spatial_shape(self) -> tuple[int, int]:
        return tuple(int(n) for n in self.meta_data["shape"][-2:])

    def read(self, ts) -> np.ndarray:
        """One sample [H,W,C] float32 by timestamp (or the constant field)."""
        if not self.time_variate:
            return self._constant
        return self._to_nhwc(np.load(self._sample_path(parse_date(ts))))

    def read_many(self, ts_array, num_threads: int = 16) -> np.ndarray:
        """Bulk read -> [N,H,W,C] float32, through the native reader where it
        takes the files, else a numpy thread pool (same values either way)."""
        if not self.time_variate:
            return np.broadcast_to(self._constant, (len(ts_array),) + self._constant.shape)
        ts_array = np.asarray(ts_array, dtype="datetime64[h]")
        if len(ts_array) == 0:
            h, w = self.spatial_shape
            return np.empty((0, h, w, self.channels), np.float32)

        raw_shape = tuple(int(n) for n in self.meta_data["shape"])
        if len(ts_array) > 1 and len(raw_shape) >= self.domain_dimension:
            from .. import native

            batch = native.read_batch(
                [self._sample_path(t) for t in ts_array], raw_shape, num_threads
            )
            if batch is not None:
                if len(raw_shape) == self.domain_dimension:
                    return batch[..., None]
                n = batch.shape[0]
                lead = int(np.prod(raw_shape[: -self.domain_dimension]))
                h, w = raw_shape[-2:]
                chw = batch.reshape(n, lead, h, w)
                return np.ascontiguousarray(np.transpose(chw, (0, 2, 3, 1)))

        if len(ts_array) == 1 or num_threads <= 1:
            return np.stack([self.read(t) for t in ts_array])
        with ThreadPoolExecutor(max_workers=num_threads) as pool:
            return np.stack(list(pool.map(self.read, ts_array)))


def _write_meta(base: str, variable: str, time_variate: bool, shape, lat, lon, attrs) -> None:
    os.makedirs(os.path.join(base, META_DIR), exist_ok=True)
    os.makedirs(os.path.join(base, SAMPLES_DIR), exist_ok=True)
    meta = {
        "name": variable,
        "time_variate": time_variate,
        "dims": ["lat", "lon"],
        "shape": [int(shape[0]), int(shape[1])],
        "coords": [
            {"name": "lat", "values": np.asarray(lat).tolist(), "dims": ["lat"]},
            {"name": "lon", "values": np.asarray(lon).tolist(), "dims": ["lon"]},
        ],
        "attrs": attrs or {},
    }
    with open(os.path.join(base, META_DIR, META_FILE), "w") as f:
        json.dump(meta, f)


def write_variable(root: str, variable: str, data: np.ndarray, timestamps,
                   lat: np.ndarray, lon: np.ndarray, attrs: dict | None = None) -> None:
    """Write [N,H,W] (or [N,H,W,1]) hourly fields in the store layout."""
    base = os.path.join(root, variable)
    if data.ndim == 4:
        data = data[..., 0]
    _write_meta(base, variable, True, data.shape[1:], lat, lon, attrs)
    for ts, field in zip(timestamps, data):
        ts = parse_date(ts)
        year_dir = os.path.join(base, SAMPLES_DIR, str(ts.item().year))
        os.makedirs(year_dir, exist_ok=True)
        np.save(os.path.join(year_dir, format_date(ts) + ".npy"), field.astype(np.float32))


def write_constant_variable(root: str, variable: str, data: np.ndarray, lat: np.ndarray,
                            lon: np.ndarray, attrs: dict | None = None) -> None:
    """Write one constant [H,W] field (e.g. orography) in the store layout."""
    if data.ndim == 3:
        data = data[..., 0]
    base = os.path.join(root, variable)
    _write_meta(base, variable, False, data.shape, lat, lon, attrs)
    np.save(os.path.join(base, SAMPLES_DIR, CONSTANT_FILE), data.astype(np.float32))


def _powerlaw_fields(rng: np.random.Generator, n: int, h: int, w: int, alpha: float,
                     cutoff: float) -> np.ndarray:
    """[n,h,w] unit-variance random fields with an isotropic power-law spectrum,
    (|k| + k0)^-alpha band-limited to |k| <= cutoff (cycles/pixel)."""
    ky = np.fft.fftfreq(h)[:, None]
    kx = np.fft.rfftfreq(w)[None, :]
    k = np.hypot(ky, kx)
    k0 = 1.0 / max(h, w)
    amp = np.where((k > 0) & (k <= cutoff), (k + k0) ** (-alpha / 2.0), 0.0)
    out = np.empty((n, h, w), np.float32)
    for i0 in range(0, n, 256):  # chunked: bounds FFT scratch memory
        white = rng.standard_normal((min(256, n - i0), h, w))
        f = np.fft.irfft2(np.fft.rfft2(white) * amp, s=(h, w))
        f /= f.std(axis=(1, 2), keepdims=True)
        out[i0 : i0 + f.shape[0]] = f.astype(np.float32)
    return out


def make_synthetic_weatherbench(
    root: str,
    min_date: str = "2017-01-01-00",
    max_date: str = "2017-01-03-00",
    variables=("t2m",),
    lr_shape: tuple[int, int] = (32, 64),
    hr_shape: tuple[int, int] = (128, 256),
    seed: int = 0,
    base_kelvin: float = 285.0,
    constants: tuple = (),
    spectrum: str = "tiles",
) -> str:
    """Generate a synthetic WeatherBench tree for tests and on-card runs.

    LR is the exact 4x block-mean of HR. `spectrum`: "tiles" puts 16x16-px
    texture tiles on a smooth planetary pattern with seasonal and diurnal
    terms; "t2m" uses a red power-law anomaly field (~k^-3) plus
    tanh-sharpened fronts, both band-limited to the LR Nyquist, so the HR
    detail is a function of LR-resolvable structure. `constants` names extra
    time-invariant variables written as single constant fields. A tree made
    with the same parameters is reused.
    """
    spec = json.dumps({
        "min": min_date, "max": max_date, "variables": list(variables),
        "lr": list(lr_shape), "hr": list(hr_shape), "seed": seed,
        "base": base_kelvin, "constants": list(constants), "spectrum": spectrum,
    }, sort_keys=True)
    marker = os.path.join(root, ".synthetic_spec.json")
    if os.path.exists(marker):
        with open(marker) as f:
            if f.read() == spec:
                return root

    rng = np.random.default_rng(seed)
    ts = hourly_range(min_date, max_date)
    n = len(ts)
    hh, hw = hr_shape
    lh, lw = lr_shape
    months = months_of(ts).astype(np.float32)

    yy = np.linspace(0, np.pi, hh)[None, :, None]
    xx = np.linspace(0, 2 * np.pi, hw)[None, None, :]
    season = 10.0 * np.cos((months[:, None, None] - 7.0) / 12.0 * 2 * np.pi)
    hours = (ts.astype("datetime64[h]").astype(int) % 24).astype(np.float32)
    diurnal = 3.0 * np.sin(hours / 24.0 * 2 * np.pi)[:, None, None]
    if spectrum == "tiles":
        smooth = rng.standard_normal((n, 8, 16)).astype(np.float32)
        texture = 2.0 * np.kron(smooth, np.ones((1, hh // 8, hw // 16), np.float32))
    elif spectrum == "t2m":
        cutoff = 0.5 * (lh / hh)  # LR Nyquist in HR cycles/pixel
        anomaly = _powerlaw_fields(rng, n, hh, hw, alpha=3.0, cutoff=cutoff)
        fronts = _powerlaw_fields(rng, n, hh, hw, alpha=2.0, cutoff=cutoff)
        texture = 3.0 * anomaly + 2.0 * np.tanh(fronts / 0.35)
    else:
        raise ValueError(f"unknown synthetic spectrum {spectrum!r}")
    hr = (
        base_kelvin + 20.0 * np.sin(yy) * np.cos(xx / 2) + season + diurnal + texture
    ).astype(np.float32)
    lr = hr.reshape(n, lh, hh // lh, lw, hw // lw).mean(axis=(2, 4))

    lat_hr = np.linspace(-90, 90, hh)
    lon_hr = np.linspace(0, 360, hw, endpoint=False)
    lat_lr = np.linspace(-90, 90, lh)
    lon_lr = np.linspace(0, 360, lw, endpoint=False)
    for var in variables:
        write_variable(os.path.join(root, "hr"), var, hr, ts, lat_hr, lon_hr)
        write_variable(os.path.join(root, "lr"), var, lr, ts, lat_lr, lon_lr)
    for var in constants:
        const_hr = (1000.0 * np.abs(np.sin(yy[0] * 2) * np.cos(xx[0]))).astype(np.float32)
        const_lr = const_hr.reshape(lh, hh // lh, lw, hw // lw).mean(axis=(1, 3))
        write_constant_variable(os.path.join(root, "hr"), var, const_hr, lat_hr, lon_hr)
        write_constant_variable(os.path.join(root, "lr"), var, const_lr, lat_lr, lon_lr)
    with open(marker, "w") as f:
        f.write(spec)
    return root
