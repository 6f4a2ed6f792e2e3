"""The port's PNG renders against matplotlib and the JAX package, on the CPU.

Every colour table of `training/colormaps.py` and `apply` byte for byte
against the JAX package's `CMAPS` (matplotlib's colormaps) and
`cmap(Normalize(vmin, vmax)(field), bytes=True)`, under, over, bad and
x == 1 included; the PNG writer read back by itself and by PIL; every
`ImageContainer` product of the port against JAX's `ImageContainer` on the
same fields: the same file names, and each panel's pixels equal, byte for
byte, to what matplotlib's colormap gives the field, range and map that
JAX's figure holds for that panel (its AxesImage: array, norm, cmap,
origin); and the WandbLogger's calls against JAX's through a fake `wandb`.
"""

import json
import os
import sys
import types

import matplotlib
import matplotlib.figure
import numpy as np
import pytest
from matplotlib.colors import Normalize
from PIL import Image

from srewd_tpu.training.visualization import CMAPS as JAX_CMAPS
from srewd_tpu.training.visualization import ImageContainer as JaxImageContainer
from srewd_tpu.utils.wandb_logger import WandbLogger as JaxWandbLogger
from srewd_tpu_torch.training import colormaps
from srewd_tpu_torch.training.visualization import ImageContainer, crop, read_plate
from srewd_tpu_torch.utils.png import read_png, write_png
from srewd_tpu_torch.utils.wandb_logger import WandbLogger


# ------------------------------------------------------------------ colormaps
@pytest.mark.parametrize("name", sorted(JAX_CMAPS))
def test_table_equals_matplotlibs(name):
    cm = JAX_CMAPS[name]
    cm._init()
    want = (cm._lut * 255).astype(np.uint8)
    got = colormaps.CMAPS[name]
    assert got.N == cm.N
    np.testing.assert_array_equal(got.lut, want)


@pytest.mark.parametrize("name", sorted(JAX_CMAPS))
def test_apply_equals_matplotlibs_colouring(name):
    rng = np.random.default_rng(0)
    cm = colormaps.CMAPS[name]
    for dtype in (np.float32, np.float64):
        f = (rng.standard_normal((24, 40)) * 30 + 270).astype(dtype)
        f[0, 0], f[0, 1], f[0, 2] = np.nan, 315.0, 220.0  # bad, x == 1, x == 0
        f[1, :3] = (1e4, -1e4, 267.5)
        for vmin, vmax in ((220, 315), (float(np.nanmin(f[2:])), float(np.nanmax(f[2:]))),
                           (260.3, 280.7), (-25.0, 25.0), (5.0, 5.0)):
            want = JAX_CMAPS[name](Normalize(vmin, vmax)(f), bytes=True)
            np.testing.assert_array_equal(colormaps.apply(cm, f, vmin, vmax), want,
                                          err_msg=f"{dtype.__name__} [{vmin}, {vmax}]")


# ------------------------------------------------------------------------ PNG
@pytest.mark.parametrize("channels", [3, 4])
def test_png_round_trip_and_pil_agree(tmp_path, channels):
    pixels = np.random.default_rng(1).integers(0, 256, (9, 13, channels), dtype=np.uint8)
    text = {"Title": "SR / HR", "layout": json.dumps({"panels": [1, 2]})}
    path = write_png(str(tmp_path / "x.png"), pixels, text)
    got, got_text = read_png(path)
    np.testing.assert_array_equal(got, pixels)
    assert got_text == text
    with Image.open(path) as im:
        assert im.mode == ("RGB" if channels == 3 else "RGBA")
        np.testing.assert_array_equal(np.asarray(im), pixels)
        assert im.text == text


def test_png_refuses_what_it_cannot_write(tmp_path):
    with pytest.raises(ValueError, match="uint8"):
        write_png(str(tmp_path / "x.png"), np.zeros((4, 4, 2), np.uint8))
    with pytest.raises(ValueError, match="uint8"):
        write_png(str(tmp_path / "x.png"), np.zeros((4, 4, 3), np.float32))


# ------------------------------------------------------------- ImageContainer
def visuals(seed=2, n=2, h=16, w=32) -> dict:
    rng = np.random.default_rng(seed)
    hr = (270 + 30 * rng.standard_normal((n, h, w, 1))).astype(np.float32)
    return {"SR": (hr + 8 * rng.standard_normal(hr.shape)).astype(np.float32), "HR": hr,
            "LR": hr.reshape(n, h // 4, 4, w // 4, 4, 1).mean(axis=(2, 4)),
            "INF": (hr + 4 * rng.standard_normal(hr.shape)).astype(np.float32)}


@pytest.fixture
def drawn(monkeypatch):
    """Every figure JAX saves: its panels' AxesImage (array, norm, cmap,
    origin) and titles, in axes order, by file name."""
    seen = {}
    orig = matplotlib.figure.Figure.savefig

    def savefig(fig, path, *args, **kwargs):
        seen[os.path.basename(str(path))] = panels_of(fig)
        return orig(fig, path, *args, **kwargs)

    monkeypatch.setattr(matplotlib.figure.Figure, "savefig", savefig)
    return seen


def panels_of(fig) -> list:
    return [{"title": ax.get_title(), "im": im} for ax in fig.axes for im in ax.images]


def assert_plate_matches(path: str, jax_panels: list, titles: bool = True):
    """The port's plate at `path` holds one panel per JAX panel, each equal
    to matplotlib's colouring of the field JAX drew, in JAX's orientation."""
    pixels, layout = read_plate(path)
    assert len(layout["panels"]) == len(jax_panels) > 0
    for box, jp in zip(layout["panels"], jax_panels):
        im = jp["im"]
        want = im.cmap(im.norm(im.get_array()), bytes=True)
        got = crop(pixels, box)
        assert box["origin"] == im.origin
        if im.origin == "lower":
            got = got[::-1]
        np.testing.assert_array_equal(got, want, err_msg=f"{path} {box['key']}")
        assert (box["vmin"], box["vmax"]) == pytest.approx((im.norm.vmin, im.norm.vmax))
        if titles:
            assert box["title"] == jp["title"]
    for bar in layout["colorbars"]:
        assert crop(pixels, bar).shape == (pixels.shape[0], 12, 4)


CASES = [  # (case, range, image_types, cmap, files: 2 samples per type drawn)
    ("defaults", None, None, None, 14),
    ("fixed_range_viridis", (220, 315),
     ["SR", "HR", "INTERPOLATED", "DELTA", "AE", "AE_INTER", "LR", "NOPE"], "viridis", 14),
    ("unknown_cmap", None, ["SR", "RESIDUALS", "ABS_INTERPOLATED"], "no_such_map", 6),
]


@pytest.mark.parametrize("case,vrange,types_,cmap,files", CASES, ids=[c[0] for c in CASES])
def test_save_all_images_matches_jax(tmp_path, drawn, case, vrange, types_, cmap, files):
    v = visuals()
    jax_c, port_c = JaxImageContainer(v, n_images=2), ImageContainer(v, n_images=2)
    if vrange:
        jax_c.set_min_max(*vrange)
        port_c.set_min_max(*vrange)
    want = jax_c.save_all_images(str(tmp_path / "jax" / "2017"), image_types=types_, cmap=cmap)
    got = port_c.save_all_images(str(tmp_path / "port" / "2017"), image_types=types_, cmap=cmap)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    assert len(got) == files
    for path in got:
        assert_plate_matches(path, drawn[os.path.basename(path)], titles=False)


@pytest.mark.parametrize("idx,cmap", [(0, None), (1, "heat_muted")])
def test_it_sr_hr_plate_matches_jax(tmp_path, drawn, idx, cmap):
    v = visuals(3)
    fig = JaxImageContainer(v).make_wandb_plot(idx=idx, cmap=cmap)
    port = ImageContainer(v)
    plate = port.it_sr_hr_plate(idx=idx, cmap=cmap)
    path = plate.save(str(tmp_path / "plate.png"))
    assert_plate_matches(path, panels_of(fig))
    rgb = port.make_wandb_plot(idx=idx, cmap=cmap)
    assert rgb.dtype == np.uint8 and rgb.shape == plate.pixels.shape[:2] + (3,)
    np.testing.assert_array_equal(rgb, plate.pixels[..., :3])
    if idx == 0:
        want = JaxImageContainer(v).save_it_sr_hr_plot(str(tmp_path / "jax_it"))
        got = port.save_it_sr_hr_plot(str(tmp_path / "port_it"))
        assert os.path.basename(got) == "port_it.png" and want.endswith("jax_it.png")
        assert_plate_matches(got, drawn["jax_it.png"])


@pytest.mark.parametrize("product,kwargs", [
    ("save_sr_hr_plot", {}), ("save_sr_hr_plot", {"cmap": "plasma", "idx": 0}),
    ("save_sr_hr_abs_plot", {}), ("save_tensor_it_sr_hr_plot", {}),
    ("save_residual_mask", {"threshold": 5.0}), ("save_residual_mask", {"idx": 1})])
def test_products_match_jax(tmp_path, drawn, product, kwargs):
    v = visuals(4)
    want = getattr(JaxImageContainer(v), product)(str(tmp_path / "jax"), **kwargs)
    got = getattr(ImageContainer(v), product)(str(tmp_path / "port"), **kwargs)
    name = os.path.basename(want)
    assert os.path.basename(got) == name.replace("jax", "port", 1)
    assert_plate_matches(got, drawn[name])


def test_residual_and_abs_maps_and_ranges_match_jax():
    v = visuals(5)
    jax_c, port_c = JaxImageContainer(v), ImageContainer(v)
    assert list(port_c.visuals) == list(jax_c.visuals)
    for key in port_c.visuals:
        np.testing.assert_array_equal(port_c.visuals[key], jax_c.visuals[key])
        assert port_c._range_for(key) == jax_c._range_for(key)
        for name in (None, "gray", "nope"):
            assert port_c._cmap_for(key, name).name == jax_c._cmap_for(key, name).name


# ---------------------------------------------------------------------- wandb
class _FakeWandb(types.ModuleType):
    def __init__(self):
        super().__init__("wandb")
        self.calls = []

    def init(self, **kw):
        self.calls.append(("init", kw["project"], kw["entity"], kw["reinit"]))

    def log(self, data, commit=None, step=None):
        self.calls.append(("log", {k: (v.kind if isinstance(v, _Img) else v)
                                   for k, v in data.items()}, commit, step))

    def Image(self, x):  # noqa: N802 (wandb's name)
        return _Img(x)


class _Img:
    def __init__(self, x):
        self.x = x
        self.kind = "image"


def _drive_logger(logger, image):
    logger.log_metrics({"epoch": 1}, step=3)
    logger.log_train_metrics({"l_pix": 0.5}, step=3)
    logger.log_train_mean_metrics({"l_pix": 0.4}, commit=True, step=3)
    logger.log_val_metrics({"RMSE": 1.5, "MAE": 1.0}, step=4)
    logger.log_val_time(2.5, step=4)
    logger.log_sr_hr_it_image(image, step=4)
    logger.commit(step=5)


def test_wandb_logger_logs_what_jax_logs(monkeypatch):
    v = visuals(6)
    opt = {"wandb": {"project": "p", "entity": "e"}, "name": "x"}
    fakes = []
    for cls, image in ((JaxWandbLogger, JaxImageContainer(v).make_wandb_plot()),
                       (WandbLogger, ImageContainer(v).make_wandb_plot())):
        fake = _FakeWandb()
        monkeypatch.setitem(sys.modules, "wandb", fake)
        logger = cls(opt, enabled=True)
        assert logger.enabled
        _drive_logger(logger, image)
        fakes.append(fake)
    assert fakes[1].calls == fakes[0].calls
    logged = [c for c in fakes[1].calls if c[0] == "log" and "val/sr_hr_it" in c[1]]
    assert len(logged) == 1


def test_wandb_logger_starts_where_jaxs_does(monkeypatch):
    """A config's `wandb` section starts both loggers with the same init;
    enabled=False starts neither, and then wandb is not imported."""
    opt = {"wandb": {"project": "p", "entity": None}}
    monkeypatch.delitem(sys.modules, "wandb", raising=False)
    for cls in (JaxWandbLogger, WandbLogger):
        assert not cls(opt, enabled=False).enabled
    assert "wandb" not in sys.modules
    fakes = []
    for cls in (JaxWandbLogger, WandbLogger):
        fake = _FakeWandb()
        monkeypatch.setitem(sys.modules, "wandb", fake)
        assert cls(opt).enabled
        fakes.append(fake.calls)
    assert fakes[0] == fakes[1] == [("init", "p", None, True)]


def test_wandb_logger_is_a_no_op_without_the_package_or_the_section(monkeypatch):
    fake = _FakeWandb()
    monkeypatch.setitem(sys.modules, "wandb", fake)
    for opt, enabled in (({}, None), ({"wandb": {"project": "p"}}, False)):
        for cls in (JaxWandbLogger, WandbLogger):
            logger = cls(opt, enabled=enabled)
            assert not logger.enabled
            _drive_logger(logger, np.zeros((2, 2, 3), np.uint8))
    assert fake.calls == []
    monkeypatch.setitem(sys.modules, "wandb", None)  # import raises ImportError
    for cls in (JaxWandbLogger, WandbLogger):
        assert not cls({"wandb": {"project": "p"}}, enabled=True).enabled
