"""ImageContainer: map renders of SR / HR / LR / error fields as PNG plates
(port of srewd_tpu/training/visualization.py, without matplotlib).

The products, their file names, value ranges and colormaps are the JAX
package's; the drawing is not. Each panel is the field at its native
resolution, one pixel per grid point, coloured by `colormaps.apply` (byte
for byte what matplotlib's colormap gives the same field and range) and
flipped so that row 0 is at the bottom (`origin="lower"`; the raw-tensor
plates keep row 0 at the top, as JAX draws them). Panels sit side by side
on a white canvas, GAP columns apart, each product with its colour-bar
strips (BAR columns, the map from vmin at the bottom to vmax at the top).
There is no font renderer: the titles, each panel's value range and
colormap, and where each panel and bar sits go into the PNG's tEXt chunks
("Title", and "layout" as JSON), which `read_plate` returns. No coastlines
are drawn (JAX draws them only with cartopy).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..utils.png import read_png, write_png
from .colormaps import CMAPS, Colormap, apply

# DELTA uses abs_color at the fixed [-25, 25]; the AE maps ae_color at [0, 21]
_DELTA_RANGE = (-25.0, 25.0)
_AE_RANGE = (0.0, 21.0)
GAP = 4  # white columns after each panel and bar
BAR = 12  # columns of a colour-bar strip
_WHITE = np.array([255, 255, 255, 255], np.uint8)


@dataclass
class Plate:
    """A rendered product: RGBA pixels and the layout of its panels and bars."""
    pixels: np.ndarray  # uint8 [H, W, 4]
    layout: dict

    @property
    def rgb(self) -> np.ndarray:
        return self.pixels[..., :3]

    def save(self, path: str) -> str:
        return write_png(path, self.pixels, {
            "Title": self.layout["title"], "Software": "srewd_tpu_torch",
            "layout": json.dumps(self.layout)})


def read_plate(path: str) -> tuple:
    """(RGBA pixels, layout) of a plate written by Plate.save."""
    pixels, text = read_png(path)
    return pixels, json.loads(text["layout"])


def crop(pixels: np.ndarray, box: dict) -> np.ndarray:
    """The pixels of one panel or bar of a layout, as stored (flipped where
    its origin is "lower")."""
    return pixels[box["y"]:box["y"] + box["h"], box["x"]:box["x"] + box["w"]]


def _bar_values(h: int, vmin: float, vmax: float) -> np.ndarray:
    """One value per row, vmax at the top row and vmin at the bottom one."""
    return vmax - (np.arange(h) + 0.5) * ((vmax - vmin) / h)


def compose(title: str, panels: list, bars: str = "shared", ticks=None) -> Plate:
    """A plate of `panels` side by side: each {"key", "title", "field" (2-D),
    "vmin", "vmax", "cmap" (Colormap), "origin"}. `bars`: "shared" draws one
    colour bar after the last panel (the first panel's map and range),
    "each" one after every panel."""
    h = max(p["field"].shape[0] for p in panels)
    blocks, boxes, bar_boxes, x = [], [], [], 0

    def add(img: np.ndarray, meta: dict, into: list) -> None:
        nonlocal x
        block = np.empty((h, img.shape[1] + GAP, 4), np.uint8)
        block[:] = _WHITE
        block[:img.shape[0], :img.shape[1]] = img
        blocks.append(block)
        into.append({**meta, "x": x, "y": 0, "w": int(img.shape[1]), "h": int(img.shape[0])})
        x += block.shape[1]

    def add_bar(p: dict) -> None:
        col = apply(p["cmap"], _bar_values(h, p["vmin"], p["vmax"]), p["vmin"], p["vmax"])
        add(np.repeat(col[:, None, :], BAR, axis=1),
            {"vmin": p["vmin"], "vmax": p["vmax"], "cmap": p["cmap"].name, "ticks": ticks},
            bar_boxes)

    for p in panels:
        img = apply(p["cmap"], p["field"], p["vmin"], p["vmax"])
        if p["origin"] == "lower":
            img = img[::-1]
        add(img, {"key": p["key"], "title": p["title"], "vmin": p["vmin"], "vmax": p["vmax"],
                  "cmap": p["cmap"].name, "origin": p["origin"]}, boxes)
        if bars == "each":
            add_bar(p)
    if bars == "shared":
        add_bar(panels[0])
    pixels = np.concatenate(blocks, axis=1)[:, :-GAP]
    return Plate(np.ascontiguousarray(pixels),
                 {"title": title, "panels": boxes, "colorbars": bar_boxes})


def _png(path: str) -> str:
    return path if path.endswith(".png") else path + ".png"


class ImageContainer:
    """Holds a dict of NHWC field batches; renders products.

    visuals keys: SR, HR, LR, INF (interpolated); derived (the reference's
    compute_residual_mask): RESIDUALS (SR - HR), RESIDUALS_INTERPOLATED
    (INF - HR), ABS_RESIDUALS, ABS_INTERPOLATED, with RESIDUAL / ABS_ERROR
    as aliases of the first and third. `metadata` is kept for the JAX
    signature (JAX reads its coordinates only to draw coastlines).
    """

    def __init__(self, visuals: dict, metadata: Optional[dict] = None, n_images: int = 1):
        self.visuals = {k: np.asarray(v) for k, v in visuals.items()}
        if "SR" in self.visuals and "HR" in self.visuals:
            res = self.visuals["SR"] - self.visuals["HR"]
            self.visuals["RESIDUALS"] = res
            self.visuals["ABS_RESIDUALS"] = np.abs(res)
            self.visuals["RESIDUAL"] = res
            self.visuals["ABS_ERROR"] = np.abs(res)
            if "INF" in self.visuals:
                res_i = self.visuals["INF"] - self.visuals["HR"]
                self.visuals["RESIDUALS_INTERPOLATED"] = res_i
                self.visuals["ABS_INTERPOLATED"] = np.abs(res_i)
        self.metadata = metadata or {}
        self.n_images = n_images
        self.vmin = None
        self.vmax = None

    def set_min_max(self, vmin: float, vmax: float) -> None:
        """A fixed colour range (the sample CLI and `train -p val` take
        [220, 315] K)."""
        self.vmin, self.vmax = vmin, vmax

    _RESIDUAL_KEYS = ("RESIDUAL", "RESIDUALS", "RESIDUALS_INTERPOLATED")
    _ABS_KEYS = ("ABS_ERROR", "ABS_RESIDUALS", "ABS_INTERPOLATED")

    def _range_for(self, key: str) -> tuple:
        if key in self._RESIDUAL_KEYS:
            m = float(np.abs(self.visuals[key]).max()) or 1.0
            return -m, m
        if key in self._ABS_KEYS:
            return 0.0, float(self.visuals[key].max()) or 1.0
        if self.vmin is not None:
            return self.vmin, self.vmax
        # one range over all the main fields
        vals = [v for k, v in self.visuals.items() if k in ("SR", "HR", "INF")]
        if not vals:
            vals = list(self.visuals.values())
        return float(min(v.min() for v in vals)), float(max(v.max() for v in vals))

    def _cmap_for(self, key: str, cmap_name: Optional[str]) -> Colormap:
        if cmap_name is not None and cmap_name in CMAPS:
            return CMAPS[cmap_name]
        if key in self._RESIDUAL_KEYS:
            return CMAPS["abs_color"]
        if key in self._ABS_KEYS:
            return CMAPS["ae_color"]
        return CMAPS["heat_vibrant"]

    def _panel(self, field: np.ndarray, key: str, title: str, cmap_name=None, vrange=None,
               cmap: Optional[Colormap] = None, origin: str = "lower") -> dict:
        vmin, vmax = vrange if vrange is not None else self._range_for(key)
        return {"key": key, "title": title, "field": field, "vmin": vmin, "vmax": vmax,
                "cmap": cmap if cmap is not None else self._cmap_for(key, cmap_name),
                "origin": origin}

    # ------------------------------------------------------------- 3-panel IT/SR/HR
    def it_sr_hr_plate(self, idx: int = 0, cmap: Optional[str] = None) -> Plate:
        """The 3-panel IT/SR/HR plate, one range over the three panels of
        sample `idx`, coolwarm unless `cmap` names another map."""
        keys = [k for k in ("INF", "SR", "HR") if k in self.visuals]
        titles = {"INF": "Upsampled with interpolation",
                  "SR": "Super-resolution reconstruction",
                  "HR": "High-resolution original"}
        vmin = min(float(self.visuals[k][idx].min()) for k in keys)
        vmax = max(float(self.visuals[k][idx].max()) for k in keys)
        return compose("IT / SR / HR", [
            self._panel(self.visuals[k][idx, :, :, 0], k, titles[k], cmap or "coolwarm",
                        vrange=(vmin, vmax)) for k in keys], bars="each")

    def make_wandb_plot(self, idx: int = 0, cmap: Optional[str] = None) -> np.ndarray:
        """The IT/SR/HR plate as RGB uint8 [H, W, 3] (what wandb logs)."""
        return self.it_sr_hr_plate(idx, cmap).rgb

    def save_it_sr_hr_plot(self, path: str, cmap: Optional[str] = None) -> str:
        return self.it_sr_hr_plate(cmap=cmap).save(_png(path))

    # --------------------------------------------------- 2-panel HR/SR comparison
    def save_sr_hr_plot(self, path: str, cmap: str = "coolwarm", idx: int = -1) -> str:
        """Ground truth and reconstruction at the fixed 220-315 K range,
        clipped and quantised to its 9 levels."""
        vmin, vmax = 220.0, 315.0
        levels = np.linspace(vmin, vmax, 9)
        panels = []
        for key, title in (("HR", "High-resolution Ground truth"), ("SR", "Model reconstruction")):
            field = np.clip(self.visuals[key][idx, :, :, 0], vmin, vmax)
            field = levels[np.clip(np.digitize(field, levels) - 1, 0, len(levels) - 1)]
            panels.append(self._panel(field, key, title, cmap, vrange=(vmin, vmax)))
        return compose("HR / SR", panels, ticks=np.round(levels, 1).tolist()).save(
            f"{path}_sr_hr_{cmap}.png")

    def save_sr_hr_abs_plot(self, path: str, idx: int = -1) -> str:
        """Interpolation's and the model's absolute error, ae_color at [0, 21]."""
        panels = [self._panel(self.visuals[key][idx, :, :, 0], key, title, vrange=_AE_RANGE,
                              cmap=CMAPS["ae_color"])
                  for key, title in (("ABS_INTERPOLATED", "Bicubic interpolation Absolute Error"),
                                     ("ABS_RESIDUALS", "Model Absolute Error"))]
        return compose("absolute errors", panels, ticks=[0, 3, 6, 9, 12, 15, 18, 21]).save(
            f"{path}_sr_hr_abs.png")

    def save_tensor_it_sr_hr_plot(self, path: str, idx: int = -1) -> str:
        """Raw-tensor plates: gray, one range, row 0 at the top."""
        keys = [k for k in ("INF", "SR", "HR") if k in self.visuals]
        titles = {"INF": "Tensor INTERPOLATED", "SR": "Tensor SR", "HR": "Tensor HR"}
        vmin = min(float(self.visuals[k][idx].min()) for k in keys)
        vmax = max(float(self.visuals[k][idx].max()) for k in keys)
        panels = [self._panel(self.visuals[k][idx, :, :, 0], k, titles[k], vrange=(vmin, vmax),
                              cmap=CMAPS["gray"], origin="upper") for k in keys]
        return compose("tensors", panels).save(_png(path))

    # ------------------------------------------------------------ residual mask
    def save_residual_mask(self, path: str, threshold: float = 1.0, idx: int = 0) -> str:
        """Sign of the residual in the white / gray / black map: -1 where SR
        underestimates by more than `threshold`, +1 where it overestimates,
        0 otherwise."""
        res = self.visuals["RESIDUALS"][idx, :, :, 0]
        mask = np.zeros_like(res)
        mask[res > threshold] = 1.0
        mask[res < -threshold] = -1.0
        panel = self._panel(mask, "RESIDUALS", "", cmap=CMAPS["residual_mask"],
                            vrange=(-1.0, 1.0))
        return compose("residual mask", [panel], ticks=[-1, 0, 1]).save(
            f"{path}_residual_mask.png")

    # ------------------------------------------------------------- per-type maps
    def save_all_images(self, path_prefix: str, image_types=None,
                        cmap: Optional[str] = None) -> list:
        """One plate per type and sample: `<path_prefix>_<type>_<idx>.png`.
        Returns the paths.

        Main fields share [min, max] (or the set_min_max range) in the
        caller's map; DELTA / RESIDUALS take abs_color at [-25, 25] and the
        AE maps ae_color at [0, 21], whatever the caller's map."""
        os.makedirs(os.path.dirname(path_prefix) or ".", exist_ok=True)
        image_types = image_types or [
            k for k in self.visuals if k not in ("LR", "RESIDUAL", "ABS_ERROR")]
        aliases = {"INTERPOLATED": "INF", "DELTA": "RESIDUALS",
                   "AE": "ABS_RESIDUALS", "AE_INTER": "ABS_INTERPOLATED"}
        saved = []
        for name in image_types:
            key = aliases.get(name, name)
            if key not in self.visuals:
                continue
            if key in self._RESIDUAL_KEYS:
                vrange, use_cmap = _DELTA_RANGE, CMAPS["abs_color"]
            elif key in self._ABS_KEYS:
                vrange, use_cmap = _AE_RANGE, CMAPS["ae_color"]
            else:
                vrange, use_cmap = None, None
            for idx in range(min(self.n_images, self.visuals[key].shape[0])):
                panel = self._panel(self.visuals[key][idx, :, :, 0], key, f"{name} {idx}",
                                    None if use_cmap is not None else cmap, vrange=vrange,
                                    cmap=use_cmap)
                saved.append(compose(name, [panel]).save(f"{path_prefix}_{name}_{idx}.png"))
        return saved
