"""Streaming evaluation metrics in Kelvin (port of srewd_tpu/training/metrics.py).

All validation metrics are computed on inverse-transformed physical values:
  * MAE / MSE / RMSE / MR: streaming sum / count over every element;
  * PSNR: the data range is (max - min) of all TARGET values seen so far,
    psnr = 10 log10(range^2 / mse);
  * SSIM: per image, channel 0 only, skimage defaults, per-image data range
    pred.max() - pred.min(), batch mean accumulated (ops/ssim.py).

Accumulators are float64 numpy on the host.
"""

from __future__ import annotations

import math
from abc import ABC, abstractmethod

import numpy as np
import torch

from ..ops.ssim import ssim as _ssim_fn


class Metric(ABC):
    def __init__(self):
        self.reset()

    def reset(self):
        self.sum = 0.0
        self.count = 0.0

    @abstractmethod
    def update(self, predicted, target):
        ...

    def compute(self):
        if self.count == 0:
            return 0.0
        return self.sum / self.count


class MAE(Metric):
    def update(self, predicted, target):
        p, t = np.asarray(predicted, np.float64), np.asarray(target, np.float64)
        self.sum += float(np.abs(p - t).sum())
        self.count += p.size


class MSE(Metric):
    def update(self, predicted, target):
        p, t = np.asarray(predicted, np.float64), np.asarray(target, np.float64)
        self.sum += float(np.square(p - t).sum())
        self.count += p.size


class RMSE(MSE):
    def compute(self):
        return math.sqrt(super().compute())


class MR(Metric):
    """Mean residual (signed bias)."""

    def update(self, predicted, target):
        p, t = np.asarray(predicted, np.float64), np.asarray(target, np.float64)
        self.sum += float((p - t).sum())
        self.count += p.size


class PSNR(Metric):
    """PSNR with the data range tracked from the targets across updates."""

    def reset(self):
        self.sum_sq = 0.0
        self.count = 0.0
        self.t_min = math.inf
        self.t_max = -math.inf

    def update(self, predicted, target):
        p, t = np.asarray(predicted, np.float64), np.asarray(target, np.float64)
        self.sum_sq += float(np.square(p - t).sum())
        self.count += p.size
        self.t_min = min(self.t_min, float(t.min()))
        self.t_max = max(self.t_max, float(t.max()))

    def compute(self):
        if self.count == 0:
            return 0.0
        mse = self.sum_sq / self.count
        if mse == 0:
            return math.inf
        return 10.0 * math.log10((self.t_max - self.t_min) ** 2 / mse)


class SSIM(Metric):
    """Per-image channel-0 SSIM with per-image pred-derived data range."""

    def update(self, predicted, target):
        p = torch.from_numpy(np.asarray(predicted, np.float32)[..., :1])
        t = torch.from_numpy(np.asarray(target, np.float32)[..., :1])
        self.sum += float(_ssim_fn(p, t).sum())
        self.count += p.shape[0]


class ValidationMetrics:
    def __init__(self, metrics_dict: dict):
        self.metrics_objects = metrics_dict
        self.metrics: dict = {}
        self.reset()

    def reset(self):
        for m in self.metrics_objects.values():
            m.reset()

    def update(self, target, predicted):
        """Called as update(HR, SR), and each metric takes its arguments as
        (predicted, target): the reference's call order, kept (only MR's
        sign depends on it)."""
        for m in self.metrics_objects.values():
            m.update(target, predicted)

    def compute_metrics(self) -> dict:
        self.metrics = {k: float(m.compute()) for k, m in self.metrics_objects.items()}
        return self.metrics

    def metrics2str(self) -> str:
        return "".join(f"  |  {k:s}: {v:.5f}" for k, v in self.metrics.items())


class TrainMetrics:
    """Dict-of-lists loss log."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.metrics: dict = {}

    def update(self, new_dict: dict):
        for k, v in new_dict.items():
            self.metrics.setdefault(k, []).append(float(v))

    def metrics2str(self) -> str:
        return "".join(
            f"  |  {k:s}: mean = {np.mean(v):.5f}, curr = {v[-1]:.5f}"
            for k, v in self.metrics.items()
        )


def create_metric_dict() -> dict:
    return {"MSE": MSE(), "RMSE": RMSE(), "MAE": MAE(), "MR": MR(), "PSNR": PSNR(), "SSIM": SSIM()}
