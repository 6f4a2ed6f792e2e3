"""Weights & Biases logger with the reference's namespacing (port of
srewd_tpu/utils/wandb_logger.py).

wandb is optional: it is imported only when the config has a `wandb`
section and the caller does not pass enabled=False. Without the package,
without the section, or when init fails, every call is a no-op.
`log_sr_hr_it_image` takes the IT/SR/HR plate as an RGB array
(`ImageContainer.make_wandb_plot`), not a figure.
"""

from __future__ import annotations


class WandbLogger:
    def __init__(self, opt: dict, enabled: bool | None = None):
        self._wandb = None
        cfg = opt.get("wandb") or {}
        if enabled is False or not cfg:
            return
        try:
            import wandb

            self._wandb = wandb
            wandb.init(
                project=cfg.get("project"),
                entity=cfg.get("entity"),
                config=opt,
                reinit=True,
            )
        except Exception:
            self._wandb = None

    @property
    def enabled(self) -> bool:
        return self._wandb is not None

    def _log(self, data: dict, commit: bool, step: int | None):
        if self._wandb:
            self._wandb.log(data, commit=commit, step=step)

    def log_metrics(self, metrics: dict, commit=True, step=None):
        self._log(metrics, commit, step)

    def log_train_metrics(self, metrics: dict, commit=False, step=None):
        self._log({f"train/{k}": v for k, v in metrics.items()}, commit, step)

    def log_train_mean_metrics(self, metrics: dict, commit=False, step=None):
        self._log({f"train_mean/{k}": v for k, v in metrics.items()}, commit, step)

    def log_val_metrics(self, metrics: dict, commit=False, step=None):
        self._log({f"val/{k}": v for k, v in metrics.items()}, commit, step)

    def log_val_time(self, seconds: float, commit=False, step=None):
        self._log({"val/val_time": seconds}, commit, step)

    def log_sr_hr_it_image(self, rgb, commit=False, step=None):
        if self._wandb:
            self._log({"val/sr_hr_it": self._wandb.Image(rgb)}, commit, step)

    def commit(self, step=None):
        self._log({}, True, step)
