"""Named python loggers writing per-experiment log files (copy of
srewd_tpu/utils/logging.py): logger "base" (train.log, optional console)
and "val" (val.log). Setting a logger up again replaces its handlers."""

from __future__ import annotations

import logging
import os


def setup_logger(
    logger_name: str | None,
    root: str,
    phase: str,
    level: int = logging.INFO,
    screen: bool = False,
) -> logging.Logger:
    logger = logging.getLogger(logger_name if logger_name else "base")
    formatter = logging.Formatter(
        "%(asctime)s.%(msecs)03d - %(levelname)s: %(message)s", datefmt="%y-%m-%d %H:%M:%S"
    )
    os.makedirs(root, exist_ok=True)
    for h in list(logger.handlers):  # a second run in one process logs once
        logger.removeHandler(h)
        h.close()
    fh = logging.FileHandler(os.path.join(root, f"{phase}.log"), mode="w")
    fh.setFormatter(formatter)
    logger.setLevel(level)
    logger.addHandler(fh)
    if screen:
        sh = logging.StreamHandler()
        sh.setFormatter(formatter)
        logger.addHandler(sh)
    return logger
