"""Seeding of the host-side RNGs (copy of srewd_tpu/utils/seeding.py, default seed 0).

Torch randomness in the port comes from explicit generators; this seeds the
python and numpy RNGs.
"""

from __future__ import annotations

import random

import numpy as np


def set_seeds(seed: int = 0) -> None:
    random.seed(seed)
    np.random.seed(seed)
