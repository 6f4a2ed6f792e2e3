"""Seeding of the host-side RNGs (copy of srewd_tpu/utils/seeding.py, default seed 0).

Torch randomness in the port comes from explicit generators; this seeds the
python and numpy RNGs, and derives the seeds of the generators of numbered
streams (`member_seed`: ensemble members, a service's device batches).
"""

from __future__ import annotations

import random

import numpy as np


def set_seeds(seed: int = 0) -> None:
    random.seed(seed)
    np.random.seed(seed)


def member_seed(seed: int, member: int) -> int:
    """The generator seed of stream `member` of `seed` (member 0: `seed`):
    an ensemble member of the sample CLI, a device batch of the service."""
    if member == 0:
        return int(seed)
    state = np.random.SeedSequence([int(seed), int(member)]).generate_state(1, np.uint64)
    return int(state[0]) >> 1
