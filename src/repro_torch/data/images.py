"""Synthetic images for the paper's §4 histogram case study.

Two kinds, as in the paper: ``solid`` (monochromatic — maximum atomic
contention, e=32) and ``uniform`` (random channel values — low contention,
e~2-3).  Sizes 32 px to 4 Mpx, four 8-bit channels (RGBA)."""

from __future__ import annotations

import numpy as np

CHANNELS = 4


def make_image(kind: str, num_pixels: int, seed: int = 0,
               color: int = 128) -> np.ndarray:
    """(num_pixels, 4) uint8-valued int32 channel array."""
    if kind == "solid":
        return np.full((num_pixels, CHANNELS), color, np.int32)
    if kind == "uniform":
        rng = np.random.default_rng(seed)
        return rng.integers(0, 256, (num_pixels, CHANNELS)).astype(np.int32)
    raise ValueError(kind)


PAPER_SIZES = [2 ** p for p in range(5, 23)]  # 32 px .. 4 Mpx
