"""Data pipeline: vertical partitioning + host batching (own numpy copy of
the reference's ``repro.data.pipeline``; outputs are byte-identical)."""
from __future__ import annotations

from typing import Iterator, List

import numpy as np


def vertical_partition(x: np.ndarray, C: int,
                       image_hw=(0, 0)) -> List[np.ndarray]:
    """Split the feature dimension into C near-equal vertical slices.

    For image data (paper: column strips of the image), features are split by
    contiguous pixel columns so conv parties get a coherent (H, W/C) strip.
    """
    h, w = image_hw
    if h and w:
        img = x.reshape(*x.shape[:-1], h, w)
        cols = np.array_split(np.arange(w), C)
        return [img[..., c].reshape(*x.shape[:-1], h * len(c)) for c in cols]
    return [s.copy() for s in np.array_split(x, C, axis=-1)]


def slice_hw(image_hw, C: int) -> List[tuple]:
    """Per-party (H, W_slice) after vertical_partition of an image."""
    h, w = image_hw
    cols = np.array_split(np.arange(w), C)
    return [(h, len(c)) for c in cols]


def batch_iterator(x: np.ndarray, y: np.ndarray, batch: int, *,
                   seed: int = 0, shuffle: bool = True) -> Iterator[tuple]:
    rng = np.random.default_rng(seed)
    n = x.shape[0]
    while True:
        idx = rng.permutation(n) if shuffle else np.arange(n)
        for i in range(0, n - batch + 1, batch):
            b = idx[i:i + batch]
            yield x[b], y[b]
