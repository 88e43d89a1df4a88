"""Data pipeline: vertical partitioning + host batching with prefetch (own
copy of the reference's ``repro.data.pipeline``; outputs are
byte-identical)."""
from __future__ import annotations

import queue
import threading
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


class Prefetcher:
    """Background-thread prefetch of an iterator (depth-bounded)."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = it
        self._done = object()
        t = threading.Thread(target=self._run, daemon=True)
        t.start()

    def _run(self):
        try:
            for item in self._it:
                self._q.put(item)
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        return item
