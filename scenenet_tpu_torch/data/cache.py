"""Disk-cached dataset wrapper: voxelize once, train many epochs.

The port's own copy of :mod:`scenenet_tpu.data.cache`.

Host voxelization is deterministic per sample, so when no stochastic
augmentation is in the transform chain every epoch recomputes the same
grids; this wrapper memoizes transform outputs to an npz directory
(first epoch pays, later epochs stream from disk). The reference recomputes
the pandas-groupby voxelization every epoch in its DataLoader workers.
"""

from __future__ import annotations

import hashlib
import os
from typing import Any, Callable, Optional

import numpy as np


class CachedDataset:
    """Wraps any index-able dataset; caches ``dataset[i]`` tuples as npz."""

    def __init__(self, dataset: Any, cache_dir: str, tag: str = "v0"):
        self.dataset = dataset
        self.cache_dir = cache_dir
        self.tag = tag
        os.makedirs(cache_dir, exist_ok=True)

    def __len__(self) -> int:
        return len(self.dataset)

    def _path(self, idx: int) -> str:
        key = hashlib.sha1(f"{self.tag}:{idx}".encode()).hexdigest()[:16]
        return os.path.join(self.cache_dir, f"{key}.npz")

    def __getitem__(self, idx: int):
        path = self._path(idx)
        if os.path.exists(path):
            data = np.load(path)
            return tuple(data[f"arr_{i}"] for i in range(len(data.files)))
        sample = self.dataset[idx]
        sample = tuple(np.asarray(s) for s in sample)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:  # atomic publish
            np.savez(f, *sample)
        os.replace(tmp, path)
        return sample

    def warm(self) -> None:
        """Precompute the whole cache (e.g. before a sweep)."""
        for i in range(len(self)):
            self[i]
