"""Batched data loading with a bounded background prefetch.

Twin of :mod:`scenenet_tpu.data.loader`'s ``PointCloudLoader``,
``random_split`` and ``Subset``: fixed-size padded point batches (points,
labels, mask, flat_idx) as numpy arrays, collated by a thread pool that
keeps at most ``num_workers + 1`` batches in flight. The shuffle is
``random.Random(seed + epoch)``, so both packages see the same batches.
"""

from __future__ import annotations

import concurrent.futures as cf
import random
from collections import deque
from typing import Any, Iterator, Sequence

import numpy as np


class PointCloudLoader:
    """Dataset must yield (points, labels, mask, flat_idx) fixed-size arrays
    (see :class:`scenenet_tpu_torch.data.transforms.PointPadding`)."""

    def __init__(self, dataset: Any, batch_size: int = 4, shuffle: bool = False,
                 num_workers: int = 4, drop_last: bool = False, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(num_workers, 1)
        self.drop_last = drop_last
        self.seed = seed
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _indices(self) -> Sequence[int]:
        idx = list(range(len(self.dataset)))
        if self.shuffle:
            random.Random(self.seed + self._epoch).shuffle(idx)
        return idx

    def _collate(self, samples):
        return tuple(np.stack(p) for p in zip(*samples))

    def __iter__(self) -> Iterator:
        idx = self._indices()
        self._epoch += 1
        batches = [idx[i:i + self.batch_size] for i in range(0, len(idx), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        with cf.ThreadPoolExecutor(self.num_workers) as pool:
            # bounded prefetch: submitting the whole epoch at once would let
            # the pool race ahead and hold every collated batch in memory
            it = iter(batches)
            pending: deque = deque()

            def submit_next():
                b = next(it, None)
                if b is not None:
                    pending.append(pool.submit(
                        lambda b=b: self._collate([self.dataset[i] for i in b])))

            for _ in range(self.num_workers + 1):
                submit_next()
            while pending:
                out = pending.popleft().result()
                submit_next()
                yield out


def random_split(n: int, val_fraction: float, seed: int = 0):
    """Shuffled index split into (train, val)."""
    idx = list(range(n))
    random.Random(seed).shuffle(idx)
    n_val = int(n * val_fraction)
    return idx[: n - n_val], idx[n - n_val:]


class Subset:
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.dataset[self.indices[i]]
