"""Batched data loading with a bounded background prefetch.

Twin of :mod:`scenenet_tpu.data.loader`: batches stay numpy arrays, which
the trainer uploads; no loader thread touches the card. The shuffle is
``random.Random(seed + epoch)``, so both packages see the same batches.

- :class:`VoxelLoader` — samples voxelized on the host (``Voxelization``
  + ``ToFullDense``), stacked into (B, 1, Z, X, Y) grids;
- :class:`PointCloudLoader` — fixed-size padded point batches (points,
  labels, mask, flat_idx) of ``PointPadding``, collated by a thread pool
  that keeps at most ``num_workers + 1`` batches in flight;
- :class:`NativePointCloudLoader` — the same point batches (with a zero
  ``flat_idx``) made by the native C++ loader in real threads, one batch
  prefetched.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import random
from collections import deque
from typing import Any, Iterator, Sequence

import numpy as np

from scenenet_tpu_torch import native
from scenenet_tpu_torch.utils.profiling import span


class _BaseLoader:
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
                with span("snt/data/loader_wait"):
                    out = pending.popleft().result()
                submit_next()
                yield out


class VoxelLoader(_BaseLoader):
    """Dataset must yield (input_grid (1,Z,X,Y), gt_grid (1,Z,X,Y))."""


class PointCloudLoader(_BaseLoader):
    """Dataset must yield (points, labels, mask, flat_idx) fixed-size arrays
    (see :class:`scenenet_tpu_torch.data.transforms.PointPadding`)."""


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


class NativePointCloudLoader(_BaseLoader):
    """Point batches prepared by the native loader
    (:func:`scenenet_tpu_torch.native.load_batch_native`).

    The per-sample hot path (npy parse, read, f64→f32, min-centring,
    subsample, pad) runs in C++ threads with the GIL released, so host prep
    scales with cores. Emits the (points, labels, mask, flat_idx) tuples of
    ``PointCloudLoader`` + ``PointPadding(compute_indices=False)`` (a cloud
    longer than ``max_points`` is subsampled by another draw); pair it with
    bins computed on the device.

    The dataset must expose ``.dataset_path`` and ``.npy_files`` (TS40K and
    SemanticKITTICrops do) or be a ``Subset`` of one.
    """

    def __init__(self, dataset: Any, batch_size: int = 4, shuffle: bool = False,
                 max_points: int = 65536, threads: int = 0,
                 drop_last: bool = False, seed: int = 0):
        super().__init__(dataset, batch_size, shuffle, num_workers=1,
                         drop_last=drop_last, seed=seed)
        self.max_points = max_points
        self.threads = threads
        self._paths = self._resolve_paths(dataset)

    @staticmethod
    def _resolve_paths(dataset) -> Sequence[str]:
        if isinstance(dataset, Subset):
            base = NativePointCloudLoader._resolve_paths(dataset.dataset)
            return [base[i] for i in dataset.indices]
        return [os.path.join(dataset.dataset_path, f) for f in dataset.npy_files]

    def __iter__(self) -> Iterator:
        idx = self._indices()
        self._epoch += 1
        batches = [idx[i:i + self.batch_size] for i in range(0, len(idx), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]

        def load(b):
            pts, labels, mask = native.load_batch_native(
                [self._paths[i] for i in b], self.max_points, self.threads)
            return pts, labels, mask, np.zeros((len(b), self.max_points), np.int32)

        def wait(fut):  # the consumer's wait for the prefetched batch
            with span("snt/data/loader_wait"):
                return fut.result()

        # one prefetch thread: the C++ call releases the GIL, so it overlaps
        # the next batch's prep with the consumer's step
        with cf.ThreadPoolExecutor(1) as pool:
            pending = None
            for b in batches:
                fut = pool.submit(load, b)
                if pending is not None:
                    yield wait(pending)
                pending = fut
            if pending is not None:
                yield wait(pending)
