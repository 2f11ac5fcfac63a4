"""TS40K dataset: the npy tower crops.

Twin of the listing and loading of :class:`scenenet_tpu.data.ts40k.TS40K`:
it lists ``{root}/{split}/*.npy`` (each an (N, 4) array of xyz and class)
and yields ``(xyz (N, 3), labels (N,))`` through a transform, loading a
random other sample where a file cannot be read. The LAS → crops ETL is not
ported.
"""

from __future__ import annotations

import os
import random
from typing import Callable, Optional

import numpy as np


class TS40K:
    def __init__(self, dataset_path: str, split: str = "fit",
                 transform: Optional[Callable] = None):
        self.dataset_path = os.path.join(dataset_path, split)
        self.split = split
        self.transform = transform
        self.npy_files = np.array(sorted(
            f for f in os.listdir(self.dataset_path)
            if f.endswith(".npy") and os.path.isfile(os.path.join(self.dataset_path, f))
        ))

    def __len__(self) -> int:
        return len(self.npy_files)

    def __str__(self) -> str:
        return f"TS40K {self.split} Dataset with {len(self)} samples"

    def _load(self, idx: int) -> np.ndarray:
        return np.load(os.path.join(self.dataset_path, self.npy_files[idx]))

    def __getitem__(self, idx: int):
        # a corrupted or unreadable file gives way to a random other sample
        for _ in range(4 * len(self) + 4):
            try:
                npy = self._load(idx)
                sample = (npy[:, 0:3], npy[:, 3])
                if self.transform is not None:
                    return self.transform(sample)
                return npy[None, :, 0:3], npy[None, :, 3]
            except Exception:
                idx = random.randint(0, len(self) - 1)
        raise RuntimeError("could not produce a valid sample")
