"""TS40K dataset: npy tower crops + the offline LAS → crops ETL.

The port's counterpart of :mod:`scenenet_tpu.data.ts40k` (numpy only).
Twin of the reference ``core/datasets/ts40k.py``:
- :class:`TS40K` lists ``{root}/{split}/*.npy`` and yields
  ``(xyz (N,3), labels (N,))`` through a transform, with the reference's
  corrupted-sample fallback (load a random other sample,
  ``ts40k.py:200-224``).
- :func:`build_data_samples` is the ETL: .las files → DBSCAN tower
  instances → radius crops → ``sample_N.npy`` (N,4 = xyz+class), resumable
  (the reference persists progress in ``read_files.pickle``; here a JSON
  sidecar) and split into fit/test folders (``ts40k.py:31-148``).
"""

from __future__ import annotations

import json
import math
import os
import random
import shutil
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from scenenet_tpu_torch.data import pcd as eda
from scenenet_tpu_torch.data.las import read_las_xyz_class


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

    def set_transform(self, transform: Callable) -> None:
        self.transform = transform

    def _load(self, idx: int) -> np.ndarray:
        return np.load(os.path.join(self.dataset_path, self.npy_files[idx]))

    def __getitem__(self, idx: int):
        # corrupted/unreadable file → random substitute, retried
        # (reference ts40k.py:200-224)
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


def build_data_samples(
    data_dirs: List[str],
    save_dir: str,
    tower_radius: bool = True,
    data_split: Dict[str, float] | int = {"fit": 0.6, "test": 0.4},
    seed: int = 0,
) -> int:
    """LAS directories → per-tower npy crops in ``save_dir/fit``, then an
    optional shuffled split into sibling folders. Returns #samples written.

    Resumable: processed LAS paths are recorded in ``read_files.json``.
    """
    fit_path = os.path.join(save_dir, "fit")
    os.makedirs(fit_path, exist_ok=True)
    if isinstance(data_split, dict):
        for folder in data_split:
            os.makedirs(os.path.join(save_dir, folder), exist_ok=True)

    progress_path = os.path.join(save_dir, "read_files.json")
    read_files: List[str] = []
    if os.path.exists(progress_path):
        with open(progress_path) as f:
            read_files = json.load(f)

    # next free index = max existing sample index across ALL split folders
    # + 1 — NOT len(listdir(fit)): after a split moves files out of fit/,
    # the surviving names are sparse and a count-based counter would reuse
    # (and silently overwrite) surviving indices on resume
    counter = 0
    scan_dirs = [os.path.join(save_dir, d) for d in os.listdir(save_dir)
                 if os.path.isdir(os.path.join(save_dir, d))]
    for sdir in scan_dirs:
        for name in os.listdir(sdir):
            if name.startswith("sample_") and name.endswith(".npy"):
                try:
                    counter = max(counter, int(name[7:-4]) + 1)
                except ValueError:
                    pass
    for d in data_dirs:
        for name in sorted(os.listdir(d)):
            path = os.path.join(d, name)
            if not name.endswith(".las") or path in read_files:
                continue
            xyz, classes = read_las_xyz_class(path)
            if not np.any(classes == eda.POWER_LINE_SUPPORT_TOWER):
                read_files.append(path)
                continue
            samples = eda.crop_tower_samples(xyz, classes) if tower_radius else \
                _crop_two_tower_samples(xyz, classes)
            for sample in samples:
                np.save(os.path.join(fit_path, f"sample_{counter}.npy"), sample)
                counter += 1
            read_files.append(path)
            with open(progress_path, "w") as f:
                json.dump(read_files, f)

    if data_split == 0 or not isinstance(data_split, dict):
        return counter

    samples = os.listdir(fit_path)
    rng = random.Random(seed)
    rng.shuffle(samples)
    assert sum(data_split.values()) <= 1 + 1e-9, "data splits should not surpass 1"
    split_sum = 0.0
    size = len(samples)
    for folder, frac in data_split.items():
        if folder == "fit":
            split_sum += frac
            continue
        chunk = samples[int(split_sum * size):math.ceil((split_sum + frac) * size)]
        split_sum += frac
        for s in chunk:
            shutil.move(os.path.join(fit_path, s), os.path.join(save_dir, folder))
    return counter


def _crop_two_tower_samples(xyz: np.ndarray, classes: np.ndarray) -> List[np.ndarray]:
    """Two-tower span crops (reference ``pcd_processing.py:771-803``)."""
    tower_xyz, _ = eda.select_object(xyz, classes, [eda.POWER_LINE_SUPPORT_TOWER])
    towers = eda.extract_towers(tower_xyz)
    if len(towers) <= 1:
        return []
    centers = np.array([t.mean(0) for t in towers])
    samples = []
    for i in range(len(towers)):
        d = np.linalg.norm(centers - centers[i], axis=1)
        d[i] = np.inf
        j = int(np.argmin(d))
        span, span_cls = eda.crop_two_towers(xyz, classes, towers[i], towers[j])
        if len(span) == 0:
            continue
        parts = [np.concatenate([span, span_cls.reshape(-1, 1)], axis=1)]
        for t in (towers[i], towers[j]):
            crop, crop_cls = eda.crop_tower_radius(xyz, classes, t)
            parts.append(np.concatenate([crop, crop_cls.reshape(-1, 1)], axis=1))
        samples.append(np.concatenate(parts))
    return samples
