"""SemanticKITTI datasets: raw sequence scans + pre-cut pole crops.

The port's counterpart of :mod:`scenenet_tpu.data.semantic_kitti` (numpy
only). Twin of the reference ``core/datasets/semKITTI.py``:
- :class:`SemanticKITTI` walks ``sequences/NN/velodyne`` + ``labels`` with
  an in-repo laserscan reader (replacing the external ``SemKITTI_API``
  checkout, ``semKITTI.py:26,294-420``), %-based splits.
- :class:`SemanticKITTICrops` (reference ``semKITTIv2``, ``:170-288``):
  npy-backed pole-centric crops with shuffled %-splits and a zeros dummy
  sample on read failure.
- :func:`build_pole_radius_samples` cuts DBSCAN radius crops around pole
  instances (label 80; ``semKITTI.py:91-158``).

KITTI voxel config from the reference: grid (64, 64, 64) or per-axis voxel
sizes (0.5, 0.5, 0.2) (``semKITTI.py:453-454``).
"""

from __future__ import annotations

import math
import os
from typing import Callable, List, Optional, Tuple

import numpy as np

from scenenet_tpu_torch.data import pcd as eda

POLE_LABEL = 80

_SPLITS = {
    "samples": (0.0, 1.0),
    "train": (0.0, 0.2),
    "val": (0.2, 0.4),
    "test": (0.4, 1.0),
}


def read_velodyne_scan(path: str) -> np.ndarray:
    """KITTI .bin scan → (N, 3) xyz (drops remission)."""
    scan = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
    return scan[:, :3].astype(np.float64)


def read_kitti_label(path: str) -> np.ndarray:
    """.label file → (N,) semantic label (low 16 bits; high 16 = instance)."""
    raw = np.fromfile(path, dtype=np.uint32)
    return (raw & 0xFFFF).astype(np.int64)


class SemanticKITTI:
    """Raw sequence scans; yields (xyz (N,3), labels (N,)) via transform."""

    def __init__(self, dataset_path: str, split: str = "samples",
                 transform: Optional[Callable] = None, sequences=range(0, 21)):
        self.transform = transform
        scan_names: List[str] = []
        label_names: List[str] = []
        for seq in sequences:
            seq_dir = os.path.join(dataset_path, "sequences", f"{seq:02d}")
            scan_dir = os.path.join(seq_dir, "velodyne")
            label_dir = os.path.join(seq_dir, "labels")
            if not os.path.isdir(scan_dir) or not os.path.isdir(label_dir):
                continue
            for dp, _, fn in os.walk(scan_dir):
                scan_names += [os.path.join(dp, f) for f in fn]
            for dp, _, fn in os.walk(label_dir):
                label_names += [os.path.join(dp, f) for f in fn]
        self.scan_names = np.sort(np.array(scan_names))
        self.label_names = np.sort(np.array(label_names))
        assert len(self.scan_names) == len(self.label_names)
        beg, end = _SPLITS[split]
        n = self.scan_names.size
        self.scan_names = self.scan_names[math.floor(beg * n):math.floor(end * n)]
        self.label_names = self.label_names[math.floor(beg * n):math.floor(end * n)]

    def __len__(self) -> int:
        return len(self.scan_names)

    def __getitem__(self, idx: int):
        xyz = read_velodyne_scan(self.scan_names[idx])
        labels = read_kitti_label(self.label_names[idx])
        sample = (xyz, labels)
        try:
            if self.transform is not None:
                return self.transform(sample)
            return xyz[None], labels[None]
        except Exception:
            # reference returns a zeros dummy on failure (semKITTI.py:411-418)
            dummy = (np.zeros((100, 3)), np.zeros(100))
            return self.transform(dummy) if self.transform else (
                np.zeros((1, 100, 3)), np.zeros((1, 100)))


class SemanticKITTICrops:
    """Pre-cut npy pole crops with shuffled %-splits (reference semKITTIv2)."""

    def __init__(self, dataset_path: str, split: str = "samples",
                 transform: Optional[Callable] = None, seed: int = 0):
        self.dataset_path = os.path.join(dataset_path, "samples")
        self.transform = transform
        self.split = split
        files = np.array(sorted(
            f for f in os.listdir(self.dataset_path) if f.endswith(".npy")
        ))
        rng = np.random.default_rng(seed)
        rng.shuffle(files)
        beg, end = _SPLITS[split]
        self.npy_files = files[math.floor(beg * files.size):math.floor(end * files.size)]

    def __len__(self) -> int:
        return len(self.npy_files)

    def __str__(self) -> str:
        return f"SemanticKITTICrops {self.split} Dataset with {len(self)} samples."

    def __getitem__(self, idx: int):
        try:
            npy = np.load(os.path.join(self.dataset_path, self.npy_files[idx]))
            sample = (npy[:, 0:3], npy[:, 3])
            if self.transform is not None:
                return self.transform(sample)
            return npy[None, :, 0:3], npy[None, :, 3]
        except Exception:
            dummy = (np.zeros((100, 3)), np.zeros(100))
            return self.transform(dummy) if self.transform else (
                np.zeros((1, 100, 3)), np.zeros((1, 100)))

    def get_item_no_transform(self, idx: int):
        """Raw (1, N, 3)/(1, N) access bypassing the transform
        (reference ``semKITTI.py:262-274``)."""
        try:
            npy = np.load(os.path.join(self.dataset_path, self.npy_files[idx]))
            return npy[None, :, 0:3], npy[None, :, 3]
        except Exception:
            return np.zeros((1, 100, 3)), np.zeros((1, 100))

    def get_item_from_path(self, idx: int):
        """Access ``sample_{idx}.npy`` by name (reference ``semKITTI.py:276-284``)."""
        npy = np.load(os.path.join(self.dataset_path, f"sample_{idx}.npy"))
        return npy[None, :, 0:3], npy[None, :, 3]


def crop_pole_samples(xyz: np.ndarray, classes: np.ndarray,
                      obj_class=(POLE_LABEL,)) -> List[np.ndarray]:
    """Radius-5 crops around DBSCAN pole instances (``semKITTI.py:91-103``)."""
    pole_xyz, _ = eda.select_object(xyz, classes, list(obj_class))
    poles = eda.extract_towers(pole_xyz, eps=5, min_points=10)
    samples = []
    for pole in poles:
        crop, crop_cls = eda.crop_tower_radius(xyz, classes, pole, radius=5)
        samples.append(np.concatenate([crop, crop_cls.reshape(-1, 1)], axis=1))
    return samples


def build_pole_radius_samples(dataset_path: str, save_path: str,
                              min_pole_points: int = 5) -> int:
    """ETL: sequence scans → pole-centric npy crops (``semKITTI.py:105-158``)."""
    samples_path = os.path.join(save_path, "samples")
    os.makedirs(samples_path, exist_ok=True)
    counter = len(os.listdir(samples_path))
    kitti = SemanticKITTI(dataset_path, transform=None)
    for i in range(len(kitti)):
        xyz, gt = kitti[i]
        xyz, gt = np.squeeze(xyz), np.squeeze(gt)
        if not np.any(gt == POLE_LABEL):
            continue
        for sample in crop_pole_samples(xyz, gt, [POLE_LABEL]):
            if np.sum(sample[:, -1] == POLE_LABEL) >= min_pole_points:
                np.save(os.path.join(samples_path, f"sample_{counter}.npy"), sample)
                counter += 1
    return counter
