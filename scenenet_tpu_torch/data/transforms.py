"""Sample transforms: raw (points, labels) → model-ready voxel tensors.

The port's counterpart of :mod:`scenenet_tpu.data.transforms`, numpy only
(the trainer uploads the batches), on the port's own
:mod:`~scenenet_tpu_torch.ops.voxel_np` and :mod:`~scenenet_tpu_torch.native`.
Twin of the reference ``core/datasets/torch_transforms.py``:
- ``Voxelization`` — hist + reg grids with a (1, Z, X, Y) channel dim
  (``torch_transforms.py:44-81``); here it also emits the grids in float32
  (the reference carries float64 to a double-precision conv — TPUs run
  f32/bf16; parity tolerance is budgeted in the tests).
- ``ToFullDense`` — binarize input and/or GT (``:16-40``).
- ``PointPadding`` — the TPU-path alternative: emit fixed-size padded
  point/label/mask arrays (plus the host-exact flat voxel index) so
  voxelization itself runs batched on device
  (:func:`scenenet_tpu_torch.ops.voxelize.voxelize_batch_binary` /
  ``voxelize_batch_from_indices``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from scenenet_tpu_torch import native
from scenenet_tpu_torch.ops import voxel_np as vnp


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, sample):
        for t in self.transforms:
            sample = t(sample)
        return sample


class Voxelization:
    """(points (N,3), labels (N,)) → (hist (1,Z,X,Y), reg (1,Z,X,Y)).

    Uses the native C++ single-pass voxelizer when built (bit-exact with
    the numpy oracle, ~4× faster); falls back to numpy otherwise.
    """

    def __init__(self, keep_labels: Sequence[int],
                 vox_size: Optional[Tuple[float, float, float]] = None,
                 vxg_size: Optional[Tuple[int, int, int]] = (64, 64, 64),
                 dtype=np.float32, use_native: Optional[bool] = None):
        if vox_size is None and vxg_size is None:
            raise ValueError("voxel size or voxelgrid size must be provided")
        self.keep_labels = list(np.asarray(keep_labels).reshape(-1))
        self.vox_size = vox_size
        self.vxg_size = vxg_size
        self.dtype = dtype
        if use_native is None:
            use_native = native.available()
        self.use_native = use_native

    def __call__(self, sample):
        pts, labels = sample
        if self.use_native:
            counts, reg, _ = native.voxelize_native(pts, labels, self.keep_labels,
                                             self.vxg_size, self.vox_size)
            hist = vnp.normalize_per_column_np(counts)
        else:
            spec = vnp.compute_grid_spec(pts, self.vxg_size, self.vox_size)
            hist = vnp.hist_on_voxel_np(pts, spec=spec)
            reg = vnp.reg_on_voxel_np(pts, labels, self.keep_labels, spec=spec)
        return hist[None].astype(self.dtype), reg[None].astype(self.dtype)


class ToFullDense:
    """Binarize ((t > 0)) the input and/or GT grids (``apply`` flags)."""

    def __init__(self, apply: Tuple[bool, bool] = (True, True)):
        self.apply = apply

    def __call__(self, sample):
        return tuple(
            (t > 0).astype(t.dtype) if self.apply[i] else t
            for i, t in enumerate(sample)
        )


class XYZVoxelization:
    """(points (N,3), labels (N,)) → (centroid (1,3,Z,X,Y), density
    (1,Z,X,Y), tower-prob (1,Z,X,Y)).

    Working twin of the reference's ``xyz_Voxelization``
    (``core/datasets/torch_transforms.py:127-166``), whose body calls
    ``Vox.centroid_hist_on_voxel`` / ``centroid_reg_on_voxel`` — functions
    that do not exist anywhere in the reference (dead code). The unpacking
    contract at ``:166`` (``voxeled[None, :-1], voxeled[None, -1], ...``)
    defines the intended output, implemented here via
    :func:`scenenet_tpu_torch.ops.voxel_np.centroid_hist_on_voxel_np`.
    """

    def __init__(self, keep_labels: Sequence[int],
                 vox_size: Optional[Tuple[float, float, float]] = None,
                 vxg_size: Optional[Tuple[int, int, int]] = (64, 64, 64),
                 dtype=np.float32):
        if vox_size is None and vxg_size is None:
            raise ValueError("voxel size or voxelgrid size must be provided")
        self.keep_labels = list(np.asarray(keep_labels).reshape(-1))
        self.vox_size = vox_size
        self.vxg_size = vxg_size
        self.dtype = dtype

    def __call__(self, sample):
        pts, labels = sample
        spec = vnp.compute_grid_spec(pts, self.vxg_size, self.vox_size)
        xyz_hist = vnp.centroid_hist_on_voxel_np(pts, spec=spec)
        reg = vnp.reg_on_voxel_np(pts, labels, self.keep_labels, spec=spec)
        return (xyz_hist[None, :-1].astype(self.dtype),
                xyz_hist[None, -1].astype(self.dtype),
                reg[None].astype(self.dtype))


class XYZToFullDense:
    """(xyz, dense, labels) → (xyz, dense > 0, labels > 0) — the reference's
    ``xyz_ToFullDense`` (``torch_transforms.py:109-123``)."""

    def __call__(self, sample):
        xyz, dense, labels = sample
        return xyz, (dense > 0).astype(dense.dtype), (labels > 0).astype(labels.dtype)


# reference-spelling aliases (migration aid)
xyz_Voxelization = XYZVoxelization
xyz_ToFullDense = XYZToFullDense


class RandomRotateZ:
    """Random rotation about the vertical axis (pre-voxelization).

    Towers are z-aligned structures, so z-rotation is the natural
    label-preserving augmentation for this task (the reference ships no
    augmentation at all). Deterministic per (seed, call index).
    """

    def __init__(self, seed: int = 0, max_angle: float = np.pi):
        self.rng = np.random.default_rng(seed)
        self.max_angle = max_angle

    def __call__(self, sample):
        pts, labels = sample
        theta = self.rng.uniform(-self.max_angle, self.max_angle)
        c, s = np.cos(theta), np.sin(theta)
        center = pts.mean(axis=0)
        rel = pts - center
        rot = np.column_stack([
            rel[:, 0] * c - rel[:, 1] * s,
            rel[:, 0] * s + rel[:, 1] * c,
            rel[:, 2],
        ])
        return rot + center, labels


class RandomFlip:
    """Random mirror over the x and/or y axis (about the cloud centroid)."""

    def __init__(self, seed: int = 0, p: float = 0.5):
        self.rng = np.random.default_rng(seed)
        self.p = p

    def __call__(self, sample):
        pts, labels = sample
        pts = np.array(pts, copy=True)
        center = pts.mean(axis=0)
        for axis in (0, 1):
            if self.rng.random() < self.p:
                pts[:, axis] = 2 * center[axis] - pts[:, axis]
        return pts, labels


class Jitter:
    """Gaussian coordinate noise, clipped (classic point-cloud jitter)."""

    def __init__(self, sigma: float = 0.01, clip: float = 0.05, seed: int = 0):
        self.sigma = sigma
        self.clip = clip
        self.rng = np.random.default_rng(seed)

    def __call__(self, sample):
        pts, labels = sample
        noise = np.clip(self.rng.normal(0, self.sigma, pts.shape),
                        -self.clip, self.clip)
        return pts + noise, labels


class AddPad:
    """Zero-pad both grids; ``pad`` is ((z_lo, z_hi), (x_lo, x_hi),
    (y_lo, y_hi)) applied after the channel dim (reference ``AddPad``,
    ``torch_transforms.py:85-100``)."""

    def __init__(self, pad):
        self.pad = tuple(tuple(p) for p in pad)

    def __call__(self, sample):
        pads = ((0, 0),) + self.pad
        return tuple(np.pad(t, pads) for t in sample)


@dataclasses.dataclass
class PointPadding:
    """(points, labels) → fixed-size (points, labels, mask, flat_idx) for
    the on-device voxelization path.

    - points are centered by their own float64 min (precision: see
      ``scenenet_tpu_torch.ops.voxelize`` module docs) and cast to float32;
    - ``flat_idx`` is the host-exact (z,x,y)-flattened bin index
      (pyntcloud-parity) so ``voxelize_batch_from_indices`` can reproduce
      the oracle bit-for-bit;
    - clouds longer than ``max_points`` are uniformly subsampled
      (deterministic per sample length).
    """

    max_points: int = 65536
    vxg_size: Tuple[int, int, int] = (64, 64, 64)
    vox_size: Optional[Tuple[float, float, float]] = None
    use_native: Optional[bool] = None
    # False skips the host-exact bin-index computation entirely (the
    # device path recomputes bins from raw coordinates; ~4× cheaper host
    # prep — the lever when host cores, not the chip, bound the pipeline)
    compute_indices: bool = True

    def __call__(self, sample):
        pts, labels = sample
        n = len(pts)
        if n > self.max_points:
            rng = np.random.default_rng(n)
            sel = rng.choice(n, self.max_points, replace=False)
            pts, labels = pts[sel], labels[sel]
            n = self.max_points

        if not self.compute_indices:
            out_pts = np.zeros((self.max_points, 3), np.float32)
            out_lab = np.zeros(self.max_points, np.int32)
            mask = np.zeros(self.max_points, bool)
            out_pts[:n] = (pts - pts.min(0)).astype(np.float32)
            out_lab[:n] = np.asarray(labels[:n], np.int32)
            mask[:n] = True
            return out_pts, out_lab, mask, np.zeros(self.max_points, np.int32)

        use_native = self.use_native
        if use_native is None:
            use_native = native.available()
        if use_native:
            _, _, _, flat = native.voxelize_native(pts, labels, (0,), self.vxg_size,
                                            self.vox_size, want_indices=True)
        else:
            spec = vnp.compute_grid_spec(pts, self.vxg_size, self.vox_size)
            idx = vnp.voxel_indices_np(pts, spec)
            n_x, n_y, _ = spec.shape
            flat = (idx[:, 2] * n_x + idx[:, 0]) * n_y + idx[:, 1]

        out_pts = np.zeros((self.max_points, 3), np.float32)
        out_lab = np.zeros(self.max_points, np.int32)
        out_idx = np.zeros(self.max_points, np.int32)
        mask = np.zeros(self.max_points, bool)
        center = pts.min(0)
        out_pts[:n] = (pts - center).astype(np.float32)
        out_lab[:n] = np.asarray(labels[:n], np.int32)
        out_idx[:n] = flat.astype(np.int32)
        mask[:n] = True
        return out_pts, out_lab, mask, out_idx
