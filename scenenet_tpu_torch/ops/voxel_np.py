"""Host-side (numpy, float64) voxelization oracle.

The port's own copy of :mod:`scenenet_tpu.ops.voxel_np` (numpy only; the
port imports nothing of the JAX package). This module is the *parity
contract* with the reference pipeline: it reproduces, in plain vectorized
numpy, the exact binning semantics the reference obtains from
``pyntcloud.structures.VoxelGrid`` plus a pandas ``groupby`` (reference:
``utils/voxelization.py:164-300``, ``utils/pcd_processing.py:341-372``).
The device path (:mod:`scenenet_tpu_torch.ops.voxelize`) is held against
this oracle, and :class:`scenenet_tpu_torch.data.transforms.PointPadding`
takes its host-exact bin indices from it.

Binning semantics replicated from pyntcloud 0.1.6 VoxelGrid:

1. The grid covers the sample's own axis-aligned bounding box.
2. With ``regular_bounding_box=True`` (the reference always uses the
   default), the AABB is first expanded symmetrically so all sides have the
   length of the largest side (a cube for cubic grids).
3. If per-axis voxel *sizes* are given instead of grid *dims* (the
   SemanticKITTI config), each axis gets an extra margin of
   ``((ptp // size) + 1) * size - ptp`` split evenly on both ends, and the
   axis bin count becomes ``int((max - min) / size)``.
4. Bin edges are ``np.linspace(min, max, n + 1)``; a point is assigned
   ``clip(searchsorted(edges, v, side='left') - 1, 0, n - 1)`` — i.e. a point
   exactly on an interior edge belongs to the *lower* bin.

Grid layout convention (reference ``utils/voxelization.py:193``): dense grids
are indexed ``(z, x, y)`` with shape ``(n_z, n_x, n_y)``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import numpy as np

ArrayLike = Union[np.ndarray, Sequence[float]]


@dataclasses.dataclass(frozen=True)
class VoxelGridSpec:
    """Geometry of a voxel grid fit to one point-cloud sample.

    Attributes
    ----------
    xyzmin, xyzmax : (3,) float64 — bounds of the (possibly expanded) box.
    shape : (n_x, n_y, n_z) int — bin counts per axis (pyntcloud's ``x_y_z``).
    """

    xyzmin: np.ndarray
    xyzmax: np.ndarray
    shape: Tuple[int, int, int]

    @property
    def voxel_size(self) -> np.ndarray:
        """Edge length of one voxel per axis, float64 (3,)."""
        return (self.xyzmax - self.xyzmin) / np.asarray(self.shape, np.float64)

    @property
    def grid_shape_zxy(self) -> Tuple[int, int, int]:
        """Dense-grid shape in the reference's (z, x, y) layout."""
        n_x, n_y, n_z = self.shape
        return (n_z, n_x, n_y)

    def segments(self, axis: int) -> np.ndarray:
        """Bin edges for ``axis`` — ``linspace(min, max, n+1)`` like pyntcloud."""
        return np.linspace(self.xyzmin[axis], self.xyzmax[axis], self.shape[axis] + 1)


def compute_grid_spec(
    xyz: np.ndarray,
    vxg_size: Optional[Tuple[int, int, int]] = (64, 64, 64),
    vox_size: Optional[Tuple[float, float, float]] = None,
    regular_bounding_box: bool = True,
) -> VoxelGridSpec:
    """Fit a voxel grid to a sample's bounding box (pyntcloud semantics).

    ``vox_size`` (per-axis voxel edge lengths) overrides ``vxg_size`` (bin
    counts), matching ``eda.voxelize_ply`` (reference
    ``utils/pcd_processing.py:341-372``).
    """
    xyz = np.asarray(xyz, dtype=np.float64)
    xyzmin = xyz.min(axis=0)
    xyzmax = xyz.max(axis=0)
    xyz_range = xyzmax - xyzmin

    if regular_bounding_box:
        margin = xyz_range.max() - xyz_range
        xyzmin = xyzmin - margin / 2
        xyzmax = xyzmax + margin / 2

    if vox_size is not None:
        shape = [1, 1, 1]
        for n, size in enumerate(vox_size):
            if size is None:
                continue
            ptp = xyz_range[n]
            margin = ((ptp // size) + 1) * size - ptp
            xyzmin[n] -= margin / 2
            xyzmax[n] += margin / 2
            shape[n] = int((xyzmax[n] - xyzmin[n]) / size)
        shape = tuple(shape)
    else:
        if vxg_size is None:
            raise ValueError("provide vxg_size or vox_size")
        shape = tuple(int(s) for s in vxg_size)

    return VoxelGridSpec(xyzmin=xyzmin, xyzmax=xyzmax, shape=shape)


def voxel_indices_np(xyz: np.ndarray, spec: VoxelGridSpec) -> np.ndarray:
    """Per-point (x_idx, y_idx, z_idx) bins, exact pyntcloud searchsorted rule."""
    xyz = np.asarray(xyz, dtype=np.float64)
    out = np.empty((xyz.shape[0], 3), dtype=np.int64)
    for axis in range(3):
        edges = spec.segments(axis)
        n = spec.shape[axis]
        out[:, axis] = np.clip(np.searchsorted(edges, xyz[:, axis]) - 1, 0, n - 1)
    return out


def _flat_zxy(idx: np.ndarray, spec: VoxelGridSpec) -> np.ndarray:
    """Flatten (x,y,z) bin triplets into the (z,x,y)-ordered dense grid."""
    n_x, n_y, _ = spec.shape
    return (idx[:, 2] * n_x + idx[:, 0]) * n_y + idx[:, 1]


def normalize_per_column_np(grid: np.ndarray) -> np.ndarray:
    """MinMax-normalize ``grid.reshape(-1, grid.shape[-1])`` per column.

    Replicates the reference's quirky ``eda.normalize_xyz(data)`` call on the
    (z, x, y) histogram grid (``utils/voxelization.py:202``,
    ``utils/pcd_processing.py:305-321``): an sklearn ``MinMaxScaler`` over the
    flattened-to-2D grid, i.e. each *y column* is scaled by its own min/max
    over all (z, x) cells.  Constant columns map to 0 (sklearn's
    zero-range handling).
    """
    flat = grid.reshape(-1, grid.shape[-1]).astype(np.float64)
    lo = flat.min(axis=0)
    hi = flat.max(axis=0)
    scale = hi - lo
    scale[scale == 0.0] = 1.0
    return ((flat - lo) / scale).reshape(grid.shape)


def hist_on_voxel_np(
    xyz: np.ndarray,
    vxg_size: Optional[Tuple[int, int, int]] = (64, 64, 64),
    vox_size: Optional[Tuple[float, float, float]] = None,
    spec: Optional[VoxelGridSpec] = None,
) -> np.ndarray:
    """Point cloud → (z, x, y) per-voxel point-count grid, minmax-normalized.

    Parity target: ``Vox.hist_on_voxel`` (reference
    ``utils/voxelization.py:164-204``) — pandas groupby count replaced by a
    flat bincount.
    """
    if spec is None:
        spec = compute_grid_spec(xyz, vxg_size, vox_size)
    idx = voxel_indices_np(xyz, spec)
    flat = _flat_zxy(idx, spec)
    n_z, n_x, n_y = spec.grid_shape_zxy
    counts = np.bincount(flat, minlength=n_z * n_x * n_y).astype(np.float64)
    grid = counts.reshape(n_z, n_x, n_y)
    return normalize_per_column_np(grid)


def reg_on_voxel_np(
    xyz: np.ndarray,
    labels: np.ndarray,
    tower_label: Union[int, Sequence[int]],
    vxg_size: Optional[Tuple[int, int, int]] = (64, 64, 64),
    vox_size: Optional[Tuple[float, float, float]] = None,
    spec: Optional[VoxelGridSpec] = None,
) -> np.ndarray:
    """Per-voxel fraction of points whose label ∈ ``tower_label``.

    Parity target: ``Vox.reg_on_voxel`` (reference
    ``utils/voxelization.py:244-300``). Empty voxels are 0.
    """
    if spec is None:
        spec = compute_grid_spec(xyz, vxg_size, vox_size)
    idx = voxel_indices_np(xyz, spec)
    flat = _flat_zxy(idx, spec)
    n_z, n_x, n_y = spec.grid_shape_zxy
    size = n_z * n_x * n_y
    labels = np.asarray(labels).reshape(-1)
    keep = np.asarray(tower_label).reshape(-1)
    is_tower = np.isin(labels, keep).astype(np.float64)
    total = np.bincount(flat, minlength=size).astype(np.float64)
    tower = np.bincount(flat, weights=is_tower, minlength=size)
    with np.errstate(invalid="ignore", divide="ignore"):
        frac = np.where(total > 0, tower / np.maximum(total, 1.0), 0.0)
    return frac.reshape(n_z, n_x, n_y)


def classes_on_voxel_np(
    xyz: np.ndarray,
    labels: np.ndarray,
    vxg_size: Tuple[int, int, int] = (64, 64, 64),
    spec: Optional[VoxelGridSpec] = None,
) -> np.ndarray:
    """Per-voxel max label (reference ``utils/voxelization.py:207-241``)."""
    if spec is None:
        spec = compute_grid_spec(xyz, vxg_size, None)
    idx = voxel_indices_np(xyz, spec)
    flat = _flat_zxy(idx, spec)
    n_z, n_x, n_y = spec.grid_shape_zxy
    grid = np.zeros(n_z * n_x * n_y, dtype=np.float64)
    np.maximum.at(grid, flat, np.asarray(labels, np.float64).reshape(-1))
    return grid.reshape(n_z, n_x, n_y)


def prob_to_label_np(grid: np.ndarray, tau: float) -> np.ndarray:
    """Threshold probabilities to {0,1} (reference ``voxelization.py:304-323``)."""
    return (grid >= tau).astype(grid.dtype)


def centroid_hist_on_voxel_np(
    xyz: np.ndarray,
    vxg_size: Optional[Tuple[int, int, int]] = (64, 64, 64),
    vox_size: Optional[Tuple[float, float, float]] = None,
    spec: Optional[VoxelGridSpec] = None,
) -> np.ndarray:
    """(4, Z, X, Y): per-voxel xyz centroid (3 channels, 0 where empty) +
    the minmax-normalized density channel of :func:`hist_on_voxel_np`.

    The reference's ``xyz_Voxelization`` transform calls
    ``Vox.centroid_hist_on_voxel`` (``core/datasets/torch_transforms.py:161``)
    but that function is never defined anywhere in the reference — dead
    code that would raise AttributeError. This is the working
    implementation of its evident intent (channels [:-1] = centroid,
    [-1] = density, per the transform's unpacking at ``:166``).
    """
    xyz = np.asarray(xyz, np.float64)
    if spec is None:
        spec = compute_grid_spec(xyz, vxg_size, vox_size)
    idx = voxel_indices_np(xyz, spec)
    flat = _flat_zxy(idx, spec)
    n_z, n_x, n_y = spec.grid_shape_zxy
    size = n_z * n_x * n_y
    counts = np.bincount(flat, minlength=size).astype(np.float64)
    cent = np.stack([
        np.bincount(flat, weights=xyz[:, c], minlength=size) for c in range(3)
    ])
    with np.errstate(invalid="ignore", divide="ignore"):
        cent = np.where(counts > 0, cent / np.maximum(counts, 1.0), 0.0)
    density = normalize_per_column_np(counts.reshape(n_z, n_x, n_y))
    return np.concatenate([cent.reshape(3, n_z, n_x, n_y), density[None]])


def centroid_reg_on_voxel_np(
    xyz: np.ndarray,
    labels: np.ndarray,
    tower_label: Union[int, Sequence[int]],
    vxg_size: Optional[Tuple[int, int, int]] = (64, 64, 64),
    vox_size: Optional[Tuple[float, float, float]] = None,
    spec: Optional[VoxelGridSpec] = None,
) -> np.ndarray:
    """(4, Z, X, Y): per-voxel xyz centroid + the tower-fraction channel of
    :func:`reg_on_voxel_np` (working twin of the reference's missing
    ``Vox.centroid_reg_on_voxel``, ``torch_transforms.py:162``)."""
    xyz = np.asarray(xyz, np.float64)
    if spec is None:
        spec = compute_grid_spec(xyz, vxg_size, vox_size)
    cent = centroid_hist_on_voxel_np(xyz, spec=spec)[:3]
    reg = reg_on_voxel_np(xyz, labels, tower_label, spec=spec)
    return np.concatenate([cent, reg[None]])


def vxg_to_xyz_np(
    vxg: np.ndarray,
    origin: Optional[ArrayLike] = None,
    voxel_size: Optional[ArrayLike] = None,
) -> np.ndarray:
    """Dense grid → (N, 4) points ``origin + index * voxel_size`` + value.

    Parity target: ``Vox.vxg_to_xyz`` (reference
    ``utils/voxelization.py:328-360``), vectorized (the reference loops over
    every voxel in Python).
    """
    vxg = np.asarray(vxg)
    origin = np.zeros(3) if origin is None else np.asarray(origin, np.float64)
    voxel_size = np.ones(3) if voxel_size is None else np.asarray(voxel_size, np.float64)
    grid_indexes = np.indices(vxg.shape).reshape(3, -1).T
    points = origin + grid_indexes * voxel_size
    return np.concatenate((points, vxg.reshape(-1, 1)), axis=1)
