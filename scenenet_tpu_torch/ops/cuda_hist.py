"""Raw points → binarized voxel grids: the CUDA kernels and their plain twins.

Two ports of TPU kernels of :mod:`scenenet_tpu.ops.pallas_hist`, both in
``csrc/points_occupancy.cu`` and sharing its bounds pass and id recipe:

- ``points_occupancy`` (``pallas_points_occupancy``, the serving prep):
  per sample, the masked bounding box expanded to a cube, each valid
  point's flat (z, x, y) bin id by the multiply recipe
  ``(p − lo)·(n / range)`` with the pyntcloud edge rule, the counts, and
  ``count > min of its y column`` as float {0, 1};
- ``points_binary`` (``pallas_points_binary``, the training prep): the
  same occupancy and, as a second grid, tower presence — 1 where any valid
  point flagged as tower lands.

Unlike the TPU kernels they take any grid. For a CUDA tensor each wrapper
launches its kernel; for a CPU tensor it runs its plain version, which
follows the same f32 recipe op by op, so the two are bit-identical.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from scenenet_tpu_torch.ops import _build

LAUNCHES = _build.LaunchCounter("points_occupancy")
BINARY_LAUNCHES = _build.LaunchCounter("points_binary")

_BIG = 3.4e38  # the TPU kernel's masked-bound sentinel


def edge_bins(rel: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """``clip(ceil(rel − 1e-4) − 1, 0, n − 1)`` as int64.

    The pyntcloud rule (a point on an interior edge belongs to the lower
    bin; the 1e-4 bias keeps that through f32 noise). The clamp happens in
    float before the conversion; NaN (the divide recipe on a zero-extent
    cloud) goes to bin 0, as XLA's saturating conversion sends it there.
    """
    c = torch.nan_to_num(torch.ceil(rel - 1e-4), nan=0.0)
    return torch.minimum(torch.clamp(c, min=1.0), n).to(torch.int64) - 1


def _cube_bounds_mul(points: torch.Tensor, mask: torch.Tensor,
                     grid_shape: Tuple[int, int, int]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, 3) lo and 1/step, exactly as the TPU kernel computes them."""
    m = mask[..., None]
    l = torch.where(m, points, _BIG).amin(dim=1)
    h = torch.where(m, points, -_BIG).amax(dim=1)
    r = h - l
    half = (r.amax(dim=1, keepdim=True) - r) * 0.5
    lo, hi = l - half, h + half
    n = torch.tensor(grid_shape, dtype=torch.float32, device=points.device)
    inv_step = n / torch.clamp(hi - lo, min=1e-30)
    return lo, inv_step


def flat_ids_mul(points: torch.Tensor, mask: torch.Tensor,
                 grid_shape: Tuple[int, int, int]) -> torch.Tensor:
    """(B, N) int64 flat (z, x, y) bin ids by the multiply recipe, each
    sample binned in its own masked cube bounds, as the kernels bin them."""
    n_x, n_y, _ = grid_shape
    lo, inv_step = _cube_bounds_mul(points, mask, grid_shape)
    n = torch.tensor(grid_shape, dtype=torch.float32, device=points.device)
    idx = edge_bins((points - lo[:, None]) * inv_step[:, None], n)
    return (idx[..., 2] * n_x + idx[..., 0]) * n_y + idx[..., 1]


def _grid_counts(flat: torch.Tensor, keep: torch.Tensor, size: int) -> torch.Tensor:
    """(B, size) int64 counts of the ids where ``keep`` is set."""
    b = flat.shape[0]
    offs = torch.arange(b, device=flat.device)[:, None] * size
    ids = torch.where(keep, flat + offs, b * size)
    return torch.bincount(ids.reshape(-1), minlength=b * size + 1)[: b * size].reshape(b, size)


def _above_column_min(counts: torch.Tensor, n_y: int) -> torch.Tensor:
    """``count > min of its y column`` as f32 {0, 1}, (B, size)."""
    b = counts.shape[0]
    cols = counts.reshape(b, -1, n_y)
    return (cols > cols.amin(dim=1, keepdim=True)).to(torch.float32).reshape(b, -1)


def points_occupancy_plain(points: torch.Tensor, mask: torch.Tensor,
                           grid_shape: Tuple[int, int, int]) -> torch.Tensor:
    """Plain PyTorch version: (B, N, 3) f32 + (B, N) bool → (B, size) f32."""
    n_x, n_y, n_z = grid_shape
    counts = _grid_counts(flat_ids_mul(points, mask, grid_shape), mask, n_x * n_y * n_z)
    return _above_column_min(counts, n_y)


def points_binary_plain(points: torch.Tensor, mask: torch.Tensor, tower: torch.Tensor,
                        grid_shape: Tuple[int, int, int]
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`points_binary`: the occupancy of
    :func:`points_occupancy_plain` and ``tower count > 0``."""
    n_x, n_y, n_z = grid_shape
    size = n_x * n_y * n_z
    flat = flat_ids_mul(points, mask, grid_shape)
    occ = _above_column_min(_grid_counts(flat, mask, size), n_y)
    towers = _grid_counts(flat, mask & tower, size)
    return occ, (towers > 0).to(torch.float32)


def _check_points(points: torch.Tensor, mask: torch.Tensor) -> None:
    if points.ndim != 3 or points.shape[2] != 3:
        raise ValueError(f"points must be (B, N, 3), got {tuple(points.shape)}")
    if mask.shape != points.shape[:2]:
        raise ValueError(f"mask must be {tuple(points.shape[:2])}, got {tuple(mask.shape)}")
    if points.dtype != torch.float32 or mask.dtype != torch.bool:
        raise TypeError(f"need float32 points and bool mask, got {points.dtype}, {mask.dtype}")
    if points.device != mask.device:
        raise ValueError(f"points on {points.device}, mask on {mask.device}")


def _check_launch_shape(points: torch.Tensor, grid_shape) -> Tuple[int, int, int, int, int]:
    if points.device.type != "cuda":
        raise ValueError(f"no points kernel for device {points.device}")
    b, n, _ = points.shape
    n_x, n_y, n_z = (int(g) for g in grid_shape)
    if min(b, n, n_x, n_y, n_z) < 1 or b * n_x * n_y * n_z >= 2**31 or n >= 2**31:
        raise ValueError(f"unsupported points shape B={b} N={n} grid={grid_shape}")
    return b, n, n_x, n_y, n_z


def points_occupancy(points: torch.Tensor, mask: torch.Tensor,
                     grid_shape: Tuple[int, int, int]) -> torch.Tensor:
    """(B, N, 3) f32 points + (B, N) bool mask → (B, n_z·n_x·n_y) f32 {0,1}
    occupancy in (z, x, y) order. ``grid_shape`` is (n_x, n_y, n_z).

    A CPU tensor takes :func:`points_occupancy_plain`; a CUDA tensor
    launches the kernel or raises.
    """
    _check_points(points, mask)
    if points.device.type == "cpu":
        return points_occupancy_plain(points, mask, grid_shape)
    b, n, n_x, n_y, n_z = _check_launch_shape(points, grid_shape)
    size = n_x * n_y * n_z
    points = points.contiguous()
    mask = mask.contiguous()
    dev = points.device
    out = torch.empty((b, size), dtype=torch.float32, device=dev)
    counts = torch.zeros((b, size), dtype=torch.int32, device=dev)
    colmin = torch.empty((b, n_y), dtype=torch.int32, device=dev)
    params = torch.empty((b, 6), dtype=torch.float32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.snt_points_occupancy(
            points.data_ptr(), mask.data_ptr(), out.data_ptr(),
            counts.data_ptr(), colmin.data_ptr(), params.data_ptr(),
            b, n, n_x, n_y, n_z, ctypes.c_void_p(stream))
    _build.check(err, "points_occupancy")
    LAUNCHES.add()
    return out


def points_binary(points: torch.Tensor, mask: torch.Tensor, tower: torch.Tensor,
                  grid_shape: Tuple[int, int, int]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, N, 3) f32 points + (B, N) bool mask + (B, N) bool tower flags →
    ((B, size) occupancy, (B, size) tower presence), both f32 {0,1} in
    (z, x, y) order. ``grid_shape`` is (n_x, n_y, n_z).

    Occupancy is :func:`points_occupancy`'s; presence is 1 where a valid
    point with its tower flag set lands. A CPU tensor takes
    :func:`points_binary_plain`; a CUDA tensor launches the kernel or raises.
    """
    _check_points(points, mask)
    if tower.shape != mask.shape or tower.dtype != torch.bool or tower.device != mask.device:
        raise ValueError(f"tower must be a bool {tuple(mask.shape)} tensor on {mask.device}, "
                         f"got {tower.dtype} {tuple(tower.shape)} on {tower.device}")
    if points.device.type == "cpu":
        return points_binary_plain(points, mask, tower, grid_shape)
    b, n, n_x, n_y, n_z = _check_launch_shape(points, grid_shape)
    size = n_x * n_y * n_z
    points, mask, tower = points.contiguous(), mask.contiguous(), tower.contiguous()
    dev = points.device
    out_x = torch.empty((b, size), dtype=torch.float32, device=dev)
    out_y = torch.empty((b, size), dtype=torch.float32, device=dev)
    counts = torch.zeros((b, size), dtype=torch.int32, device=dev)
    flags = torch.zeros((b, size), dtype=torch.uint8, device=dev)
    colmin = torch.empty((b, n_y), dtype=torch.int32, device=dev)
    params = torch.empty((b, 6), dtype=torch.float32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.snt_points_binary(
            points.data_ptr(), mask.data_ptr(), tower.data_ptr(), out_x.data_ptr(),
            out_y.data_ptr(), counts.data_ptr(), flags.data_ptr(), colmin.data_ptr(),
            params.data_ptr(), b, n, n_x, n_y, n_z, ctypes.c_void_p(stream))
    _build.check(err, "points_binary")
    BINARY_LAUNCHES.add()
    return out_x, out_y
