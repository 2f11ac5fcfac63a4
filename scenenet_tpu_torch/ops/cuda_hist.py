"""Raw points → binarized voxel occupancy: the CUDA kernel and its plain twin.

``points_occupancy`` is the port of the TPU kernel
``scenenet_tpu.ops.pallas_hist.pallas_points_occupancy``: per sample, the
masked bounding box expanded to a cube, each valid point's flat (z, x, y)
bin id by the multiply recipe ``(p − lo)·(n / range)`` with the pyntcloud
edge rule, the counts, and ``count > min of its y column`` as float {0, 1}.
Unlike the TPU kernel it takes any grid.

For a CUDA tensor it launches ``csrc/points_occupancy.cu``; for a CPU
tensor it runs :func:`points_occupancy_plain`, which follows the same f32
recipe op by op, so the two are bit-identical.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from scenenet_tpu_torch.ops import _build

LAUNCHES = _build.LaunchCounter("points_occupancy")

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


def points_occupancy_plain(points: torch.Tensor, mask: torch.Tensor,
                           grid_shape: Tuple[int, int, int]) -> torch.Tensor:
    """Plain PyTorch version: (B, N, 3) f32 + (B, N) bool → (B, size) f32."""
    b = points.shape[0]
    n_x, n_y, n_z = grid_shape
    size = n_x * n_y * n_z
    lo, inv_step = _cube_bounds_mul(points, mask, grid_shape)
    n = torch.tensor(grid_shape, dtype=torch.float32, device=points.device)
    idx = edge_bins((points - lo[:, None]) * inv_step[:, None], n)
    flat = (idx[..., 2] * n_x + idx[..., 0]) * n_y + idx[..., 1]
    offs = torch.arange(b, device=points.device)[:, None] * size
    ids = torch.where(mask, flat + offs, b * size)
    counts = torch.bincount(ids.reshape(-1), minlength=b * size + 1)[: b * size]
    counts = counts.reshape(b, -1, n_y)
    colmin = counts.amin(dim=1, keepdim=True)
    return (counts > colmin).to(torch.float32).reshape(b, size)


def points_occupancy(points: torch.Tensor, mask: torch.Tensor,
                     grid_shape: Tuple[int, int, int]) -> torch.Tensor:
    """(B, N, 3) f32 points + (B, N) bool mask → (B, n_z·n_x·n_y) f32 {0,1}
    occupancy in (z, x, y) order. ``grid_shape`` is (n_x, n_y, n_z).

    A CPU tensor takes :func:`points_occupancy_plain`; a CUDA tensor
    launches the kernel or raises.
    """
    if points.ndim != 3 or points.shape[2] != 3:
        raise ValueError(f"points must be (B, N, 3), got {tuple(points.shape)}")
    if mask.shape != points.shape[:2]:
        raise ValueError(f"mask must be {tuple(points.shape[:2])}, got {tuple(mask.shape)}")
    if points.dtype != torch.float32 or mask.dtype != torch.bool:
        raise TypeError(f"need float32 points and bool mask, got {points.dtype}, {mask.dtype}")
    if points.device != mask.device:
        raise ValueError(f"points on {points.device}, mask on {mask.device}")
    if points.device.type == "cpu":
        return points_occupancy_plain(points, mask, grid_shape)
    if points.device.type != "cuda":
        raise ValueError(f"no occupancy kernel for device {points.device}")
    b, n, _ = points.shape
    n_x, n_y, n_z = (int(g) for g in grid_shape)
    size = n_x * n_y * n_z
    if min(b, n, n_x, n_y, n_z) < 1 or b * size >= 2**31 or n >= 2**31:
        raise ValueError(f"unsupported occupancy shape B={b} N={n} grid={grid_shape}")
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
