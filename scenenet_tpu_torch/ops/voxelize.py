"""Device-side voxelization: padded raw points → voxel grids and back.

PyTorch twin of the parts of :mod:`scenenet_tpu.ops.voxelize` that the
serving path runs. Point clouds are padded to a fixed N with a boolean
mask; every function takes a batch (B, N, 3) and works on the device of
its inputs.

Two f32 binning recipes exist, as in the JAX package, and each function
states which it follows:

- the **divide** recipe ``(p − lo) / ((hi − lo) / n)`` of
  :func:`voxel_indices`, used for the voxel→point gather ids;
- the **multiply** recipe ``(p − lo) · (n / (hi − lo))`` of the TPU
  occupancy kernel, used by :func:`voxelize_batch_occupancy`.

They agree except for points within an f32 rounding of the 1e-4 edge bias.
"""

from __future__ import annotations

from typing import Tuple

import torch

from scenenet_tpu_torch.ops.cuda_hist import edge_bins, points_occupancy

_F32_MAX = torch.finfo(torch.float32).max


def grid_bounds(points: torch.Tensor, mask: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked AABB over the point axis (dim −2), expanded to equal side
    lengths (pyntcloud's regular bounding box). (…, N, 3) → two (…, 3)."""
    m = mask[..., None]
    lo = torch.where(m, points, _F32_MAX).amin(dim=-2)
    hi = torch.where(m, points, -_F32_MAX).amax(dim=-2)
    rng = hi - lo
    margin = rng.amax(dim=-1, keepdim=True) - rng
    return lo - margin / 2, hi + margin / 2


def voxel_indices(points: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                  grid_shape: Tuple[int, int, int]) -> torch.Tensor:
    """Per-point (x, y, z) bin indices (int64) for an (n_x, n_y, n_z) grid,
    by the divide recipe. ``lo``/``hi`` broadcast against ``points``
    ((…, 1, 3) for batched points).

    pyntcloud's searchsorted-left rule: interior-edge points fall in the
    lower bin; ``v == lo`` falls in bin 0.
    """
    shape = torch.tensor(grid_shape, dtype=points.dtype, device=points.device)
    step = (hi - lo) / shape
    return edge_bins((points - lo) / step, shape)


def _flat_zxy_idx(idx: torch.Tensor, grid_shape: Tuple[int, int, int]) -> torch.Tensor:
    """Flatten (x, y, z) bins into the (z, x, y)-ordered dense grid."""
    n_x, n_y, _ = grid_shape
    return (idx[..., 2] * n_x + idx[..., 0]) * n_y + idx[..., 1]


def batch_flat_ids(points: torch.Tensor, mask: torch.Tensor,
                   grid_shape: Tuple[int, int, int]) -> torch.Tensor:
    """(B, N, 3) padded points → (B, N) int64 flat (z, x, y) bin ids, each
    sample binned in its own masked cube bounds (divide recipe)."""
    lo, hi = grid_bounds(points, mask)
    idx = voxel_indices(points, lo[:, None], hi[:, None], grid_shape)
    return _flat_zxy_idx(idx, grid_shape)


def voxelize_batch_occupancy(points: torch.Tensor, mask: torch.Tensor,
                             grid_shape: Tuple[int, int, int] = (64, 64, 64)
                             ) -> torch.Tensor:
    """Binarized occupancy grids (B, n_z, n_x, n_y) float32 {0, 1}:
    ``count > min of its y column`` (exactly the JAX
    ``voxelize_batch_hist(...) > 0``), by the multiply recipe.

    A CUDA tensor runs the occupancy kernel, a CPU tensor its plain
    version. Any grid shape is taken.
    """
    n_x, n_y, n_z = grid_shape
    occ = points_occupancy(points, mask, grid_shape)
    return occ.reshape(points.shape[0], n_z, n_x, n_y)


def gather_point_values(grid: torch.Tensor, flat_idx: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
    """Per-point values from a dense (z, x, y) grid: the voxel→point gather.
    Leading batch dims on all arguments; padded points read 0."""
    flat_grid = grid.reshape(*grid.shape[:-3], -1)
    vals = torch.gather(flat_grid, -1, flat_idx.to(torch.int64))
    return torch.where(mask, vals, torch.zeros((), dtype=vals.dtype, device=vals.device))


def prob_to_label(grid: torch.Tensor, tau: float) -> torch.Tensor:
    """Threshold probabilities to {0, 1}."""
    return (grid >= tau).to(grid.dtype)
