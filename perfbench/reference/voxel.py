"""Voxelization of padded point batches, as the reference implementation
defines it (pyntcloud's regular bounding box and its searchsorted-left
edge rule), in the two f32 recipes the served and trained paths follow.

- The multiply recipe ``(p − lo) · (n / (hi − lo))`` bins the occupancy and
  tower grids (training and serving).
- The divide recipe ``(p − lo) / ((hi − lo) / n)`` bins the served
  voxel→point gather.

The grid is laid out (z, x, y); ``grid`` is given as (n_x, n_y, n_z).
"""

from __future__ import annotations

from typing import Tuple

import torch

_BIG = 3.4e38  # the masked-bound sentinel of the multiply recipe


def edge_bins(rel: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """``clip(ceil(rel − 1e-4) − 1, 0, n − 1)``: an interior edge belongs to
    the lower bin; NaN goes to bin 0."""
    c = torch.nan_to_num(torch.ceil(rel - 1e-4), nan=0.0)
    return torch.minimum(torch.clamp(c, min=1.0), n).to(torch.int64) - 1


def _flat(idx: torch.Tensor, grid: Tuple[int, int, int]) -> torch.Tensor:
    n_x, n_y, _ = grid
    return (idx[..., 2] * n_x + idx[..., 0]) * n_y + idx[..., 1]


def ids_multiply(points: torch.Tensor, mask: torch.Tensor,
                 grid: Tuple[int, int, int]) -> torch.Tensor:
    """(B, N) flat bin ids by the multiply recipe, each sample in its own
    masked bounding cube."""
    m = mask[..., None]
    low = torch.where(m, points, _BIG).amin(dim=1)
    high = torch.where(m, points, -_BIG).amax(dim=1)
    r = high - low
    half = (r.amax(dim=1, keepdim=True) - r) * 0.5
    lo, hi = low - half, high + half
    n = torch.tensor(grid, dtype=torch.float32, device=points.device)
    inv_step = n / torch.clamp(hi - lo, min=1e-30)
    return _flat(edge_bins((points - lo[:, None]) * inv_step[:, None], n), grid)


def ids_divide(points: torch.Tensor, mask: torch.Tensor,
               grid: Tuple[int, int, int]) -> torch.Tensor:
    """(B, N) flat bin ids by the divide recipe."""
    m = mask[..., None]
    big = torch.finfo(torch.float32).max
    low = torch.where(m, points, big).amin(dim=-2)
    high = torch.where(m, points, -big).amax(dim=-2)
    rng = high - low
    margin = rng.amax(dim=-1, keepdim=True) - rng
    lo, hi = (low - margin / 2)[:, None], (high + margin / 2)[:, None]
    n = torch.tensor(grid, dtype=torch.float32, device=points.device)
    return _flat(edge_bins((points - lo) / ((hi - lo) / n), n), grid)


def counts(flat: torch.Tensor, keep: torch.Tensor, size: int) -> torch.Tensor:
    """(B, size) int64 point counts of the ids where ``keep`` is set."""
    b = flat.shape[0]
    offs = torch.arange(b, device=flat.device)[:, None] * size
    ids = torch.where(keep, flat + offs, b * size)
    return torch.bincount(ids.reshape(-1), minlength=b * size + 1)[: b * size].reshape(b, size)


def occupancy(points: torch.Tensor, mask: torch.Tensor, grid: Tuple[int, int, int]
              ) -> torch.Tensor:
    """(B, Z, X, Y) f32 {0, 1}: a voxel's count above the least count of its
    y column (the reference's histogram binarized as ``> 0`` after the
    per-column min-max)."""
    n_x, n_y, n_z = grid
    c = counts(ids_multiply(points, mask, grid), mask, n_x * n_y * n_z)
    cols = c.reshape(c.shape[0], -1, n_y)
    occ = (cols > cols.amin(dim=1, keepdim=True)).to(torch.float32)
    return occ.reshape(c.shape[0], n_z, n_x, n_y)


def training_grids(points: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
                   keep_labels, grid: Tuple[int, int, int]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x, y) (B, 1, Z, X, Y) f32 {0, 1}: occupancy, and tower presence
    (some valid point with a label of ``keep_labels`` in the voxel)."""
    n_x, n_y, n_z = grid
    tower = torch.zeros_like(mask)
    for k in keep_labels:
        tower |= labels == k
    flat = ids_multiply(points, mask, grid)
    b = points.shape[0]
    x = occupancy(points, mask, grid)
    y = (counts(flat, mask & tower, n_x * n_y * n_z) > 0).to(torch.float32)
    return x[:, None], y.reshape(b, n_z, n_x, n_y)[:, None]


def gather(grid_values: torch.Tensor, flat: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-point values of (B, Z, X, Y) grids; padded points read 0."""
    vals = torch.gather(grid_values.reshape(grid_values.shape[0], -1), 1, flat)
    return torch.where(mask, vals, 0.0)
