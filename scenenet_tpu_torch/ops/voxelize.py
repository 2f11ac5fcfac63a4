"""Device-side voxelization: padded raw points → voxel grids and back.

PyTorch twin of :mod:`scenenet_tpu.ops.voxelize`. Point clouds are padded
to a fixed N with a boolean mask; the batched functions take (B, N, 3) and
work on the device of their inputs, the single-sample ones are thin calls
of them with B = 1.

Two f32 binning recipes exist, as in the JAX package, and each function
states which it follows:

- the **divide** recipe ``(p − lo) / ((hi − lo) / n)`` of
  :func:`voxel_indices` and :func:`batch_flat_ids`: the voxel→point gather
  ids, the single-sample functions, and every batched function at the grid
  sizes where :func:`_use_sorted_hist` holds;
- the **multiply** recipe ``(p − lo) · (n / (hi − lo))`` of the raw-points
  kernels, which the batched functions follow below those sizes.

They agree except for points within an f32 rounding of the 1e-4 edge bias.
This is the routing of the JAX package on its accelerator, so the two
packages put every point of a given input in the same bin.

Which kernel counts: the raw-points kernels (``points_occupancy``,
``points_binary``, ``points_bin_counts``) below the sorted sizes;
``batch_flat_ids`` and ``sorted_bin_counts`` at them; for bin ids computed
on the host, ``bin_counts`` below and ``sorted_bin_counts`` at them. A CPU
tensor takes each kernel's plain version.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from scenenet_tpu_torch.ops.cuda_hist import (
    ID_ROW, above_column_min, bin_counts, edge_bins, points_bin_counts, points_binary,
    points_occupancy, sorted_bin_counts,
)

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


def normalize_per_column(grid: torch.Tensor) -> torch.Tensor:
    """Per-y-column minmax over all other axes, in the grid's dtype: each
    column of ``grid.reshape(-1, n_y)`` is scaled by its own min and max; a
    constant column scales by 1 (and so maps to 0). Device twin of
    :func:`scenenet_tpu_torch.ops.voxel_np.normalize_per_column_np`."""
    return _normalize_columns(grid[None])[0]


def _normalize_columns(grids: torch.Tensor) -> torch.Tensor:
    """:func:`normalize_per_column` of every sample of a (B, …, n_y) stack."""
    flat = grids.reshape(grids.shape[0], -1, grids.shape[-1])
    lo = flat.amin(dim=1, keepdim=True)
    hi = flat.amax(dim=1, keepdim=True)
    scale = torch.where(hi - lo == 0, torch.ones_like(lo), hi - lo)
    return ((flat - lo) / scale).reshape(grids.shape)


def _use_sorted_hist(n_hi: int, n_points: int, size: int) -> bool:
    """The one routing predicate of the histogram paths, the JAX package's
    own (``n_hi = ceil(size / 512)``): a grid of more than 4096 such rows,
    or of more than 512 with at least 1e11 points × bins a sample, takes
    ids from :func:`batch_flat_ids` and counts from ``sorted_bin_counts``.
    The thresholds are kept as they are so that both packages bin a given
    input by the same recipe; they were not chosen for this card, where
    either kernel serves any size."""
    return n_hi > 4096 or (n_hi > 512 and n_points * size >= int(1e11))


def _sorted_route(n_points: int, grid_shape: Tuple[int, int, int]) -> bool:
    size = grid_shape[0] * grid_shape[1] * grid_shape[2]
    return _use_sorted_hist(-(-size // ID_ROW), n_points, size)


def _is_tower(labels: torch.Tensor, keep_labels: Tuple[int, ...]) -> torch.Tensor:
    """(…) bool: the label is one of ``keep_labels``."""
    is_tower = torch.zeros(labels.shape, dtype=torch.bool, device=labels.device)
    for lbl in keep_labels:
        is_tower |= labels == lbl
    return is_tower


def _counts_from_points(points: torch.Tensor, mask: torch.Tensor,
                        tower: Optional[torch.Tensor], grid_shape: Tuple[int, int, int],
                        channels: int) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(B, size) f32 counts [and tower counts] from raw points: the
    raw-points kernel (multiply recipe), or at the sorted sizes the divide
    recipe's ids and the sorted kernel."""
    n_x, n_y, n_z = grid_shape
    if _sorted_route(points.shape[1], grid_shape):
        flat = batch_flat_ids(points, mask, grid_shape)
        return sorted_bin_counts(flat, mask, tower, n_x * n_y * n_z, channels=channels)
    return points_bin_counts(points, mask, tower, grid_shape, channels=channels)


def _hist_reg(counts: torch.Tensor, tower: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Counts and tower counts → (per-column-normalized density, fraction
    of tower points per voxel, 0 where empty)."""
    reg = torch.where(counts > 0, tower / torch.clamp(counts, min=1.0),
                      torch.zeros_like(counts))
    return _normalize_columns(counts), reg


def voxelize_batch_occupancy(points: torch.Tensor, mask: torch.Tensor,
                             grid_shape: Tuple[int, int, int] = (64, 64, 64)
                             ) -> torch.Tensor:
    """Binarized occupancy grids (B, n_z, n_x, n_y) float32 {0, 1}:
    ``count > min of its y column`` (exactly ``voxelize_batch_hist(...) >
    0``).

    Below the sorted sizes the occupancy kernel does it all (multiply
    recipe); at them the counts come from :func:`batch_flat_ids` and the
    sorted kernel (divide recipe). Any grid shape is taken.
    """
    n_x, n_y, n_z = grid_shape
    b = points.shape[0]
    if not _sorted_route(points.shape[1], grid_shape):
        return points_occupancy(points, mask, grid_shape).reshape(b, n_z, n_x, n_y)
    counts, _ = _counts_from_points(points, mask, None, grid_shape, channels=1)
    return above_column_min(counts, n_y).reshape(b, n_z, n_x, n_y)


def voxelize_batch_binary(points: torch.Tensor, labels: torch.Tensor,
                          mask: torch.Tensor, keep_labels: Tuple[int, ...] = (15,),
                          grid_shape: Tuple[int, int, int] = (64, 64, 64)
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training grids: (B, N, 3) f32 points, (B, N) int labels and a
    (B, N) bool mask → (x, y), each (B, n_z, n_x, n_y) float32 {0, 1}.

    x is the occupancy (``count > min of its y column``), y the tower
    presence (some valid point with a label in ``keep_labels`` lands in
    the voxel). Below the sorted sizes the two-channel kernel does it all
    (multiply recipe); at them the counts come from :func:`batch_flat_ids`
    and the sorted kernel (divide recipe). Any grid shape is taken.
    """
    n_x, n_y, n_z = grid_shape
    b = points.shape[0]
    tower = _is_tower(labels, keep_labels) & mask
    if not _sorted_route(points.shape[1], grid_shape):
        x, y = points_binary(points, mask, tower, grid_shape)
        return x.reshape(b, n_z, n_x, n_y), y.reshape(b, n_z, n_x, n_y)
    counts, towers = _counts_from_points(points, mask, tower, grid_shape, channels=2)
    return (above_column_min(counts, n_y).reshape(b, n_z, n_x, n_y),
            (towers > 0).to(torch.float32).reshape(b, n_z, n_x, n_y))


def voxelize_batch(points: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
                   keep_labels: Tuple[int, ...] = (15,),
                   grid_shape: Tuple[int, int, int] = (64, 64, 64)
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, N, 3) points, (B, N) labels and mask → (hist, reg), each
    (B, n_z, n_x, n_y) float32: the per-column-normalized point counts (the
    model's density input) and the fraction of points with a label in
    ``keep_labels`` per voxel (the regression target), from one pass over
    the points. Recipe and kernel as in :func:`_counts_from_points`."""
    n_x, n_y, n_z = grid_shape
    b = points.shape[0]
    tower = _is_tower(labels, keep_labels) & mask
    counts, towers = _counts_from_points(points, mask, tower, grid_shape, channels=2)
    return _hist_reg(counts.reshape(b, n_z, n_x, n_y), towers.reshape(b, n_z, n_x, n_y))


def voxelize_batch_hist(points: torch.Tensor, mask: torch.Tensor,
                        grid_shape: Tuple[int, int, int] = (64, 64, 64),
                        method: str = "mxu") -> torch.Tensor:
    """Batched density grids only, (B, n_z, n_x, n_y) float32. ``method``
    names a TPU formulation in the JAX package; it is accepted and ignored
    here (one kernel serves)."""
    n_x, n_y, n_z = grid_shape
    counts, _ = _counts_from_points(points, mask, None, grid_shape, channels=1)
    return _normalize_columns(counts.reshape(points.shape[0], n_z, n_x, n_y))


def _counts_from_flat(flat: torch.Tensor, mask: torch.Tensor,
                      tower: Optional[torch.Tensor], grid_shape: Tuple[int, int, int]
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(B, size) f32 counts [and tower counts, where ``tower`` is given]
    from (B, N) flat bin ids: ``bin_counts``, or ``sorted_bin_counts`` at
    the sorted sizes."""
    size = grid_shape[0] * grid_shape[1] * grid_shape[2]
    if _sorted_route(flat.shape[1], grid_shape):
        return sorted_bin_counts(flat, mask, tower, size,
                                 channels=1 if tower is None else 2)
    return bin_counts(flat, mask, size, weights=tower)


def _batch_from_flat(flat: torch.Tensor, is_tower: torch.Tensor, mask: torch.Tensor,
                     grid_shape: Tuple[int, int, int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, N) flat bin ids, tower flags and mask → (hist, reg)."""
    n_x, n_y, n_z = grid_shape
    b = flat.shape[0]
    counts, towers = _counts_from_flat(flat, mask, is_tower.to(torch.bool) & mask, grid_shape)
    return _hist_reg(counts.reshape(b, n_z, n_x, n_y), towers.reshape(b, n_z, n_x, n_y))


def voxelize_batch_from_indices(flat_idx: torch.Tensor, is_tower: torch.Tensor,
                                mask: torch.Tensor,
                                grid_shape: Tuple[int, int, int] = (64, 64, 64)
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bit-exact hybrid path, batched: (B, N) bin indices computed on
    the host in float64 (:func:`scenenet_tpu_torch.ops.voxel_np.voxel_indices_np`,
    flattened in (z, x, y) order; padded points carry ``mask=False``) →
    (hist, reg) as :func:`voxelize_batch` gives them, with the reference's
    binning reproduced point for point."""
    return _batch_from_flat(flat_idx, is_tower, mask, grid_shape)


# ---- single-sample forms: the batched ones at B = 1 ---------------------------
# ``method`` ('scatter' or 'sort') picks between two XLA formulations in the
# JAX package; it is accepted and ignored here. As there, these bin by the
# divide recipe at every grid size, within ``lo``/``hi`` where given.

def _sample_flat_ids(points, mask, grid_shape, lo, hi) -> torch.Tensor:
    if lo is None or hi is None:
        lo, hi = grid_bounds(points, mask)
    return _flat_zxy_idx(voxel_indices(points, lo, hi, grid_shape), grid_shape)


def voxelize_fused(points: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
                   keep_labels: Tuple[int, ...] = (15,),
                   grid_shape: Tuple[int, int, int] = (64, 64, 64),
                   lo: Optional[torch.Tensor] = None, hi: Optional[torch.Tensor] = None,
                   method: str = "scatter") -> Tuple[torch.Tensor, torch.Tensor]:
    """One sample: (N, 3) points, (N,) labels and mask → (hist, reg), each
    (n_z, n_x, n_y) float32."""
    flat = _sample_flat_ids(points, mask, grid_shape, lo, hi)
    hist, reg = _batch_from_flat(flat[None], _is_tower(labels, keep_labels)[None],
                                 mask[None], grid_shape)
    return hist[0], reg[0]


def voxelize_hist(points: torch.Tensor, mask: torch.Tensor,
                  grid_shape: Tuple[int, int, int] = (64, 64, 64),
                  lo: Optional[torch.Tensor] = None, hi: Optional[torch.Tensor] = None,
                  method: str = "scatter") -> torch.Tensor:
    """One sample's density grid only."""
    n_x, n_y, n_z = grid_shape
    flat = _sample_flat_ids(points, mask, grid_shape, lo, hi)
    counts, _ = _counts_from_flat(flat[None], mask[None], None, grid_shape)
    return normalize_per_column(counts.reshape(n_z, n_x, n_y))


def voxelize_reg(points: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
                 keep_labels: Tuple[int, ...] = (15,),
                 grid_shape: Tuple[int, int, int] = (64, 64, 64),
                 lo: Optional[torch.Tensor] = None, hi: Optional[torch.Tensor] = None,
                 method: str = "scatter") -> torch.Tensor:
    """One sample's tower-fraction grid only."""
    return voxelize_fused(points, labels, mask, keep_labels, grid_shape, lo, hi)[1]


def voxelize_from_indices(flat_idx: torch.Tensor, is_tower: torch.Tensor,
                          mask: torch.Tensor,
                          grid_shape: Tuple[int, int, int] = (64, 64, 64),
                          method: str = "scatter") -> Tuple[torch.Tensor, torch.Tensor]:
    """One sample of :func:`voxelize_batch_from_indices`: (N,) host-exact
    flat indices, tower flags and mask → (hist, reg)."""
    hist, reg = _batch_from_flat(flat_idx[None], is_tower[None], mask[None], grid_shape)
    return hist[0], reg[0]


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


def vxg_to_xyz(vxg: torch.Tensor, origin: Optional[torch.Tensor] = None,
               voxel_size: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dense 3-D grid → (n0·n1·n2, 4) rows ``origin + index · voxel_size``
    and the voxel's value, in the grid's own axis order and dtype."""
    axes = torch.meshgrid(*(torch.arange(n, dtype=vxg.dtype, device=vxg.device)
                            for n in vxg.shape), indexing="ij")
    points = torch.stack([a.reshape(-1) for a in axes], dim=1)
    if voxel_size is not None:
        points = points * voxel_size
    if origin is not None:
        points = points + origin
    return torch.cat([points, vxg.reshape(-1, 1)], dim=1)
