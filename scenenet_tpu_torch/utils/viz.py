"""Visualization export: voxel grids → colored point clouds, no GUI deps.

The port's own copy of :mod:`scenenet_tpu.utils.viz`, with the same color
tables and the same (z, x, y) → (x, y, z) reorder: the reference's
open3d-window plotting (``utils/voxelization.py:45-155, 364-398``) as
(N, 6) xyzrgb arrays and ASCII PLY files (density: blue↔white↔red;
ranges: 10-step jet with white-dropped zeros; pred-vs-GT composite
``(4·pred + gt)/5``). Pure numpy on the host: a caller holding a tensor
passes ``t.cpu().numpy()``.
"""

from __future__ import annotations

import numpy as np

# matplotlib-free 10-anchor jet approximation (r, g, b) per range
_JET10 = np.array([
    [1.0, 1.0, 1.0],   # range 0 forced white (dropped)
    [0.0, 0.2, 1.0],
    [0.0, 0.6, 1.0],
    [0.0, 1.0, 0.8],
    [0.3, 1.0, 0.4],
    [0.7, 1.0, 0.2],
    [1.0, 0.9, 0.0],
    [1.0, 0.6, 0.0],
    [1.0, 0.3, 0.0],
    [0.9, 0.0, 0.0],
])


def voxelgrid_to_points(grid: np.ndarray, color_mode: str = "density",
                        drop_white: bool = True) -> np.ndarray:
    """Nonzero voxels → (N, 6) array [x, y, z, r, g, b] ∈ [0,1] colors.

    ``density``: value<0 → blue-ish, ≈0 → white, >0 → red-ish (reference
    ``plot_voxelgrid`` 'density' scheme). ``ranges``: 10 jet bins over
    [0,1]; bin-0 (white) voxels dropped for visibility when ``drop_white``.
    Note the reference indexes the grid (z, x, y) and emits (x, y, z).
    """
    grid = np.asarray(grid)
    z, x, y = grid.nonzero()
    vals = grid[z, x, y]
    xyz = np.column_stack([x, y, z]).astype(np.float64)

    if color_mode == "density":
        c = np.clip(vals, -1, 1)
        rgb = np.empty((len(c), 3))
        neg = c < 0
        rgb[neg] = np.column_stack([1 + c[neg], 1 + c[neg], np.ones(neg.sum())])
        rgb[~neg] = np.column_stack([np.ones((~neg).sum()), 1 - c[~neg], 1 - c[~neg]])
    elif color_mode == "ranges":
        lin = np.linspace(0, 1, 10)
        step = (1 / 10) / 2
        idx = np.argmin(np.abs(vals[:, None] - lin[None, :] - step), axis=1)
        if drop_white:
            keep = vals > lin[1]
            xyz, vals, idx = xyz[keep], vals[keep], idx[keep]
        rgb = _JET10[idx]
    else:
        raise ValueError(f"color_mode must be 'density' or 'ranges', got {color_mode}")
    return np.concatenate([xyz, rgb], axis=1)


def pred_vs_gt_points(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """TP/FP/FN composite ``(4·pred + gt)/5`` colored by ranges
    (reference ``visualize_pred_vs_gt``, ``voxelization.py:364-398``):
    1.0 → TP, 0.8 → FP, 0.2 → FN."""
    composite = (4 * np.squeeze(pred) + np.squeeze(gt)) / 5
    return voxelgrid_to_points(composite, color_mode="ranges")


def write_ply(path: str, points: np.ndarray) -> None:
    """ASCII PLY export of an (N, 3) or (N, 6) xyz[rgb] array."""
    points = np.asarray(points)
    has_color = points.shape[1] >= 6
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(points)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if has_color:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for p in points:
            line = f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f}"
            if has_color:
                rgb = (np.clip(p[3:6], 0, 1) * 255).astype(int)
                line += f" {rgb[0]} {rgb[1]} {rgb[2]}"
            f.write(line + "\n")


def proposals_to_points(centroids_xy: np.ndarray, z_range=(0, 63),
                        color=(1.0, 0.0, 1.0)) -> np.ndarray:
    """Tower-proposal xy coordinates → vertical marker columns (N, 6), for
    overlaying proposals on an exported cloud (reference ``plot_centroids``,
    ``observer_utils.py:585-...``)."""
    cols = []
    for cx, cy in np.asarray(centroids_xy).reshape(-1, 2):
        zs = np.arange(z_range[0], z_range[1] + 1)
        col = np.column_stack([
            np.full_like(zs, cx, dtype=np.float64),
            np.full_like(zs, cy, dtype=np.float64),
            zs.astype(np.float64),
        ])
        cols.append(col)
    if not cols:
        return np.empty((0, 6))
    xyz = np.concatenate(cols)
    rgb = np.tile(np.asarray(color), (len(xyz), 1))
    return np.concatenate([xyz, rgb], axis=1)


def quantile_uncertainty_points(quantile_grids: np.ndarray) -> np.ndarray:
    """q_hi − q_lo spread grid → ranges-colored points (reference
    ``plot_quantile_uncertainty``, ``voxelization.py:147-155``)."""
    assert quantile_grids.ndim == 4 and quantile_grids.shape[0] >= 2
    spread = quantile_grids[-1] - quantile_grids[0]
    return voxelgrid_to_points(spread, color_mode="ranges")
