"""Tower-proposal post-processing: prediction grid → tower coordinates.

The port's own copy of :mod:`scenenet_tpu.utils.proposals`, over the
port's DBSCAN, centroid and grid helpers: the reference's evaluation
pipeline (``utils/observer_utils.py:397-582``), DBSCAN over the predicted
voxels, centroid aggregation (<1.5 merge), wall/border filtering by height
and xy variance, and Euclidean-distance evaluation against ground-truth
towers. Pure numpy on the host.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from scenenet_tpu_torch.data.pcd import xyz_centroid
from scenenet_tpu_torch.ops.dbscan import extract_clusters
from scenenet_tpu_torch.ops.voxel_np import prob_to_label_np, vxg_to_xyz_np

TOWER_HEIGHT = 14.0   # avg tower height from the reference's EDA
CROP_RADIUS = 15.0    # Labelec sample crop radius
MERGE_DIST = 1.5      # centroid merge distance


def grid_to_tower_points(grid: np.ndarray, tau: Optional[float] = None) -> np.ndarray:
    """Thresholded grid → (N, 3) voxel-coordinate points of positives.

    Dense grids are indexed (z, x, y); columns are reordered to (x, y, z)
    so downstream xy/height logic reads naturally.
    """
    grid = np.squeeze(np.asarray(grid))
    if tau is not None:
        grid = prob_to_label_np(grid, tau)
    pts = vxg_to_xyz_np(grid)
    pts = pts[pts[:, 3] >= 1.0]
    return pts[:, [1, 2, 0]]


def extract_towers_from_grid(
    grid: np.ndarray, eps: float = 3.5, min_points: int = 18,
    tau: Optional[float] = None,
) -> Tuple[List[np.ndarray], np.ndarray]:
    """DBSCAN clusters + per-cluster median centroids
    (reference ``extract_towers``, ``observer_utils.py:397-408``)."""
    pts = grid_to_tower_points(grid, tau)
    if len(pts) == 0:
        return [], np.empty((0, 3))
    towers = extract_clusters(pts, eps=eps, min_points=min_points)
    if not towers:
        return [], np.empty((0, 3))
    centroids = np.vstack([xyz_centroid(t) for t in towers])
    return towers, centroids


def aggregate_centroids(centroids: np.ndarray, merge_dist: float = MERGE_DIST) -> np.ndarray:
    """Merge xy-centroids closer than ``merge_dist`` by local averaging
    (reference ``observer_utils.py:476-500``; z is dropped)."""
    if len(centroids) == 0:
        return np.empty((0, 2))
    xy = centroids[:, :2]
    merged = []
    for c in xy:
        d = np.linalg.norm(xy - c, axis=1)
        merged.append(xy[d <= merge_dist].mean(axis=0))
    return np.unique(np.asarray(merged), axis=0)


def filter_towers(
    towers: List[np.ndarray],
    centroids: np.ndarray,
    grid_center_xy: np.ndarray,
    threshold: float,
    tower_height: float = TOWER_HEIGHT,
    radius: float = CROP_RADIUS,
) -> Tuple[List[np.ndarray], np.ndarray]:
    """Drop wall-like clusters (too flat + too wide) and border clusters
    (reference ``observer_utils.py:503-549``)."""
    keep = np.zeros(len(towers), bool)
    for i, t in enumerate(towers):
        t_min, t_max = t.min(axis=0), t.max(axis=0)
        xy_var = np.max(t_max[:2] - t_min[:2])
        height = t_max[2] - t_min[2]
        keep[i] = height >= tower_height or xy_var <= threshold
        border = np.sum((centroids[i][:2] - grid_center_xy) ** 2) > (radius - 2 * threshold) ** 2
        keep[i] = keep[i] and not border
    return [t for i, t in enumerate(towers) if keep[i]], centroids[keep]


def get_tower_proposals(
    pred_grid: np.ndarray,
    density_grid: Optional[np.ndarray] = None,
    min_dist: float = 3.5,
    min_points: int = 18,
    tau: Optional[float] = 0.65,
) -> np.ndarray:
    """Prediction grid → (C, 2) xy tower-proposal coordinates
    (reference ``get_tower_proposals``, ``observer_utils.py:556-582``)."""
    towers, centroids = extract_towers_from_grid(pred_grid, eps=min_dist,
                                                 min_points=min_points, tau=tau)
    if len(towers) >= 1:
        if density_grid is not None:
            occupied = grid_to_tower_points(density_grid, tau=1e-9)
            center_xy = occupied.mean(axis=0)[:2] if len(occupied) else np.zeros(2)
        else:
            # grids are (z, x, y)-indexed and centroids live in (x, y):
            # the center must come from dims 1 and 2, not [:2] = (z, x)
            # (latent for cubic grids only)
            shp = np.squeeze(pred_grid).shape
            center_xy = np.asarray(shp[1:3], np.float64) / 2
        towers, centroids = filter_towers(towers, centroids, center_xy, min_dist / 2)
    return aggregate_centroids(centroids)


def compute_euc_dists(
    pred_grid: np.ndarray,
    gt_grid: np.ndarray,
    min_dist: float = 3.5,
    min_points: int = 18,
    tau: Optional[float] = 0.65,
) -> List[Tuple[np.ndarray, Optional[np.ndarray], float]]:
    """Per GT tower: (gt_xy, closest_proposal_xy | None, distance)
    (reference ``observer_utils.py:413-473``)."""
    _, pred_c = extract_towers_from_grid(pred_grid, eps=min_dist,
                                         min_points=min_points, tau=tau)
    _, gt_c = extract_towers_from_grid(gt_grid, eps=min_dist,
                                       min_points=min_points, tau=tau)
    if len(pred_c) == 0:
        return [(g[:2], None, 0.0) for g in gt_c]
    merged = aggregate_centroids(pred_c)
    out = []
    for g in gt_c:
        d = np.linalg.norm(merged - g[:2], axis=1)
        j = int(np.argmin(d))
        out.append((g[:2], merged[j], float(d[j])))
    return out
