"""Host-side DBSCAN (pure numpy, grid-hashed) for instance extraction.

The port's own copy of :mod:`scenenet_tpu.ops.dbscan`.

The reference delegates clustering to Open3D's C++ DBSCAN
(``utils/pcd_processing.py:577-589``). This implementation uses an
eps-sized voxel hash so neighbor queries only scan the 27 adjacent cells,
giving near-linear behavior on LiDAR crops; it returns the same label
contract (``-1`` = noise, clusters numbered from 0).
"""

from __future__ import annotations

from collections import deque
from typing import List

import numpy as np


def dbscan(points: np.ndarray, eps: float, min_points: int) -> np.ndarray:
    """Cluster ``points`` (N, d); returns (N,) int labels, -1 for noise.

    A point is a core point if its eps-neighborhood (including itself)
    holds ≥ ``min_points`` points, matching Open3D's convention.
    """
    points = np.asarray(points, np.float64)
    n = len(points)
    if n == 0:
        return np.empty(0, np.int64)

    cell = np.floor(points / eps).astype(np.int64)
    order = np.lexsort(cell.T[::-1])
    sorted_cells = cell[order]
    # group point indices per occupied cell
    uniq, starts = np.unique(sorted_cells, axis=0, return_index=True)
    cell_map = {}
    bounds = np.append(starts, n)
    for i, c in enumerate(map(tuple, uniq)):
        cell_map[c] = order[bounds[i]:bounds[i + 1]]

    offsets = np.array(np.meshgrid(*([[-1, 0, 1]] * points.shape[1]))).T.reshape(-1, points.shape[1])
    eps2 = eps * eps

    def neighbors(i: int) -> np.ndarray:
        c = cell[i]
        cand: List[np.ndarray] = []
        for off in offsets:
            grp = cell_map.get(tuple(c + off))
            if grp is not None:
                cand.append(grp)
        cand = np.concatenate(cand)
        d2 = np.sum((points[cand] - points[i]) ** 2, axis=1)
        return cand[d2 <= eps2]

    labels = np.full(n, -2, np.int64)  # -2 = unvisited
    cluster = 0
    for i in range(n):
        if labels[i] != -2:
            continue
        nbrs = neighbors(i)
        if len(nbrs) < min_points:
            labels[i] = -1
            continue
        labels[i] = cluster
        queue = deque(nbrs)
        while queue:
            j = queue.popleft()
            if labels[j] == -1:
                labels[j] = cluster  # border point
            if labels[j] != -2:
                continue
            labels[j] = cluster
            j_nbrs = neighbors(j)
            if len(j_nbrs) >= min_points:
                queue.extend(j_nbrs)
        cluster += 1
    return labels


def extract_clusters(points: np.ndarray, eps: float, min_points: int) -> List[np.ndarray]:
    """Points of each cluster (noise dropped) — twin of the reference's
    ``eda.extract_towers`` (``pcd_processing.py:608-652``)."""
    labels = dbscan(points, eps, min_points)
    return [points[labels == c] for c in range(labels.max() + 1)] if len(labels) else []
