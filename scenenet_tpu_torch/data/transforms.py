"""Point padding for the on-device voxelization path.

Twin of :class:`scenenet_tpu.data.transforms.PointPadding` without its
native route: with ``compute_indices=False`` (the default here, the route
of the JAX package's native batch loader) the device computes the bins from
the raw coordinates and no host bin index is made; with
``compute_indices=True`` the host-exact index comes from the numpy oracle
:mod:`scenenet_tpu_torch.ops.voxel_np`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from scenenet_tpu_torch.ops import voxel_np as vnp


@dataclasses.dataclass
class PointPadding:
    """(points, labels) → fixed-size (points, labels, mask, flat_idx).

    - points are centered by their own float64 min and cast to float32;
    - clouds longer than ``max_points`` are uniformly subsampled
      (deterministic per sample length);
    - ``flat_idx`` is zeros unless ``compute_indices``: then it is each
      point's (z, x, y)-flattened bin in the grid fit to the sample
      (``vxg_size`` bins per axis, or ``vox_size`` voxel edge lengths, which
      override it), computed in float64 with pyntcloud's linspace +
      searchsorted rule, so that ``voxelize_batch_from_indices`` reproduces
      the reference's binning point for point. Padded points carry index 0
      with ``mask=False``.
    """

    max_points: int = 65536
    vxg_size: Tuple[int, int, int] = (64, 64, 64)
    vox_size: Optional[Tuple[float, float, float]] = None
    compute_indices: bool = False

    def __call__(self, sample):
        pts, labels = sample
        n = len(pts)
        if n > self.max_points:
            rng = np.random.default_rng(n)
            sel = rng.choice(n, self.max_points, replace=False)
            pts, labels = pts[sel], labels[sel]
            n = self.max_points
        out_pts = np.zeros((self.max_points, 3), np.float32)
        out_lab = np.zeros(self.max_points, np.int32)
        out_idx = np.zeros(self.max_points, np.int32)
        mask = np.zeros(self.max_points, bool)
        out_pts[:n] = (pts - pts.min(0)).astype(np.float32)
        out_lab[:n] = np.asarray(labels[:n], np.int32)
        mask[:n] = True
        if self.compute_indices:
            spec = vnp.compute_grid_spec(pts, self.vxg_size, self.vox_size)
            idx = vnp.voxel_indices_np(pts, spec)
            n_x, n_y, _ = spec.shape
            out_idx[:n] = ((idx[:, 2] * n_x + idx[:, 0]) * n_y + idx[:, 1]).astype(np.int32)
        return out_pts, out_lab, mask, out_idx
