"""Point padding for the on-device voxelization path.

Twin of :class:`scenenet_tpu.data.transforms.PointPadding` with
``compute_indices=False``, the route of the JAX package's native batch
loader: the device computes the bins from the raw coordinates, so no host
bin index is made.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class PointPadding:
    """(points, labels) → fixed-size (points, labels, mask, flat_idx).

    - points are centered by their own float64 min and cast to float32;
    - clouds longer than ``max_points`` are uniformly subsampled
      (deterministic per sample length);
    - ``flat_idx`` is zeros: the bins are computed on the device.
    """

    max_points: int = 65536
    compute_indices: bool = False

    def __post_init__(self):
        if self.compute_indices:
            raise NotImplementedError(
                "PointPadding(compute_indices=True) (the host-exact bin index of "
                "the use_indices route) is not ported yet: ROADMAP B8")

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
        mask = np.zeros(self.max_points, bool)
        out_pts[:n] = (pts - pts.min(0)).astype(np.float32)
        out_lab[:n] = np.asarray(labels[:n], np.int32)
        mask[:n] = True
        return out_pts, out_lab, mask, np.zeros(self.max_points, np.int32)
