"""K1's share of its roofline on the served dispatch: the occupancy
kernel (``ops/cuda_hist.py`` ``points_occupancy``), all four of its
passes, against the least time its bytes need.

Work a dispatch of B tiles padded to N points on a grid of S voxels: the
points (12 bytes a point) and the mask (1 byte) read once, the f32
occupancy grid written once; no arithmetic worth a bound.
"""

import math
import re

from perfbench.peaks import bound_s

KERNELS = re.compile(r"\b(bounds|mark|expand|full_column)_kernel\b")


def work(batch: int, points: int, voxels: int):
    """(bytes, flops) of one call."""
    return batch * points * (12 + 1) + batch * voxels * 4, 0.0


def read(ctx):
    dispatches = ctx.counters.get("dispatches", 0)
    seconds = ctx.trace.kernel_seconds(KERNELS)
    if not dispatches or seconds <= 0:
        return None
    b, f = work(ctx.traffic["batch_size"], ctx.traffic["points"]["pad"],
                math.prod(ctx.config["voxel_grid_size"]))
    return bound_s(b, f, ctx.config["precision"]) * dispatches / seconds * 100.0
