"""K5's share of its roofline on the served dispatch: the tensor-core
GENEO stencil (``ops/cuda_conv.py`` ``geneo_stencil_conv_mxu``) with the
relu∘tanh head, against the least time it needs.

Work a dispatch of B grids of S voxels and a kernel of T taps: x read and
the f32 probabilities written once, 2·T·B·S FLOPs of the model's
arithmetic (however many products the split form takes).
"""

import math
import re

from perfbench.peaks import bound_s

KERNELS = re.compile(r"\bstencil_mma_kernel\b")


def work(batch: int, voxels: int, taps: int):
    return 2 * batch * voxels * 4 + taps * 4, 2.0 * taps * batch * voxels


def read(ctx):
    dispatches = ctx.counters.get("dispatches", 0)
    seconds = ctx.trace.kernel_seconds(KERNELS)
    if not dispatches or seconds <= 0:
        return None
    b, f = work(ctx.traffic["batch_size"], math.prod(ctx.config["voxel_grid_size"]),
                math.prod(ctx.config["kernel_size"]))
    return bound_s(b, f, ctx.config["precision"]) * dispatches / seconds * 100.0
