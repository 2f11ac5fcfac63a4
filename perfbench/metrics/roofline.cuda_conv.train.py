"""The GENEO conv kernels' share of their roofline in a SceneNet train
step: K2's forward (``ops/cuda_conv.py`` ``geneo_stencil_conv``) and K4's
kernel gradient (``stencil_dk``, its reduction pass included), against the
least time each needs.

Work a step of B grids of S voxels and a kernel of T taps: the forward
reads x and writes the output (f32), 2·T·B·S FLOPs; the kernel gradient
reads x and the output's cotangent and writes T values, 2·T·B·S FLOPs.
"""

import math
import re

from perfbench.peaks import bound_s

KERNELS = re.compile(r"\bstencil(_fast)?_kernel\b|\bstencil_dk(_fast)?_kernel\b"
                     r"|\breduce_taps_kernel\b")


def work(batch: int, voxels: int, taps: int):
    """[(bytes, flops)] of the forward and the kernel gradient of one step."""
    flops = 2.0 * taps * batch * voxels
    return [(2 * batch * voxels * 4 + taps * 4, flops),
            (2 * batch * voxels * 4 + taps * 4, flops)]


def read(ctx):
    steps = ctx.counters.get("steps", 0)
    seconds = ctx.trace.kernel_seconds(KERNELS)
    if not steps or seconds <= 0:
        return None
    parts = work(ctx.traffic["batch_size"], math.prod(ctx.config["voxel_grid_size"]),
                 math.prod(ctx.config["kernel_size"]))
    bound = sum(bound_s(b, f, ctx.config["precision"]) for b, f in parts)
    return bound * steps / seconds * 100.0
