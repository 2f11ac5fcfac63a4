"""The served dispatch's share of the card's peak: SceneNet's forward
convolution, 2·T·B·S FLOPs a dispatch of B grids of S voxels (T taps),
times the dispatches of the traced window, over the window, over the peak
of the configuration's precision."""

import math

from perfbench.peaks import FLOPS


def read(ctx):
    dispatches = ctx.counters.get("dispatches", 0)
    if not dispatches:
        return None
    cfg = ctx.config
    flops = (2.0 * math.prod(cfg["kernel_size"]) * ctx.traffic["batch_size"]
             * math.prod(cfg["voxel_grid_size"]) * dispatches)
    return flops / ctx.trace.window_s / FLOPS[cfg["precision"]] * 100.0
