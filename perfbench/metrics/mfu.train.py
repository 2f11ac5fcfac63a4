"""The train step's share of the card's peak: the model's convolution
FLOPs a step (forward, the input gradient where one is taken, the weight
or kernel gradient), times the steps of the traced window, over the
window, over the peak of the configuration's precision.

SceneNet (B grids of S voxels, T taps): the forward and the kernel
gradient, 2·T·B·S FLOPs each; the input is data, so no input gradient.
UNet: each 3³ conv's forward, weight gradient and (but the first) input
gradient, 2·27·B·S·C_in·C_out FLOPs each, and the 1×1×1 head's three.
"""

import math

from perfbench.peaks import FLOPS
from perfbench.reference.unet import conv_layers


def step_flops(config: dict, batch: int) -> float:
    voxels = math.prod(config["voxel_grid_size"])
    if config["model"] == "scenenet":
        return 2 * (2.0 * math.prod(config["kernel_size"]) * batch * voxels)
    total = 0.0
    for i, (cin, cout, edge) in enumerate(conv_layers(config, config["voxel_grid_size"][0])):
        conv = 2.0 * 27 * batch * edge ** 3 * cin * cout
        total += conv * (3 if i else 2)
    head = 2.0 * batch * voxels * config["channels"][0] * config["n_classes"]
    return total + 3 * head


def read(ctx):
    steps = ctx.counters.get("steps", 0)
    if not steps:
        return None
    flops = step_flops(ctx.config, ctx.traffic["batch_size"]) * steps
    return flops / ctx.trace.window_s / FLOPS[ctx.config["precision"]] * 100.0
