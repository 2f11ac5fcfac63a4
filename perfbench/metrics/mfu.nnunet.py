"""The nnU-Net train step's share of the card's peak: the network's conv
FLOPs a step, times the steps of the traced window, over the window, over
the peak of the configuration's precision.

Every 3³ conv (stride 1 or 2, C_in → C_out, output edge E, batch B): its
forward, 2·27·B·E³·C_in·C_out FLOPs, as many for its weight gradient and,
but at the first conv (its input is the data), for its input gradient.
Every transposed conv (kernel 2, stride 2, input edge E): 2·8·B·E³·C_in·C_out
each for its forward, input and weight gradients. Every 1×1×1 head:
2·B·E³·C·n_classes for its forward, and its two gradients where its loss
weight is not 0 (the 8³ head of weight 0 gets none). Nothing is read where
the traced steps made no call of the network's norm (the route's
``launches``): another cell's window, or a program without the network.
"""

from perfbench.peaks import FLOPS
from perfbench.reference.nnunet import conv_layers, head_layers, transposed_layers


def step_flops(config: dict, batch: int) -> float:
    grid = config["voxel_grid_size"][0]
    total = 0.0
    for i, (cin, cout, edge, _) in enumerate(conv_layers(config, grid)):
        total += 2.0 * 27 * batch * edge ** 3 * cin * cout * (3 if i else 2)
    for cin, cout, edge in transposed_layers(config, grid):
        total += 3 * 2.0 * 8 * batch * edge ** 3 * cin * cout
    for cin, edge, weight in head_layers(config, grid):
        total += 2.0 * batch * edge ** 3 * cin * config["n_classes"] * (3 if weight else 1)
    return total


def read(ctx):
    steps = ctx.counters.get("steps", 0)
    if not steps or not ctx.counters.get("launches", {}).get("instance_norm_lrelu"):
        return None
    flops = step_flops(ctx.config, ctx.traffic["batch_size"]) * steps
    return flops / ctx.trace.window_s / FLOPS[ctx.config["precision"]] * 100.0
