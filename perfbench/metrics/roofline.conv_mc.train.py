"""The multi-channel conv kernel's share of its roofline in a UNet train
step: K10 (``ops/cuda_conv_mc.py`` ``conv3d_mc_same``), its forward at
every 3³ conv and its input gradient at every conv but the first, with the
weight split and the K-split reduction it launches, against the least time
each needs.

Work of one conv of C_in → C_out channels over B grids of S voxels: the
input, the 27·C_in·C_out weights and the output each moved once (f32),
2·27·B·S·C_in·C_out FLOPs; its input gradient moves the output's
cotangent, the weights and the input's, and takes as many FLOPs.
"""

import re

from perfbench.peaks import bound_s
from perfbench.reference.unet import conv_layers

KERNELS = re.compile(r"\bconv3d_mc_(tc_)?kernel\b|\bconv3d_mc_(split|reduce)_kernel\b")


def work(batch: int, layers):
    """[(bytes, flops)] of the forward and input-gradient convs of a step."""
    out = []
    for i, (cin, cout, edge) in enumerate(layers):
        voxels = edge ** 3
        moved = (batch * voxels * (cin + cout) + 27 * cin * cout) * 4
        flops = 2.0 * 27 * batch * voxels * cin * cout
        out.append((moved, flops))
        if i:  # the first conv's input is the data: no gradient taken
            out.append((moved, flops))
    return out


def read(ctx):
    steps = ctx.counters.get("steps", 0)
    seconds = ctx.trace.kernel_seconds(KERNELS)
    if not steps or seconds <= 0:
        return None
    layers = conv_layers(ctx.config, ctx.config["voxel_grid_size"][0])
    bound = sum(bound_s(b, f, ctx.config["precision"])
                for b, f in work(ctx.traffic["batch_size"], layers))
    return bound * steps / seconds * 100.0
