"""The weight gradient's kernel's share of its roofline in a UNet train
step: K10's dw (``ops/cuda_conv_mc.py`` ``conv3d_mc_weight_grad``,
``csrc/conv3d_mc_dw.cu``), its kernel and its K split's reduction at every
3³ conv, against the least time each needs.

Work of one conv's dw, C_in → C_out channels over B grids of S voxels: the
input and the output's cotangent each read once, the 27·C_in·C_out weight
gradient written once (f32), 2·27·B·S·C_in·C_out FLOPs. Every conv's dw is
taken, the first's too (its weights train). Silent where the kernels did
not run (the library's dw has other names).
"""

import re

from perfbench.peaks import bound_s
from perfbench.reference.unet import conv_layers

KERNELS = re.compile(r"\bconv3d_mc_dw_(reduce_)?kernel\b")


def work(batch: int, layers):
    """[(bytes, flops)] of the weight gradients of a step."""
    return [((batch * edge ** 3 * (cin + cout) + 27 * cin * cout) * 4,
             2.0 * 27 * batch * edge ** 3 * cin * cout) for cin, cout, edge in layers]


def read(ctx):
    steps = ctx.counters.get("steps", 0)
    seconds = ctx.trace.kernel_seconds(KERNELS)
    if not steps or seconds <= 0:
        return None
    layers = conv_layers(ctx.config, ctx.config["voxel_grid_size"][0])
    bound = sum(bound_s(b, f, ctx.config["precision"])
                for b, f in work(ctx.traffic["batch_size"], layers))
    return bound * steps / seconds * 100.0
