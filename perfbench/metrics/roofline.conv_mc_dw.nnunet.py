"""K10's weight-gradient kernel's share of its roofline in an nnU-Net
train step: ``conv3d_mc_weight_grad`` (``csrc/conv3d_mc_dw.cu``), its
kernel and its K split's reduction at the network's 17 stride-1 3³ convs,
against the least time each needs.

Work of one conv's dw, C_in → C_out channels over B grids of S voxels: the
input and the output's cotangent each read once, the 27·C_in·C_out weight
gradient written once (f32), 2·27·B·S·C_in·C_out FLOPs. The first conv's
weights train too. Nothing is read where the traced steps launched no dw
kernel of the network (the route's ``launches``; another cell's window has
none).
"""

import re

from perfbench.peaks import bound_s
from perfbench.reference.nnunet import conv_layers

KERNELS = re.compile(r"\bconv3d_mc_dw_(reduce_)?kernel\b")


def work(batch: int, layers):
    """[(bytes, flops)] of the stride-1 convs' weight gradients of a step."""
    return [((batch * edge ** 3 * (cin + cout) + 27 * cin * cout) * 4,
             2.0 * 27 * batch * edge ** 3 * cin * cout)
            for cin, cout, edge, stride in layers if stride == 1]


def read(ctx):
    steps = ctx.counters.get("steps", 0)
    if not steps or not ctx.counters.get("launches", {}).get("conv3d_mc_dw"):
        return None
    seconds = ctx.trace.kernel_seconds(KERNELS)
    if seconds <= 0:
        return None
    layers = conv_layers(ctx.config, ctx.config["voxel_grid_size"][0])
    bound = sum(bound_s(b, f, ctx.config["precision"])
                for b, f in work(ctx.traffic["batch_size"], layers))
    return bound * steps / seconds * 100.0
