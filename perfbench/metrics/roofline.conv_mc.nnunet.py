"""The multi-channel conv kernel's share of its roofline in an nnU-Net
train step: K10 (``ops/cuda_conv_mc.py`` ``conv3d_mc_same``) at the
network's 17 stride-1 3³ convs, its forward at each and its input gradient
at each but the first, with the weight split and the K-split reduction it
launches, against the least time each needs. The strided convs are not
K10's (``ops/library_conv.py``).

Work of one conv of C_in → C_out channels over B grids of S voxels: the
input, the 27·C_in·C_out weights and the output each moved once (f32),
2·27·B·S·C_in·C_out FLOPs; its input gradient moves the output's
cotangent, the weights and the input's, and takes as many FLOPs. Nothing
is read where the traced steps launched no K10 call of the network (the
route's ``launches``; another cell's window has none).
"""

import re

from perfbench.peaks import bound_s
from perfbench.reference.nnunet import conv_layers

KERNELS = re.compile(r"\bconv3d_mc_(tc_)?kernel\b|\bconv3d_mc_(split|reduce)_kernel\b")


def work(batch: int, layers):
    """[(bytes, flops)] of the forward and input-gradient K10 calls of a
    step; ``layers`` as ``conv_layers`` gives them, every conv of stride 1."""
    out = []
    for i, (cin, cout, edge, stride) in enumerate(layers):
        if stride != 1:
            continue
        voxels = edge ** 3
        moved = (batch * voxels * (cin + cout) + 27 * cin * cout) * 4
        flops = 2.0 * 27 * batch * voxels * cin * cout
        out.append((moved, flops))
        if i:  # the first conv's input is the data: no gradient taken
            out.append((moved, flops))
    return out


def read(ctx):
    steps = ctx.counters.get("steps", 0)
    if not steps or not ctx.counters.get("launches", {}).get("conv3d_mc"):
        return None
    seconds = ctx.trace.kernel_seconds(KERNELS)
    if seconds <= 0:
        return None
    layers = conv_layers(ctx.config, ctx.config["voxel_grid_size"][0])
    bound = sum(bound_s(b, f, ctx.config["precision"])
                for b, f in work(ctx.traffic["batch_size"], layers))
    return bound * steps / seconds * 100.0
