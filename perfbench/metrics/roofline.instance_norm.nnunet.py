"""The library's InstanceNorm + LeakyReLU (``ops/library_conv.py``
``instance_norm_lrelu``: ``F.instance_norm`` and ``F.leaky_relu``) share of
its roofline in an nnU-Net train step, forward and backward, over the
network's 22 normalised tensors (one after each 3³ conv).

Work of one tensor of E elements (B grids × C channels × S voxels, f32),
the least bytes of the pair fused: the forward reads x and writes y once
(8·E bytes), the backward reads x and the output's cotangent and writes the
input's once (12·E). Bound by bytes at 3.35 TB/s; the operations (a few an
element) are far below the peak.

The kernels matched (``KERNELS``) are the names the first traced run of the
cell showed for these two calls and their gradients (PyTorch 2.11, cuDNN's
batch norm under ``F.instance_norm``): ``cudnn::bn_fw_tr_1C11_kernel_NCHW``
and ``cudnn::bn_fw_tr_1C11_singleread`` forward, ``cudnn::bn_bw_1C11_kernel_new``
and ``cudnn::bn_bw_1C11_singleread`` backward, PyTorch's ``leaky_relu_kernel``
and ``leaky_relu_backward_kernel``. No other kernel of the cell has these
names (the network has no BatchNorm); the UNet's BatchNorm shares cuDNN's,
so nothing is read where the traced steps made no call of the wrapper (the
route's ``launches``; another cell's window has none).
"""

import re

from perfbench.peaks import bound_s
from perfbench.reference.nnunet import conv_layers

KERNELS = re.compile(r"\bcudnn::bn_(fw|bw)_|\bleaky_relu(_backward)?_kernel\b")


def work(batch: int, layers):
    """[(bytes, flops)] of the norm + nonlinearity after every 3³ conv."""
    return [(20.0 * batch * cout * edge ** 3, 0.0) for _, cout, edge, _ in layers]


def read(ctx):
    steps = ctx.counters.get("steps", 0)
    if not steps or not ctx.counters.get("launches", {}).get("instance_norm_lrelu"):
        return None
    seconds = ctx.trace.kernel_seconds(KERNELS)
    if seconds <= 0:
        return None
    layers = conv_layers(ctx.config, ctx.config["voxel_grid_size"][0])
    bound = sum(bound_s(b, f, ctx.config["precision"])
                for b, f in work(ctx.traffic["batch_size"], layers))
    return bound * steps / seconds * 100.0
