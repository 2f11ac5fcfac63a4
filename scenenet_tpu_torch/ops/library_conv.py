"""The operations of nnU-Net's ``PlainConvUNet`` that no hand-written kernel
of the port computes, as library calls in full f32 (TF32 off, forward and
backward), each behind a wrapper that counts its calls on the card.

- :func:`conv3d_strided`: the encoder's downsampling conv, 3³, stride 2,
  zero pad 1, with a bias. The forward and dx are cuDNN's in full f32; dw
  is PyTorch's own (vol2col and f32 GEMMs, cuDNN off): at the five strided
  layers of the 128³ network at batch 2 cuDNN's f32 3D weight gradient took
  about 1.7× as long, and PyTorch's own dx about 1.7× cuDNN's (the smoke's
  ``[timing] nnU-Net's library convs`` line; ``PERF.md`` §6).
- :func:`conv_transpose3d_k2`: the decoder's upsampling, a transposed conv
  of kernel 2 and stride 2 with a bias, cuDNN's forward and backward. Its 8
  taps never overlap, so it is one matrix product, (C_in, 8·C_out)ᵀ ×
  (C_in, N) a sample, and a reshuffle of the taps; as cuBLAS products and
  copies that form took 2.3× cuDNN's time at the network's five layers at
  batch 2, and PyTorch's own kernels 1.3× (``PERF.md`` §6).
- :func:`instance_norm_lrelu`: InstanceNorm (affine, ε 1e-5, each sample's
  own statistics, no running ones), then LeakyReLU(0.01). Not in place:
  the norm's output is a view, and autograd would undo an in-place op on it
  with extra copies in the backward.

The two convs are ``torch.autograd.Function``s, so that their backward
keeps TF32 off whatever the process's switches say when autograd runs it.
Every device runs the same calls; on the CPU they are plain PyTorch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from scenenet_tpu_torch.ops import _build
from scenenet_tpu_torch.ops.conv3d import cudnn_off, tf32_off

STRIDED_LAUNCHES = _build.LaunchCounter("conv3d_strided")
TRANSPOSED_LAUNCHES = _build.LaunchCounter("conv_transpose3d_k2")
NORM_LAUNCHES = _build.LaunchCounter("instance_norm_lrelu")

NORM_EPS = 1e-5
NEGATIVE_SLOPE = 0.01


class _StridedConv3d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        with tf32_off():
            return F.conv3d(x, w, b, stride=2, padding=1)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            with tf32_off():
                dx = torch.nn.grad.conv3d_input(x.shape, w, g, stride=2, padding=1)
        if ctx.needs_input_grad[1]:
            with cudnn_off():
                dw = torch.nn.grad.conv3d_weight(x, w.shape, g, stride=2, padding=1)
        if ctx.needs_input_grad[2]:
            db = g.sum((0, 2, 3, 4))
        return dx, dw, db


def conv3d_strided(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x (B, C_in, Z, X, Y) × w (C_out, C_in, 3, 3, 3) + b (C_out,) → (B,
    C_out, ⌈Z/2⌉, ⌈X/2⌉, ⌈Y/2⌉): ``F.conv3d(x, w, b, stride=2, padding=1)``
    in full f32, differentiable in all three."""
    if w.ndim != 5 or tuple(w.shape[2:]) != (3, 3, 3) or x.ndim != 5 \
            or x.shape[1] != w.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)}: want (B, C_in, Z, X, Y) "
                         "and (C_out, C_in, 3, 3, 3)")
    if x.device.type == "cuda":
        STRIDED_LAUNCHES.add()
    return _StridedConv3d.apply(x, w, b)


class _ConvTranspose3dK2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        with tf32_off():
            return F.conv_transpose3d(x, w, b, stride=2)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        with tf32_off():
            dx, dw, db = torch.ops.aten.convolution_backward(
                g, x, w, [w.shape[1]], [2, 2, 2], [0, 0, 0], [1, 1, 1], True, [0, 0, 0], 1,
                list(ctx.needs_input_grad))
        return dx, dw, db


def conv_transpose3d_k2(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x (B, C_in, Z, X, Y) × w (C_in, C_out, 2, 2, 2) + b (C_out,) → (B,
    C_out, 2Z, 2X, 2Y): ``F.conv_transpose3d(x, w, b, stride=2)`` in full
    f32, differentiable in all three."""
    if w.ndim != 5 or tuple(w.shape[2:]) != (2, 2, 2) or x.ndim != 5 \
            or x.shape[1] != w.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)}: want (B, C_in, Z, X, Y) "
                         "and (C_in, C_out, 2, 2, 2)")
    if x.device.type == "cuda":
        TRANSPOSED_LAUNCHES.add()
    return _ConvTranspose3dK2.apply(x, w, b)


def instance_norm_lrelu(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor
                        ) -> torch.Tensor:
    """``leaky_relu(instance_norm(x) · weight + bias, 0.01)`` over each
    sample's and channel's own voxels (biased variance, ε 1e-5)."""
    if x.device.type == "cuda":
        NORM_LAUNCHES.add()
    y = F.instance_norm(x, weight=weight, bias=bias, eps=NORM_EPS)
    return F.leaky_relu(y, NEGATIVE_SLOPE)
