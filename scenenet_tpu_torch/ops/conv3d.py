"""SAME-padded 3D convolution in plain PyTorch.

Twin of :func:`scenenet_tpu.ops.conv3d.conv3d_same` (the XLA conv outside
any Pallas kernel). SAME padding follows torch's asymmetric rule for even
kernels: low = (k-1)//2, high = k//2.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


def same_pads(kernel_size) -> tuple:
    """``F.pad`` widths (last axis first) for a SAME conv with torch's
    asymmetric rule."""
    pads = []
    for k in reversed(tuple(kernel_size)):
        pads += [(k - 1) // 2, k // 2]
    return tuple(pads)


def conv3d_same(x: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    """SAME-padded 3D cross-correlation.

    x : (B, C_in, Z, X, Y); kernels : (C_out, C_in, k_z, k_x, k_y).
    Returns (B, C_out, Z, X, Y) in x's dtype. A bf16 x keeps bf16 in and
    out, as the JAX conv does for bf16 operands: the products and sums are
    taken in f32 from the bf16 values and the result rounded once.
    """
    kernels = kernels.to(x.dtype)
    if x.dtype == torch.bfloat16:
        return conv3d_same(x.float(), kernels.float()).to(torch.bfloat16)
    return F.conv3d(F.pad(x, same_pads(kernels.shape[2:])), kernels)


def geneo_conv(x: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    """Grouped single-input-channel GENEO convolution.

    x : (B, 1, Z, X, Y); kernels : (G, k_z, k_x, k_y) → (B, G, Z, X, Y).
    """
    return conv3d_same(x, kernels[:, None])


@contextlib.contextmanager
def _switched(module, name: str, value):
    """A process-wide backend switch set for the block and put back after."""
    before = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, before)


def tf32_off():
    """cuDNN convolutions in full f32 inside the block (the switch is on by
    default, and TF32 keeps ~3 decimal digits). cuDNN itself stays on."""
    return _switched(torch.backends.cudnn, "allow_tf32", False)


@contextlib.contextmanager
def cudnn_off():
    """Convolutions by PyTorch's own kernels (vol2col and a full-f32 matrix
    product) inside the block, not cuDNN's."""
    with _switched(torch.backends.cudnn, "enabled", False), \
            _switched(torch.backends.cuda.matmul, "allow_tf32", False):
        yield


def conv3d_f32(x: torch.Tensor, w: torch.Tensor, bias=None, padding=0) -> torch.Tensor:
    """``F.conv3d`` in full f32, whatever the process-wide TF32 switch says
    (cuDNN would otherwise round f32 convolutions to TF32 on the card)."""
    with tf32_off():
        return F.conv3d(x, w, bias, padding=padding)
