"""SAME-padded 3D convolution in plain PyTorch.

Twin of :func:`scenenet_tpu.ops.conv3d.conv3d_same` (the XLA conv outside
any Pallas kernel). SAME padding follows torch's asymmetric rule for even
kernels: low = (k-1)//2, high = k//2.
"""

from __future__ import annotations

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
    Returns (B, C_out, Z, X, Y).
    """
    return F.conv3d(F.pad(x, same_pads(kernels.shape[2:])), kernels.to(x.dtype))
