"""Plain PyTorch references that decide ``correct``.

Written from the published description of each stage (the reference
implementation's voxelization, GENEO kernels, loss and models) in plain
``torch`` operations, f32 with TF32 off. Nothing here imports the program
(``scenenet_tpu_torch``), JAX or the JAX package, and nothing takes a
tensor that the program made, except to judge it.
"""

import contextlib

import torch


@contextlib.contextmanager
def full_f32():
    """Convolutions and matrix products in full f32 inside the block."""
    before = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before


def tf32(v: torch.Tensor) -> torch.Tensor:
    """``v`` rounded to TF32 (10 explicit mantissa bits, nearest, ties
    away): the operand a TF32 tensor core reads. The controls compute their
    convolutions on operands rounded so, which is what TF32 does to f32."""
    bits = v.contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF
    return rounded.view(torch.float32)


def tf32_st(v: torch.Tensor) -> torch.Tensor:
    """:func:`tf32` in the forward, the identity in the backward."""
    return v + (tf32(v.detach()) - v).detach()
