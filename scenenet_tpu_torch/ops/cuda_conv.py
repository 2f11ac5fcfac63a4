"""GENEO stencil conv: the CUDA kernel and its plain twin.

``geneo_stencil_conv`` is the port of the TPU kernel
``scenenet_tpu.ops.pallas_conv.geneo_stencil_conv``: an f32 SAME conv of a
(B, 1, Z, X, Y) grid with one (k_z, k_x, k_y) kernel, torch's asymmetric
pads, and an optional relu∘tanh head.

For a CUDA tensor it launches ``csrc/stencil_conv.cu``; for a CPU tensor
it runs :func:`geneo_stencil_conv_plain`. The two sum the taps in a
different order, so they agree to f32 rounding, not bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from scenenet_tpu_torch.ops import _build
from scenenet_tpu_torch.ops.conv3d import conv3d_same

LAUNCHES = _build.LaunchCounter("stencil_conv")

MAX_KZ = 16  # the kernel's k_z is a template parameter, instantiated 1..16


def geneo_stencil_conv_plain(x: torch.Tensor, kernel: torch.Tensor,
                             activation: bool = True) -> torch.Tensor:
    """Plain PyTorch version: ``conv3d_same`` then relu∘tanh."""
    out = conv3d_same(x, kernel[None, None])
    return torch.relu(torch.tanh(out)) if activation else out


def geneo_stencil_conv(x: torch.Tensor, kernel: torch.Tensor,
                       activation: bool = True,
                       z_prepadded: bool = False) -> torch.Tensor:
    """Fused SAME conv + (optional) relu∘tanh.

    x : (B, 1, Z, X, Y) float32; kernel : (k_z, k_x, k_y) float32.
    Returns (B, 1, Z, X, Y) float32. Not differentiable on the CUDA path.

    A CPU tensor takes :func:`geneo_stencil_conv_plain`; a CUDA tensor
    launches the kernel or raises.
    """
    if z_prepadded:
        raise NotImplementedError(
            "z_prepadded (VALID-z halo conv of the spatially sharded path) "
            "is not ported yet: ROADMAP B10")
    if x.ndim != 5 or x.shape[1] != 1:
        raise ValueError(f"x must be (B, 1, Z, X, Y), got {tuple(x.shape)}")
    if kernel.ndim != 3:
        raise ValueError(f"kernel must be (k_z, k_x, k_y), got {tuple(kernel.shape)}")
    if x.dtype != torch.float32 or kernel.dtype != torch.float32:
        raise TypeError(f"need float32 x and kernel, got {x.dtype}, {kernel.dtype}")
    if x.device != kernel.device:
        raise ValueError(f"x on {x.device}, kernel on {kernel.device}")
    if x.device.type == "cpu":
        return geneo_stencil_conv_plain(x, kernel, activation)
    if x.device.type != "cuda":
        raise ValueError(f"no stencil kernel for device {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or kernel.requires_grad):
        raise RuntimeError("the CUDA stencil forward has no backward yet "
                           "(ROADMAP B5): call it without autograd")
    b, _, z, xx, yy = x.shape
    k_z, k_x, k_y = kernel.shape
    if not 1 <= k_z <= MAX_KZ or b > 65535 or z > 8 * 65535 or b * z * xx * yy >= 2**31:
        raise ValueError(f"unsupported stencil shape x={tuple(x.shape)} "
                         f"kernel={tuple(kernel.shape)}")
    x = x.contiguous()
    kernel = kernel.contiguous()
    out = torch.empty_like(x)
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.snt_stencil_conv(
            x.data_ptr(), kernel.data_ptr(), out.data_ptr(),
            b, z, xx, yy, k_z, k_x, k_y, int(bool(activation)),
            ctypes.c_void_p(stream))
    _build.check(err, "stencil_conv")
    LAUNCHES.add()
    return out
