"""GENEO stencil conv and its kernel gradient: the CUDA kernels, their plain
twins, and the differentiable composition.

- ``geneo_stencil_conv`` is the port of the TPU kernel
  ``scenenet_tpu.ops.pallas_conv.geneo_stencil_conv``: an f32 SAME conv of
  a (B, 1, Z, X, Y) grid with one (k_z, k_x, k_y) kernel, torch's
  asymmetric pads, and an optional relu∘tanh head (``csrc/stencil_conv.cu``).
- ``stencil_dk`` is the port of ``pallas_conv.stencil_dk``: the gradient of
  that conv with respect to its kernel, ``dk[dz,dx,dy] = Σ x_pad[b, z+dz,
  x+dx, y+dy]·g[b, z, x, y]`` (``csrc/stencil_dk.cu``).
- ``fused_geneo_conv`` is ``pallas_conv.fused_geneo_conv``: relu∘tanh of
  the conv as a ``torch.autograd.Function`` whose forward is the stencil
  kernel and whose backward is ``stencil_dk`` for the kernel and the
  stencil with the flipped kernel for the input.

For a CUDA tensor each wrapper launches its kernel; for a CPU tensor it
runs its plain version. Kernel and plain version sum the same products in
a different order, so they agree to f32 rounding, not bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from scenenet_tpu_torch.ops import _build
from scenenet_tpu_torch.ops.conv3d import conv3d_same, same_pads

LAUNCHES = _build.LaunchCounter("stencil_conv")
DK_LAUNCHES = _build.LaunchCounter("stencil_dk")

MAX_KZ = 16  # the kernels' k_z is a template parameter, instantiated 1..16


def _check_volume(name: str, x: torch.Tensor) -> None:
    if x.ndim != 5 or x.shape[1] != 1:
        raise ValueError(f"{name} must be (B, 1, Z, X, Y), got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {x.dtype}")


def _check_launch(x: torch.Tensor, kernel_size) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"no stencil kernel for device {x.device}")
    b, _, z, xx, yy = x.shape
    if not 1 <= kernel_size[0] <= MAX_KZ or b > 65535 or z > 8 * 65535 \
            or b * z * xx * yy >= 2**31:
        raise ValueError(f"unsupported stencil shape x={tuple(x.shape)} "
                         f"kernel={tuple(kernel_size)}")


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
    Returns (B, 1, Z, X, Y) float32. Forward only on the CUDA path: the
    differentiable form is :func:`fused_geneo_conv`.

    A CPU tensor takes :func:`geneo_stencil_conv_plain`; a CUDA tensor
    launches the kernel or raises.
    """
    if z_prepadded:
        raise NotImplementedError(
            "z_prepadded (VALID-z halo conv of the spatially sharded path) "
            "is not ported yet: ROADMAP B10")
    _check_volume("x", x)
    if kernel.ndim != 3:
        raise ValueError(f"kernel must be (k_z, k_x, k_y), got {tuple(kernel.shape)}")
    if kernel.dtype != torch.float32:
        raise TypeError(f"kernel must be float32, got {kernel.dtype}")
    if x.device != kernel.device:
        raise ValueError(f"x on {x.device}, kernel on {kernel.device}")
    if x.device.type == "cpu":
        return geneo_stencil_conv_plain(x, kernel, activation)
    _check_launch(x, kernel.shape)
    if torch.is_grad_enabled() and (x.requires_grad or kernel.requires_grad):
        raise RuntimeError("the raw CUDA stencil is forward only: use "
                           "fused_geneo_conv for a differentiable conv")
    b, _, z, xx, yy = x.shape
    k_z, k_x, k_y = kernel.shape
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


def stencil_dk_plain(x: torch.Tensor, g: torch.Tensor,
                     kernel_size: Tuple[int, int, int]) -> torch.Tensor:
    """Plain PyTorch version of :func:`stencil_dk`: one f32 product-sum per
    tap over the SAME-padded x. (A conv with the batch as input channel
    would be a conv whose weight is the whole volume.)"""
    k_z, k_x, k_y = kernel_size
    _, _, z, xx, yy = g.shape
    xp = F.pad(x, same_pads(kernel_size))[:, 0]
    g0 = g[:, 0]
    dk = torch.empty(kernel_size, dtype=torch.float32, device=x.device)
    for dz in range(k_z):
        for dx in range(k_x):
            for dy in range(k_y):
                dk[dz, dx, dy] = (xp[:, dz:dz + z, dx:dx + xx, dy:dy + yy] * g0).sum()
    return dk


def stencil_dk(x: torch.Tensor, g: torch.Tensor, kernel_size: Tuple[int, int, int],
               z_prepadded: bool = False) -> torch.Tensor:
    """Kernel gradient of the SAME stencil conv: x, g (B, 1, Z, X, Y) f32 →
    dk (k_z, k_x, k_y) f32, ``Σ_{b,z,x,y} x_pad[b, z+dz, x+dx, y+dy]·g[b,z,x,y]``.

    A CPU tensor takes :func:`stencil_dk_plain`; a CUDA tensor launches the
    kernel or raises. The kernel reduces in a fixed order: the same input
    gives the same bits on every run.
    """
    if z_prepadded:
        raise NotImplementedError(
            "z_prepadded (VALID-z kernel gradient of the spatially sharded "
            "path) is not ported yet: ROADMAP B10")
    _check_volume("x", x)
    _check_volume("g", g)
    kernel_size = tuple(int(k) for k in kernel_size)
    if x.shape != g.shape or x.device != g.device:
        raise ValueError(f"x {tuple(x.shape)} on {x.device} and g {tuple(g.shape)} "
                         f"on {g.device} must match")
    if len(kernel_size) != 3 or min(kernel_size) < 1:
        raise ValueError(f"kernel_size must be three positive ints, got {kernel_size}")
    if x.device.type == "cpu":
        return stencil_dk_plain(x, g, kernel_size)
    _check_launch(x, kernel_size)
    b, _, z, xx, yy = x.shape
    k_z, k_x, k_y = kernel_size
    x = x.contiguous()
    g = g.contiguous()
    lib = _build.load()
    n_blocks = lib.snt_stencil_dk_blocks(b, z, xx, yy)
    dk = torch.empty(kernel_size, dtype=torch.float32, device=x.device)
    partial = torch.empty((n_blocks, k_z * k_x * k_y), dtype=torch.float32,
                          device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.snt_stencil_dk(
            x.data_ptr(), g.data_ptr(), dk.data_ptr(), partial.data_ptr(),
            b, z, xx, yy, k_z, k_x, k_y, ctypes.c_void_p(stream))
    _build.check(err, "stencil_dk")
    DK_LAUNCHES.add()
    return dk


def _conv_transpose_same(g: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """dx of the SAME conv, plain PyTorch: correlation of g with the
    flipped kernel under the mirrored pads (low k//2, high (k-1)//2)."""
    pads = same_pads(kernel.shape)
    mirrored = tuple(p for lo, hi in zip(pads[::2], pads[1::2]) for p in (hi, lo))
    return F.conv3d(F.pad(g, mirrored), kernel.flip((0, 1, 2))[None, None])


class _FusedGeneoConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel):
        out = geneo_stencil_conv(x, kernel, activation=True)
        ctx.save_for_backward(x, kernel, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, kernel, out = ctx.saved_tensors
        # d relu(tanh(c))/dc = 1 − tanh(c)² where tanh(c) > 0; out = relu(tanh(c))
        act = g * torch.where(out > 0, 1.0 - out * out, torch.zeros_like(out))
        dx = dk = None
        if ctx.needs_input_grad[0]:
            if all(k % 2 for k in kernel.shape):
                # odd on every axis: the mirrored pads equal the forward's,
                # so dx is the stencil with the flipped kernel
                dx = geneo_stencil_conv(act, kernel.flip((0, 1, 2)).contiguous(),
                                        activation=False)
            else:
                dx = _conv_transpose_same(act, kernel)
        if ctx.needs_input_grad[1]:
            dk = stencil_dk(x, act, tuple(kernel.shape))
        return dx, dk


def fused_geneo_conv(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """relu(tanh(conv_same(x, kernel))), differentiable in both arguments.

    Forward: :func:`geneo_stencil_conv`. Backward: dk by :func:`stencil_dk`;
    dx, only when x requires grad, by the stencil with the flipped kernel
    (kernels odd on every axis) or the plain conv-transpose with mirrored
    pads (the JAX package takes an XLA conv there too).
    """
    return _FusedGeneoConv.apply(x, kernel)


def fused_geneo_conv_mxu(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """The banded-y tensor-core training forward: not ported yet."""
    raise NotImplementedError(
        "fused_geneo_conv_mxu (the banded-y tensor-core stencil forward) is "
        "not ported yet: ROADMAP B2")
