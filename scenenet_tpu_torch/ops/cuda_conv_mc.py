"""Multi-channel 3×3×3 SAME conv3d: the CUDA kernel, its plain twin and the
differentiable composition.

- ``conv3d_mc_same`` is the port of the TPU kernel
  ``scenenet_tpu.ops.pallas_conv_mc.conv3d_mc_same``: x (B, C_in, Z, X, Y) ×
  w (C_out, C_in, 3, 3, 3) → (B, C_out, Z, X, Y), stride 1, zero pad 1 a
  side, no bias, f32 in and out with f32 accumulation; with
  ``channels_last=True`` x and the result are (B, Z, X, Y, C)
  (``csrc/conv3d_mc.cu``: one kernel for every volume size and both
  layouts).
- ``conv3d_mc_same_plain`` is the plain PyTorch version: ``F.conv3d`` with
  padding 1 and TF32 off.
- ``fused_conv3d_mc`` is that conv as a ``torch.autograd.Function``, the
  conv of ``UNet3D`` and ``CnnBaseline`` on the kernel backend. Forward:
  the kernel. dx, only when x needs it: the same kernel on the cotangent
  with the weights flipped on their three spatial axes and their two
  channel axes swapped (exact for a 3³ kernel with pad 1). dw: the JAX
  package has no kernel for it (its ``conv3d_mc_same`` carries no custom
  gradient, and the weight gradient of its models is XLA's conv), so it is
  a library call here too, ``torch.nn.grad.conv3d_weight`` in full f32 with
  cuDNN switched off for the call (its f32 weight gradient of a 3D conv is
  the slower library path at the UNet's large layers); it is not one of
  the port's kernels.

For a CUDA tensor each wrapper launches its kernel; for a CPU tensor it
runs its plain version. Kernel and plain version sum the same products in
a different order, so they agree to f32 rounding, not bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from scenenet_tpu_torch.ops import _build
from scenenet_tpu_torch.ops.conv3d import conv3d_f32, cudnn_off

MC_LAUNCHES = _build.LaunchCounter("conv3d_mc")


def _check_args(x: torch.Tensor, w: torch.Tensor, channels_last: bool) -> None:
    if w.ndim != 5 or tuple(w.shape[2:]) != (3, 3, 3):
        raise ValueError(f"w must be (C_out, C_in, 3, 3, 3), got {tuple(w.shape)}")
    if x.ndim != 5:
        raise ValueError("x must be (B, C_in, Z, X, Y), or (B, Z, X, Y, C_in) with "
                         f"channels_last, got {tuple(x.shape)}")
    c_in = x.shape[-1] if channels_last else x.shape[1]
    if c_in != w.shape[1] or min(x.shape) < 1 or w.shape[0] < 1:
        raise ValueError(f"x {tuple(x.shape)} (channels_last={channels_last}) does not "
                         f"match w {tuple(w.shape)}")
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f"x and w must be float32, got {x.dtype} and {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"x on {x.device}, w on {w.device}")


def conv3d_mc_same_plain(x: torch.Tensor, w: torch.Tensor,
                         channels_last: bool = False) -> torch.Tensor:
    """Plain PyTorch version: one ``F.conv3d`` with padding 1, in full f32
    (TF32 off)."""
    if channels_last:
        x = x.permute(0, 4, 1, 2, 3)
    out = conv3d_f32(x, w, padding=1)
    return out.permute(0, 2, 3, 4, 1).contiguous() if channels_last else out


def _transposed(w: torch.Tensor) -> torch.Tensor:
    """(C_out, C_in, 3, 3, 3) → (C_in, 27, C_out) contiguous, the layout the
    kernel stages from (rows of C_out weights per input channel and tap)."""
    c_out, c_in = w.shape[:2]
    return w.reshape(c_out, c_in, 27).permute(1, 2, 0).contiguous()


def _launch(x: torch.Tensor, wt: torch.Tensor, channels_last: bool) -> torch.Tensor:
    """The kernel on contiguous x and transposed weights ``wt`` (C_in, 27, C_out)."""
    c_in, _, c_out = wt.shape
    x = x.contiguous()
    if channels_last:
        b, z, xx, yy, _ = x.shape
        out = torch.empty((b, z, xx, yy, c_out), dtype=torch.float32, device=x.device)
    else:
        b, _, z, xx, yy = x.shape
        out = torch.empty((b, c_out, z, xx, yy), dtype=torch.float32, device=x.device)
    vox = z * xx * yy

    def strides(c):  # element strides of (sample, channel, voxel)
        return (vox * c, 1, c) if channels_last else (vox * c, vox, 1)

    vec_out = int(not channels_last and yy % 4 == 0 and out.data_ptr() % 16 == 0)
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.snt_conv3d_mc(x.data_ptr(), wt.data_ptr(), out.data_ptr(),
                                b, c_in, c_out, z, xx, yy, *strides(c_in), *strides(c_out),
                                vec_out, ctypes.c_void_p(stream))
    _build.check(err, "conv3d_mc")
    MC_LAUNCHES.add()
    return out


def conv3d_mc_same(x: torch.Tensor, w: torch.Tensor,
                   channels_last: bool = False) -> torch.Tensor:
    """SAME 3³ conv3d.

    x (B, C_in, Z, X, Y) × w (C_out, C_in, 3, 3, 3) → (B, C_out, Z, X, Y),
    f32. With ``channels_last=True`` x is (B, Z, X, Y, C_in) and the output
    matches. Any other kernel size raises a ``ValueError``. Forward only on
    the CUDA path: the differentiable form is :func:`fused_conv3d_mc`.

    A CPU tensor takes :func:`conv3d_mc_same_plain`; a CUDA tensor launches
    the kernel or raises.
    """
    _check_args(x, w, channels_last)
    if x.device.type == "cpu":
        return conv3d_mc_same_plain(x, w, channels_last)
    if x.device.type != "cuda":
        raise ValueError(f"no conv3d_mc kernel for device {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise RuntimeError("the raw CUDA conv is forward only: use fused_conv3d_mc "
                           "for a differentiable conv")
    return _launch(x, _transposed(w), channels_last)


def conv3d_mc_weight_grad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dw of the SAME 3³ conv, (C_out, C_in, 3, 3, 3): the library's weight
    gradient in full f32, by PyTorch's own kernels. cuDNN's f32 weight
    gradient of a 3D conv is several times slower at the UNet's 64³ layers
    (``PERF.md`` has both times)."""
    with cudnn_off():
        return torch.nn.grad.conv3d_weight(x, (g.shape[1], x.shape[1], 3, 3, 3), g, padding=1)


class _FusedConv3dMc(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return conv3d_mc_same(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = dw = None
        g = g.contiguous()
        if ctx.needs_input_grad[0]:
            # the conv of g with the taps flipped and the channel axes swapped
            dx = conv3d_mc_same(g, w.flip((2, 3, 4)).transpose(0, 1))
        if ctx.needs_input_grad[1]:
            dw = conv3d_mc_weight_grad(x, g)
        return dx, dw


def fused_conv3d_mc(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """:func:`conv3d_mc_same` (channels first), differentiable in both
    arguments: the kernel forward, the kernel again for dx (launched only
    when x requires grad), the library's weight gradient for dw."""
    return _FusedConv3dMc.apply(x, w)
