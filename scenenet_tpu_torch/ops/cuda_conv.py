"""GENEO stencil conv and its kernel gradient: the CUDA kernels, their plain
twins, and the differentiable compositions.

- ``geneo_stencil_conv`` is the port of the TPU kernel
  ``scenenet_tpu.ops.pallas_conv.geneo_stencil_conv``: an f32 SAME conv of
  a (B, 1, Z, X, Y) grid with one (k_z, k_x, k_y) kernel, torch's
  asymmetric pads, and an optional relu∘tanh head (``csrc/stencil_conv.cu``:
  an unrolled, register-blocked kernel for (9,5,5) and a generic one for
  every other kernel size, picked by ``stencil_route``).
- ``geneo_stencil_conv_mxu`` is the port of ``pallas_conv.geneo_stencil_conv_mxu``:
  the same conv on the tensor cores, x rounded to bf16, the kernel split
  into bf16 ``hi`` + 2⁻⁹·bf16 ``lo``, f32 accumulation, and an optional
  fused ``>= τ`` mask (``csrc/stencil_mma.cu``: one mma packs two halo
  planes and two output planes; ``stencil_mma_plan`` picks its z tile).
- ``stencil_dk`` is the port of ``pallas_conv.stencil_dk``: the gradient of
  that conv with respect to its kernel, ``dk[dz,dx,dy] = Σ x_pad[b, z+dz,
  x+dx, y+dy]·g[b, z, x, y]`` (``csrc/stencil_dk.cu``: an unrolled,
  register-blocked kernel for (9,5,5) and a generic one for every other
  kernel size, picked by the same ``stencil_route``).
- ``z_prepadded=True`` gives both the VALID-z form of the spatially sharded
  path: the input's z slab already carries its neighbours' k_z − 1 halo
  planes, so z is not padded again and Z − (k_z − 1) output planes come
  out. The kernels take the input's z extent and low z pad as arguments;
  the SAME route passes (Z, (k_z − 1)//2), the halo route (Z, 0).
- ``halo_stencil_conv`` is the port of ``pallas_conv.halo_stencil_conv``:
  that VALID-z conv as a ``torch.autograd.Function`` with the JAX package's
  backward (dx by the halo form of the f32 stencil on the flipped kernel
  over g padded in z, dk by the halo form of ``stencil_dk``).
- ``fused_geneo_conv`` and ``fused_geneo_conv_mxu`` are their namesakes in
  ``pallas_conv``: relu∘tanh of the conv as a ``torch.autograd.Function``
  whose forward is the f32 or the tensor-core stencil and whose backward,
  shared by both, is ``stencil_dk`` for the kernel and the f32 stencil
  with the flipped kernel for the input.

For a CUDA tensor each wrapper launches its kernel; for a CPU tensor it
runs its plain version. Kernel and plain version sum the same products in
a different order, so they agree to f32 rounding, not bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from scenenet_tpu_torch.ops import _build
from scenenet_tpu_torch.ops.conv3d import conv3d_f32, conv3d_same, same_pads

LAUNCHES = _build.LaunchCounter("stencil_conv")
DK_LAUNCHES = _build.LaunchCounter("stencil_dk")
MXU_LAUNCHES = _build.LaunchCounter("stencil_mma")

MAX_KZ = 16  # the kernels' k_z is a template parameter, instantiated 1..16
MAX_BLOCK_SHARED = 232448  # bytes of shared memory one block can use on sm_90
LO_SCALE = 512.0  # 2⁹: shifts the kernel's bf16 residual into bf16's mantissa window
# the kernel sizes the f32 stencil's and the kernel gradient's unrolled,
# register-blocked kernels are built for
FAST_KERNEL_SIZES = ((9, 5, 5),)
_ROUTE_FLAG = {"generic": 0, "fast": 1}  # the C entries' `fast` argument
# the kernel gradient's unrolled kernel: a block's g tile (z, x, y), and the
# blocks an SM its registers allow; the card's SMs
DK_FAST_TILE = (4, 16, 32)
DK_FAST_BLOCKS_PER_SM = 4
DK_MAX_Z_TILES = 4  # the most g tiles a block of it walks along z
SMS = 132
# the tensor-core stencil: a tile's output x and y, its two z extents (16, or
# 8 where the tall tile would leave an SM's block fewer than MMA_GROUPS
# tiles), and the groups of warps of its one block an SM, which take turns
MMA_TILE_X, MMA_TILE_Y = 16, 32
MMA_TALL_Z, MMA_SHORT_Z = 16, 8
MMA_GROUPS = 2


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


def _check_conv_args(x: torch.Tensor, kernel: torch.Tensor) -> None:
    _check_volume("x", x)
    if kernel.ndim != 3:
        raise ValueError(f"kernel must be (k_z, k_x, k_y), got {tuple(kernel.shape)}")
    if kernel.dtype != torch.float32:
        raise TypeError(f"kernel must be float32, got {kernel.dtype}")
    if x.device != kernel.device:
        raise ValueError(f"x on {x.device}, kernel on {kernel.device}")


def stencil_route(kernel_size) -> str:
    """Which of two kernels a launch of the f32 stencil or of its kernel
    gradient takes, from the kernel size alone: ``"fast"`` (tap loops
    unrolled at compile time, a sliding window in registers) for a size of
    ``FAST_KERNEL_SIZES``, at every batch and volume (on the card it is the
    faster one from batch 1 up), else ``"generic"`` (runtime k_x and k_y)."""
    return "fast" if tuple(int(k) for k in kernel_size) in FAST_KERNEL_SIZES else "generic"


def stencil_dk_plan(b: int, z: int, x: int, y: int) -> int:
    """How many g tiles along z each block of the unrolled kernel gradient
    walks (1, 2 or 4): the most that still leaves every SM its
    ``DK_FAST_BLOCKS_PER_SM`` blocks. A block adds its sums over its tiles
    and writes one partial a tap, so more tiles a block means fewer
    partials and a cheaper fixed-order reduce; fewer blocks than the card
    holds would leave SMs idle."""
    tz, tx, ty = DK_FAST_TILE
    tiles_z = -(-z // tz)
    blocks = b * tiles_z * -(-x // tx) * -(-y // ty)
    zg = 1
    while 2 * zg <= min(DK_MAX_Z_TILES, tiles_z) \
            and blocks // (2 * zg) >= SMS * DK_FAST_BLOCKS_PER_SM:
        zg *= 2
    return zg


def stencil_mma_smem(kernel_size, tz: int) -> int:
    """Bytes of shared memory a block of the tensor-core stencil needs at
    z tile ``tz``: the B fragments of every (dx, 8-input chunk, pair step),
    hi and lo, 16 bytes a lane, and for each of its ``MMA_GROUPS`` groups
    the larger of its bf16 halo tile (planes ``tz + 2·steps − 2``, rows
    ``16 + k_x − 1``, a row pitch of 8 mod 16 elements) and its staged f32
    output tile (``tz`` x 16 x 36). ``csrc/stencil_mma.cu`` computes the
    same (``snt_stencil_mma_smem``)."""
    k_z, k_x, k_y = (int(k) for k in kernel_size)
    steps = (k_z + 2) // 2  # ceil((k_z + 1) / 2): an output pair's halo planes, in pairs
    chunks = (k_y + 10) // 8  # ceil((4 + k_y - 1) / 8): a y quad's inputs, in eights
    pitch = -(-(MMA_TILE_Y - 4 + 8 * chunks) // 8) * 8
    pitch += 8 if pitch % 16 == 0 else 0
    frags = k_x * chunks * steps * 32 * 16
    tile = (tz + 2 * steps - 2) * (MMA_TILE_X + k_x - 1) * pitch * 2
    staged = tz * MMA_TILE_X * (MMA_TILE_Y + 4) * 4
    return frags + MMA_GROUPS * max(tile, staged)


def stencil_mma_plan(b: int, z: int, x: int, y: int, kernel_size) -> int:
    """The tensor-core stencil's z tile: ``MMA_TALL_Z`` (16 output planes a
    tile, fewer halo planes staged an output) where that still gives the
    one block on every SM ``MMA_GROUPS`` tiles (one for each group) and its
    shared memory fits, else ``MMA_SHORT_Z`` (twice the tiles: batch 1 and
    the micro-batcher's small batches)."""
    tiles = b * -(-z // MMA_TALL_Z) * -(-x // MMA_TILE_X) * -(-y // MMA_TILE_Y)
    if tiles >= SMS * MMA_GROUPS \
            and stencil_mma_smem(kernel_size, MMA_TALL_Z) <= MAX_BLOCK_SHARED:
        return MMA_TALL_Z
    return MMA_SHORT_Z


def _z_form(z_in: int, k_z: int, z_prepadded: bool) -> Tuple[int, int]:
    """(output planes, low z pad) of the conv over ``z_in`` input planes:
    SAME keeps the extent and pads (k_z − 1)//2 below; the halo form reads
    the slab's own halo planes, pads nothing and loses k_z − 1 planes."""
    if not z_prepadded:
        return z_in, (k_z - 1) // 2
    z_out = z_in - (k_z - 1)
    if z_out < 1:
        raise ValueError(f"Z={z_in} too small for kernel z={k_z} (prepadded)")
    return z_out, 0


def _xy_pads(kernel_size) -> tuple:
    """``F.pad`` widths of the SAME pads in x and y alone (z VALID)."""
    return same_pads(kernel_size)[:4] + (0, 0)


def geneo_stencil_conv_plain(x: torch.Tensor, kernel: torch.Tensor,
                             activation: bool = True,
                             z_prepadded: bool = False) -> torch.Tensor:
    """Plain PyTorch version: ``conv3d_same`` (or, ``z_prepadded``, the
    conv VALID in z and SAME in x and y) then relu∘tanh."""
    if z_prepadded:
        _z_form(x.shape[2], kernel.shape[0], True)
        out = F.conv3d(F.pad(x, _xy_pads(kernel.shape)), kernel[None, None].to(x.dtype))
    else:
        out = conv3d_same(x, kernel[None, None])
    return torch.relu(torch.tanh(out)) if activation else out


def _launch_stencil(x: torch.Tensor, kernel: torch.Tensor, activation: bool,
                    route: str, z_prepadded: bool = False) -> torch.Tensor:
    """One launch of the f32 stencil on checked CUDA tensors, through the
    kernel ``route`` names (``stencil_route`` picks it; the card tests force
    either); SAME in z, or VALID (``z_prepadded``)."""
    b, _, z, xx, yy = x.shape
    k_z, k_x, k_y = kernel.shape
    z_out, z_lo = _z_form(z, k_z, z_prepadded)
    x = x.contiguous()
    kernel = kernel.contiguous()
    out = torch.empty((b, 1, z_out, xx, yy), dtype=torch.float32, device=x.device)
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.snt_stencil_conv(
            x.data_ptr(), kernel.data_ptr(), out.data_ptr(),
            b, z_out, xx, yy, k_z, k_x, k_y, int(bool(activation)), _ROUTE_FLAG[route],
            z, z_lo, ctypes.c_void_p(stream))
    _build.check(err, "stencil_conv")
    LAUNCHES.add()
    return out


def geneo_stencil_conv(x: torch.Tensor, kernel: torch.Tensor,
                       activation: bool = True,
                       z_prepadded: bool = False) -> torch.Tensor:
    """Fused SAME conv + (optional) relu∘tanh.

    x : (B, 1, Z, X, Y) float32; kernel : (k_z, k_x, k_y) float32.
    Returns (B, 1, Z, X, Y) float32. Forward only on the CUDA path: the
    differentiable forms are :func:`fused_geneo_conv` and
    :func:`halo_stencil_conv`.

    ``z_prepadded=True`` treats the input's z extent as already carrying
    the k_z − 1 halo planes (the spatially sharded path): VALID in z, SAME
    in x and y, and Z − (k_z − 1) output planes.

    A CPU tensor takes :func:`geneo_stencil_conv_plain`; a CUDA tensor
    launches the kernel or raises.
    """
    _check_conv_args(x, kernel)
    _z_form(x.shape[2], kernel.shape[0], z_prepadded)
    if x.device.type == "cpu":
        return geneo_stencil_conv_plain(x, kernel, activation, z_prepadded)
    _check_launch(x, kernel.shape)
    if torch.is_grad_enabled() and (x.requires_grad or kernel.requires_grad):
        raise RuntimeError("the raw CUDA stencil is forward only: use "
                           "fused_geneo_conv or halo_stencil_conv for a differentiable conv")
    return _launch_stencil(x, kernel, activation, stencil_route(kernel.shape), z_prepadded)


def split_kernel_bf16(kernel: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(k_z, k_x, k_y) f32 kernel → bf16 ``(hi, lo)`` with
    ``hi = bf16(k)`` and ``lo = bf16((k − f32(hi))·2⁹)``, both rounded to
    nearest even, so that ``hi + lo/2⁹`` carries about 16 mantissa bits of
    ``k``. The values the JAX package's ``banded_y_weights`` places on its
    bands."""
    hi = kernel.to(torch.bfloat16)
    lo = ((kernel - hi.float()) * LO_SCALE).to(torch.bfloat16)
    return hi, lo


def geneo_stencil_conv_mxu_plain(x: torch.Tensor, kernel: torch.Tensor,
                                 activation: bool = True, split: bool = True,
                                 tau: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`geneo_stencil_conv_mxu`, the same
    arithmetic: x rounded to bf16, one f32 conv with ``hi`` and, for
    ``split``, one with ``lo`` scaled back by 2⁻⁹, then the head and the
    τ mask. Every bf16×bf16 product is exact in f32, so this and the
    kernel differ only in the order of their f32 sums."""
    xb = x.to(torch.bfloat16).float()
    hi, lo = split_kernel_bf16(kernel)
    out = conv3d_same(xb, hi.float()[None, None])
    if split:
        out = out + conv3d_same(xb, lo.float()[None, None]) * (1.0 / LO_SCALE)
    if activation:
        out = torch.relu(torch.tanh(out))
    if tau is not None:
        out = (out >= torch.tensor(tau, dtype=torch.float32, device=out.device)).float()
    return out


def geneo_stencil_conv_mxu(x: torch.Tensor, kernel: torch.Tensor,
                           activation: bool = True, split: bool = True,
                           tau: Optional[float] = None) -> torch.Tensor:
    """The SAME conv of :func:`geneo_stencil_conv` on the tensor cores.

    x : (B, 1, Z, X, Y) float32, rounded to bf16 (exact for {0, 1}
    occupancy); kernel : (k_z, k_x, k_y) float32, used as
    :func:`split_kernel_bf16`'s ``hi + lo/2⁹`` (``split=True``, near f32)
    or ``hi`` alone (``split=False``); products accumulate in f32.
    ``activation`` applies relu∘tanh; ``tau`` returns the f32 {0, 1} mask
    ``(result >= f32(τ))`` instead, computed in the kernel's epilogue.
    Returns (B, 1, Z, X, Y) float32. Forward only on the CUDA path: the
    differentiable form is :func:`fused_geneo_conv_mxu`.

    A CPU tensor takes :func:`geneo_stencil_conv_mxu_plain`; a CUDA tensor
    launches the kernel or raises.
    """
    _check_conv_args(x, kernel)
    if x.device.type == "cpu":
        return geneo_stencil_conv_mxu_plain(x, kernel, activation, split, tau)
    _check_launch(x, kernel.shape)
    if torch.is_grad_enabled() and (x.requires_grad or kernel.requires_grad):
        raise RuntimeError("the raw tensor-core stencil is forward only: use "
                           "fused_geneo_conv_mxu for a differentiable conv")
    b, _, z, xx, yy = x.shape
    return _launch_mma(x, kernel, activation, split, tau,
                       stencil_mma_plan(b, z, xx, yy, kernel.shape))


def _launch_mma(x: torch.Tensor, kernel: torch.Tensor, activation: bool, split: bool,
                tau: Optional[float], tz: int) -> torch.Tensor:
    """One launch of the tensor-core stencil on checked CUDA tensors at z
    tile ``tz`` (``stencil_mma_plan`` picks it; the card tests force
    either)."""
    b, _, z, xx, yy = x.shape
    k_z, k_x, k_y = kernel.shape
    shared = stencil_mma_smem(kernel.shape, tz)
    if shared > MAX_BLOCK_SHARED:
        raise ValueError(
            f"kernel {tuple(kernel.shape)} needs {shared} bytes of shared memory a "
            f"block for its weight fragments and halo tile; the limit is "
            f"{MAX_BLOCK_SHARED}")
    lib = _build.load()
    x = x.contiguous()
    kernel = kernel.contiguous()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.snt_stencil_mma(
            x.data_ptr(), kernel.data_ptr(), out.data_ptr(),
            b, z, xx, yy, k_z, k_x, k_y, int(bool(activation)), int(bool(split)),
            int(tau is not None), float(0.0 if tau is None else tau), tz,
            ctypes.c_void_p(stream))
    _build.check(err, "stencil_mma")
    MXU_LAUNCHES.add()
    return out


def stencil_dk_plain(x: torch.Tensor, g: torch.Tensor,
                     kernel_size: Tuple[int, int, int],
                     z_prepadded: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`stencil_dk`: one f32 product-sum per
    tap over the SAME-padded x (``z_prepadded``: padded in x and y alone).
    (A conv with the batch as input channel would be a conv whose weight is
    the whole volume.)"""
    k_z, k_x, k_y = kernel_size
    _, _, z, xx, yy = g.shape
    xp = F.pad(x, _xy_pads(kernel_size) if z_prepadded else same_pads(kernel_size))[:, 0]
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

    ``z_prepadded=True`` is the gradient of the halo conv: x carries the
    k_z − 1 halo planes (Z + k_z − 1 planes against g's Z) and is padded in
    x and y alone.

    A CPU tensor takes :func:`stencil_dk_plain`; a CUDA tensor launches the
    kernel or raises. The kernel reduces in a fixed order: the same input
    gives the same bits on every run.
    """
    _check_volume("x", x)
    _check_volume("g", g)
    kernel_size = tuple(int(k) for k in kernel_size)
    if len(kernel_size) != 3 or min(kernel_size) < 1:
        raise ValueError(f"kernel_size must be three positive ints, got {kernel_size}")
    z_g = x.shape[2] - (kernel_size[0] - 1) if z_prepadded else x.shape[2]
    if (g.shape[:2] + g.shape[3:] != x.shape[:2] + x.shape[3:] or g.shape[2] != z_g
            or x.device != g.device):
        raise ValueError(f"x {tuple(x.shape)} on {x.device} and g {tuple(g.shape)} "
                         f"on {g.device} must match (g with {z_g} z planes)")
    if x.device.type == "cpu":
        return stencil_dk_plain(x, g, kernel_size, z_prepadded)
    _check_launch(x, kernel_size)
    return _launch_dk(x, g, kernel_size, stencil_route(kernel_size), z_prepadded)


def _launch_dk(x: torch.Tensor, g: torch.Tensor, kernel_size: Tuple[int, int, int],
               route: str, z_prepadded: bool = False) -> torch.Tensor:
    """One launch of the kernel gradient on checked CUDA tensors, through the
    kernel ``route`` names (``stencil_route`` picks it; the card tests
    force either); the SAME form, or the halo form (``z_prepadded``)."""
    b, _, z, xx, yy = g.shape
    z_in = x.shape[2]
    k_z, k_x, k_y = kernel_size
    z_lo = 0 if z_prepadded else (k_z - 1) // 2
    x = x.contiguous()
    g = g.contiguous()
    zg = stencil_dk_plan(b, z, xx, yy) if route == "fast" else 1
    lib = _build.load()
    n_blocks = lib.snt_stencil_dk_blocks(b, z, xx, yy, _ROUTE_FLAG[route], zg)
    dk = torch.empty(kernel_size, dtype=torch.float32, device=x.device)
    partial = torch.empty((k_z * k_x * k_y, n_blocks), dtype=torch.float32,
                          device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.snt_stencil_dk(
            x.data_ptr(), g.data_ptr(), dk.data_ptr(), partial.data_ptr(),
            b, z, xx, yy, k_z, k_x, k_y, _ROUTE_FLAG[route], zg, z_in, z_lo,
            ctypes.c_void_p(stream))
    _build.check(err, "stencil_dk")
    DK_LAUNCHES.add()
    return dk


def _conv_transpose_same(g: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """dx of the SAME conv, plain PyTorch: correlation of g with the
    flipped kernel under the mirrored pads (low k//2, high (k-1)//2)."""
    pads = same_pads(kernel.shape)
    mirrored = tuple(p for lo, hi in zip(pads[::2], pads[1::2]) for p in (hi, lo))
    return F.conv3d(F.pad(g, mirrored), kernel.flip((0, 1, 2))[None, None])


def _fused_backward(ctx, g):
    """The backward both fused forms share: exact f32, whatever the forward."""
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


class _FusedGeneoConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel):
        out = geneo_stencil_conv(x, kernel, activation=True)
        ctx.save_for_backward(x, kernel, out)
        return out

    backward = staticmethod(_fused_backward)


class _FusedGeneoConvMxu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel):
        out = geneo_stencil_conv_mxu(x, kernel, activation=True, split=True)
        ctx.save_for_backward(x, kernel, out)
        return out

    backward = staticmethod(_fused_backward)


def fused_geneo_conv(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """relu(tanh(conv_same(x, kernel))), differentiable in both arguments.

    Forward: :func:`geneo_stencil_conv`. Backward: dk by :func:`stencil_dk`;
    dx, only when x requires grad, by the stencil with the flipped kernel
    (kernels odd on every axis) or the plain conv-transpose with mirrored
    pads (the JAX package takes an XLA conv there too).
    """
    return _FusedGeneoConv.apply(x, kernel)


def fused_geneo_conv_mxu(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """:func:`fused_geneo_conv` with the tensor-core forward
    (:func:`geneo_stencil_conv_mxu`, split bf16, near f32) and the same
    exact f32 backward: the gradients see the forward's rounding only
    through the activation's cotangent."""
    return _FusedGeneoConvMxu.apply(x, kernel)


def _halo_conv_transpose(g: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """dx of the halo conv, plain PyTorch: full correlation of g with the
    flipped kernel along z (pads k_z − 1 on both sides), mirrored SAME pads
    in x and y."""
    k_z = kernel.shape[0]
    pads = same_pads(kernel.shape)
    mirrored = (pads[1], pads[0], pads[3], pads[2], k_z - 1, k_z - 1)
    return conv3d_f32(F.pad(g, mirrored), kernel.flip((0, 1, 2))[None, None])


class _HaloStencilConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_ext, kernel, activation):
        out = geneo_stencil_conv(x_ext, kernel, activation=activation, z_prepadded=True)
        ctx.activation = activation
        ctx.save_for_backward(x_ext, kernel, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x_ext, kernel, out = ctx.saved_tensors
        k_z = kernel.shape[0]
        if ctx.activation:
            # out = relu(tanh(c)); d/dc = 1 − tanh²(c) where tanh(c) > 0
            g = g * torch.where(out > 0, 1.0 - out * out, torch.zeros_like(out))
        g = g.contiguous()
        dx = dk = None
        if ctx.needs_input_grad[0]:
            if all(k % 2 for k in kernel.shape):
                # odd on every axis: the mirrored x/y pads equal the forward's,
                # so dx is the halo form of the f32 stencil on the flipped
                # kernel over g padded by k_z − 1 planes on both sides in z
                g_ext = F.pad(g, (0, 0, 0, 0, k_z - 1, k_z - 1))
                dx = geneo_stencil_conv(g_ext, kernel.flip((0, 1, 2)).contiguous(),
                                        activation=False, z_prepadded=True)
            else:
                dx = _halo_conv_transpose(g, kernel)
        if ctx.needs_input_grad[1]:
            dk = stencil_dk(x_ext, g, tuple(kernel.shape), z_prepadded=True)
        return dx, dk, None


def halo_stencil_conv(x_ext: torch.Tensor, kernel: torch.Tensor,
                      activation: bool = False) -> torch.Tensor:
    """VALID-z / SAME-x/y stencil conv of one z slab of a spatially sharded
    volume, differentiable in both arguments.

    x_ext : (B, 1, Z_local + k_z − 1, X, Y), the local z slab with its
    neighbours' halo planes already concatenated (zeros at the volume's
    ends). Returns (B, 1, Z_local, X, Y); concatenating the slabs' outputs
    over z equals the unsharded SAME conv. ``activation`` applies relu∘tanh.

    Forward: :func:`geneo_stencil_conv` with ``z_prepadded=True``. Backward
    (the JAX package's): the cotangent masked by ``out > 0`` under the
    activation; dx by that halo form of the f32 stencil on the flipped
    kernel over g padded by k_z − 1 zero planes on both sides in z for
    kernels odd on every axis, by the plain library conv for the others;
    dk by :func:`stencil_dk` with ``z_prepadded=True``.
    """
    return _HaloStencilConv.apply(x_ext, kernel, bool(activation))
