"""Multi-channel 3×3×3 SAME conv3d: the CUDA kernel, its plain twin and the
differentiable composition.

- ``conv3d_mc_same`` is the port of the TPU kernel
  ``scenenet_tpu.ops.pallas_conv_mc.conv3d_mc_same``: x (B, C_in, Z, X, Y) ×
  w (C_out, C_in, 3, 3, 3) → (B, C_out, Z, X, Y), stride 1, zero pad 1 a
  side, no bias, f32 in and out with f32 accumulation; with
  ``channels_last=True`` x and the result are (B, Z, X, Y, C)
  (``csrc/conv3d_mc.cu``). Layers with more than ``FMA_MAX_C_IN`` input
  channels run on the tensor cores as a three-product split: each f32
  operand is ``hi + lo`` with ``hi`` its TF32 part, and the product is taken
  as ``hi·hi`` (one TF32 mma) ``+ lo·hi + hi·lo`` (both in one bf16 mma, whose
  8 bits are enough for terms 2⁻¹¹ of the first) with f32 sums, inside the
  f32 tolerance. The rest and the channels-last layout run the f32 FMA
  kernel. :func:`conv3d_mc_plan` picks the route, the tile and the K split
  from the shape alone.
- The bf16 form (``csrc/conv3d_mc.cu``) takes bf16 x and w and returns
  bf16, with f32 sums and each output rounded once. Past ``FMA_MAX_C_IN``
  input channels it is a tensor-core kernel of its own: bf16 operands on
  the bf16 ``m16n8k16`` mma, 16 channels of one tap a K step, the input
  staged by ``cp.async`` and paired into channel-interleaved words in
  shared memory, the weights packed once a call in the B fragments' order
  (:func:`pack_bf16_fragments` is that order in torch). Up to
  ``FMA_MAX_C_IN`` channels (the UNet's 1→32 layer) it is the FMA kernel's
  bf16 form. Channels first only (channels-last bf16 raises). It is the
  conv of the bf16 UNet.
- ``conv3d_mc_same_plain`` is the plain PyTorch version: ``F.conv3d`` with
  padding 1 and TF32 off (for bf16 operands: on their values widened to
  f32, the result rounded to bf16). ``conv3d_mc_same_tc_plain`` repeats the
  tensor-core kernel's arithmetic (``split_weights`` and ``split_inputs`` by
  bit arithmetic, three f32 convs) for the CPU tests.
- ``conv3d_mc_weight_grad`` is the conv's weight gradient dw. The JAX
  package has no kernel for it (its ``conv3d_mc_same`` carries no custom
  gradient, and the weight gradient of its models is XLA's conv). For f32
  on the card it is a kernel of the port with no TPU counterpart
  (``csrc/conv3d_mc_dw.cu``): a GEMM of C_out × 27·C_in over the batch's
  voxels on the tensor cores, with the forward's three-product split and a
  fixed-order K split; :func:`conv3d_mc_dw_plan` picks its tile and split
  from the shape alone. ``conv3d_mc_weight_grad_tc_plain`` repeats its
  arithmetic (``split_inputs`` on both operands, three f32 library dw
  calls). For bf16 operands on the card dw stays cuDNN's bf16 weight
  gradient, a library call.
- ``fused_conv3d_mc`` is that conv as a ``torch.autograd.Function``, the
  conv of ``UNet3D`` and ``CnnBaseline`` on the kernel backend. Forward:
  the kernel. dx, only when x needs it: the same kernel on the cotangent
  with the weights flipped on their three spatial axes and their two
  channel axes swapped (exact for a 3³ kernel with pad 1). dw:
  :func:`conv3d_mc_weight_grad`.

For a CUDA tensor each wrapper launches its kernel; for a CPU tensor it
runs its plain version. Kernel and plain version sum in a different order
(and the tensor-core route drops the ``lo·lo`` term, 2⁻²¹ of a product), so
they agree to f32 rounding, not bit for bit. The kernels use no atomics:
their K splits are reduced in a fixed order, so two runs give the same bits.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from scenenet_tpu_torch.ops import _build
from scenenet_tpu_torch.ops.conv3d import conv3d_f32, cudnn_off

MC_LAUNCHES = _build.LaunchCounter("conv3d_mc")
MC_BF16_LAUNCHES = _build.LaunchCounter("conv3d_mc_bf16")  # the bf16 form
MC_DW_LAUNCHES = _build.LaunchCounter("conv3d_mc_dw")  # f32 dw and its K-split reduction
DTYPES = (torch.float32, torch.bfloat16)

K_STEP = 8          # input channels of one tensor-core K step (one tap of a chunk)
K_STEP_BF16 = 16    # the same in the bf16 form: the K of one bf16 m16n8k16 mma
MAX_K_SPLITS = 32   # most blocks that share one output tile's C_in
TARGET_BLOCKS = 264  # two blocks for each of the card's 132 SMs
# the bf16 form's K split stays within one block an SM: its partial sums and
# their reduction cost more than the idle SMs of a short wave save (on an H100
# the UNet's 8³ layers ran 1.1-1.4x slower split 2 to 4 ways than unsplit,
# csrc/bench/conv_mc_bf16_times.py)
BF16_TARGET_BLOCKS = 132
FMA_MAX_C_IN = 4    # up to here a layer stays on the FMA kernel: padded to a K
#                     step the tensor cores would do twice the work or more
# the tensor-core kernel's tiles, by the id the C entry takes:
# (samples, z, x, y) voxels of a block and its output channels
TC_TILES = {0: ((1, 4, 8, 16), 32), 1: ((1, 8, 8, 8), 32), 2: ((1, 4, 8, 8), 64),
            3: ((4, 4, 4, 4), 64)}
FMA_TILE = "fma"
# the weight gradient's kernel: a block takes 32 output channels x the tile's
# input channels x 27 taps, over stages of the tile's voxels (samples, z, x,
# y); tiles by the id the C entry takes; one block an SM (its shared memory),
# one wave where the K split can fill it
DW_CO = 32
DW_TILES = {0: ((1, 4, 4, 16), 16), 1: ((1, 4, 8, 8), 16), 2: ((2, 4, 4, 4), 16),
            3: ((1, 4, 4, 16), 8), 4: ((1, 4, 8, 8), 8), 5: ((2, 4, 4, 4), 8)}
DW_TARGET_BLOCKS = 132


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
    if x.dtype not in DTYPES or w.dtype != x.dtype:
        raise TypeError(f"x and w must be both float32 or both bfloat16, got {x.dtype} and "
                        f"{w.dtype}")
    if channels_last and x.dtype == torch.bfloat16:
        raise ValueError("the bf16 form is channels first only")
    if x.device != w.device:
        raise ValueError(f"x on {x.device}, w on {w.device}")


def conv3d_mc_same_plain(x: torch.Tensor, w: torch.Tensor,
                         channels_last: bool = False) -> torch.Tensor:
    """Plain PyTorch version: one ``F.conv3d`` with padding 1, in full f32
    (TF32 off); bf16 operands are widened to f32 and the result rounded to
    bf16 once."""
    if x.dtype == torch.bfloat16:
        return conv3d_mc_same_plain(x.float(), w.float(), channels_last).to(torch.bfloat16)
    if channels_last:
        x = x.permute(0, 4, 1, 2, 3)
    out = conv3d_f32(x, w, padding=1)
    return out.permute(0, 2, 3, 4, 1).contiguous() if channels_last else out


def conv3d_mc_plan(b: int, c_in: int, c_out: int, z: int, x: int, y: int,
                   channels_last: bool = False, bf16: bool = False) -> Tuple[object, int]:
    """(tile, k_splits) for one call, from its shape alone.

    ``tile`` is ``FMA_TILE`` (C_in ≤ ``FMA_MAX_C_IN``, in either form, or
    channels-last: the FMA kernel, never split) or a key of ``TC_TILES``:
    32 output channels a block up to C_out = 32 and 64 past it; 16 voxels
    along y where the volume has more than 8, else 8; and where the volume
    is within 4³, four samples of 4×4×4 in one tile, so that none of it lies
    outside. ``k_splits`` divides the chunks of C_in (8 channels, 16 in the
    ``bf16`` form) among that many blocks where the tiles alone give fewer
    than ``TARGET_BLOCKS``, up to :func:`conv3d_mc_split_cap`. The bf16 form
    takes the f32 form's tiles; its K split is the most that keeps the
    launch within ``BF16_TARGET_BLOCKS`` (one wave of one block an SM), up
    to its cap.
    """
    if channels_last or c_in <= FMA_MAX_C_IN:
        return FMA_TILE, 1
    if c_out <= 32:
        tile = 0 if y > 8 else 1
    else:
        tile = 3 if max(z, x, y) <= 4 else 2
    blocks = conv3d_mc_blocks(tile, 1, b, c_out, z, x, y)
    if bf16:
        return tile, max(1, min(conv3d_mc_split_cap(tile, c_in, True),
                                BF16_TARGET_BLOCKS // blocks))
    return tile, min(conv3d_mc_split_cap(tile, c_in), -(-TARGET_BLOCKS // blocks))


def conv3d_mc_split_cap(tile, c_in: int, bf16: bool = False) -> int:
    """The most K splits a call may take: one chunk a block at least (8
    channels, 16 in the bf16 form), ``MAX_K_SPLITS`` at most; 1 on the FMA
    kernel."""
    step = K_STEP_BF16 if bf16 else K_STEP
    return 1 if tile == FMA_TILE else min(-(-c_in // step), MAX_K_SPLITS)


def conv3d_mc_blocks(tile, k_splits: int, b: int, c_out: int, z: int, x: int, y: int) -> int:
    """Blocks a tensor-core launch has under ``tile`` and ``k_splits``."""
    (tb, tz, tx, ty), bn = TC_TILES[tile]
    return (-(-b // tb) * -(-z // tz) * -(-x // tx) * -(-y // ty) * -(-c_out // bn)
            * k_splits)


def pack_bf16_fragments(w: torch.Tensor, bn: int) -> torch.Tensor:
    """bf16 weights (C_out, C_in, 3, 3, 3) → the B fragments the bf16 form's
    kernel packs once a call, as int32 (co_tiles, C_in/16 chunks, 27 taps,
    bn/16, 32 lanes, 4): for lane ``g·4 + t`` of entry ``jj``, words 0, 1 are
    the ``m16n8k16`` B registers b0, b1 of n8 tile ``2·jj`` (output channel
    ``8·(2·jj) + g`` of the tile; b0 holds input channels ``2t`` (low half)
    and ``2t + 1`` of the chunk, b1 ``2t + 8`` and ``2t + 9``), words 2, 3
    those of n8 tile ``2·jj + 1``; zero past C_in or C_out."""
    c_out, c_in = w.shape[:2]
    co_t, nc = -(-c_out // bn), -(-c_in // K_STEP_BF16)
    bits = torch.zeros((co_t * bn, nc * K_STEP_BF16, 27), dtype=torch.int32)
    bits[:c_out, :c_in] = w.detach().cpu().reshape(c_out, c_in, 27).contiguous() \
        .view(torch.int16).to(torch.int32) & 0xFFFF
    # (co_tile, n8 pair jj, h = which n8 of the pair, g, chunk, K slot, tap)
    b = bits.reshape(co_t, bn // 16, 2, 8, nc, K_STEP_BF16, 27)
    # K slot = 8·half + 2t + e (e: low or high half of a word)
    b = b.reshape(co_t, bn // 16, 2, 8, nc, 2, 4, 2, 27)
    words = b[..., 0, :] | (b[..., 1, :] << 16)   # (co_t, jj, h, g, nc, half, t, tap)
    words = words.permute(0, 4, 7, 1, 3, 6, 2, 5)  # (co_t, nc, tap, jj, g, t, h, half)
    return words.reshape(co_t, nc, 27, bn // 16, 32, 4).contiguous()


def tf32_round(v: torch.Tensor) -> torch.Tensor:
    """f32 → the nearest TF32 value (10 mantissa bits, ties away from zero,
    as ``cvt.rna.tf32.f32`` rounds), still as f32: half an ulp added to the
    magnitude's bits, the low 13 bits cleared."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_truncate(v: torch.Tensor) -> torch.Tensor:
    """f32 → the TF32 value next towards zero: the low 13 bits cleared."""
    return (v.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _bf16(v: torch.Tensor) -> torch.Tensor:
    return v.to(torch.bfloat16).to(torch.float32)


def split_weights(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 weights → ``(hi, lo)``: ``hi = tf32(w)`` rounded to nearest,
    ``lo = bf16(w − hi)`` (the difference is exact in f32), both as f32.
    ``hi + lo`` reproduces ``w`` to 2⁻²⁰ relative. The split the kernel makes
    of its weights once a call."""
    hi = tf32_round(w)
    return hi, _bf16(w - hi)


def split_inputs(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 inputs → ``(hi, lo)``: ``hi`` the leading 10 mantissa bits (a
    mask), ``lo = bf16(x − hi)``: 2⁻¹⁹ relative. The split the kernel makes of
    its inputs in registers as it loads them."""
    hi = tf32_truncate(x)
    return hi, _bf16(x - hi)


def conv3d_mc_same_tc_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The tensor-core kernel's arithmetic in plain PyTorch: three f32 convs,
    ``x_hi·w_hi`` (a product of two TF32 values is exact in f32) and the two
    cross terms ``x_lo·bf16(w) + bf16(x)·w_lo`` (what the kernel's one bf16
    mma takes), f32 sums; the ``lo·lo`` term, 2⁻²¹ of a product, is dropped.
    Channels first."""
    xh, xl = split_inputs(x)
    wh, wl = split_weights(w)
    return conv3d_f32(xl, _bf16(w), padding=1) + conv3d_f32(_bf16(x), wl, padding=1) \
        + conv3d_f32(xh, wh, padding=1)


def _transposed(w: torch.Tensor) -> torch.Tensor:
    """(C_out, C_in, 3, 3, 3) → (C_in, 27, C_out) contiguous, the layout the
    kernel stages from (rows of C_out weights per input channel and tap)."""
    c_out, c_in = w.shape[:2]
    return w.reshape(c_out, c_in, 27).permute(1, 2, 0).contiguous()


def _launch_tc(x: torch.Tensor, w: torch.Tensor, tile: int, k_splits: int) -> torch.Tensor:
    """The tensor-core kernel on channels-first x and weights of any strides:
    the weight split (or packing), the conv and the K-split reduction are
    one launch of the wrapper. bf16 x and w take the bf16 form and return
    bf16."""
    x = x.contiguous()
    b, c_in, z, xx, yy = x.shape
    c_out = w.shape[0]
    bn = TC_TILES[tile][1]
    half = x.dtype == torch.bfloat16
    out = torch.empty((b, c_out, z, xx, yy), dtype=x.dtype, device=x.device)
    # f32: a TF32 pair and two bf16 pairs (16 bytes) a lane, n8 tile, tap and
    # 8 channels; bf16: two bf16 pairs (8 bytes) a lane, n8 tile, tap and 16
    frag_words = -(-c_out // bn) * 27 * bn * (-(-c_in // K_STEP_BF16) * 8 if half
                                              else -(-c_in // K_STEP) * 16)
    frag = torch.empty((frag_words,), dtype=torch.float32, device=x.device)
    partial = (torch.empty((k_splits, *out.shape), dtype=torch.float32, device=x.device)
               if k_splits > 1 else None)
    lib = _build.load()
    entry = lib.snt_conv3d_mc_tc_bf16 if half else lib.snt_conv3d_mc_tc
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = entry(x.data_ptr(), w.data_ptr(), frag.data_ptr(), out.data_ptr(),
                    partial.data_ptr() if k_splits > 1 else None,
                    b, c_in, c_out, z, xx, yy, *w.stride(), tile, k_splits,
                    ctypes.c_void_p(stream))
    _build.check(err, "conv3d_mc_bf16" if half else "conv3d_mc")
    (MC_BF16_LAUNCHES if half else MC_LAUNCHES).add()
    return out


def _launch(x: torch.Tensor, wt: torch.Tensor, channels_last: bool) -> torch.Tensor:
    """The FMA kernel on contiguous x and transposed weights ``wt`` (C_in, 27,
    C_out); bf16 x and wt take its bf16 form and return bf16."""
    c_in, _, c_out = wt.shape
    x = x.contiguous()
    half = x.dtype == torch.bfloat16
    if channels_last:
        b, z, xx, yy, _ = x.shape
        out = torch.empty((b, z, xx, yy, c_out), dtype=x.dtype, device=x.device)
    else:
        b, _, z, xx, yy = x.shape
        out = torch.empty((b, c_out, z, xx, yy), dtype=x.dtype, device=x.device)
    vox = z * xx * yy

    def strides(c):  # element strides of (sample, channel, voxel)
        return (vox * c, 1, c) if channels_last else (vox * c, vox, 1)

    # four y outputs a store: 16 bytes of f32, 8 of bf16
    vec_out = int(not channels_last and yy % 4 == 0
                  and out.data_ptr() % (4 * out.element_size()) == 0)
    lib = _build.load()
    entry = lib.snt_conv3d_mc_bf16 if half else lib.snt_conv3d_mc
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = entry(x.data_ptr(), wt.data_ptr(), out.data_ptr(),
                    b, c_in, c_out, z, xx, yy, *strides(c_in), *strides(c_out),
                    vec_out, ctypes.c_void_p(stream))
    _build.check(err, "conv3d_mc_bf16" if half else "conv3d_mc")
    (MC_BF16_LAUNCHES if half else MC_LAUNCHES).add()
    return out


def conv3d_mc_same(x: torch.Tensor, w: torch.Tensor,
                   channels_last: bool = False) -> torch.Tensor:
    """SAME 3³ conv3d.

    x (B, C_in, Z, X, Y) × w (C_out, C_in, 3, 3, 3) → (B, C_out, Z, X, Y),
    in x's dtype: f32, or bf16 (K10's bf16 form, channels first). With
    ``channels_last=True`` x is (B, Z, X, Y, C_in) and the output matches.
    Any other kernel size raises a ``ValueError``. Forward only on the CUDA
    path: the differentiable form is :func:`fused_conv3d_mc`.

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
    if channels_last:
        b, z, xx, yy, _ = x.shape
    else:
        b, _, z, xx, yy = x.shape
    tile, k_splits = conv3d_mc_plan(b, w.shape[1], w.shape[0], z, xx, yy, channels_last,
                                    bf16=x.dtype == torch.bfloat16)
    if tile == FMA_TILE:
        return _launch(x, _transposed(w), channels_last)
    return _launch_tc(x, w, tile, k_splits)


def conv3d_mc_weight_grad_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dw of the SAME 3³ conv, (C_out, C_in, 3, 3, 3), in full f32 by
    PyTorch's own kernels (cuDNN off); bf16 operands are widened to f32 and
    the result rounded to bf16 once."""
    if x.dtype == torch.bfloat16:
        return conv3d_mc_weight_grad_plain(x.float(), g.float()).to(torch.bfloat16)
    with cudnn_off():
        return torch.nn.grad.conv3d_weight(x, (g.shape[1], x.shape[1], 3, 3, 3), g, padding=1)


def conv3d_mc_weight_grad_tc_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The dw kernel's arithmetic in plain PyTorch: both operands split by
    :func:`split_inputs`, three f32 weight gradients, ``x_hi·g_hi`` (exact
    products of TF32 values) and the cross terms ``x_lo·bf16(g) +
    bf16(x)·g_lo`` (what the kernel's one bf16 mma takes), f32 sums; the
    ``lo·lo`` term, 2⁻²⁰ of a product, is dropped."""
    xh, xl = split_inputs(x)
    gh, gl = split_inputs(g)
    return conv3d_mc_weight_grad_plain(xl, _bf16(g)) + conv3d_mc_weight_grad_plain(_bf16(x), gl) \
        + conv3d_mc_weight_grad_plain(xh, gh)


def conv3d_mc_dw_stages(tile: int, b: int, z: int, x: int, y: int) -> int:
    """Stages (the tile's voxels, ``DW_TILES[tile][0]``) that cover the batch."""
    tb, tz, tx, ty = DW_TILES[tile][0]
    return -(-b // tb) * -(-z // tz) * -(-x // tx) * -(-y // ty)


def conv3d_mc_dw_blocks(tile: int, splits: int, c_in: int, c_out: int) -> int:
    """Blocks of a dw launch: a channel tile pair and a K split each."""
    return -(-c_out // DW_CO) * -(-c_in // DW_TILES[tile][1]) * splits


def conv3d_mc_dw_plan(b: int, c_in: int, c_out: int, z: int, x: int, y: int) -> Tuple[int, int]:
    """(tile, splits) of the weight gradient's kernel, from the shape alone.

    ``tile`` is a key of ``DW_TILES``: 4×4×16 voxels a stage where the
    volume has more than 8 along y, 4×8×8 up to that, and two samples of
    4×4×4 where it is within 4³, so that little of a tile lies outside; 16
    input channels a block, or 8 up to C_in = 8 (the 1→32 layer runs as
    8→32, not 16→32). ``splits`` divides the stages among that many blocks
    of one channel tile pair, so that the launch comes to
    ``DW_TARGET_BLOCKS`` blocks where the channel tiles alone give fewer, at
    most one split a stage. Split ``k`` takes stages ``[k·n // splits, (k +
    1)·n // splits)`` of the ``n`` that :func:`conv3d_mc_dw_stages` counts.
    Any shape and channel count takes the kernel: C_in and C_out are padded
    to the block's channels, the volume to whole tiles."""
    tile = (0 if y > 8 else 1 if max(z, x, y) > 4 else 2) + (3 if c_in <= 8 else 0)
    splits = DW_TARGET_BLOCKS // conv3d_mc_dw_blocks(tile, 1, c_in, c_out)
    return tile, max(1, min(splits, conv3d_mc_dw_stages(tile, b, z, x, y)))


def _launch_dw(x: torch.Tensor, g: torch.Tensor, tile: int, splits: int) -> torch.Tensor:
    """The dw kernel on f32 x (B, C_in, Z, X, Y) and g (B, C_out, Z, X, Y)
    under ``tile`` and ``splits``; the K split's reduction is a second
    launch. Counts the kernels it launched."""
    x, g = x.contiguous(), g.contiguous()
    b, c_in, z, xx, yy = x.shape
    c_out = g.shape[1]
    out = torch.empty((c_out, c_in, 3, 3, 3), dtype=torch.float32, device=x.device)
    partial = (torch.empty((splits, c_out, c_in, 27), dtype=torch.float32, device=x.device)
               if splits > 1 else None)
    # the tiles by tensor copies, whose maps want rows of whole 16-byte words
    vec = int(yy % 4 == 0 and x.data_ptr() % 16 == 0 and g.data_ptr() % 16 == 0)
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.snt_conv3d_mc_dw(x.data_ptr(), g.data_ptr(), out.data_ptr(),
                                   partial.data_ptr() if splits > 1 else None,
                                   b, c_in, c_out, z, xx, yy, tile, splits, vec,
                                   ctypes.c_void_p(stream))
    _build.check(err, "conv3d_mc_dw")
    MC_DW_LAUNCHES.add(2 if splits > 1 else 1)
    return out


def conv3d_mc_weight_grad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dw of the SAME 3³ conv, (C_out, C_in, 3, 3, 3), of x (B, C_in, Z, X,
    Y) and the output's cotangent g (B, C_out, Z, X, Y), in their dtype.

    A CPU tensor takes :func:`conv3d_mc_weight_grad_plain`. On the card f32
    launches the kernel (:func:`conv3d_mc_dw_plan`) or raises; bf16 is
    cuDNN's bf16 weight gradient: PyTorch's own kernels in bf16 sum the
    batch's samples in bf16, which takes them further from the plain version
    than cuDNN, and they take longer (``PERF.md``)."""
    if x.ndim != 5 or g.ndim != 5 or x.shape[0] != g.shape[0] or x.shape[2:] != g.shape[2:]:
        raise ValueError(f"x {tuple(x.shape)} and g {tuple(g.shape)} must be (B, C, Z, X, Y) "
                         "of one batch and volume")
    if x.dtype not in DTYPES or g.dtype != x.dtype:
        raise TypeError(f"x and g must be both float32 or both bfloat16, got {x.dtype} and "
                        f"{g.dtype}")
    if x.device.type == "cpu":
        return conv3d_mc_weight_grad_plain(x, g)
    if x.device.type != "cuda" or g.device != x.device:
        raise ValueError(f"no conv3d_mc_dw kernel for x on {x.device}, g on {g.device}")
    if x.dtype == torch.bfloat16:
        return torch.nn.grad.conv3d_weight(x, (g.shape[1], x.shape[1], 3, 3, 3), g, padding=1)
    return _launch_dw(x, g, *conv3d_mc_dw_plan(x.shape[0], x.shape[1], g.shape[1],
                                              *x.shape[2:]))


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
    """:func:`conv3d_mc_same` (channels first, f32 or bf16), differentiable
    in both arguments: the kernel forward, the kernel again for dx (launched
    only when x requires grad), :func:`conv3d_mc_weight_grad` for dw."""
    return _FusedConv3dMc.apply(x, w)
