"""The voxel histogram family: the CUDA kernels and their plain twins.

Ports of the TPU kernels of :mod:`scenenet_tpu.ops.pallas_hist`. Four take
raw points, live in ``csrc/points_occupancy.cu`` and share its bounds pass
and id recipe:

- ``points_occupancy`` (``pallas_points_occupancy``, the serving prep):
  per sample, the masked bounding box expanded to a cube, each valid
  point's flat (z, x, y) bin id by the multiply recipe
  ``(p − lo)·(n / range)`` with the pyntcloud edge rule, the counts, and
  ``count > min of its y column`` as float {0, 1};
- ``points_binary`` (``pallas_points_binary``, the training prep): the
  same occupancy and, as a second grid, tower presence — 1 where any valid
  point flagged as tower lands;
- ``points_bin_counts`` (``pallas_points_bin_counts``): the counts
  themselves and, as a second grid, the counts of the flagged points, for
  the density and tower-fraction grids;
- ``flat_ids`` (``pallas_flat_ids``): the bin ids alone.

Two take flat bin ids computed beforehand (``csrc/bin_counts.cu``):

- ``bin_counts`` (``pallas_bin_counts``): counts and flagged counts as the
  two halves of one 64-bit counter a voxel (one integer atomic a point, then
  one pass that writes both f32 grids), or sums of float weights at bf16
  precision;
- ``sorted_bin_counts`` (``pallas_sorted_bin_counts``): the same counts for
  large grids, slab by slab, from the ids partitioned by slab (no sort).

Unlike the TPU kernels they take any grid. For a CUDA tensor each wrapper
launches its kernel; for a CPU tensor it runs its plain version, which
follows the same f32 recipe op by op, so the two are bit-identical.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import torch

from scenenet_tpu_torch.ops import _build

LAUNCHES = _build.LaunchCounter("points_occupancy")
BINARY_LAUNCHES = _build.LaunchCounter("points_binary")
BIN_COUNTS_LAUNCHES = _build.LaunchCounter("points_bin_counts")
FLAT_COUNTS_LAUNCHES = _build.LaunchCounter("bin_counts")
SORTED_COUNTS_LAUNCHES = _build.LaunchCounter("sorted_bin_counts")
FLAT_IDS_LAUNCHES = _build.LaunchCounter("flat_ids")

ID_ROW = 512  # the TPU kernels lay a grid out in rows of 512 bins (their n_hi rows)

_BIG = 3.4e38  # the TPU kernel's masked-bound sentinel

BOUNDS_UNIT = 1024  # points a block of the bounds pass takes a step: 256 threads x 4
BOUNDS_TARGET_BLOCKS = 1056  # one full wave of 256-thread blocks on 132 SMs
MARK_POINTS = 4096  # points a block of the mark pass takes at most
MARK_MIN_BLOCKS = 264  # two blocks an SM: the least the mark pass is cut to
SLAB_BINS = 4096  # bins K8's slab pass counts a block
MAX_PARTS = 4096  # K8's partition parts a sample at most
SORTED_TARGET_BLOCKS = 264  # two 256-thread blocks an SM for K8's partition passes


def edge_bins(rel: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """``clip(ceil(rel − 1e-4) − 1, 0, n − 1)`` as int64.

    The pyntcloud rule (a point on an interior edge belongs to the lower
    bin; the 1e-4 bias keeps that through f32 noise). The clamp happens in
    float before the conversion; NaN (the divide recipe on a zero-extent
    cloud) goes to bin 0, as XLA's saturating conversion sends it there.
    """
    c = torch.nan_to_num(torch.ceil(rel - 1e-4), nan=0.0)
    return torch.minimum(torch.clamp(c, min=1.0), n).to(torch.int64) - 1


def _cube_bounds_mul(points: torch.Tensor, mask: torch.Tensor,
                     grid_shape: Tuple[int, int, int]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, 3) lo and 1/step, exactly as the TPU kernel computes them."""
    m = mask[..., None]
    l = torch.where(m, points, _BIG).amin(dim=1)
    h = torch.where(m, points, -_BIG).amax(dim=1)
    r = h - l
    half = (r.amax(dim=1, keepdim=True) - r) * 0.5
    lo, hi = l - half, h + half
    n = torch.tensor(grid_shape, dtype=torch.float32, device=points.device)
    inv_step = n / torch.clamp(hi - lo, min=1e-30)
    return lo, inv_step


def flat_ids_mul(points: torch.Tensor, mask: torch.Tensor,
                 grid_shape: Tuple[int, int, int]) -> torch.Tensor:
    """(B, N) int64 flat (z, x, y) bin ids by the multiply recipe, each
    sample binned in its own masked cube bounds, as the kernels bin them."""
    n_x, n_y, _ = grid_shape
    lo, inv_step = _cube_bounds_mul(points, mask, grid_shape)
    n = torch.tensor(grid_shape, dtype=torch.float32, device=points.device)
    idx = edge_bins((points - lo[:, None]) * inv_step[:, None], n)
    return (idx[..., 2] * n_x + idx[..., 0]) * n_y + idx[..., 1]


def _grid_counts(flat: torch.Tensor, keep: torch.Tensor, size: int) -> torch.Tensor:
    """(B, size) int64 counts of the ids where ``keep`` is set."""
    b = flat.shape[0]
    offs = torch.arange(b, device=flat.device)[:, None] * size
    ids = torch.where(keep, flat + offs, b * size)
    return torch.bincount(ids.reshape(-1), minlength=b * size + 1)[: b * size].reshape(b, size)


def above_column_min(counts: torch.Tensor, n_y: int) -> torch.Tensor:
    """``count > min of its y column`` as f32 {0, 1}, (B, size)."""
    b = counts.shape[0]
    cols = counts.reshape(b, -1, n_y)
    return (cols > cols.amin(dim=1, keepdim=True)).to(torch.float32).reshape(b, -1)


def points_occupancy_plain(points: torch.Tensor, mask: torch.Tensor,
                           grid_shape: Tuple[int, int, int]) -> torch.Tensor:
    """Plain PyTorch version: (B, N, 3) f32 + (B, N) bool → (B, size) f32."""
    n_x, n_y, n_z = grid_shape
    counts = _grid_counts(flat_ids_mul(points, mask, grid_shape), mask, n_x * n_y * n_z)
    return above_column_min(counts, n_y)


def points_binary_plain(points: torch.Tensor, mask: torch.Tensor, tower: torch.Tensor,
                        grid_shape: Tuple[int, int, int]
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`points_binary`: the occupancy of
    :func:`points_occupancy_plain` and ``tower count > 0``."""
    n_x, n_y, n_z = grid_shape
    size = n_x * n_y * n_z
    flat = flat_ids_mul(points, mask, grid_shape)
    occ = above_column_min(_grid_counts(flat, mask, size), n_y)
    towers = _grid_counts(flat, mask & tower, size)
    return occ, (towers > 0).to(torch.float32)


def points_bin_counts_plain(points: torch.Tensor, mask: torch.Tensor,
                            tower: Optional[torch.Tensor],
                            grid_shape: Tuple[int, int, int], channels: int = 2
                            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of :func:`points_bin_counts`."""
    n_x, n_y, n_z = grid_shape
    size = n_x * n_y * n_z
    flat = flat_ids_mul(points, mask, grid_shape)
    counts = _grid_counts(flat, mask, size).to(torch.float32)
    if channels == 1:
        return counts, None
    if tower is None:
        return counts, torch.zeros_like(counts)
    return counts, _grid_counts(flat, mask & tower, size).to(torch.float32)


def invalid_id(size: int) -> int:
    """The id :func:`flat_ids` gives a masked point: the first multiple of
    512 at or past ``size``, as the TPU kernel's."""
    return -(-size // ID_ROW) * ID_ROW


def flat_ids_plain(points: torch.Tensor, mask: torch.Tensor,
                   grid_shape: Tuple[int, int, int]) -> torch.Tensor:
    """Plain PyTorch version of :func:`flat_ids`."""
    n_x, n_y, n_z = grid_shape
    flat = flat_ids_mul(points, mask, grid_shape)
    return torch.where(mask, flat, invalid_id(n_x * n_y * n_z)).to(torch.int32)


def _counted(flat: torch.Tensor, mask: torch.Tensor, size: int) -> torch.Tensor:
    """(B, N) bool: the point is valid and its id lies in [0, size)."""
    return mask & (flat >= 0) & (flat < size)


def bin_counts_plain(flat: torch.Tensor, mask: torch.Tensor, size: int,
                     weights: Optional[torch.Tensor] = None, indicator: bool = True
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of :func:`bin_counts`."""
    flat = flat.to(torch.int64)
    keep = _counted(flat, mask, size)
    counts = _grid_counts(flat, keep, size).to(torch.float32)
    if weights is None:
        return counts, None
    if indicator:
        return counts, _grid_counts(flat, keep & (weights != 0), size).to(torch.float32)
    b = flat.shape[0]
    w = weights.to(torch.bfloat16).to(torch.float32)  # round to nearest even
    offs = torch.arange(b, device=flat.device)[:, None] * size
    ids = torch.where(keep, flat + offs, b * size).reshape(-1)
    wsum = torch.zeros(b * size + 1, dtype=torch.float32, device=flat.device)
    wsum.index_add_(0, ids, w.reshape(-1))
    return counts, wsum[: b * size].reshape(b, size)


def sorted_bin_counts_plain(flat: torch.Tensor, mask: torch.Tensor,
                            weights: Optional[torch.Tensor], size: int,
                            channels: int = 2
                            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of :func:`sorted_bin_counts`: a histogram
    needs no sort, so it is :func:`bin_counts_plain`'s indicator form."""
    if channels == 2 and weights is None:
        weights = torch.zeros_like(mask)
    return bin_counts_plain(flat, mask, size, weights if channels == 2 else None)


def _check_points(points: torch.Tensor, mask: torch.Tensor) -> None:
    if points.ndim != 3 or points.shape[2] != 3:
        raise ValueError(f"points must be (B, N, 3), got {tuple(points.shape)}")
    if mask.shape != points.shape[:2]:
        raise ValueError(f"mask must be {tuple(points.shape[:2])}, got {tuple(mask.shape)}")
    if points.dtype != torch.float32 or mask.dtype != torch.bool:
        raise TypeError(f"need float32 points and bool mask, got {points.dtype}, {mask.dtype}")
    if points.device != mask.device:
        raise ValueError(f"points on {points.device}, mask on {mask.device}")


def _check_launch_shape(points: torch.Tensor, grid_shape) -> Tuple[int, int, int, int, int]:
    if points.device.type != "cuda":
        raise ValueError(f"no points kernel for device {points.device}")
    b, n, _ = points.shape
    n_x, n_y, n_z = (int(g) for g in grid_shape)
    if min(b, n, n_x, n_y, n_z) < 1 or b > 65535 or b * n_x * n_y * n_z >= 2**31 \
            or n >= 2**31:
        raise ValueError(f"unsupported points shape B={b} N={n} grid={grid_shape}")
    return b, n, n_x, n_y, n_z


def _check_flag(flag: torch.Tensor, mask: torch.Tensor, what: str) -> None:
    if flag.shape != mask.shape or flag.dtype != torch.bool or flag.device != mask.device:
        raise ValueError(f"{what} must be a bool {tuple(mask.shape)} tensor on {mask.device}, "
                         f"got {flag.dtype} {tuple(flag.shape)} on {flag.device}")


def _check_ids(flat: torch.Tensor, mask: torch.Tensor, size: int,
               weights: Optional[torch.Tensor]) -> None:
    if flat.ndim != 2 or flat.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"flat must be (B, N) int32 or int64, got {flat.dtype} "
                        f"{tuple(flat.shape)}")
    if mask.shape != flat.shape or mask.dtype != torch.bool or mask.device != flat.device:
        raise ValueError(f"mask must be a bool {tuple(flat.shape)} tensor on {flat.device}, "
                         f"got {mask.dtype} {tuple(mask.shape)} on {mask.device}")
    if weights is not None and (weights.shape != flat.shape or weights.device != flat.device):
        raise ValueError(f"weights must be {tuple(flat.shape)} on {flat.device}, got "
                         f"{tuple(weights.shape)} on {weights.device}")
    if int(size) < 1:
        raise ValueError(f"size must be positive, got {size}")


def _check_ids_launch(flat: torch.Tensor, size: int) -> Tuple[int, int]:
    if flat.device.type != "cuda":
        raise ValueError(f"no bin-count kernel for device {flat.device}")
    b, n = flat.shape
    if min(b, n) < 1 or b * size >= 2**31 or n >= 2**31:
        raise ValueError(f"unsupported ids shape B={b} N={n} size={size}")
    return b, n


def _ids_int32(flat: torch.Tensor, size: int) -> torch.Tensor:
    """Contiguous int32 ids for the kernels; an int64 id that int32 cannot
    hold is first moved to −1 or ``size``, which count nowhere either."""
    if flat.dtype == torch.int64:
        flat = flat.clamp(-1, size)
    return flat.to(torch.int32).contiguous()


def _flags(weights: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Contiguous bool flags ``weights != 0`` for the kernels (a bool tensor
    as it is), or None."""
    if weights is None:
        return None
    return (weights if weights.dtype == torch.bool else weights != 0).contiguous()


# the flag dtypes K7 reads as they are: (bytes a flag, whether it is a float,
# whose sign bit alone does not make it set)
FLAG_FORMATS = {torch.bool: (1, False), torch.uint8: (1, False), torch.int8: (1, False),
                torch.int16: (2, False), torch.int32: (4, False), torch.int64: (8, False),
                torch.float16: (2, True), torch.bfloat16: (2, True),
                torch.float32: (4, True), torch.float64: (8, True)}


FLOAT_COUNT_MAX_POINTS = 2 ** 24  # f32 adds of 1.0 stay exact up to this count


def bin_counts_route(n: int) -> str:
    """K7's route for N points a sample: ``"float"`` (f32 atomics straight
    into the zeroed outputs: two device operations, one atomic a point and
    one more a flagged point) where no voxel can pass ``2**24`` points,
    else ``"counter"`` (a 64-bit counter a voxel, zeroed, counted and read
    once by a finishing pass: three operations, exact to N < 2**31)."""
    return "float" if n <= FLOAT_COUNT_MAX_POINTS else "counter"


def points_bin_counts_route(n: int) -> str:
    """K6's route for N points a sample, by :func:`bin_counts_route`'s rule:
    ``"float"`` (f32 atomics straight into the outputs the bounds pass
    zeroes: two device operations) where no voxel can pass ``2**24`` points,
    else ``"int32"`` (int32 atomics into the same memory and a pass that
    converts it to f32 in place: three operations, exact to N < 2**31)."""
    return "float" if n <= FLOAT_COUNT_MAX_POINTS else "int32"


def bin_counts_scratch(b: int, size: int, flagged: bool) -> Tuple[torch.dtype, int]:
    """``(dtype, elements)`` of K7's counter route's scratch: one 64-bit
    counter a voxel with flags (the count in its low half, the flagged count
    in its high half: a count below 2**31 never carries into it), one 32-bit
    count without."""
    return (torch.int64 if flagged else torch.int32), b * size


def _flag_operand(weights: Optional[torch.Tensor]
                  ) -> Tuple[Optional[torch.Tensor], int, int]:
    """``(tensor, bytes a flag, is float)`` for K7: the weights as they are
    where ``FLAG_FORMATS`` has their dtype (no pass over them), else the
    bool ``weights != 0``; ``(None, 0, 0)`` without weights."""
    if weights is None:
        return None, 0, 0
    if weights.dtype not in FLAG_FORMATS:
        weights = weights != 0
    width, is_float = FLAG_FORMATS[weights.dtype]
    return weights.contiguous(), width, int(is_float)


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def bounds_plan(b: int, n: int, target: int = BOUNDS_TARGET_BLOCKS) -> Tuple[int, int]:
    """``(chunks, chunk_len)`` of the bounds pass the four raw-points
    kernels share: each sample's N points are cut into ``chunks`` chunks of
    ``chunk_len`` points (a multiple of ``BOUNDS_UNIT``, the last chunk
    ragged, none empty), one block a chunk, so that ``b·chunks`` reaches
    ``target`` blocks where the points allow it: the card is full at B=1 as
    at B=64, and the partial bounds a consumer block reduces stay few. K8's
    partition passes take the same plan with their own target."""
    units = -(-n // BOUNDS_UNIT)
    per_sample = max(1, min(units, -(-target // b)))
    chunk_units = -(-units // per_sample)
    return -(-units // chunk_units), chunk_units * BOUNDS_UNIT


def mark_plan(b: int, chunks: int, chunk_len: int) -> int:
    """Points a block of K1's and K3's mark pass, and of K9's ids pass, takes:
    whole chunks of the bounds plan, up to ``MARK_POINTS`` where that leaves
    the pass at least ``MARK_MIN_BLOCKS`` blocks. A longer chunk lets a
    block's shared-memory filter catch more repeats and amortises its setup
    (zeroing the filter, reducing the bounds partials); at B=1 and at B=64
    the bounds chunk stands as it is."""
    f = max(1, min(MARK_POINTS // chunk_len, b * chunks // MARK_MIN_BLOCKS))
    return f * chunk_len


def sorted_counts_plan(b: int, n: int, size: int) -> Tuple[int, int, int, int, int]:
    """``(shift, parts, chunks, chunk_len, scratch_words)`` of K8.

    A sample's bins are cut into ``parts`` parts of ``2**shift`` bins: one
    ``SLAB_BINS`` slab each (shift 12) up to 256³, wider parts past it, so
    that a sample never has more than ``MAX_PARTS`` (the partition passes
    keep a histogram of them in shared memory; the slab pass then skips the
    points of a part's other slabs). The partition passes cut the points as
    :func:`bounds_plan` does, to ``SORTED_TARGET_BLOCKS`` blocks: fewer and
    longer chunks than the bounds pass, so that a block reserves each part's
    range with one global atomic for many points. Scratch, int32 words: the
    count, fill and start of each part, then a bucket slot a point."""
    shift = SLAB_BINS.bit_length() - 1
    while -(-size >> shift) > MAX_PARTS:
        shift += 1
    parts = -(-size >> shift)
    chunks, chunk_len = bounds_plan(b, n, SORTED_TARGET_BLOCKS)
    return shift, parts, chunks, chunk_len, 3 * b * parts + b * n


def _partials(b: int, chunks: int, dev: torch.device) -> torch.Tensor:
    """Scratch of the bounds pass: (B, chunks, 6) f32 min and max a chunk."""
    return torch.empty((b, chunks, 6), dtype=torch.float32, device=dev)


def bitmap_words(b: int, size: int) -> int:
    """32-bit words of one bitmap of K1 and K3 (a bit a voxel, B samples of
    ``size`` voxels), rounded up to whole 16-byte words, so that K3's tower
    bitmap, right after the occupancy one, starts aligned."""
    return -(-(b * -(-size // 32)) // 4) * 4


def _occupancy_scratch(b: int, size: int, n_y: int, chunks: int, bitmaps: int,
                       dev: torch.device) -> Tuple[torch.Tensor, List[int]]:
    """One int32 scratch of K1 (one bitmap) or K3 (two), zeroed by the kernel
    where it must be. Returns the tensor (the caller holds it until the
    launch is queued) and the addresses of its parts: the bitmaps, the voxels
    set in each y column, the bounds partials."""
    words = bitmap_words(b, size)
    scratch = torch.empty(bitmaps * words + b * n_y + b * chunks * 6, dtype=torch.int32,
                          device=dev)
    offsets = [k * words for k in range(bitmaps)] + [bitmaps * words, bitmaps * words + b * n_y]
    return scratch, [scratch.data_ptr() + 4 * o for o in offsets]


def points_occupancy(points: torch.Tensor, mask: torch.Tensor,
                     grid_shape: Tuple[int, int, int]) -> torch.Tensor:
    """(B, N, 3) f32 points + (B, N) bool mask → (B, n_z·n_x·n_y) f32 {0,1}
    occupancy in (z, x, y) order. ``grid_shape`` is (n_x, n_y, n_z).

    A CPU tensor takes :func:`points_occupancy_plain`; a CUDA tensor
    launches the kernel or raises.
    """
    _check_points(points, mask)
    if points.device.type == "cpu":
        return points_occupancy_plain(points, mask, grid_shape)
    b, n, n_x, n_y, n_z = _check_launch_shape(points, grid_shape)
    size = n_x * n_y * n_z
    points = points.contiguous()
    mask = mask.contiguous()
    dev = points.device
    chunks, chunk_len = bounds_plan(b, n)
    out = torch.empty((b, size), dtype=torch.float32, device=dev)  # every element written
    scratch, parts = _occupancy_scratch(b, size, n_y, chunks, 1, dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.snt_points_occupancy(
            points.data_ptr(), mask.data_ptr(), out.data_ptr(), *parts, b, n, n_x, n_y, n_z,
            chunks, chunk_len, mark_plan(b, chunks, chunk_len),
            ctypes.c_void_p(stream))
    _build.check(err, "points_occupancy")
    LAUNCHES.add()
    return out


def points_binary(points: torch.Tensor, mask: torch.Tensor, tower: torch.Tensor,
                  grid_shape: Tuple[int, int, int]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, N, 3) f32 points + (B, N) bool mask + (B, N) bool tower flags →
    ((B, size) occupancy, (B, size) tower presence), both f32 {0,1} in
    (z, x, y) order. ``grid_shape`` is (n_x, n_y, n_z).

    Occupancy is :func:`points_occupancy`'s; presence is 1 where a valid
    point with its tower flag set lands. A CPU tensor takes
    :func:`points_binary_plain`; a CUDA tensor launches the kernel or raises.
    """
    _check_points(points, mask)
    _check_flag(tower, mask, "tower")
    if points.device.type == "cpu":
        return points_binary_plain(points, mask, tower, grid_shape)
    b, n, n_x, n_y, n_z = _check_launch_shape(points, grid_shape)
    size = n_x * n_y * n_z
    points, mask, tower = points.contiguous(), mask.contiguous(), tower.contiguous()
    dev = points.device
    chunks, chunk_len = bounds_plan(b, n)
    out_x = torch.empty((b, size), dtype=torch.float32, device=dev)  # every element written
    out_y = torch.empty((b, size), dtype=torch.float32, device=dev)
    scratch, parts = _occupancy_scratch(b, size, n_y, chunks, 2, dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.snt_points_binary(
            points.data_ptr(), mask.data_ptr(), tower.data_ptr(), out_x.data_ptr(),
            out_y.data_ptr(), *parts, b, n, n_x, n_y, n_z, chunks, chunk_len,
            mark_plan(b, chunks, chunk_len), ctypes.c_void_p(stream))
    _build.check(err, "points_binary")
    BINARY_LAUNCHES.add()
    return out_x, out_y


def points_bin_counts(points: torch.Tensor, mask: torch.Tensor,
                      tower: Optional[torch.Tensor], grid_shape: Tuple[int, int, int],
                      channels: int = 2) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(B, N, 3) f32 points + (B, N) bool mask [+ (B, N) bool tower flags] →
    ((B, size) f32 counts, (B, size) f32 counts of the flagged points), in
    (z, x, y) order; ``grid_shape`` is (n_x, n_y, n_z). ``channels=1`` skips
    the second grid and returns None for it; ``tower=None`` with two
    channels gives zeros.

    Bounds and ids as in :func:`points_occupancy` (the multiply recipe). For
    a CUDA tensor both grids are one allocation, zeroed by the bounds pass
    and counted by the route :func:`points_bin_counts_route` picks: the
    returned tensors are views of it. Nothing waits for the host, so the
    call can be captured in a CUDA graph. A CPU tensor takes
    :func:`points_bin_counts_plain`; a CUDA tensor launches the kernel or
    raises.
    """
    _check_points(points, mask)
    if channels not in (1, 2):
        raise ValueError(f"channels must be 1 or 2, got {channels}")
    if channels == 1:
        tower = None
    if tower is not None:
        _check_flag(tower, mask, "tower")
    if points.device.type == "cpu":
        return points_bin_counts_plain(points, mask, tower, grid_shape, channels)
    _check_launch_shape(points, grid_shape)
    got = _launch_points_bin_counts(points, mask, tower, grid_shape, channels,
                                    points_bin_counts_route(points.shape[1]))
    BIN_COUNTS_LAUNCHES.add()
    return got


def _launch_points_bin_counts(points: torch.Tensor, mask: torch.Tensor,
                              tower: Optional[torch.Tensor], grid_shape: Tuple[int, int, int],
                              channels: int, route: str
                              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One launch of K6 on checked CUDA tensors, through the route ``route``
    names (:func:`points_bin_counts_route` picks it; the card tests force
    either). The tower grid lies right after the counts in one allocation;
    the count pass takes the bounds pass's chunks (1024 points a block at
    the train batch: longer ones were slower)."""
    b, n, _ = points.shape
    n_x, n_y, n_z = (int(g) for g in grid_shape)
    size = n_x * n_y * n_z
    points, mask = points.contiguous(), mask.contiguous()
    tower = None if tower is None else tower.contiguous()
    dev = points.device
    both = torch.empty((channels, b, size), dtype=torch.float32, device=dev)
    chunks, chunk_len = bounds_plan(b, n)
    partials = _partials(b, chunks, dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.snt_points_bin_counts(
            points.data_ptr(), mask.data_ptr(), _ptr(tower), both[0].data_ptr(),
            None if channels == 1 else both[1].data_ptr(), partials.data_ptr(), b, n, n_x,
            n_y, n_z, chunks, chunk_len, int(route == "int32"), ctypes.c_void_p(stream))
    _build.check(err, "points_bin_counts")
    return both[0], None if channels == 1 else both[1]


def flat_ids(points: torch.Tensor, mask: torch.Tensor,
             grid_shape: Tuple[int, int, int]) -> torch.Tensor:
    """(B, N, 3) f32 points + (B, N) bool mask → (B, N) int32 flat (z, x, y)
    bin ids by the multiply recipe, each sample in its own masked cube
    bounds; a masked point gets :func:`invalid_id` of the grid's size.

    A CPU tensor takes :func:`flat_ids_plain`; a CUDA tensor launches the
    kernel or raises.
    """
    _check_points(points, mask)
    if points.device.type == "cpu":
        return flat_ids_plain(points, mask, grid_shape)
    b, n, n_x, n_y, n_z = _check_launch_shape(points, grid_shape)
    points, mask = points.contiguous(), mask.contiguous()
    dev = points.device
    ids = torch.empty((b, n), dtype=torch.int32, device=dev)
    chunks, chunk_len = bounds_plan(b, n)
    partials = _partials(b, chunks, dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.snt_flat_ids(points.data_ptr(), mask.data_ptr(), ids.data_ptr(),
                               partials.data_ptr(), b, n, n_x, n_y, n_z,
                               invalid_id(n_x * n_y * n_z), chunks, chunk_len,
                               mark_plan(b, chunks, chunk_len), ctypes.c_void_p(stream))
    _build.check(err, "flat_ids")
    FLAT_IDS_LAUNCHES.add()
    return ids


def bin_counts(flat: torch.Tensor, mask: torch.Tensor, size: int,
               weights: Optional[torch.Tensor] = None, indicator: bool = True
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(B, N) int flat bin ids + (B, N) bool mask [+ (B, N) weights] →
    ((B, size) f32 counts, (B, size) f32 weighted counts or None).

    A point counts where its mask is set and its id lies in ``[0, size)``;
    any other counts nowhere (a padded point's id 0 never reaches bin 0).
    ``indicator=True``: the weights are {0, 1} flags (any dtype; nonzero
    means set) and the second grid counts the flagged points, exactly (f32
    atomics of 1.0 up to 2**24 points a sample, 64-bit counters past it).
    ``indicator=False``: float weights, each rounded to
    bf16 and summed in f32 with float atomics, whose order changes from run
    to run: those sums are not bit-reproducible (the counts are).

    For a CUDA tensor the indicator form reads the ids (int32 or int64) and
    the flags (a dtype of ``FLAG_FORMATS``) as they are and counts by the
    route :func:`bin_counts_route` picks: two or three device operations,
    none waiting for the host, so the call can be captured in a CUDA graph.
    A CPU tensor takes :func:`bin_counts_plain`; a CUDA tensor launches the
    kernel or raises.
    """
    _check_ids(flat, mask, size, weights)
    if flat.device.type == "cpu":
        return bin_counts_plain(flat, mask, size, weights, indicator)
    b, n = _check_ids_launch(flat, size)
    if weights is None or indicator:
        counts, second = _launch_bin_counts(flat, mask, size, weights, bin_counts_route(n))
        FLAT_COUNTS_LAUNCHES.add()
        return counts, second
    dev = flat.device
    mask = mask.contiguous()
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        flat = _ids_int32(flat, size)
        counts = torch.zeros((b, size), dtype=torch.int32, device=dev)
        w = weights.to(torch.float32).contiguous()
        second = torch.zeros((b, size), dtype=torch.float32, device=dev)
        err = lib.snt_bin_counts_weighted(flat.data_ptr(), mask.data_ptr(), w.data_ptr(),
                                          counts.data_ptr(), second.data_ptr(), b, n, size,
                                          stream)
    _build.check(err, "bin_counts")
    FLAT_COUNTS_LAUNCHES.add()
    return counts.view(torch.float32), second


def _launch_bin_counts(flat: torch.Tensor, mask: torch.Tensor, size: int,
                       weights: Optional[torch.Tensor], route: str
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One launch of K7's indicator form on checked CUDA tensors, through
    the route ``route`` names (:func:`bin_counts_route` picks it; the card
    tests force either). The two outputs are one allocation, the flagged
    grid right after the counts, so that the float route zeroes both with
    one memset."""
    b, n = flat.shape
    dev = flat.device
    flat, mask = flat.contiguous(), mask.contiguous()
    flag, width, is_float = _flag_operand(weights)
    both = torch.empty((1 if flag is None else 2, b, size), dtype=torch.float32, device=dev)
    scratch = None
    if route == "counter":
        dtype, cells = bin_counts_scratch(b, size, flag is not None)
        scratch = torch.empty(cells, dtype=dtype, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        err = lib.snt_bin_counts(flat.data_ptr(), flat.element_size(), mask.data_ptr(),
                                 _ptr(flag), width, is_float, _ptr(scratch),
                                 both[0].data_ptr(), None if flag is None else both[1].data_ptr(),
                                 b, n, size, stream)
    _build.check(err, "bin_counts")
    return both[0], None if flag is None else both[1]


def sorted_bin_counts(flat: torch.Tensor, mask: torch.Tensor,
                      weights: Optional[torch.Tensor], size: int, channels: int = 2
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(B, N) int flat bin ids + (B, N) bool mask [+ (B, N) {0, 1} weights]
    → ((B, size) f32 counts, (B, size) f32 counts of the points whose
    weight is nonzero), for large grids. ``channels=1`` returns None for the
    second grid; ``weights=None`` with two channels gives zeros. Which
    points count is :func:`bin_counts`'s rule.

    For a CUDA tensor no sort is made: the kernels partition the points by
    slabs of ``SLAB_BINS`` bins (a count pass, then a scatter of one
    ``id | flag << 31`` word a point into its slab's bucket) and count each
    slab from its bucket in shared memory, writing every output element
    once, so nothing is zeroed here (:func:`sorted_counts_plan`). Nothing
    waits for the device: the call can be captured in a CUDA graph.
    A CPU tensor takes :func:`sorted_bin_counts_plain`; a CUDA tensor
    launches the kernel or raises.
    """
    _check_ids(flat, mask, size, weights)
    if channels not in (1, 2):
        raise ValueError(f"channels must be 1 or 2, got {channels}")
    if channels == 1:
        weights = None
    if flat.device.type == "cpu":
        return sorted_bin_counts_plain(flat, mask, weights, size, channels)
    b, n = _check_ids_launch(flat, size)
    dev = flat.device
    flat = _ids_int32(flat, size)
    mask = mask.contiguous()
    flag = _flags(weights)
    shift, _, chunks, chunk_len, words = sorted_counts_plan(b, n, size)
    scratch = torch.empty(words, dtype=torch.int32, device=dev)
    counts = torch.empty((b, size), dtype=torch.float32, device=dev)
    second = torch.empty((b, size), dtype=torch.float32, device=dev) if channels == 2 else None
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        err = lib.snt_sorted_bin_counts(flat.data_ptr(), mask.data_ptr(), _ptr(flag),
                                        counts.data_ptr(), _ptr(second), scratch.data_ptr(),
                                        b, n, size, shift, chunks, chunk_len, stream)
    _build.check(err, "sorted_bin_counts")
    SORTED_COUNTS_LAUNCHES.add()
    return counts, second
