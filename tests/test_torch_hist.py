"""Port parity: the histogram family's plain versions vs the TPU kernels.

On the CPU each wrapper of ``scenenet_tpu_torch.ops.cuda_hist`` runs its
kernel's plain version. Each is held **exactly** (integer counts and ids)
against its Pallas function in interpret mode, at the small shapes
``tests/test_pallas_hist.py`` uses, with one and two channels and with an N
that is no multiple of the chunk; at large grids, where interpret mode is
too slow, against ``np.bincount``. The float-weight form of ``bin_counts``
sums bf16-rounded weights in f32 in another order than the kernel: rtol
1e-5, atol 1e-5.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from scenenet_tpu.ops import voxelize as jv
from scenenet_tpu.ops.pallas_hist import (
    pallas_bin_counts, pallas_flat_ids, pallas_points_bin_counts, pallas_sorted_bin_counts,
)
from scenenet_tpu_torch.ops import cuda_hist
from scenenet_tpu_torch.ops import voxelize as tv


def _points(seed, b=3, n=9000, rounded=False):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 30, (b, n, 3)).astype(np.float32)
    if rounded:  # a 1 cm lattice: points land on voxel edges
        pts = np.round(pts, 2).astype(np.float32)
    mask = np.arange(n)[None, :] < np.array([n, n * 7 // 9, n // 2])[:b, None]
    tower = (rng.random((b, n)) < 0.05) & mask
    return pts, mask, tower


def _ids(seed, b, n, size, spread=None):
    """Flat ids with heavy duplication, a ragged random mask and flags."""
    rng = np.random.default_rng(seed)
    flat = rng.integers(0, spread or size, (b, n)).astype(np.int32)
    mask = rng.random((b, n)) > 0.15
    w = (rng.random((b, n)) > 0.6).astype(np.int32)
    return flat, mask, w


def _brute(flat, keep, size):
    out = np.zeros((flat.shape[0], size), np.float32)
    for i in range(flat.shape[0]):
        out[i] = np.bincount(flat[i][keep[i]], minlength=size)
    return out


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


# ---- K6 points_bin_counts ------------------------------------------------------

@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("grid,rounded,chunk", [((16, 16, 16), False, None),
                                                ((32, 32, 32), True, 2048),
                                                ((64, 64, 64), True, None)])
def test_points_bin_counts_plain_equals_pallas_kernel(grid, rounded, chunk, channels):
    """N = 9000 is no multiple of the chunk (4096 by default)."""
    pts, mask, tower = _points(1, rounded=rounded)
    want = pallas_points_bin_counts(jnp.asarray(pts), jnp.asarray(mask),
                                    jnp.asarray(tower) if channels == 2 else None, grid,
                                    interpret=True, chunk=chunk, channels=channels)
    tp, tm, tt = _t(pts, mask, tower)
    got = cuda_hist.points_bin_counts(tp, tm, tt if channels == 2 else None, grid,
                                      channels=channels)
    assert got[0].dtype == torch.float32 and got[0].shape == (3, grid[0] * grid[1] * grid[2])
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert float(got[0].sum()) == mask.sum()
    if channels == 1:
        assert got[1] is None and want[1] is None
    else:
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        assert float(got[1].sum()) == tower.sum() > 0


def test_points_bin_counts_binarized_is_points_binary():
    """The counts, binarized by the column-min rule and ``> 0``, are the
    two-channel binary kernel's grids; tower=None gives a zero grid."""
    grid = (12, 10, 14)
    pts, mask, tower = _points(2, rounded=True)
    tp, tm, tt = _t(pts, mask, tower)
    counts, towers = cuda_hist.points_bin_counts(tp, tm, tt, grid)
    occ, pres = cuda_hist.points_binary(tp, tm, tt, grid)
    cols = counts.reshape(3, -1, grid[1])
    want = (cols > cols.amin(dim=1, keepdim=True)).float().reshape(3, -1)
    assert torch.equal(want, occ) and torch.equal((towers > 0).float(), pres)
    none = cuda_hist.points_bin_counts(tp, tm, None, grid)
    assert torch.equal(none[0], counts) and float(none[1].abs().sum()) == 0


# ---- K7 bin_counts -------------------------------------------------------------

@pytest.mark.parametrize("with_weights", [False, True])
@pytest.mark.parametrize("size,n,chunk", [(64 * 64 * 64, 6000, 1024), (12 * 10 * 14, 3000, 1024),
                                          (32 * 32 * 32, 5000, 4096)])
def test_bin_counts_plain_equals_pallas_kernel(size, n, chunk, with_weights):
    """Indicator form, one and two channels; ids in the padding past
    ``size``, past the last row of 512, and negative count nowhere in
    either package."""
    flat, mask, w = _ids(size, 2, n, size)
    flat[0, :5] = [size, size + 1, -(-size // 512) * 512 - 1, 10 ** 6, -3]
    want = pallas_bin_counts(jnp.asarray(flat), jnp.asarray(mask), size,
                             jnp.asarray(w) if with_weights else None,
                             interpret=True, chunk=chunk)
    tf, tm, tw = _t(flat, mask, w)
    got = cuda_hist.bin_counts(tf, tm, size, tw if with_weights else None)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    keep = mask & (flat >= 0) & (flat < size)
    np.testing.assert_array_equal(got[0].numpy(), _brute(flat, keep, size))
    if with_weights:
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(got[1].numpy(), _brute(flat, keep & (w != 0), size))
    else:
        assert got[1] is None and want[1] is None
    # int64 ids are taken too
    again = cuda_hist.bin_counts(tf.long(), tm, size, tw if with_weights else None)
    assert torch.equal(again[0], got[0])


def test_bin_counts_float_weights_match_pallas_kernel():
    """``indicator=False``: weights rounded to bf16, summed in f32. The
    order of the f32 sums differs: rtol 1e-5, atol 1e-5. The counts stay
    exact."""
    size, n = 16 * 16 * 16, 5000
    flat, mask, _ = _ids(3, 2, n, size, spread=size // 20)
    w = np.random.default_rng(4).normal(1.0, 0.5, (2, n)).astype(np.float32)
    want = pallas_bin_counts(jnp.asarray(flat), jnp.asarray(mask), size, jnp.asarray(w),
                             interpret=True, int8=False, chunk=1024)
    got = cuda_hist.bin_counts(*_t(flat, mask), size, torch.from_numpy(w), indicator=False)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-5, atol=1e-5)
    # and it is the bf16 rounding that is summed, not the f32 weight
    exact = np.zeros((2, size))
    for i in range(2):
        np.add.at(exact[i], flat[i][mask[i]], w[i][mask[i]].astype(np.float64))
    assert np.abs(got[1].numpy() - exact).max() > 1e-3


def test_bin_counts_ignores_out_of_range_and_masked_zero_ids():
    """A padded point carries flat_idx 0 with mask False: it must not reach
    bin 0. Ids outside [0, size) count nowhere."""
    size = 100
    flat = np.array([[0, 0, 0, 5, 5, 99, 100, 101, -1, 7, 0, 0]], np.int32)
    mask = np.array([[1, 0, 0, 1, 1, 1, 1, 1, 1, 0, 0, 0]], bool)
    w = np.ones_like(flat)
    for fn in (lambda: cuda_hist.bin_counts(*_t(flat, mask), size, torch.from_numpy(w)),
               lambda: cuda_hist.sorted_bin_counts(*_t(flat, mask, w), size)):
        counts, flagged = fn()
        want = np.zeros(size, np.float32)
        want[[0, 5, 99]] = [1, 2, 1]
        np.testing.assert_array_equal(counts[0].numpy(), want)
        np.testing.assert_array_equal(flagged[0].numpy(), want)
    all_masked = cuda_hist.bin_counts(*_t(flat, np.zeros_like(mask)), size)
    assert float(all_masked[0].sum()) == 0


# ---- K8 sorted_bin_counts ------------------------------------------------------

@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("size,n,n_slabs,chunk", [(128 * 128 * 16, 3000, 4, 512),
                                                  (128 * 128 * 16, 3000, 16, 512),
                                                  (96 * 64 * 16, 1537, 6, 512),
                                                  (64 * 64 * 40, 2500, None, 512)])
def test_sorted_bin_counts_plain_equals_pallas_kernel(size, n, n_slabs, chunk, channels):
    flat, mask, w = _ids(n, 2, n, size, spread=size // 50)
    flat = (flat * 37 % size).astype(np.int32)
    mask[1, n // 2:] = False
    want = pallas_sorted_bin_counts(jnp.asarray(flat), jnp.asarray(mask),
                                    jnp.asarray(w) if channels == 2 else None, size,
                                    n_slabs=n_slabs, chunk=chunk, interpret=True,
                                    channels=channels)
    tf, tm, tw = _t(flat, mask, w)
    got = cuda_hist.sorted_bin_counts(tf, tm, tw if channels == 2 else None, size,
                                      channels=channels)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    if channels == 2:
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        k7 = cuda_hist.bin_counts(tf, tm, size, tw)  # the two id kernels agree
        assert torch.equal(k7[0], got[0]) and torch.equal(k7[1], got[1])
    else:
        assert got[1] is None and want[1] is None


def test_sorted_bin_counts_edge_cases_equal_pallas_kernel():
    """Every point in one bin; an all-masked sample; weights None with two
    channels (a zero second grid in both packages)."""
    size = 128 * 128 * 16
    flat = np.full((1, 600), 7, np.int32)
    ones = np.ones((1, 600), bool)
    for mask, w in ((ones, np.ones((1, 600), np.int32)), (~ones, None), (ones, None)):
        want = pallas_sorted_bin_counts(jnp.asarray(flat), jnp.asarray(mask),
                                        None if w is None else jnp.asarray(w), size,
                                        n_slabs=16, chunk=256, interpret=True)
        got = cuda_hist.sorted_bin_counts(*_t(flat, mask), None if w is None
                                          else torch.from_numpy(w), size)
        for g, wnt in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))
    assert float(got[0][0, 7]) == 600 and float(got[1].sum()) == 0


@pytest.mark.parametrize("grid,b,n", [((128, 128, 128), 2, 20000), ((64, 64, 256), 2, 20000),
                                      ((256, 256, 256), 1, 20000)])
def test_sorted_bin_counts_plain_large_grids_equal_bincount(grid, b, n):
    """Interpret mode is too slow at these sizes: hold the plain version
    against np.bincount, exactly."""
    size = grid[0] * grid[1] * grid[2]
    rng = np.random.default_rng(size % 1000)
    flat = rng.integers(0, size, (b, n)).astype(np.int32)
    flat[:, : n // 4] = flat[:, n // 4: n // 2]  # duplicates
    flat[0, -3:] = [0, size - 1, size - 1]
    mask = rng.random((b, n)) > 0.1
    mask[0, -3:] = True
    w = rng.random((b, n)) > 0.7
    counts, flagged = cuda_hist.sorted_bin_counts(*_t(flat, mask, w), size)
    np.testing.assert_array_equal(counts.numpy(), _brute(flat, mask, size))
    np.testing.assert_array_equal(flagged.numpy(), _brute(flat, mask & w, size))
    assert float(counts[0, size - 1]) >= 2


# ---- K9 flat_ids ---------------------------------------------------------------

@pytest.mark.parametrize("rounded", [False, True])
@pytest.mark.parametrize("grid", [(64, 64, 64), (64, 64, 256), (128, 128, 128), (12, 10, 14)])
def test_flat_ids_plain_equals_pallas_kernel(grid, rounded):
    """Exact, masked points included (the sentinel ``ceil(size/512)·512``);
    N = 4000 is no multiple of the chunk."""
    rng = np.random.default_rng(5)
    pts = rng.uniform(0, 30, (3, 4000, 3)).astype(np.float32)
    if rounded:
        pts = np.round(pts, 2).astype(np.float32)
    mask = rng.random((3, 4000)) > 0.1
    want = np.asarray(pallas_flat_ids(jnp.asarray(pts), jnp.asarray(mask), grid,
                                      interpret=True, chunk=512))
    got = cuda_hist.flat_ids(*_t(pts, mask), grid)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    size = grid[0] * grid[1] * grid[2]
    assert (got.numpy()[~mask] == cuda_hist.invalid_id(size)).all()
    assert cuda_hist.invalid_id(size) == -(-size // 512) * 512 >= size


def test_flat_ids_equal_divide_recipe_where_the_recipes_agree():
    """The ids kernel multiplies; ``batch_flat_ids`` divides. On uniform
    random coordinates the two agree (asserted against the JAX package's
    ids), and then the counts from these ids are the raw-points kernel's."""
    grid = (16, 16, 16)
    pts, mask, tower = _points(6)
    tp, tm, tt = _t(pts, mask, tower)
    ids = cuda_hist.flat_ids(tp, tm, grid)
    want = np.asarray(jv.batch_flat_ids(jnp.asarray(pts), jnp.asarray(mask), grid))
    np.testing.assert_array_equal(ids.numpy()[mask], want[mask])
    assert torch.equal(ids.long()[tm], tv.batch_flat_ids(tp, tm, grid)[tm])
    from_ids = cuda_hist.bin_counts(ids, tm, 16 ** 3, tt)
    from_points = cuda_hist.points_bin_counts(tp, tm, tt, grid)
    assert torch.equal(from_ids[0], from_points[0]) and torch.equal(from_ids[1], from_points[1])


# ---- the wrappers ----------------------------------------------------------------

def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    grid = (8, 8, 8)
    pts, mask, tower = _points(7, b=2, n=500)
    tp, tm, tt = _t(pts, mask, tower)
    flat = tv.batch_flat_ids(tp, tm, grid)
    counters = (cuda_hist.BIN_COUNTS_LAUNCHES, cuda_hist.FLAT_COUNTS_LAUNCHES,
                cuda_hist.SORTED_COUNTS_LAUNCHES, cuda_hist.FLAT_IDS_LAUNCHES)
    before = [c.count for c in counters]
    pairs = [
        (cuda_hist.points_bin_counts(tp, tm, tt, grid),
         cuda_hist.points_bin_counts_plain(tp, tm, tt, grid)),
        (cuda_hist.bin_counts(flat, tm, 512, tt), cuda_hist.bin_counts_plain(flat, tm, 512, tt)),
        (cuda_hist.sorted_bin_counts(flat, tm, tt, 512),
         cuda_hist.sorted_bin_counts_plain(flat, tm, tt, 512)),
        ((cuda_hist.flat_ids(tp, tm, grid),), (cuda_hist.flat_ids_plain(tp, tm, grid),)),
    ]
    for got, want in pairs:
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert [c.count for c in counters] == before
    assert [c.name for c in counters] == ["points_bin_counts", "bin_counts",
                                          "sorted_bin_counts", "flat_ids"]


@pytest.mark.parametrize("case", ["flat_float", "flat_1d", "mask_shape", "mask_dtype",
                                  "weights_shape", "size", "channels", "tower_dtype",
                                  "points_shape", "counts_channels"])
def test_wrappers_reject_bad_inputs(case):
    flat = torch.zeros((1, 10), dtype=torch.int32)
    mask = torch.ones((1, 10), dtype=torch.bool)
    pts = torch.zeros((1, 10, 3))
    calls = {
        "flat_float": (TypeError, lambda: cuda_hist.bin_counts(flat.float(), mask, 8)),
        "flat_1d": (TypeError, lambda: cuda_hist.sorted_bin_counts(flat[0], mask[0], None, 8)),
        "mask_shape": (ValueError, lambda: cuda_hist.bin_counts(flat, mask[:, :9], 8)),
        "mask_dtype": (ValueError, lambda: cuda_hist.bin_counts(flat, mask.int(), 8)),
        "weights_shape": (ValueError, lambda: cuda_hist.bin_counts(flat, mask, 8, flat[:, :3])),
        "size": (ValueError, lambda: cuda_hist.bin_counts(flat, mask, 0)),
        "channels": (ValueError, lambda: cuda_hist.sorted_bin_counts(flat, mask, None, 8,
                                                                     channels=3)),
        "tower_dtype": (ValueError, lambda: cuda_hist.points_bin_counts(pts, mask, mask.int(),
                                                                        (8, 8, 8))),
        "points_shape": (ValueError, lambda: cuda_hist.flat_ids(pts[0], mask[0], (8, 8, 8))),
        "counts_channels": (ValueError, lambda: cuda_hist.points_bin_counts(pts, mask, None,
                                                                           (8, 8, 8), channels=0)),
    }
    error, call = calls[case]
    with pytest.raises(error):
        call()


def test_int64_ids_past_int32_count_nowhere():
    """An int64 id that wraps into range as int32 (2³² + 5) must not count."""
    flat = torch.tensor([[5, 2 ** 32 + 5, -(2 ** 32) + 5, 7]], dtype=torch.int64)
    mask = torch.ones((1, 4), dtype=torch.bool)
    for counts in (cuda_hist.bin_counts(flat, mask, 16)[0],
                   cuda_hist.sorted_bin_counts(flat, mask, None, 16, channels=1)[0]):
        assert counts[0].tolist() == [0.0] * 5 + [1.0, 0.0, 1.0] + [0.0] * 8
    ids = cuda_hist._ids_int32(flat, 16)
    assert ids.dtype == torch.int32 and ids.tolist() == [[5, 16, -1, 7]]


# ---- K7's route, scratch and flag rule, on the CPU --------------------------------

@pytest.mark.parametrize("n,want", [(65536, "float"), (131072, "float"), (1, "float"),
                                    (2 ** 24, "float"), (2 ** 24 + 1, "counter"),
                                    (2 ** 31 - 1, "counter")])
def test_bin_counts_route(n, want):
    """f32 atomics of 1.0 where no voxel can pass 2**24 points, the 64-bit
    counters past it."""
    assert cuda_hist.bin_counts_route(n) == want


@pytest.mark.parametrize("b,size,flagged,want", [
    (16, 64 ** 3, True, (torch.int64, 16 * 64 ** 3)),  # 33.5 MB: one counter a voxel
    (16, 64 ** 3, False, (torch.int32, 16 * 64 ** 3)),
    (4, 128 ** 3, True, (torch.int64, 4 * 128 ** 3)),
    (3, 12 * 10 * 14, False, (torch.int32, 3 * 12 * 10 * 14)),
])
def test_bin_counts_scratch(b, size, flagged, want):
    assert cuda_hist.bin_counts_scratch(b, size, flagged) == want


@pytest.mark.parametrize("dtype", list(cuda_hist.FLAG_FORMATS))
def test_flag_formats_bit_rule_is_nonzero(dtype):
    """K7 reads a flag's raw bits: set where they are nonzero, for a float
    where they are nonzero outside the sign bit. On these values (-0.0, NaN,
    infinities, subnormals, ±1) that rule is ``weights != 0``."""
    width, is_float = cuda_hist.FLAG_FORMATS[dtype]
    vals = [0.0, -0.0, 1.0, -1.0, 3.0, float("nan"), float("inf"), float("-inf"), 1e-40,
            -1e-40, 6e-8, 2.0 ** -140]
    w = torch.tensor(vals, dtype=torch.float64).nan_to_num(
        nan=0.0 if not dtype.is_floating_point else float("nan"), posinf=7.0, neginf=-7.0)
    w = w.to(dtype)
    assert w.element_size() == width
    bits = w.view({1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[width])
    bits = bits.to(torch.int64) & ((1 << (8 * width)) - 1 if width < 8 else -1)
    if is_float:
        bits = bits & ((1 << (8 * width - 1)) - 1)
    assert torch.equal(bits != 0, w != 0)


# ---- the bounds pass's chunk plan (the four raw-points kernels), on the CPU --------

@pytest.mark.parametrize("b,n", [(1, 131072), (64, 131072), (16, 65536), (8, 131072),
                                 (4, 131072), (3, 9000), (1, 1), (4, 1025), (2, 2048),
                                 (1, 131071), (65535, 7), (1, 2**31 - 1)])
def test_bounds_plan_covers_every_point_and_fills_the_card(b, n):
    """Every point in exactly one chunk of whole units, no chunk empty; the
    blocks reach at least half the target where the points allow it, and
    never pass it by a sample's worth (the partials a consumer block reduces
    stay few); the same arguments give the same plan."""
    chunks, chunk_len = cuda_hist.bounds_plan(b, n)
    assert (chunks, chunk_len) == cuda_hist.bounds_plan(b, n)
    assert chunk_len % cuda_hist.BOUNDS_UNIT == 0 and chunk_len > 0
    assert (chunks - 1) * chunk_len < n <= chunks * chunk_len
    units = -(-n // cuda_hist.BOUNDS_UNIT)
    assert 2 * b * chunks >= min(cuda_hist.BOUNDS_TARGET_BLOCKS, b * units)
    assert b * chunks < cuda_hist.BOUNDS_TARGET_BLOCKS + b
    assert chunks <= 65535


@pytest.mark.parametrize("b,n,want", [
    (1, 131072, (128, 1024)),   # a served request: one unit a block, 128 blocks
    (64, 131072, (16, 8192)),   # the batch-64 pipeline: 1024 blocks of 8 units
    (16, 65536, (64, 1024)),    # the train batch: 1024 blocks of one unit
    (1, 100, (1, 1024)),
])
def test_bounds_plan_at_the_main_paths_shapes(b, n, want):
    assert cuda_hist.bounds_plan(b, n) == want


@pytest.mark.parametrize("b,n", [(4, 131072), (1, 131072), (16, 65536), (1, 300000)])
def test_bounds_plan_takes_a_target(b, n):
    """K8's partition passes: the same rules at their own target of blocks."""
    chunks, chunk_len = cuda_hist.bounds_plan(b, n, cuda_hist.SORTED_TARGET_BLOCKS)
    assert chunk_len % cuda_hist.BOUNDS_UNIT == 0
    assert (chunks - 1) * chunk_len < n <= chunks * chunk_len
    units = -(-n // cuda_hist.BOUNDS_UNIT)
    assert 2 * b * chunks >= min(cuda_hist.SORTED_TARGET_BLOCKS, b * units)
    assert b * chunks < cuda_hist.SORTED_TARGET_BLOCKS + b
    assert cuda_hist.bounds_plan(b, n) == cuda_hist.bounds_plan(
        b, n, cuda_hist.BOUNDS_TARGET_BLOCKS)


# ---- K8's slab partition plan and K3's bitmaps, on the CPU -------------------------

@pytest.mark.parametrize("b,n,size", [(4, 131072, 128 ** 3), (1, 131072, 256 ** 3),
                                      (4, 32768, 64 * 64 * 256), (16, 65536, 64 ** 3),
                                      (3, 9000, 512), (2, 1000, 4097), (1, 7, 1),
                                      (2, 20000, 2 ** 25 + 5), (1, 20000, 2 ** 31 - 1),
                                      (1, 4 * 1024 * 1024, 256 ** 3)])
def test_sorted_counts_plan_covers_every_bin_and_point(b, n, size):
    """Parts of 2**shift bins, whole slabs each, cover the grid with at most
    MAX_PARTS a sample; the chunks cover the points; the scratch holds three
    ints a part and one word a point."""
    shift, parts, chunks, chunk_len, words = cuda_hist.sorted_counts_plan(b, n, size)
    assert shift >= 12 and (1 << shift) % cuda_hist.SLAB_BINS == 0
    assert (parts - 1) << shift < size <= parts << shift
    assert parts <= cuda_hist.MAX_PARTS
    assert shift == 12 or -(-size >> (shift - 1)) > cuda_hist.MAX_PARTS  # the narrowest
    assert (chunks, chunk_len) == cuda_hist.bounds_plan(b, n, cuda_hist.SORTED_TARGET_BLOCKS)
    assert words == 3 * b * parts + b * n


@pytest.mark.parametrize("b,n,size,want", [
    (4, 131072, 128 ** 3, (12, 512, 64, 2048)),   # the 128³ route: 512 slabs, 256 blocks
    (1, 131072, 256 ** 3, (12, 4096, 128, 1024)),  # 256³: 4096 slabs, one part each
    (1, 20000, 2 ** 25 + 5, (14, 2049, 20, 1024)),  # past 256³: four slabs a part
])
def test_sorted_counts_plan_at_the_main_paths_shapes(b, n, size, want):
    assert cuda_hist.sorted_counts_plan(b, n, size)[:4] == want


@pytest.mark.parametrize("b,size,want", [(16, 64 ** 3, 16 * 8192), (1, 512, 16),
                                         (3, 12 * 10 * 14, 160), (1, 33, 4), (64, 64 ** 3, 524288)])
def test_bitmap_words_are_whole_16_byte_words(b, size, want):
    """K3's tower bitmap starts right after the occupancy one: a bit a voxel
    of every sample, rounded up to whole 16-byte words."""
    words = cuda_hist.bitmap_words(b, size)
    assert words == want and words % 4 == 0 and 32 * words >= b * size


@pytest.mark.parametrize("b,n,want", [
    (1, 131072, 1024),   # a served request: the bounds chunk, 128 blocks
    (64, 131072, 8192),  # the batch-64 pipeline: the bounds chunk already long
    (16, 65536, 3072),   # the train batch: three bounds chunks a block, 352 blocks
    (1, 65536, 1024), (4, 131072, 1024), (3, 9000, 1024), (1, 100, 1024),
])
def test_mark_plan_takes_whole_bounds_chunks(b, n, want):
    """The mark pass of K1 and K3 takes whole chunks of the bounds plan, at
    most MARK_POINTS points, and never fewer than MARK_MIN_BLOCKS blocks
    where the bounds pass had more."""
    chunks, chunk_len = cuda_hist.bounds_plan(b, n)
    mark_len = cuda_hist.mark_plan(b, chunks, chunk_len)
    assert mark_len == want and mark_len % chunk_len == 0
    assert mark_len <= max(chunk_len, cuda_hist.MARK_POINTS)
    blocks = b * -(-n // mark_len)
    assert blocks >= min(b * chunks, cuda_hist.MARK_MIN_BLOCKS)


# ---- K6's and K9's second pass: its chunk plan and K6's route, on the CPU ----------

@pytest.mark.parametrize("kernel", ["K6 count", "K9 ids"])
@pytest.mark.parametrize("b", [1, 16, 64])
@pytest.mark.parametrize("n", [777, 9001, 65536 - 3, 131072 + 5])  # no multiple of 1024
def test_points_second_pass_takes_whole_bounds_chunks(kernel, b, n):
    """K6's count pass takes the bounds plan's chunks as they are; K9's ids
    pass whole runs of them by mark_plan (at most MARK_POINTS points, or the
    one bounds chunk, and no fewer than MARK_MIN_BLOCKS blocks where the
    bounds pass had more). Either covers every point with no empty block,
    and its chunks start on a 1024-point unit (four points a thread)."""
    chunks, chunk_len = cuda_hist.bounds_plan(b, n)
    pass_len = chunk_len if kernel == "K6 count" else cuda_hist.mark_plan(b, chunks, chunk_len)
    assert pass_len % chunk_len == 0 and pass_len % cuda_hist.BOUNDS_UNIT == 0
    assert pass_len <= max(chunk_len, cuda_hist.MARK_POINTS)
    pass_chunks = -(-n // pass_len)
    assert (pass_chunks - 1) * pass_len < n <= pass_chunks * pass_len
    assert b * pass_chunks >= min(b * chunks, cuda_hist.MARK_MIN_BLOCKS)
    assert pass_chunks <= chunks <= 65535  # the grid's x dimension


@pytest.mark.parametrize("b", [1, 16, 64])
@pytest.mark.parametrize("n,want", [(777, "float"), (65536 - 3, "float"), (131072 + 5, "float"),
                                    (2 ** 24, "float"), (2 ** 24 + 1, "int32"),
                                    (2 ** 31 - 1, "int32")])
def test_points_bin_counts_route(b, n, want):
    """K6 counts by f32 atomics where no voxel can pass 2**24 points, by
    int32 atomics and a convert pass past it: K7's rule, by the points a
    sample (N) alone, whatever the batch B. Where the float route is taken
    every count a voxel can reach is an f32 integer; past it the int32
    counts hold any N the wrappers take."""
    route = cuda_hist.points_bin_counts_route(n)
    assert route == want
    if n <= 2 ** 24 < b * n:  # a batch past 2**24 points in all: each sample's voxels are its own
        assert route == "float"
    assert (route == "float") == (cuda_hist.bin_counts_route(n) == "float")
    if route == "float":
        assert float(np.float32(n)) == n and float(np.float32(n - 1)) == n - 1
    else:
        assert n < 2 ** 31
