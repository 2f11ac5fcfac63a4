"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip where torch finds no CUDA device. On a machine
with a card (no jax needed there):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from scenenet_tpu_torch.ops import cuda_conv, cuda_conv_mc, cuda_hist
from scenenet_tpu_torch.ops.conv3d import conv3d_same

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _cloud(seed, b, n, cm=True):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 30, (b, n, 3)).astype(np.float32)
    if cm:  # 1 cm lattice: points land on voxel edges
        pts = np.round(pts, 2).astype(np.float32)
    mask = np.arange(n)[None, :] < rng.integers(n // 2, n + 1, (b, 1))
    return pts, mask


@pytest.mark.parametrize("grid", [(16, 16, 16), (64, 64, 64), (12, 10, 14), (48, 40, 56)])
def test_occupancy_kernel_exact(dev, grid):
    pts, mask = _cloud(1, 3, 9000)
    pt, mt = torch.from_numpy(pts).to(dev), torch.from_numpy(mask).to(dev)
    got = cuda_hist.points_occupancy(pt, mt, grid)
    want = cuda_hist.points_occupancy_plain(pt, mt, grid)
    cpu = cuda_hist.points_occupancy_plain(torch.from_numpy(pts), torch.from_numpy(mask), grid)
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), cpu)


def test_occupancy_kernel_counts_launches(dev):
    pts, mask = _cloud(2, 1, 100)
    before = cuda_hist.LAUNCHES.count
    cuda_hist.points_occupancy(torch.from_numpy(pts).to(dev),
                               torch.from_numpy(mask).to(dev), (8, 8, 8))
    assert cuda_hist.LAUNCHES.count == before + 1


def _tower_flags(mask, rule):
    """Tower flags for K3: "random" (a tenth of all points, masked ones
    too: the kernel must gate a flag by its mask), "all" (every point) or
    "masked" (only the masked points: no tower voxel at all)."""
    if rule == "all":
        return np.ones(mask.shape, bool)
    if rule == "masked":
        return ~mask
    return np.random.default_rng(4).random(mask.shape) < 0.1


def _points_family_exact(dev, pts, mask, grid, flags="random"):
    """K1 against its plain version and twice for the same bits; K3, K6 and
    K9, which share its bounds pass, against theirs on the same points (K3
    twice, its occupancy equal to K1's, its presence to the valid flagged
    points' counts)."""
    pt, mt = torch.from_numpy(pts).to(dev), torch.from_numpy(mask).to(dev)
    raw = torch.from_numpy(_tower_flags(mask, flags)).to(dev)
    tower = mt & raw
    before = cuda_hist.LAUNCHES.count
    got = cuda_hist.points_occupancy(pt, mt, grid)
    assert cuda_hist.LAUNCHES.count == before + 1
    assert torch.equal(got, cuda_hist.points_occupancy_plain(pt, mt, grid))
    assert torch.equal(got, cuda_hist.points_occupancy(pt, mt, grid))
    before = cuda_hist.BINARY_LAUNCHES.count
    binary = cuda_hist.points_binary(pt, mt, raw, grid)
    assert cuda_hist.BINARY_LAUNCHES.count == before + 1
    for a, b, c in zip(binary, cuda_hist.points_binary_plain(pt, mt, tower, grid),
                       cuda_hist.points_binary(pt, mt, raw, grid)):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert torch.equal(binary[0], got)
    flagged = cuda_hist.points_bin_counts_plain(pt, mt, tower, grid)[1]
    assert torch.equal(binary[1], (flagged > 0).float())
    for a, b in zip(cuda_hist.points_bin_counts(pt, mt, tower, grid),
                    cuda_hist.points_bin_counts_plain(pt, mt, tower, grid)):
        assert torch.equal(a, b)
    assert torch.equal(cuda_hist.flat_ids(pt, mt, grid), cuda_hist.flat_ids_plain(pt, mt, grid))
    return got


@pytest.mark.parametrize("b,n,grid", [(1, 131072, (64, 64, 64)), (3, 131072, (64, 64, 64)),
                                      (64, 65536, (64, 64, 64)), (2, 131072, (64, 64, 256)),
                                      (3, 131071, (48, 40, 56)), (4, 3001, (12, 10, 14)),
                                      (2, 1025, (16, 16, 16)), (2, 60000, (128, 128, 128)),
                                      (1, 20000, (4, 9000, 4))])
def test_occupancy_kernel_exact_at_batch_and_chunking(dev, b, n, grid):
    """One sample, a few and the batch-64 pipeline's count; non-cubic grids;
    N a multiple of the bounds pass's 1024-point unit or not (then the
    points are read one at a time); a grid whose bitmap does not fit in
    shared memory (128³) and one with more y columns than shared memory
    counts (n_y = 9000): both mark in device memory."""
    pts, mask = _cloud(b + n, b, n)
    _points_family_exact(dev, pts, mask, grid)


@pytest.mark.parametrize("flags", ["random", "all", "masked"])
def test_occupancy_kernel_one_point_zero_extent_and_all_masked(dev, flags):
    """K1 and K3 (with tower flags on a tenth of the points, on all, or on
    the masked ones alone, which count nowhere)."""
    pts = np.zeros((3, 5000, 3), np.float32)
    mask = np.zeros((3, 5000), bool)
    pts[0] = np.random.default_rng(5).uniform(0, 9, (5000, 3))
    mask[0, 17] = True        # one valid point
    pts[1] = 2.5
    mask[1, :300] = True      # every point at one place: zero extent
    got = _points_family_exact(dev, pts, mask, (16, 16, 16), flags)  # sample 2: all masked
    assert [int(v) for v in got.sum(1)] == [1, 1, 0]
    towers = cuda_hist.points_binary(*(torch.from_numpy(a).to(dev) for a in
                                       (pts, mask, _tower_flags(mask, flags))), (16, 16, 16))[1]
    want = {"random": None, "all": [1, 1, 0], "masked": [0, 0, 0]}[flags]
    assert want is None or [int(v) for v in towers.sum(1)] == want


def _full_column(n, y, reps=1, extra=()):
    """Every (z, x) voxel of y column `y` of an n^3 grid holds `reps` points."""
    pts = [[ix + 0.5, y + 0.5, iz + 0.5] for iz in range(n) for ix in range(n)
           for _ in range(reps)]
    return np.asarray(pts + [[0.5, 0.5, 0.5], [n - 0.1] * 3] + list(extra), np.float32)


def _stack(clouds):
    n = max(len(c) for c in clouds)
    pts = np.zeros((len(clouds), n, 3), np.float32)
    mask = np.zeros((len(clouds), n), bool)
    for i, c in enumerate(clouds):
        pts[i, :len(c)], mask[i, :len(c)] = c, True
    return pts, mask


@pytest.mark.parametrize("flags", ["random", "all"])
def test_occupancy_kernel_full_columns_in_part_of_a_batch(dev, flags):
    """Sample 0 fills two y columns (one voxel of one of them holds more
    points), sample 1 one, sample 2 none: only the full columns take the
    exact count > column-min rewrite. K3 with every point a tower point:
    its presence keeps the whole full column, its occupancy does not."""
    more = [[1.5, 3.5, 1.5]] * 3
    two = _full_column(8, 0, reps=2, extra=[[ix + 0.5, 3.5, iz + 0.5] for iz in range(8)
                                            for ix in range(8)] + more)
    pts, mask = _stack([two, _full_column(8, 0, reps=2),
                        np.random.default_rng(6).uniform(0, 8, (200, 3)).astype(np.float32)])
    got = _points_family_exact(dev, pts, mask, (8, 8, 8), flags).reshape(3, 8, 8, 8)
    assert int(got[1, :, :, 0].sum()) == 1 and int(got[0, :, :, 3].sum()) == 1
    if flags == "all":
        towers = cuda_hist.points_binary(*(torch.from_numpy(a).to(dev) for a in
                                           (pts, mask, _tower_flags(mask, flags))), (8, 8, 8))[1]
        towers = towers.reshape(3, 8, 8, 8)
        assert int(towers[1, :, :, 0].sum()) == 64 and int(towers[0, :, :, 3].sum()) == 64


@pytest.mark.parametrize("grid,y", [((32, 32, 32), 5), ((128, 8, 128), 7)])
def test_occupancy_kernel_full_column_of_many_voxels(dev, grid, y):
    """(128, 8, 128): a column of 16384 voxels, counted in two slabs."""
    pts, mask = _stack([_full_column(grid[0], y)])
    _points_family_exact(dev, pts, mask, grid)


@pytest.mark.parametrize("ks", [(9, 5, 5), (9, 6, 6), (3, 3, 3), (9, 9, 9), (4, 7, 2)])
@pytest.mark.parametrize("shape", [(2, 16, 16, 16), (1, 13, 37, 70)])
@pytest.mark.parametrize("activation", [True, False])
def test_stencil_kernel_matches_plain(dev, ks, shape, activation):
    rng = np.random.default_rng(sum(ks) + sum(shape))
    x = torch.from_numpy((rng.random(shape) > 0.7).astype(np.float32))[:, None].to(dev)
    k = torch.from_numpy(rng.normal(0, 0.3, ks).astype(np.float32)).to(dev)
    got = cuda_conv.geneo_stencil_conv(x, k, activation=activation)
    want = cuda_conv.geneo_stencil_conv_plain(x, k, activation=activation)
    # f32 sums of up to 729 taps in another order than cuDNN: 1e-5 on
    # probabilities, and 1e-5 relative on raw conv values of magnitude ~10
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(17, 64, 64, 64), (5, 24, 70, 100), (2, 128, 128, 64),
                                   (1, 64, 64, 64), (2, 9, 17, 35), (3, 5, 3, 2)])
@pytest.mark.parametrize("activation", [True, False])
def test_stencil_fast_and_generic_routes_agree(dev, shape, activation):
    """(9,5,5) takes the unrolled kernel at every batch and volume (Y a
    multiple of 4 or not: 16-byte or 4-byte staging); the generic kernel,
    forced on the same input, sums the same 225 products in another order.
    Both are held to the plain version, and two runs of each give the same
    bits."""
    assert cuda_conv.stencil_route((9, 5, 5)) == "fast"
    rng = np.random.default_rng(sum(shape))
    x = torch.from_numpy((rng.random(shape) > 0.7).astype(np.float32))[:, None].to(dev)
    k = torch.from_numpy(rng.normal(0, 0.3, (9, 5, 5)).astype(np.float32)).to(dev)
    before = cuda_conv.LAUNCHES.count
    got = cuda_conv.geneo_stencil_conv(x, k, activation=activation)
    assert cuda_conv.LAUNCHES.count == before + 1
    fast = cuda_conv._launch_stencil(x, k, activation, "fast")
    generic = cuda_conv._launch_stencil(x, k, activation, "generic")
    assert torch.equal(got, fast)
    assert torch.equal(generic, cuda_conv._launch_stencil(x, k, activation, "generic"))
    want = cuda_conv.geneo_stencil_conv_plain(x, k, activation=activation)
    torch.testing.assert_close(fast, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(generic, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(fast, generic, rtol=1e-5, atol=1e-5)


def test_stencil_fast_route_is_refused_for_other_kernel_sizes(dev):
    x = torch.zeros((1, 1, 8, 8, 8), device=dev)
    with pytest.raises(RuntimeError, match="stencil_conv"):
        cuda_conv._launch_stencil(x, torch.zeros((9, 6, 6), device=dev), True, "fast")
    assert cuda_conv.stencil_route((9, 6, 6)) == "generic"


def test_stencil_kernel_refuses_grad(dev):
    x = torch.zeros((1, 1, 8, 8, 8), device=dev)
    k = torch.zeros((3, 3, 3), device=dev, requires_grad=True)
    with pytest.raises(RuntimeError, match="fused_geneo_conv"):
        cuda_conv.geneo_stencil_conv(x, k)


@pytest.mark.parametrize("grid", [(16, 16, 16), (64, 64, 64), (12, 10, 14), (48, 40, 56)])
def test_binary_kernel_exact(dev, grid):
    pts, mask = _cloud(3, 3, 9000)
    tower = (np.random.default_rng(4).random(mask.shape) < 0.05) & mask
    args = [torch.from_numpy(a).to(dev) for a in (pts, mask, tower)]
    before = cuda_hist.BINARY_LAUNCHES.count
    got = cuda_hist.points_binary(*args, grid)
    assert cuda_hist.BINARY_LAUNCHES.count == before + 1
    want = cuda_hist.points_binary_plain(*args, grid)
    cpu = cuda_hist.points_binary_plain(*(torch.from_numpy(a) for a in (pts, mask, tower)), grid)
    for g, w, c in zip(got, want, cpu):
        assert torch.equal(g, w)
        assert torch.equal(g.cpu(), c)
    assert torch.equal(got[0], cuda_hist.points_occupancy(args[0], args[1], grid))


@pytest.mark.parametrize("ks", [(9, 5, 5), (9, 6, 6), (3, 3, 3), (4, 7, 2), (16, 3, 9)])
@pytest.mark.parametrize("shape", [(2, 16, 16, 16), (1, 13, 37, 70), (3, 5, 9, 33)])
def test_stencil_dk_kernel_matches_plain(dev, ks, shape):
    rng = np.random.default_rng(sum(ks) + sum(shape))
    x = torch.from_numpy((rng.random(shape) > 0.7).astype(np.float32))[:, None].to(dev)
    g = torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32))[:, None].to(dev)
    before = cuda_conv.DK_LAUNCHES.count
    got = cuda_conv.stencil_dk(x, g, ks)
    again = cuda_conv.stencil_dk(x, g, ks)
    assert cuda_conv.DK_LAUNCHES.count == before + 2
    want = cuda_conv.stencil_dk_plain(x, g, ks)
    # f32 sums of up to ~10⁵ products in another order: bound relative to
    # the largest tap
    assert torch.equal(got, again)  # fixed-order reduction: bit-identical
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.parametrize("shape", [(1, 64, 64, 64), (16, 64, 64, 64), (2, 13, 37, 70),
                                   (2, 9, 17, 35), (3, 5, 9, 33)])
def test_stencil_dk_fast_and_generic_routes_agree(dev, shape):
    """(9,5,5) takes the unrolled kernel at every batch and volume (Y a
    multiple of the 32-wide tile or not, of 4 or not); the generic kernel,
    forced on the same input, sums the same products in another order. Both
    within 1e-4·max|dk| of the plain version, each bit-identical run to run."""
    assert cuda_conv.stencil_route((9, 5, 5)) == "fast"
    rng = np.random.default_rng(sum(shape))
    x = torch.from_numpy((rng.random(shape) > 0.8).astype(np.float32))[:, None].to(dev)
    g = torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32))[:, None].to(dev)
    before = cuda_conv.DK_LAUNCHES.count
    got = cuda_conv.stencil_dk(x, g, (9, 5, 5))
    assert cuda_conv.DK_LAUNCHES.count == before + 1
    want = cuda_conv.stencil_dk_plain(x, g, (9, 5, 5))
    tol = 1e-4 * float(want.abs().max())
    for route in ("fast", "generic"):
        a = cuda_conv._launch_dk(x, g, (9, 5, 5), route)
        assert torch.equal(a, cuda_conv._launch_dk(x, g, (9, 5, 5), route))
        assert float((a - want).abs().max()) <= tol
    assert torch.equal(got, cuda_conv._launch_dk(x, g, (9, 5, 5), "fast"))


@pytest.mark.parametrize("ks", [(1, 1, 1), (9, 6, 6), (16, 3, 3)])
@pytest.mark.parametrize("shape", [(2, 16, 16, 16), (1, 13, 37, 70)])
def test_stencil_dk_generic_route_at_other_sizes(dev, ks, shape):
    assert cuda_conv.stencil_route(ks) == "generic"
    rng = np.random.default_rng(sum(ks) * sum(shape))
    x = torch.from_numpy((rng.random(shape) > 0.7).astype(np.float32))[:, None].to(dev)
    g = torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32))[:, None].to(dev)
    got = cuda_conv.stencil_dk(x, g, ks)
    assert torch.equal(got, cuda_conv.stencil_dk(x, g, ks))
    want = cuda_conv.stencil_dk_plain(x, g, ks)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_stencil_dk_fast_route_is_refused_for_other_kernel_sizes(dev):
    x = torch.zeros((1, 1, 8, 8, 8), device=dev)
    with pytest.raises(RuntimeError, match="stencil_dk"):
        cuda_conv._launch_dk(x, x, (9, 6, 6), "fast")


@pytest.mark.parametrize("ks", [(9, 5, 5), (9, 6, 6)])
def test_fused_geneo_conv_grads_on_card(dev, ks):
    rng = np.random.default_rng(9)
    x0 = torch.from_numpy((rng.random((2, 1, 16, 16, 16)) > 0.8).astype(np.float32)).to(dev)
    k0 = torch.from_numpy((rng.random(ks) * 0.2 - 0.1).astype(np.float32)).to(dev)
    w = torch.from_numpy(rng.normal(size=(2, 1, 16, 16, 16)).astype(np.float32)).to(dev)
    x, k = x0.clone().requires_grad_(), k0.clone().requires_grad_()
    (cuda_conv.fused_geneo_conv(x, k) * w).sum().backward()
    xr, kr = x0.clone().requires_grad_(), k0.clone().requires_grad_()
    (torch.relu(torch.tanh(conv3d_same(xr, kr[None, None]))) * w).sum().backward()
    assert float((k.grad - kr.grad).abs().max()) <= 1e-4 * float(kr.grad.abs().max())
    torch.testing.assert_close(x.grad, xr.grad, rtol=0, atol=1e-5)


def _tap(ks, idx):
    k = np.zeros(ks, np.float32)
    k[idx] = 1.0
    return k


@pytest.mark.parametrize("ks,idx", [
    ((9, 5, 5), (0, 0, 0)), ((9, 5, 5), (8, 2, 2)), ((9, 5, 5), (4, 4, 2)),
    ((9, 5, 5), (4, 2, 0)), ((9, 5, 5), (4, 2, 4)), ((9, 6, 6), (0, 5, 0)),
    ((9, 6, 6), (8, 0, 5)), ((3, 3, 11), (1, 1, 10)), ((2, 4, 17), (1, 3, 16))])
def test_mma_kernel_single_tap_is_a_shift(dev, ks, idx):
    """A kernel that is 1 at one tap moves the volume by that tap's offset:
    any slip in the mma fragment layouts or the pads shows as a wrong shift."""
    rng = np.random.default_rng(sum(idx))
    x = torch.from_numpy((rng.random((2, 1, 11, 21, 70)) > 0.6).astype(np.float32)).to(dev)
    k = torch.from_numpy(_tap(ks, idx)).to(dev)
    got = cuda_conv.geneo_stencil_conv_mxu(x, k, activation=False)
    # cuDNN may take a transform algorithm: round its f32 answer to the {0,1} it means
    want = cuda_conv.geneo_stencil_conv_plain(x, k, activation=False).round()
    assert torch.equal(got, want) and 0 < int(got.sum()) < got.numel()


MMA_SHAPES = [(2, 16, 16, 16), (1, 20, 16, 16), (1, 13, 37, 70), (2, 40, 48, 56),
              (1, 64, 96, 96), (1, 40, 144, 200)]


@pytest.mark.parametrize("ks", [(9, 5, 5), (9, 6, 6), (3, 3, 3), (9, 9, 9), (4, 7, 2),
                                (16, 3, 11), (2, 2, 20)])
@pytest.mark.parametrize("shape", MMA_SHAPES)
@pytest.mark.parametrize("split", [True, False])
@pytest.mark.parametrize("activation", [True, False])
def test_mma_kernel_matches_plain(dev, ks, shape, split, activation):
    rng = np.random.default_rng(sum(ks) + sum(shape))
    x = torch.from_numpy((rng.random(shape) > 0.7).astype(np.float32))[:, None].to(dev)
    k = torch.from_numpy(rng.normal(0, 0.3, ks).astype(np.float32)).to(dev)
    before = cuda_conv.MXU_LAUNCHES.count
    got = cuda_conv.geneo_stencil_conv_mxu(x, k, activation=activation, split=split)
    assert cuda_conv.MXU_LAUNCHES.count == before + 1
    want = cuda_conv.geneo_stencil_conv_mxu_plain(x, k, activation=activation, split=split)
    # the same exact bf16 x bf16 products, summed in f32 in another order
    bound = 1e-5 * max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= bound
    if split:  # near f32: the JAX tests' bound against the f32 conv
        f32 = cuda_conv.geneo_stencil_conv_plain(x, k, activation=activation)
        torch.testing.assert_close(got, f32, rtol=1e-4, atol=2e-4)


@pytest.mark.parametrize("split", [True, False])
def test_mma_kernel_general_floats_round_to_bf16(dev, split):
    """Non-occupancy inputs round to bf16 (nearest even) inside the kernel."""
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.normal(0, 1, (2, 1, 16, 24, 40)).astype(np.float32)).to(dev)
    k = torch.from_numpy(rng.normal(0, 0.1, (9, 5, 5)).astype(np.float32)).to(dev)
    got = cuda_conv.geneo_stencil_conv_mxu(x, k, activation=False, split=split)
    want = cuda_conv.geneo_stencil_conv_mxu_plain(x, k, activation=False, split=split)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("shape", MMA_SHAPES[:4])
@pytest.mark.parametrize("activation", [True, False])
def test_mma_kernel_fused_tau_mask(dev, shape, activation):
    rng = np.random.default_rng(sum(shape))
    x = torch.from_numpy((rng.random(shape) > 0.7).astype(np.float32))[:, None].to(dev)
    k = torch.from_numpy(rng.normal(0, 0.3, (9, 5, 5)).astype(np.float32)).to(dev)
    probs = cuda_conv.geneo_stencil_conv_mxu(x, k, activation=activation)
    mask = cuda_conv.geneo_stencil_conv_mxu(x, k, activation=activation, tau=0.65)
    assert torch.equal(mask, (probs >= 0.65).float())  # the kernel's own probabilities
    assert 0 < int(mask.sum()) < mask.numel()
    plain = cuda_conv.geneo_stencil_conv_mxu_plain(x, k, activation=activation)
    flips = (mask != (plain >= 0.65).float()) & ((plain - 0.65).abs() > 1e-5)
    assert int(flips.sum()) == 0


def test_mma_kernel_refuses_grad_and_oversize(dev):
    x = torch.zeros((1, 1, 8, 8, 8), device=dev)
    k = torch.zeros((3, 3, 3), device=dev, requires_grad=True)
    with pytest.raises(RuntimeError, match="fused_geneo_conv_mxu"):
        cuda_conv.geneo_stencil_conv_mxu(x, k)
    with pytest.raises(ValueError, match="shared memory"):
        cuda_conv.geneo_stencil_conv_mxu(x, torch.zeros((16, 16, 16), device=dev))
    with pytest.raises(ValueError, match="unsupported stencil shape"):
        cuda_conv.geneo_stencil_conv_mxu(x, torch.zeros((17, 3, 3), device=dev))


def _mma_both_tiles(x, k, **kw):
    """The tensor-core stencil at both z tiles, each launched twice: every
    output sums the same mma in the same order, so all four are bit-equal."""
    runs = [cuda_conv._launch_mma(x, k, kw.get("activation", True), kw.get("split", True),
                                  kw.get("tau"), tz)
            for tz in (cuda_conv.MMA_TALL_Z, cuda_conv.MMA_SHORT_Z) for _ in range(2)]
    torch.cuda.synchronize()
    for r in runs[1:]:
        assert torch.equal(r, runs[0])
    return runs[0]


@pytest.mark.parametrize("ks,shape", [
    ((1, 5, 5), (2, 24, 40, 64)),     # k_z = 1: one pair step, half of B live
    ((16, 5, 5), (2, 24, 40, 64)),    # k_z = 16: nine pair steps, a plane past the halo
    ((9, 5, 11), (2, 20, 33, 70)),    # k_y > 9: two 8-input chunks
    ((9, 3, 14), (1, 17, 20, 45)),    # three chunks
    ((9, 6, 6), (2, 24, 40, 64)),     # even sizes: asymmetric pads
    ((8, 4, 4), (2, 19, 23, 37)),     # even k_z: the pair steps' last plane is 0
    ((9, 5, 5), (1, 64, 64, 64)),     # batch 1 at 64^3 (the short tile's case)
    ((9, 5, 5), (3, 64, 64, 64)),
    ((9, 5, 5), (1, 40, 144, 200)),   # ragged z, x and y tiles
])
@pytest.mark.parametrize("split", [True, False])
def test_mma_kernel_packed_planes_match_plain(dev, ks, shape, split):
    """Both z tiles, bit-identical from run to run and to each other, within
    MXU_TOL of the plain version; with split, within the f32 stencil's
    bound; the fused tau-mask flips only inside the 1e-5 band."""
    rng = np.random.default_rng(sum(ks) * 7 + sum(shape))
    x = torch.from_numpy((rng.random(shape) > 0.7).astype(np.float32))[:, None].to(dev)
    k = torch.from_numpy(rng.normal(0, 0.3, ks).astype(np.float32)).to(dev)
    got = _mma_both_tiles(x, k, split=split)
    want = cuda_conv.geneo_stencil_conv_mxu_plain(x, k, split=split)
    assert float((got - want).abs().max()) <= 1e-5 * max(1.0, float(want.abs().max()))
    assert torch.equal(cuda_conv.geneo_stencil_conv_mxu(x, k, split=split), got)
    if split:
        f32 = cuda_conv.geneo_stencil_conv_plain(x, k)
        assert float((got - f32).abs().max()) <= 1e-4
    mask = _mma_both_tiles(x, k, split=split, tau=0.65)
    assert torch.equal(mask, (got >= 0.65).float())
    flips = (mask != (want >= 0.65).float()) & ((want - 0.65).abs() > 1e-5)
    assert int(flips.sum()) == 0


@pytest.mark.parametrize("ks,idx", [
    ((1, 5, 5), (0, 0, 4)), ((16, 5, 5), (15, 4, 0)), ((16, 5, 5), (0, 2, 2)),
    ((9, 5, 5), (1, 3, 1)), ((9, 5, 5), (7, 1, 3)), ((8, 3, 3), (7, 2, 2)),
    ((9, 5, 11), (4, 2, 9)), ((9, 3, 14), (3, 1, 13))])
def test_mma_kernel_single_tap_packed_fragments(dev, ks, idx):
    """One tap at a time, at both z tiles: odd and even dz (the two halo
    planes of a step), both output planes of a pair, every 8-input chunk.
    A wrong B fragment entry shows as a wrong shift."""
    rng = np.random.default_rng(sum(idx) + 100)
    x = torch.from_numpy((rng.random((2, 1, 21, 19, 45)) > 0.6).astype(np.float32)).to(dev)
    k = torch.from_numpy(_tap(ks, idx)).to(dev)
    got = _mma_both_tiles(x, k, activation=False)
    want = cuda_conv.geneo_stencil_conv_plain(x, k, activation=False).round()
    assert torch.equal(got, want) and 0 < int(got.sum()) < got.numel()


def test_mma_smem_formula_matches_the_library(dev):
    """The plan's shared-memory formula is the kernel's own."""
    from scenenet_tpu_torch.ops import _build
    lib = _build.load()
    for ks in [(9, 5, 5), (9, 6, 6), (16, 3, 11), (2, 2, 20), (1, 1, 1), (16, 16, 16)]:
        for tz in (cuda_conv.MMA_TALL_Z, cuda_conv.MMA_SHORT_Z):
            assert lib.snt_stencil_mma_smem(*ks, tz) == cuda_conv.stencil_mma_smem(ks, tz)


@pytest.mark.parametrize("ks", [(9, 5, 5), (9, 6, 6)])
def test_fused_geneo_conv_mxu_grads_on_card(dev, ks):
    """Tensor-core forward, the f32 backward of fused_geneo_conv."""
    rng = np.random.default_rng(9)
    x0 = torch.from_numpy((rng.random((2, 1, 16, 16, 16)) > 0.8).astype(np.float32)).to(dev)
    k0 = torch.from_numpy((rng.random(ks) * 0.2 - 0.1).astype(np.float32)).to(dev)
    w = torch.from_numpy(rng.normal(size=(2, 1, 16, 16, 16)).astype(np.float32)).to(dev)
    x, k = x0.clone().requires_grad_(), k0.clone().requires_grad_()
    before = (cuda_conv.MXU_LAUNCHES.count, cuda_conv.DK_LAUNCHES.count)
    out = cuda_conv.fused_geneo_conv_mxu(x, k)
    (out * w).sum().backward()
    assert (cuda_conv.MXU_LAUNCHES.count, cuda_conv.DK_LAUNCHES.count) == \
        (before[0] + 1, before[1] + 1)
    ref = cuda_conv.geneo_stencil_conv(x0, k0)
    out = out.detach()
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-4)
    # the shared backward, applied to the kernel's own output (against
    # fused_geneo_conv a relu gate may open in one and not in the other)
    act = w * torch.where(out > 0, 1.0 - out * out, torch.zeros_like(out))
    dk = cuda_conv.stencil_dk_plain(x0, act, ks)
    assert float((k.grad - dk).abs().max()) <= 1e-4 * float(dk.abs().max())
    torch.testing.assert_close(x.grad, cuda_conv._conv_transpose_same(act, k0),
                               rtol=0, atol=1e-5)


# ---- the model and the server on the card ---------------------------------------

def test_scenenet_inference_mxu_on_card(dev):
    """inference="mxu" with tau: one tensor-core launch, no f32 stencil, the
    mask of the kernel's own probabilities, near the f32 route."""
    from scenenet_tpu_torch.models import SceneNet

    rng = np.random.default_rng(4)
    x = torch.from_numpy((rng.random((3, 1, 32, 32, 32)) > 0.9).astype(np.float32)).to(dev)
    net = SceneNet.create(kernel_size=(9, 5, 5), seed=0, backend="cuda").to(dev).eval()
    before = (cuda_conv.MXU_LAUNCHES.count, cuda_conv.LAUNCHES.count)
    with torch.inference_mode():
        mask = net(x, inference="mxu", tau=0.65)
        assert (cuda_conv.MXU_LAUNCHES.count, cuda_conv.LAUNCHES.count) == \
            (before[0] + 1, before[1])
        probs = net(x, inference="mxu")
        fast = net(x, inference="mxu_fast")
        f32 = net(x, inference=True)
    assert torch.equal(mask, (probs >= 0.65).float())
    torch.testing.assert_close(probs, f32, rtol=0, atol=1e-4)
    torch.testing.assert_close(fast, f32, rtol=2e-2, atol=2e-2)
    assert float((fast - f32).abs().max()) > float((probs - f32).abs().max())
    assert SceneNet.create(kernel_size=(9, 5, 5), backend="cuda_mxu").to(dev)(x).requires_grad


@pytest.mark.parametrize("model,inference", [("scenenet", "mxu"), ("quantile", True)])
def test_batched_pipeline_on_card_matches_cpu(dev, model, inference):
    """Six concurrent requests through the micro-batcher on the card against
    the CPU pipeline. The card and the CPU synthesize kernels that differ in
    the last bit; the tensor-core route can turn that into one unit of a
    tap's bf16 residual (2⁻¹⁷·|k|), so the three-member ensemble, with three
    times the chances, is held on the f32 route."""
    import threading

    from scenenet_tpu_torch.cli.serve import _Pipeline

    kw = dict(grid=(16, 16, 16), max_points=4096, inference=inference, model=model)
    cpu = _Pipeline(None, device="cpu", **kw)
    gpu = _Pipeline(None, device="cuda", max_batch=4, batch_window_ms=200.0, **kw)
    rng = np.random.default_rng(8)
    # ~8% of the voxels occupied, like a LiDAR tile
    clouds = [np.round(rng.uniform(0, 20 + i, (330 + 20 * i, 3)), 2).astype(np.float32)
              for i in range(6)]
    out = [None] * 6
    # the pipeline's count: the wrappers' own plus each captured bucket's
    # launches once a replay (every bucket 1, 2, 4 is a graph on the card)
    before = gpu.kernel_launches()
    threads = [threading.Thread(target=lambda i=i: out.__setitem__(i, gpu.predict(clouds[i])),
                                daemon=True) for i in range(6)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        gpu.close()
    stats = gpu._batcher.stats_snapshot()
    assert stats["requests"] == 6 and stats["dispatches"] < 6 and stats["max_batch_seen"] > 1
    convs = (3 if model == "quantile" else 1) * stats["dispatches"]
    after = gpu.kernel_launches()
    launched = (after["stencil_mma"] - before["stencil_mma"],
                after["stencil_conv"] - before["stencil_conv"])
    assert launched == ((convs, 0) if inference == "mxu" else (0, convs))
    assert sum(gpu.graph_replays().values()) == stats["dispatches"]
    for cloud, (pred, probs) in zip(clouds, out):
        ref_pred, ref_probs = cpu.predict(cloud)
        assert probs.shape == ref_probs.shape
        np.testing.assert_allclose(pred, ref_pred, rtol=0, atol=1e-5)
        np.testing.assert_allclose(probs, ref_probs, rtol=0, atol=1e-5)



@pytest.mark.parametrize("model,inference", [("scenenet", True), ("scenenet", "mxu"),
                                             ("scenenet", "mxu_fast"), ("quantile", True),
                                             ("quantile", "mxu")])
def test_served_graph_replay_equals_eager_run_batch(dev, model, inference, tmp_path):
    """Every warmed bucket is one CUDA graph; its replay gives the eager
    run_batch's bits, twice, and a restored checkpoint takes effect at the
    next replay (the kernels are synthesized inside the graph)."""
    from scenenet_tpu_torch.cli.serve import _Pipeline
    from scenenet_tpu_torch.models.scenenet import QuantileSceneNet, SceneNet
    from scenenet_tpu_torch.train.checkpoint import save_checkpoint

    p = _Pipeline(None, grid=(16, 16, 16), max_points=4096, inference=inference, model=model,
                  device="cuda", max_batch=4, batch_window_ms=0.0)
    try:
        assert sorted(p._graphs) == [1, 2, 4] and all(g.graph.captured
                                                      for g in p._graphs.values())
        for b in (1, 2, 4):
            pts, mask = _cloud(30 + b, b, 4096)
            pt, mt = torch.from_numpy(pts).to(dev), torch.from_numpy(mask).to(dev)
            with torch.inference_mode():
                eager = p._run(pt, mt)
            got, again = p.run_batch(pt, mt), p.run_batch(pt, mt)
            for g, a, e in zip(got, again, eager):
                assert torch.equal(g, e) and torch.equal(a, e)
            assert p._graphs[b].replays == 2
        other = (QuantileSceneNet.create(kernel_size=(9, 5, 5), seed=3)
                 if model == "quantile" else SceneNet.create(kernel_size=(9, 5, 5), seed=3))
        save_checkpoint(str(tmp_path / "other.npz"), other)
        from scenenet_tpu_torch.train.checkpoint import restore_checkpoint

        restore_checkpoint(str(tmp_path / "other.npz"), p.net)
        with torch.inference_mode():
            eager_new = p._run(pt, mt)
        got_new = p.run_batch(pt, mt)
        assert torch.equal(got_new[1], eager_new[1]) and not torch.equal(got_new[1], got[1])
    finally:
        p.close()


def test_concurrent_direct_requests_through_one_graph(dev):
    """The adaptive "single" phase: handler threads replay bucket 1's graph
    at once; the lock keeps every reply its own request's."""
    import threading

    from scenenet_tpu_torch.cli.serve import _Pipeline

    kw = dict(grid=(16, 16, 16), max_points=4096, device="cuda")
    ref = _Pipeline(None, **kw)
    p = _Pipeline(None, max_batch=4, batch_window_ms=0.0, adaptive=True, **kw)
    rng = np.random.default_rng(12)
    clouds = [np.round(rng.uniform(0, 15 + i, (300 + 40 * i, 3)), 2).astype(np.float32)
              for i in range(12)]
    out = [None] * len(clouds)
    try:
        p._batcher._mode = "single"
        p._batcher._phase_len = 10 ** 6  # stay in the direct phase
        threads = [threading.Thread(target=lambda i=i: out.__setitem__(i, p.predict(clouds[i])),
                                    daemon=True) for i in range(len(clouds))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        p.close()
    assert p._batcher.stats_snapshot().get("direct_requests") == len(clouds)
    assert p.graph_replays()[1] == len(clouds)
    for cloud, (pred, probs) in zip(clouds, out):
        want_pred, want_probs = ref.predict(cloud)
        np.testing.assert_array_equal(pred, want_pred)
        np.testing.assert_array_equal(probs, want_probs)


def test_healthz_launch_counts_grow_per_replay(dev):
    import io
    import json
    import threading
    import urllib.request

    from scenenet_tpu_torch.cli.serve import build_server

    server, p = build_server(["--grid", "16", "--max-points", "4096", "--port", "0"])
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    seen = []
    try:
        for i in range(3):
            buf = io.BytesIO()
            np.savez(buf, points=np.random.default_rng(i).uniform(0, 9, (500, 3)))
            req = urllib.request.Request(f"{url}/predict", data=buf.getvalue(), method="POST")
            with urllib.request.urlopen(req, timeout=60) as r:
                assert r.status == 200
            with urllib.request.urlopen(f"{url}/healthz", timeout=60) as r:
                seen.append(json.loads(r.read()))
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
        p.close()
    assert p._graphs[1].launches["points_occupancy"] == p._graphs[1].launches[
        "stencil_conv"] == 1
    for k in ("points_occupancy", "stencil_conv"):
        counts = [h["kernel_launches"][k] for h in seen]
        assert counts[1] - counts[0] == counts[2] - counts[1] == 1, (k, counts)
    assert [h["graph_replays"]["1"] for h in seen] == [1, 2, 3]

# ---- the histogram family: counts, ids given, ids sorted, ids out ---------------------

HIST_GRIDS = [(16, 16, 16), (64, 64, 64), (12, 10, 14), (48, 40, 56), (64, 64, 256)]


def _equal_pairs(got, want, cpu):
    for g, w, c in zip(got, want, cpu):
        if w is None:
            assert g is None and c is None
        else:
            assert g.dtype == w.dtype and torch.equal(g, w) and torch.equal(g.cpu(), c)


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("n", [9000, 777])  # neither a multiple of 256
@pytest.mark.parametrize("grid", HIST_GRIDS)
def test_points_bin_counts_kernel_exact(dev, grid, n, channels):
    pts, mask = _cloud(5, 3, n)
    tower = (np.random.default_rng(6).random(mask.shape) < 0.05) & mask
    host = [torch.from_numpy(a) for a in (pts, mask, tower)]
    args = [a.to(dev) for a in host]
    before = cuda_hist.BIN_COUNTS_LAUNCHES.count
    got = cuda_hist.points_bin_counts(*args, grid, channels=channels)
    assert cuda_hist.BIN_COUNTS_LAUNCHES.count == before + 1
    _equal_pairs(got, cuda_hist.points_bin_counts_plain(*args, grid, channels),
                 cuda_hist.points_bin_counts_plain(*host, grid, channels))
    assert float(got[0].sum()) == mask.sum()
    if channels == 2:  # binarized, the counts are the two-channel binary kernel's grids
        occ, pres = cuda_hist.points_binary(*args, grid)
        cols = got[0].reshape(3, -1, grid[1])
        assert torch.equal((cols > cols.amin(1, keepdim=True)).float().reshape(3, -1), occ)
        assert torch.equal((got[1] > 0).float(), pres)
        zeros = cuda_hist.points_bin_counts(args[0], args[1], None, grid)
        assert torch.equal(zeros[0], got[0]) and float(zeros[1].abs().sum()) == 0


@pytest.mark.parametrize("n", [9000, 777])
@pytest.mark.parametrize("grid", HIST_GRIDS)
def test_flat_ids_kernel_exact(dev, grid, n):
    pts, mask = _cloud(7, 3, n)
    pts[~mask] = np.nan  # a masked point's coordinates are never read
    pt, mt = torch.from_numpy(pts).to(dev), torch.from_numpy(mask).to(dev)
    before = cuda_hist.FLAT_IDS_LAUNCHES.count
    got = cuda_hist.flat_ids(pt, mt, grid)
    assert cuda_hist.FLAT_IDS_LAUNCHES.count == before + 1
    want = cuda_hist.flat_ids_plain(pt, mt, grid)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    size = grid[0] * grid[1] * grid[2]
    assert bool((got[~mt] == cuda_hist.invalid_id(size)).all()) and int(got[mt].max()) < size
    # the counts kernel over these ids equals the raw-points counts kernel
    a = cuda_hist.bin_counts(got, mt, size)[0]
    assert torch.equal(a, cuda_hist.points_bin_counts(pt.nan_to_num(0.0), mt, None, grid,
                                                      channels=1)[0])


def _offset_view(t):
    """A contiguous copy of ``t`` whose storage starts one element into its
    allocation: its pointer is off every 16-byte (and, for one byte an
    element, every 4-byte) boundary, so the kernels take their point-by-point
    path."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    flat[1:] = t.reshape(-1)
    return flat[1:].view(t.shape)


def _k6_k9_exact(pts, mask, tower, grid, channels=2):
    """K6 (both routes, the public call counting one launch) and K9 equal to
    their plain versions; returns K6's grids and K9's ids."""
    before = (cuda_hist.BIN_COUNTS_LAUNCHES.count, cuda_hist.FLAT_IDS_LAUNCHES.count)
    got = cuda_hist.points_bin_counts(pts, mask, tower, grid, channels=channels)
    ids = cuda_hist.flat_ids(pts, mask, grid)
    assert (cuda_hist.BIN_COUNTS_LAUNCHES.count, cuda_hist.FLAT_IDS_LAUNCHES.count) == (
        before[0] + 1, before[1] + 1)
    want = cuda_hist.points_bin_counts_plain(pts, mask, tower, grid, channels)
    for route in ("float", "int32"):
        forced = cuda_hist._launch_points_bin_counts(pts, mask, tower, grid, channels, route)
        for g, f, w in zip(got, forced, want):
            assert (w is None and g is None and f is None) or (
                torch.equal(g, w) and torch.equal(f, w))
    assert torch.equal(ids, cuda_hist.flat_ids_plain(pts, mask, grid))
    return got, ids


@pytest.mark.parametrize("n", [9001, 65536 + 2, 131072 - 1])  # N % 4 != 0
@pytest.mark.parametrize("offset", [False, True])
def test_points_bin_counts_and_flat_ids_ragged_and_unaligned(dev, n, offset):
    """N % 4 != 0, and points, mask and flags as views one element into
    their allocations: both kernels point by point, exact. The tower flags
    are not gated here (a tenth of every point, masked ones too) and the
    masked points' coordinates are NaN: neither reaches a count or an id."""
    pts, mask = _cloud(31, 3, n)
    pts[~mask] = np.nan
    flags = np.random.default_rng(32).random(mask.shape) < 0.1
    args = [torch.from_numpy(a).to(dev) for a in (pts, mask, flags)]
    if offset:
        args = [_offset_view(a) for a in args]
        assert args[0].data_ptr() % 16 and args[1].data_ptr() % 4 and args[2].data_ptr() % 4
    (counts, towers), ids = _k6_k9_exact(*args, (64, 64, 64))
    assert float(counts.sum()) == mask.sum() and float(towers.sum()) == (mask & flags).sum()
    assert bool((ids[~args[1]] == cuda_hist.invalid_id(64 ** 3)).all())


@pytest.mark.parametrize("b,n", [(16, 65536), (1, 131072), (4, 131072)])
def test_points_bin_counts_ungated_flags_and_nan_masked_points(dev, b, n):
    """The main path's shapes (four points a thread, 16-byte loads): tower
    flags set on masked points too count nowhere, NaN coordinates of masked
    points reach neither the bounds, a count nor an id."""
    pts, mask = _cloud(33 + b, b, n)
    pts[~mask] = np.nan
    flags = np.random.default_rng(34).random(mask.shape) < 0.3
    args = [torch.from_numpy(a).to(dev) for a in (pts, mask, flags)]
    (counts, towers), ids = _k6_k9_exact(*args, (64, 64, 64))
    assert float(towers.sum()) == (mask & flags).sum()
    assert float(counts.sum()) == mask.sum()
    # one channel, and two with no flags (zeros)
    _k6_k9_exact(args[0], args[1], None, (64, 64, 64), channels=1)
    _, zeros = cuda_hist.points_bin_counts(args[0], args[1], None, (64, 64, 64))
    assert float(zeros.abs().sum()) == 0


def test_points_bin_counts_one_voxel_holds_every_point(dev):
    """Sample 0: every point at one place (a zero-extent cloud: voxel 0),
    all flagged; sample 1: 70000 points at one place and one far away, so
    that all but one share a voxel; sample 2: all masked. Exact on both
    routes, K9's ids all 0 for sample 0."""
    n = 70000
    pts = np.zeros((3, n, 3), np.float32)
    pts[0] = [1.5, 2.5, 3.5]
    pts[1] = [0.25, 0.25, 0.25]
    pts[1, -1] = [30.0, 30.0, 30.0]
    mask = np.ones((3, n), bool)
    mask[2] = False
    flags = np.zeros((3, n), bool)
    flags[0] = True
    args = [torch.from_numpy(a).to(dev) for a in (pts, mask, flags)]
    (counts, towers), ids = _k6_k9_exact(*args, (64, 64, 64))
    assert float(counts[0, 0]) == n == float(towers[0, 0]) == float(towers[0].sum())
    assert float(counts[1].max()) == n - 1 and float(counts[1].sum()) == n
    assert float(towers[1].sum()) == 0 and float(counts[2].abs().sum()) == 0
    assert int(ids[0].abs().sum()) == 0


def test_points_bin_counts_past_2_24_points_a_sample(dev):
    """2**24 + 3 of one sample's 2**24 + 5 points in one voxel: the wrapper
    takes the int32 route, whose count rounds to f32 once (to 2**24 + 4) as
    the plain version's does; f32 atomics would stop at 2**24. The float
    route is refused past 2**24 points."""
    n = 2 ** 24 + 5
    pts = torch.full((1, n, 3), 2.0, device=dev)
    pts[0, :2] = torch.tensor([[0.0, 0.0, 0.0], [9.0, 9.0, 9.0]], device=dev)
    mask = torch.ones((1, n), dtype=torch.bool, device=dev)
    flags = torch.zeros((1, n), dtype=torch.bool, device=dev)
    flags[0, ::2] = True
    assert cuda_hist.points_bin_counts_route(n) == "int32"
    got = cuda_hist.points_bin_counts(pts, mask, flags, (8, 8, 8))
    want = cuda_hist.points_bin_counts_plain(pts, mask, flags, (8, 8, 8))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert float(got[0].max()) == float(np.float32(n - 2)) == 2 ** 24 + 4
    with pytest.raises(RuntimeError):
        cuda_hist._launch_points_bin_counts(pts, mask, flags, (8, 8, 8), 2, "float")


@pytest.mark.parametrize("b,n", [(16, 65536), (1, 131072)])
def test_points_bin_counts_and_flat_ids_in_a_cuda_graph(dev, b, n):
    """Captured in a CUDA graph and replayed, K6 and K9 give the eager
    call's grids and ids: nothing in them waits for the host."""
    pts, mask = _cloud(35, b, n)
    flags = np.random.default_rng(36).random(mask.shape) < 0.2
    pt, mt, ft = (torch.from_numpy(a).to(dev) for a in (pts, mask, flags))
    want = cuda_hist.points_bin_counts(pt, mt, ft, (64, 64, 64))
    want_ids = cuda_hist.flat_ids(pt, mt, (64, 64, 64))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        cuda_hist.points_bin_counts(pt, mt, ft, (64, 64, 64))
        cuda_hist.flat_ids(pt, mt, (64, 64, 64))
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = cuda_hist.points_bin_counts(pt, mt, ft, (64, 64, 64))
        ids = cuda_hist.flat_ids(pt, mt, (64, 64, 64))
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert torch.equal(ids, want_ids)


def _device_ops(fn, calls=10):
    """Device operations (kernels and memsets) of ``calls`` calls of ``fn``,
    by name, from torch.profiler, after a warm-up call. A second pass that
    starts while the bounds pass drains may lose a record in one call, so
    the names are counted over several."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return Counter(e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)


def test_points_bin_counts_takes_two_device_operations(dev):
    """K6 at the train step's shape: the bounds pass, which zeroes both grids,
    and the count pass (at most three, and no convert pass); the int32 route
    adds one convert pass for both grids. K9: the bounds and the ids pass.
    Each a call: no operation more often than the calls."""
    pts, mask = _cloud(37, 16, 65536)
    flags = np.random.default_rng(38).random(mask.shape) < 0.2
    pt, mt, ft = (torch.from_numpy(a).to(dev) for a in (pts, mask, flags))
    for fn, want in (
            (lambda: cuda_hist.points_bin_counts(pt, mt, ft, (64, 64, 64)),
             ["bounds_kernel", "count_kernel<true>"]),
            (lambda: cuda_hist._launch_points_bin_counts(pt, mt, ft, (64, 64, 64), 2, "int32"),
             ["bounds_kernel", "count_kernel<false>", "counts_to_float_kernel"]),
            (lambda: cuda_hist.flat_ids(pt, mt, (64, 64, 64)), ["bounds_kernel", "ids_kernel"])):
        ops = _device_ops(fn)
        assert len(ops) == len(want) and max(ops.values()) <= 10, ops
        assert all(sum(w in name for name in ops) == 1 for w in want), ops


def _flat_case(seed, b, n, size):
    rng = np.random.default_rng(seed)
    flat = rng.integers(0, max(size // 7, 1), (b, n)).astype(np.int32) * 7 % size
    flat[:, ::50] = rng.integers(0, size, flat[:, ::50].shape)
    flat[0, :6] = [0, size - 1, size, size + 3, -1, -2 ** 31]  # the edges and outside
    mask = rng.random((b, n)) > 0.15
    mask[0, :6] = True
    mask[-1, n // 2:] = False  # padded tail, ids 0
    flat[-1, n // 2:] = 0
    w = (rng.random((b, n)) > 0.6).astype(np.int32)
    return flat, mask, w


@pytest.mark.parametrize("weights", [None, "int32", "bool", "float"])
@pytest.mark.parametrize("size,b,n", [(16 ** 3, 3, 9000), (64 ** 3, 2, 65536 + 3),
                                      (12 * 10 * 14, 3, 777), (64 * 64 * 256, 2, 32768)])
def test_bin_counts_kernel_exact(dev, size, b, n, weights):
    flat, mask, w = _flat_case(size, b, n, size)
    w = None if weights is None else w.astype({"int32": np.int32, "bool": bool,
                                               "float": np.float32}[weights])
    host = [torch.from_numpy(flat), torch.from_numpy(mask)]
    hw = None if w is None else torch.from_numpy(w)
    args = [a.to(dev) for a in host]
    dw = None if hw is None else hw.to(dev)
    before = cuda_hist.FLAT_COUNTS_LAUNCHES.count
    got = cuda_hist.bin_counts(*args, size, dw)
    assert cuda_hist.FLAT_COUNTS_LAUNCHES.count == before + 1
    _equal_pairs(got, cuda_hist.bin_counts_plain(*args, size, dw),
                 cuda_hist.bin_counts_plain(*host, size, hw))
    keep = mask & (flat >= 0) & (flat < size)
    assert float(got[0].sum()) == keep.sum()
    assert torch.equal(cuda_hist.bin_counts(args[0].long(), args[1], size, dw)[0], got[0])


def test_bin_counts_kernel_float_weights(dev):
    """indicator=False: bf16-rounded weights, f32 atomics in an order that
    changes run to run: rtol 1e-5, atol 1e-5 against the plain version; the
    counts stay exact."""
    size, b, n = 32 ** 3, 2, 30000
    flat, mask, _ = _flat_case(1, b, n, size)
    w = np.random.default_rng(2).normal(1.0, 0.5, (b, n)).astype(np.float32)
    args = [torch.from_numpy(a).to(dev) for a in (flat, mask)]
    dw = torch.from_numpy(w).to(dev)
    got = cuda_hist.bin_counts(*args, size, dw, indicator=False)
    want = cuda_hist.bin_counts_plain(*args, size, dw, indicator=False)
    assert torch.equal(got[0], want[0])
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-5)
    unrounded = torch.zeros(b * size + 1, device=dev).index_add_(
        0, torch.where(args[1] & (args[0] >= 0) & (args[0] < size),
                       args[0].long() + torch.arange(b, device=dev)[:, None] * size,
                       b * size).reshape(-1), dw.reshape(-1))[:-1].reshape(b, size)
    assert float((got[1] - unrounded).abs().max()) > 1e-3  # bf16 was applied


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("size,b,n", [(16 ** 3, 3, 9000), (12 * 10 * 14, 3, 777),
                                      (4096, 2, 1000), (4097, 2, 1000),
                                      (64 * 64 * 256, 2, 32768), (128 ** 3, 4, 131072),
                                      (256 ** 3, 1, 131072)])
def test_sorted_bin_counts_kernel_exact(dev, size, b, n, channels):
    """Sizes around the slab width (4096 bins), non-cubic grids, and the
    128³ and 256³ classes; equal to the plain version and to bin_counts."""
    flat, mask, w = _flat_case(size + 1, b, n, size)
    args = [torch.from_numpy(a).to(dev) for a in (flat, mask)]
    dw = torch.from_numpy(w).to(dev) if channels == 2 else None
    before = cuda_hist.SORTED_COUNTS_LAUNCHES.count
    got = cuda_hist.sorted_bin_counts(*args, dw, size, channels=channels)
    assert cuda_hist.SORTED_COUNTS_LAUNCHES.count == before + 1
    want = cuda_hist.sorted_bin_counts_plain(*args, dw, size, channels)
    other = cuda_hist.bin_counts(*args, size, dw)
    for g, w_, o in zip(got, want, other):
        if w_ is None:
            assert g is None
        else:
            assert torch.equal(g, w_) and torch.equal(g, o)
    if channels == 2:
        zeros = cuda_hist.sorted_bin_counts(*args, None, size)
        assert torch.equal(zeros[0], got[0]) and float(zeros[1].abs().sum()) == 0


def test_sorted_bin_counts_kernel_one_hot_bin_and_all_masked(dev):
    size = 128 * 128 * 16
    flat = torch.full((2, 70000), 12345, dtype=torch.int32, device=dev)
    mask = torch.ones((2, 70000), dtype=torch.bool, device=dev)
    mask[1] = False
    counts, flagged = cuda_hist.sorted_bin_counts(flat, mask, mask, size)
    assert float(counts[0, 12345]) == 70000 == float(counts.sum())
    assert float(flagged[0, 12345]) == 70000 == float(flagged.sum())


def _sorted_exact(dev, flat, mask, w, size):
    """K8 with two channels, one, and none flagged, against its plain
    version and K7; returns the two-channel counts."""
    args = [torch.as_tensor(a).to(dev) for a in (flat, mask, w)]
    got = cuda_hist.sorted_bin_counts(*args, size)
    other = cuda_hist.bin_counts(args[0], args[1], size, args[2])
    for g, w_, o in zip(got, cuda_hist.sorted_bin_counts_plain(*args, size), other):
        assert torch.equal(g, w_) and torch.equal(g, o)
    one = cuda_hist.sorted_bin_counts(*args[:2], None, size, channels=1)
    assert one[1] is None and torch.equal(one[0], got[0])
    return got


@pytest.mark.parametrize("size", [3 * 4096, 4096 * 4096 + 17, 128 ** 3, 256 ** 3,
                                  2 ** 25 + 5, 3 * 2 ** 26])
def test_sorted_bin_counts_kernel_slab_edges(dev, size):
    """Ids on both sides of every slab edge near 4096 and at size − 1, and
    negative ids, at sizes of one to many 4096-bin slabs; past 256³ a part
    of the partition holds several slabs (four at 2**25 + 5, B=2; sixteen at
    3·2**26, B=1)."""
    b = 2 if size < 2 ** 26 else 1
    n = 20000
    rng = np.random.default_rng(size % 1000)
    flat = rng.integers(-50, size, (b, n)).astype(np.int32)
    edges = [4095, 4096, 4097, 8191, 8192, size - 4097, size - 4096, size - 1, size,
             -1, -4096, -(2 ** 31)]
    flat[:, :len(edges) * 3] = np.repeat(np.array(edges, np.int32), 3)[None]
    mask = rng.random((b, n)) > 0.1
    mask[:, :len(edges) * 3] = True
    w = rng.random((b, n)) < 0.5
    counts, flagged = _sorted_exact(dev, flat, mask, w, size)
    for e in (4095, 4096, 4097, 8191, 8192, size - 1):
        assert float(counts[0, e]) >= 3
    keep = mask & (flat >= 0) & (flat < size)
    assert float(counts.sum()) == keep.sum() and float(flagged.sum()) == (keep & w).sum()


@pytest.mark.parametrize("b,n", [(1, 300000), (3, 131072), (2, 70001)])
def test_sorted_bin_counts_kernel_one_slab_over_many_blocks(dev, b, n):
    """Every point in one slab (bins 8192 .. 12287 of 128³), read by every
    block of the partition passes: one part's range reserved by all of
    them, one slab block counting it all."""
    rng = np.random.default_rng(n)
    flat = rng.integers(8192, 12288, (b, n)).astype(np.int32)
    mask = rng.random((b, n)) > 0.05
    counts, _ = _sorted_exact(dev, flat, mask, rng.random((b, n)) < 0.3, 128 ** 3)
    assert float(counts[:, 8192:12288].sum()) == mask.sum() == float(counts.sum())
    assert cuda_hist.sorted_counts_plan(b, n, 128 ** 3)[2] > 1


def test_sorted_bin_counts_kernel_negative_ids(dev):
    """Negative ids (int32 and int64) count nowhere, whatever their mask."""
    rng = np.random.default_rng(9)
    flat = rng.integers(-(2 ** 31), 2 ** 20, (2, 50000)).astype(np.int64)
    flat[1, ::2] = -rng.integers(1, 2 ** 40, flat[1, ::2].shape)
    mask = np.ones(flat.shape, bool)
    w = rng.random(flat.shape) < 0.5
    got = _sorted_exact(dev, flat.astype(np.int32), mask, w, 128 ** 3)
    wide = _sorted_exact(dev, flat, mask, w, 128 ** 3)
    assert torch.equal(got[0][0], wide[0][0])
    assert float(wide[0].sum()) == ((flat >= 0) & (flat < 128 ** 3)).sum()


def test_sorted_bin_counts_kernel_in_a_cuda_graph(dev):
    """Captured in a CUDA graph and replayed, K8 gives the eager call's
    counts: no step of it waits for the host."""
    rng = np.random.default_rng(12)
    size = 128 ** 3
    flat = torch.from_numpy(rng.integers(0, size, (4, 131072)).astype(np.int32)).to(dev)
    mask = torch.from_numpy(rng.random((4, 131072)) > 0.3).to(dev)
    w = torch.from_numpy(rng.random((4, 131072)) < 0.3).to(dev)
    want = cuda_hist.sorted_bin_counts(flat, mask, w, size)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        cuda_hist.sorted_bin_counts(flat, mask, w, size)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = cuda_hist.sorted_bin_counts(flat, mask, w, size)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _k7_both_routes(flat, mask, size, w):
    """K7's indicator form through its two routes, equal to each other and
    to the public call (which counts one launch)."""
    before = cuda_hist.FLAT_COUNTS_LAUNCHES.count
    got = cuda_hist.bin_counts(flat, mask, size, w)
    assert cuda_hist.FLAT_COUNTS_LAUNCHES.count == before + 1
    for route in ("float", "counter"):
        other = cuda_hist._launch_bin_counts(flat, mask, size, w, route)
        assert torch.equal(other[0], got[0])
        assert (other[1] is None and got[1] is None) or torch.equal(other[1], got[1])
    return got


@pytest.mark.parametrize("dtype", [torch.bool, torch.uint8, torch.int8, torch.int16,
                                   torch.int32, torch.int64, torch.float16, torch.bfloat16,
                                   torch.float32, torch.float64])
def test_bin_counts_kernel_reads_flags_in_their_dtype(dev, dtype):
    """K7 reads the flags as they are: nonzero set, and for a float -0.0
    not set, NaN and a subnormal set, as ``weights != 0``."""
    size, b, n = 16 ** 3, 2, 9000
    flat, mask, w = _flat_case(3, b, n, size)
    w = torch.from_numpy(w.astype(np.float64)) * 3.0
    if dtype.is_floating_point:
        w[0, :4] = torch.tensor([-0.0, float("nan"), 1e-40, -2.0], dtype=torch.float64)
    w = w.to(dtype)
    args = [torch.from_numpy(a).to(dev) for a in (flat, mask)]
    got = _k7_both_routes(*args, size, w.to(dev))
    want = cuda_hist.bin_counts_plain(*args, size, w.to(dev))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("channels", [1, 2])
def test_bin_counts_kernel_int64_ids(dev, channels):
    """int64 ids read as they are: ids past int32's range, negative ones and
    ones that int32 would wrap into range count nowhere; the rest exactly."""
    size, b, n = 64 ** 3, 2, 50000
    rng = np.random.default_rng(4)
    flat = rng.integers(0, size, (b, n)).astype(np.int64)
    flat[:, ::3] += rng.integers(1, 4, flat[:, ::3].shape) * 2 ** 32  # wraps into range
    flat[:, 1::7] = -rng.integers(1, 2 ** 40, flat[:, 1::7].shape)
    flat[1, 2::11] = 2 ** 31 + 5
    mask = rng.random((b, n)) > 0.1
    w = rng.random((b, n)) < 0.4
    args = [torch.from_numpy(a).to(dev) for a in (flat, mask)]
    dw = torch.from_numpy(w).to(dev) if channels == 2 else None
    got = _k7_both_routes(*args, size, dw)
    want = cuda_hist.bin_counts_plain(*args, size, dw)
    assert torch.equal(got[0], want[0])
    assert (got[1] is None) if channels == 1 else torch.equal(got[1], want[1])
    assert float(got[0].sum()) == (mask & (flat >= 0) & (flat < size)).sum()


def test_bin_counts_kernel_one_voxel_holds_every_point(dev):
    """Every point of sample 0 in one voxel, all flagged: both grids at
    70000 there (on the counter route both halves of one counter). Sample 1:
    every point in voxel 0 and none flagged, so the flagged grid (the high
    half) stays 0: a count never carries into it. Sample 2: all masked, ids
    0, counts nowhere. Both routes, int32 and int64 ids."""
    n = 70000
    flat = torch.zeros((3, n), dtype=torch.int32, device=dev)
    flat[0] = 12345
    mask = torch.ones((3, n), dtype=torch.bool, device=dev)
    mask[2] = False
    flags = torch.zeros((3, n), dtype=torch.bool, device=dev)
    flags[0] = True
    flags[2] = True
    for ids in (flat, flat.long()):
        counts, flagged = _k7_both_routes(ids, mask, 64 ** 3, flags)
        assert float(counts[0, 12345]) == n == float(counts[0].sum())
        assert float(flagged[0, 12345]) == n == float(flagged[0].sum())
        assert float(counts[1, 0]) == n == float(counts[1].sum())
        assert float(flagged[1].abs().sum()) == 0
        assert float(counts[2].abs().sum()) == 0 and float(flagged[2].abs().sum()) == 0
        one = _k7_both_routes(ids, mask, 64 ** 3, None)
        assert one[1] is None and torch.equal(one[0], counts)


@pytest.mark.parametrize("route", ["float", "counter"])
@pytest.mark.parametrize("channels", [1, 2])
def test_bin_counts_kernel_in_a_cuda_graph(dev, channels, route):
    """Captured in a CUDA graph and replayed, K7 gives the eager call's
    counts on either route: its memset and passes wait for no host step."""
    rng = np.random.default_rng(13)
    size = 64 ** 3
    flat = torch.from_numpy(rng.integers(-5, size + 5, (16, 65536)).astype(np.int32)).to(dev)
    mask = torch.from_numpy(rng.random((16, 65536)) > 0.3).to(dev)
    w = torch.from_numpy(rng.random((16, 65536)) < 0.3).to(dev) if channels == 2 else None
    want = cuda_hist.bin_counts_plain(flat, mask, size, w)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        cuda_hist._launch_bin_counts(flat, mask, size, w, route)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = cuda_hist._launch_bin_counts(flat, mask, size, w, route)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0])
        assert (got[1] is None) if channels == 1 else torch.equal(got[1], want[1])


def test_int64_ids_past_int32_count_nowhere_on_card(dev):
    flat = torch.tensor([[5, 2 ** 32 + 5, -(2 ** 32) + 5, 7]], dtype=torch.int64, device=dev)
    mask = torch.ones((1, 4), dtype=torch.bool, device=dev)
    for counts in (cuda_hist.bin_counts(flat, mask, 16)[0],
                   cuda_hist.sorted_bin_counts(flat, mask, None, 16, channels=1)[0]):
        assert counts[0].tolist() == [0.0] * 5 + [1.0, 0.0, 1.0] + [0.0] * 8


def test_voxelize_routes_on_card(dev):
    """Below the sorted sizes the raw-points kernels, at them batch_flat_ids
    and the sorted kernel; each entry equal to its CPU (plain) result."""
    from scenenet_tpu_torch.ops import voxelize as tv

    rng = np.random.default_rng(3)
    for grid, n, k8 in (((16, 16, 16), 5000, 0), ((128, 128, 128), 49152, 1)):
        pts = rng.uniform(0, 30, (2, n, 3)).astype(np.float32)
        mask = np.arange(n)[None, :] < np.array([[4000], [2500]])
        labels = rng.choice([2, 15], (2, n)).astype(np.int32)
        host = [torch.from_numpy(a) for a in (pts, labels, mask)]
        card = [a.to(dev) for a in host]
        for fn, takes_labels in ((tv.voxelize_batch, True), (tv.voxelize_batch_binary, True),
                                 (tv.voxelize_batch_hist, False),
                                 (tv.voxelize_batch_occupancy, False)):
            sel = (0, 1, 2) if takes_labels else (0, 2)
            extra = ((15,), grid) if takes_labels else (grid,)
            before = cuda_hist.SORTED_COUNTS_LAUNCHES.count
            got = fn(*(card[i] for i in sel), *extra)
            assert cuda_hist.SORTED_COUNTS_LAUNCHES.count == before + k8
            want = fn(*(host[i] for i in sel), *extra)
            for g, w in zip((got if isinstance(got, tuple) else (got,)),
                            (want if isinstance(want, tuple) else (want,))):
                torch.testing.assert_close(g.cpu(), w, rtol=0, atol=1e-6)


# ---- the multi-channel 3³ conv (conv3d_mc) ------------------------------------------

def _mc_case(seed, b, cin, cout, shape, channels_last=False):
    """x ~ U(0, 1) and lecun-scaled weights: outputs of magnitude ~1."""
    rng = np.random.default_rng(seed)
    xs = (b, *shape, cin) if channels_last else (b, cin, *shape)
    x = rng.random(xs).astype(np.float32)
    w = (rng.standard_normal((cout, cin, 3, 3, 3)) / np.sqrt(27 * cin)).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(w)


def _mc_close(got, want, cin=1):
    # f32 sums of 27·C_in products in another order than cuDNN's: the JAX
    # package's own bound up to 160 channels, the absolute part growing with
    # the square root of the sum's length past that
    torch.testing.assert_close(got, want, rtol=1e-5, atol=2e-5 * max(1.0, (cin / 160) ** 0.5))


@pytest.mark.parametrize("cin,cout,shape", [
    (4, 8, (6, 6, 6)), (32, 32, (12, 12, 12)), (160, 128, (8, 8, 8)), (16, 24, (5, 9, 7)),
    (1, 32, (16, 16, 16)), (64, 32, (32, 32, 32)), (512, 256, (8, 8, 8)),
    (256, 256, (4, 4, 4)), (3, 3, (17, 5, 3)), (33, 65, (3, 1, 2)), (1, 1, (1, 1, 1)),
])
def test_conv3d_mc_kernel_matches_plain(dev, cin, cout, shape):
    x, w = _mc_case(sum(shape) + cin, 2, cin, cout, shape)
    x, w = x.to(dev), w.to(dev)
    before = cuda_conv_mc.MC_LAUNCHES.count
    got = cuda_conv_mc.conv3d_mc_same(x, w)
    assert cuda_conv_mc.MC_LAUNCHES.count == before + 1
    assert got.shape == (2, cout, *shape)
    _mc_close(got, cuda_conv_mc.conv3d_mc_same_plain(x, w), cin)
    _mc_close(got.cpu(), cuda_conv_mc.conv3d_mc_same(x.cpu(), w.cpu()), cin)


@pytest.mark.parametrize("b,cin,cout,shape", [
    (16, 256, 128, (8, 8, 8)),   # 5 K splits of 32 chunks: 6 and 7 chunks a block
    (2, 100, 64, (8, 8, 8)),     # C_in no multiple of the K step: a chunk of 4 channels
    (1, 256, 256, (4, 4, 4)),    # batch 1 in the four-sample tile, the split at its cap
    (1, 128, 256, (8, 8, 8)),    # batch 1 at 8^3
    (3, 40, 30, (6, 10, 7)),     # C_out no multiple of 8, Y no multiple of 4
    (2, 72, 100, (5, 4, 3)),     # the 64-channel tile with a ragged channel tile
    (5, 48, 64, (4, 4, 4)),      # a batch that does not fill its last four-sample tile
])
def test_conv3d_mc_tensor_core_shapes_match_plain(dev, b, cin, cout, shape):
    """The shapes the plan treats differently: every tile, the K split with
    even and ragged chunks, tiles and channel tiles that hang over the
    volume; and the same bits on a second run (no atomics anywhere)."""
    tile, k_splits = cuda_conv_mc.conv3d_mc_plan(b, cin, cout, *shape)
    assert tile != cuda_conv_mc.FMA_TILE
    x, w = _mc_case(b + cin + cout, b, cin, cout, shape)
    x, w = x.to(dev), w.to(dev)
    before = cuda_conv_mc.MC_LAUNCHES.count
    got = cuda_conv_mc.conv3d_mc_same(x, w)
    again = cuda_conv_mc.conv3d_mc_same(x, w)
    assert cuda_conv_mc.MC_LAUNCHES.count == before + 2
    _mc_close(got, cuda_conv_mc.conv3d_mc_same_plain(x, w), cin)
    assert torch.equal(got, again)
    # the kernel's own arithmetic, summed in another order
    _mc_close(got, cuda_conv_mc.conv3d_mc_same_tc_plain(x, w), cin)


def test_conv3d_mc_split_plans_are_exercised():
    """The cases above reach a K split above 1, the cap, and all four tiles."""
    plans = [cuda_conv_mc.conv3d_mc_plan(b, cin, cout, *shape) for b, cin, cout, shape in (
        (16, 256, 128, (8, 8, 8)), (1, 256, 256, (4, 4, 4)), (3, 40, 30, (6, 10, 7)),
        (2, 64, 32, (32, 32, 32)))]
    assert {t for t, _ in plans} == {0, 1, 2, 3}
    assert plans[0][1] == 5 and plans[1][1] == cuda_conv_mc.MAX_K_SPLITS


def test_conv3d_mc_dx_takes_strided_weights(dev):
    """The input gradient's weights are a flipped, transposed view: the
    kernel reads them through their strides, no copy."""
    x, w = _mc_case(11, 2, 24, 40, (6, 6, 6))
    g = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (2, 40, 6, 6, 6)).astype(np.float32)).to(dev)
    w = w.to(dev)
    view = w.flip((2, 3, 4)).transpose(0, 1)
    assert not view.is_contiguous()
    _mc_close(cuda_conv_mc.conv3d_mc_same(g, view),
              cuda_conv_mc.conv3d_mc_same_plain(g, view.contiguous()))


@pytest.mark.parametrize("cin,cout,shape", [(24, 16, (10, 10, 10)), (5, 40, (4, 7, 9))])
def test_conv3d_mc_kernel_channels_last(dev, cin, cout, shape):
    x, w = _mc_case(1, 2, cin, cout, shape, channels_last=True)
    x, w = x.to(dev), w.to(dev)
    got = cuda_conv_mc.conv3d_mc_same(x, w, channels_last=True)
    assert got.shape == (2, *shape, cout) and got.is_contiguous()
    _mc_close(got, cuda_conv_mc.conv3d_mc_same_plain(x, w, channels_last=True))
    first = cuda_conv_mc.conv3d_mc_same(x.permute(0, 4, 1, 2, 3).contiguous(), w)
    _mc_close(got.permute(0, 4, 1, 2, 3), first)


def test_conv3d_mc_kernel_over_drawn_shapes(dev):
    from hypothesis import given, settings
    from hypothesis import strategies as st

    extent = st.integers(1, 20)

    @settings(max_examples=40, deadline=None, derandomize=True)
    @given(b=st.integers(1, 3), cin=st.integers(1, 70), cout=st.integers(1, 70),
           shape=st.tuples(extent, extent, extent), last=st.booleans())
    def run(b, cin, cout, shape, last):
        x, w = _mc_case(b + cin + cout, b, cin, cout, shape, channels_last=last)
        x, w = x.to(dev), w.to(dev)
        _mc_close(cuda_conv_mc.conv3d_mc_same(x, w, channels_last=last),
                  cuda_conv_mc.conv3d_mc_same_plain(x, w, channels_last=last))

    run()


def test_conv3d_mc_kernel_unaligned_view_and_refusals(dev):
    x, w = _mc_case(2, 3, 8, 8, (4, 4, 8))
    x, w = x.to(dev), w.to(dev)
    view = x[1:]  # contiguous, but its storage starts off a 16-byte boundary of nothing
    _mc_close(cuda_conv_mc.conv3d_mc_same(view, w),
              cuda_conv_mc.conv3d_mc_same_plain(view, w))
    with pytest.raises(ValueError, match="3, 3, 3"):
        cuda_conv_mc.conv3d_mc_same(x, torch.zeros((8, 8, 3, 3, 5), device=dev))
    with pytest.raises(RuntimeError, match="fused_conv3d_mc"):
        cuda_conv_mc.conv3d_mc_same(x, w.clone().requires_grad_())


@pytest.mark.parametrize("cin,cout,shape", [(1, 32, (16, 16, 16)), (64, 32, (12, 10, 14)),
                                            (256, 128, (8, 8, 8))])
def test_fused_conv3d_mc_grads_match_autograd(dev, cin, cout, shape):
    """dx (the kernel on the flipped, swapped weights) and dw (the weight
    gradient's kernel) against autograd through the plain conv; dx is not
    launched when x needs no gradient."""
    x, w = _mc_case(7, 2, cin, cout, shape)
    g = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (2, cout, *shape)).astype(np.float32)).to(dev)
    xa, wa = x.to(dev).requires_grad_(), w.to(dev).requires_grad_()
    before = cuda_conv_mc.MC_LAUNCHES.count
    (cuda_conv_mc.fused_conv3d_mc(xa, wa) * g).sum().backward()
    assert cuda_conv_mc.MC_LAUNCHES.count == before + 2
    xb, wb = x.to(dev).requires_grad_(), w.to(dev).requires_grad_()
    (cuda_conv_mc.conv3d_mc_same_plain(xb, wb) * g).sum().backward()
    torch.testing.assert_close(xa.grad, xb.grad, rtol=1e-5, atol=2e-5)
    assert float((wa.grad - wb.grad).abs().max()) <= 1e-4 * float(wb.grad.abs().max())
    wc = w.to(dev).requires_grad_()
    before = cuda_conv_mc.MC_LAUNCHES.count
    (cuda_conv_mc.fused_conv3d_mc(x.to(dev), wc) * g).sum().backward()
    assert cuda_conv_mc.MC_LAUNCHES.count == before + 1  # forward only: no dx
    assert torch.equal(wc.grad, wa.grad)


def test_unet_on_card_kernel_backend_matches_plain_backend(dev):
    """The whole UNet at 32³, batch 4 (32 values a channel at the bottleneck:
    below that the BatchNorms make the comparison ill-conditioned):
    train-mode prediction, running statistics and gradients of backend cuda
    against backend torch (cuDNN, TF32 off)."""
    from scenenet_tpu_torch.models.unet3d import UNet3D

    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.random((4, 1, 32, 32, 32)) > 0.7).astype(np.float32)).to(dev)
    wgt = torch.from_numpy(rng.standard_normal((4, 1, 32, 32, 32)).astype(np.float32)).to(dev)
    nets = {b: UNet3D.create(seed=3, backend=b).to(dev).train() for b in ("cuda", "torch")}
    before = cuda_conv_mc.MC_LAUNCHES.count
    preds = {}
    for b, net in nets.items():
        preds[b] = net(x)
        (preds[b] * wgt).sum().backward()
    assert cuda_conv_mc.MC_LAUNCHES.count == before + 18 + 17
    torch.testing.assert_close(preds["cuda"], preds["torch"], rtol=0, atol=1e-4)
    for (n, a), b in zip(nets["cuda"].named_buffers(), nets["torch"].buffers()):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5, msg=n)
    for (n, a), b in zip(nets["cuda"].named_parameters(), nets["torch"].parameters()):
        ga, gb = a.grad.flatten().double(), b.grad.flatten().double()
        assert float(ga @ gb) >= 0.99 * float(ga.norm() * gb.norm()), n
        assert float((ga - gb).abs().max()) <= 0.25 * float(gb.abs().max()), n
    nets["cuda"].eval()
    with torch.no_grad():
        before = cuda_conv_mc.MC_LAUNCHES.count
        nets["cuda"](x)
        assert cuda_conv_mc.MC_LAUNCHES.count == before + 18


# ---- the halo conv (z_prepadded): K2 and K4 VALID in z ---------------------------

def _halo_case(dev, b, z_out, xx, yy, ks, seed):
    rng = np.random.default_rng(seed)
    x = (rng.random((b, 1, z_out + ks[0] - 1, xx, yy)) > 0.7).astype(np.float32)
    g = rng.normal(0, 1, (b, 1, z_out, xx, yy)).astype(np.float32)
    k = rng.normal(0, 0.3, ks).astype(np.float32)
    return (torch.from_numpy(a).to(dev) for a in (x, g, k))


@pytest.mark.parametrize("activation", [True, False])
@pytest.mark.parametrize("shape", [(2, 13, 16, 32), (1, 5, 37, 70), (3, 30, 9, 33)])
def test_prepadded_stencil_both_routes_match_plain(dev, shape, activation):
    """K2 with the slab's own halo planes (z_out no multiple of the 8-plane
    tile; Y a multiple of 4 or not): the unrolled and the generic kernel
    against the plain VALID-z conv, each bit-identical run to run."""
    b, z_out, xx, yy = shape
    x, _, k = _halo_case(dev, b, z_out, xx, yy, (9, 5, 5), sum(shape))
    got = cuda_conv.geneo_stencil_conv(x, k, activation=activation, z_prepadded=True)
    assert got.shape == (b, 1, z_out, xx, yy)
    want = cuda_conv.geneo_stencil_conv_plain(x, k, activation, z_prepadded=True)
    for route in ("fast", "generic"):
        a = cuda_conv._launch_stencil(x, k, activation, route, z_prepadded=True)
        assert torch.equal(a, cuda_conv._launch_stencil(x, k, activation, route, z_prepadded=True))
        torch.testing.assert_close(a, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, cuda_conv._launch_stencil(x, k, activation, "fast", z_prepadded=True))
    generic = cuda_conv.geneo_stencil_conv(x, k[:, :3, :3].contiguous(), activation,
                                           z_prepadded=True)
    torch.testing.assert_close(generic, cuda_conv.geneo_stencil_conv_plain(
        x, k[:, :3, :3], activation, z_prepadded=True), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 13, 16, 32), (1, 5, 37, 70), (3, 30, 9, 33)])
def test_prepadded_dk_both_routes_match_plain(dev, shape):
    """K4 with x's slab carrying the halo (Z + 8 planes against g's Z; z_out
    no multiple of the 4-plane tile): both kernels within 1e-4·max|dk| of
    the plain version, each bit-identical run to run; (3,3,3) generic."""
    b, z_out, xx, yy = shape
    x, g, _ = _halo_case(dev, b, z_out, xx, yy, (9, 5, 5), sum(shape) + 1)
    want = cuda_conv.stencil_dk_plain(x, g, (9, 5, 5), z_prepadded=True)
    tol = 1e-4 * float(want.abs().max())
    got = cuda_conv.stencil_dk(x, g, (9, 5, 5), z_prepadded=True)
    for route in ("fast", "generic"):
        a = cuda_conv._launch_dk(x, g, (9, 5, 5), route, z_prepadded=True)
        assert torch.equal(a, cuda_conv._launch_dk(x, g, (9, 5, 5), route, z_prepadded=True))
        assert float((a - want).abs().max()) <= tol
    assert torch.equal(got, cuda_conv._launch_dk(x, g, (9, 5, 5), "fast", z_prepadded=True))
    x3 = x[:, :, 3:-3].contiguous()  # Z + 2 planes for k_z = 3
    want3 = cuda_conv.stencil_dk_plain(x3, g, (3, 3, 3), z_prepadded=True)
    got3 = cuda_conv.stencil_dk(x3, g, (3, 3, 3), z_prepadded=True)
    assert float((got3 - want3).abs().max()) <= 1e-4 * float(want3.abs().max())


@pytest.mark.parametrize("ks", [(9, 5, 5), (3, 3, 3), (8, 6, 6)])
def test_halo_stencil_conv_grads_match_plain(dev, ks):
    """halo_stencil_conv on the card (K2 forward and dx, K4 dk; the library
    conv for dx of the even kernel) against its autograd on the CPU's plain
    versions; the slabs' outputs concatenate to the SAME conv."""
    x, g, k = _halo_case(dev, 2, 16, 12, 12, ks, sum(ks))
    outs, grads = [], []
    for d in (dev, torch.device("cpu")):
        xa = x.to(d).clone().requires_grad_()
        ka = k.to(d).clone().requires_grad_()
        out = cuda_conv.halo_stencil_conv(xa, ka, True)
        out.backward(g.to(d))
        outs.append(out.detach().cpu())
        grads.append((xa.grad.cpu(), ka.grad.cpu()))
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=1e-5)
    torch.testing.assert_close(grads[0][0], grads[1][0], rtol=0, atol=1e-5)
    assert float((grads[0][1] - grads[1][1]).abs().max()) <= 1e-4 * float(
        grads[1][1].abs().max())
    vol = (torch.rand((2, 1, 32, 16, 16), device=dev) > 0.7).float()
    lo, hi = (ks[0] - 1) // 2, ks[0] // 2
    padded = torch.nn.functional.pad(vol, (0, 0, 0, 0, lo, hi))
    slabs = [cuda_conv.geneo_stencil_conv(padded[:, :, i * 8:(i + 1) * 8 + ks[0] - 1], k,
                                          z_prepadded=True) for i in range(4)]
    torch.testing.assert_close(torch.cat(slabs, dim=2), cuda_conv.geneo_stencil_conv(vol, k),
                               rtol=0, atol=1e-6)


# ---- K10's bf16 form ---------------------------------------------------------------------

def _bf16_close(got, want, cin):
    """Both sum exact products of bf16 values in f32 and round once, so
    they part where the two f32 sums round to neighbouring bf16 values:
    within one bf16 unit of the result (at most 2^-7 of it) plus the f32
    form's tolerance for the two f32 sums' order."""
    assert got.dtype == want.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), rtol=2.0 ** -7,
                               atol=2e-5 * max(1.0, (cin / 160) ** 0.5))


UNET_LAYERS = [(1, 32, 64), (32, 32, 64), (32, 64, 32), (64, 64, 32), (64, 128, 16),
               (128, 128, 16), (128, 256, 8), (256, 256, 8), (256, 256, 4), (512, 256, 8),
               (256, 128, 8), (256, 128, 16), (128, 64, 16), (128, 64, 32), (64, 32, 32),
               (64, 32, 64)]  # the 16 distinct shapes of UNet3D's 18 convs


def _bf16_twice(x, w, cin):
    """K10's bf16 form twice on the same inputs: the same bits, within one
    bf16 unit of the plain version, counted on the bf16 form's counter."""
    before = (cuda_conv_mc.MC_BF16_LAUNCHES.count, cuda_conv_mc.MC_LAUNCHES.count)
    got = cuda_conv_mc.conv3d_mc_same(x, w)
    again = cuda_conv_mc.conv3d_mc_same(x, w)
    assert (cuda_conv_mc.MC_BF16_LAUNCHES.count, cuda_conv_mc.MC_LAUNCHES.count) == (
        before[0] + 2, before[1])
    assert torch.equal(got, again)
    _bf16_close(got, cuda_conv_mc.conv3d_mc_same_plain(x, w), cin)
    return got


@pytest.mark.parametrize("b,cin,cout,shape", [
    *((2, c, o, (n, n, n)) for c, o, n in UNET_LAYERS),
    (16, 256, 128, (8, 8, 8)), (1, 256, 256, (4, 4, 4)), (3, 40, 30, (6, 10, 7)),
    (2, 72, 100, (5, 4, 3)), (5, 48, 64, (4, 4, 4)), (2, 3, 5, (7, 6, 5)), (1, 1, 1, (1, 1, 1)),
    (2, 32, 32, (6, 6, 7)),      # Y odd: the halo rows by plain loads
    (3, 32, 64, (5, 5, 5)),      # Y odd and < 8
    (1, 24, 32, (9, 9, 12)),     # Y no multiple of 8; C_in 24: a chunk of 16 and one of 8
    (4, 100, 40, (6, 7, 6)),     # C_in 100: 7 chunks, the last of 4 channels
    (5, 17, 72, (4, 4, 4)),      # the four-sample tile over 5 samples, C_in 17
    (2, 64, 32, (8, 8, 2)),      # Y = 2
    (1, 48, 96, (3, 5, 16)),     # the 64-channel tile, Y a multiple of 16
    (2, 16, 8, (12, 3, 24)),     # Y a multiple of 8, not of 16
    (1, 1, 32, (9, 9, 9)), (2, 2, 32, (7, 5, 3)), (3, 3, 40, (6, 6, 8)), (4, 4, 64, (5, 4, 9)),
])
def test_conv3d_mc_bf16_form_matches_plain(dev, b, cin, cout, shape):
    """K10's bf16 form at the UNet's layer shapes (batch 2) and at ragged
    ones (Y odd, below 8 and no multiple of 8: the halo copied by plain
    loads, not cp.async; C_in no multiple of the 16-channel chunk; batches
    1-5; C_in 1-4): against the plain version (the bf16 values widened,
    F.conv3d in f32, rounded once), bit-identical run to run, counted on its
    own; the tensor cores past 4 input channels, the FMA kernel's bf16 form
    up to it."""
    x, w = _mc_case(b + cin + cout + sum(shape), b, cin, cout, shape)
    x, w = x.to(dev, torch.bfloat16), w.to(dev, torch.bfloat16)
    tile, _ = cuda_conv_mc.conv3d_mc_plan(b, cin, cout, *shape, bf16=True)
    assert (tile == cuda_conv_mc.FMA_TILE) == (cin <= cuda_conv_mc.FMA_MAX_C_IN)
    got = _bf16_twice(x, w, cin)
    assert got.shape == (b, cout, *shape)
    _bf16_close(got.cpu(), cuda_conv_mc.conv3d_mc_same(x.cpu(), w.cpu()), cin)


# K10 at the shapes of channel tensor parallelism (parallel/gspmd.py): a rank's conv at
# C_out/m for m = 2, 4 ("fwd"), and the dx of a column-parallel conv, whose cotangent has
# the rank's C_out/m channels ("dx"; at m = 8 the 32-wide layers' dx has 4: the FMA kernel)
TP_SHARD_SHAPES = [("fwd", 1, 16, 16), ("fwd", 32, 16, 16), ("fwd", 32, 8, 16),
                   ("fwd", 64, 16, 8), ("fwd", 256, 128, 4), ("dx", 16, 32, 16),
                   ("dx", 8, 32, 16), ("dx", 4, 32, 16), ("dx", 128, 256, 4)]


@pytest.mark.parametrize("form", ["f32", "bf16"])
@pytest.mark.parametrize("what,cin,cout,n", TP_SHARD_SHAPES)
def test_conv3d_mc_at_channel_parallel_shapes(dev, form, what, cin, cout, n):
    """Each form of K10 at a channel-TP rank's shapes (batch 2) against its
    plain version, bit-identical run to run; C_out ≤ 32 on the 32-wide
    tile, part of it empty, C_in ≤ 4 on the FMA kernel."""
    x, w = _mc_case(cin + cout + n, 2, cin, cout, (n, n, n))
    x, w = x.to(dev), w.to(dev)
    if form == "bf16":
        x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
        got = _bf16_twice(x, w, cin)
    else:
        before = cuda_conv_mc.MC_LAUNCHES.count
        got = cuda_conv_mc.conv3d_mc_same(x, w)
        assert torch.equal(got, cuda_conv_mc.conv3d_mc_same(x, w))
        assert cuda_conv_mc.MC_LAUNCHES.count == before + 2
        _mc_close(got, cuda_conv_mc.conv3d_mc_same_plain(x, w), cin)
    tile, _ = cuda_conv_mc.conv3d_mc_plan(2, cin, cout, n, n, n, bf16=form == "bf16")
    assert (tile == cuda_conv_mc.FMA_TILE) == (cin <= cuda_conv_mc.FMA_MAX_C_IN)
    assert got.shape == (2, cout, n, n, n)


@pytest.mark.parametrize("tile", sorted(cuda_conv_mc.TC_TILES))
@pytest.mark.parametrize("k_splits", [1, 2, 3, 7])
def test_conv3d_mc_bf16_form_every_tile_and_split(dev, tile, k_splits):
    """Every tile under K splits 1, 2, 3 and 7 (the last: 7 chunks of 16
    channels, one a block, the last chunk of 4 channels) on one case that
    hangs over every tile: within a unit of the plain version, the same
    bits twice."""
    x, w = _mc_case(tile + k_splits, 3, 100, 70, (6, 9, 16))
    x, w = x.to(dev, torch.bfloat16), w.to(dev, torch.bfloat16)
    want = cuda_conv_mc.conv3d_mc_same_plain(x, w)
    got = cuda_conv_mc._launch_tc(x, w, tile, k_splits)
    assert torch.equal(got, cuda_conv_mc._launch_tc(x, w, tile, k_splits))
    _bf16_close(got, want, 100)


def test_conv3d_mc_bf16_dx_takes_strided_weights(dev):
    """The input gradient's weights, flipped and transposed, through their
    strides: the packing reads the view, no copy; twice, bit-identical."""
    _, w = _mc_case(11, 2, 48, 40, (6, 6, 6))
    g = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (2, 40, 6, 7, 8)).astype(np.float32)).to(dev, torch.bfloat16)
    view = w.to(dev, torch.bfloat16).flip((2, 3, 4)).transpose(0, 1)
    assert not view.is_contiguous()
    got = _bf16_twice(g, view, 40)
    _bf16_close(got, cuda_conv_mc.conv3d_mc_same_plain(g, view.contiguous()), 40)


@pytest.mark.parametrize("cout,cin,bn", [(40, 24, 32), (64, 100, 64), (70, 33, 64)])
def test_conv3d_mc_bf16_packing_matches_its_torch_order(dev, cout, cin, bn):
    """The packing kernel alone against ``pack_bf16_fragments`` (the B
    fragments' order, held against the PTX layout on the CPU), bit for bit,
    on a contiguous and on a flipped, transposed weight view."""
    import ctypes

    from scenenet_tpu_torch.ops import _build

    _, w = _mc_case(cout, 1, cin, cout, (1, 1, 1))
    w = w.to(dev, torch.bfloat16)
    for view in (w, w.transpose(0, 1).contiguous().flip((2, 3, 4)).transpose(0, 1)):
        want = cuda_conv_mc.pack_bf16_fragments(view, bn)
        frag = torch.zeros(want.numel(), dtype=torch.int32, device=dev)
        err = _build.load().snt_conv3d_mc_pack_bf16(
            view.data_ptr(), frag.data_ptr(), cin, cout, *view.stride(), bn,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        assert err == 0
        assert torch.equal(frag.cpu(), want.reshape(-1))


@pytest.mark.parametrize("cin,cout,shape", [(64, 32, (16, 16, 16)), (256, 128, (8, 8, 8)),
                                            (1, 32, (12, 12, 12))])
def test_fused_conv3d_mc_bf16_grads(dev, cin, cout, shape):
    """The bf16 form's dx (the kernel on the flipped, swapped bf16 weights)
    against autograd through the plain version, bit-identical run to run;
    dw (cuDNN's bf16 weight gradient) within 1e-2 of max|dw| of the plain
    version's (f32 sums of bf16 products, rounded once; the smoke measured
    up to 5.1e-3 at the UNet's layers, about one bf16 unit of the largest)."""
    x, w = _mc_case(cin + cout, 2, cin, cout, shape)
    x, w = x.to(dev, torch.bfloat16), w.to(dev, torch.bfloat16)
    g = torch.randn((2, cout, *shape), device=dev).to(torch.bfloat16)
    grads = []
    for _ in range(2):
        xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
        (cuda_conv_mc.fused_conv3d_mc(xa, wa).float() * g.float()).sum().backward()
        grads.append((xa.grad, wa.grad))
    xb, wb = x.clone().requires_grad_(), w.clone().requires_grad_()
    (cuda_conv_mc.conv3d_mc_same_plain(xb, wb).float() * g.float()).sum().backward()
    assert torch.equal(grads[0][0], grads[1][0])
    _bf16_close(grads[0][0], xb.grad, cout)
    want_dw = cuda_conv_mc.conv3d_mc_weight_grad_plain(x, g)
    assert grads[0][1].dtype == torch.bfloat16
    assert float((grads[0][1].float() - want_dw.float()).abs().max()) <= \
        1e-2 * float(want_dw.float().abs().max())


def test_conv3d_mc_bf16_form_refuses_channels_last(dev):
    x = torch.zeros((1, 4, 4, 4, 8), device=dev, dtype=torch.bfloat16)
    w = torch.zeros((8, 8, 3, 3, 3), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="channels first"):
        cuda_conv_mc.conv3d_mc_same(x, w, channels_last=True)
    with pytest.raises(TypeError, match="both"):
        cuda_conv_mc.conv3d_mc_same(x.permute(0, 4, 1, 2, 3).contiguous(), w.float())


# ---- K10's weight gradient (conv3d_mc_dw) ------------------------------------------

# (batch, C_in, C_out, extent) off the UNet's layers: B = 1 and 3, a 12x10x14 volume, C
# no multiple of 8, C_in = 1, Y odd or no multiple of 4 (the 4-byte copies)
DW_RAGGED = [(1, 16, 24, (5, 9, 7)), (3, 1, 32, (12, 10, 14)), (1, 40, 30, (6, 10, 7)),
             (3, 100, 70, (12, 10, 14)), (3, 3, 3, (17, 5, 3)), (1, 1, 1, (1, 1, 1)),
             (3, 72, 100, (5, 4, 3)), (5, 48, 64, (4, 4, 4)), (1, 13, 9, (12, 10, 14)),
             (3, 8, 40, (4, 4, 4)), (2, 5, 24, (9, 12, 16))]


def _dw_case(seed, b, cin, cout, shape, dev):
    gen = torch.Generator(dev).manual_seed(seed)
    x = torch.rand((b, cin, *shape), device=dev, generator=gen)
    return x, torch.randn((b, cout, *shape), device=dev, generator=gen)


def _dw_close(got, want):
    """Sums over every voxel of the batch, in another order than the
    library's and with the split products: 1e-4 of the largest entry."""
    assert got.shape == want.shape and got.dtype == want.dtype == torch.float32
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.parametrize("b,cin,cout,shape", [
    *((2, c, o, (n, n, n)) for c, o, n in UNET_LAYERS), *DW_RAGGED])
def test_conv3d_mc_dw_kernel_matches_library(dev, b, cin, cout, shape):
    """K10's dw at the UNet's layer shapes (batch 2) and at ragged ones
    against the f32 library call (PyTorch's own kernels, cuDNN off) and the
    kernel's own arithmetic in torch; bit-identical run to run, its
    launches (the kernel, and the K split's reduction where it splits)
    counted on its own counter and on no other."""
    x, g = _dw_case(b + cin + cout, b, cin, cout, shape, dev)
    tile, splits = cuda_conv_mc.conv3d_mc_dw_plan(b, cin, cout, *shape)
    before = (cuda_conv_mc.MC_DW_LAUNCHES.count, cuda_conv_mc.MC_LAUNCHES.count)
    got = cuda_conv_mc.conv3d_mc_weight_grad(x, g)
    again = cuda_conv_mc.conv3d_mc_weight_grad(x, g)
    launches = 1 + (splits > 1)
    assert (cuda_conv_mc.MC_DW_LAUNCHES.count, cuda_conv_mc.MC_LAUNCHES.count) == (
        before[0] + 2 * launches, before[1])
    assert torch.equal(got, again)
    _dw_close(got, cuda_conv_mc.conv3d_mc_weight_grad_plain(x, g))
    _dw_close(got, cuda_conv_mc.conv3d_mc_weight_grad_tc_plain(x, g))


@pytest.mark.parametrize("tile", sorted(cuda_conv_mc.DW_TILES))
@pytest.mark.parametrize("splits", [1, 2, 3, 7])
def test_conv3d_mc_dw_every_tile_and_split(dev, tile, splits):
    """Every tile under K splits 1, 2, 3 and 7 on one case that hangs over
    every tile and channel tile (Y a multiple of 4, and Y odd: the tensor
    copies and the 4-byte ones): within 1e-4 of the library, the same bits
    twice."""
    for shape in ((6, 9, 16), (5, 7, 9)):
        x, g = _dw_case(tile + splits, 3, 20 if cuda_conv_mc.DW_TILES[tile][1] == 16 else 6,
                        40, shape, dev)
        want = cuda_conv_mc.conv3d_mc_weight_grad_plain(x, g)
        got = cuda_conv_mc._launch_dw(x, g, tile, splits)
        assert torch.equal(got, cuda_conv_mc._launch_dw(x, g, tile, splits))
        _dw_close(got, want)


@pytest.mark.parametrize("what,cin,cout,n", TP_SHARD_SHAPES)
def test_conv3d_mc_dw_at_channel_parallel_shapes(dev, what, cin, cout, n):
    """The dw at a channel-TP rank's shapes (batch 2; ``TP_SHARD_SHAPES``):
    a rank's C_out/m slice of the weights, C_out below the block's 32."""
    x, g = _dw_case(cin + cout + n, 2, cin, cout, (n, n, n), dev)
    got = cuda_conv_mc.conv3d_mc_weight_grad(x, g)
    assert torch.equal(got, cuda_conv_mc.conv3d_mc_weight_grad(x, g))
    _dw_close(got, cuda_conv_mc.conv3d_mc_weight_grad_plain(x, g))


def test_conv3d_mc_dw_takes_no_library_call_in_f32(dev, monkeypatch):
    """On the card the f32 backward of fused_conv3d_mc reaches the library's
    weight gradient nowhere; the bf16 backward still does (cuDNN bf16)."""
    real = torch.nn.grad.conv3d_weight
    calls = []
    monkeypatch.setattr(torch.nn.grad, "conv3d_weight",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    x, w = _mc_case(3, 2, 24, 40, (6, 7, 8))
    g = torch.randn((2, 40, 6, 7, 8), device=dev)
    wa = w.to(dev).requires_grad_()
    (cuda_conv_mc.fused_conv3d_mc(x.to(dev).requires_grad_(), wa) * g).sum().backward()
    assert calls == [] and wa.grad is not None
    wb = w.to(dev, torch.bfloat16).requires_grad_()
    cuda_conv_mc.fused_conv3d_mc(x.to(dev, torch.bfloat16), wb).float().sum().backward()
    assert calls == [1]


def test_conv3d_mc_dw_unaligned_view_and_refusals(dev):
    """A view whose storage starts off a 16-byte boundary takes the 4-byte
    copies; mismatched shapes and dtypes raise."""
    x, g = _dw_case(4, 3, 8, 16, (4, 4, 8), dev)
    view = torch.rand(x.numel() + 1, device=dev)[1:].view(x.shape)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    _dw_close(cuda_conv_mc.conv3d_mc_weight_grad(view, g),
              cuda_conv_mc.conv3d_mc_weight_grad_plain(view, g))
    with pytest.raises(ValueError, match="one batch"):
        cuda_conv_mc.conv3d_mc_weight_grad(x, g[:2])
    with pytest.raises(TypeError, match="both"):
        cuda_conv_mc.conv3d_mc_weight_grad(x, g.double())


# ---- the cached train step as a CUDA graph ----------------------------------------

def test_cached_fit_replays_a_graph_as_the_streamed_steps(dev, tmp_path):
    """fit_grid_cached on the card (3 warm-up steps, then one captured step
    replayed) against Trainer.fit on the same batches in the same order:
    losses rtol 1e-5, parameters 1e-5, counts equal. The wrappers count the
    eager steps' launches and the capture's; the profiler's trace shows K2
    and K4 run on the card in every step, the replays included."""
    import re
    from torch.profiler import ProfilerActivity, profile

    from scenenet_tpu_torch.data.device_cache import DeviceGridCache
    from scenenet_tpu_torch.losses import resolve_criterion
    from scenenet_tpu_torch.models import SceneNet
    from scenenet_tpu_torch.train import TrainConfig, Trainer

    rng = np.random.default_rng(0)
    grids = DeviceGridCache.__new__(DeviceGridCache)
    occ = rng.random((16, 1, 16, 16, 16)) > 0.8
    grids.x = torch.from_numpy(occ.astype(np.uint8)).to(dev)
    grids.y = torch.from_numpy((occ & (rng.random(occ.shape) > 0.7)).astype(np.uint8)).to(dev)
    crit = resolve_criterion("geneo_tversky")(convex_weight=5, tversky_alpha=2,
                                                focal_gamma=4, tversky_smooth=1e-6)

    def trainer(tag):
        net = SceneNet.create(kernel_size=(9, 5, 5), seed=3, backend="cuda").to(dev)
        return Trainer(net, crit, TrainConfig(run_dir=str(tmp_path / tag), max_epochs=2,
                                              checkpoint_dir=str(tmp_path / f"c{tag}"),
                                              early_stop_metric=None))

    cached, streamed = trainer("cached"), trainer("streamed")
    before = (cuda_conv.LAUNCHES.count, cuda_conv.DK_LAUNCHES.count)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        cached.fit_grid_cached(grids, 2, augment=False,
                               generator=torch.Generator(dev).manual_seed(5))
        torch.cuda.synchronize()
    assert (cuda_conv.LAUNCHES.count - before[0], cuda_conv.DK_LAUNCHES.count - before[1]) \
        == (3 + 1, 3 + 1)
    runs = {k: sum(e.count for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA and re.search(p, e.key))
            for k, p in (("k2", r"\bstencil(_fast)?_kernel\b"),
                         ("k4", r"\breduce_taps_kernel\b"))}
    assert runs == {"k2": 16, "k4": 16}
    assert cached.cached_epochs.runner.captured and cached.cached_epochs.runner.replays == 13
    gen = torch.Generator(dev).manual_seed(5)

    def batches():
        for _ in range(2):
            order = torch.randperm(16, generator=gen, device=dev)
            yield [(grids.x[order[i:i + 2]].float(), grids.y[order[i:i + 2]].float())
                   for i in range(0, 16, 2)]

    epochs = batches()

    class Loader:
        def __iter__(self):
            return iter(next(epochs))

    streamed.fit(Loader())
    assert cached.train_counts == streamed.train_counts
    for (n, a), b in zip(cached.model.named_parameters(), streamed.model.parameters()):
        assert float((a - b).detach().abs()) <= 1e-5, n
    losses = [[r["train_loss"] for r in map(__import__("json").loads,
                                            open(tmp_path / t / "metrics.jsonl"))]
              for t in ("cached", "streamed")]
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-5)


# ---- quantile and accumulation steps replayed from their graphs --------------------

def _grid_cache(dev, n=8, seed=0):
    from scenenet_tpu_torch.data.device_cache import DeviceGridCache

    rng = np.random.default_rng(seed)
    grids = DeviceGridCache.__new__(DeviceGridCache)
    occ = rng.random((n, 1, 16, 16, 16)) > 0.8
    grids.x = torch.from_numpy(occ.astype(np.uint8)).to(dev)
    grids.y = torch.from_numpy((occ & (rng.random(occ.shape) > 0.7)).astype(np.uint8)).to(dev)
    return grids


def _graph_vs_eager(dev, tmp_path, model_fn, criterion, epochs, **cfg):
    """fit_grid_cached on the card (its steps replayed from CUDA graphs after
    the warm-up) against the same batches in the same order through
    train_step with the cached route's capturable optimizer: losses,
    counts and parameters bit-identical."""
    from scenenet_tpu_torch.train import TrainConfig, Trainer, metrics

    grids = _grid_cache(dev)

    def trainer(tag):
        return Trainer(model_fn().to(dev), criterion,
                       TrainConfig(run_dir=str(tmp_path / tag), max_epochs=epochs,
                                   checkpoint_dir=str(tmp_path / f"c{tag}"),
                                   early_stop_metric=None, **cfg))

    graph, eager = trainer("graph"), trainer("eager")
    graph.fit_grid_cached(grids, 2, augment=False, generator=torch.Generator(dev).manual_seed(5))
    eager.setup_optimizer(capturable=True)
    gen = torch.Generator(dev).manual_seed(5)
    losses, counts = [], []
    for _ in range(epochs):
        order = torch.randperm(8, generator=gen, device=dev)
        ms, loss_sum = metrics.init_metric_state(dev), torch.zeros((), device=dev)
        for i in range(0, 8, 2):
            rows = order[i:i + 2]
            ms, loss = eager.train_step(ms, grids.x[rows].float(), grids.y[rows].float())
            loss_sum += loss
        losses.append(float(loss_sum) / 4)
        counts.append(metrics.metric_counts(ms))
    got = [r["train_loss"] for r in map(__import__("json").loads,
                                        open(tmp_path / "graph" / "metrics.jsonl"))]
    assert got == losses and graph.train_counts == counts
    for (n, a), b in zip(graph.model.named_parameters(), eager.model.parameters()):
        assert torch.equal(a, b), n
    return graph


def test_quantile_cached_fit_replays_a_graph_bit_identical(dev, tmp_path):
    """A quantile ensemble's step (K2 forward and K4 for dk once a member)
    replayed from its graph, 3 epochs of 4 steps, against eager steps."""
    from scenenet_tpu_torch.losses import resolve_criterion
    from scenenet_tpu_torch.models import QuantileSceneNet

    crit = resolve_criterion("quantile_geneo")(convex_weight=5, quantiles=(0.1, 0.5, 0.9))
    graph = _graph_vs_eager(dev, tmp_path, lambda: QuantileSceneNet.create(
        kernel_size=(9, 5, 5), seed=3, backend="cuda"), crit, epochs=3)
    runner = graph.cached_epochs.runner
    assert runner.captured and runner.replays == 12 - 3


@pytest.mark.parametrize("k", [2, 3])
def test_accumulation_cached_fit_replays_two_graphs_bit_identical(dev, tmp_path, k):
    """accumulate_grad_batches=k on the card: the accumulating step and the
    updating step each captured after their warm-up and replayed as the
    host's count names them, 4 epochs of 4 steps, against eager steps."""
    from scenenet_tpu_torch.losses import resolve_criterion
    from scenenet_tpu_torch.models import SceneNet

    crit = resolve_criterion("geneo_tversky")(convex_weight=5, tversky_alpha=2,
                                                focal_gamma=4, tversky_smooth=1e-6)
    graph = _graph_vs_eager(dev, tmp_path, lambda: SceneNet.create(
        kernel_size=(9, 5, 5), seed=3, backend="cuda"), crit, epochs=4,
        accumulate_grad_batches=k)
    epochs = graph.cached_epochs
    updates = 16 // k
    assert epochs.runner.captured and epochs.accumulate_runner.captured
    assert epochs.runner.replays == updates - 3
    assert epochs.accumulate_runner.replays == 16 - updates - 3
    assert graph.multi_steps.calls == 16 % k


def test_bf16_cached_fit_replays_a_graph_bit_identical(dev, tmp_path):
    """precision bf16 on the kernel backend (bf16 kernel synthesis, K2 and
    K4 on the widened kernel) replayed from its graph against eager steps."""
    from scenenet_tpu_torch.losses import resolve_criterion
    from scenenet_tpu_torch.models import SceneNet

    crit = resolve_criterion("geneo_tversky")(convex_weight=5, tversky_alpha=2,
                                                focal_gamma=4, tversky_smooth=1e-6)
    graph = _graph_vs_eager(dev, tmp_path, lambda: SceneNet.create(
        kernel_size=(9, 5, 5), seed=3, backend="cuda"), crit, epochs=2, precision="bf16")
    assert graph.cached_epochs.runner.replays == 8 - 3


def test_step_capture_holds_when_a_dead_graph_is_collectable_inside_it(dev):
    """While it is captured, the step drops the last reference to another
    captured step, held in a reference cycle, and allocates enough to set
    off an automatic collection: the capture holds (no collection runs in
    it) and the replays compute what the eager steps did."""
    import gc

    from scenenet_tpu_torch.train.step_graph import WARMUP, StepGraph

    def doubling(buf):
        return lambda: buf.mul_(2.0).add_(1.0)

    old = StepGraph(doubling(torch.zeros(4, device=dev)), dev)
    for _ in range(WARMUP + 1):
        old()
    assert old.graph is not None
    held, calls = [old], []
    del old
    buf = torch.zeros(4, device=dev)

    def step():
        doubling(buf)()
        calls.append(1)
        if len(calls) == WARMUP + 1:  # the capture
            box = [held.pop()]
            box.append(box)
            del box
            junk = [[] for _ in range(10 * gc.get_threshold()[0])]
            del junk

    new = StepGraph(step, dev)
    for _ in range(WARMUP + 3):
        new()
    torch.cuda.synchronize()
    assert new.graph is not None and new.replays == 3 and len(calls) == WARMUP + 1
    assert torch.equal(buf, torch.full_like(buf, 2.0 ** (WARMUP + 3) - 1))


# ---- preemption through the CUDA graphs, L-BFGS, the tuners on the card ------------

def _resume_twins(dev, tmp_path, route, **cfg):
    """A straight cached fit on the card and one preempted after the first
    chunk of epoch 0 then resumed in a new Trainer (warm-up steps at the
    restored cursor, then a graph captured on the restored buffers)."""
    from scenenet_tpu_torch.data.device_cache import DevicePointCache
    from scenenet_tpu_torch.losses import resolve_criterion
    from scenenet_tpu_torch.models import SceneNet
    from scenenet_tpu_torch.train import TrainConfig, Trainer, make_device_voxelize_prep
    from scenenet_tpu_torch.train.preempt import request_preemption

    crit = resolve_criterion("geneo_tversky")(convex_weight=5, tversky_alpha=2,
                                                focal_gamma=4, tversky_smooth=1e-6)
    if route == "grids":
        data, prep = _grid_cache(dev, n=24, seed=4), None
    else:
        rng = np.random.default_rng(6)
        data = DevicePointCache([(rng.random((512, 3)).astype(np.float32) * 10.0,
                                  rng.integers(0, 20, 512).astype(np.int32),
                                  np.ones(512, bool)) for _ in range(24)], dev)
        prep = make_device_voxelize_prep((16, 16, 16), (15,), use_indices=False)

    def fit(tag, resume=None, preempt=False):
        net = SceneNet.create(kernel_size=(9, 5, 5), seed=3, backend="cuda").to(dev)
        t = Trainer(net, crit, TrainConfig(run_dir=str(tmp_path / tag), max_epochs=3,
                                           checkpoint_dir=str(tmp_path / f"c{tag}"),
                                           early_stop_metric=None, epoch_chunks=3, **cfg),
                    batch_prep=prep)
        if preempt:
            request_preemption()
        run = t.fit_grid_cached if route == "grids" else t.fit_cached
        run(data, 4, augment=True, generator=torch.Generator(dev).manual_seed(7),
            resume_from=resume)
        torch.cuda.synchronize()
        return t

    straight = fit("s")
    killed = fit("k", preempt=True)
    assert killed.preempted
    resumed = fit("r", resume=str(tmp_path / "ck" / "preempt.npz"))
    return straight, resumed


@pytest.mark.parametrize("route,cfg", [("grids", {}), ("grids", {"accumulate_grad_batches": 2}),
                                       ("points", {}), ("points", {"accumulate_grad_batches": 2})])
def test_cached_fit_resumes_bit_identically_through_graphs(dev, tmp_path, route, cfg):
    straight, resumed = _resume_twins(dev, tmp_path, route, **cfg)
    runners = [r for r in (resumed.cached_epochs.runner, resumed.cached_epochs.accumulate_runner)
               if r is not None]
    assert all(r.captured and r.replays > 0 for r in runners)
    assert straight.train_counts[-1] == resumed.train_counts[-1]
    for (n, a), b in zip(straight.model.named_parameters(), resumed.model.parameters()):
        assert torch.equal(a, b), n


def test_lbfgs_steps_on_the_card_match_the_plain_versions(dev, tmp_path):
    """Three L-BFGS steps with the kernels (K2, K4) against the same steps
    through the plain versions on the card: the same trial counts,
    parameters rtol 1e-4."""
    from scenenet_tpu_torch.losses import resolve_criterion
    from scenenet_tpu_torch.models import SceneNet
    from scenenet_tpu_torch.train import TrainConfig, Trainer
    from scenenet_tpu_torch.train import metrics as tmetrics

    grids = _grid_cache(dev, n=6, seed=2)
    crit = resolve_criterion("focal_tversky")(tversky_alpha=2, tversky_beta=1,
                                                tversky_smooth=1e-6, focal_gamma=4)
    out = {}
    for backend in ("cuda", "torch"):
        net = SceneNet.create(kernel_size=(9, 5, 5), seed=3, backend=backend).to(dev)
        t = Trainer(net, crit, TrainConfig(run_dir=str(tmp_path / backend), optimizer="lbfgs",
                                           learning_rate=0.8, early_stop_metric=None,
                                           checkpoint_dir=str(tmp_path / f"c{backend}")))
        t.setup_optimizer()
        before = cuda_conv.DK_LAUNCHES.count
        trials = []
        for i in range(3):
            t.train_step(tmetrics.init_metric_state(dev), grids.x[2 * i:2 * i + 2].float(),
                         grids.y[2 * i:2 * i + 2].float())
            trials.append(t.optimizer.trials)
        launched = cuda_conv.DK_LAUNCHES.count - before
        out[backend] = (trials, [p.detach().clone() for p in net.parameters()], launched)
    assert out["cuda"][0] == out["torch"][0]
    assert out["cuda"][2] == 3 + sum(out["cuda"][0]) and out["torch"][2] == 0
    for a, b in zip(out["cuda"][1], out["torch"][1]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)


def test_is_oom_on_a_real_out_of_memory(dev):
    """A real torch.OutOfMemoryError is OOM-shaped, find_max_batch_size
    stops at it and frees the cache, and the next step runs."""
    from scenenet_tpu_torch.train.tune import _is_oom, find_max_batch_size

    free = torch.cuda.mem_get_info(dev)[1]
    try:
        torch.empty(2 * free, dtype=torch.uint8, device=dev)
    except Exception as e:
        assert isinstance(e, torch.OutOfMemoryError) and _is_oom(e)
    else:
        raise AssertionError("twice the card's memory was allocated")

    def probe(b):
        torch.empty(b * (1 << 30), dtype=torch.uint8, device=dev).fill_(1)

    found = find_max_batch_size(probe, start=1, max_batch=1 << 12)
    assert 1 <= found < free / (1 << 30)
    x = torch.ones(1 << 20, device=dev)
    assert float((x * 2).sum()) == 2 * (1 << 20)


def test_autotune_over_cuda_and_cuda_mxu_at_64(dev, tmp_path):
    from scenenet_tpu_torch.losses import resolve_criterion
    from scenenet_tpu_torch.models import SceneNet
    from scenenet_tpu_torch.train.tune import autotune_backend

    crit = resolve_criterion("focal_tversky")(tversky_alpha=2, tversky_beta=1,
                                                tversky_smooth=1e-6, focal_gamma=4)
    before = (cuda_conv.LAUNCHES.count, cuda_conv.MXU_LAUNCHES.count)
    winner, times = autotune_backend(
        lambda b: SceneNet.create(kernel_size=(9, 5, 5), seed=0, backend=b).to(dev), crit, 4,
        (64, 64, 64), cache_path=str(tmp_path / "autotune.json"), iters=3)
    assert winner in ("cuda", "cuda_mxu") and set(times) == {"cuda", "cuda_mxu"}
    assert all(0 < v < float("inf") for v in times.values())
    assert cuda_conv.LAUNCHES.count > before[0] and cuda_conv.MXU_LAUNCHES.count > before[1]
    assert autotune_backend(
        lambda b: SceneNet.create(kernel_size=(9, 5, 5), seed=0, backend=b).to(dev), crit, 4,
        (64, 64, 64), cache_path=str(tmp_path / "autotune.json")) == (winner, times)


# ---- A10 + A11 on the card: visualize, the imports, the exports, C6 ---------------

def _viz_dataset(root, n_test=2):
    rng = np.random.default_rng(0)
    for split, n in (("fit", 2), ("test", n_test)):
        (root / split).mkdir(parents=True)
        for i in range(n):
            m = 6000
            xyz = rng.uniform([0, 0, 0], [30, 30, 60], (m, 3))
            xyz[: m // 5, :2] = rng.normal(15, 0.6, (m // 5, 2))  # a tower's column
            labels = np.where(np.arange(m) < m // 5, 15, rng.choice([1, 2], m))
            np.save(root / split / f"sample_{i}.npy", np.column_stack([xyz, labels]))
    return str(root)


def test_visualize_on_the_card_matches_the_cpu(dev, tmp_path):
    """cli.visualize --device cuda (K2) at 64³ against --device cpu on the
    same checkpoint: the same summary (voxel counts, proposals), and the
    forward's probabilities within 1e-5."""
    from scenenet_tpu_torch.cli import visualize
    from scenenet_tpu_torch.cli.train import build_datasets, build_model
    from scenenet_tpu_torch.models import SceneNet
    from scenenet_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
    from scenenet_tpu_torch.utils.config import load_config

    data = _viz_dataset(tmp_path / "ds")
    ckpt = str(tmp_path / "ckpt.npz")
    save_checkpoint(ckpt, SceneNet.create(kernel_size=(9, 5, 5), seed=6))
    sets = [f"data_path={data}", "kernel_size=(9, 5, 5)"]
    before = cuda_conv.LAUNCHES.count
    got = visualize.main(["--set", *sets, "--checkpoint", ckpt, "--n", "2", "--out",
                          str(tmp_path / "gpu"), "--device", "cuda"])
    assert cuda_conv.LAUNCHES.count >= before + 2  # K2, a sample each
    want = visualize.main(["--set", *sets, "--checkpoint", ckpt, "--n", "2", "--out",
                           str(tmp_path / "cpu"), "--device", "cpu"])
    assert got == want
    cfg = load_config(None, {"data_path": data, "kernel_size": (9, 5, 5),
                             "device_voxelization": False})
    x = torch.from_numpy(np.asarray(build_datasets(cfg)[2][0][0], np.float32))[None]
    with torch.no_grad():
        probs = [restore_checkpoint(ckpt, build_model(cfg, d)).eval()(x.to(d)).cpu()
                 for d in (dev, torch.device("cpu"))]
    torch.testing.assert_close(probs[0], probs[1], rtol=0, atol=1e-5)


def test_imported_even_kernel_checkpoint_runs_k2_generic(dev, tmp_path):
    """A .ckpt without kernel_size imports at (9, 6, 6): on the card its
    forward takes K2's generic kernel, within 1e-5 of the plain version."""
    from scenenet_tpu_torch.compat import export_torch_state_dict, import_scenenet_params
    from scenenet_tpu_torch.models import SceneNet

    export_torch_state_dict(SceneNet.create(kernel_size=(9, 6, 6), seed=3),
                            str(tmp_path / "r.ckpt"))
    ck = torch.load(str(tmp_path / "r.ckpt"), weights_only=False)
    del ck["hyper_parameters"]["kernel_size"]
    torch.save(ck, str(tmp_path / "r.ckpt"))
    model = import_scenenet_params(str(tmp_path / "r.ckpt"), backend="cuda").to(dev)
    assert model.kernel_size == (9, 6, 6) and cuda_conv.stencil_route((9, 6, 6)) == "generic"
    x = (torch.rand(2, 1, 64, 64, 64, device=dev) > 0.95).float()
    before = cuda_conv.LAUNCHES.count
    with torch.no_grad():
        got = model(x)
        model.backend = "torch"
        want = model(x)
    assert cuda_conv.LAUNCHES.count == before + 1
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_exports_run_on_the_card_against_k2(dev, tmp_path):
    """The torch.export program and the ONNX file, loaded back and run on
    the card, within 1e-5 of the K2 forward."""
    from scenenet_tpu_torch.models import SceneNet
    from scenenet_tpu_torch.utils.export import export_forward, load_exported
    from scenenet_tpu_torch.utils.onnx_export import export_scenenet_onnx, load_onnx

    model = SceneNet.create(kernel_size=(9, 5, 5), seed=1, backend="cuda").to(dev)
    x = (torch.rand(2, 1, 64, 64, 64, device=dev) > 0.95).float()
    with torch.no_grad():
        want = model(x)
        export_forward(model, (2, 1, 64, 64, 64), str(tmp_path / "f.pt2"))
        prog = load_exported(str(tmp_path / "f.pt2"))(x)
    export_scenenet_onnx(model, (64, 64, 64), str(tmp_path / "f.onnx"))
    onnx = load_onnx(str(tmp_path / "f.onnx"))(x)
    assert prog.device.type == onnx.device.type == "cuda"
    torch.testing.assert_close(prog, want, rtol=0, atol=1e-5)
    torch.testing.assert_close(onnx, want, rtol=0, atol=1e-5)


def test_autotune_times_graph_replays(dev, tmp_path):
    """C6: on a replay route each candidate is timed by replays of its
    captured step (finite ms), filed under a key that differs from the eager
    one."""
    from scenenet_tpu_torch.losses import resolve_criterion
    from scenenet_tpu_torch.models import SceneNet
    from scenenet_tpu_torch.train import tune

    crit = resolve_criterion("geneo_tversky")()
    make = lambda b: SceneNet.create(kernel_size=(9, 5, 5), seed=0, backend=b).to(dev)  # noqa: E731
    cache = tmp_path / "autotune.json"
    winner, times = tune.autotune_backend(make, crit, 4, (64, 64, 64), optimizer="adam",
                                          cache_path=str(cache), iters=3, graph=True)
    assert winner in ("cuda", "cuda_mxu")
    assert all(0 < v < float("inf") for v in times.values())
    import json

    keys = list(json.loads(cache.read_text()))
    assert len(keys) == 1 and json.loads(keys[0])["route"] == "graph"
    eager = tune.autotune_cache_key(torch.cuda.get_device_name(dev), 4, (64, 64, 64), "adam",
                                    ("cuda", "cuda_mxu"), "", False)
    assert eager != keys[0]


# ---- A12: the mesh on gloo ranks that share the card, and NCCL on one rank ----------

def _mesh_legs():
    import os
    import sys

    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import torch_mesh_legs

    return torch_mesh_legs, here


def test_mesh_fits_on_card_match_the_single_rank_twin(dev, tmp_path):
    """2 and 4 gloo ranks on cuda:0: the grid fit, the grid cache and the
    z-sharded fit (B10's halo forms launched) against the same fits on one
    rank on the card: confusion counts exact, losses rtol 1e-5."""
    from scenenet_tpu_torch.parallel import launch

    legs, here = _mesh_legs()
    r2 = launch.run_ranks("torch_mesh_legs:card_ranks_2", 2, {"tmp": str(tmp_path / "m2")},
                          timeout=300, path=here)
    r4 = launch.run_ranks("torch_mesh_legs:card_ranks_4", 4, {"tmp": str(tmp_path / "m4")},
                          timeout=300, path=here)
    twins = {"dp": legs.fit_leg("dp", str(tmp_path / "t"), device=dev),
             "cached_grids": legs.cached_leg("grids", str(tmp_path / "t"), device=dev),
             "space": legs.fit_leg("space", str(tmp_path / "t"), device=dev)}
    for got, key in ((r2[0], "dp"), (r2[0], "cached_grids"), (r4[0], "space")):
        want = twins[key]
        assert got[key]["counts"] == want["counts"], key
        np.testing.assert_allclose([s["train_loss"] for _, s in got[key]["scores"]],
                                   [s["train_loss"] for _, s in want["scores"]], rtol=1e-5)
    assert all(r["launches"][0] > 0 and r["launches"][1] > 0 for r in r4)


def test_nccl_all_reduce_is_captured_in_a_graph(dev):
    from scenenet_tpu_torch.parallel import launch

    _, here = _mesh_legs()
    got = launch.run_ranks("torch_mesh_legs:card_nccl_rank", 1, timeout=180, path=here,
                           env={"TORCH_NCCL_ASYNC_ERROR_HANDLING": "0"})[0]
    assert got == {"eager": True, "replay": True}
