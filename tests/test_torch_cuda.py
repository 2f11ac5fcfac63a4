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
    before = (cuda_conv.MXU_LAUNCHES.count, cuda_conv.LAUNCHES.count)
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
    launched = (cuda_conv.MXU_LAUNCHES.count - before[0], cuda_conv.LAUNCHES.count - before[1])
    assert launched == ((convs, 0) if inference == "mxu" else (0, convs))
    for cloud, (pred, probs) in zip(clouds, out):
        ref_pred, ref_probs = cpu.predict(cloud)
        assert probs.shape == ref_probs.shape
        np.testing.assert_allclose(pred, ref_pred, rtol=0, atol=1e-5)
        np.testing.assert_allclose(probs, ref_probs, rtol=0, atol=1e-5)


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
    """dx (the kernel on the flipped, swapped weights) and dw (the library
    call) against autograd through the plain conv; dx is not launched when
    x needs no gradient."""
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
