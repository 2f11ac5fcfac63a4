"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip where torch finds no CUDA device. On a machine
with a card (no jax needed there):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from scenenet_tpu_torch.ops import cuda_conv, cuda_hist
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
