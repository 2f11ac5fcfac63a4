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
