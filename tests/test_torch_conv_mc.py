"""Port parity: the multi-channel 3³ conv in torch vs the JAX package.

The CUDA kernel cannot run here; its plain version (``F.conv3d``, TF32
off) is held against the Pallas kernel in interpret mode, at that
kernel's own test shapes and tolerance (atol 2e-5, rtol 1e-5: f32 sums of
27·C_in products in another order), and the autograd Function's dx and dw
against ``jax.grad`` of XLA's conv. What surrounds the kernel in Python
(the weight layouts it is launched with, for the forward and for dx) is
checked by summing the kernel's products in numpy-like torch code.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F
from jax import lax

from scenenet_tpu.ops.pallas_conv_mc import conv3d_mc_same as pallas_conv3d_mc
from scenenet_tpu_torch.ops import cuda_conv_mc
from scenenet_tpu_torch.ops.cuda_conv_mc import (
    conv3d_mc_same, conv3d_mc_same_plain, conv3d_mc_weight_grad, fused_conv3d_mc,
)

TOL = dict(atol=2e-5, rtol=1e-5)  # tests/test_pallas_conv_mc.py's own


def _xla(x, w):
    return lax.conv_general_dilated(
        x, w, (1, 1, 1), "SAME", dimension_numbers=("NCDHW", "OIDHW", "NCDHW"),
        preferred_element_type=jnp.float32)


def _case(cin, cout, shape, b=2, seed=None):
    rng = np.random.default_rng(sum(shape) + cin if seed is None else seed)
    x = rng.random((b, cin, *shape)).astype(np.float32)
    w = (rng.standard_normal((cout, cin, 3, 3, 3)) * 0.1).astype(np.float32)
    return x, w


@pytest.mark.parametrize("cin,cout,shape", [
    (4, 8, (6, 6, 6)),        # tiny channels
    (32, 32, (12, 12, 12)),   # shallow UNet regime
    (160, 128, (8, 8, 8)),    # deep regime
    (16, 24, (5, 9, 7)),      # non-cubic + odd extents
])
def test_plain_matches_pallas_interpret(cin, cout, shape):
    x, w = _case(cin, cout, shape)
    want = pallas_conv3d_mc(jnp.asarray(x), jnp.asarray(w), interpret=True, n_tile=256)
    got = conv3d_mc_same(torch.from_numpy(x), torch.from_numpy(w))
    assert got.shape == (2, cout, *shape) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(_xla(jnp.asarray(x), jnp.asarray(w))),
                               **TOL)


def test_channels_last_matches_pallas_interpret():
    rng = np.random.default_rng(0)
    x = rng.random((2, 10, 10, 10, 24)).astype(np.float32)
    w = (rng.standard_normal((16, 24, 3, 3, 3)) * 0.1).astype(np.float32)
    want = pallas_conv3d_mc(jnp.asarray(x), jnp.asarray(w), interpret=True, n_tile=256,
                            channels_last=True)
    got = conv3d_mc_same(torch.from_numpy(x), torch.from_numpy(w), channels_last=True)
    assert got.shape == (2, 10, 10, 10, 16) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    first = conv3d_mc_same(torch.from_numpy(x).permute(0, 4, 1, 2, 3).contiguous(),
                           torch.from_numpy(w))
    np.testing.assert_allclose(got.permute(0, 4, 1, 2, 3).numpy(), first.numpy(), **TOL)


def test_plain_matches_pallas_streamed_variant():
    """A volume past the TPU kernel's resident budget (its streamed body,
    ``_mc_kernel``): one function here serves both sizes."""
    x, w = _case(4, 16, (32, 32, 32), b=1)
    flat_bytes = 4 * 34 * 34 * 40 * 128  # the padded rows at 128 lanes, at least
    out_bytes = 4 * 43 * 1024 * 16       # 43 tiles of 1024 rows cover 32·34·40
    assert flat_bytes + out_bytes > 24 * 1024 * 1024  # the resident variant's limit
    want = pallas_conv3d_mc(jnp.asarray(x), jnp.asarray(w), interpret=True)
    got = conv3d_mc_same(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("cin,cout,shape", [(1, 32, (8, 8, 8)), (16, 24, (5, 9, 7)),
                                            (64, 32, (6, 6, 6))])
def test_fused_grads_match_jax_grad_of_xla_conv(cin, cout, shape):
    """Value, dx and dw of Σ(conv·g): dx is the conv of g with the flipped,
    channel-swapped weights, dw the library's weight gradient. Bounds:
    2e-5 + 1e-5 relative on dx (27·C_out products), 1e-4 of the largest
    entry on dw (sums over every voxel of the batch)."""
    x, w = _case(cin, cout, shape)
    g = np.random.default_rng(1).standard_normal((2, cout, *shape)).astype(np.float32)
    want_x, want_w = jax.grad(lambda a, b: jnp.sum(_xla(a, b) * g), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    tx, tw = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    out = fused_conv3d_mc(tx, tw)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(_xla(jnp.asarray(x), jnp.asarray(w))), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_x), **TOL)
    want_w = np.asarray(want_w)
    assert np.abs(tw.grad.numpy() - want_w).max() <= 1e-4 * np.abs(want_w).max()
    np.testing.assert_array_equal(
        conv3d_mc_weight_grad(torch.from_numpy(x), torch.from_numpy(g)).numpy(),
        tw.grad.numpy())


def test_fused_skips_dx_when_x_needs_no_grad(monkeypatch):
    """The first conv of a model (x is data): backward makes dw only."""
    calls = []
    real = cuda_conv_mc.conv3d_mc_same
    monkeypatch.setattr(cuda_conv_mc, "conv3d_mc_same",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    x, w = _case(1, 4, (4, 4, 4))
    tw = torch.from_numpy(w).requires_grad_()
    fused_conv3d_mc(torch.from_numpy(x), tw).sum().backward()
    assert len(calls) == 1 and tw.grad is not None
    tx = torch.from_numpy(x).requires_grad_()
    fused_conv3d_mc(tx, tw).sum().backward()
    assert len(calls) == 3 and tx.grad is not None  # forward and dx


def _sum_like_the_kernel(x, wt):
    """What the kernel computes from its launch arguments: for every input
    channel and tap, the zero-padded x shifted by the tap times the
    (C_in, 27, C_out) weights' row."""
    b, cin, z, xx, yy = x.shape
    xp = F.pad(x, (1, 1, 1, 1, 1, 1))
    out = torch.zeros((b, wt.shape[2], z, xx, yy), dtype=torch.float64)
    for tap in range(27):
        dz, dx, dy = tap // 9, (tap // 3) % 3, tap % 3
        shifted = xp[:, :, dz:dz + z, dx:dx + xx, dy:dy + yy].double()
        out += torch.einsum("bczxy,co->bozxy", shifted, wt[:, tap].double())
    return out.float()


def test_launch_layouts_forward_and_dx():
    """``_transposed`` gives the kernel (C_in, 27, C_out) rows; for dx the
    weights go in flipped on the three spatial axes with the channel axes
    swapped. Summed as the kernel sums them, both reproduce autograd."""
    x, w = _case(5, 7, (4, 6, 5))
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    wt = cuda_conv_mc._transposed(tw)
    assert wt.shape == (5, 27, 7) and wt.is_contiguous()
    np.testing.assert_allclose(_sum_like_the_kernel(tx, wt).numpy(),
                               conv3d_mc_same_plain(tx, tw).numpy(), **TOL)
    g = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 7, 4, 6, 5))
                         .astype(np.float32))
    xa = tx.clone().requires_grad_()
    (F.conv3d(xa, tw, padding=1) * g).sum().backward()
    wt_dx = cuda_conv_mc._transposed(tw.flip((2, 3, 4)).transpose(0, 1))
    assert wt_dx.shape == (7, 27, 5)
    np.testing.assert_allclose(_sum_like_the_kernel(g, wt_dx).numpy(), xa.grad.numpy(), **TOL)


@pytest.mark.parametrize("bad,exc", [
    (lambda x, w: conv3d_mc_same(x, torch.zeros((8, 4, 3, 3, 5))), ValueError),
    (lambda x, w: conv3d_mc_same(x, torch.zeros((8, 4, 1, 1, 1))), ValueError),
    (lambda x, w: conv3d_mc_same(x, torch.zeros((8, 5, 3, 3, 3))), ValueError),
    (lambda x, w: conv3d_mc_same(x[0], w), ValueError),
    (lambda x, w: conv3d_mc_same(x, w, channels_last=True), ValueError),
    (lambda x, w: conv3d_mc_same(x.double(), w), TypeError),
    (lambda x, w: conv3d_mc_same(x, w.half()), TypeError),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad, exc):
    """Kernels other than 3×3×3 raise a ValueError, as the JAX function
    asserts; so do mismatched channels, ranks and types."""
    x, w = _case(4, 8, (6, 6, 6))
    with pytest.raises(exc):
        bad(torch.from_numpy(x), torch.from_numpy(w))


def test_launch_counter_counts_only_launches():
    """On the CPU the wrapper runs the plain version and counts nothing."""
    x, w = _case(4, 8, (6, 6, 6))
    before = cuda_conv_mc.MC_LAUNCHES.count
    conv3d_mc_same(torch.from_numpy(x), torch.from_numpy(w))
    fused_conv3d_mc(torch.from_numpy(x), torch.from_numpy(w).requires_grad_()).sum().backward()
    assert cuda_conv_mc.MC_LAUNCHES.count == before
