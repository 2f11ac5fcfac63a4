"""Port parity: the stencil conv, its kernel gradient and their autograd
composition vs the TPU kernels.

On a CPU tensor each wrapper runs its plain version; it must agree with
the Pallas kernel in interpret mode. Both are f32 sums of the same
products in different orders: atol 1e-5 on conv outputs, and the JAX
package's own bounds (rtol 1e-4, atol 1e-3) on kernel gradients, which sum
~10⁴ products of magnitude ~1 per tap.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from scenenet_tpu.ops.conv3d import conv3d_same as jax_conv3d_same
from scenenet_tpu.ops.pallas_conv import fused_geneo_conv as jax_fused
from scenenet_tpu.ops.pallas_conv import geneo_stencil_conv as pallas_stencil
from scenenet_tpu.ops.pallas_conv import stencil_dk as pallas_dk
from scenenet_tpu_torch.ops import cuda_conv
from scenenet_tpu_torch.ops.conv3d import conv3d_same, same_pads
from scenenet_tpu_torch.ops.cuda_conv import fused_geneo_conv, geneo_stencil_conv, stencil_dk

ATOL = 1e-5


def _inputs(seed, ks, shape=(2, 16, 16, 16)):
    rng = np.random.default_rng(seed)
    x = (rng.random(shape) > 0.7).astype(np.float32)[:, None]  # {0,1} occupancy
    k = rng.normal(0, 0.3, ks).astype(np.float32)
    return x, k


@pytest.mark.parametrize("activation", [True, False])
@pytest.mark.parametrize("ks", [(9, 5, 5), (9, 6, 6), (3, 3, 3)])
def test_plain_matches_pallas_stencil(ks, activation):
    x, k = _inputs(sum(ks), ks)
    want = np.asarray(pallas_stencil(jnp.asarray(x), jnp.asarray(k),
                                     activation=activation, interpret=True))
    got = geneo_stencil_conv(torch.from_numpy(x), torch.from_numpy(k),
                             activation=activation).numpy()
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("ks", [(9, 6, 6), (4, 7, 2)])
def test_conv3d_same_matches_jax(ks):
    """Even kernels take torch's asymmetric pads (low (k-1)//2, high k//2)."""
    x, k = _inputs(1, ks, shape=(1, 10, 12, 9))
    want = np.asarray(jax_conv3d_same(jnp.asarray(x), jnp.asarray(k)[None, None]))
    got = conv3d_same(torch.from_numpy(x), torch.from_numpy(k)[None, None]).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert same_pads((9, 6, 4)) == (1, 2, 2, 3, 4, 4)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.zeros((1, 1, 8, 8, 8))
    with pytest.raises(NotImplementedError, match="B10"):
        geneo_stencil_conv(x, torch.zeros((3, 3, 3)), z_prepadded=True)
    with pytest.raises(ValueError):
        geneo_stencil_conv(torch.zeros((1, 2, 8, 8, 8)), torch.zeros((3, 3, 3)))
    with pytest.raises(TypeError):
        geneo_stencil_conv(x.double(), torch.zeros((3, 3, 3), dtype=torch.float64))


@pytest.mark.parametrize("ks,shape", [((9, 5, 5), (2, 1, 16, 16, 16)),
                                      ((9, 5, 5), (2, 1, 7, 16, 16)),
                                      ((9, 6, 6), (2, 1, 16, 16, 16))])
def test_stencil_dk_plain_matches_pallas(ks, shape):
    """Z=7 is shorter than the kernel; (9,6,6) takes the asymmetric pads."""
    rng = np.random.default_rng(5)
    x = rng.random(shape).astype(np.float32)
    g = rng.random(shape).astype(np.float32)
    want = np.asarray(pallas_dk(jnp.asarray(x), jnp.asarray(g), ks, interpret=True))
    got = stencil_dk(torch.from_numpy(x), torch.from_numpy(g), ks).numpy()
    assert got.shape == ks and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("ks", [(9, 5, 5), (9, 6, 6), (3, 3, 3)])
def test_fused_geneo_conv_grads_match_jax(ks):
    """gx and gk of the autograd Function against jax.grad of the JAX
    package's custom VJP (its XLA formulations, as its own test runs it)."""
    rng = np.random.default_rng(3)
    x = rng.random((2, 1, 16, 16, 16)).astype(np.float32)
    k = (rng.random(ks) * 0.2 - 0.1).astype(np.float32)
    gx_want, gk_want = jax.grad(lambda a, b: jnp.sum(jax_fused(a, b, True) ** 2),
                                argnums=(0, 1))(jnp.asarray(x), jnp.asarray(k))
    xt = torch.from_numpy(x).requires_grad_()
    kt = torch.from_numpy(k).requires_grad_()
    out = fused_geneo_conv(xt, kt)
    (out ** 2).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(jax_fused(jnp.asarray(x), jnp.asarray(k), True)),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_want), atol=1e-5)
    np.testing.assert_allclose(kt.grad.numpy(), np.asarray(gk_want), atol=1e-3, rtol=1e-4)


def test_fused_geneo_conv_skips_dx_for_data():
    """x is data in the train step: no dx is computed for it."""
    calls = []
    x = torch.from_numpy((np.random.default_rng(0).random((1, 1, 8, 8, 8)) > 0.7)
                         .astype(np.float32))
    k = torch.full((3, 3, 3), 0.05, requires_grad=True)
    orig = cuda_conv.geneo_stencil_conv
    try:
        cuda_conv.geneo_stencil_conv = lambda *a, **kw: calls.append(kw) or orig(*a, **kw)
        fused_geneo_conv(x, k).sum().backward()
    finally:
        cuda_conv.geneo_stencil_conv = orig
    assert x.grad is None and k.grad is not None
    assert calls == [{"activation": True}]  # the forward only


def test_dk_and_mxu_forms_raise():
    x = torch.zeros((1, 1, 8, 8, 8))
    with pytest.raises(NotImplementedError, match="B10"):
        stencil_dk(x, x, (3, 3, 3), z_prepadded=True)
    with pytest.raises(NotImplementedError, match="B2"):
        cuda_conv.fused_geneo_conv_mxu(x, torch.zeros((3, 3, 3)))
    with pytest.raises(ValueError):
        stencil_dk(x, torch.zeros((1, 1, 8, 8, 7)), (3, 3, 3))
