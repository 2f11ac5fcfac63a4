"""Port parity: the stencil conv's plain version vs the TPU kernel.

``geneo_stencil_conv`` on a CPU tensor runs its plain version
(``conv3d_same`` then relu∘tanh); it must agree with the Pallas
``geneo_stencil_conv`` in interpret mode. Both are f32 sums of the same
taps in different orders, hence atol 1e-5.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from scenenet_tpu.ops.conv3d import conv3d_same as jax_conv3d_same
from scenenet_tpu.ops.pallas_conv import geneo_stencil_conv as pallas_stencil
from scenenet_tpu_torch.ops.conv3d import conv3d_same, same_pads
from scenenet_tpu_torch.ops.cuda_conv import geneo_stencil_conv

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
