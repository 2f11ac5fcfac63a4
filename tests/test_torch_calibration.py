"""Port parity: probability calibration in torch vs the JAX package.

The same numpy predictions and labels, made from a seed, go through both
packages' temperature and Platt fits (200 and 300 plain gradient steps on
the mean BCE): the fitted scalars agree within rtol 1e-5 (f32 means over
2000–4000 values summed in another order), the recalibrated
probabilities within 1e-6.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from scenenet_tpu.utils import calibration as jcal
from scenenet_tpu_torch.losses.segmentation import binary_cross_entropy
from scenenet_tpu_torch.utils import calibration as tcal


def _overconfident(seed, n=4000):
    rng = np.random.default_rng(seed)
    p_true = np.clip(rng.random(n), 0.05, 0.95).astype(np.float32)
    y = (rng.random(n) < p_true).astype(np.float32)
    over = np.where(p_true > 0.5, p_true ** 0.25, 1 - (1 - p_true) ** 0.25)
    return np.clip(over, 0.01, 0.99).astype(np.float32), y


def _separable(seed, n=2000):
    rng = np.random.default_rng(seed)
    y = (rng.random(n) > 0.5).astype(np.float32)
    p = np.clip(0.5 + (y - 0.5) * 0.2 + rng.normal(0, 0.05, n), 0.01, 0.99)
    return p.astype(np.float32), y


@pytest.mark.parametrize("seed", [0, 1])
def test_temperature_matches_jax(seed):
    p, y = _overconfident(seed)
    t = tcal.fit_temperature(torch.from_numpy(p), torch.from_numpy(y))
    want = jcal.fit_temperature(jnp.asarray(p), jnp.asarray(y))
    assert t > 1.0  # overconfident predictions: a temperature above 1
    np.testing.assert_allclose(t, want, rtol=1e-5)
    got = tcal.apply_temperature(torch.from_numpy(p), t)
    np.testing.assert_allclose(got.numpy(), np.asarray(jcal.apply_temperature(
        jnp.asarray(p), want)), rtol=0, atol=1e-6)
    y_t = torch.from_numpy(y)
    assert (binary_cross_entropy(got, y_t).mean()
            < binary_cross_entropy(torch.from_numpy(p), y_t).mean())


@pytest.mark.parametrize("seed", [1, 2])
def test_platt_matches_jax(seed):
    p, y = _separable(seed)
    a, b = tcal.fit_platt(torch.from_numpy(p), torch.from_numpy(y))
    wa, wb = jcal.fit_platt(jnp.asarray(p), jnp.asarray(y))
    np.testing.assert_allclose([a, b], [wa, wb], rtol=1e-5, atol=1e-6)
    got = tcal.apply_platt(torch.from_numpy(p), a, b)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(jcal.apply_platt(
        jnp.asarray(p), wa, wb)), rtol=0, atol=1e-6)


def test_logit_clip_matches_jax():
    p = np.array([0.0, 1e-9, 0.5, 1.0 - 1e-9, 1.0], np.float32)
    np.testing.assert_allclose(tcal._logits(torch.from_numpy(p)).numpy(),
                               np.asarray(jcal._logits(jnp.asarray(p))), rtol=1e-6)
