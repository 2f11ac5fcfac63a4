"""Port parity: the training criteria in torch vs the JAX package.

The same numpy inputs go through both; values and gradients agree to 1e-5
(f32 sums over the same elements in another order). The inputs are 2×8³:
XLA's CPU reduction accumulates f32 in order, and at 2×12³ its mean of the
loss weights already strays 2.5e-5 from the float64 value, where torch's
stays within 1e-7.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from scenenet_tpu.losses import geneo_loss as jgl
from scenenet_tpu.losses import registry as jreg
from scenenet_tpu.losses import weighted_mse as jwm
from scenenet_tpu.models import SceneNet as JaxSceneNet
from scenenet_tpu_torch.losses import geneo_loss as tgl
from scenenet_tpu_torch.losses import registry as treg
from scenenet_tpu_torch.losses import weighted_mse as twm
from scenenet_tpu_torch.models import SceneNet
from scenenet_tpu_torch.train.checkpoint import params_from_jax

TOL = 1e-5
# the criterion weights of experiments/defaults.yaml
DEFAULTS = dict(weight_alpha=1, weight_epsilon=0.1, mse_weight=1, convex_weight=5,
                tversky_alpha=2, tversky_beta=1, tversky_smooth=1e-6, focal_gamma=4)


def _pred_gt(seed, shape=(2, 1, 8, 8, 8)):
    rng = np.random.default_rng(seed)
    pred = rng.random(shape).astype(np.float32)
    gt = (rng.random(shape) > 0.9).astype(np.float32)
    return pred, gt


def _value_and_grad_torch(fn, pred, gt):
    p = torch.from_numpy(pred).requires_grad_()
    loss = fn(p, torch.from_numpy(gt))
    loss.backward()
    return float(loss.detach()), p.grad.numpy()


def _value_and_grad_jax(fn, pred, gt):
    v, g = jax.value_and_grad(lambda p: fn(p, jnp.asarray(gt)))(jnp.asarray(pred))
    return float(v), np.asarray(g)


def test_weighting_table_is_the_jax_packages():
    for a, b in zip(twm.load_weighting_scheme(), jwm.load_weighting_scheme()):
        np.testing.assert_array_equal(a, b)
    y = np.random.default_rng(0).random(1000)
    for a, b in zip(twm.hist_frequency_estimation(y), jwm.hist_frequency_estimation(y)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("freqs", [None, (3, 5, 2, 7, 40, 41, 42, 43, 44, 45)])
def test_dens_target_lookup_and_substitution_quirk(freqs):
    """Nearest range start, and the in-place substitution in index order:
    with freqs (3, 5, 2, 7, …) index 0 → 3 → 7 and index 2 → 2 → 7."""
    jw = jwm.WeightedMSE.create(**{k: v for k, v in DEFAULTS.items()
                                   if k in ("weight_alpha", "weight_epsilon", "mse_weight")})
    tw = twm.WeightedMSE.create(weight_alpha=1, weight_epsilon=0.1, mse_weight=1)
    if freqs is not None:
        jw = jwm.WeightedMSE(freqs=freqs, ranges=jw.ranges)
        tw = twm.WeightedMSE(freqs=freqs, ranges=tw.ranges)
    y = np.random.default_rng(1).random((4, 50)).astype(np.float32)
    y[0, :4] = [0.0, 1.0, 0.05, 0.95]  # ties and the ends
    got = tw.dens_target(torch.from_numpy(y)).numpy()
    want = np.asarray(jw.dens_target(jnp.asarray(y)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    np.testing.assert_allclose(tw.weight_target(torch.from_numpy(y)).numpy(),
                               np.asarray(jw.weight_target(jnp.asarray(y))), rtol=TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_weighted_mse_value_and_grad(seed):
    pred, gt = _pred_gt(seed)
    t = twm.WeightedMSE.create(**DEFAULTS)
    j = jwm.WeightedMSE.create(**DEFAULTS)
    tv, tg = _value_and_grad_torch(t, pred, gt)
    jv, jg = _value_and_grad_jax(j, pred, gt)
    np.testing.assert_allclose(tv, jv, rtol=TOL)
    np.testing.assert_allclose(tg, jg, rtol=TOL, atol=1e-9)


@pytest.mark.parametrize("name", ["tversky", "focal_tversky"])
@pytest.mark.parametrize("seed", [0, 2])
def test_tversky_losses_value_and_grad(name, seed):
    pred, gt = _pred_gt(seed)
    t = treg.resolve_criterion(name)(**DEFAULTS)
    j = jreg.resolve_criterion(name)(**DEFAULTS)
    tv, tg = _value_and_grad_torch(t, pred, gt)
    jv, jg = _value_and_grad_jax(j, pred, gt)
    np.testing.assert_allclose(tv, jv, rtol=TOL)
    np.testing.assert_allclose(tg, jg, rtol=TOL, atol=1e-12)


def _perturbed(seed):
    """JAX params with a negative λ and a negative GENEO scalar, so that both
    hinge penalties are active."""
    jnet, jparams = JaxSceneNet.create(kernel_size=(9, 5, 5), seed=seed)
    free = [ln for ln in jnet.lambda_names if ln != jnet.last_lambda]
    jparams = jax.tree.map(lambda v: v, jparams)
    jparams["lambdas"][free[0]] = jnp.float32(-0.2)
    jparams["geneo"]["cy_0"]["sigma"] = jnp.float32(-0.3)
    return jnet, jparams


@pytest.mark.parametrize("name", ["geneo", "geneo_tversky"])
@pytest.mark.parametrize("seed", [0, 4])
def test_geneo_losses_value_and_param_grads(name, seed):
    """The whole criterion on a SceneNet forward, with the penalties read
    from the live parameters: value and every parameter's gradient."""
    jnet, jparams = _perturbed(seed)
    net = SceneNet.create(kernel_size=(9, 5, 5), seed=seed)
    net.load_state_dict(params_from_jax(jparams))
    rng = np.random.default_rng(seed)
    x = (rng.random((2, 1, 8, 8, 8)) > 0.8).astype(np.float32)
    gt = (rng.random(x.shape) > 0.95).astype(np.float32)
    jcrit = jreg.resolve_criterion(name)(**DEFAULTS)
    tcrit = treg.resolve_criterion(name)(**DEFAULTS)

    def jloss(p):
        return jcrit(jnet.apply(p, jnp.asarray(x)), jnp.asarray(gt),
                     jnet.cvx_coefficients(p), jnet.geneo_params_flat(p), jnet.last_lambda)

    jv, jg = jax.value_and_grad(jloss)(jparams)
    loss = tcrit(net(torch.from_numpy(x)), torch.from_numpy(gt), net.cvx_coefficients(),
                 net.geneo_params_flat(), net.last_lambda)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jv), rtol=TOL)
    jflat = {".".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
             for path, v in jax.tree_util.tree_flatten_with_path(jg)[0]}
    for pname, p in net.named_parameters():
        if not p.requires_grad:
            # frozen in the port; the JAX gradient there is 0 (apex is
            # floored and detached, λ_last cancels in the penalty)
            assert float(jflat[pname]) == 0.0, pname
            continue
        np.testing.assert_allclose(p.grad.numpy(), jflat[pname], rtol=TOL, atol=TOL,
                                   err_msg=pname)


def test_penalties_match():
    jnet, jparams = _perturbed(1)
    net = SceneNet.create(kernel_size=(9, 5, 5), seed=1)
    net.load_state_dict(params_from_jax(jparams))
    got = tgl.cvx_loss(net.cvx_coefficients(), net.last_lambda, 5.0).item()
    want = float(jgl.cvx_loss(jnet.cvx_coefficients(jparams), jnet.last_lambda, 5.0))
    assert got > 0
    np.testing.assert_allclose(got, want, rtol=1e-6)
    got = tgl.positive_regularizer(net.geneo_params_flat(), 5.0).item()
    want = float(jgl.positive_regularizer(jnet.geneo_params_flat(jparams), 5.0))
    assert got > 0
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert set(net.geneo_params_flat()) == set(jnet.geneo_params_flat(jparams))
    assert float(tgl.cvx_loss({}, None)) == 0.0 == float(tgl.positive_regularizer({}))


@pytest.mark.parametrize("name", ["dice", "dice_bce", "geneo_dice", "geneo_dice_bce",
                                  "quantile", "quantile_geneo"])
def test_unported_criteria_raise(name):
    assert name in jreg.CRITERION_REGISTRY
    with pytest.raises(NotImplementedError, match="A9"):
        treg.resolve_criterion(name)


def test_unknown_criterion_raises():
    with pytest.raises(NotImplementedError):
        treg.resolve_criterion("nope")
