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
from scenenet_tpu.losses import segmentation as jseg
from scenenet_tpu.losses import weighted_mse as jwm
from scenenet_tpu.models import QuantileSceneNet as JaxQuantileSceneNet
from scenenet_tpu.models import SceneNet as JaxSceneNet
from scenenet_tpu_torch.losses import geneo_loss as tgl
from scenenet_tpu_torch.losses import quantile as tq
from scenenet_tpu_torch.losses import registry as treg
from scenenet_tpu_torch.losses import segmentation as tseg
from scenenet_tpu_torch.losses import weighted_mse as twm
from scenenet_tpu_torch.models import QuantileSceneNet, SceneNet
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


@pytest.mark.parametrize("name,seed", [
    (name, seed) for name in ("geneo", "geneo_tversky", "geneo_dice") for seed in (0, 4)
] + [("geneo_dice_bce", 1), ("geneo_dice_bce", 4)])
def test_geneo_losses_value_and_param_grads(name, seed):
    """The whole criterion on a SceneNet forward, with the penalties read
    from the live parameters: value and every parameter's gradient.

    The BCE term's gradient is −w/p at a positive target: where p is near 0
    it multiplies the packages' ~1e-7 forward difference (kernel synthesis)
    into a relative gradient difference of 1e-7/p (seed 0 has p = 4.3e-4 at
    a tower voxel: 2e-3). So a BCE criterion runs on draws whose positive
    predictions are all ≥ 1e-2, and asserts that first."""
    jnet, jparams = _perturbed(seed)
    net = SceneNet.create(kernel_size=(9, 5, 5), seed=seed)
    net.load_state_dict(params_from_jax(jparams))
    rng = np.random.default_rng(seed)
    x = (rng.random((2, 1, 8, 8, 8)) > 0.8).astype(np.float32)
    gt = (rng.random(x.shape) > 0.95).astype(np.float32)
    jcrit = jreg.resolve_criterion(name)(**DEFAULTS)
    tcrit = treg.resolve_criterion(name)(**DEFAULTS)
    if name.endswith("bce"):
        pred = np.asarray(jnet.apply(jparams, jnp.asarray(x)))
        assert pred[(gt == 1) & (pred > 0)].min() >= 1e-2

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


QUANTILES = (0.1, 0.5, 0.9)
PORTED_SINCE_A9 = ("dice", "dice_bce", "geneo_dice", "geneo_dice_bce", "quantile",
                   "quantile_geneo")


def _criterion_kwargs(name):
    return dict(DEFAULTS, quantiles=QUANTILES) if name.startswith("quantile") else DEFAULTS


@pytest.mark.parametrize("name", PORTED_SINCE_A9)
def test_unported_criteria_raise(name):
    """These six criteria raised once (ROADMAP A9); since ported, each one's
    value and gradient against the JAX class on the same seeded tensors (a
    quantile prediction is (B, Q, ...) against a (B, 1, ...) target)."""
    assert name in jreg.CRITERION_REGISTRY and name in treg.CRITERION_REGISTRY
    t = treg.resolve_criterion(name)(**_criterion_kwargs(name))
    j = jreg.resolve_criterion(name)(**_criterion_kwargs(name))
    pred, gt = _pred_gt(7, (2, len(QUANTILES) if name.startswith("quantile") else 1, 8, 8, 8))
    gt = gt[:, :1]
    tv, tg = _value_and_grad_torch(t, pred, gt)
    jv, jg = _value_and_grad_jax(j, pred, gt)
    assert np.isfinite(tv) and np.abs(tg).max() > 0
    np.testing.assert_allclose(tv, jv, rtol=TOL)
    np.testing.assert_allclose(tg, jg, rtol=TOL, atol=1e-9)


def test_registry_names_are_the_jax_packages():
    assert set(treg.CRITERION_REGISTRY) == set(jreg.CRITERION_REGISTRY)


@pytest.mark.parametrize("name,kw", [
    ("BinaryDiceLoss", dict(reduction="sum")), ("BinaryDiceLoss", dict(reduction="none", p=1.0)),
    ("FocalLoss", dict()), ("FocalLoss", dict(reduction="sum", focal_gamma=3.0)),
    ("FocalLoss", dict(reduction="none")), ("IoULoss", dict()),
    ("IoULoss", dict(smooth=1e-3)),
])
def test_segmentation_losses_value_and_grad(name, kw):
    """The classes the registry does not name, and the reductions it does
    not pick: value (summed where it is a vector) and gradient."""
    pred, gt = _pred_gt(3)
    t, j = getattr(tseg, name)(**kw), getattr(jseg, name)(**kw)
    tv, tg = _value_and_grad_torch(lambda p, y: t(p, y).sum(), pred, gt)
    jv, jg = _value_and_grad_jax(lambda p, y: j(p, y).sum(), pred, gt)
    np.testing.assert_allclose(tv, jv, rtol=TOL)
    np.testing.assert_allclose(tg, jg, rtol=TOL, atol=1e-9)


def test_binary_cross_entropy_clamps_as_torch():
    """The log terms stop at −100 at p = 0 and 1, as torch.nn.BCELoss; the
    values equal the JAX function's and torch's own loss."""
    pred = np.array([0.0, 1.0, 0.3, 1e-30, 0.999], np.float32)
    gt = np.array([1.0, 0.0, 1.0, 1.0, 0.0], np.float32)
    got = tseg.binary_cross_entropy(torch.from_numpy(pred), torch.from_numpy(gt)).numpy()
    np.testing.assert_allclose(got, np.asarray(jseg.binary_cross_entropy(pred, gt)), rtol=1e-6)
    np.testing.assert_allclose(got, torch.nn.functional.binary_cross_entropy(
        torch.from_numpy(pred), torch.from_numpy(gt), reduction="none").numpy(), rtol=1e-6)
    assert got[0] == got[1] == 100.0


def test_quantile_loss_takes_squeezed_targets_and_refuses_mesh_axes():
    t = treg.resolve_criterion("quantile")(quantiles=QUANTILES)
    j = jreg.resolve_criterion("quantile")(quantiles=QUANTILES)
    pred, gt = _pred_gt(11, (2, 3, 8, 8, 8))
    gt = gt[:, 0]  # (B, Z, X, Y)
    got = float(t(torch.from_numpy(pred), torch.from_numpy(gt)))
    np.testing.assert_allclose(got, float(j(jnp.asarray(pred), jnp.asarray(gt))), rtol=TOL)
    # mesh axes are ported (A12): outside a mesh's ranks they are refused
    with pytest.raises(RuntimeError, match="no mesh is active"):
        tq.QuantileLoss(w_mse=t.w_mse, axis_names=("data",))(torch.from_numpy(pred),
                                                             torch.from_numpy(gt))


@pytest.mark.parametrize("seed", [0, 3])
def test_quantile_geneo_penalties_over_members(seed):
    """QuantileGENEOLoss on a QuantileSceneNet forward, the penalties summed
    over the members' lists: value and every member's parameter gradients."""
    jnet, jparams = JaxQuantileSceneNet.create(kernel_size=(9, 5, 5), seed=seed,
                                               quantiles=QUANTILES)
    # one negative λ and one negative GENEO scalar in member 1: both hinges active
    free = [ln for ln in jnet.net.lambda_names if ln != jnet.last_lambda][0]
    jparams["lambdas"][free] = jparams["lambdas"][free].at[1].set(-0.2)
    jparams["geneo"]["cy_0"]["sigma"] = jparams["geneo"]["cy_0"]["sigma"].at[1].set(-0.3)
    net = QuantileSceneNet.create(kernel_size=(9, 5, 5), seed=seed, quantiles=QUANTILES)
    net.load_stacked_state(params_from_jax(jparams))
    rng = np.random.default_rng(seed)
    x = (rng.random((2, 1, 8, 8, 8)) > 0.8).astype(np.float32)
    gt = (rng.random(x.shape) > 0.95).astype(np.float32)
    jcrit = jreg.resolve_criterion("quantile_geneo")(**_criterion_kwargs("quantile"))
    tcrit = treg.resolve_criterion("quantile_geneo")(**_criterion_kwargs("quantile"))

    def jloss(p):
        return jcrit(jnet.apply(p, jnp.asarray(x)), jnp.asarray(gt), jnet.cvx_coefficients(p),
                     jnet.geneo_params_flat(p), jnet.last_lambda)

    jv, jg = jax.value_and_grad(jloss)(jparams)
    loss = tcrit(net(torch.from_numpy(x)), torch.from_numpy(gt), net.cvx_coefficients(),
                 net.geneo_params_flat(), net.last_lambda)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jv), rtol=TOL)
    jflat = {".".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
             for path, v in jax.tree_util.tree_flatten_with_path(jg)[0]}
    for q, member in enumerate(net.members):
        for pname, p in member.named_parameters():
            if not p.requires_grad:  # member 0's structure: frozen in every member
                assert float(jflat[pname][q]) == 0.0, (q, pname)
                continue
            np.testing.assert_allclose(p.grad.numpy(), jflat[pname][q], rtol=TOL, atol=TOL,
                                       err_msg=f"{q} {pname}")


def test_unknown_criterion_raises():
    with pytest.raises(NotImplementedError):
        treg.resolve_criterion("nope")


def test_geneo_penalties_sum_over_a_quantile_ensembles_members():
    """A GENEO criterion given a quantile ensemble's lists (one dict a
    member) sums the members' penalties, as QuantileGENEOLoss does, so
    model=quantile trains with the default criterion too (the JAX package's
    GENEO criteria take dicts only and raise on the lists)."""
    jnet, jparams = JaxQuantileSceneNet.create(kernel_size=(9, 5, 5), seed=2,
                                               quantiles=QUANTILES)
    free = [ln for ln in jnet.net.lambda_names if ln != jnet.last_lambda][0]
    jparams["lambdas"][free] = jparams["lambdas"][free].at[2].set(-0.4)
    net = QuantileSceneNet.create(kernel_size=(9, 5, 5), seed=2, quantiles=QUANTILES)
    net.load_stacked_state(params_from_jax(jparams))
    crit = treg.resolve_criterion("geneo_tversky")(**DEFAULTS)
    got = crit.penalties(net.cvx_coefficients(), net.geneo_params_flat(), net.last_lambda)
    want = sum(float(jgl.cvx_loss(c, jnet.last_lambda, 5.0) + jgl.positive_regularizer(g, 5.0))
               for c, g in zip(jnet.cvx_coefficients(jparams), jnet.geneo_params_flat(jparams)))
    assert want > 0
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    pred, gt = _pred_gt(5, (2, 3, 8, 8, 8))
    loss = crit(torch.from_numpy(pred), torch.from_numpy(gt[:, :1]), net.cvx_coefficients(),
                net.geneo_params_flat(), net.last_lambda)
    assert torch.isfinite(loss) and float(loss) > float(got)
