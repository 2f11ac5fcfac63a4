"""Port parity: SceneNet and its checkpoints in torch vs the JAX package."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import scenenet_tpu.ops.pallas_conv as jax_pc
from scenenet_tpu.models import QuantileSceneNet as JaxQuantileSceneNet
from scenenet_tpu.models import SceneNet as JaxSceneNet
from scenenet_tpu.ops.pallas_conv import geneo_stencil_conv as pallas_stencil
from scenenet_tpu.train import checkpoint as jckpt
from scenenet_tpu_torch.models import QuantileSceneNet, SceneNet
from scenenet_tpu_torch.ops import cuda_conv
from scenenet_tpu_torch.ops.voxelize import prob_to_label
from scenenet_tpu_torch.train import checkpoint as tckpt

ATOL = 1e-5  # f32 conv: the same taps summed in another order


def _jax_flat(params):
    return {k: np.asarray(v) for k, v in tckpt._flatten(params).items()}


def _port_flat(net):
    return tckpt._flatten(net)


def _occupancy(seed, shape=(2, 16, 16, 16)):
    """~10% occupied, like a voxelized LiDAR crop. The kernels' f32 sums
    (the neg-sphere mean shift) round differently in XLA and torch by
    ~2e-7 per tap, and every occupied tap adds that to the conv."""
    rng = np.random.default_rng(seed)
    return (rng.random(shape) > 0.9).astype(np.float32)[:, None]


@pytest.mark.parametrize("version,ks,seed", [
    ("v2", (9, 5, 5), 0), ("v2", (9, 6, 6), 3), ("v1", (9, 9, 9), 7)])
def test_create_draws_identical_params(version, ks, seed):
    jnet, jparams = JaxSceneNet.create(kernel_size=ks, version=version, seed=seed)
    net = SceneNet.create(kernel_size=ks, version=version, seed=seed)
    assert net.last_lambda == jnet.last_lambda
    assert net.observers == jnet.observers
    got, want = _port_flat(net), _jax_flat(jparams)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(net.effective_lambdas().detach().numpy(),
                                  np.asarray(jnet.effective_lambdas(jparams)))
    assert net.trainable_mask() == jax.tree.map(bool, jnet.trainable_mask(jparams))
    for name, p in net.named_parameters():
        path = name.split(".")
        mask = net.trainable_mask()
        for key in path:
            mask = mask[key]
        assert p.requires_grad == mask, name


@pytest.mark.parametrize("ks", [(9, 5, 5), (9, 6, 6)])
def test_jax_checkpoint_gives_same_forward(tmp_path, ks):
    """A checkpoint the JAX package wrote loads into the port (npz and
    params_from_jax) and computes the JAX forward: the XLA apply and the
    Pallas stencil (interpret mode) on the folded kernel."""
    jnet, jparams = JaxSceneNet.create(kernel_size=ks, seed=0)
    # trained-looking values, so loading is what makes the two agree
    jparams = jax.tree.map(lambda v: v * 1.1 + 0.01, jparams)
    path = str(tmp_path / "jax_ckpt.npz")
    jckpt.save_checkpoint(path, jparams, {"step": 1})
    x = _occupancy(sum(ks))

    want_xla = np.asarray(jnet.apply(jparams, jnp.asarray(x)))
    combined = jnp.sum(jnet.effective_lambdas(jparams)[:, None, None, None]
                       * jnet.synthesize_kernels(jparams), axis=0)
    want_stencil = np.asarray(pallas_stencil(jnp.asarray(x), combined, activation=True,
                                             interpret=True))

    via_npz = tckpt.restore_checkpoint(path, SceneNet.create(kernel_size=ks, seed=0,
                                                             backend="cuda"))
    via_tree = SceneNet.create(kernel_size=ks, seed=0)
    via_tree.load_state_dict(tckpt.params_from_jax(jparams))
    with torch.no_grad():
        got_cuda = via_npz(torch.from_numpy(x), inference=True).numpy()
        got_torch = via_tree(torch.from_numpy(x)).numpy()
        mask = via_npz(torch.from_numpy(x), inference=True, tau=0.5).numpy()
    for got in (got_cuda, got_torch):
        np.testing.assert_allclose(got, want_xla, rtol=0, atol=ATOL)
        np.testing.assert_allclose(got, want_stencil, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(mask, (got_cuda >= 0.5).astype(np.float32))


def test_port_checkpoint_loads_in_jax(tmp_path):
    net = SceneNet.create(kernel_size=(9, 5, 5), seed=11)
    path = str(tmp_path / "port.npz")
    tckpt.save_checkpoint(path, net, {"step": 2})
    jnet, template = JaxSceneNet.create(kernel_size=(9, 5, 5), seed=0)
    restored = jckpt.restore_checkpoint(path, template)
    want = _port_flat(net)
    for k, v in _jax_flat(restored).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


def test_restore_rejects_missing_and_misshapen(tmp_path):
    net = SceneNet.create(kernel_size=(9, 5, 5), seed=0)
    flat = tckpt._flatten(net)
    missing = dict(flat)
    missing.pop("geneo/cy_0/radius")
    np.savez(tmp_path / "missing.npz", **missing)
    with pytest.raises(KeyError):
        tckpt.restore_checkpoint(str(tmp_path / "missing.npz"), net)
    flat["lambdas/lambda_cy_0"] = np.zeros(2, np.float32)
    np.savez(tmp_path / "shape.npz", **flat)
    with pytest.raises(ValueError):
        tckpt.restore_checkpoint(str(tmp_path / "shape.npz"), net)


def test_torch_backend_grads_match_jax():
    """The plain backend is differentiable: parameter gradients of a
    weighted output sum agree with jax.grad of the XLA apply."""
    jnet, jparams = JaxSceneNet.create(kernel_size=(9, 5, 5), seed=2)
    net = SceneNet.create(kernel_size=(9, 5, 5), seed=2)
    x = _occupancy(9, shape=(1, 12, 12, 12))
    w = np.random.default_rng(1).normal(size=x.shape).astype(np.float32)

    jgrad = jax.grad(lambda p: jnp.sum(jnet.apply(p, jnp.asarray(x)) * w))(jparams)
    torch.sum(net(torch.from_numpy(x)) * torch.from_numpy(w)).backward()
    jflat = _jax_flat(jgrad)
    for name, p in net.named_parameters():
        key = name.replace(".", "/")
        got = p.grad.numpy() if p.grad is not None else np.zeros((), np.float32)
        np.testing.assert_allclose(got, jflat[key], rtol=1e-4, atol=1e-4, err_msg=key)


@pytest.mark.parametrize("backend,inference", [
    ("cuda", "mxu"), ("torch", "mxu_fast"), ("torch", "mxu"), ("cuda_mxu", True)])
def test_unported_forwards_raise(backend, inference):
    """Once refusals, now routes: "mxu"/"mxu_fast" on every backend, and
    inference=True on backend cuda_mxu, reach the tensor-core stencil with
    split = (inference != "mxu_fast") and no gradient."""
    net = SceneNet.create(kernel_size=(9, 5, 5), seed=1, backend=backend)
    x = torch.from_numpy(_occupancy(4, shape=(1, 12, 12, 12)))
    got = net(x, inference=inference)
    with torch.no_grad():
        want = cuda_conv.geneo_stencil_conv_mxu_plain(
            x, net.combined_kernel(), split=inference != "mxu_fast")
    assert torch.equal(got, want) and not got.requires_grad
    with pytest.raises(ValueError, match="backend"):
        SceneNet.create(kernel_size=(3, 3, 3), backend="pallas_mxu")


@pytest.mark.parametrize("backend,inference", [
    ("torch", False), ("torch", True), ("cuda", False), ("cuda", True),
    ("cuda_mxu", False), ("cuda_mxu", True), ("cuda", "mxu"), ("torch", "mxu"),
    ("cuda", "mxu_fast")])
def test_forward_tau_equals_prob_to_label(backend, inference):
    """forward(tau=τ) is prob_to_label(forward(...), τ) on every route, the
    ones that fuse the threshold into the stencil included."""
    net = SceneNet.create(kernel_size=(9, 5, 5), seed=0, backend=backend)
    x = torch.from_numpy(_occupancy(37, shape=(1, 16, 16, 16)))
    with torch.no_grad():
        probs = net(x, inference=inference)
        mask = net(x, inference=inference, tau=0.65)
    assert torch.equal(mask, prob_to_label(probs, 0.65))
    assert mask.dtype == torch.float32 and 0 < int(mask.sum()) < mask.numel()


def test_backend_cuda_mxu_routes_training_through_fused_mxu(monkeypatch):
    from scenenet_tpu_torch.models import scenenet as port_scenenet

    calls = []
    orig = cuda_conv.fused_geneo_conv_mxu
    monkeypatch.setattr(port_scenenet, "fused_geneo_conv_mxu",
                        lambda x, k: calls.append("fused_mxu") or orig(x, k))
    net = SceneNet.create(kernel_size=(9, 5, 5), seed=2, backend="cuda_mxu")
    x = torch.from_numpy(_occupancy(5, shape=(1, 12, 12, 12)))
    out = net(x)
    out.sum().backward()
    assert calls == ["fused_mxu"] and out.requires_grad
    assert all(p.grad is not None for p in net.parameters() if p.requires_grad)
    ref = SceneNet.create(kernel_size=(9, 5, 5), seed=2)(x)
    # split bf16 against f32: the JAX tests' bound for that pair
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                               atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("ks", [(9, 5, 5), (9, 6, 6)])
def test_inference_mxu_matches_jax_apply(monkeypatch, ks):
    """net(x, inference="mxu") / "mxu_fast" against the JAX
    ``apply(..., inference=...)`` on the pallas backend (its kernel in
    interpret mode), at LiDAR-like occupancy; the fused τ-masks may differ
    only inside the 1e-5 band of τ."""
    orig = jax_pc.geneo_stencil_conv_mxu
    monkeypatch.setattr(jax_pc, "geneo_stencil_conv_mxu",
                        lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))
    jnet, jparams = JaxSceneNet.create(kernel_size=ks, seed=3, backend="pallas")
    net = SceneNet.create(kernel_size=ks, seed=3, backend="cuda")
    x = _occupancy(sum(ks) + 1)
    for inference in ("mxu", "mxu_fast"):
        want = np.asarray(jnet.apply(jparams, jnp.asarray(x), inference=inference))
        jmask = np.asarray(jnet.apply(jparams, jnp.asarray(x), inference=inference, tau=0.65))
        got = net(torch.from_numpy(x), inference=inference).numpy()
        mask = net(torch.from_numpy(x), inference=inference, tau=0.65).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
        assert not ((mask != jmask) & (np.abs(want - 0.65) > ATOL)).any()
    f32 = net(torch.from_numpy(x), inference=True).numpy()
    np.testing.assert_allclose(net(torch.from_numpy(x), inference="mxu").numpy(), f32,
                               atol=2e-4, rtol=1e-4)


# ---- QuantileSceneNet ----------------------------------------------------------

QUANTILES = (0.1, 0.3, 0.5, 0.9)


def _stacked(model):
    return {k.replace(".", "/"): v.numpy() for k, v in model.stacked_state().items()}


def test_quantile_create_draws_identical_stacked_params():
    jmodel, jparams = JaxQuantileSceneNet.create(kernel_size=(9, 5, 5), quantiles=QUANTILES,
                                                 seed=4)
    model = QuantileSceneNet.create(kernel_size=(9, 5, 5), quantiles=QUANTILES, seed=4)
    assert model.last_lambda == jmodel.last_lambda and model.quantiles == QUANTILES
    got, want = _stacked(model), _jax_flat(jparams)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == (len(QUANTILES),)
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert model.trainable_mask() == jax.tree.map(bool, jmodel.trainable_mask(jparams))
    for m in model.members:  # every member has member 0's frozen set
        assert not m.lambdas[model.last_lambda].requires_grad
    for q, (cvx, flat) in enumerate(zip(model.cvx_coefficients(), model.geneo_params_flat())):
        jc, jf = jmodel.cvx_coefficients(jparams)[q], jmodel.geneo_params_flat(jparams)[q]
        assert {k: float(v.detach()) for k, v in cvx.items()} == \
            {k: float(v) for k, v in jc.items()}
        assert {k: float(v.detach()) for k, v in flat.items()} == \
            {k: float(v) for k, v in jf.items()}


@pytest.mark.parametrize("inference", [False, "mxu"])
def test_quantile_forward_matches_jax(monkeypatch, inference):
    """(B, Q, Z, X, Y) after params_from_jax, on the plain route and on
    the tensor-core route (the JAX kernel in interpret mode)."""
    orig = jax_pc.geneo_stencil_conv_mxu
    monkeypatch.setattr(jax_pc, "geneo_stencil_conv_mxu",
                        lambda *a, **kw: orig(*a, **{**kw, "interpret": True}))
    backend = "pallas" if inference else "xla"
    jmodel, jparams = JaxQuantileSceneNet.create(kernel_size=(9, 5, 5), quantiles=QUANTILES,
                                                 seed=6, backend=backend)
    # trained-looking values, so loading is what makes the two agree. XLA and
    # torch round the synthesized kernels ~2e-7 apart, and on the tensor-core
    # route such a step can move a tap's bf16 residual by one unit
    # (2⁻¹⁷·|k|): parity holds to 1e-5 at this draw, not at every one
    jparams = jax.tree.map(lambda v: v * 0.95, jparams)
    # the seed fixes the structure (which λ is derived); the values are loaded
    model = QuantileSceneNet.create(kernel_size=(9, 5, 5), quantiles=QUANTILES, seed=6,
                                    backend="cuda" if inference else "torch")
    assert model.last_lambda == jmodel.last_lambda
    model.load_stacked_state(tckpt.params_from_jax(jparams))
    x = _occupancy(12)
    want = np.asarray(jmodel.apply(jparams, jnp.asarray(x), inference=inference))
    with torch.no_grad():
        got = model(torch.from_numpy(x), inference=inference).numpy()
    assert got.shape == want.shape == (2, len(QUANTILES), 16, 16, 16)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert np.abs(got[:, 0] - got[:, 1]).max() > 1e-3  # the members differ


def test_quantile_checkpoint_round_trips_both_ways(tmp_path):
    jmodel, jparams = JaxQuantileSceneNet.create(kernel_size=(9, 5, 5), seed=8)
    jckpt.save_checkpoint(str(tmp_path / "jax.npz"), jparams)
    model = tckpt.restore_checkpoint(str(tmp_path / "jax.npz"),
                                     QuantileSceneNet.create(kernel_size=(9, 5, 5), seed=0))
    want = _jax_flat(jparams)
    for k, v in _stacked(model).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    tckpt.save_checkpoint(str(tmp_path / "port.npz"), model, {"step": 3})
    _, template = JaxQuantileSceneNet.create(kernel_size=(9, 5, 5), seed=1)
    restored = _jax_flat(jckpt.restore_checkpoint(str(tmp_path / "port.npz"), template))
    assert restored.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(restored[k], want[k], err_msg=k)
    # a single SceneNet's checkpoint has no Q axis: refused by shape
    tckpt.save_checkpoint(str(tmp_path / "single.npz"), SceneNet.create(kernel_size=(9, 5, 5)))
    with pytest.raises(ValueError, match="shape"):
        tckpt.restore_checkpoint(str(tmp_path / "single.npz"), model)


@pytest.mark.parametrize("ks", [(9, 5, 5), (9, 6, 6)])
def test_cuda_backend_trains_like_torch_backend(ks):
    """backend="cuda" with inference=False is the training forward
    (fused_geneo_conv: on CPU tensors its plain forward and dk); output and
    every parameter gradient match the plain backend and jax.grad."""
    jnet, jparams = JaxSceneNet.create(kernel_size=ks, seed=5)
    x = _occupancy(6, shape=(2, 12, 12, 12))
    w = np.random.default_rng(8).normal(size=x.shape).astype(np.float32)
    jgrad = _jax_flat(jax.grad(
        lambda p: jnp.sum(jnet.apply(p, jnp.asarray(x)) * w))(jparams))
    grads = {}
    for backend in ("cuda", "torch"):
        net = SceneNet.create(kernel_size=ks, seed=5, backend=backend)
        out = net(torch.from_numpy(x))
        torch.sum(out * torch.from_numpy(w)).backward()
        grads[backend] = {n: p.grad for n, p in net.named_parameters()}
        assert out.requires_grad
    for name, g in grads["cuda"].items():
        if g is None:  # frozen: apex and λ_last
            assert grads["torch"][name] is None and float(jgrad[name.replace(".", "/")]) == 0
            continue
        np.testing.assert_allclose(g.numpy(), grads["torch"][name].numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
        np.testing.assert_allclose(g.numpy(), jgrad[name.replace(".", "/")],
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def test_loss_plumbing_matches_jax():
    jnet, jparams = JaxSceneNet.create(kernel_size=(9, 5, 5), seed=3)
    net = SceneNet.create(kernel_size=(9, 5, 5), seed=3)
    cvx = {k: float(v.detach()) for k, v in net.cvx_coefficients().items()}
    assert cvx == {k: float(v) for k, v in jnet.cvx_coefficients(jparams).items()}
    flat = {k: float(v.detach()) for k, v in net.geneo_params_flat().items()}
    assert flat == {k: float(v) for k, v in jnet.geneo_params_flat(jparams).items()}
    assert net.parameters_in_dict() == pytest.approx(jnet.parameters_in_dict(jparams),
                                                     abs=1e-7)
    assert net.num_trainable_params() == jnet.num_trainable_params(jparams) == 11
    assert net.num_total_params() == jnet.num_total_params(jparams) == 13
