"""Port parity: SceneNet and its checkpoints in torch vs the JAX package."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from scenenet_tpu.models import SceneNet as JaxSceneNet
from scenenet_tpu.ops.pallas_conv import geneo_stencil_conv as pallas_stencil
from scenenet_tpu.train import checkpoint as jckpt
from scenenet_tpu_torch.models import SceneNet
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


@pytest.mark.parametrize("backend,inference,item", [
    ("cuda", "mxu", "B2"), ("torch", "mxu_fast", "B2")])
def test_unported_forwards_raise(backend, inference, item):
    net = SceneNet.create(kernel_size=(3, 3, 3), backend=backend)
    with pytest.raises(NotImplementedError, match=item):
        net(torch.zeros((1, 1, 4, 4, 4)), inference=inference)


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
