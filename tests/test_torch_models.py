"""Port parity: UNet3D, CnnBaseline and SceneNetClassifier in torch vs the
JAX package, from weights carried over with ``params_from_jax``.

Sizes: the UNet at its full channel ladder on a 16³ grid and on an odd
(20, 18, 22) one (the pools floor, ``_pad_to`` pads unevenly), batch 2;
the CNNs on 12³. The same inputs, made with numpy from a seed, go through
both packages. Tolerances are stated where they are used; the UNet's come
from 18 convs of up to 27·512 products and as many BatchNorms, whose
batch variance flax takes as E[x²] − E[x]² and torch in two passes.
"""

import json
import math
import shutil

import numpy as np
import pytest

import flax.linen as fnn
import jax
import jax.numpy as jnp
import torch

from scenenet_tpu.losses import resolve_criterion as jax_criterion
from scenenet_tpu.models import SceneNetClassifier as JaxSceneNetClassifier
from scenenet_tpu.models.cnn_baseline import CnnBaseline as JaxCnnBaseline
from scenenet_tpu.models.cnn_baseline import CnnBaseline2 as JaxCnnBaseline2
from scenenet_tpu.models.unet3d import UNet3D as JaxUNet3D
from scenenet_tpu.train import TrainConfig as JaxTrainConfig
from scenenet_tpu.train import Trainer as JaxTrainer
from scenenet_tpu.train import checkpoint as jckpt
from scenenet_tpu.train import metrics as jmetrics
from scenenet_tpu.train.state import create_train_state
from scenenet_tpu_torch.cli import train as tcli
from scenenet_tpu_torch.losses import resolve_criterion
from scenenet_tpu_torch.models import (
    CnnBaseline, CnnBaseline2, QuantileSceneNet, SceneNet, SceneNetClassifier, UNet3D,
)
from scenenet_tpu_torch.models.unet3d import BLOCKS, FlaxBatchNorm
from scenenet_tpu_torch.train import TrainConfig, Trainer
from scenenet_tpu_torch.train import checkpoint as tckpt
from scenenet_tpu_torch.train import metrics as tmetrics
from scenenet_tpu_torch.utils.config import ExperimentConfig

DEFAULTS = dict(weight_alpha=1, weight_epsilon=0.1, mse_weight=1, convex_weight=5,
                tversky_alpha=2, tversky_beta=1, tversky_smooth=1e-6, focal_gamma=4)


def _occupancy(seed, shape, density=0.3):
    rng = np.random.default_rng(seed)
    return (rng.random(shape) < density).astype(np.float32)[:, None]


def _flat(tree):
    return {k.replace("/", "."): np.asarray(v) for k, v in tckpt._flatten(tree).items()}


def _varied(variables, seed):
    """The JAX UNet's initial variables with BN scale, bias and running
    statistics moved off 1 and 0, so that a swapped or dropped one shows."""
    rng = np.random.default_rng(seed)

    def move(path, leaf):
        name = path[-1].key
        if name in ("scale", "var"):
            return jnp.asarray(rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32))
        if name in ("bias", "mean"):
            return jnp.asarray(rng.normal(0, 0.1, leaf.shape).astype(np.float32))
        return leaf

    return jax.tree_util.tree_map_with_path(move, variables)


@pytest.fixture(scope="module")
def jax_unet():
    model, variables = JaxUNet3D.create(seed=0, input_shape=(1, 1, 16, 16, 16))
    return model, _varied(variables, 1)


def _port_unet(variables, backend="torch"):
    net = UNet3D(backend=backend)
    return tckpt.load_module_state(net, tckpt.params_from_jax(variables))


# ---- BatchNorm ----------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 5, 4, 6, 3), (8, 8, 1, 1, 1)])
def test_flax_batchnorm_matches_flax(shape):
    """Train mode: the normalised batch and the new running statistics
    (momentum 0.99, biased variance); eval mode: the running statistics.
    1e-5 on values of magnitude ~1 (the two variance formulas), 1e-6 on the
    statistics."""
    rng = np.random.default_rng(0)
    x = rng.normal(0.3, 2.0, shape).astype(np.float32)
    c = shape[1]
    variables = {"params": {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                            "bias": rng.normal(0, 0.1, c).astype(np.float32)},
                 "batch_stats": {"mean": rng.normal(0, 0.1, c).astype(np.float32),
                                 "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}}
    xl = jnp.moveaxis(jnp.asarray(x), 1, -1)
    want, upd = fnn.BatchNorm(use_running_average=False).apply(
        variables, xl, mutable=["batch_stats"])
    want_eval = fnn.BatchNorm(use_running_average=True).apply(variables, xl)
    bn = FlaxBatchNorm(c)
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(variables["params"]["scale"]))
        bn.bias.copy_(torch.from_numpy(variables["params"]["bias"]))
        bn.mean.copy_(torch.from_numpy(variables["batch_stats"]["mean"]))
        bn.var.copy_(torch.from_numpy(variables["batch_stats"]["var"]))
    bn.eval()
    got_eval = bn(torch.from_numpy(x))
    np.testing.assert_allclose(got_eval.detach().numpy(),
                               np.moveaxis(np.asarray(want_eval), -1, 1), atol=1e-5, rtol=1e-5)
    bn.train()
    got = bn(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.moveaxis(np.asarray(want), -1, 1),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(bn.mean.numpy(), np.asarray(upd["batch_stats"]["mean"]),
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(bn.var.numpy(), np.asarray(upd["batch_stats"]["var"]),
                               atol=1e-6, rtol=1e-6)
    # the gradient through the batch statistics, with a random cotangent
    g = rng.standard_normal(shape).astype(np.float32)
    gl = jnp.moveaxis(jnp.asarray(g), 1, -1)
    want_g = jax.grad(lambda p, a: jnp.sum(fnn.BatchNorm(use_running_average=False).apply(
        {"params": p, "batch_stats": variables["batch_stats"]}, a,
        mutable=["batch_stats"])[0] * gl), argnums=(0, 1))(variables["params"], xl)
    xt = torch.from_numpy(x).requires_grad_()
    (bn(xt) * torch.from_numpy(g)).sum().backward()
    for got_g, w in ((xt.grad.numpy(), np.moveaxis(np.asarray(want_g[1]), -1, 1)),
                     (bn.scale.grad.numpy(), np.asarray(want_g[0]["scale"])),
                     (bn.bias.grad.numpy(), np.asarray(want_g[0]["bias"]))):
        assert np.abs(got_g - w).max() <= 1e-4 * np.abs(w).max()
    # not torch's BatchNorm3d: that one stores the unbiased variance
    n = x.size // c
    unbiased = 0.99 * variables["batch_stats"]["var"] + 0.01 * x.var((0, 2, 3, 4)) * n / (n - 1)
    assert np.abs(bn.var.numpy() - unbiased).max() > 1e-5


# ---- UNet3D -------------------------------------------------------------------

def test_unet_structure_and_create():
    """The ladder, the parameter count, flax's initial values (lecun-normal
    kernels, zero bias, BN 1/0, statistics 0/1) and the seed."""
    _, variables = JaxUNet3D.create(seed=0, input_shape=(1, 1, 16, 16, 16))
    want = _flat(variables)
    net = UNet3D.create(seed=0)
    got = {k: v.numpy() for k, v in net.flax_state().items()}
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == np.float32, k
    assert sum(p.numel() for p in net.parameters()) == sum(
        v.size for k, v in want.items() if k.startswith("params."))
    assert net.is_stateful and net.cvx_coefficients() == {} and net.geneo_params_flat() == {}
    for name in BLOCKS:
        block = getattr(net, name)
        for w, bn in ((block.conv0, block.bn0), (block.conv1, block.bn1)):
            fan_in = w[0].numel()
            std = float(w.detach().std())
            assert abs(std * math.sqrt(fan_in) - 1.0) < 0.1, (name, std)  # variance 1/fan_in
            assert float(w.abs().max()) <= 2 * math.sqrt(1 / fan_in) / 0.87962566103423978 + 1e-6
            assert torch.equal(bn.scale, torch.ones_like(bn.scale)) and not bn.bias.any()
            assert not bn.mean.any() and torch.equal(bn.var, torch.ones_like(bn.var))
    assert not net.out.bias.any()
    again, other = UNet3D.create(seed=0), UNet3D.create(seed=1)
    assert torch.equal(again.down2.conv1, net.down2.conv1)
    assert not torch.equal(other.down2.conv1, net.down2.conv1)
    # the bf16 model (A13, ported since): flax's initial values whatever the dtype
    half = UNet3D.create(seed=0, dtype=torch.bfloat16)
    assert half.dtype == torch.bfloat16 and half.down2.conv1.dtype == torch.float32
    assert torch.equal(half.down2.conv1, net.down2.conv1)
    with pytest.raises(ValueError, match="dtype"):
        UNet3D(dtype=torch.float16)
    with pytest.raises(ValueError, match="backend"):
        UNet3D(backend="cuda_mxu")


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("shape", [(2, 16, 16, 16), (2, 20, 18, 22)])
def test_unet_eval_matches_jax(jax_unet, shape, backend):
    """Eval mode (running statistics): probabilities within 2e-5."""
    model, variables = jax_unet
    x = _occupancy(sum(shape), shape)
    want = model.apply(variables, jnp.asarray(x))
    net = _port_unet(variables, backend).eval()
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    assert got.shape == (shape[0], 1, *shape[1:]) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)
    assert 0 < float(got.min()) and float(got.max()) < 1 and float(got.std()) > 1e-3


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("shape", [(2, 16, 16, 16), (2, 20, 18, 22)])
def test_unet_train_mode_matches_jax(jax_unet, shape, backend):
    """Train mode: the prediction normalised by the batch, and the running
    statistics it leaves. At the 1³ bottleneck a channel's batch is 2
    values, normalised to about ±1 whatever their distance: a rounding of
    the conv before it is amplified by 1/distance. Probabilities within
    5e-4 (most within 1e-5), statistics within 1e-5 + 1e-4 relative."""
    model, variables = jax_unet
    x = _occupancy(sum(shape) + 1, shape)
    want, upd = model.apply(variables, jnp.asarray(x), train=True)
    net = _port_unet(variables, backend).train()
    got = net(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=5e-4, rtol=0)
    stats = {k: v.numpy() for k, v in net.flax_state().items() if k.startswith("batch_stats")}
    want_stats = _flat({"batch_stats": upd["batch_stats"]})
    assert set(stats) == set(want_stats) and len(stats) == 36
    before = _flat({"batch_stats": variables["batch_stats"]})
    for k, v in want_stats.items():
        np.testing.assert_allclose(stats[k], v, atol=1e-5, rtol=1e-4, err_msg=k)
        assert np.abs(v - before[k]).max() > 1e-4, k  # the statistics did move


def test_unet_gradients_match_jax(jax_unet):
    """Σ pred·w with a random w, in eval mode: the gradient of every
    parameter against jax.grad, within 1e-4 of its largest entry, on the
    kernel backend's path (the autograd Function's dx and dw through every
    conv, the pools, the upsampling, ``_pad_to`` and the concat). In train
    mode the same comparison is ill-conditioned at this size (a channel of
    the 1³ bottleneck normalises 2 values; the port's own f32 and f64
    gradients differ by 1-4% there): the BatchNorm's own gradient is held in
    ``test_flax_batchnorm_matches_flax`` and the train-mode network in the
    trainer tests below, at a size where it is well-conditioned."""
    model, variables = jax_unet
    x = _occupancy(5, (2, 16, 16, 16))
    wgt = np.random.default_rng(3).standard_normal(x.shape).astype(np.float32)
    params, state = model.split_variables(variables)
    want = _flat({"params": jax.grad(
        lambda p: jnp.sum(model.apply_eval(p, state, jnp.asarray(x)) * wgt))(params)})
    net = _port_unet(variables, "cuda").eval()
    (net(torch.from_numpy(x)) * torch.from_numpy(wgt)).sum().backward()
    grads = {"params.out.kernel": net.out.weight.grad.permute(2, 3, 4, 1, 0),
             "params.out.bias": net.out.bias.grad}
    for name in BLOCKS:
        block = getattr(net, name)
        for i, (w, bn) in enumerate(((block.conv0, block.bn0), (block.conv1, block.bn1))):
            grads[f"params.{name}.Conv_{i}.kernel"] = w.grad.permute(2, 3, 4, 1, 0)
            grads[f"params.{name}.BatchNorm_{i}.scale"] = bn.scale.grad
            grads[f"params.{name}.BatchNorm_{i}.bias"] = bn.bias.grad
    assert set(grads) == set(want)
    for k, v in want.items():
        scale = np.abs(v).max()
        assert scale > 0, k
        assert np.abs(grads[k].numpy() - v).max() <= 1e-4 * scale, k


# ---- CnnBaseline ----------------------------------------------------------------

@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("ks", [(9, 5, 5), (3, 3, 3), (4, 2, 3)])
def test_cnn_baseline_matches_jax(ks, backend):
    """Two biased convs, channel sum, relu∘tanh; even kernels take the
    asymmetric SAME pads. 1e-5 on outputs in [0, 1)."""
    model, params = JaxCnnBaseline.create(conv_num=3, kernel_size=ks, seed=2,
                                          input_shape=(1, 1, 12, 12, 12))
    rng = np.random.default_rng(3)
    params = jax.tree.map(lambda a: a + rng.normal(0, 0.05, a.shape).astype(np.float32), params)
    x = _occupancy(4, (2, 12, 12, 12))
    want = model.apply(params, jnp.asarray(x))
    net = CnnBaseline(3, ks, True, backend)
    tckpt.load_module_state(net, tckpt.params_from_jax(params))
    xt = torch.from_numpy(x)
    got = net(xt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=0)
    assert float(got.max()) > 0.05
    want_g = _flat(jax.grad(lambda p: jnp.sum(model.apply(p, jnp.asarray(x)) ** 2))(params))
    (got ** 2).sum().backward()
    for i, (w, bias) in enumerate(zip(net.weights, net.biases)):
        for got_g, key in ((w.grad.permute(2, 3, 4, 1, 0), f"Conv_{i}.kernel"),
                           (bias.grad, f"Conv_{i}.bias")):
            scale = np.abs(want_g[key]).max()
            assert np.abs(got_g.numpy() - want_g[key]).max() <= 1e-4 * scale, key
    assert net.cvx_coefficients() == {} and net.geneo_params_flat() == {}


def test_cnn_baseline2_and_create():
    model, params = JaxCnnBaseline2(seed=1)
    x = _occupancy(6, (2, 12, 12, 12))
    net = CnnBaseline2(seed=1)
    assert (net.conv_num, net.kernel_size, net.two_layers) == (1, (3, 2, 2), False)
    assert {k: v.shape for k, v in net.flax_state().items()} == \
        {k: v.shape for k, v in _flat(params).items()}
    assert not net.biases[0].any() and float(net.weights[0].std()) > 0
    tckpt.load_module_state(net, tckpt.params_from_jax(params))
    np.testing.assert_allclose(net(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(model.apply(params, jnp.asarray(x))), atol=1e-5, rtol=0)
    a, b = CnnBaseline.create(seed=3), CnnBaseline.create(seed=3)
    assert torch.equal(a.weights[1], b.weights[1]) and len(a.weights) == 2
    assert a.weights[0].shape == (3, 1, 9, 9, 9) and a.weights[1].shape == (3, 3, 9, 9, 9)


# ---- SceneNetClassifier -----------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 4])
def test_classifier_create_and_hard_output(seed):
    ks = (9, 5, 5)
    model, params = JaxSceneNetClassifier.create(kernel_size=ks, seed=seed)
    net = SceneNetClassifier.create(kernel_size=ks, seed=seed)
    assert float(net.tau.detach()) == float(params["tau"]) and 0 <= float(net.tau) <= 0.4
    got, want = _flat(net), _flat(params)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert net.last_lambda == model.last_lambda and net.tau.requires_grad
    assert net.trainable_mask()["tau"] is True
    assert net.parameters_in_dict()["tau"] == pytest.approx(float(params["tau"]))
    x = _occupancy(seed, (2, 16, 16, 16), 0.1)
    probs = np.asarray(model.net.apply(params, jnp.asarray(x)))
    hard = net(torch.from_numpy(x))
    want_hard = np.asarray(model.apply(params, jnp.asarray(x)))
    assert set(np.unique(hard.numpy())) <= {0.0, 1.0} and not hard.requires_grad
    # equal but where a probability is within the conv's 1e-5 of tau
    off = (hard.numpy() != want_hard) & (np.abs(probs - float(params["tau"])) > 1e-5)
    assert not off.any() and 0 < hard.sum() < hard.numel()
    for hook in ("cvx_coefficients", "geneo_params_flat"):
        want_hook = getattr(model, hook)(params)
        got_hook = getattr(net, hook)()
        assert set(got_hook) == set(want_hook)
        for k, v in want_hook.items():
            assert float(got_hook[k].detach()) == float(v), k


def test_classifier_straight_through_matches_jax():
    """The straight-through value equals the hard grid; its gradient is the
    slope-50 sigmoid's, to τ and to the net's parameters (rtol 1e-3 of each
    scalar: f32 sums over 8192 voxels)."""
    ks = (9, 5, 5)
    model, params = JaxSceneNetClassifier.create(kernel_size=ks, seed=4)
    params = {**params, "tau": jnp.asarray(0.3, jnp.float32)}
    net = SceneNetClassifier.create(kernel_size=ks, seed=4)
    with torch.no_grad():
        net.tau.fill_(0.3)
    x = _occupancy(9, (2, 16, 16, 16), 0.1)
    wgt = np.random.default_rng(1).random((2, 1, 16, 16, 16)).astype(np.float32)
    want_v, want_g = jax.value_and_grad(lambda p: jnp.sum(
        model.apply(p, jnp.asarray(x), straight_through=True) * wgt))(params)
    out = net(torch.from_numpy(x), straight_through=True)
    assert torch.equal(out.detach(), net(torch.from_numpy(x)))
    v = (out * torch.from_numpy(wgt)).sum()
    v.backward()
    np.testing.assert_allclose(float(v.detach()), float(want_v), rtol=1e-5)
    want_g = _flat(want_g)
    assert abs(want_g["tau"]) > 1e-3
    for name, p in net.named_parameters():
        if not p.requires_grad:
            continue
        np.testing.assert_allclose(float(p.grad), want_g[name], rtol=1e-3, atol=1e-5,
                                   err_msg=name)


# ---- checkpoints -------------------------------------------------------------------

def test_unet_checkpoint_crosses_both_ways(jax_unet, tmp_path):
    """port → JAX → port: the flax names and layouts, running statistics
    included; ``num_batches_tracked`` or any torch-only name is no part of it."""
    try:
        _, variables = jax_unet
        net = _port_unet(variables)
        tckpt.save_checkpoint(str(tmp_path / "port.npz"), net)
        with np.load(tmp_path / "port.npz") as data:
            keys = set(data.files)
        assert keys == {k.replace(".", "/") for k in _flat(variables)}
        assert "params/down0/Conv_0/kernel" in keys and "batch_stats/up3/BatchNorm_1/var" in keys
        _, template = JaxUNet3D.create(seed=5, input_shape=(1, 1, 16, 16, 16))
        restored = jckpt.restore_checkpoint(str(tmp_path / "port.npz"), template)
        want = _flat(variables)
        for k, v in _flat(restored).items():
            np.testing.assert_array_equal(v, want[k], err_msg=k)
        jckpt.save_checkpoint(str(tmp_path / "jax.npz"), restored)
        back = tckpt.restore_checkpoint(str(tmp_path / "jax.npz"), UNet3D.create(seed=9))
        for (n, a), b in zip(back.state_dict().items(), net.state_dict().values()):
            assert torch.equal(a, b), n
        x = torch.from_numpy(_occupancy(0, (1, 16, 16, 16)))
        with torch.no_grad():
            assert torch.equal(back.eval()(x), net.eval()(x))
        with pytest.raises(KeyError):
            tckpt.restore_checkpoint(str(tmp_path / "jax.npz"), CnnBaseline.create())
        with pytest.raises(KeyError, match="unexpected"):
            net.load_flax_state({**net.flax_state(), "params.down9.Conv_0.kernel": torch.zeros(1)})
    finally:
        # two 52 MB checkpoints: leave nothing behind
        shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.mark.parametrize("ks,two", [((9, 5, 5), True), ((3, 2, 2), False)])
def test_cnn_checkpoint_crosses_both_ways(ks, two, tmp_path):
    net = CnnBaseline.create(conv_num=3, kernel_size=ks, seed=2, two_layers=two)
    with torch.no_grad():
        for bias in net.biases:
            bias.normal_(0, 0.1)
    tckpt.save_checkpoint(str(tmp_path / "port.npz"), net)
    _, template = JaxCnnBaseline.create(conv_num=3, kernel_size=ks, seed=7, two_layers=two,
                                        input_shape=(1, 1, 12, 12, 12))
    restored = jckpt.restore_checkpoint(str(tmp_path / "port.npz"), template)
    assert restored["Conv_0"]["kernel"].shape == (*ks, 1, 3)
    x = _occupancy(1, (2, 12, 12, 12))
    model = JaxCnnBaseline(3, ks, two)
    np.testing.assert_allclose(net(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(model.apply(restored, jnp.asarray(x))), atol=1e-5,
                               rtol=0)
    jckpt.save_checkpoint(str(tmp_path / "jax.npz"), restored)
    back = tckpt.restore_checkpoint(str(tmp_path / "jax.npz"),
                                    CnnBaseline(3, ks, two))
    for (n, a), b in zip(back.state_dict().items(), net.state_dict().values()):
        assert torch.equal(a, b), n


# ---- the trainer --------------------------------------------------------------------

GRID = (16, 16, 16)   # the CLI runs
FIT_GRID = (32, 32, 32)
FIT_BATCH = 4
LR = 1e-2


@pytest.fixture(scope="module")
def grids():
    """Three (x, y) batches of occupancy and tower grids: 32³, batch 4, so
    that a channel of the 2³ bottleneck normalises 32 values. (At 16³ and
    batch 2 it normalises 2, which come out as ±1 whatever they were: the
    gradient through that is rounding noise, and two f32 trainers part
    ways within three steps.)"""
    out = []
    for i in range(3):
        x = _occupancy(10 + i, (FIT_BATCH, *FIT_GRID), 0.2)
        y = x * _occupancy(20 + i, (FIT_BATCH, *FIT_GRID), 0.3)
        out.append((x, y))
    return out


def _jax_unet_steps(optimizer, grids, tmp, lr=LR):
    model, variables = JaxUNet3D.create(seed=0, input_shape=(1, 1, *GRID))
    config = JaxTrainConfig(run_dir=str(tmp / "run"), checkpoint_dir=str(tmp / "ckpt"),
                            optimizer=optimizer, learning_rate=lr, early_stop_metric=None,
                            max_epochs=1)
    trainer = JaxTrainer(model, jax_criterion("geneo_tversky")(**DEFAULTS), config)
    params, model_state = model.split_variables(variables)
    state, tx = create_train_state(params, optimizer, lr, None)
    state = state.replace(model_state=model_state)
    step, _ = trainer._build_steps(tx)
    losses, counts = [], []
    for x, y in grids:
        state, m, loss, _ = step(state, jmetrics.init_metric_state(), jnp.asarray(x),
                                 jnp.asarray(y))
        losses.append(float(loss))
        counts.append(jmetrics.metric_counts(m))
    return variables, losses, counts, _flat({"params": state.params, **state.model_state})


@pytest.fixture(scope="module")
def jax_sgd_steps(grids, tmp_path_factory):
    return _jax_unet_steps("sgd", grids, tmp_path_factory.mktemp("jax_unet_sgd"))


def _port_unet_trainer(variables, backend, optimizer, tmp_path, lr=LR, **cfg):
    net = _port_unet(variables, backend)
    cfg.setdefault("checkpoint_top_k", 1)  # a UNet checkpoint is 52 MB
    config = TrainConfig(run_dir=str(tmp_path / f"run_{backend}"),
                         checkpoint_dir=str(tmp_path / f"ckpt_{backend}"), optimizer=optimizer,
                         learning_rate=lr, early_stop_metric=None, **cfg)
    return Trainer(net, resolve_criterion("geneo_tversky")(**DEFAULTS), config)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_three_unet_sgd_steps_match_jax(backend, grids, jax_sgd_steps, tmp_path):
    """Three SGD steps on the UNet against the JAX Trainer. Losses rtol
    2e-4; confusion counts equal at the first step and within 32 of 131072
    voxels after (predictions a rounding from τ); each tensor's three-step
    update within 25% of its largest entry and at cosine ≥ 0.99 of the JAX
    update, all parameters together at cosine ≥ 0.999 (train-mode
    gradients through 18 BatchNorms agree to a few percent in f32);
    running statistics within 1e-3."""
    variables, want_losses, want_counts, want_state = jax_sgd_steps
    trainer = _port_unet_trainer(variables, backend, "sgd", tmp_path)
    trainer.setup_optimizer()
    for i, (x, y) in enumerate(grids):
        m, loss = trainer.train_step(tmetrics.init_metric_state(), torch.from_numpy(x),
                                     torch.from_numpy(y))
        np.testing.assert_allclose(float(loss), want_losses[i], rtol=2e-4)
        got_counts = tmetrics.metric_counts(m)
        assert sum(got_counts) == sum(want_counts[i]) == x.size
        assert sum(abs(a - b) for a, b in zip(got_counts, want_counts[i])) <= (32 if i else 0)
    assert trainer.model.training and trainer.step == 3
    got = {k: v.numpy() for k, v in trainer.model.flax_state().items()}
    assert set(got) == set(want_state)
    start = _flat(variables)
    ours, theirs = [], []
    for k, v in want_state.items():
        if k.startswith("batch_stats"):
            np.testing.assert_allclose(got[k], v, atol=1e-3, rtol=0, err_msg=k)
            assert np.abs(v - start[k]).max() > 1e-3, k
            continue
        a = (got[k] - start[k]).ravel().astype(np.float64)
        b = (v - start[k]).ravel().astype(np.float64)
        if k == "params.out.bias" and not b.any():
            continue
        assert np.abs(b).max() > 0, k  # it trained
        assert np.abs(a - b).max() <= 0.25 * np.abs(b).max(), k
        assert a @ b >= 0.99 * np.linalg.norm(a) * np.linalg.norm(b), k
        ours.append(a)
        theirs.append(b)
    a, b = np.concatenate(ours), np.concatenate(theirs)
    assert a @ b >= 0.999 * np.linalg.norm(a) * np.linalg.norm(b)


def test_three_unet_adam_steps_match_jax_losses(grids, tmp_path):
    """With Adam (lr 1e-3) only the losses are held (rtol 1e-3): a gradient
    entry near 0 moves its parameter by ±lr in either package, and 12.9 M
    parameters cannot be seeded away from that."""
    variables, want_losses, _, _ = _jax_unet_steps("adam", grids, tmp_path, lr=1e-3)
    trainer = _port_unet_trainer(variables, "cuda", "adam", tmp_path, lr=1e-3)
    trainer.setup_optimizer()
    for i, (x, y) in enumerate(grids):
        _, loss = trainer.train_step(tmetrics.init_metric_state(), torch.from_numpy(x),
                                     torch.from_numpy(y))
        np.testing.assert_allclose(float(loss), want_losses[i], rtol=2e-4 if i == 0 else 1e-3)
    assert want_losses[2] < want_losses[0]


def test_unet_fit_checkpoints_carry_running_statistics(jax_unet, tmp_path):
    """Trainer.fit on the stateful model: every checkpoint holds the
    running statistics, restore_best brings them back, the JAX package
    reads them, and no parameter series is logged for a black box."""
    try:
        variables = jax_unet[1]
        trainer = _port_unet_trainer(variables, "torch", "sgd", tmp_path, max_epochs=1)
        batches = []
        for i in range(3):
            x = _occupancy(10 + i, (2, *GRID), 0.2)
            batches.append((torch.from_numpy(x),
                            torch.from_numpy(x * _occupancy(20 + i, (2, *GRID), 0.3))))
        model, best = trainer.fit(batches, val_loader=batches[:1])
        assert math.isfinite(best["train_loss"]) and math.isfinite(best["val_loss"])
        trained = {k: v.clone() for k, v in model.state_dict().items()}
        assert float((trained["down4.bn1.mean"] - torch.from_numpy(
            np.asarray(variables["batch_stats"]["down4"]["BatchNorm_1"]["mean"]))).abs().max()) > 0
        with torch.no_grad():
            for buf in model.buffers():
                buf.zero_()
        restored = trainer.restore_best("val_loss")
        for k, v in restored.state_dict().items():
            assert torch.equal(v, trained[k]), k
        ckpt = tmp_path / "ckpt_torch"
        _, template = JaxUNet3D.create(seed=5, input_shape=(1, 1, *GRID))
        back = _flat(jckpt.restore_checkpoint(str(ckpt / "last.npz"), template))
        for k, v in model.flax_state().items():
            np.testing.assert_array_equal(back[k], v.numpy(), err_msg=k)
        logs = [json.loads(line) for line in open(tmp_path / "run_torch" / "params.jsonl")]
        assert all(any(k.startswith("grad") for k in r) for r in logs)  # gradients only
        scores = trainer.evaluate(batches[1:], prefix="test")
        assert math.isfinite(scores["test_loss"]) and not model.training
    finally:
        # a checkpoint per monitored score, 52 MB each: leave nothing behind
        shutil.rmtree(tmp_path, ignore_errors=True)


# ---- the train CLI ------------------------------------------------------------------

@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("ts40k_models")
    rng = np.random.default_rng(0)
    for split, n in [("fit", 8), ("test", 2)]:
        (root / split).mkdir()
        for i in range(n):
            m = int(rng.integers(2000, 4000))
            xyz = rng.uniform([0, 0, 0], [30, 30, 60], (m, 3))
            labels = rng.choice([1, 2, 15], size=m, p=[0.5, 0.35, 0.15])
            np.save(root / split / f"sample_{i}.npy",
                    np.concatenate([xyz, labels[:, None]], axis=1))
    return str(root)


def _argv(dataset, out, *extra):
    return ["--device", "cpu", "--set", f"data_path={dataset}", f"output_dir={out}",
            "batch_size=2", f"voxel_grid_size={GRID}", "max_points=4096", "max_epochs=1",
            "num_workers=1", "val_split=0.25", *extra]


def test_cli_trains_unet(dataset, tmp_path, capsys):
    try:
        scores = tcli.main(_argv(dataset, tmp_path, "model=unet", "checkpoint_top_k=1"))
        out = capsys.readouterr().out
        assert "[device_cache auto] -> false (stateful model)" in out
        assert "[test] using best 'train_FBetaScore' checkpoint" in out
        for k in ("train_loss", "val_loss", "test_loss"):
            assert math.isfinite(scores[k]), k
        ckpt = tmp_path / "scenenet_ts40k" / "checkpoints"
        with np.load(ckpt / "last.npz") as data:
            assert "batch_stats/down0/BatchNorm_0/mean" in data.files
            assert float(np.abs(data["batch_stats/down0/BatchNorm_0/mean"]).max()) > 0
        _, template = JaxUNet3D.create(seed=1, input_shape=(1, 1, *GRID))
        restored = jckpt.restore_checkpoint(str(ckpt / "last.npz"), template)
        port = tckpt.restore_checkpoint(str(ckpt / "last.npz"), UNet3D.create(seed=2))
        x = _occupancy(3, (1, *GRID))
        with torch.no_grad():
            got = port.eval()(torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(JaxUNet3D().apply(
            restored, jnp.asarray(x))), atol=2e-5, rtol=0)
    finally:
        # a checkpoint per monitored score, 52 MB each: leave nothing behind
        shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.mark.parametrize("extra", [(), ("kernel_size=(3, 3, 3)", "model_backend=pallas")])
def test_cli_trains_cnn(dataset, tmp_path, extra):
    """model=cnn takes the config's kernel size ((9,5,5) in the defaults: the
    library conv) and, at (3,3,3) on the kernel backend, the hand-written
    conv's path (its plain version here)."""
    scores = tcli.main(_argv(dataset, tmp_path, "model=cnn", *extra))
    for k in ("train_loss", "val_loss", "test_loss"):
        assert math.isfinite(scores[k]), k
    with np.load(tmp_path / "scenenet_ts40k" / "checkpoints" / "last.npz") as data:
        assert set(data.files) == {"Conv_0/kernel", "Conv_0/bias", "Conv_1/kernel",
                                   "Conv_1/bias"}
        want = (3, 3, 3) if extra else (9, 5, 5)
        assert data["Conv_1/kernel"].shape == (*want, 3, 3)


def test_cli_model_backends_and_refusals(dataset, tmp_path):
    cpu, card = torch.device("cpu"), torch.device("cuda")
    for model in ("unet", "cnn"):
        cfg = ExperimentConfig(model=model)
        assert tcli.resolve_backend(cfg, cpu) == "torch"
        assert tcli.resolve_backend(cfg, card) == "cuda"
        assert tcli.resolve_backend(ExperimentConfig(model=model, model_backend="xla"),
                                    card) == "torch"
        with pytest.raises(ValueError, match="tensor-core"):
            tcli.resolve_backend(ExperimentConfig(model=model, model_backend="pallas_mxu"), cpu)
        built = tcli.build_model(ExperimentConfig(model=model, model_backend="pallas",
                                                  kernel_size=(3, 3, 3)), cpu)
        assert built.backend == "cuda" and isinstance(built, (UNet3D, CnnBaseline))
    assert isinstance(tcli.build_model(ExperimentConfig(), cpu), SceneNet)
    # ported since (A8, A13): the quantile ensemble and the bf16 UNet train
    quantile = tcli.build_model(ExperimentConfig(model="quantile", quantiles=(0.2, 0.8)), cpu)
    assert isinstance(quantile, QuantileSceneNet) and quantile.quantiles == (0.2, 0.8)
    assert tcli.build_criterion(ExperimentConfig(model="quantile", criterion="quantile",
                                                 quantiles=(0.2, 0.8))).quantiles == (0.2, 0.8)
    scores = tcli.main(_argv(dataset, tmp_path / "q", "model=quantile"))
    assert math.isfinite(scores["train_loss"]) and math.isfinite(scores["test_loss"])
    # channel TP is ported (A12): outside a launch of 2 ranks it names the command
    with pytest.raises(RuntimeError, match="torch.distributed.run --nproc-per-node 2"):
        tcli.main(_argv(dataset, tmp_path, "model=unet", "mesh_channel=2"))
    assert tcli.build_model(ExperimentConfig(model="unet", precision="bf16"),
                            cpu).dtype == torch.bfloat16
    try:
        scores = tcli.main(_argv(dataset, tmp_path / "u", "model=unet", "precision=bf16",
                                 "checkpoint_top_k=1"))
        assert math.isfinite(scores["train_loss"]) and math.isfinite(scores["test_loss"])
    finally:
        # a checkpoint per monitored score, 52 MB each: leave nothing behind
        shutil.rmtree(tmp_path / "u", ignore_errors=True)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcli.main(["--set", f"data_path={dataset}", "model=unet"])


# ---- bf16 (precision: bf16) ------------------------------------------------------------

@pytest.mark.parametrize("train", [True, False])
def test_flax_batchnorm_bf16_matches_flax(train):
    """A bf16 input takes flax's reduced-precision BatchNorm: statistics and
    normalisation in f32 from the widened input, the output rounded to bf16,
    the running statistics f32; against ``flax.linen.BatchNorm(dtype=bf16)``
    with bf16 scale and bias (the trainer's cast), within one bf16 ulp."""
    rng = np.random.default_rng(3)
    shape = (4, 6, 5, 4, 3)
    x = rng.normal(0.3, 2.0, shape).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    scale = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    bias = rng.normal(0, 0.1, 6).astype(np.float32)
    stats = {"mean": rng.normal(0, 0.1, 6).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, 6).astype(np.float32)}
    params = {"scale": jnp.asarray(scale, jnp.bfloat16), "bias": jnp.asarray(bias, jnp.bfloat16)}
    xl = jnp.moveaxis(jnp.asarray(xb.float().numpy(), jnp.bfloat16), 1, -1)
    mod = fnn.BatchNorm(use_running_average=not train, dtype=jnp.bfloat16)
    if train:
        want, upd = mod.apply({"params": params, "batch_stats": stats}, xl,
                              mutable=["batch_stats"])
    else:
        want = mod.apply({"params": params, "batch_stats": stats}, xl)
    bn = FlaxBatchNorm(6).train(train)
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.mean.copy_(torch.from_numpy(stats["mean"]))
        bn.var.copy_(torch.from_numpy(stats["var"]))
    half = {"scale": bn.scale.to(torch.bfloat16), "bias": bn.bias.to(torch.bfloat16)}
    got = torch.func.functional_call(bn, half, (xb,))
    assert got.dtype == torch.bfloat16 and bn.mean.dtype == torch.float32
    want = np.moveaxis(np.asarray(want.astype(jnp.float32)), -1, 1)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -100))) - 7)
    diff = np.abs(got.detach().float().numpy() - want)
    assert (diff <= ulp).all(), (diff / ulp).max()
    if train:
        np.testing.assert_allclose(bn.mean.numpy(), np.asarray(upd["batch_stats"]["mean"]),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(bn.var.numpy(), np.asarray(upd["batch_stats"]["var"]),
                                   rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def jax_unet_bf16(jax_unet, grids, tmp_path_factory):
    """The JAX Trainer's bf16 loss and prediction of the flax bf16 UNet, in
    train mode (with the new running statistics) and in eval mode, on the
    first 32³ batch of 4, op by op; and the distance between that train-mode
    prediction and the jitted one (XLA fuses and rounds the bf16 operations
    in another order there)."""
    _, variables = jax_unet
    model = JaxUNet3D(dtype=jnp.bfloat16)
    tmp = tmp_path_factory.mktemp("jax_unet_bf16")
    config = JaxTrainConfig(run_dir=str(tmp / "run"), checkpoint_dir=str(tmp / "ckpt"),
                            precision="bf16", early_stop_metric=None)
    trainer = JaxTrainer(model, jax_criterion("geneo_tversky")(**DEFAULTS), config)
    params, model_state = model.split_variables(variables)
    x, y = (jnp.asarray(a) for a in grids[0])
    out = {}
    for train in (True, False):
        loss, (pred, new_ms) = trainer._loss(params, x, y, model_state, train=train)
        out[train] = (float(loss), np.asarray(pred), new_ms)
    jitted = jax.jit(trainer._loss, static_argnames="train")(params, x, y, model_state,
                                                             train=True)[1][0]
    out["jit_distance"] = float(np.abs(np.asarray(jitted) - out[True][1]).max())
    return out


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("train", [True, False])
def test_unet_bf16_matches_flax_bf16(backend, train, jax_unet, jax_unet_bf16, grids,
                                     tmp_path):
    """UNet3D(dtype=bf16) under the trainer's precision bf16, at 32³ batch 4
    (a bottleneck channel normalises 32 values), against the flax bf16 UNet
    under the JAX Trainer's: loss, prediction and running statistics.

    The JAX package's own bf16 budget is loss rtol 5e-2 and prediction atol
    3e-2 (``tests/test_train.py``). The loss holds it (measured 3e-4), the
    eval-mode prediction too (7e-4 at most). The train-mode prediction does
    not, and neither does XLA against itself: its op-by-op and jitted bf16
    forms of this model differ by 0.055 at most (0.005 on average), the
    bf16 rounding of 18 convs and BatchNorms amplified by the batch
    statistics. So the train-mode prediction is held at a mean |Δ| of 1e-2
    (measured 0.004) and a largest |Δ| no larger than XLA's own two forms'
    (measured 0.039)."""
    _, variables = jax_unet
    want_loss, want_pred, want_ms = jax_unet_bf16[train]
    net = UNet3D(backend=backend, dtype=torch.bfloat16)
    tckpt.load_module_state(net, tckpt.params_from_jax(variables))
    config = TrainConfig(run_dir=str(tmp_path / "run"), checkpoint_dir=str(tmp_path / "ckpt"),
                         precision="bf16", early_stop_metric=None)
    trainer = Trainer(net, resolve_criterion("geneo_tversky")(**DEFAULTS), config)
    net.train(train)
    x, y = (torch.from_numpy(a) for a in grids[0])
    loss, pred = trainer._loss(x, y)
    assert pred.dtype == torch.float32 and pred.shape == x.shape
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=5e-2)
    diff = np.abs(pred.detach().numpy() - want_pred)
    if train:
        assert diff.mean() <= 1e-2 and diff.max() <= jax_unet_bf16["jit_distance"], (
            diff.mean(), diff.max(), jax_unet_bf16["jit_distance"])
        stats = _flat({"batch_stats": want_ms["batch_stats"]})
        for k, v in net.flax_state().items():
            if k.startswith("batch_stats"):
                assert v.dtype == torch.float32
                np.testing.assert_allclose(v.numpy(), stats[k], rtol=0, atol=3e-2, err_msg=k)
    else:
        assert diff.max() <= 3e-2, diff.max()
    loss.backward()
    for n, p in net.named_parameters():
        assert p.grad is not None and p.grad.dtype == torch.float32, n
