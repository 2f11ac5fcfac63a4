"""nnU-Net's ``3d_fullres`` network (``models/nnunet3d.py``), its deep
supervision (``losses/deep_supervision.py``) and its library operations
(``ops/library_conv.py``) against the benchmark's plain reference
(``perfbench/reference/nnunet.py``) and PyTorch's own modules, on the CPU:
the outputs, the weighted loss, every leaf's gradient, a Trainer step with
Adam, the CLI and checkpoints. The network has no counterpart in the JAX
package."""

import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from perfbench import check, spec
from perfbench.reference import nnunet as ref
from perfbench.routes.stream_train_nnunet import he_weights
from scenenet_tpu_torch.cli import train as tcli
from scenenet_tpu_torch.losses import (
    DeepSupervision, deep_supervision_weights, nearest_exact_target, resolve_criterion,
)
from scenenet_tpu_torch.models import NNUNet3D
from scenenet_tpu_torch.models.nnunet3d import plan
from scenenet_tpu_torch.ops import library_conv as lc
from scenenet_tpu_torch.train import TrainConfig, Trainer
from scenenet_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from scenenet_tpu_torch.train.metrics import init_metric_state
from scenenet_tpu_torch.train.preempt import restore_train_snapshot, save_train_snapshot
from scenenet_tpu_torch.utils.config import ExperimentConfig
from scenenet_tpu_torch.utils.logging import NullLogger

PUBLISHED = spec.load_config("perfbench/configs/nnunet3d_fullres_128.json")
# four stages at 16^3 (edges 16, 8, 4, 2): three heads, weights 1, 1/2, 0 over 1.5
SMALL = {**PUBLISHED, "features": [4, 8, 16, 16], "strides": [1, 2, 2, 2],
         "voxel_grid_size": [16, 16, 16]}
SEED = 2**31 + 23


def _model(config, backend="torch"):
    model = NNUNet3D(config["features"], config["strides"], config["in_channels"],
                     config["n_classes"], config["convs_per_stage"], backend=backend)
    weights = he_weights(SEED, ref.param_shapes(config), torch.device("cpu"))
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(weights[name])
    return model, weights


def _grids(batch=2, edge=16, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = (torch.rand((batch, 1, edge, edge, edge), generator=gen) < 0.2).float()
    y = (torch.rand((batch, 1, edge, edge, edge), generator=gen) < 0.1).float()
    return x, y


def _criterion(config):
    return resolve_criterion(config["criterion"])(**config["criterion_params"])


def test_published_configuration_plan_and_parameter_count():
    assert plan(PUBLISHED["voxel_grid_size"]) == (tuple(PUBLISHED["features"]),
                                                  tuple(PUBLISHED["strides"]))
    assert plan((64, 64, 64)) == ((32, 64, 128, 256, 320), (1, 2, 2, 2, 2))
    model = NNUNet3D.create(PUBLISHED["voxel_grid_size"], seed=0)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert shapes == dict(ref.param_shapes(PUBLISHED))
    assert sum(p.numel() for p in model.parameters()) == PUBLISHED["parameters"] == 31194789
    layers = ref.conv_layers(PUBLISHED, 128)
    assert len(layers) == PUBLISHED["convs"] == 22
    assert sum(s == 2 for *_, s in layers) == PUBLISHED["strided_convs"] == 5
    assert len(ref.transposed_layers(PUBLISHED, 128)) == PUBLISHED["transposed_convs"]
    # InitWeights_He(1e-2): He-normal weights, zero biases, norm scale 1 and bias 0
    w = model.encoder[0][1].weight
    assert float(w.detach().std()) == pytest.approx(math.sqrt(2 / (1 + 1e-4) / (32 * 27)),
                                                    rel=0.05)
    assert not model.up[0].bias.any() and not model.heads[4].bias.any()
    assert torch.equal(model.encoder[3][0].norm_weight, torch.ones(256))


def test_deep_supervision_weights_and_targets_by_hand():
    assert deep_supervision_weights(5) == pytest.approx(
        [1 / 1.875, 0.5 / 1.875, 0.25 / 1.875, 0.125 / 1.875, 0.0])
    assert deep_supervision_weights(5) == pytest.approx(ref.ds_weights(5))
    assert deep_supervision_weights(1) == [1.0]
    y = torch.arange(8 ** 3, dtype=torch.float32).view(1, 1, 8, 8, 8)  # value 64z + 8x + y
    # factor 2: voxels 1, 3, 5, 7 along each axis; factor 4: 2, 6; factor 8: 4
    assert nearest_exact_target(y, (1, 1, 4, 4, 4))[0, 0, 0, 0, :].tolist() == [73, 75, 77, 79]
    assert nearest_exact_target(y, (1, 1, 4, 4, 4))[0, 0, 1, 2, 3].tolist() == 64 * 3 + 8 * 5 + 7
    assert nearest_exact_target(y, (1, 1, 2, 2, 2)).flatten().tolist() == [
        64 * z + 8 * x + v for z in (2, 6) for x in (2, 6) for v in (2, 6)]
    assert nearest_exact_target(y, (1, 1, 1, 1, 1)).item() == 64 * 4 + 8 * 4 + 4
    outs = [torch.zeros(1, 1, 8 >> k, 8 >> k, 8 >> k) for k in range(4)]
    for o, t in zip(outs, ref.ds_targets(y, outs)):  # F.interpolate's nearest-exact
        assert torch.equal(nearest_exact_target(y, o.shape), t)
    with pytest.raises(ValueError):
        nearest_exact_target(y, (1, 1, 3, 3, 3))
    # three outputs, weights 1/1.5, 0.5/1.5 and 0 of a criterion that reads the
    # target's mean; the weight-0 output is never given to the criterion
    calls = []

    def crit(p, t, *args):
        calls.append(p.shape[-1])
        return (p - t).mean() + sum(args)

    loss = DeepSupervision(crit)([o + 1 for o in outs[:3]], y, 0.0)
    # the 4^3 target's mean is its middle voxel (4, 4, 4): 64·4 + 8·4 + 4
    want = (1 - y.mean()) / 1.5 + 0.5 * (1 - (64 * 4 + 8 * 4 + 4)) / 1.5
    assert calls == [8, 4] and float(loss) == pytest.approx(float(want), rel=1e-6)
    assert float(DeepSupervision(crit)(outs[0], y)) == pytest.approx(-float(y.mean()))


def test_outputs_match_the_reference():
    model, weights = _model(SMALL)
    x, _ = _grids()
    outs = model.train()(x)
    want = ref.NNUNet(SMALL, weights).forward(x)
    assert [tuple(o.shape) for o in outs] == [(2, 1, 16, 16, 16), (2, 1, 8, 8, 8),
                                              (2, 1, 4, 4, 4)]
    for o, w in zip(outs, want):
        torch.testing.assert_close(o, w, rtol=1e-5, atol=1e-6)
    # evaluation (and deep supervision off) returns the top output alone
    torch.testing.assert_close(model.eval()(x), want[0], rtol=1e-5, atol=1e-6)
    model.train().deep_supervision = False
    torch.testing.assert_close(model(x), want[0], rtol=1e-5, atol=1e-6)


def test_loss_and_every_leaf_gradient_match_the_reference():
    model, weights = _model(SMALL)
    x, y = _grids(seed=1)
    loss = DeepSupervision(_criterion(SMALL))(model.train()(x), y)
    names = [n for n, _ in model.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss, list(model.parameters()),
                                                allow_unused=True)))
    params = {n: v.clone().requires_grad_(True) for n, v in weights.items()}
    want_loss = ref.ds_loss(ref.NNUNet(SMALL, params).forward(x), y, SMALL)
    want = dict(zip(names, torch.autograd.grad(want_loss, [params[n] for n in names],
                                               allow_unused=True)))
    assert float(loss.detach()) == pytest.approx(float(want_loss.detach()), rel=1e-5)
    # the deepest head's term has weight 0: neither side gives its head a gradient
    deepest = {"heads.0.weight", "heads.0.bias"}  # level 0: the 2^3 level
    assert {n for n, g in want.items() if g is None} == deepest
    assert {n for n, g in grads.items() if g is None} == deepest
    scale = max(float(g.abs().max()) for g in want.values() if g is not None)
    for n in names:
        if n not in deepest:
            torch.testing.assert_close(grads[n], want[n], rtol=1e-4, atol=1e-5 * scale,
                                       msg=lambda m, n=n: f"{n}: {m}")


def test_a_trainer_step_with_adam_matches_the_reference():
    model, weights = _model(SMALL)
    batches = [_grids(seed=2), _grids(seed=3)]
    trainer = Trainer(model, DeepSupervision(_criterion(SMALL)),
                      TrainConfig(learning_rate=SMALL["learning_rate"], tau=SMALL["tau"],
                                  early_stop_metric=None, log_gradients=False),
                      logger=NullLogger())
    trainer.setup_optimizer()
    mstate, losses = init_metric_state(torch.device("cpu")), []
    for x, y in batches:
        mstate, loss = trainer.train_step(mstate, x, y)
        losses.append(float(loss))
    want = ref.train(SMALL, weights, batches, torch.device("cpu"))
    assert losses == pytest.approx(want["losses"], rel=1e-5)
    assert torch.stack(list(mstate)).tolist() == want["counts"].tolist()
    # the deepest head never had a gradient: Adam holds no state for it and left it
    deepest = [model.heads[0].weight, model.heads[0].bias]
    assert all(p not in trainer.optimizer.state for p in deepest)
    # a conv's bias before InstanceNorm has no gradient in exact arithmetic: Adam
    # scales the rounding noise of its gradient up to the learning rate, on either
    # side alike, so those leaves are left out of the change (as perfbench's check is)
    moving = check.moving_leaves(want["grads"], list(weights))
    assert sorted(set(weights) - set(moving)) == sorted(
        n for n in weights if n.endswith(".bias") and n.startswith(("encoder.", "decoder.")))
    # Adam moves an element by about the learning rate whatever its gradient's size, so
    # an element whose gradient is near its rounding may differ by a share of it
    change = {n: p.detach() - weights[n] for n, p in model.named_parameters()}
    want_change = {n: want["params"][n] - weights[n] for n in weights}
    assert check.leaf_gap(change, want_change, moving) < 1e-4
    for n in moving:
        torch.testing.assert_close(change[n], want_change[n], rtol=1e-3,
                                   atol=1e-2 * SMALL["learning_rate"],
                                   msg=lambda m, n=n: f"{n}: {m}")
    assert torch.equal(model.heads[0].weight.detach(), weights["heads.0.weight"])


@pytest.mark.parametrize("shape", [(2, 3, 8, 8, 8), (1, 2, 7, 6, 9), (1, 1, 5, 5, 5),
                                   (2, 4, 2, 3, 2)])
def test_strided_conv_wrapper_matches_conv3d_in_float64(shape):
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(shape, generator=gen, dtype=torch.float64, requires_grad=True)
    w = torch.randn((5, shape[1], 3, 3, 3), generator=gen, dtype=torch.float64,
                    requires_grad=True)
    b = torch.randn(5, generator=gen, dtype=torch.float64, requires_grad=True)
    out, want = lc.conv3d_strided(x, w, b), F.conv3d(x, w, b, stride=2, padding=1)
    torch.testing.assert_close(out, want, rtol=1e-12, atol=1e-12)
    g = torch.randn(want.shape, generator=gen, dtype=torch.float64)
    leaves = (x, w, b)
    for a, c in zip(torch.autograd.grad(out, leaves, g), torch.autograd.grad(want, leaves, g)):
        torch.testing.assert_close(a, c, rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError):
        lc.conv3d_strided(x, w[:, :, :2], b)


@pytest.mark.parametrize("shape", [(2, 3, 4, 4, 4), (1, 5, 3, 2, 5)])
def test_transposed_conv_wrapper_matches_conv_transpose3d_in_float64(shape):
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(shape, generator=gen, dtype=torch.float64, requires_grad=True)
    w = torch.randn((shape[1], 4, 2, 2, 2), generator=gen, dtype=torch.float64,
                    requires_grad=True)
    b = torch.randn(4, generator=gen, dtype=torch.float64, requires_grad=True)
    out, want = lc.conv_transpose3d_k2(x, w, b), F.conv_transpose3d(x, w, b, stride=2)
    torch.testing.assert_close(out, want, rtol=1e-12, atol=1e-12)
    g = torch.randn(want.shape, generator=gen, dtype=torch.float64)
    leaves = (x, w, b)
    for a, c in zip(torch.autograd.grad(out, leaves, g), torch.autograd.grad(want, leaves, g)):
        torch.testing.assert_close(a, c, rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError):
        lc.conv_transpose3d_k2(x, w.transpose(0, 1), b)


def test_instance_norm_lrelu_wrapper_matches_the_modules():
    gen = torch.Generator().manual_seed(6)
    x = torch.randn((2, 3, 5, 6, 4), generator=gen, requires_grad=True)
    norm = nn.InstanceNorm3d(3, affine=True)
    with torch.no_grad():
        norm.weight.copy_(torch.randn(3, generator=gen))
        norm.bias.copy_(torch.randn(3, generator=gen))
    want = nn.LeakyReLU(0.01)(norm(x))
    out = lc.instance_norm_lrelu(x, norm.weight, norm.bias)
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    g = torch.randn(want.shape, generator=gen)
    leaves = (x, norm.weight, norm.bias)
    for a, c in zip(torch.autograd.grad(out, leaves, g), torch.autograd.grad(want, leaves, g)):
        torch.testing.assert_close(a, c, rtol=1e-6, atol=1e-6)


def test_the_loss_span_sits_between_forward_and_backward(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    from perfbench import spans
    from perfbench.trace import Trace

    model, _ = _model(SMALL)
    trainer = Trainer(model, DeepSupervision(_criterion(SMALL)),
                      TrainConfig(early_stop_metric=None, log_gradients=False),
                      logger=NullLogger())
    trainer.setup_optimizer()
    mstate = init_metric_state(torch.device("cpu"))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for seed in (7, 8):
            mstate, _ = trainer.train_step(mstate, *_grids(seed=seed))
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    with open(tmp_path / "trace.json") as f:
        found = spans.program_spans(Trace(json.load(f)["traceEvents"], 1.0))
    loss, steps = found["snt/train/loss"], found["snt/train/step"]
    assert len(loss) == len(steps) == 2
    for (ls, lf), (ss, sf), (_, ff), (bs, _) in zip(loss, steps, found["snt/train/forward"],
                                                    found["snt/train/backward"]):
        assert ss <= ls and lf <= sf and ff <= ls and lf <= bs


@pytest.fixture(scope="module")
def clouds(tmp_path_factory):
    root = tmp_path_factory.mktemp("ts40k_nnunet")
    rng = np.random.default_rng(0)
    for split, n in (("fit", 4), ("test", 2)):
        (root / split).mkdir()
        for i in range(n):
            m = int(rng.integers(2000, 4000))
            xyz = rng.uniform([0, 0, 0], [30, 30, 60], (m, 3))
            labels = rng.choice([1, 2, 15], size=m, p=[0.5, 0.35, 0.15])
            np.save(root / split / f"sample_{i}.npy", np.concatenate([xyz, labels[:, None]], 1))
    return str(root)


def _cli_cfg(clouds, tmp_path, **kw):
    return ExperimentConfig(model="nnunet", data_path=clouds, output_dir=str(tmp_path),
                            batch_size=2, voxel_grid_size=(16, 16, 16), max_points=4096,
                            max_epochs=1, num_workers=1, val_split=0.25, **kw)


def test_cli_trains_validates_and_checkpoints_nnunet(clouds, tmp_path, capsys):
    scores = tcli.run(_cli_cfg(clouds, tmp_path), device="cpu")
    out = capsys.readouterr().out
    assert "[device_cache auto] -> false (nnunet streams its batches)" in out
    assert math.isfinite(scores["train_loss"]) and math.isfinite(scores["val_loss"])
    assert math.isfinite(scores["test_loss"]) and "test_F1Score" in scores
    last = next((tmp_path).glob("*/checkpoints/last.npz"))
    restored = restore_checkpoint(str(last), NNUNet3D.create((16, 16, 16), seed=1))
    with np.load(last) as z:
        assert len(z.files) == len(restored.state_dict())
        for n, v in restored.state_dict().items():
            np.testing.assert_array_equal(z[n.replace(".", "/")], v.numpy())
    again = tcli.run(_cli_cfg(clouds, tmp_path, resume_from_checkpoint=True), device="cpu")
    assert math.isfinite(again["test_loss"])


@pytest.mark.parametrize("override, message", [
    ({"precision": "bf16"}, "trains in f32"),
    ({"mesh_channel": 2}, "one card"),
    ({"mesh_data": 2}, "one card"),
    ({"device_cache": "grids"}, "streaming loader"),
    ({"device_cache": "points"}, "streaming loader"),
])
def test_cli_refuses_what_nnunet_does_not_train(clouds, tmp_path, override, message):
    with pytest.raises(ValueError, match=message):
        tcli.run(_cli_cfg(clouds, tmp_path, **override), device="cpu")


def test_checkpoint_and_snapshot_round_trip_with_adam_state(tmp_path):
    def trainer_of(model):
        t = Trainer(model, DeepSupervision(_criterion(SMALL)),
                    TrainConfig(early_stop_metric=None, log_gradients=False),
                    logger=NullLogger())
        t.setup_optimizer()
        return t

    trainer = trainer_of(_model(SMALL)[0])
    mstate = init_metric_state(torch.device("cpu"))
    mstate, loss = trainer.train_step(mstate, *_grids(seed=9))
    save_checkpoint(str(tmp_path / "model.npz"), trainer.model)
    fresh = NNUNet3D(SMALL["features"], SMALL["strides"])
    restore_checkpoint(str(tmp_path / "model.npz"), fresh)
    for (n, a), b in zip(trainer.model.state_dict().items(), fresh.state_dict().values()):
        assert torch.equal(a, b), n
    state = trainer.train_state()
    assert any(k.endswith("/exp_avg_sq") for k in state)
    save_train_snapshot(str(tmp_path / "snap.npz"), state, mstate, loss, {}, {"kind": "batch"})
    restored, _, _, _, _ = restore_train_snapshot(str(tmp_path / "snap.npz"),
                                                  trainer.train_state(), {})
    other = trainer_of(NNUNet3D(SMALL["features"], SMALL["strides"]))
    other.load_train_state(restored)
    for k, v in other.train_state().items():
        assert torch.equal(v, state[k]), k
    # both take the same next step
    batch = _grids(seed=10)
    trainer.train_step(init_metric_state(torch.device("cpu")), *batch)
    other.train_step(init_metric_state(torch.device("cpu")), *batch)
    for a, b in zip(trainer.model.parameters(), other.model.parameters()):
        assert torch.equal(a, b)


def _plan_launches():
    """K10's launches a train step by its plans at the published configuration: a
    forward at each stride-1 conv and a dx at each but the first (one counted launch
    each); a dw at each, two launches where it splits (the kernel, its reduction)."""
    from scenenet_tpu_torch.ops.cuda_conv_mc import conv3d_mc_dw_plan

    stride1 = [(ci, co, e) for ci, co, e, s in ref.conv_layers(PUBLISHED, 128) if s == 1]
    dw = sum(2 if conv3d_mc_dw_plan(2, ci, co, e, e, e)[1] > 1 else 1 for ci, co, e in stride1)
    return {"conv3d_mc": 2 * len(stride1) - 1, "conv3d_mc_dw": dw, "conv3d_strided": 5,
            "conv_transpose3d_k2": 5, "instance_norm_lrelu": 22}


def test_the_plans_launch_count_a_step():
    assert _plan_launches() == {"conv3d_mc": 33, "conv3d_mc_dw": 27, "conv3d_strided": 5,
                                "conv_transpose3d_k2": 5, "instance_norm_lrelu": 22}


@pytest.mark.cuda
def test_a_card_step_launches_k10_and_the_wrappers_by_the_plan():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from scenenet_tpu_torch.ops._build import launch_counts

    dev = torch.device("cuda")
    model = NNUNet3D.create(PUBLISHED["voxel_grid_size"], seed=0, backend="cuda").to(dev)
    trainer = Trainer(model, DeepSupervision(_criterion(PUBLISHED)),
                      TrainConfig(early_stop_metric=None, log_gradients=False),
                      logger=NullLogger())
    trainer.setup_optimizer()
    x, y = (t.to(dev) for t in _grids(2, 128))
    mstate = init_metric_state(dev)
    mstate, first = trainer.train_step(mstate, x, y)
    before = launch_counts()
    mstate, second = trainer.train_step(mstate, x, y)
    torch.cuda.synchronize()
    after = launch_counts()
    got = {k: after[k] - before.get(k, 0) for k in _plan_launches()}
    assert got == _plan_launches()
    assert math.isfinite(float(first)) and math.isfinite(float(second))


def _chip_smoke():
    root = str(Path(__file__).resolve().parents[1])
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    return chip_smoke


def test_the_smokes_layer_lists_are_the_networks():
    smoke = _chip_smoke()
    convs = ref.conv_layers(PUBLISHED, 128)
    assert smoke.NNUNET_BATCH == spec.load_traffic("nnunet.train.stream128")["batch_size"]
    assert smoke.NNUNET_CONVS == [(ci, co, e) for ci, co, e, s in convs if s == 1]
    assert smoke.NNUNET_STRIDED == [(ci, co, 2 * e) for ci, co, e, s in convs if s == 2]
    assert smoke.NNUNET_TRANSPOSED == ref.transposed_layers(PUBLISHED, 128)


@pytest.mark.cuda
def test_k10_at_the_networks_stride1_convs_matches_the_library_on_the_card():
    """The smoke's ``[K10 nnunet]`` phase: K10 forward, dx and dw at the 17
    stride-1 convs at batch 2 against the f32 library calls, launches by the
    plans (it raises on a failed check)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    smoke = _chip_smoke()
    worst = smoke.nnunet_k10_phase(torch.device("cuda"))["worst"]
    assert worst["dw"] <= smoke.MC_DW_REL_TOL and worst["forward"] < 1e-4 and worst["dx"] < 1e-4
