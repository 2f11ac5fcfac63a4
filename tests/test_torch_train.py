"""Port parity: the training path in torch vs the JAX package.

The trainer, its metrics, optimizer, checkpoints and callbacks, the host
data layer, the config and the train CLI, at a small size (16³ grid,
batch 2, 4096 padded points, kernel (9,5,5), the defaults' geneo_tversky
weights). The same loader batches go through both trainers. The clouds
have uniform random float coordinates, where the port's multiply bin
recipe and JAX's CPU divide recipe agree (checked first).

Tolerances: losses rtol 1e-4 (f32 sums over 8192 voxels in another
order), parameters after 3 Adam steps atol 1e-5 (each step moves a
parameter by about lr = 1e-3, and optax and torch round the update
differently), confusion counts exact, scores 1e-6 (JAX computes them in
f32, the port in float64 from int64 counts).
"""

import dataclasses
import json
import math
import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from scenenet_tpu.data import PointPadding as JaxPointPadding
from scenenet_tpu.data import TS40K as JaxTS40K
from scenenet_tpu.data.loader import PointCloudLoader as JaxPointCloudLoader
from scenenet_tpu.data.loader import random_split as jax_random_split
from scenenet_tpu.losses import resolve_criterion as jax_criterion
from scenenet_tpu.models import SceneNet as JaxSceneNet
from scenenet_tpu.train import TrainConfig as JaxTrainConfig
from scenenet_tpu.train import Trainer as JaxTrainer
from scenenet_tpu.train import make_device_voxelize_prep as jax_prep
from scenenet_tpu.train import metrics as jmetrics
from scenenet_tpu.train.checkpoint import restore_checkpoint as jax_restore
from scenenet_tpu.train.state import create_train_state
from scenenet_tpu.utils.config import load_config as jax_load_config
from scenenet_tpu_torch.cli import train as tcli
from scenenet_tpu_torch.data import PointCloudLoader, PointPadding, Subset, TS40K, random_split
from scenenet_tpu_torch.losses import resolve_criterion
from scenenet_tpu_torch.models import SceneNet
from scenenet_tpu_torch.ops import cuda_hist
from scenenet_tpu_torch.ops import voxelize as tv
from scenenet_tpu_torch.train import (
    BestMetricTracker, CheckpointManager, EarlyStopping, TrainConfig, Trainer,
    make_device_voxelize_prep, restore_checkpoint, save_checkpoint,
)
from scenenet_tpu_torch.train import metrics as tmetrics
from scenenet_tpu_torch.train.state import resolve_optimizer
from scenenet_tpu_torch.utils.config import ExperimentConfig, load_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID = (16, 16, 16)
KS = (9, 5, 5)
MAX_POINTS = 4096
LR = 1e-3
SEED = 55  # a draw whose first gradients are all well away from 0 (see below)
DEFAULTS = dict(weight_alpha=1, weight_epsilon=0.1, mse_weight=1, convex_weight=5,
                tversky_alpha=2, tversky_beta=1, tversky_smooth=1e-6, focal_gamma=4)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """A TS40K-style directory: (N, 4) float64 xyz + label crops, one of
    them longer than MAX_POINTS (subsampled by the padding)."""
    root = tmp_path_factory.mktemp("ts40k_torch")
    rng = np.random.default_rng(0)
    for split, n in [("fit", 8), ("test", 2)]:
        (root / split).mkdir()
        for i in range(n):
            m = 5000 if (split, i) == ("fit", 3) else int(rng.integers(2000, 4000))
            xyz = rng.uniform([0, 0, 0], [30, 30, 60], (m, 3))
            labels = rng.choice([1, 2, 15], size=m, p=[0.5, 0.35, 0.15])
            np.save(root / split / f"sample_{i}.npy",
                    np.concatenate([xyz, labels[:, None]], axis=1))
    return str(root)


def _loader(root, seed=0):
    ds = TS40K(root, "fit", transform=PointPadding(max_points=MAX_POINTS))
    return PointCloudLoader(ds, 2, shuffle=True, num_workers=1, seed=seed, drop_last=True)


@pytest.fixture(scope="module")
def batches(dataset):
    out = list(_loader(dataset))[:3]
    for pts, _, mask, _ in out:  # the two bin recipes agree on these clouds
        tp, tm = torch.from_numpy(pts), torch.from_numpy(mask)
        assert torch.equal(cuda_hist.flat_ids_mul(tp, tm, GRID)[tm],
                           tv.batch_flat_ids(tp, tm, GRID)[tm])
    return out


def _jflat(tree):
    return {".".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_trainer(tmp_path, backend, **cfg):
    net = SceneNet.create(kernel_size=KS, seed=SEED, backend=backend)
    config = TrainConfig(run_dir=str(tmp_path / f"run_{backend}"),
                         checkpoint_dir=str(tmp_path / f"ckpt_{backend}"),
                         learning_rate=LR, early_stop_metric=None, **cfg)
    return Trainer(net, resolve_criterion("geneo_tversky")(**DEFAULTS), config,
                   batch_prep=make_device_voxelize_prep(GRID, (15,)))


def _jax_trainer(tmp_path):
    jnet, jparams = JaxSceneNet.create(kernel_size=KS, seed=SEED, backend="xla")
    config = JaxTrainConfig(run_dir=str(tmp_path / "run_jax"),
                            checkpoint_dir=str(tmp_path / "ckpt_jax"),
                            learning_rate=LR, early_stop_metric=None, max_epochs=1)
    trainer = JaxTrainer(jnet, jax_criterion("geneo_tversky")(**DEFAULTS), config,
                         batch_prep=jax_prep(GRID, (15,), use_indices=False))
    return trainer, jnet, jparams


# ---- the trainer -----------------------------------------------------------

@pytest.fixture(scope="module")
def jax_steps(batches, tmp_path_factory):
    """Three JAX train steps: per-step loss and confusion counts, and the
    parameters after them."""
    trainer, jnet, jparams = _jax_trainer(tmp_path_factory.mktemp("jax_steps"))
    state, tx = create_train_state(jparams, "adam", LR, jnet.trainable_mask(jparams))
    step, _ = trainer._build_steps(tx)
    losses, counts = [], []
    for b in batches:
        state, m, loss, _ = step(state, jmetrics.init_metric_state(),
                                 *(jnp.asarray(a) for a in b))
        losses.append(float(loss))
        counts.append(jmetrics.metric_counts(m))
    return losses, counts, _jflat(state.params)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_three_train_steps_match_jax(backend, batches, jax_steps, tmp_path):
    want_losses, want_counts, want_params = jax_steps
    trainer = _port_trainer(tmp_path, backend)
    trainer.setup_optimizer()
    for i, b in enumerate(batches):
        m, loss = trainer.train_step(tmetrics.init_metric_state(), *trainer.to_device(b))
        if i == 0:
            # Adam's first step moves by ~lr·sign(g): every trainable
            # gradient must be well away from 0 for the signs to agree
            g = {n: abs(float(p.grad)) for n, p in trainer.model.named_parameters()
                 if p.requires_grad}
            assert min(g.values()) > 1e-3 * max(g.values()), g
        np.testing.assert_allclose(float(loss), want_losses[i], rtol=1e-4)
        assert tmetrics.metric_counts(m) == want_counts[i]
    assert sum(c[0] for c in want_counts) > 0  # some tower voxels predicted
    for name, p in trainer.model.named_parameters():
        np.testing.assert_allclose(float(p.detach()), want_params[name], rtol=0, atol=1e-5,
                                   err_msg=name)
    assert trainer.step == 3


@pytest.fixture(scope="module")
def jax_fit(batches, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_fit")
    trainer, _, jparams = _jax_trainer(tmp)
    params, best = trainer.fit(jparams, batches, val_loader=batches[:1])
    test = trainer.evaluate(params, batches[1:], prefix="test")
    return _jflat(params), best, test


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_fit_matches_jax(backend, batches, jax_fit, tmp_path):
    """A 3-step Trainer.fit with validation, then evaluate: the final
    parameters, the epoch's loss and scores, and the logs and checkpoints
    on disk."""
    want_params, want_best, want_test = jax_fit
    trainer = _port_trainer(tmp_path, backend, max_epochs=1)
    model, best = trainer.fit(batches, val_loader=batches[:1])
    assert model is trainer.model
    for name, p in model.named_parameters():
        np.testing.assert_allclose(float(p.detach()), want_params[name], rtol=0, atol=1e-5,
                                   err_msg=name)
    assert set(best) == set(want_best)
    for k, v in want_best.items():
        if k == "epoch_time_s":
            continue
        tol = dict(rtol=1e-4) if k.endswith("loss") else dict(rtol=0, atol=1e-6)
        np.testing.assert_allclose(best[k], v, err_msg=k, **tol)
    test = trainer.evaluate(batches[1:], prefix="test")
    assert set(test) == set(want_test)
    for k, v in want_test.items():
        tol = dict(rtol=1e-4) if k.endswith("loss") else dict(rtol=0, atol=1e-6)
        np.testing.assert_allclose(test[k], v, err_msg=k, **tol)
    run, ckpt = tmp_path / f"run_{backend}", tmp_path / f"ckpt_{backend}"
    assert (ckpt / "last.npz").exists() and (ckpt / "train_loss_step0.npz").exists()
    params_log = [json.loads(line) for line in open(run / "params.jsonl")]
    assert any("grad/geneo/cy_0/radius" in r for r in params_log)
    assert any("lambda_cy_0" in r for r in params_log)
    assert json.loads(open(run / "metrics.jsonl").readline())["step"] == 0
    restored = trainer.restore_best("val_FBetaScore", SceneNet.create(kernel_size=KS, seed=SEED))
    for (n, a), b in zip(restored.state_dict().items(), model.state_dict().values()):
        assert torch.equal(a, b.cpu()), n


def test_frozen_parameters_never_move(batches, tmp_path):
    trainer = _port_trainer(tmp_path, "torch", max_epochs=1)
    before = {n: float(p.detach()) for n, p in trainer.model.named_parameters()}
    trainer.fit(batches)
    frozen = [n for n, p in trainer.model.named_parameters() if not p.requires_grad]
    assert sorted(frozen) == sorted(["geneo.cone_0.apex",
                                     f"lambdas.{trainer.model.last_lambda}"])
    for n, p in trainer.model.named_parameters():
        assert (float(p.detach()) == before[n]) == (n in frozen), n
    in_opt = {id(p) for g in trainer.optimizer.param_groups for p in g["params"]}
    assert all(id(p) not in in_opt for n, p in trainer.model.named_parameters() if n in frozen)


def test_restore_best_falls_back_to_last(batches, tmp_path):
    trainer = _port_trainer(tmp_path, "torch", max_epochs=1)
    trainer.fit(batches[:1])
    with pytest.warns(UserWarning, match="last.npz"):
        trainer.restore_best("val_FBetaScore")
    with pytest.raises(FileNotFoundError):
        _port_trainer(tmp_path, "torch").restore_best("train_loss")


def test_early_stopping_ends_fit(batches, tmp_path):
    trainer = _port_trainer(tmp_path, "torch", max_epochs=10)
    trainer.config.early_stop_metric = "train_loss"
    trainer.config.early_stop_patience = 1
    trainer.fit(batches[:1])  # EarlyStopping is mode max: the loss falls → stops
    assert trainer.step == 2


# ---- metrics -----------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_match_jax(seed):
    rng = np.random.default_rng(seed)
    pred = rng.random((3, 1, 10, 10, 10)).astype(np.float32)
    gt = (rng.random(pred.shape) > 0.9).astype(np.float32)
    pred[0, 0, 0, 0, :3] = [0.65, np.nextafter(np.float32(0.65), 0), 0.9]
    js, ts = jmetrics.init_metric_state(), tmetrics.init_metric_state()
    for i in range(3):  # accumulated over batches
        js = jmetrics.update_metrics(js, jnp.asarray(pred[i]), jnp.asarray(gt[i]), 0.65)
        ts = tmetrics.update_metrics(ts, torch.from_numpy(pred[i]), torch.from_numpy(gt[i]),
                                     0.65)
    assert tmetrics.metric_counts(ts) == jmetrics.metric_counts(js)
    assert all(v.dtype == torch.int64 for v in ts)
    want = {k: float(v) for k, v in jmetrics.compute_metrics(js, 0.5).items()}
    got = tmetrics.compute_metrics(ts, 0.5)
    assert set(got) == set(want) == set(tmetrics.METRIC_NAMES)
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-6), k


def test_metrics_empty_positive_class_and_broadcast():
    s = tmetrics.update_metrics(tmetrics.init_metric_state(), torch.zeros(100), torch.zeros(100))
    m = tmetrics.compute_metrics(s)
    assert m["Precision"] == 0.0 and m["JaccardIndex"] == pytest.approx(0.5)
    # quantile-style (B, Q, ...) predictions against a (B, 1, ...) target
    pred = torch.tensor([[[0.9], [0.1], [0.7]]])
    s = tmetrics.update_metrics(tmetrics.init_metric_state(), pred, torch.ones((1, 1, 1)))
    assert tmetrics.metric_counts(s) == (2, 0, 1, 0)


def test_metric_counts_pass_int32():
    big = tmetrics.MetricState(*(torch.tensor(v, dtype=torch.int64)
                                 for v in (3, 5, 7, 40000 * 65536)))
    s = tmetrics.merge_metric_states(big, big)
    assert tmetrics.metric_counts(s) == (6, 10, 14, 2 * 40000 * 65536)
    assert tmetrics.compute_metrics(s)["JaccardIndex"] > 0.5


# ---- optimizer, checkpoints, callbacks ----------------------------------------

@pytest.mark.parametrize("name", ["adam", "sgd", "rmsprop"])
def test_resolve_optimizer_minimizes(name):
    a = torch.nn.Parameter(torch.zeros(3))
    frozen = torch.nn.Parameter(torch.ones(3), requires_grad=False)
    opt = resolve_optimizer(name, [a, frozen], 1e-1)
    assert [p for g in opt.param_groups for p in g["params"]] == [a]
    target = torch.tensor([1.0, -2.0, 3.0])
    first = ((a - target) ** 2).sum().item()
    for _ in range(20):
        opt.zero_grad()
        loss = ((a - target) ** 2).sum()
        loss.backward()
        opt.step()
    assert ((a - target) ** 2).sum().item() < first


def test_adam_matches_optax_on_one_step():
    """The same gradient through torch's Adam and optax.adam."""
    import optax

    g = np.array([0.3, -2e-3, 5.0], np.float32)
    p = torch.nn.Parameter(torch.tensor([1.0, 2.0, 3.0]))
    opt = resolve_optimizer("adam", [p], 1e-3)
    for _ in range(3):
        p.grad = torch.from_numpy(g.copy())
        opt.step()
    tx = optax.adam(1e-3)
    jp = jnp.asarray([1.0, 2.0, 3.0])
    st = tx.init(jp)
    for _ in range(3):
        up, st = tx.update(jnp.asarray(g), st, jp)
        jp = optax.apply_updates(jp, up)
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp), rtol=0, atol=1e-6)


def test_checkpoint_top_k_and_jax_restore(tmp_path):
    net = SceneNet.create(kernel_size=KS, seed=0)
    mgr = CheckpointManager(str(tmp_path), {"train_F1Score": "max"}, top_k=2)
    for step, score in enumerate([0.1, 0.3, 0.2, 0.5]):
        mgr.step(net, {"train_F1Score": score}, step)
    assert mgr.best_score("train_F1Score") == pytest.approx(0.5)
    kept = sorted(f for f in os.listdir(tmp_path) if f.startswith("train_F1Score"))
    assert kept == ["train_F1Score_step1.json", "train_F1Score_step1.npz",
                    "train_F1Score_step3.json", "train_F1Score_step3.npz"]
    _, template = JaxSceneNet.create(kernel_size=KS, seed=5)
    for path in (mgr.best_path("train_F1Score"), mgr.last_path()):
        restored = _jflat(jax_restore(path, template))
        for n, v in net.state_dict().items():
            np.testing.assert_array_equal(restored[n], v.numpy())


def test_nan_score_never_admitted(tmp_path):
    net = SceneNet.create(kernel_size=KS, seed=0)
    mgr = CheckpointManager(str(tmp_path), {"val_FBetaScore": "max"}, top_k=1)
    with pytest.warns(UserWarning, match="non-finite"):
        mgr.step(net, {"val_FBetaScore": float("nan")}, 0)
    assert mgr.best_path("val_FBetaScore") is None
    mgr.step(net, {"val_FBetaScore": 0.4}, 1)
    assert mgr.best_score("val_FBetaScore") == pytest.approx(0.4)
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        mgr.step(net, {"val_FBetaScore": float("nan")}, 2)
    assert mgr.best_score("val_FBetaScore") == pytest.approx(0.4)


def test_metric_disappearing_warns_once(tmp_path):
    net = SceneNet.create(kernel_size=KS, seed=0)
    mgr = CheckpointManager(str(tmp_path), {"val_loss": "min", "train_loss": "min"})
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        mgr.step(net, {"train_loss": 1.0}, 0)
    mgr.step(net, {"train_loss": 0.9, "val_loss": 0.5}, 1)
    with pytest.warns(UserWarning, match="disappeared"):
        mgr.step(net, {"train_loss": 0.8}, 2)


def test_callbacks():
    es = EarlyStopping("val_F1Score", patience=2, mode="max")
    assert not es.update({"val_F1Score": 0.5})
    assert not es.update({"val_F1Score": 0.4})
    assert es.update({"val_F1Score": 0.45})
    assert not EarlyStopping("missing").update({"other": 1.0})
    bt = BestMetricTracker()
    for scores in ({"train_loss": 1.0, "val_F1Score": float("nan")},
                   {"train_loss": 0.5, "val_F1Score": 0.2},
                   {"train_loss": 0.7, "val_F1Score": 0.1}):
        bt.update(scores)
    assert bt.best == {"train_loss": 0.5, "val_F1Score": 0.2}


# ---- data ----------------------------------------------------------------------

def test_loader_batches_equal_jax(dataset):
    """Listing, padding (subsampling included), split and the seeded
    shuffle over two epochs give the JAX package's batches."""
    jds = JaxTS40K(dataset, "fit", transform=JaxPointPadding(max_points=MAX_POINTS,
                                                             compute_indices=False))
    jloader = JaxPointCloudLoader(jds, 2, shuffle=True, num_workers=2, seed=3,
                                  drop_last=True)
    tloader = _loader(dataset, seed=3)
    tloader.num_workers = 2
    assert len(tloader) == len(jloader) == 4
    for _ in range(2):
        got, want = list(tloader), list(jloader)
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    assert random_split(10, 0.34, seed=2) == jax_random_split(10, 0.34, seed=2)
    ds = TS40K(dataset, "fit")
    assert list(ds.npy_files) == list(jds.npy_files) and len(Subset(ds, [1, 2])) == 2
    xyz, labels = ds[0]
    assert xyz.shape[0] == 1 and xyz.shape[2] == 3 and labels.shape == xyz.shape[:2]


# ---- config and CLI ----------------------------------------------------------

def _chip_smoke():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    return chip_smoke


def test_smoke_set_list_is_the_defaults_yaml():
    """The --set list chip_smoke.py passes equals experiments/defaults.yaml,
    key by key and, once loaded, field by field (also under the JAX loader)."""
    import yaml

    overrides = tcli.parse_overrides(_chip_smoke().DEFAULTS_SET)
    with open(os.path.join(ROOT, "experiments", "defaults.yaml")) as f:
        assert set(overrides) == set(yaml.safe_load(f))
    got = load_config(None, overrides)
    want = load_config(os.path.join(ROOT, "experiments", "defaults.yaml"))
    for field in dataclasses.fields(ExperimentConfig):
        assert getattr(got, field.name) == getattr(want, field.name), field.name
    assert dataclasses.asdict(jax_load_config(None, overrides)) == dataclasses.asdict(got)
    assert got.batch_size == 16 and got.kernel_size == (9, 5, 5) and got.voxel_size is None


def _cli_cfg(root, tmp_path, **kw):
    base = dict(data_path=root, output_dir=str(tmp_path), batch_size=2,
                voxel_grid_size=GRID, kernel_size=KS, max_points=MAX_POINTS, max_epochs=2,
                num_workers=2, early_stop_metric=None, val_split=0.25)
    base.update(kw)
    return ExperimentConfig(**base)


def test_cli_run_trains_and_tests(dataset, tmp_path, capsys):
    scores = tcli.run(_cli_cfg(dataset, tmp_path), device="cpu")
    out = capsys.readouterr().out
    assert "[device_cache auto] -> false" in out and "A6" in out
    assert "[test] using best 'train_FBetaScore' checkpoint" in out
    assert math.isfinite(scores["train_loss"]) and math.isfinite(scores["val_loss"])
    assert math.isfinite(scores["test_loss"]) and "test_F1Score" in scores
    ckpt = tmp_path / "scenenet_ts40k" / "checkpoints"
    assert (ckpt / "last.npz").exists()
    assert any(f.name.startswith("train_FBetaScore_step") for f in ckpt.iterdir())
    # the JAX package reads the port's checkpoint
    _, template = JaxSceneNet.create(kernel_size=KS, seed=0)
    restored = _jflat(jax_restore(str(ckpt / "last.npz"), template))
    port = restore_checkpoint(str(ckpt / "last.npz"), SceneNet.create(kernel_size=KS, seed=0))
    for n, v in port.state_dict().items():
        np.testing.assert_array_equal(restored[n], v.numpy())
    assert set(restored) == set(port.state_dict())


def test_cli_main_with_set_overrides(dataset, tmp_path, capsys):
    """--set alone (no YAML), --device cpu, the cuda backend's plain path,
    and resuming from the checkpoint the first run left."""
    args = ["--device", "cpu", "--set", f"data_path={dataset}", f"output_dir={tmp_path}",
            "batch_size=2", f"voxel_grid_size={GRID}", f"max_points={MAX_POINTS}",
            "max_epochs=1", "num_workers=1", "device_cache=False", "model_backend=cuda",
            "test_checkpoint=last", "val_split=0.0"]
    first = tcli.main(args)
    assert math.isfinite(first["train_loss"]) and "val_loss" not in first
    second = tcli.main(args + ["--set", "resume_from_checkpoint=True"])
    assert math.isfinite(second["test_loss"])
    assert "[device_cache auto]" not in capsys.readouterr().out


def test_backend_resolution():
    cfg = ExperimentConfig()
    assert tcli.resolve_backend(cfg, torch.device("cpu")) == "torch"
    assert tcli.resolve_backend(cfg, torch.device("cuda")) == "cuda"
    for name, want in (("xla", "torch"), ("pallas", "cuda"), ("cuda", "cuda"),
                       ("pallas_mxu", "cuda_mxu"), ("cuda_mxu", "cuda_mxu")):
        assert tcli.resolve_backend(ExperimentConfig(model_backend=name),
                                    torch.device("cpu")) == want
    with pytest.raises(ValueError):
        tcli.resolve_backend(ExperimentConfig(model_backend="nope"), torch.device("cpu"))


def test_cli_model_backend_pallas_mxu_trains(dataset, tmp_path):
    """model_backend: pallas_mxu (the JAX package's name) resolves to
    cuda_mxu and trains through the CLI; on the CPU its plain versions."""
    scores = tcli.run(_cli_cfg(dataset, tmp_path, model_backend="pallas_mxu", max_epochs=1),
                      device="cpu")
    assert math.isfinite(scores["train_loss"]) and math.isfinite(scores["test_loss"])


def test_cuda_mxu_backend_grads_match_jax_pallas_mxu():
    """Value and parameter gradients of sum(model(x)²) with backend
    cuda_mxu against the JAX model with backend pallas_mxu (its kernel in
    interpret mode), at that package's own bounds for the pair."""
    import scenenet_tpu.ops.pallas_conv as pc

    jnet, jparams = JaxSceneNet.create({"cy": 1, "cone": 1, "neg": 1}, kernel_size=KS,
                                       seed=5, backend="pallas_mxu")
    x = (np.random.default_rng(43).random((2, 1, 16, 16, 16)) > 0.5).astype(np.float32)
    orig = pc.fused_geneo_conv_mxu
    patch = pytest.MonkeyPatch()
    patch.setattr(pc, "fused_geneo_conv_mxu", lambda x_, k_, interpret=False: orig(x_, k_, True))
    try:
        want_v, want_g = jax.value_and_grad(
            lambda p: jnp.sum(jnet.apply(p, jnp.asarray(x)) ** 2))(jparams)
    finally:
        patch.undo()
    net = SceneNet.create({"cy": 1, "cone": 1, "neg": 1}, kernel_size=KS, seed=5,
                          backend="cuda_mxu")
    v = (net(torch.from_numpy(x)) ** 2).sum()
    v.backward()
    np.testing.assert_allclose(float(v.detach()), float(want_v), rtol=1e-4)
    want_g = _jflat(want_g)
    for name, p in net.named_parameters():
        got = p.grad.numpy() if p.grad is not None else np.zeros((), np.float32)
        np.testing.assert_allclose(got, want_g[name], rtol=2e-3, atol=2e-3, err_msg=name)


def test_cuda_mxu_fit_stays_close_to_torch_backend(batches, tmp_path):
    """Three train steps with the tensor-core forward: finite, and each
    loss within rtol 1e-3 of the plain backend's (near-f32 forward, the
    same exact backward)."""
    trainers = {b: _port_trainer(tmp_path, b) for b in ("cuda_mxu", "torch")}
    for t in trainers.values():
        t.setup_optimizer()
    for b in batches:
        losses = {k: float(t.train_step(tmetrics.init_metric_state(), *t.to_device(b))[1])
                  for k, t in trainers.items()}
        assert math.isfinite(losses["cuda_mxu"])
        np.testing.assert_allclose(losses["cuda_mxu"], losses["torch"], rtol=1e-3)
    for (n, a), b in zip(trainers["cuda_mxu"].model.named_parameters(),
                         trainers["torch"].model.parameters()):
        assert math.isfinite(float(a.detach())), n
        np.testing.assert_allclose(float(a.detach()), float(b.detach()), rtol=0, atol=1e-4,
                                   err_msg=n)


def test_cli_default_device_is_cuda(dataset, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.run(_cli_cfg(dataset, tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["--set", f"data_path={dataset}"])


@pytest.mark.parametrize("overrides,item", [
    ({"model": "quantile"}, "A8"), ({"model": "cnn"}, "A8"), ({"model": "unet"}, "A8"),
    ({"dataset": "semantic_kitti"}, "A0"), ({"mesh_data": 2}, "A12"),
    ({"mesh_space": 2}, "A12"), ({"mesh_dcn_data": 2}, "A12"),
    ({"mesh_ensemble": 3}, "A12"), ({"mesh_channel": 2}, "A12"),
    ({"constrained": "admm"}, "A7"), ({"auto_lr_find": True}, "A7"),
    ({"auto_scale_batch_size": True}, "A7"), ({"model_backend": "autotune"}, "A7"),
    ({"fast_dev_run": True}, "A10"),
    ({"device_voxelization": False}, "A0"), ({"geneo_init": "smart"}, "A2"),
    ({"export_stablehlo": True}, "A11"), ({"use_wandb": True}, "A10"),
    ({"device_cache": "points"}, "A6"), ({"device_cache": "grids"}, "A6"),
    ({"device_cache": True}, "A6"), ({"precision": "bf16"}, "A13"),
    ({"accumulate_grad_batches": 2}, "A13"), ({"checkpoint_every_n_steps": 5}, "A7"),
    ({"optimizer": "lbfgs"}, "A7"), ({"criterion": "dice_bce"}, "A9"),
])
def test_cli_unported_config_raises(dataset, tmp_path, overrides, item):
    with pytest.raises(NotImplementedError, match=item):
        tcli.run(_cli_cfg(dataset, tmp_path, **overrides), device="cpu")


PORTED_SINCE = {"use_indices", "unbinarized", "host_indices"}  # B8, B7, B8: they raised once


@pytest.mark.parametrize("case,item", [
    ("sweep", "A10"), ("use_indices", "B8"), ("unbinarized", "B7"), ("mesh", "A12"),
    ("resume_from", "A7"), ("host_indices", "B8"),
])
def test_unported_entry_points_raise(case, item, tmp_path):
    """What is not ported raises, naming its ROADMAP item; the entry points
    ported since (``PORTED_SINCE``) must now work instead."""
    cfg = TrainConfig(run_dir=str(tmp_path / "r"), checkpoint_dir=str(tmp_path / "c"))
    net = SceneNet.create(kernel_size=(3, 3, 3))
    calls = {
        "sweep": lambda: tcli.main(["--device", "cpu", "--sweep", "sweep.yaml"]),
        "use_indices": lambda: make_device_voxelize_prep(GRID, use_indices=True),
        "unbinarized": lambda: make_device_voxelize_prep(GRID, binarize=(True, False)),
        "mesh": lambda: Trainer(net, resolve_criterion("mse")(), cfg, mesh=object()),
        "resume_from": lambda: Trainer(net, resolve_criterion("mse")(), cfg).fit(
            [], resume_from="snapshot.npz"),
        "host_indices": lambda: PointPadding(max_points=64, vxg_size=GRID,
                                             compute_indices=True),
    }
    if case not in PORTED_SINCE:
        with pytest.raises(NotImplementedError, match=item):
            calls[case]()
        return
    rng = np.random.default_rng(0)
    xyz, labels = rng.uniform(0, 9, (40, 3)) + 100.0, rng.choice([2, 15], 40)
    pts, lab, mask, flat = PointPadding(max_points=64, vxg_size=GRID,
                                        compute_indices=True)((xyz, labels))
    made = calls[case]()
    if case == "host_indices":
        assert made((xyz, labels))[3].max() > 0 and flat[40:].max() == 0
        return
    x, y = made(*(torch.from_numpy(a)[None] for a in (pts, lab, mask, flat)))
    assert x.shape == y.shape == (1, 1, 16, 16, 16)
    assert float(x.sum()) > 0 and 0 < float(y.max()) <= 1
    if case == "unbinarized":  # y is the tower fraction, not its indicator
        assert set(x.unique().tolist()) == {0.0, 1.0}
        want = tv.voxelize_batch(torch.from_numpy(pts)[None], torch.from_numpy(lab)[None],
                                 torch.from_numpy(mask)[None], (15,), GRID)[1]
        assert torch.equal(y[0, 0], want[0])


def test_save_checkpoint_then_restore_roundtrip(tmp_path):
    net = SceneNet.create(kernel_size=KS, seed=2)
    save_checkpoint(str(tmp_path / "a.npz"), net, {"step": 1})
    other = restore_checkpoint(str(tmp_path / "a.npz"), SceneNet.create(kernel_size=KS, seed=2))
    for (n, a), b in zip(other.state_dict().items(), net.state_dict().values()):
        assert torch.equal(a, b), n
    assert json.load(open(tmp_path / "a.json")) == {"step": 1}


# ---- the host-exact route (bins from the host in float64) and the counts grids ----

def _crops(seed=3):
    """Two crops on a 1 cm lattice in world coordinates (points on voxel
    edges, where only the float64 host index is exact), one longer than
    MAX_POINTS."""
    rng = np.random.default_rng(seed)
    out = []
    for m in (3000, 5000):
        xyz = np.round(rng.uniform([0, 0, 0], [30, 24, 45], (m, 3)), 2) + [4.1e5, 5.2e6, 300.0]
        out.append((xyz, rng.choice([1, 2, 15], size=m, p=[0.5, 0.35, 0.15])))
    return out


@pytest.mark.parametrize("vxg_size,vox_size", [((16, 16, 16), None), ((12, 10, 14), None),
                                               ((64, 64, 64), (2.0, 2.0, 3.0))])
def test_point_padding_host_indices_equal_jax(vxg_size, vox_size):
    """PointPadding(compute_indices=True) against the JAX transform on its
    numpy route: all four arrays exact, with bin counts and with voxel
    sizes, on a short cloud and on one that is subsampled."""
    port = PointPadding(max_points=MAX_POINTS, vxg_size=vxg_size, vox_size=vox_size,
                        compute_indices=True)
    ref = JaxPointPadding(max_points=MAX_POINTS, vxg_size=vxg_size, vox_size=vox_size,
                          use_native=False, compute_indices=True)
    for sample in _crops():
        got, want = port(sample), ref(sample)
        assert len(got) == len(want) == 4
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        n = min(len(sample[0]), MAX_POINTS)
        assert got[3][:n].max() > 0 and not got[3][n:].any() and got[2].sum() == n
    # the default stays the device-binned route: no index is made
    assert not PointPadding(max_points=MAX_POINTS)(_crops()[0])[3].any()


def _index_loader(root, seed=0):
    ds = TS40K(root, "fit", transform=PointPadding(max_points=MAX_POINTS, vxg_size=GRID,
                                                   compute_indices=True))
    return PointCloudLoader(ds, 2, shuffle=True, num_workers=1, seed=seed, drop_last=True)


@pytest.fixture(scope="module")
def index_batches(dataset, batches):
    """The same batches as ``batches``, with the host-exact flat index."""
    out = list(_index_loader(dataset))[:3]
    for (p, l, m, f), (p0, l0, m0, _) in zip(out, batches):
        assert np.array_equal(p, p0) and np.array_equal(m, m0) and f.max() > 0
    return out


@pytest.mark.parametrize("binarize", [(True, True), (True, False), (False, True),
                                      (False, False)])
@pytest.mark.parametrize("use_indices", [True, False])
def test_device_voxelize_prep_matches_jax(index_batches, use_indices, binarize):
    """Every branch of the prep against the JAX prep on the same batch:
    binarized grids exact, hist and reg within 1e-6 (one f32 division)."""
    batch = index_batches[0]
    want = jax_prep(GRID, (15,), binarize=binarize, use_indices=use_indices)(
        *(jnp.asarray(a) for a in batch))
    got = make_device_voxelize_prep(GRID, (15,), binarize=binarize, use_indices=use_indices)(
        *(torch.from_numpy(a) for a in batch))
    for g, w, binary in zip(got, want, binarize):
        assert g.shape == (2, 1, 16, 16, 16) and g.dtype == torch.float32
        if binary:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            assert set(g.unique().tolist()) == {0.0, 1.0}
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)
            assert len(g.unique()) > 2
    # without a flat_idx in the batch, use_indices falls to the device bins
    no_idx = make_device_voxelize_prep(GRID, (15,), binarize=binarize, use_indices=True)(
        *(torch.from_numpy(a) for a in batch[:3]))
    dev = make_device_voxelize_prep(GRID, (15,), binarize=binarize)(
        *(torch.from_numpy(a) for a in batch))
    assert all(torch.equal(a, b) for a, b in zip(no_idx, dev))


@pytest.fixture(scope="module")
def jax_index_steps(index_batches, tmp_path_factory):
    """Three JAX train steps on the host-exact route (its prep's default)."""
    tmp = tmp_path_factory.mktemp("jax_index_steps")
    jnet, jparams = JaxSceneNet.create(kernel_size=KS, seed=SEED, backend="xla")
    config = JaxTrainConfig(run_dir=str(tmp / "run"), checkpoint_dir=str(tmp / "ckpt"),
                            learning_rate=LR, early_stop_metric=None, max_epochs=1)
    trainer = JaxTrainer(jnet, jax_criterion("geneo_tversky")(**DEFAULTS), config,
                         batch_prep=jax_prep(GRID, (15,), use_indices=True))
    state, tx = create_train_state(jparams, "adam", LR, jnet.trainable_mask(jparams))
    step, _ = trainer._build_steps(tx)
    losses, counts = [], []
    for b in index_batches:
        state, m, loss, _ = step(state, jmetrics.init_metric_state(),
                                 *(jnp.asarray(a) for a in b))
        losses.append(float(loss))
        counts.append(jmetrics.metric_counts(m))
    return losses, counts, _jflat(state.params)


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_three_host_exact_train_steps_match_jax(backend, index_batches, jax_index_steps,
                                                tmp_path):
    """A 3-step fit from host-exact indices against the JAX Trainer: losses
    rtol 1e-4, parameters 1e-5, confusion counts exact."""
    want_losses, want_counts, want_params = jax_index_steps
    trainer = _port_trainer(tmp_path, backend)
    trainer.batch_prep = make_device_voxelize_prep(GRID, (15,), use_indices=True)
    trainer.setup_optimizer()
    for i, b in enumerate(index_batches):
        m, loss = trainer.train_step(tmetrics.init_metric_state(), *trainer.to_device(b))
        np.testing.assert_allclose(float(loss), want_losses[i], rtol=1e-4)
        assert tmetrics.metric_counts(m) == want_counts[i]
    assert sum(c[0] for c in want_counts) > 0
    for name, p in trainer.model.named_parameters():
        np.testing.assert_allclose(float(p.detach()), want_params[name], rtol=0, atol=1e-5,
                                   err_msg=name)


def test_tower_fraction_target_trains(index_batches, tmp_path):
    """binarize=(True, False): the density input binarized, the target the
    tower fraction; three finite, falling-or-equal-scale steps that move
    the parameters."""
    trainer = _port_trainer(tmp_path, "cuda")
    trainer.batch_prep = make_device_voxelize_prep(GRID, (15,), binarize=(True, False))
    trainer.setup_optimizer()
    before = {n: float(p.detach()) for n, p in trainer.model.named_parameters()}
    for b in index_batches:
        _, loss = trainer.train_step(tmetrics.init_metric_state(), *trainer.to_device(b))
        assert math.isfinite(float(loss))
    moved = [n for n, p in trainer.model.named_parameters() if float(p.detach()) != before[n]]
    assert len(moved) >= trainer.model.num_trainable_params() // 2


def _spy(monkeypatch, name):
    calls = []
    real = getattr(tv, name)

    def wrapped(*a, **k):
        calls.append(name)
        return real(*a, **k)

    monkeypatch.setattr(tv, name, wrapped)
    return calls


def test_cli_host_indices_trains(dataset, tmp_path, monkeypatch, capsys):
    """--host-indices: the loader makes the float64 bin index and the device
    counts it (bin_counts), never the raw-points kernels."""
    k7, k3 = _spy(monkeypatch, "bin_counts"), _spy(monkeypatch, "points_binary")
    args = ["--device", "cpu", "--host-indices", "--set", f"data_path={dataset}",
            f"output_dir={tmp_path}", "batch_size=2", f"voxel_grid_size={GRID}",
            f"max_points={MAX_POINTS}", "max_epochs=1", "num_workers=1", "val_split=0.25"]
    scores = tcli.main(args)
    assert math.isfinite(scores["train_loss"]) and math.isfinite(scores["val_loss"])
    assert math.isfinite(scores["test_loss"]) and "test_F1Score" in scores
    assert len(k7) >= 3 + 1 + 1 and not k3  # train steps, val and test batches
    # the same through run(), and without the flag the raw-points kernel bins
    k7.clear()
    plain = tcli.run(_cli_cfg(dataset, tmp_path / "dev", max_epochs=1), device="cpu")
    assert math.isfinite(plain["train_loss"]) and k3 and not k7
    exact = tcli.run(_cli_cfg(dataset, tmp_path / "host", max_epochs=1), device="cpu",
                     host_indices=True)
    assert math.isfinite(exact["train_loss"]) and k7


@pytest.mark.parametrize("host_indices", [False, True])
def test_cli_trains_at_a_sorted_route_size(dataset, tmp_path, monkeypatch, host_indices):
    """A grid and pad length at which the JAX package's routing predicate
    holds ((64,64,128) with 196608 padded points): the train CLI goes
    through sorted_bin_counts on both routes, and trains."""
    grid, n_pad = (64, 64, 128), 196608
    assert tv._sorted_route(n_pad, grid) and not tv._sorted_route(MAX_POINTS, grid)
    k8 = _spy(monkeypatch, "sorted_bin_counts")
    others = _spy(monkeypatch, "points_binary") + _spy(monkeypatch, "bin_counts")
    cfg = _cli_cfg(dataset, tmp_path, voxel_grid_size=grid, max_points=n_pad, max_epochs=1,
                   batch_size=4, val_split=0.0, test_checkpoint="last")
    scores = tcli.run(cfg, device="cpu", host_indices=host_indices)
    assert math.isfinite(scores["train_loss"]) and math.isfinite(scores["test_loss"])
    assert len(k8) >= 2 + 1 and not others  # 8 fit crops = 2 steps, then the test batch
