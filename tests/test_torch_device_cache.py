"""Port parity: the device-resident epochs (caches, cached fits, the CLI's
route) in torch vs the JAX package, and the cached fits vs the port's own
streaming fit.

At a small size (16³ grid, batch 2, 4096 padded points, kernel (9,5,5),
the defaults' geneo_tversky weights), on the CPU, where a cached step runs
eagerly; the CUDA graph that replays it on a card is held against the
eager steps by the card tests and the smoke. The clouds have uniform random
float coordinates, on which the port's multiply bin recipe and JAX's CPU
divide recipe agree (checked first).

Tolerances: losses rtol 1e-5, parameters atol 1e-5, confusion counts
exact; scores 1e-6 against JAX (f32 there, float64 from int64 counts here).
The D4 transform is exact, the z-rotation 1e-6 on unit-scale coordinates.
Against the JAX package the cache holds exactly one batch, so the
permutation (JAX's PRNG bits are not reproduced) only reorders samples
inside a batch, and every loss and gradient is a sum over the batch.
"""

import dataclasses
import json
import math
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import scenenet_tpu.train.loop as jax_loop
from scenenet_tpu.cli.train import _resolve_device_cache_auto as jax_resolve_auto
from scenenet_tpu.data import PointPadding as JaxPointPadding
from scenenet_tpu.data import TS40K as JaxTS40K
from scenenet_tpu.data.device_cache import DeviceGridCache as JaxGridCache
from scenenet_tpu.data.device_cache import DevicePointCache as JaxPointCache
from scenenet_tpu.data.device_cache import d4_transform_grids as jax_d4
from scenenet_tpu.data.device_cache import rotate_z_batch as jax_rotate
from scenenet_tpu.data.loader import Subset as JaxSubset
from scenenet_tpu.losses import resolve_criterion as jax_criterion
from scenenet_tpu.models import SceneNet as JaxSceneNet
from scenenet_tpu.train import TrainConfig as JaxTrainConfig
from scenenet_tpu.train import Trainer as JaxTrainer
from scenenet_tpu.train import make_device_voxelize_prep as jax_prep
from scenenet_tpu.train import metrics as jmetrics
from scenenet_tpu.train.preempt import chunk_starts as jax_chunk_starts
from scenenet_tpu.utils.config import ExperimentConfig as JaxExperimentConfig
from scenenet_tpu_torch.cli import train as tcli
from scenenet_tpu_torch.data import PointPadding, Subset, TS40K
from scenenet_tpu_torch.data.device_cache import (
    CacheLoader, DeviceGridCache, DevicePointCache, augment_points, build_cache_batch,
    d4_transform_grids, permute_rows, rotate_z_batch,
)
from scenenet_tpu_torch.losses import resolve_criterion
from scenenet_tpu_torch.models import SceneNet
from scenenet_tpu_torch.ops import cuda_hist
from scenenet_tpu_torch.ops import voxelize as tv
from scenenet_tpu_torch.train import TrainConfig, Trainer, make_device_voxelize_prep
from scenenet_tpu_torch.train.preempt import chunk_starts
from scenenet_tpu_torch.utils.config import ExperimentConfig

GRID = (16, 16, 16)
KS = (9, 5, 5)
MAX_POINTS = 4096
LR = 1e-3
SEED = 55  # a draw whose first gradients are all well away from 0
DEFAULTS = dict(weight_alpha=1, weight_epsilon=0.1, mse_weight=1, convex_weight=5,
                tversky_alpha=2, tversky_beta=1, tversky_smooth=1e-6, focal_gamma=4)
EPOCHS = 3


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """A TS40K-style directory of 8 fit and 2 test crops, uniform random
    float coordinates."""
    root = tmp_path_factory.mktemp("ts40k_cache")
    rng = np.random.default_rng(1)
    for split, n in [("fit", 8), ("test", 2)]:
        (root / split).mkdir()
        for i in range(n):
            m = int(rng.integers(2000, 4000))
            xyz = rng.uniform([0, 0, 0], [30, 30, 60], (m, 3))
            labels = rng.choice([1, 2, 15], size=m, p=[0.5, 0.35, 0.15])
            np.save(root / split / f"sample_{i}.npy",
                    np.concatenate([xyz, labels[:, None]], axis=1))
    return str(root)


def _port_ds(root, idx=None):
    ds = TS40K(root, "fit", transform=PointPadding(max_points=MAX_POINTS,
                                                        compute_indices=False))
    return ds if idx is None else Subset(ds, idx)


def _check_recipes(cache):
    """The port's multiply bin recipe and the divide recipe agree here."""
    p, m = cache.points, cache.mask
    assert torch.equal(cuda_hist.flat_ids_mul(p, m, GRID)[m], tv.batch_flat_ids(p, m, GRID)[m])


def _port_trainer(tmp_path, tag="a", batch_prep=True, **cfg):
    net = SceneNet.create(kernel_size=KS, seed=SEED, backend="torch")
    cfg.setdefault("max_epochs", EPOCHS)
    config = TrainConfig(run_dir=str(tmp_path / f"run_{tag}"),
                         checkpoint_dir=str(tmp_path / f"ckpt_{tag}"),
                         learning_rate=LR, early_stop_metric=None, **cfg)
    prep = make_device_voxelize_prep(GRID, (15,), use_indices=False) if batch_prep else None
    return Trainer(net, resolve_criterion("geneo_tversky")(**DEFAULTS), config,
                   batch_prep=prep)


def _params(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def _jflat(tree):
    return {".".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _losses(run_dir):
    return [json.loads(line)["train_loss"] for line in open(run_dir / "metrics.jsonl")
            if "train_loss" in json.loads(line)]


# ---- the cache functions -------------------------------------------------------

def test_d4_transform_grids_equals_jax_exactly():
    """All 8 elements of D4, per sample, on uint8 and f32 grids."""
    rng = np.random.default_rng(0)
    grid = rng.integers(0, 2, (8, 2, 3, 6, 6)).astype(np.uint8)
    bits = np.array([[(i >> j) & 1 for i in range(8)] for j in range(3)], bool)
    for dtype in (np.uint8, np.float32):
        g = grid.astype(dtype)
        want = np.asarray(jax_d4(jnp.asarray(g), *(jnp.asarray(b) for b in bits)))
        got = d4_transform_grids(torch.from_numpy(g), *(torch.from_numpy(b) for b in bits))
        assert got.dtype == torch.from_numpy(g).dtype
        np.testing.assert_array_equal(got.numpy(), want)
    assert len({got[i].numpy().tobytes() for i in range(8)}) == 8
    with pytest.raises(ValueError, match="square"):
        d4_transform_grids(torch.zeros((1, 1, 2, 3, 4)), *(torch.zeros(1, dtype=bool),) * 3)


def test_rotate_z_batch_and_flips_equal_jax():
    """The rotation about each sample's xy centroid (1e-6), and the flips
    of the cached fit's augmentation built on it."""
    rng = np.random.default_rng(1)
    pts = rng.random((3, 500, 3)).astype(np.float32)
    angles = rng.uniform(0, 2 * np.pi, 3).astype(np.float32)
    want = np.asarray(jax_rotate(jnp.asarray(pts), jnp.asarray(angles)))
    got = rotate_z_batch(torch.from_numpy(pts), torch.from_numpy(angles)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[..., 2], pts[..., 2])
    flips = np.array([[True, False], [False, True], [True, True]])
    center = want[..., :2].mean(axis=1, keepdims=True)
    want_flipped = np.concatenate(
        [(want[..., :2] - center) * np.where(flips, -1.0, 1.0)[:, None] + center,
         want[..., 2:]], axis=-1)
    got = augment_points(torch.from_numpy(pts), torch.from_numpy(angles),
                         torch.from_numpy(flips)).numpy()
    np.testing.assert_allclose(got, want_flipped, rtol=0, atol=1e-6)


def test_chunk_starts_equals_jax():
    for n_batches in (1, 4, 7, 125):
        for k in (1, 2, 3, 8, 200):
            assert chunk_starts(n_batches, k) == [tuple(c) for c in
                                                  jax_chunk_starts(n_batches, k)]


def test_point_cache_holds_the_dataset(dataset):
    ds = _port_ds(dataset)
    cache = DevicePointCache(ds, "cpu", load_batch=3)  # ragged loads
    want = JaxPointCache(JaxTS40K(dataset, "fit", transform=JaxPointPadding(
        max_points=MAX_POINTS, compute_indices=False)))
    assert len(cache) == len(want) == 8
    for got, ref, dtype in ((cache.points, want.points, torch.float32),
                            (cache.labels, want.labels, torch.int32),
                            (cache.mask, want.mask, torch.bool)):
        assert got.dtype == dtype
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    order = torch.tensor([3, 1, 7])
    assert torch.equal(permute_rows(cache.labels, order), cache.labels[order])
    # an epoch of the loader view: every sample once, augmented batches keep
    # z, labels and mask
    loader = CacheLoader(cache, 3, generator=torch.Generator().manual_seed(0), augment=True)
    batches = list(loader)
    assert len(loader) == len(batches) == 2
    seen = torch.cat([b[1] for b in batches])
    assert sorted(seen[:, 0].tolist()) != [] and seen.shape == (6, MAX_POINTS)
    tail = list(cache.epoch(3, generator=torch.Generator().manual_seed(0), drop_last=False))
    assert [len(b[0]) for b in tail] == [3, 3, 2]
    pts, lab, m = build_cache_batch(cache.points, cache.labels, cache.mask, 2, 2, False)
    assert torch.equal(pts, cache.points[2:4]) and torch.equal(m, cache.mask[2:4])
    with pytest.raises(ValueError, match="Generator"):
        next(cache.epoch(2))


def test_grid_cache_equals_jax_and_refuses_lossy_storage(dataset):
    """uint8 training grids equal the JAX package's, and equal the prep's
    f32 grids; a non-binarized prep is refused under uint8 and kept under
    float32."""
    cache = DevicePointCache(_port_ds(dataset), "cpu")
    _check_recipes(cache)
    prep = make_device_voxelize_prep(GRID, (15,), use_indices=False)
    grids = DeviceGridCache(cache, prep, load_batch=3)
    assert grids.x.dtype == grids.y.dtype == torch.uint8 and len(grids) == 8
    jcache = JaxPointCache(JaxTS40K(dataset, "fit", transform=JaxPointPadding(
        max_points=MAX_POINTS, compute_indices=False)))
    jgrids = JaxGridCache(jcache, jax_prep(GRID, (15,), use_indices=False))
    np.testing.assert_array_equal(grids.x.numpy(), np.asarray(jgrids.x))
    np.testing.assert_array_equal(grids.y.numpy(), np.asarray(jgrids.y))
    x, y = prep(cache.points, cache.labels, cache.mask)
    assert torch.equal(grids.x.float(), x) and torch.equal(grids.y.float(), y)
    frac = make_device_voxelize_prep(GRID, (15,), binarize=(True, False), use_indices=False)
    with pytest.raises(ValueError, match="store_dtype=torch.float32"):
        DeviceGridCache(cache, frac)
    exact = DeviceGridCache(cache, frac, store_dtype=torch.float32)
    assert torch.equal(exact.y, frac(cache.points, cache.labels, cache.mask)[1])


# ---- the cached fits against the JAX Trainer's, one batch a cache ------------------

@pytest.fixture(scope="module")
def one_batch_jax(dataset, tmp_path_factory):
    """The JAX Trainer's fit_grid_cached and fit_cached (augment=False, 3
    epochs) on a cache of samples 1 and 5: per-epoch losses and counts, and
    the parameters after them."""
    jds = JaxSubset(JaxTS40K(dataset, "fit", transform=JaxPointPadding(
        max_points=MAX_POINTS, compute_indices=False)), [1, 5])
    out = {}
    for route in ("grids", "points"):
        tmp = tmp_path_factory.mktemp(f"jax_{route}")
        jnet, jparams = JaxSceneNet.create(kernel_size=KS, seed=SEED, backend="xla")
        cfg = JaxTrainConfig(run_dir=str(tmp / "run"), checkpoint_dir=str(tmp / "ckpt"),
                             learning_rate=LR, early_stop_metric=None, max_epochs=EPOCHS)
        prep = jax_prep(GRID, (15,), use_indices=False)
        trainer = JaxTrainer(jnet, jax_criterion("geneo_tversky")(**DEFAULTS), cfg,
                             batch_prep=prep)
        counts = []
        orig = jax_loop.compute_metrics
        patch = pytest.MonkeyPatch()
        patch.setattr(jax_loop, "compute_metrics", lambda m, b: (
            counts.append(jmetrics.metric_counts(m)), orig(m, b))[1])
        try:
            cache = JaxPointCache(jds)
            if route == "grids":
                params, best = trainer.fit_grid_cached(
                    jparams, JaxGridCache(cache, prep), batch_size=2, augment=False,
                    key=jax.random.PRNGKey(0))
            else:
                params, best = trainer.fit_cached(jparams, cache, batch_size=2,
                                                  augment=False, key=jax.random.PRNGKey(0))
        finally:
            patch.undo()
        out[route] = (_losses(tmp / "run"), counts, _jflat(params), best)
    return out


@pytest.mark.parametrize("route", ["grids", "points"])
def test_one_batch_cached_fit_matches_jax(route, dataset, one_batch_jax, tmp_path):
    want_losses, want_counts, want_params, want_best = one_batch_jax[route]
    cache = DevicePointCache(_port_ds(dataset, [1, 5]), "cpu")
    _check_recipes(cache)
    trainer = _port_trainer(tmp_path)
    gen = torch.Generator().manual_seed(0)
    if route == "grids":
        model, best = trainer.fit_grid_cached(DeviceGridCache(cache, trainer.batch_prep),
                                              batch_size=2, augment=False, generator=gen)
    else:
        model, best = trainer.fit_cached(cache, batch_size=2, augment=False, generator=gen)
    assert trainer.step == EPOCHS and trainer.cached_epochs.runner.eager_calls == EPOCHS
    np.testing.assert_allclose(_losses(tmp_path / "run_a"), want_losses, rtol=1e-5)
    assert trainer.train_counts == want_counts
    assert sum(c[0] for c in want_counts) > 0  # some tower voxels predicted
    for name, p in model.named_parameters():
        np.testing.assert_allclose(float(p.detach()), want_params[name], rtol=0, atol=1e-5,
                                   err_msg=name)
    for k, v in want_best.items():
        if k.startswith("train_") and not k.endswith("loss"):
            np.testing.assert_allclose(best[k], v, rtol=0, atol=1e-6, err_msg=k)


# ---- the cached fits against the port's streaming fit, several batches an epoch ----

class _GridLoader:
    """The streaming twin of fit_grid_cached(augment=False): each epoch one
    permutation from ``generator``, batches of f32 grids in its order."""

    def __init__(self, grids, batch_size, generator):
        self.grids, self.batch_size, self.generator = grids, batch_size, generator

    def __iter__(self):
        n = len(self.grids)
        order = torch.randperm(n, generator=self.generator)
        for b in range(n // self.batch_size):
            rows = order[b * self.batch_size:(b + 1) * self.batch_size]
            yield self.grids.x[rows].float(), self.grids.y[rows].float()


@pytest.fixture(scope="module")
def cache8(dataset):
    cache = DevicePointCache(_port_ds(dataset), "cpu")
    _check_recipes(cache)
    return cache


@pytest.mark.parametrize("route", ["grids", "points"])
def test_cached_fit_matches_streaming_fit(route, cache8, tmp_path):
    """4 batches an epoch, 3 epochs, the same order of batches: the cached
    fit trains as Trainer.fit on the streamed batches."""
    cached = _port_trainer(tmp_path, "cached")
    streamed = _port_trainer(tmp_path, "streamed", batch_prep=route == "points")
    if route == "grids":
        grids = DeviceGridCache(cache8, cached.batch_prep)
        cached.fit_grid_cached(grids, 2, augment=False,
                               generator=torch.Generator().manual_seed(4))
        streamed.fit(_GridLoader(grids, 2, torch.Generator().manual_seed(4)))
    else:
        cached.fit_cached(cache8, 2, augment=False, generator=torch.Generator().manual_seed(4))
        streamed.fit(CacheLoader(cache8, 2, generator=torch.Generator().manual_seed(4)))
    assert cached.step == streamed.step == 4 * EPOCHS
    np.testing.assert_allclose(_losses(tmp_path / "run_cached"),
                               _losses(tmp_path / "run_streamed"), rtol=1e-5)
    assert cached.train_counts == streamed.train_counts
    for (n, a), b in zip(cached.model.named_parameters(), streamed.model.parameters()):
        np.testing.assert_allclose(float(a.detach()), float(b.detach()), rtol=0, atol=1e-5,
                                   err_msg=n)


@pytest.fixture(scope="module")
def one_chunk_fit(cache8, tmp_path_factory):
    trainer = _port_trainer(tmp_path_factory.mktemp("chunks1"))
    trainer.fit_cached(cache8, 2, augment=True, generator=torch.Generator().manual_seed(9))
    return _params(trainer.model), trainer.train_counts


@pytest.mark.parametrize("chunks", [1, 2, 3])
def test_epoch_chunks_give_the_same_fit(chunks, cache8, one_chunk_fit, tmp_path):
    """An epoch in 1, 2 or 3 chunks (the partition of chunk_starts) trains
    the same, augmentation included: the draws are the epoch's."""
    trainer = _port_trainer(tmp_path, epoch_chunks=chunks)
    trainer.fit_cached(cache8, 2, augment=True, generator=torch.Generator().manual_seed(9))
    want_params, want_counts = one_chunk_fit
    assert trainer.train_counts == want_counts
    for n, p in trainer.model.named_parameters():
        assert torch.equal(p.detach(), want_params[n]), n


def test_augmentation_changes_the_fit_and_d4_keeps_grids_binary(cache8, tmp_path):
    """augment=True draws a fresh D4 element a sample and visit: the fit
    differs from augment=False on the same permutations, and stays finite."""
    runs = {}
    for augment in (True, False):
        t = _port_trainer(tmp_path, str(augment), max_epochs=2)
        grids = DeviceGridCache(cache8, t.batch_prep)
        _, best = t.fit_grid_cached(grids, 2, augment=augment,
                                    generator=torch.Generator().manual_seed(1))
        assert math.isfinite(best["train_loss"])
        runs[augment] = _params(t.model)
    assert any(not torch.equal(runs[True][n], runs[False][n]) for n in runs[True])


def test_evaluate_cached_equals_evaluate_and_jax(dataset, cache8, tmp_path):
    """5 samples at batch 2 (a ragged tail of 1): the scores of evaluate
    on the same batches, the loss weighted by the samples of each batch;
    and the JAX package's evaluate_cached."""
    trainer = _port_trainer(tmp_path, batch_prep=False)
    grids = DeviceGridCache(DevicePointCache(_port_ds(dataset, [0, 2, 3, 6, 7]), "cpu"),
                            make_device_voxelize_prep(GRID, (15,), use_indices=False))
    got = trainer.evaluate_cached(grids, batch_size=2, prefix="t")
    batches = [(grids.x[i:i + 2].float(), grids.y[i:i + 2].float()) for i in (0, 2, 4)]
    want = trainer.evaluate(batches, prefix="t")
    for k in want:
        if not k.endswith("loss"):
            assert got[k] == want[k], k
    losses = [float(trainer._loss(x, y)[0]) for x, y in batches]
    np.testing.assert_allclose(got["t_loss"], (2 * losses[0] + 2 * losses[1] + losses[2]) / 5,
                               rtol=1e-6)
    jnet, jparams = JaxSceneNet.create(kernel_size=KS, seed=SEED, backend="xla")
    jtrainer = JaxTrainer(jnet, jax_criterion("geneo_tversky")(**DEFAULTS), JaxTrainConfig(
        run_dir=str(tmp_path / "jrun"), checkpoint_dir=str(tmp_path / "jckpt")))
    jds = JaxSubset(JaxTS40K(dataset, "fit", transform=JaxPointPadding(
        max_points=MAX_POINTS, compute_indices=False)), [0, 2, 3, 6, 7])
    jgrids = JaxGridCache(JaxPointCache(jds), jax_prep(GRID, (15,), use_indices=False))
    jwant = jtrainer.evaluate_cached(jparams, jgrids, batch_size=2, prefix="t")
    for k, v in jwant.items():
        tol = dict(rtol=1e-5) if k.endswith("loss") else dict(rtol=0, atol=1e-6)
        np.testing.assert_allclose(got[k], v, err_msg=k, **tol)


@pytest.mark.parametrize("case", ["stateful", "small", "device", "resume"])
def test_cached_fits_refuse(case, cache8, tmp_path, capsys):
    from scenenet_tpu_torch.models import UNet3D

    trainer = _port_trainer(tmp_path)
    if case == "stateful":
        trainer.model = UNet3D.create(seed=0)
        with pytest.raises(ValueError, match="stateless"):
            trainer.fit_cached(cache8, 2)
    elif case == "small":
        with pytest.raises(ValueError, match="< batch"):
            trainer.fit_cached(cache8, 9)
    elif case == "device":
        cache8_meta = type("C", (), {"device": torch.device("meta"), "__len__": lambda s: 8})()
        with pytest.raises(ValueError, match="meta"):
            trainer.fit_grid_cached(cache8_meta, 2)
    else:
        # resuming is ported since (A7): a snapshot that is not there is refused
        # with a printed line, and the fit starts fresh
        trainer.config.max_epochs = 1
        trainer.fit_cached(cache8, 2, resume_from=str(tmp_path / "snapshot.npz"))
        assert "unusable" in capsys.readouterr().out
        assert trainer.step == 4 and not trainer.preempted


def test_debug_nans_stops_a_cached_fit(cache8, tmp_path):
    trainer = _port_trainer(tmp_path, debug_nans=True)
    inner = trainer.criterion
    trainer.criterion = lambda *a: inner(*a) * float("nan")
    with pytest.raises((FloatingPointError, RuntimeError)):
        trainer.fit_cached(cache8, 2)
    assert not torch.is_anomaly_enabled()


# ---- the CLI's route -----------------------------------------------------------

@pytest.mark.parametrize("overrides,want", [
    ({}, "grids"), ({"augment": True}, "points"), ({"model": "unet"}, False),
    ({"model": "cnn"}, "grids"), ({"device_voxelization": False}, False),
    ({"voxel_grid_size": (256, 256, 256)}, False),
])
def test_device_cache_auto_equals_jax(overrides, want, capsys):
    """The decision and the line it prints, on the CPU's 16 GiB budget, for
    2000 crops (TS40K's size; 500000 where nothing fits)."""
    n = 500_000 if "voxel_grid_size" in overrides else 2000
    assert jax_resolve_auto(JaxExperimentConfig(data_path="x", **overrides), n) == want
    jax_line = capsys.readouterr().out
    got = tcli._resolve_device_cache_auto(ExperimentConfig(data_path="x", **overrides), n,
                                          torch.device("cpu"))
    assert got == want
    assert capsys.readouterr().out == jax_line


def test_resolve_device_cache_values(capsys):
    cpu = torch.device("cpu")
    for value, want in (("points", "points"), ("grids", "grids"), (True, "points"),
                        ("true", "points"), (False, False), ("false", False), (None, False)):
        assert tcli.resolve_device_cache(ExperimentConfig(device_cache=value), 10, cpu) == want
    assert tcli.resolve_device_cache(ExperimentConfig(), 10, cpu, host_indices=True) is False
    assert "--host-indices" in capsys.readouterr().out
    with pytest.raises(ValueError, match="host-indices"):
        tcli.resolve_device_cache(ExperimentConfig(device_cache="grids"), 10, cpu, True)
    with pytest.raises(ValueError, match="device_cache"):
        tcli.resolve_device_cache(ExperimentConfig(device_cache="hbm"), 10, cpu)


def test_cli_defaults_train_through_the_grid_cache(dataset, tmp_path, capsys):
    """The defaults' route (device_cache auto, augment false) prints the
    JAX CLI's decision and trains through fit_grid_cached: the same fit as
    device_cache=grids, and the same as the point cache without
    augmentation."""
    base = ["--device", "cpu", "--set", f"data_path={dataset}", "batch_size=2",
            f"voxel_grid_size={GRID}", f"max_points={MAX_POINTS}", "max_epochs=2",
            "num_workers=1", "early_stop_metric=None", "val_split=0.25"]
    scores = {}
    for value in ("auto", "grids", "points"):
        scores[value] = tcli.main(base + [f"output_dir={tmp_path / value}",
                                          f"device_cache={value}"])
        out = capsys.readouterr().out
        assert ("[device_cache auto] -> 'grids'" in out) == (value == "auto")
    timeless = {k: {m: v for m, v in s.items() if m != "epoch_time_s"}
                for k, s in scores.items()}
    assert timeless["auto"] == timeless["grids"]
    for k in ("train_loss", "val_loss", "test_loss"):
        np.testing.assert_allclose(scores["points"][k], scores["grids"][k], rtol=1e-5)


def test_train_config_fields_equal_jax():
    """Every field of the JAX TrainConfig, in its order, with its default."""
    want = [(f.name, f.default) for f in dataclasses.fields(JaxTrainConfig)]
    got = [(f.name, f.default) for f in dataclasses.fields(TrainConfig)]
    assert got == want


@pytest.mark.parametrize("field,value,error,match", [
    ("use_wandb", True, None, "[RunLogger] wandb disabled ("),
    ("compiler_options", {"xla_tpu_run_space_to_batch": "false"}, ValueError, "XLA"),
])
def test_train_config_refuses_what_the_port_does_not_take(field, value, error, match,
                                                          tmp_path, monkeypatch, capsys):
    if error is None:
        # ported since (A10): the reference's behaviour, a wandb that does not
        # import is reported and the trainer is made
        monkeypatch.setitem(sys.modules, "wandb", None)
        assert _port_trainer(tmp_path, **{field: value}).config.use_wandb
        assert match in capsys.readouterr().out
    else:
        with pytest.raises(error, match=match):
            _port_trainer(tmp_path, **{field: value})
    _port_trainer(tmp_path, compiler_options={})  # empty: nothing asked for


def test_run_logger_signature_and_sweep_runs(tmp_path, monkeypatch, capsys):
    """RunLogger takes the JAX signature and, as there, reports a wandb that
    does not import; --sweep draws --sweep-runs configs (ported since, A10)
    and reads its spec as the JAX CLI does."""
    from scenenet_tpu_torch.utils.logging import RunLogger

    RunLogger(str(tmp_path / "r"), use_wandb=False, wandb_kwargs=None).close()
    monkeypatch.setitem(sys.modules, "wandb", None)
    RunLogger(str(tmp_path / "w"), use_wandb=True).close()
    assert "[RunLogger] wandb disabled (" in capsys.readouterr().out
    seen = []
    monkeypatch.setattr(tcli, "run_sweep", lambda draws, *a, **kw: seen.append(draws))
    (tmp_path / "s.yaml").write_text("parameters:\n  learning_rate: {values: [0.1, 0.2]}\n")
    tcli.main(["--device", "cpu", "--sweep", str(tmp_path / "s.yaml"), "--sweep-runs", "2"])
    assert len(seen[0]) == 2 and all(d["learning_rate"] in (0.1, 0.2) for d in seen[0])
