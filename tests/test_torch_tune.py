"""Port parity: the tuners and the CLI's dev switches, mirroring
``tests/test_tune.py``.

- ``lr_range_test`` against the JAX package's on the same batches: the
  same suggested learning rate and the smoothed-loss history rtol 1e-5
  (f32 losses summed in another order, carried through 12 Adam steps);
- ``find_max_batch_size``'s doubling, its start failure and a non-OOM
  error raised, with torch's out-of-memory error;
- ``autotune_backend``'s pick, cache, out-of-memory skip and all-OOM
  raise (the measurement monkeypatched), and a real measurement with Adam
  and with L-BFGS;
- the CLI: ``model_backend: autotune`` falling back under ``--device
  cpu``, refusing a non-SceneNet model, ``fast_dev_run``,
  ``auto_lr_find`` and ``auto_scale_batch_size``.
"""

import json
import math

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from scenenet_tpu.losses import resolve_criterion as jax_criterion
from scenenet_tpu.models import SceneNet as JaxSceneNet
from scenenet_tpu.train.tune import lr_range_test as jax_lr_range_test
from scenenet_tpu_torch.cli import train as tcli
from scenenet_tpu_torch.losses import resolve_criterion
from scenenet_tpu_torch.models import SceneNet
from scenenet_tpu_torch.train import tune
from scenenet_tpu_torch.train.tune import (
    _is_oom, find_max_batch_size, lr_range_test, measure_train_step_ms,
)
from scenenet_tpu_torch.utils.config import ExperimentConfig

CRIT = dict(tversky_alpha=2, tversky_beta=1, tversky_smooth=1e-6, focal_gamma=4)


def _toy(batch=2, grid=12, n=3, seed=0):
    rng = np.random.default_rng(seed)
    return [((rng.random((batch, 1, grid, grid, grid)) > 0.9).astype(np.float32),
             (rng.random((batch, 1, grid, grid, grid)) > 0.97).astype(np.float32))
            for _ in range(n)]


def _crit():
    return resolve_criterion("focal_tversky")(**CRIT)


def test_lr_range_test_matches_jax():
    batches = _toy()
    jnet, jparams = JaxSceneNet.create(kernel_size=(9, 5, 5), seed=0)
    want_lr, want = jax_lr_range_test(jnet, jax_criterion("focal_tversky")(**CRIT), jparams,
                                      batches, min_lr=1e-4, max_lr=0.5, steps=12)
    net = SceneNet.create(kernel_size=(9, 5, 5), seed=0)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    lr, hist = lr_range_test(net, _crit(), batches, min_lr=1e-4, max_lr=0.5, steps=12)
    assert 1e-4 <= lr <= 0.5 and lr == pytest.approx(want_lr, rel=1e-12)
    assert len(hist) == len(want) >= 3
    np.testing.assert_allclose([h[0] for h in hist], [h[0] for h in want], rtol=1e-12)
    np.testing.assert_allclose([h[1] for h in hist], [h[1] for h in want], rtol=1e-5)
    # the model is untouched: the test trains a copy
    assert all(torch.equal(v, before[k]) for k, v in net.state_dict().items())


def test_lr_range_test_lbfgs_raises():
    net = SceneNet.create(kernel_size=(9, 5, 5), seed=0)
    with pytest.raises(NotImplementedError):
        lr_range_test(net, _crit(), _toy(), optimizer="lbfgs")


def test_find_max_batch_size_doubles_until_oom():
    calls = []

    def probe(b):
        calls.append(b)
        if b > 16:
            raise torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")

    assert find_max_batch_size(probe, start=2) == 16
    assert calls == [2, 4, 8, 16, 32]
    assert find_max_batch_size(lambda b: None, start=3, max_batch=20) == 12


def test_find_max_batch_size_start_failure_raises():
    def probe(b):
        raise torch.OutOfMemoryError("CUDA out of memory")

    with pytest.raises(RuntimeError):
        find_max_batch_size(probe, start=4)


def test_find_max_batch_size_non_oom_propagates():
    def probe(b):
        if b > 2:
            raise ValueError("shape mismatch")

    with pytest.raises(ValueError):
        find_max_batch_size(probe, start=2)


@pytest.mark.parametrize("exc,oom", [
    (torch.OutOfMemoryError("x"), True),
    (RuntimeError("CUDA out of memory. Tried to allocate 20.00 MiB"), True),
    (RuntimeError("RESOURCE_EXHAUSTED: out of memory"), True),
    (MemoryError(), True),
    (RuntimeError("shape mismatch"), False),
    (TypeError("bad argument"), False),
])
def test_is_oom(exc, oom):
    assert _is_oom(exc) is oom


def _make(backend):
    return SceneNet.create(kernel_size=(9, 5, 5), seed=0, backend=backend)


def test_autotune_measures_picks_and_caches(tmp_path, monkeypatch):
    calls = []

    def fake_measure(model, criterion, x, y, optimizer="sgd", iters=6, graph=False):
        assert graph is False  # a graph needs a card: the CPU times eager steps
        calls.append(model.backend)
        return {"cuda": 5.0, "cuda_mxu": 2.0}[model.backend]

    monkeypatch.setattr(tune, "measure_train_step_ms", fake_measure)
    cache = str(tmp_path / "autotune.json")
    winner, times = tune.autotune_backend(_make, _crit(), 2, (12, 12, 12), cache_path=cache)
    assert winner == "cuda_mxu" and times == {"cuda": 5.0, "cuda_mxu": 2.0}
    assert calls == ["cuda", "cuda_mxu"]
    # a hit: nothing measured again
    assert tune.autotune_backend(_make, _crit(), 2, (12, 12, 12),
                                 cache_path=cache) == (winner, times)
    assert len(calls) == 2
    # another shape is another key
    tune.autotune_backend(_make, _crit(), 4, (12, 12, 12), cache_path=cache)
    assert len(calls) == 4
    # refresh measures a cached key again
    tune.autotune_backend(_make, _crit(), 2, (12, 12, 12), cache_path=cache, refresh=True)
    assert len(calls) == 6
    assert not [p for p in tmp_path.iterdir() if p.name != "autotune.json"]  # atomic replace


def test_autotune_oom_candidate_is_skipped(tmp_path, monkeypatch, capsys):
    def fake(model, criterion, x, y, optimizer="sgd", iters=6, graph=False):
        if model.backend == "cuda_mxu":
            raise torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 1.00 TiB")
        return 3.0

    monkeypatch.setattr(tune, "measure_train_step_ms", fake)
    winner, times = tune.autotune_backend(_make, _crit(), 2, (12, 12, 12),
                                          cache_path=str(tmp_path / "c.json"))
    assert winner == "cuda" and times["cuda_mxu"] == float("inf")
    assert "'cuda_mxu' OOMs" in capsys.readouterr().out


def test_autotune_all_oom_raises(tmp_path, monkeypatch):
    def fake(*a, **k):
        raise torch.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(tune, "measure_train_step_ms", fake)
    with pytest.raises(RuntimeError, match="OOM"):
        tune.autotune_backend(_make, _crit(), 2, (12, 12, 12),
                              cache_path=str(tmp_path / "c.json"))


def test_autotune_non_oom_error_propagates(tmp_path, monkeypatch):
    def fake(*a, **k):
        raise TypeError("shape bug")

    monkeypatch.setattr(tune, "measure_train_step_ms", fake)
    with pytest.raises(TypeError):
        tune.autotune_backend(_make, _crit(), 2, (12, 12, 12),
                              cache_path=str(tmp_path / "c.json"))


@pytest.mark.parametrize("optimizer", ["adam", "lbfgs"])
def test_real_measurement_runs(tmp_path, optimizer):
    """Unmocked: a real timed step on the plain backend at a tiny size (a
    CPU time, checked only for being positive), and the autotune over it."""
    net = SceneNet.create(kernel_size=(3, 3, 3), seed=0)
    x, y = (torch.from_numpy(a) for a in _toy(grid=8, n=1)[0])
    before = {k: v.clone() for k, v in net.state_dict().items()}
    assert measure_train_step_ms(net, _crit(), x, y, optimizer=optimizer, iters=2) > 0
    assert all(torch.equal(v, before[k]) for k, v in net.state_dict().items())
    winner, times = tune.autotune_backend(
        lambda b: SceneNet.create(kernel_size=(3, 3, 3), seed=0, backend=b), _crit(), 2,
        (8, 8, 8), candidates=("torch",), optimizer=optimizer, iters=2,
        cache_path=str(tmp_path / "c.json"))
    assert winner == "torch" and times["torch"] > 0


# ---- the CLI's switches -------------------------------------------------------

def _cfg(tmp_path, small_cloud, **kw):
    root = tmp_path / "ds"
    for split in ("fit", "test"):
        (root / split).mkdir(parents=True, exist_ok=True)
        for i in range(4):
            np.save(root / split / f"s{i}.npy", small_cloud)
    base = dict(data_path=str(root), output_dir=str(tmp_path / "out"), batch_size=2,
                voxel_grid_size=(12, 12, 12), max_epochs=5, num_workers=1,
                early_stop_metric=None, val_split=0.0, device_voxelization=True,
                max_points=4096)
    base.update(kw)
    return ExperimentConfig(**base)


def test_cli_fast_dev_run(tmp_path, small_cloud, capsys):
    scores = tcli.run(_cfg(tmp_path, small_cloud, fast_dev_run=True), device="cpu")
    assert math.isfinite(scores["test_loss"])
    out = capsys.readouterr().out
    assert "[fast_dev_run] one epoch, one batch a split" in out
    assert (tmp_path / "out" / "scenenet_ts40k" / "metrics.jsonl").read_text().count(
        '"train_loss"') == 1


def test_cli_auto_lr_find_updates_lr(tmp_path, small_cloud, capsys):
    scores = tcli.run(_cfg(tmp_path, small_cloud, auto_lr_find=True, max_epochs=1),
                      device="cpu")
    assert math.isfinite(scores["test_loss"])
    assert "[auto_lr_find] suggested learning_rate" in capsys.readouterr().out


def test_cli_auto_lr_find_keeps_lbfgs_rate(tmp_path, small_cloud, capsys):
    scores = tcli.run(_cfg(tmp_path, small_cloud, auto_lr_find=True, max_epochs=1,
                           optimizer="lbfgs"), device="cpu")
    assert math.isfinite(scores["test_loss"])
    assert "[auto_lr_find] skipped" in capsys.readouterr().out


def test_cli_auto_scale_batch_size(tmp_path, small_cloud, capsys):
    """The probe doubles from batch_size up to the training set (4 samples)."""
    scores = tcli.run(_cfg(tmp_path, small_cloud, auto_scale_batch_size=True, max_epochs=1),
                      device="cpu")
    assert math.isfinite(scores["test_loss"])
    assert "[auto_scale_batch_size] batch_size 2 → 4" in capsys.readouterr().out


@pytest.mark.parametrize("grid,n_train,want", [
    ((64, 64, 64), 51, 51),             # the training set
    ((64, 64, 64), 100000, 4096),       # the JAX package's cap
    ((128, 128, 128), 100000, 1023),    # B·Z·X·Y < 2³¹, the kernels' limit
    ((64, 64, 256), 5000, 2047),
    ((1024, 1024, 1024), 100000, 16),   # never below the configured batch
])
def test_batch_probe_limit(grid, n_train, want):
    cfg = ExperimentConfig(voxel_grid_size=grid, batch_size=16)
    assert tcli.batch_probe_limit(cfg, n_train) == want
    assert want == 16 or want * math.prod(grid) < 2**31


def test_cli_rejects_non_scenenet_autotune(tmp_path):
    with pytest.raises(ValueError, match="autotune"):
        tcli.run(ExperimentConfig(data_path=str(tmp_path), model="cnn",
                                  model_backend="autotune", output_dir=str(tmp_path)),
                 device="cpu")


def test_cli_autotune_falls_back_on_the_cpu(tmp_path, small_cloud, capsys):
    scores = tcli.run(_cfg(tmp_path, small_cloud, fast_dev_run=True,
                           model_backend="autotune"), device="cpu")
    assert math.isfinite(scores["test_loss"])
    assert "[autotune] no CUDA device (--device cpu); using model_backend=auto" in \
        capsys.readouterr().out


def test_autotune_key_carries_the_route(tmp_path):
    """The cache key names the route the timing took, so an eager entry is
    never reused for a replayed run; on the CPU ``graph`` times eager
    steps and files them under the eager key."""
    args = ("cpu", 2, (8, 8, 8), "adam", ("torch",), "")
    assert tune.autotune_cache_key(*args, True) != tune.autotune_cache_key(*args, False)
    assert json.loads(tune.autotune_cache_key(*args, True))["route"] == "graph"
    cache = tmp_path / "c.json"
    tune.autotune_backend(
        lambda b: SceneNet.create(kernel_size=(3, 3, 3), seed=0, backend=b), _crit(), 2,
        (8, 8, 8), candidates=("torch",), optimizer="adam", iters=1, cache_path=str(cache),
        graph=True)
    assert list(json.loads(cache.read_text())) == [tune.autotune_cache_key(*args, False)]


@pytest.mark.parametrize("device,optimizer,replays", [
    ("cpu", "adam", False), ("cuda", "adam", True), ("cuda", "sgd", True),
    ("cuda", "lbfgs", False), ("cuda", "lbfgs_instance", False)])
def test_trains_by_replay_is_the_cached_fits_rule(device, optimizer, replays):
    """One rule says whether a cached fit replays its step and so how
    autotune times it: on a card, any optimizer but L-BFGS, by name or by
    instance (the instance is the one a cached fit sees)."""
    from scenenet_tpu_torch.train.lbfgs import LBFGS
    from scenenet_tpu_torch.train.loop import trains_by_replay

    if optimizer == "lbfgs_instance":
        optimizer = LBFGS([torch.zeros(2, requires_grad=True)], lr=1.0)
    assert trains_by_replay(torch.device(device), optimizer) is replays
