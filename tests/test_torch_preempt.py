"""Preemption-safe training in the port, mirroring ``tests/test_preempt.py``.

A fit preempted mid-epoch (by ``request_preemption``, by a periodic
snapshot left behind when the process dies, or by a real SIGTERM to a
``cli.train`` process) and resumed must end on parameters *bit-identical*
to a straight run's: on the grid cache, the point cache and the streamed
``fit`` (whose list loader gives the same batches every epoch), under
gradient accumulation, bf16 and L-BFGS. No tolerance: the resumed run does
the same arithmetic in the same order. The lifecycle cases (a snapshot
discarded after completion, a corrupt one, another pipeline's, another
chunk partition, another model shape) start fresh with a printed line.
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

import torch

from scenenet_tpu.train.preempt import chunk_starts as jax_chunk_starts
from scenenet_tpu_torch.data.device_cache import DeviceGridCache, DevicePointCache
from scenenet_tpu_torch.losses import resolve_criterion
from scenenet_tpu_torch.models import SceneNet
from scenenet_tpu_torch.train import TrainConfig, Trainer, make_device_voxelize_prep
from scenenet_tpu_torch.train import metrics as tmetrics
from scenenet_tpu_torch.train.loop import CachedEpochs
from scenenet_tpu_torch.train.preempt import (
    SNAPSHOT_NAME, PreemptionGuard, chunk_starts, discard_snapshot,
    load_train_snapshot_if_compatible, request_preemption, restore_train_snapshot,
    save_train_snapshot,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KS = (9, 5, 5)


def _grids(n, g, seed):
    rng = np.random.default_rng(seed)
    cache = DeviceGridCache.__new__(DeviceGridCache)
    cache.x = torch.from_numpy((rng.random((n, 1, g, g, g)) > 0.9).astype(np.uint8))
    cache.y = torch.from_numpy((rng.random((n, 1, g, g, g)) > 0.97).astype(np.uint8))
    return cache


def _trainer(tmp_path, tag, model=None, prep=None, **kw):
    net = model or SceneNet.create(kernel_size=KS, seed=3)
    cfg = TrainConfig(checkpoint_dir=str(tmp_path / f"c{tag}"), run_dir=str(tmp_path / f"r{tag}"),
                      early_stop_metric=None, log_gradients=False, **kw)
    return Trainer(net, resolve_criterion("mse")(), cfg, batch_prep=prep)


def _snap(trainer):
    return os.path.join(trainer.config.checkpoint_dir, SNAPSHOT_NAME)


def _cursor(trainer):
    with open(_snap(trainer)[:-4] + ".json") as f:
        return json.load(f)["cursor"]


def _same(a: Trainer, b: Trainer):
    for (name, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), name
    assert a.train_counts[-1] == b.train_counts[-1]


def test_chunk_starts_match_jax():
    for n, k in [(16, 4), (10, 4), (3, 8), (5, 1), (125, 8), (7, 3), (1, 1)]:
        assert chunk_starts(n, k) == jax_chunk_starts(n, k)
        assert sum(length for _, length in chunk_starts(n, k)) == n


def test_save_restore_roundtrip(tmp_path):
    trainer = _trainer(tmp_path, "s", optimizer="adam")
    trainer.setup_optimizer()
    grids = _grids(2, 12, 0)
    trainer.train_step(tmetrics.init_metric_state(), grids.x.float(), grids.y.float())
    state = trainer.train_state()
    mstate = tmetrics.MetricState(*(torch.tensor(i, dtype=torch.int64) for i in range(4)))
    keys = {"generator": torch.Generator().manual_seed(5).get_state()}
    path = str(tmp_path / "snap.npz")
    save_train_snapshot(path, state, mstate, torch.tensor(2.5), keys,
                        {"epoch": 3, "next_chunk": 2, "step": 19})
    rstate, rmstate, rloss, rkeys, cursor = restore_train_snapshot(path, state, keys)
    assert cursor == {"epoch": 3, "next_chunk": 2, "step": 19}
    assert float(rloss) == 2.5 and tmetrics.metric_counts(rmstate) == (0, 1, 2, 3)
    assert torch.equal(rkeys["generator"], keys["generator"])
    assert set(rstate) == set(state) and any(k.startswith("optimizer/") for k in state)
    for k, v in state.items():
        assert torch.equal(rstate[k], v.detach().cpu()), k
    # another structure (one name short) is refused
    short = dict(state)
    short.pop("step")
    with pytest.raises(ValueError):
        restore_train_snapshot(path, short, keys)


def test_guard_latches_sigterm_and_restores_handler():
    before = signal.getsignal(signal.SIGTERM)
    with PreemptionGuard() as guard:
        assert not guard.triggered
        os.kill(os.getpid(), signal.SIGTERM)
        time.sleep(0.05)
        assert guard.triggered
    assert signal.getsignal(signal.SIGTERM) is before
    request_preemption()
    with PreemptionGuard() as guard:
        assert guard.triggered
    with PreemptionGuard() as guard:  # cleared on exit
        assert not guard.triggered


@pytest.mark.parametrize("options", [
    {}, {"accumulate_grad_batches": 2}, {"precision": "bf16"},
    {"optimizer": "lbfgs", "learning_rate": 0.8},
])
def test_grid_cached_resume_bit_identical(tmp_path, options):
    """Preempted at the first chunk boundary of epoch 0, then resumed: the
    final parameters equal a straight run's bit for bit."""
    grids = _grids(24, 12, 1)
    kw = dict(max_epochs=3, epoch_chunks=3, **options)
    straight = _trainer(tmp_path, "s", **kw)
    straight.fit_grid_cached(grids, 4, augment=True, generator=torch.Generator().manual_seed(4))
    t1 = _trainer(tmp_path, "k", **kw)
    request_preemption()
    t1.fit_grid_cached(grids, 4, augment=True, generator=torch.Generator().manual_seed(4))
    assert t1.preempted
    assert _cursor(t1) == {"kind": "chunk", "epoch": 0, "next_chunk": 1, "n_chunks": 3,
                           "step": 2}
    t2 = _trainer(tmp_path, "k2", **kw)
    t2.fit_grid_cached(grids, 4, augment=True, generator=torch.Generator().manual_seed(4),
                       resume_from=_snap(t1))
    assert not t2.preempted and t2.step == straight.step == 18
    _same(straight, t2)


def test_point_cached_resume_bit_identical(tmp_path):
    """The same through the point cache: the voxelization every step and the
    point-space augmentation drawn for the epoch carried across."""
    cache = _points()
    prep = make_device_voxelize_prep((12, 12, 12), (15,), use_indices=False)
    kw = dict(max_epochs=2, epoch_chunks=3, prep=prep)
    straight = _trainer(tmp_path, "s", **kw)
    straight.fit_cached(cache, 4, augment=True, generator=torch.Generator().manual_seed(8))
    t1 = _trainer(tmp_path, "k", **kw)
    request_preemption()
    t1.fit_cached(cache, 4, augment=True, generator=torch.Generator().manual_seed(8))
    assert t1.preempted
    t2 = _trainer(tmp_path, "k2", **kw)
    t2.fit_cached(cache, 4, augment=True, generator=torch.Generator().manual_seed(8),
                  resume_from=_snap(t1))
    _same(straight, t2)


class _Killed(Exception):
    """Stands for the process dying hard (SIGKILL) mid-run."""


def _points(n=24, seed=6):
    rng = np.random.default_rng(seed)
    return DevicePointCache([(rng.random((256, 3)).astype(np.float32) * 10.0,
                              rng.integers(0, 20, 256).astype(np.int32), np.ones(256, bool))
                             for _ in range(n)], "cpu")


@pytest.mark.parametrize("route", ["grids", "points"])
def test_cached_periodic_snapshot_resume(tmp_path, monkeypatch, route):
    """checkpoint_every_n_steps: the fit dies hard in epoch 1 and the last
    periodic snapshot it left (at a chunk boundary) resumes bit-identically."""
    if route == "grids":
        data, prep = _grids(24, 12, 2), None
    else:
        data, prep = _points(), make_device_voxelize_prep((12, 12, 12), (15,), use_indices=False)
    kw = dict(max_epochs=3, epoch_chunks=3, checkpoint_every_n_steps=2, prep=prep)

    def fit(t, **extra):
        run = t.fit_grid_cached if route == "grids" else t.fit_cached
        run(data, 4, augment=True, generator=torch.Generator().manual_seed(1), **extra)

    straight = _trainer(tmp_path, "s", **kw)
    fit(straight)
    assert not os.path.exists(_snap(straight))  # discarded on completion
    run_chunk = CachedEpochs.run_chunk
    calls = []

    def dying(self, index):
        calls.append(index)
        if len(calls) == 5:  # epoch 1's second chunk
            raise _Killed
        return run_chunk(self, index)

    monkeypatch.setattr(CachedEpochs, "run_chunk", dying)
    t1 = _trainer(tmp_path, "k", **kw)
    with pytest.raises(_Killed):
        fit(t1)
    assert _cursor(t1)["epoch"] == 1 and _cursor(t1)["next_chunk"] == 1
    monkeypatch.setattr(CachedEpochs, "run_chunk", run_chunk)
    t2 = _trainer(tmp_path, "k2", **kw)
    fit(t2, resume_from=_snap(t1))
    _same(straight, t2)


def _batch_list(n=6, seed=2, g=12):
    rng = np.random.default_rng(seed)
    return [((rng.random((2, 1, g, g, g)) > 0.9).astype(np.float32),
             (rng.random((2, 1, g, g, g)) > 0.97).astype(np.float32)) for _ in range(n)]


@pytest.mark.parametrize("how", ["request", "periodic"])
def test_fit_batch_path_resume(tmp_path, how):
    """The streamed fit: stopped after a step (a programmatic SIGTERM) or
    dead after its periodic snapshot, the resume skips the epoch's taken
    batches and ends on the straight run's parameters."""
    batches = _batch_list()
    straight = _trainer(tmp_path, "s", max_epochs=2)
    straight.fit(batches)
    if how == "request":
        t1 = _trainer(tmp_path, "k", max_epochs=2, checkpoint_every_n_steps=1)
        request_preemption()
        t1.fit(batches)
        assert t1.preempted
        cursor = _cursor(t1)
        assert (cursor["epoch"], cursor["next_batch"], cursor["kind"]) == (0, 1, "batch")
    else:
        class DyingLoader:  # the same batches every epoch, until the 10th batch
            served = 0

            def __iter__(self):
                for b in batches:
                    if self.served == 9:
                        raise _Killed
                    self.served += 1
                    yield b

        t1 = _trainer(tmp_path, "k", max_epochs=2, checkpoint_every_n_steps=2)
        with pytest.raises(_Killed):
            t1.fit(DyingLoader())
        cursor = _cursor(t1)
        assert (cursor["epoch"], cursor["next_batch"]) == (1, 2)
    t2 = _trainer(tmp_path, "k2", max_epochs=2)
    t2.fit(batches, resume_from=_snap(t1))
    _same(straight, t2)


def test_discarded_after_completed_fits(tmp_path):
    t = _trainer(tmp_path, "d", max_epochs=2, epoch_chunks=2, checkpoint_every_n_steps=1)
    t.fit_grid_cached(_grids(16, 12, 1), 4, augment=False)
    assert not t.preempted and not os.path.exists(_snap(t))
    assert not os.path.exists(_snap(t)[:-4] + ".json")
    t = _trainer(tmp_path, "db", max_epochs=1, checkpoint_every_n_steps=2)
    t.fit(_batch_list(4))
    assert not t.preempted and not os.path.exists(_snap(t))


def test_corrupt_snapshot_starts_fresh(tmp_path, capsys):
    t = _trainer(tmp_path, "c", max_epochs=1, epoch_chunks=2)
    os.makedirs(t.config.checkpoint_dir, exist_ok=True)
    with open(_snap(t), "wb") as f:
        f.write(b"PK\x03\x04 truncated garbage")
    with open(_snap(t)[:-4] + ".json", "w") as f:
        f.write("{")
    t.fit_grid_cached(_grids(16, 12, 1), 4, augment=False, resume_from=_snap(t))
    assert "unusable" in capsys.readouterr().out
    assert t.step == 4


def test_cross_pipeline_snapshot_starts_fresh(tmp_path, capsys):
    t1 = _trainer(tmp_path, "x1", max_epochs=2, epoch_chunks=2)
    request_preemption()
    t1.fit_grid_cached(_grids(16, 12, 1), 4, augment=False)
    assert t1.preempted and os.path.exists(_snap(t1))
    t2 = _trainer(tmp_path, "x2", max_epochs=1)
    t2.fit(_batch_list(3), resume_from=_snap(t1))
    assert "'chunk' fit pipeline" in capsys.readouterr().out
    assert t2.step == 3


def test_changed_epoch_chunks_starts_fresh(tmp_path, capsys):
    t1 = _trainer(tmp_path, "g1", max_epochs=2, epoch_chunks=4)
    request_preemption()
    t1.fit_grid_cached(_grids(16, 12, 1), 4, augment=False)
    t2 = _trainer(tmp_path, "g2", max_epochs=1, epoch_chunks=2)
    t2.fit_grid_cached(_grids(16, 12, 1), 4, augment=False, resume_from=_snap(t1))
    assert "chunk partition" in capsys.readouterr().out
    assert t2.step == 4


def test_changed_model_shape_starts_fresh(tmp_path, capsys):
    t1 = _trainer(tmp_path, "m1", max_epochs=2, epoch_chunks=2)
    request_preemption()
    t1.fit_grid_cached(_grids(16, 12, 1), 4, augment=False)
    other = SceneNet.create({"cy": 2, "cone": 1, "neg": 1}, kernel_size=KS, seed=3)
    t2 = _trainer(tmp_path, "m2", model=other, max_epochs=1, epoch_chunks=2)
    t2.fit_grid_cached(_grids(16, 12, 1), 4, augment=False, resume_from=_snap(t1))
    assert "unusable" in capsys.readouterr().out
    assert t2.step == 4


def test_load_if_compatible_reports_kind(tmp_path):
    t = _trainer(tmp_path, "k", max_epochs=1)
    t.setup_optimizer()
    path = str(tmp_path / "s.npz")
    save_train_snapshot(path, t.train_state(), tmetrics.init_metric_state(), torch.zeros(()),
                        {}, {"kind": "batch", "epoch": 0, "next_batch": 1, "loss_count": 1,
                             "step": 1})
    assert load_train_snapshot_if_compatible(path, t.train_state(), {}, "batch") is not None
    assert load_train_snapshot_if_compatible(path, t.train_state(), {}, "chunk") is None
    discard_snapshot(path)
    assert not os.path.exists(path) and not os.path.exists(path[:-4] + ".json")


# ---- a real SIGTERM to cli.train, and the relaunch that resumes ----------------

def _dataset(root):
    rng = np.random.default_rng(0)
    for split, n in [("fit", 6), ("test", 2)]:
        os.makedirs(os.path.join(root, split))
        for i in range(n):
            m = int(rng.integers(1500, 3000))
            xyz = rng.uniform([0, 0, 0], [30, 30, 60], (m, 3))
            labels = rng.choice([1, 2, 15], size=m, p=[0.5, 0.35, 0.15])
            np.save(os.path.join(root, split, f"sample_{i}.npy"),
                    np.concatenate([xyz, labels[:, None]], axis=1))


def test_sigterm_cli_train_then_relaunch_resumes(tmp_path):
    """A real ``cli.train`` process (the defaults' grid cache, 3 chunks an
    epoch) takes SIGTERM mid-training, flushes its snapshot and finishes;
    the relaunch of the same command resumes from it (``resume_preempted``)
    and its ``last.npz`` equals an unkilled run's bit for bit."""
    data = str(tmp_path / "ds")
    _dataset(data)
    # one compute thread a process: the three runs agree bit for bit at any
    # count, and one keeps them quick beside other test workers
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")

    def launch(out):
        return subprocess.Popen(
            [sys.executable, "-m", "scenenet_tpu_torch.cli.train", "--device", "cpu", "--set",
             f"data_path={data}", f"output_dir={out}", "batch_size=2",
             "voxel_grid_size=(12, 12, 12)", "max_points=2048", "max_epochs=60",
             "num_workers=1", "val_split=0.0", "early_stop_metric=None", "epoch_chunks=3",
             "checkpoint_top_k=1"],
            env=env, cwd=str(tmp_path), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)

    straight = launch(tmp_path / "straight")
    out, _ = straight.communicate(timeout=300)
    assert straight.returncode == 0, out[-3000:]

    killed = launch(tmp_path / "killed")
    metrics = tmp_path / "killed" / "scenenet_ts40k" / "metrics.jsonl"
    deadline = time.time() + 240
    while time.time() < deadline and killed.poll() is None:
        if metrics.exists() and sum(1 for _ in open(metrics)) >= 3:
            break
        time.sleep(0.02)
    assert killed.poll() is None, "finished before the SIGTERM (raise max_epochs)\n" + \
        (killed.communicate()[0] or "")[-2000:]
    killed.send_signal(signal.SIGTERM)
    out, _ = killed.communicate(timeout=120)
    assert killed.returncode == 0, out[-3000:]
    assert "[preempt] SIGTERM: snapshot flushed" in out, out[-3000:]
    ckpt = tmp_path / "killed" / "scenenet_ts40k" / "checkpoints"
    assert (ckpt / SNAPSHOT_NAME).exists()

    relaunch = launch(tmp_path / "killed")
    out, _ = relaunch.communicate(timeout=300)
    assert relaunch.returncode == 0, out[-3000:]
    assert "[preempt] resuming from snapshot" in out
    assert not (ckpt / SNAPSHOT_NAME).exists()
    a = np.load(tmp_path / "straight" / "scenenet_ts40k" / "checkpoints" / "last.npz")
    b = np.load(ckpt / "last.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
