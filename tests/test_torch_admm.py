"""Port parity: ADMM constrained training (``ADMMTrainer``) against the JAX
package's, on one device.

Mirrors ``tests/test_admm.py``'s single-device cases (the CLI mode, the
violation driven down, ``experiments/admm.yaml``'s L-BFGS at learning rate
0.8 and ρ 5, validation scores, checkpoints and early stopping), and adds:

- ``augmented_loss``'s value and gradient against JAX's, rtol 1e-6 (one
  f32 sum over the constraints);
- 3 epochs against the JAX ``ADMMTrainer`` with Adam and with L-BFGS: the
  parameters after every epoch, μ (the JAX side's replayed from its
  parameters by its own dual update, which it does not expose) and
  ``history``, rtol 1e-5 (f32 losses summed in another order, about 1e-6
  relative, carried through a few steps). The L-BFGS run asserts that its
  linesearch decisions sit further than 1e-4 (relative) from their
  thresholds, so that rounding cannot flip one.
"""

import math
import os
from types import SimpleNamespace

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from scenenet_tpu.losses import resolve_criterion as jax_criterion
from scenenet_tpu.models import SceneNet as JaxSceneNet
from scenenet_tpu.train import admm as jadmm
from scenenet_tpu.train.checkpoint import CheckpointManager as JaxCheckpointManager
from scenenet_tpu_torch.cli import train as tcli
from scenenet_tpu_torch.losses import resolve_criterion
from scenenet_tpu_torch.models import SceneNet
from scenenet_tpu_torch.train.admm import (
    ADMMConfig, ADMMTrainer, _constraint_values, augmented_loss,
)
from scenenet_tpu_torch.train.checkpoint import CheckpointManager
from scenenet_tpu_torch.utils.config import ExperimentConfig

KS = (9, 5, 5)
CRIT = dict(tversky_alpha=2, tversky_beta=1, tversky_smooth=1e-6, focal_gamma=4)


def _batches(n=2, seed=0, grid=12):
    rng = np.random.default_rng(seed)
    return [((rng.random((2, 1, grid, grid, grid)) > 0.9).astype(np.float32),
             (rng.random((2, 1, grid, grid, grid)) > 0.97).astype(np.float32))
            for _ in range(n)]


def _violation(net) -> float:
    with torch.no_grad():
        return float(torch.clamp(-_constraint_values(net), min=0).max())


def _cfg(tmp_path, tag, **kw):
    base = dict(checkpoint_dir=str(tmp_path / f"c{tag}"), run_dir=str(tmp_path / f"r{tag}"),
                log_gradients=False)
    base.update(kw)
    return ADMMConfig(**base)


def test_cli_admm_mode(tmp_path, small_cloud, capsys):
    root = tmp_path / "ds"
    for split in ("fit", "test"):
        (root / split).mkdir(parents=True)
        for i in range(4):
            np.save(root / split / f"s{i}.npy", small_cloud)
    cfg = ExperimentConfig(data_path=str(root), output_dir=str(tmp_path / "out"),
                           batch_size=2, voxel_grid_size=(12, 12, 12), max_epochs=2,
                           num_workers=1, early_stop_metric=None, val_split=0.3,
                           device_voxelization=False, constrained="admm", admm_rho=2.0)
    scores = tcli.run(cfg, device="cpu")
    assert math.isfinite(scores["train_loss"]) and math.isfinite(scores["test_loss"])
    assert scores["admm_mu_norm"] >= 0
    assert "[admm] augmented-Lagrangian training (rho=2.0" in capsys.readouterr().out


def test_reduces_constraint_violation(tmp_path):
    seed = 5  # the first draw from 5 on that starts infeasible
    net = SceneNet.create(kernel_size=KS, seed=seed)
    while _violation(net) == 0.0 and seed < 30:
        seed += 1
        net = SceneNet.create(kernel_size=KS, seed=seed)
    start = _violation(net)
    assert start > 0, "no infeasible init found"
    trainer = ADMMTrainer(net, resolve_criterion("mse")(), _cfg(
        tmp_path, "v", max_epochs=6, admm_rho=5.0, optimizer="adam", learning_rate=5e-2))
    _, best = trainer.fit(_batches())
    assert _violation(net) < start * 0.5
    assert trainer.history[-1]["mu_norm"] >= 0 and len(trainer.history) == 6
    assert math.isfinite(best["train_loss"])


def test_admm_yaml_lbfgs_trains(tmp_path):
    """experiments/admm.yaml's optimizer and rates (lbfgs at 0.8, ρ 5, the
    focal Tversky criterion) train and drive the violation down."""
    net = SceneNet.create(kernel_size=KS, seed=5)
    start = _violation(net)
    trainer = ADMMTrainer(net, resolve_criterion("focal_tversky")(**CRIT), _cfg(
        tmp_path, "l", max_epochs=5, admm_rho=5.0, optimizer="lbfgs", learning_rate=0.8))
    _, best = trainer.fit(_batches())
    assert math.isfinite(best["train_loss"])
    assert _violation(net) < start
    assert trainer.optimizer.evaluations >= trainer.step == 10


def test_val_scores_checkpoints_early_stop(tmp_path):
    batches = _batches(3)
    net = SceneNet.create(kernel_size=KS, seed=0)
    trainer = ADMMTrainer(net, resolve_criterion("mse")(), _cfg(
        tmp_path, "e", max_epochs=4, optimizer="adam", learning_rate=1e-2,
        early_stop_metric="val_loss", early_stop_patience=1, admm_rho=1.0))
    _, best = trainer.fit(batches, val_loader=batches[:1])
    assert "val_loss" in best and math.isfinite(best["val_loss"])
    assert os.path.exists(tmp_path / "ce" / "last.npz")
    assert any(f.startswith("val_loss_step") for f in os.listdir(tmp_path / "ce"))
    restored = trainer.restore_best("val_loss", SceneNet.create(kernel_size=KS, seed=1))
    assert set(restored.state_dict()) == set(net.state_dict())
    scores = trainer.evaluate(batches[:1], "test")
    assert math.isfinite(scores["test_loss"])
    assert next(trainer.predict(batches[:1])).shape == batches[0][0].shape
    # early stopping: a patience of 1 ends the fit once val_loss stops improving
    assert 1 <= len(trainer.history) <= 4


def test_mesh_raises_a12(tmp_path):
    net = SceneNet.create(kernel_size=KS, seed=0)
    with pytest.raises(ValueError, match="constrained=admm shards over data/space only"):
        # every mesh axis is ported (A12); ADMM trains over the data and space
        # axes, and refuses the 'model' axis as the JAX CLI does
        ADMMTrainer(net, resolve_criterion("mse")(), _cfg(tmp_path, "m"),
                    mesh=SimpleNamespace(size=2, shape={"data": 1, "model": 2}))


def test_augmented_loss_matches_jax():
    jnet, jparams = JaxSceneNet.create(kernel_size=KS, seed=5)
    net = SceneNet.create(kernel_size=KS, seed=5)
    rng = np.random.default_rng(1)
    n = int(_constraint_values(net).shape[0])
    mu = np.abs(rng.normal(size=n)).astype(np.float32) * (rng.random(n) > 0.3)
    data = np.float32(0.75)

    def jloss(p):
        return jadmm.augmented_loss(jnp.asarray(data), jadmm._constraint_values(jnet, p),
                                    jnp.asarray(mu), 5.0)

    want_v, want_g = jax.value_and_grad(jloss)(jparams)
    got = augmented_loss(torch.tensor(data), _constraint_values(net), torch.from_numpy(mu), 5.0)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want_v), rtol=1e-6)
    want_g = {".".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
              for path, v in jax.tree_util.tree_flatten_with_path(want_g)[0]}
    for name, p in net.named_parameters():
        g = p.grad.numpy() if p.grad is not None else np.zeros(p.shape, np.float32)
        np.testing.assert_allclose(g, want_g[name], rtol=1e-6, atol=1e-7, err_msg=name)
    np.testing.assert_allclose(_constraint_values(net).detach().numpy(),
                               np.asarray(jadmm._constraint_values(jnet, jparams)), rtol=1e-6)


def _record(monkeypatch, cls):
    """Every tree ``cls.step`` checkpoints, as numpy by name."""
    seen = []
    orig = cls.step

    def step(self, tree, scores, epoch):
        if isinstance(tree, torch.nn.Module):
            seen.append({k: v.detach().numpy().copy() for k, v in tree.state_dict().items()})
        else:
            seen.append({".".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
                         for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]})
        return orig(self, tree, scores, epoch)

    monkeypatch.setattr(cls, "step", step)
    return seen


# seed 10 for L-BFGS: a draw whose linesearch decisions all sit clear of f32 rounding
@pytest.mark.parametrize("optimizer,lr,seed", [("adam", 1e-2, 5), ("lbfgs", 0.8, 10)])
def test_three_epochs_match_jax_admm_trainer(tmp_path, monkeypatch, optimizer, lr, seed):
    batches = _batches(2, seed=1)
    rho = 5.0
    jnet, jparams = JaxSceneNet.create(kernel_size=KS, seed=seed)
    jcfg = jadmm.ADMMConfig(max_epochs=3, admm_rho=rho, optimizer=optimizer,
                            learning_rate=lr, checkpoint_dir=str(tmp_path / "cj"),
                            run_dir=str(tmp_path / "rj"), log_gradients=False,
                            early_stop_metric=None)
    jseen = _record(monkeypatch, JaxCheckpointManager)
    jtrainer = jadmm.ADMMTrainer(jnet, jax_criterion("focal_tversky")(**CRIT), jcfg)
    jtrainer.fit(jparams, batches)
    # JAX's μ, replayed from its parameters after every epoch by its dual update
    jmu = jnp.zeros(len(jadmm._constraint_values(jnet, jparams)))
    _, jtemplate = JaxSceneNet.create(kernel_size=KS, seed=seed)
    for flat in jseen:
        p = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(jtemplate), [
            flat[".".join(str(getattr(k, "key", k)) for k in path)]
            for path, _ in jax.tree_util.tree_flatten_with_path(jtemplate)[0]])
        jmu = jnp.maximum(0.0, jmu + rho * -jadmm._constraint_values(jnet, p))

    net = SceneNet.create(kernel_size=KS, seed=seed)
    seen = _record(monkeypatch, CheckpointManager)
    trainer = ADMMTrainer(net, resolve_criterion("focal_tversky")(**CRIT), _cfg(
        tmp_path, "t", max_epochs=3, admm_rho=rho, optimizer=optimizer, learning_rate=lr,
        early_stop_metric=None))
    ls_runs = []
    if optimizer == "lbfgs":
        from test_torch_lbfgs import _margins

        from scenenet_tpu_torch.train import lbfgs as tlbfgs

        run = tlbfgs.ZoomLinesearch.run

        def spy(self, *a, **k):
            out = run(self, *a, **k)
            ls_runs.append(_margins(self))
            return out

        monkeypatch.setattr(tlbfgs.ZoomLinesearch, "run", spy)
    trainer.fit(batches)
    if optimizer == "lbfgs":
        margins = [m for ms in ls_runs for m in ms]
        assert len(ls_runs) == 6 and min(abs(m) for m in margins) > 1e-4, \
            sorted(abs(m) for m in margins)[:3]
    assert len(seen) == len(jseen) == 3
    for epoch, (got, want) in enumerate(zip(seen, jseen)):
        for name, v in got.items():
            np.testing.assert_allclose(v, want[name], rtol=1e-5, atol=1e-7,
                                       err_msg=f"epoch {epoch} {name}")
    np.testing.assert_allclose(trainer.mu.numpy(), np.asarray(jmu), rtol=1e-5, atol=1e-7)
    assert len(trainer.history) == len(jtrainer.history) == 3
    for got, want in zip(trainer.history, jtrainer.history):
        assert got["epoch"] == want["epoch"]
        for k in ("max_violation", "mu_norm", "train_loss"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7, err_msg=k)
