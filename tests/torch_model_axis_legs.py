"""The rank side of the port's ``model``- and ``stage``-axis tests
(``tests/test_torch_ensemble_parallel.py``, ``tests/test_torch_gspmd.py``,
``tests/test_torch_pipeline_parallel.py``).

Every ``*_ranks`` function runs on each rank of a gloo launch on the CPU
(:func:`scenenet_tpu_torch.parallel.launch.run_ranks`) and returns numpy
results, which the tests hold against the JAX package and against the
port's single-device twin: the same functions called with ``mesh=None``.
This module imports torch, numpy and the port only.
"""

from __future__ import annotations

import os

import numpy as np
import torch

KS = (9, 5, 5)
GENEO = {"cy": 1, "cone": 1, "neg": 1}
QUANTILES = (0.1, 0.3, 0.5, 0.9)
QSEED = 3


# ---- data (numpy, seeded: the tests make the same arrays for JAX) -------------------

def ep_batch(b=8, z=16, seed=0):
    rng = np.random.default_rng(seed)
    return ((rng.random((b, 1, z, 12, 12)) > 0.9).astype(np.float32),
            (rng.random((b, 1, z, 12, 12)) > 0.97).astype(np.float32))


def ep_raw(seed=5, b=8, n=900):
    rng = np.random.default_rng(seed)
    pts = rng.uniform([0, 0, 0], [30, 30, 60], (b, n, 3)).astype(np.float32)
    labels = rng.choice([1, 2, 15], size=(b, n)).astype(np.int32)
    return pts, labels, np.ones((b, n), bool)


def grid_box(n, g, seed):
    rng = np.random.default_rng(seed)
    return ((rng.random((n, 1, g, g, g)) > 0.9).astype(np.uint8),
            (rng.random((n, 1, g, g, g)) > 0.97).astype(np.uint8))


def cube_batches(n=2, b=8, g=16, seed=0):
    rng = np.random.default_rng(seed)
    return [((rng.random((b, 1, g, g, g)) > 0.9).astype(np.float32),
             (rng.random((b, 1, g, g, g)) > 0.97).astype(np.float32)) for _ in range(n)]


def deep_stack(c=4, g=8, s=4, m=3, mb=2):
    rng = np.random.default_rng(1)
    kernels = [rng.normal(0, 0.2, (3, 3, 3, c, c)).astype(np.float32) for _ in range(s)]
    biases = [rng.normal(0, 0.1, (c,)).astype(np.float32) for _ in range(s)]
    x = rng.normal(0, 1, (m, mb, g, g, g, c)).astype(np.float32)  # NDHWC, the JAX layout
    return kernels, biases, x


# ---- helpers -------------------------------------------------------------------------

class Capture:
    def __init__(self):
        self.scores = []

    def log_metrics(self, scores, step):
        self.scores.append((step, dict(scores)))

    def log_params(self, params, step):
        pass


def _np(t):
    return t.detach().cpu().float().numpy().copy()


def _params(model):
    from scenenet_tpu_torch.train.checkpoint import _module_state

    return {k: _np(v) for k, v in _module_state(model).items()}


def _grads(named):
    return {k: _np(v) for k, v in named.items()}


def _config(tmp, tag, **kw):
    from scenenet_tpu_torch.train import TrainConfig

    base = dict(max_epochs=2, optimizer="sgd", learning_rate=1e-2, early_stop_metric=None,
                checkpoint_dir=os.path.join(tmp, f"ckpt_{tag}"),
                run_dir=os.path.join(tmp, f"run_{tag}"), log_gradients=False)
    base.update(kw)
    return TrainConfig(**base)


def digest(tree):
    """``tree`` with every array replaced by its shape and a hash of its
    bytes: what the ranks after the first return of the UNet's states, which
    are held equal to the first rank's (pickling every rank's 150 MB of them
    took half of the launch)."""
    import hashlib

    if isinstance(tree, dict):
        return {k: digest(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(digest(v) for v in tree)
    if isinstance(tree, np.ndarray):
        return (tree.shape, hashlib.sha1(np.ascontiguousarray(tree).tobytes()).hexdigest())
    return tree


def _init():
    from scenenet_tpu_torch.parallel import launch

    return launch.init_from_env("gloo", "cpu")


def _mesh(shape, names, dev=None):
    from scenenet_tpu_torch.parallel import make_mesh

    return make_mesh(shape, axis_names=names, device=dev or torch.device("cpu"))


def _guard(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


# ---- ensemble parallelism ------------------------------------------------------------

def ep_model(quantiles=QUANTILES):
    from scenenet_tpu_torch.models import QuantileSceneNet

    return QuantileSceneNet.create(GENEO, KS, quantiles=quantiles, seed=QSEED)


def ep_criterion(kind="quantile_geneo", quantiles=QUANTILES):
    from scenenet_tpu_torch.losses import resolve_criterion

    kw = dict(quantiles=quantiles, weight_alpha=1.0, weight_epsilon=0.1, mse_weight=1.0)
    if kind == "quantile_geneo":
        kw["convex_weight"] = 5.0
    return resolve_criterion(kind)(**kw)


def ep_steps(mesh, kind, raw=False):
    """3 SGD steps (one on a raw point batch with ``raw``) of
    ``make_ensemble_train_step`` (the one-rank Trainer step with no mesh):
    the losses, the assembled gradients, the parameters and the counts."""
    from scenenet_tpu_torch.parallel.ep import make_ensemble_train_step
    from scenenet_tpu_torch.train import Trainer, make_device_voxelize_prep
    from scenenet_tpu_torch.train.metrics import init_metric_state, metric_counts

    model = ep_model()
    crit = ep_criterion(kind)
    opt = torch.optim.SGD([p for p in model.parameters() if p.requires_grad], lr=1e-2)
    prep = make_device_voxelize_prep((16, 12, 12), use_indices=False) if raw else None
    if mesh is not None:
        step = make_ensemble_train_step(model, crit, opt, mesh, batch_prep=prep,
                                        with_grads=True)
    else:
        t = Trainer(model, crit, _config("/nonexistent", "ep"), logger=Capture(),
                    batch_prep=prep)
        t.optimizer = opt

        def step(mstate, *batch):
            mstate, loss = t.train_step(mstate, *(torch.as_tensor(b) for b in batch))
            return mstate, loss, {n: p.grad for n, p in model.named_parameters()
                                  if p.grad is not None}
    m = init_metric_state()
    losses, grads = [], []
    batches = [ep_raw()] if raw else [ep_batch(seed=i) for i in range(3)]
    for batch in batches:
        m, loss, g = step(m, *batch)
        losses.append(float(loss))
        grads.append(_grads(g))
    return {"losses": losses, "grads": grads, "params": _params(model),
            "counts": metric_counts(m)}


def ep_eval(mesh, b):
    from scenenet_tpu_torch.parallel.ep import make_ensemble_eval_step
    from scenenet_tpu_torch.train import Trainer
    from scenenet_tpu_torch.train.metrics import init_metric_state, metric_counts

    model, crit = ep_model(), ep_criterion()
    x, y = ep_batch(b=b)
    if mesh is None:
        t = Trainer(model, crit, _config("/nonexistent", "epe"), logger=Capture())
        m, loss, pred = t.eval_step(init_metric_state(), torch.from_numpy(x),
                                    torch.from_numpy(y))
    else:
        m, loss, pred = make_ensemble_eval_step(model, crit, mesh)(init_metric_state(), x, y)
    return {"loss": float(loss), "counts": metric_counts(m), "pred": _np(pred)}


def ep_local_eval(mesh):
    """``make_local_ensemble_eval_step`` on the rank's rows of a batch of 8
    and, replicated over data, on a batch of 5."""
    from scenenet_tpu_torch.parallel.ep import make_local_ensemble_eval_step
    from scenenet_tpu_torch.train.metrics import init_metric_state, metric_counts

    out = {}
    for b, sharded in ((8, True), (5, False)):
        x, y = ep_batch(b=b)
        if sharded:
            rows = slice(mesh.coords["data"] * 4, (mesh.coords["data"] + 1) * 4)
            x, y = x[rows], y[rows]
        step = make_local_ensemble_eval_step(ep_model(), ep_criterion(), mesh,
                                             batch_sharded=sharded)
        m, loss, _ = step(init_metric_state(), x, y)
        out[b] = {"loss": float(loss), "counts": metric_counts(m)}
    return out


def ep_fit(tmp, mesh, route, tag, **kw):
    """A Trainer fit of the ensemble: ``route`` streamed (with a validation
    batch), grids (the grid cache, D4 draws) or points (the point cache)."""
    from scenenet_tpu_torch.train import Trainer, make_device_voxelize_prep

    logger = Capture()
    model = ep_model()
    prep = (make_device_voxelize_prep((16, 16, 16), (15,), use_indices=False)
            if route == "points" else None)
    trainer = Trainer(model, ep_criterion(), _config(tmp, tag, **kw), logger=logger,
                      batch_prep=prep, mesh=mesh)
    gen = torch.Generator().manual_seed(7)
    if route == "streamed":
        batches = [ep_batch(seed=i) for i in range(3)]
        trainer.fit(batches, val_loader=batches[:1])
    elif route in ("grids", "grids_aug"):
        x, y = grid_box(16, 12, 0)
        trainer.fit_grid_cached(_GridCache(x, y), batch_size=8, augment=route == "grids_aug",
                                generator=gen)
    elif route == "points":
        trainer.fit_cached(_PointCache(), batch_size=4, augment=True, generator=gen)
    out = {"counts": list(trainer.train_counts), "params": _params(model),
           "scores": [s for _, s in logger.scores], "step": trainer.step}
    if route == "grids":
        x, y = grid_box(13, 12, 4)
        out["evaluate_cached"] = trainer.evaluate_cached(_GridCache(x, y), batch_size=4)
    return out


class _GridCache:
    def __init__(self, x, y):
        self.x, self.y = torch.from_numpy(x), torch.from_numpy(y)
        self.device = self.x.device

    def __len__(self):
        return int(self.x.shape[0])


class _PointCache:
    def __init__(self, n=8, npts=1024, seed=3):
        rng = np.random.default_rng(seed)
        self.points = torch.from_numpy(
            rng.uniform([0, 0, 0], [30, 30, 60], (n, npts, 3)).astype(np.float32))
        self.labels = torch.from_numpy(rng.choice([1, 2, 15], size=(n, npts)).astype(np.int32))
        self.mask = torch.ones((n, npts), dtype=torch.bool)
        self.device = self.points.device

    def __len__(self):
        return int(self.points.shape[0])


def ep_lbfgs(tmp, mesh, route):
    """L-BFGS over the ensemble: 2 streamed batches, or one epoch of the
    grid cache; the linesearch's trial counts with the parameters."""
    from scenenet_tpu_torch.train import Trainer

    model = ep_model()
    trainer = Trainer(model, ep_criterion(), _config(tmp, f"lb_{route}", optimizer="lbfgs",
                                                     learning_rate=0.1, max_epochs=1),
                      logger=Capture(), mesh=mesh)
    if route == "streamed":
        trainer.fit([ep_batch(seed=i) for i in range(2)])
    else:
        x, y = grid_box(16, 12, 0)
        trainer.fit_grid_cached(_GridCache(x, y), batch_size=8, augment=False,
                                generator=torch.Generator().manual_seed(3))
    return {"params": _params(model), "counts": list(trainer.train_counts),
            "trials": trainer.optimizer.trials}


def ep_preempt(tmp, mesh):
    """4 streamed steps unkilled; 2 steps, a snapshot and a fresh trainer's
    resume: the resumed parameters against the unkilled ones."""
    from scenenet_tpu_torch.train import Trainer
    from scenenet_tpu_torch.train import preempt as pre

    batches = [ep_batch(seed=i) for i in range(4)]
    full = Trainer(ep_model(), ep_criterion(), _config(tmp, "pfull", max_epochs=1),
                   logger=Capture(), mesh=mesh)
    full.fit(batches)

    class PreemptAfter:
        def __iter__(self):
            for i, b in enumerate(batches):
                if i == 1:
                    pre.request_preemption()
                yield b

    cfg = _config(tmp, "pkill", max_epochs=1)
    killed = Trainer(ep_model(), ep_criterion(), cfg, logger=Capture(), mesh=mesh)
    killed.fit(PreemptAfter())
    resumed = Trainer(ep_model(), ep_criterion(), cfg, logger=Capture(), mesh=mesh)
    resumed.fit(batches, resume_from=os.path.join(cfg.checkpoint_dir, pre.SNAPSHOT_NAME))
    return {"preempted": killed.preempted, "killed_step": killed.step,
            "resumed_step": resumed.step, "full": _params(full.model),
            "resumed": _params(resumed.model)}


def ep_inference(mesh, x):
    from scenenet_tpu_torch.parallel.ep import make_ensemble_inference_fn

    return _np(make_ensemble_inference_fn(ep_model(), mesh)(x))


def ep_guards(tmp, mesh, dp_mesh):
    """The EP guards' messages on a (data, model) mesh, and on a (data,
    space) mesh, which has no model axis."""
    from scenenet_tpu_torch.models import SceneNet
    from scenenet_tpu_torch.parallel.ep import (
        make_ensemble_inference_fn, make_ensemble_train_step,
    )

    opt = torch.optim.SGD(ep_model().parameters(), lr=1e-2)
    return {
        "indivisible": _guard(lambda: make_ensemble_inference_fn(
            ep_model(quantiles=(0.1, 0.5, 0.9)), _mesh((1, 4), ("data", "model")))),
        "non_ensemble": _guard(lambda: make_ensemble_inference_fn(
            SceneNet.create(kernel_size=KS, seed=0), mesh)),
        "criterion": _guard(lambda: make_ensemble_train_step(
            ep_model(), ep_criterion("mse"), opt, mesh)),
        "quantiles": _guard(lambda: make_ensemble_train_step(
            ep_model(), ep_criterion(quantiles=(0.1, 0.2, 0.5, 0.9)), opt, mesh)),
        "missing_axis": _guard(lambda: make_ensemble_inference_fn(ep_model(), dp_mesh)),
        "conflict": _guard(lambda: _conflict(tmp)),
    }


def _mse():
    from scenenet_tpu_torch.losses import resolve_criterion

    return resolve_criterion("mse")()


def _conflict(tmp):
    from scenenet_tpu_torch.train import Trainer

    mesh = _mesh((1, 2, 2), ("data", "space", "model"))
    Trainer(ep_model(), ep_criterion(), _config(tmp, "conflict"), logger=Capture(), mesh=mesh)


def ep_cli(tmp, data):
    """``cli.train --set model=quantile criterion=quantile_geneo mesh_data=2
    mesh_ensemble=2`` on the launch's 4 ranks (the grid cache), and the
    CLI's guards."""
    from scenenet_tpu_torch.cli import train as tcli

    argv = ["--device", "cpu", "--dist-backend", "gloo", "--set", f"data_path={data}",
            f"output_dir={os.path.join(tmp, 'cli_ep')}", "batch_size=4",
            "voxel_grid_size=(12, 12, 16)", "kernel_size=(3, 3, 3)", "max_points=1024",
            "max_epochs=1", "num_workers=1", "model=quantile", "criterion=quantile_geneo",
            "quantiles=(0.1, 0.3, 0.5, 0.9)", "mesh_data=2", "mesh_ensemble=2",
            "early_stop_metric=None"]
    return {"scores": tcli.main(argv)}


def ensemble_ranks(tmp, data):
    """4 ranks: (data 2, model 2), (data 1, model 4), (data 4, model 1), the
    hybrid dcn 2 × (data 1 × model 2), and (data 4, space 1)."""
    dev = _init()
    mesh = _mesh((2, 2), ("data", "model"), dev)
    out = {"coords": mesh.coords}
    x, _ = ep_batch(b=8)
    out["inference"] = {"2x2": ep_inference(mesh, x),
                        "1x4": ep_inference(_mesh((1, 4), ("data", "model"), dev), x)}
    mesh = _mesh((2, 2), ("data", "model"), dev)
    for kind in ("quantile", "quantile_geneo"):
        out[f"steps_{kind}"] = ep_steps(mesh, kind)
    out["steps_raw"] = ep_steps(mesh, "quantile_geneo", raw=True)
    out["eval"] = {b: ep_eval(mesh, b) for b in (8, 5)}
    out["local_eval"] = ep_local_eval(mesh)
    for route in ("streamed", "grids", "grids_aug", "points"):
        out[f"fit_{route}"] = ep_fit(tmp, mesh, route, f"ep_{route}")
    out["bf16"] = ep_fit(tmp, mesh, "streamed", "ep_bf16", precision="bf16")
    for route in ("streamed", "grids"):
        out[f"lbfgs_{route}"] = ep_lbfgs(tmp, mesh, route)
    out["preempt"] = ep_preempt(tmp, mesh)
    degenerate = _mesh((4, 1), ("data", "model"), dev)
    out["degenerate"] = {"fit": ep_fit(tmp, degenerate, "streamed", "ep_deg"),
                         "eval": {b: ep_eval_dp(degenerate, b) for b in (8, 5)}}
    from scenenet_tpu_torch.parallel import make_hybrid_mesh

    hybrid = make_hybrid_mesh((2, 1), (1, 2), axis_names=("data", "model"), device=dev)
    out["hybrid_shape"] = hybrid.shape
    out["hybrid"] = ep_fit(tmp, hybrid, "streamed", "ep_hybrid")
    out["guards"] = ep_guards(tmp, mesh, _mesh((4, 1), ("data", "space"), dev))
    out["cli"] = ep_cli(tmp, data)
    return out


def ep_eval_dp(mesh, b):
    """``make_sharded_eval_step`` (data parallelism) on a mesh whose model
    axis has one rank."""
    from scenenet_tpu_torch.parallel.dp import make_sharded_eval_step
    from scenenet_tpu_torch.train.metrics import init_metric_state, metric_counts

    x, y = ep_batch(b=b)
    m, loss, _ = make_sharded_eval_step(ep_model(), ep_criterion(), mesh)(
        init_metric_state(), x, y)
    return {"loss": float(loss), "counts": metric_counts(m)}


# ---- channel tensor parallelism ------------------------------------------------------

def tp_model(kind, seed=0, precision="f32"):
    """The UNet (computing in bf16 under ``precision="bf16"``, as the train
    CLI builds it) or a CNN of 4 channels."""
    from scenenet_tpu_torch.models import CnnBaseline, UNet3D

    if kind == "unet":
        return UNet3D.create(seed=seed, dtype=torch.bfloat16 if precision == "bf16"
                             else torch.float32)
    return CnnBaseline.create(conv_num=4, kernel_size=(3, 3, 3), seed=seed)


def tp_twin(model):
    """The one-rank twin's model: its BatchNorms in flax's form (E[x²] − E[x]²,
    the JAX one and the sharded one) through a mesh of one rank, over which
    the statistics' mean is the identity."""
    if getattr(model, "is_stateful", False):
        _mesh((1, 1), ("data", "model"))  # made active: the BatchNorms' pmean names 'data'
        model.with_bn_sync("data")
    return model


def tp_criterion():
    from scenenet_tpu_torch.losses import resolve_criterion

    return resolve_criterion("dice_bce")()


def tp_step(mesh, kind, optimizer="sgd", lr=1e-2, precision="f32", n_steps=1):
    """``make_gspmd_train_step`` (the one-rank Trainer step with no mesh):
    the losses, the full gradients by parameter name, the full flax-layout
    state after the steps (running statistics included) and the counts."""
    from scenenet_tpu_torch.parallel.gspmd import make_gspmd_train_step
    from scenenet_tpu_torch.train import Trainer
    from scenenet_tpu_torch.train.metrics import init_metric_state, metric_counts

    model = tp_model(kind, precision=precision)
    if mesh is not None:
        step = make_gspmd_train_step(model, tp_criterion(), optimizer, mesh,
                                     learning_rate=lr, precision=precision)
        trainer = step.trainer
    else:
        trainer = Trainer(tp_twin(model), tp_criterion(), _config("/nonexistent", "tp",
                                                         optimizer=optimizer,
                                                         learning_rate=lr,
                                                         precision=precision),
                          logger=Capture())
        trainer.setup_optimizer()

        def step(mstate, *batch):
            mstate, loss = trainer.train_step(mstate, *(torch.as_tensor(b) for b in batch))
            return mstate, loss, trainer.full_gradients()
    m = init_metric_state()
    losses, grads = [], []
    for x, y in cube_batches(n=n_steps):
        m, loss, g = step(m, x, y)
        losses.append(float(loss))
        grads.append(flax_grads(kind, g))
    trainer.sync_model()
    out = {"losses": losses, "grads": grads, "state": _params(model),
           "counts": metric_counts(m)}
    if mesh is not None:
        out["local"] = {k: _np(v) for k, v in trainer.net.flax_state().items()}
    return out


def flax_grads(kind, grads):
    """Gradients by torch parameter name → the flax layout and names (the
    JAX package's gradient tree, flattened)."""
    holder = tp_model(kind)
    with torch.no_grad():
        for n, p in holder.named_parameters():
            p.copy_(grads[n])
    return {k: _np(v) for k, v in holder.flax_state().items()
            if not k.startswith("batch_stats")}


def tp_eval(mesh, kind, b):
    from scenenet_tpu_torch.parallel.gspmd import make_gspmd_eval_step
    from scenenet_tpu_torch.train import Trainer
    from scenenet_tpu_torch.train.metrics import init_metric_state, metric_counts

    (x, y), = cube_batches(n=1)
    x, y = x[:b], y[:b]
    if mesh is None:
        t = Trainer(tp_model(kind), tp_criterion(), _config("/nonexistent", "tpe"),
                    logger=Capture())
        m, loss, pred = t.eval_step(init_metric_state(), torch.from_numpy(x),
                                    torch.from_numpy(y))
    else:
        m, loss, pred = make_gspmd_eval_step(tp_model(kind), tp_criterion(), mesh)(
            init_metric_state(), x, y)
    return {"loss": float(loss), "counts": metric_counts(m), "pred": _np(pred)}


def tp_adam_state(mesh):
    """One Adam step of the CNN under TP: the shapes of the moments the
    optimizer holds, and the snapshot state gathered over the full tree."""
    from scenenet_tpu_torch.parallel.gspmd import make_gspmd_train_step
    from scenenet_tpu_torch.train.metrics import init_metric_state

    step = make_gspmd_train_step(tp_model("cnn"), tp_criterion(), "adam", mesh)
    step(init_metric_state(), *cube_batches(n=1)[0])
    t = step.trainer
    local = {k: tuple(v.shape) for k, v in t.optimizer.state_dict()["state"][0].items()}
    full = {k: tuple(v.shape) for k, v in t.train_state().items()}
    return {"local": local, "full": full}


def tp_fit(tmp, mesh, tag, **kw):
    """A streamed UNet fit of one epoch of one batch, validated on it (the
    gradients logged): one SGD step of the Trainer, so it is also the UNet's
    step, its gradients the fit's last. Its best checkpoint is restored into
    a one-device UNet3D."""
    from scenenet_tpu_torch.train import Trainer
    from scenenet_tpu_torch.train.checkpoint import restore_checkpoint

    logger = Capture()
    model = tp_model("unet")
    if mesh is None:
        tp_twin(model)
    trainer = Trainer(model, tp_criterion(), _config(tmp, tag, log_gradients=True,
                                                     max_epochs=1, **kw),
                      logger=logger, mesh=mesh)
    batches = cube_batches(n=1)
    _, best = trainer.fit(batches, val_loader=batches)
    restored = restore_checkpoint(trainer._ckpt.best_path("val_loss"), tp_model("unet", seed=5))
    _drop(trainer.config.checkpoint_dir, mesh)
    out = {"state": _params(model), "counts": list(trainer.train_counts),
           "scores": [s for _, s in logger.scores], "restored": _params(restored),
           "best": best, "grads": flax_grads("unet", trainer.full_gradients()),
           "losses": [s["train_loss"] for _, s in logger.scores]}
    if mesh is not None:
        out["local"] = {k: _np(v) for k, v in trainer.net.flax_state().items()}
    return out


def _drop(directory, mesh=None):
    """Remove a UNet run's checkpoints (22 MB each, one a monitor) once every
    rank has read them."""
    import shutil

    from scenenet_tpu_torch.parallel.mesh import barrier

    if mesh is not None:
        barrier(mesh)
    if mesh is None or mesh.rank == 0:
        shutil.rmtree(directory, ignore_errors=True)


def tp_preempt(tmp, mesh):
    """The CNN under TP and Adam: 3 streamed steps unkilled; 2 steps, a
    snapshot (the shards and Adam's moments gathered into the full tree)
    and a fresh trainer's resume, which cuts them again."""
    from scenenet_tpu_torch.train import Trainer
    from scenenet_tpu_torch.train import preempt as pre

    batches = cube_batches(n=3)
    cfg = dict(max_epochs=1, optimizer="adam", learning_rate=1e-3)
    full = Trainer(tp_model("cnn"), tp_criterion(), _config(tmp, "tp_pfull", **cfg),
                   logger=Capture(), mesh=mesh)
    full.fit(batches)

    class PreemptAfter:
        def __iter__(self):
            for i, b in enumerate(batches):
                if i == 1:
                    pre.request_preemption()
                yield b

    config = _config(tmp, "tp_pkill", **cfg)
    killed = Trainer(tp_model("cnn"), tp_criterion(), config, logger=Capture(), mesh=mesh)
    killed.fit(PreemptAfter())
    resumed = Trainer(tp_model("cnn"), tp_criterion(), config, logger=Capture(), mesh=mesh)
    resumed.fit(batches, resume_from=os.path.join(config.checkpoint_dir, pre.SNAPSHOT_NAME))
    return {"preempted": killed.preempted, "killed_step": killed.step,
            "resumed_step": resumed.step, "full": _params(full.model),
            "resumed": _params(resumed.model)}


def tp_guards(tmp, mesh):
    from scenenet_tpu_torch.models import CnnBaseline, SceneNet
    from scenenet_tpu_torch.parallel.gspmd import make_gspmd_train_step
    from scenenet_tpu_torch.train import Trainer
    from scenenet_tpu_torch.train.metrics import init_metric_state

    net = SceneNet.create(GENEO, KS, seed=0)
    x, y = cube_batches(n=1)[0]
    step = make_gspmd_train_step(tp_model("cnn"), tp_criterion(), "sgd", mesh)
    t = Trainer(tp_model("unet"), tp_criterion(), _config(tmp, "g1"), logger=Capture(),
                mesh=mesh)
    return {
        "scenenet": _guard(lambda: make_gspmd_train_step(net, tp_criterion(), "sgd", mesh)),
        "cnn3": _guard(lambda: make_gspmd_train_step(
            CnnBaseline.create(conv_num=3, kernel_size=(3, 3, 3)), tp_criterion(), "sgd",
            _mesh((1, 4), ("data", "model")))),
        "indivisible": _guard(lambda: step(init_metric_state(), x[:5], y[:5])),
        "cached": _guard(lambda: t._check_mesh_supported(pure_dp=True, batch_size=8)),
    }


def tp_cli(tmp, data):
    from scenenet_tpu_torch.cli import train as tcli

    argv = ["--device", "cpu", "--dist-backend", "gloo", "--set", f"data_path={data}",
            f"output_dir={os.path.join(tmp, 'cli_tp')}", "batch_size=4",
            "voxel_grid_size=(16, 16, 16)", "max_points=1024", "max_epochs=1",
            "num_workers=1", "model=unet", "criterion=dice_bce", "mesh_data=2",
            "mesh_channel=2", "early_stop_metric=None"]
    scores = tcli.main(argv)
    import torch.distributed as dist

    dist.barrier()
    if dist.get_rank() == 0:
        import shutil

        shutil.rmtree(os.path.join(tmp, "cli_tp"), ignore_errors=True)
    return {"scores": scores}


def channel_ranks(tmp, data):
    """4 ranks, (data 2, model 2): the UNet's fit of one step, the CNN's
    step, the bf16 and L-BFGS steps, evaluation with a ragged tail, a
    preempted and resumed fit, the shards of the full state, the guards and
    ``cli.train --set mesh_channel=2``."""
    dev = _init()
    mesh = _mesh((2, 2), ("data", "model"), dev)
    out = {"coords": mesh.coords}
    out["cnn"] = tp_step(mesh, "cnn", optimizer="adam", lr=1e-3)
    out["bf16"] = tp_step(mesh, "unet", precision="bf16")
    out["lbfgs"] = tp_step(mesh, "cnn", optimizer="lbfgs", lr=0.1, n_steps=2)
    out["eval"] = {b: tp_eval(mesh, "cnn", b) for b in (8, 5)}
    out["adam_state"] = tp_adam_state(mesh)
    out["preempt"] = tp_preempt(tmp, mesh)
    out["fit"] = tp_fit(tmp, mesh, "tp_fit")
    from scenenet_tpu_torch.parallel.gspmd import channel_specs, gather_state, shard_state

    full = tp_model("unet").flax_state()
    local = shard_state(full, mesh)
    back = gather_state(local, channel_specs(full, mesh), mesh)
    out["shards"] = {"local": {k: _np(v) for k, v in local.items()},
                     "back_equal": all(torch.equal(back[k], v) for k, v in full.items())}
    out["guards"] = tp_guards(tmp, mesh)
    out["cli"] = tp_cli(tmp, data)
    if mesh.rank != 0:
        for k in ("bf16", "fit", "shards"):
            out[k] = digest(out[k])
    return out


# ---- the pipeline ----------------------------------------------------------------------

def pp_model(seed=0):
    from scenenet_tpu_torch.models import CnnBaseline

    return CnnBaseline.create(conv_num=3, kernel_size=(3, 3, 3), seed=seed)


def pp_forward(mesh, m, x):
    from scenenet_tpu_torch.parallel.pp import cnn_pipeline_params, make_pipeline_inference_fn

    model = pp_model()
    return _np(make_pipeline_inference_fn(model, mesh, n_microbatches=m)(
        cnn_pipeline_params(model), x))


def pp_unet_model():
    from scenenet_tpu_torch.models import UNet3D

    return UNet3D.create(seed=0)


def pp_unet_forward(mesh, m, x):
    from scenenet_tpu_torch.parallel.pp import make_unet_pipeline_inference_fn

    return _np(make_unet_pipeline_inference_fn(pp_unet_model(), mesh, n_microbatches=m)(x))


def plain_microbatches(model, mesh, m, x):
    """The unpipelined model's eval forward of this rank's rows, a
    microbatch at a time, as the pipeline's stages see them."""
    n = mesh.shape["data"]
    rows = torch.from_numpy(x).chunk(n)[mesh.coords["data"]]
    model.eval()
    with torch.no_grad():
        return _np(torch.cat([model(mb) for mb in rows.chunk(m)]))


def plain_grads(x, y):
    """The unpipelined CnnBaseline's gradients of the loss on (x, y)."""
    model = pp_model()
    loss = tp_criterion()(model(torch.from_numpy(x)), torch.from_numpy(y), {}, {}, None)
    loss.backward()
    state = {}
    for i, (w, b) in enumerate(zip(model.weights, model.biases)):
        state[f"Conv_{i}.kernel"] = _np(w.grad.permute(2, 3, 4, 1, 0))
        state[f"Conv_{i}.bias"] = _np(b.grad)
    return state


def pp_steps(mesh, m, optimizer="sgd", lr=1e-2, n_steps=3, b=8):
    """``make_pipeline_train_step`` over the stacked tree: the losses, the
    first step's stacked gradients, the unstacked parameters and the counts."""
    from scenenet_tpu_torch.parallel.pp import (
        cnn_pipeline_params, cnn_unstack_params, make_pipeline_train_step,
    )
    from scenenet_tpu_torch.train.metrics import init_metric_state, metric_counts
    from scenenet_tpu_torch.train.state import resolve_optimizer

    model = pp_model()
    stacked = {k: torch.nn.Parameter(v) for k, v in cnn_pipeline_params(model).items()}
    opt = resolve_optimizer(optimizer, stacked.values(), lr)
    step = make_pipeline_train_step(model, tp_criterion(), opt, mesh, stacked,
                                    n_microbatches=m, with_grads=True)
    mstate = init_metric_state()
    losses, grads = [], []
    for i in range(n_steps):
        x, y = ep_batch(b=b, z=16, seed=i)
        x, y = x[..., :12], y[..., :12]
        mstate, loss, g = step(mstate, x, y)
        losses.append(float(loss))
        grads.append(_grads(g))
    return {"losses": losses, "grads": grads, "counts": metric_counts(mstate),
            "params": {k: _np(v) for k, v in cnn_unstack_params(stacked).items()},
            "kernel0": _np(stacked["kernel"][0])}


def pp_deep(mesh):
    from scenenet_tpu_torch.parallel.pp import make_stage_params, pipeline_apply

    kernels, biases, x = deep_stack()
    stacked = make_stage_params([torch.from_numpy(k) for k in kernels],
                                [torch.from_numpy(b) for b in biases])
    x_mb = torch.from_numpy(x).permute(0, 1, 5, 2, 3, 4)  # NDHWC → NCDHW
    return _np(pipeline_apply(stacked, x_mb, stage_axis="stage", n_stages=4, mesh=mesh))


def pp_guards(mesh4x1):
    from scenenet_tpu_torch.parallel.pp import cnn_pipeline_params, make_pipeline_inference_fn

    model = pp_model()
    return {
        "stage_count": _guard(lambda: make_pipeline_inference_fn(
            model, _mesh((1, 4), ("data", "stage")))),
        "missing_axis": _guard(lambda: make_pipeline_inference_fn(model, mesh4x1)),
        "microbatch": _guard(lambda: make_pipeline_inference_fn(
            model, _mesh((2, 2), ("data", "stage")), n_microbatches=3)(
                cnn_pipeline_params(model), np.zeros((8, 1, 8, 8, 8), np.float32))),
    }


def pipeline_x(b=8, g=16, seed=4, p=0.8):
    rng = np.random.default_rng(seed)
    return (rng.random((b, 1, g, g, g)) > p).astype(np.float32)


def pipeline_ranks():
    """4 ranks: (data 2, stage 2) forward, training and the UNet pipeline,
    the deep stack over (data 1, stage 4), and the guards."""
    dev = _init()
    mesh = _mesh((2, 2), ("data", "stage"), dev)
    out = {"coords": mesh.coords}
    x = pipeline_x()
    out["forward"] = pp_forward(mesh, 2, x)
    out["forward_plain"] = plain_microbatches(pp_model(), mesh, 2, x)
    out["unet"] = pp_unet_forward(mesh, 2, x)
    out["unet_plain"] = plain_microbatches(pp_unet_model(), mesh, 2, x)
    out["steps"] = pp_steps(mesh, 2)
    deep = _mesh((1, 4), ("data", "stage"), dev)
    out["deep"] = pp_deep(deep)
    out["guards"] = pp_guards(_mesh((4, 1), ("data", "space"), dev))
    return out


def pipeline_ranks_2():
    """2 ranks, (data 1, stage 2): the forward at 4 microbatches, the UNet
    pipeline, 3 training steps, Adam's steps on the embedded weights."""
    dev = _init()
    mesh = _mesh((1, 2), ("data", "stage"), dev)
    x = pipeline_x()
    x0, y0 = ep_batch(b=8, z=16, seed=0)
    return {"coords": mesh.coords, "forward": pp_forward(mesh, 4, x),
            "forward_plain": plain_microbatches(pp_model(), mesh, 4, x),
            "unet": pp_unet_forward(mesh, 4, x),
            "unet_plain": plain_microbatches(pp_unet_model(), mesh, 4, x),
            "steps": pp_steps(mesh, 4),
            "plain_grads": plain_grads(x0[..., :12], y0[..., :12]),
            "adam": pp_steps(mesh, 2, optimizer="adam", lr=1e-3, n_steps=2, b=4)}
