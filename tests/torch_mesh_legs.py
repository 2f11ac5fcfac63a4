"""The rank side of the port's mesh tests (``tests/test_torch_parallel.py``,
``tests/test_torch_mesh_training.py``).

Every ``*_ranks`` function runs on each rank of a gloo launch on the CPU
(:func:`scenenet_tpu_torch.parallel.launch.run_ranks`, one fresh
interpreter a rank) and returns numpy results to the test, which holds them
against the JAX package and the port's single-device twin. This module
imports torch, numpy and the port only: the ranks never import jax. The
data functions and the fits take ``mesh=None`` too, so that the test runs
the very same code as the single-device twin.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

KS = (9, 5, 5)
DEFAULTS = dict(weight_alpha=1, weight_epsilon=0.1, mse_weight=1, convex_weight=5,
                tversky_alpha=2, tversky_beta=1, tversky_smooth=1e-6, focal_gamma=4)
HALO_KZ = (1, 4, 9)


# ---- data -----------------------------------------------------------------------

def grid_batches(n=3, b=8, z=16, seed=11):
    """(x, y) occupancy batches of (b, 1, z, 12, 12), the JAX mesh tests' shapes."""
    rng = np.random.default_rng(seed)
    return [((rng.random((b, 1, z, 12, 12)) > 0.9).astype(np.float32),
             (rng.random((b, 1, z, 12, 12)) > 0.97).astype(np.float32)) for _ in range(n)]


def raw_batches(n=2, b=8, npts=1500, seed=12):
    """Raw padded point batches (points, labels, mask)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        pts = rng.uniform([0, 0, 0], [30, 30, 60], (b, npts, 3)).astype(np.float32)
        labels = rng.choice([1, 2, 15], size=(b, npts)).astype(np.int32)
        out.append((pts, labels, np.ones((b, npts), bool)))
    return out


def halo_inputs(kz):
    rng = np.random.default_rng(100 + kz)
    return (rng.random((2, 1, 32, 8, 8)).astype(np.float32),
            rng.random((1, 1, kz, 5, 5)).astype(np.float32))


def spatial_inputs():
    rng = np.random.default_rng(1)
    return ((rng.random((2, 1, 32, 16, 16)) > 0.9).astype(np.float32),
            rng.random((2, 1, 32, 16, 16)).astype(np.float32))


class GridBox:
    """A grid cache's tensors (uint8 x and y), as ``DeviceGridCache`` holds them."""

    def __init__(self, n, g=12, seed=2):
        rng = np.random.default_rng(seed)
        self.x = torch.from_numpy((rng.random((n, 1, g, g, g)) > 0.9).astype(np.uint8))
        self.y = torch.from_numpy((rng.random((n, 1, g, g, g)) > 0.97).astype(np.uint8))
        self.device = self.x.device

    def to(self, device):
        self.x, self.y = self.x.to(device), self.y.to(device)
        self.device = self.x.device
        return self

    def __len__(self):
        return int(self.x.shape[0])


class PointBox:
    """A point cache's tensors, as ``DevicePointCache`` holds them."""

    def __init__(self, n=16, npts=1024, seed=3):
        rng = np.random.default_rng(seed)
        self.points = torch.from_numpy(
            rng.uniform([0, 0, 0], [30, 30, 60], (n, npts, 3)).astype(np.float32))
        self.labels = torch.from_numpy(rng.choice([1, 2, 15], size=(n, npts)).astype(np.int32))
        self.mask = torch.ones((n, npts), dtype=torch.bool)
        self.device = self.points.device

    def to(self, device):
        self.points, self.labels, self.mask = (t.to(device) for t in
                                               (self.points, self.labels, self.mask))
        self.device = self.points.device
        return self

    def __len__(self):
        return int(self.points.shape[0])


# ---- fits ---------------------------------------------------------------------------

class Capture:
    """A logger that keeps every epoch's scores."""

    def __init__(self):
        self.scores = []

    def log_metrics(self, scores, step):
        self.scores.append((step, dict(scores)))

    def log_params(self, params, step):
        pass


def criterion(name="geneo_tversky"):
    from scenenet_tpu_torch.losses import resolve_criterion

    if name == "geneo_tversky":
        return resolve_criterion(name)(**DEFAULTS)
    if name == "quantile_geneo":
        return resolve_criterion(name)(quantiles=(0.1, 0.5, 0.9), weight_alpha=1,
                                       weight_epsilon=0.1, mse_weight=1, convex_weight=5)
    return resolve_criterion(name)()


def _params(model):
    from scenenet_tpu_torch.train.checkpoint import _module_state

    return {k: v.detach().cpu().numpy().copy() for k, v in _module_state(model).items()}


def _result(trainer, model, logger, **extra):
    out = {"counts": list(trainer.train_counts), "scores": logger.scores,
           "params": _params(model), "step": trainer.step}
    out.update(extra)
    return out


def _config(tmp, tag, **kw):
    from scenenet_tpu_torch.train import TrainConfig

    base = dict(max_epochs=2, optimizer="sgd", learning_rate=1e-2, early_stop_metric=None,
                checkpoint_dir=os.path.join(tmp, f"ckpt_{tag}"),
                run_dir=os.path.join(tmp, f"run_{tag}"), log_gradients=False)
    base.update(kw)
    return TrainConfig(**base)


def fit_leg(kind, tmp, mesh=None, tag=None, device="cpu", **kw):
    """One fit of the mesh test matrix; the same code with ``mesh=None`` is
    its single-device twin. On ``device="cuda"`` the models take the kernel
    backend."""
    from scenenet_tpu_torch.models import CnnBaseline, QuantileSceneNet, SceneNet, UNet3D
    from scenenet_tpu_torch.train import Trainer, make_device_voxelize_prep

    tag = tag or f"{kind}_{'mesh' if mesh is not None else 'one'}"
    logger = Capture()
    crit = criterion()
    prep = None
    val = None
    if kind == "unet":
        model = UNet3D.create(seed=0, backend=_backend(device))
        cfg = _config(tmp, tag, max_epochs=1)
        rng = np.random.default_rng(21)
        batches = [((rng.random((4, 1, 32, 32, 32)) > 0.9).astype(np.float32),
                    (rng.random((4, 1, 32, 32, 32)) > 0.97).astype(np.float32))
                   for _ in range(2)]
    else:
        if kind == "quantile":
            model = QuantileSceneNet.create(kernel_size=KS, seed=0, backend=_backend(device))
            crit = criterion("quantile_geneo")
        elif kind == "cnn":
            model = CnnBaseline.create(conv_num=3, kernel_size=(3, 3, 3), seed=0,
                                       backend=_backend(device))
        else:
            model = SceneNet.create(kernel_size=KS, seed=0, backend=_backend(device))
        cfg = _config(tmp, tag, **kw)
        batches = grid_batches(z=32 if kind in ("space", "hybrid") else 16)
        val = batches[:1]
        if kind == "raw":
            prep = make_device_voxelize_prep((16, 16, 16), (15,), use_indices=False)
            batches = raw_batches()
            val = None
    trainer = Trainer(model.to(device), crit, cfg, logger=logger, batch_prep=prep, mesh=mesh,
                      overlap=kind == "space")
    if cfg.optimizer == "lbfgs":
        # step by step: the trial counts of every step
        from scenenet_tpu_torch.train.metrics import init_metric_state

        trainer.setup_optimizer()
        trainer._replicate()
        trials, losses = [], []
        with (mesh.active() if mesh is not None else _null()):
            for batch in batches:
                _, loss = trainer.train_step(init_metric_state(device), *trainer.shard(batch))
                trials.append(trainer.optimizer.trials)
                losses.append(float(loss))
        return {"trials": trials, "losses": losses, "params": _params(model)}
    trainer.fit(batches, val)
    extra = {}
    if kind == "unet":
        extra["stats"] = {k: v.numpy().copy() for k, v in model.flax_state().items()
                          if k.startswith("batch_stats")}
    return _result(trainer, model, logger, **extra)


def _backend(device):
    return "cuda" if torch.device(device).type == "cuda" else "torch"


class _null:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


def cached_leg(kind, tmp, mesh=None, device="cpu", **kw):
    """The cached fits: the grid cache with D4 draws, the point cache with
    rotations and flips, and accumulation over the grid cache."""
    from scenenet_tpu_torch.models import SceneNet
    from scenenet_tpu_torch.train import Trainer, make_device_voxelize_prep

    tag = f"{kind}_{'mesh' if mesh is not None else 'one'}"
    logger = Capture()
    model = SceneNet.create(kernel_size=KS, seed=0, backend=_backend(device)).to(device)
    prep = (make_device_voxelize_prep((16, 16, 16), (15,), use_indices=False)
            if kind == "points" else None)
    trainer = Trainer(model, criterion(), _config(tmp, tag, **kw), logger=logger,
                      batch_prep=prep, mesh=mesh)
    gen = torch.Generator(device).manual_seed(5)
    if kind == "points":
        trainer.fit_cached(PointBox().to(device), batch_size=4, augment=True, generator=gen)
    else:
        trainer.fit_grid_cached(GridBox(16).to(device), batch_size=4,
                                augment=kind == "grids", generator=gen)
    return _result(trainer, model, logger)


def eval_leg(tmp, mesh=None, z=16):
    """Evaluation with a ragged tail: a loader of batches 8, 8, 5 and a grid
    cache of 21 samples in batches of 8."""
    from scenenet_tpu_torch.models import SceneNet
    from scenenet_tpu_torch.train import Trainer

    model = SceneNet.create(kernel_size=KS, seed=0)
    trainer = Trainer(model, criterion(), _config(tmp, "eval"), logger=Capture(), mesh=mesh)
    b = grid_batches(n=3, z=z, seed=13)
    loader = [b[0], b[1], (b[2][0][:5], b[2][1][:5])]
    out = {"loader": trainer.evaluate(loader, "test")}
    if z == 12:
        out["cached"] = trainer.evaluate_cached(GridBox(21), batch_size=8)
    return out


def preempt_leg(tmp, mesh=None):
    """Two steps, a snapshot, a fresh trainer resuming from it for the last
    step: its parameters against an unkilled fit's, bit for bit."""
    from scenenet_tpu_torch.models import SceneNet
    from scenenet_tpu_torch.train import Trainer
    from scenenet_tpu_torch.train import preempt as pre

    batches = grid_batches(n=3)
    full = Trainer(SceneNet.create(kernel_size=KS, seed=0), criterion(),
                   _config(tmp, "pfull", max_epochs=1), logger=Capture(), mesh=mesh)
    full.fit(batches)

    class PreemptAfter:
        def __iter__(self):
            for i, b in enumerate(batches):
                if i == 1:  # latched during the second step: the snapshot follows it
                    pre.request_preemption()
                yield b

    cfg = _config(tmp, "pkill", max_epochs=1)
    killed = Trainer(SceneNet.create(kernel_size=KS, seed=0), criterion(), cfg,
                     logger=Capture(), mesh=mesh)
    killed.fit(PreemptAfter())
    snap = os.path.join(cfg.checkpoint_dir, pre.SNAPSHOT_NAME)
    resumed = Trainer(SceneNet.create(kernel_size=KS, seed=0), criterion(), cfg,
                      logger=Capture(), mesh=mesh)
    resumed.fit(batches, resume_from=snap)
    return {"preempted": killed.preempted, "killed_step": killed.step,
            "resumed_step": resumed.step, "full": _params(full.model),
            "resumed": _params(resumed.model)}


def admm_leg(tmp, mesh=None, z=16):
    from scenenet_tpu_torch.models import SceneNet
    from scenenet_tpu_torch.train.admm import ADMMConfig, ADMMTrainer

    cfg = ADMMConfig(**{**dataclasses.asdict(_config(tmp, "admm", max_epochs=2)),
                        "admm_rho": 5.0})
    model = SceneNet.create(kernel_size=KS, seed=0)
    logger = Capture()
    trainer = ADMMTrainer(model, criterion("focal_tversky"), cfg, logger=logger, mesh=mesh)
    trainer.fit(grid_batches(z=z))
    return {"history": trainer.history, "params": _params(model), "scores": logger.scores}


def guard_messages(tmp, mesh):
    """What each guard of the mesh says."""
    from scenenet_tpu_torch.models import CnnBaseline, SceneNet, UNet3D
    from scenenet_tpu_torch.train import Trainer

    out = {}
    net = SceneNet.create(kernel_size=KS, seed=0)
    t = Trainer(net, criterion(), _config(tmp, "g"), logger=Capture(), mesh=mesh)

    def trainer(model):
        return Trainer(model, criterion(), _config(tmp, "gm"), logger=Capture(), mesh=mesh)

    calls = [("indivisible", lambda: t.fit([grid_batches(n=1, b=3)[0]])),
             ("cached_batch", lambda: t.fit_grid_cached(GridBox(8), batch_size=3)),
             ("unet_cached", lambda: trainer(UNet3D.create(seed=0)).fit_grid_cached(
                 GridBox(8), 4))]
    if mesh.shape["space"] > 1:
        calls = [("z_indivisible", lambda: t.fit([grid_batches(n=1, b=2, z=15)[0]])),
                 ("cached_space", lambda: t.fit_grid_cached(GridBox(8), batch_size=2)),
                 ("unet_space", lambda: trainer(UNet3D.create(seed=0))),
                 ("cnn_space", lambda: trainer(CnnBaseline.create(kernel_size=(3, 3, 3))))]
    for name, call in calls:
        try:
            call()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


# ---- the rank functions -------------------------------------------------------------

def _init(device="cpu", backend="gloo"):
    from scenenet_tpu_torch.parallel import launch

    return launch.init_from_env(backend, device)


def parallel_ranks():
    """4 ranks: mesh layouts, the collectives, the halo conv, the spatial
    forward and its gradients, and the inference functions."""
    dev = _init()
    from scenenet_tpu_torch.models import SceneNet
    from scenenet_tpu_torch.parallel import (
        halo_conv3d, local_batch_size, make_dp_inference_fn, make_hybrid_mesh, make_mesh,
        pmean, psum, shift, spatial_scenenet_forward,
    )
    from scenenet_tpu_torch.parallel.dp import reduce_gradients

    out = {"order": {
        "mesh_4x1": make_mesh((4, 1), device=dev).devices,
        "mesh_2x2": make_mesh((2, 2), device=dev).devices,
        "hybrid_dcn_data": make_hybrid_mesh((2, 1), (1, 2), device=dev).devices,
        "hybrid_dcn_space": make_hybrid_mesh((1, 2), (2, 1), device=dev).devices,
    }}
    line = make_mesh((1, 4), device=dev)
    me = torch.tensor([float(line.rank + 1)], requires_grad=True)
    up = shift(me, "space", +1, line)
    down = shift(me, "space", -1, line)
    total = psum(me * me, ("data", "space"), line)
    total.backward()
    out["collectives"] = {"coords": line.coords, "up": float(up), "down": float(down),
                          "psum": float(total), "grad": float(me.grad),
                          "pmean": float(pmean(me.detach(), "space", line))}
    try:
        local_batch_size(15, make_mesh((2, 2), device=dev))
    except ValueError as e:
        out["local_batch_error"] = str(e)
    out["local_batch"] = local_batch_size(16, make_mesh((2, 2), device=dev))
    # the rows a rank loads itself, cut to its z slab
    from scenenet_tpu_torch.parallel import global_batch_from_local

    sp = make_mesh((2, 2), device=dev)
    rows = np.arange(2 * 3 * 4 * 2 * 2, dtype=np.float32).reshape(2, 3, 4, 2, 2)
    out["local_rows"] = {"coords": sp.coords, "parts": [
        t.numpy() for t in global_batch_from_local((rows, rows[:, 0]), sp, space_axis="space")]}

    halo = {}
    for n_space in (2, 4):
        mesh = make_mesh((4 // n_space, n_space), device=dev)
        s = mesh.coords["space"]
        for kz in HALO_KZ:
            x, k = halo_inputs(kz)
            z = x.shape[2] // n_space
            xs = torch.from_numpy(x[:, :, s * z:(s + 1) * z])
            for overlap in (False, True):
                for backend in ("torch", "cuda"):
                    halo[(n_space, kz, overlap, backend)] = halo_conv3d(
                        xs, torch.from_numpy(k), backend=backend, overlap=overlap,
                        mesh=mesh).numpy()
    out["halo"] = halo
    out["coords"] = {n: make_mesh((4 // n, n), device=dev).coords for n in (2, 4)}

    x, w = spatial_inputs()
    spatial = {}
    for shape, overlap in (((1, 4), False), ((2, 2), True)):
        mesh = make_mesh(shape, device=dev)
        d, s = mesh.coords["data"], mesh.coords["space"]
        rows = x.shape[0] // shape[0]
        zs = x.shape[2] // shape[1]
        part = (slice(d * rows, (d + 1) * rows), slice(None), slice(s * zs, (s + 1) * zs))
        net = SceneNet.create(kernel_size=KS, seed=0)
        pred = spatial_scenenet_forward(net, torch.from_numpy(x[part]), overlap=overlap,
                                        mesh=mesh)
        loss = psum(torch.sum(pred * torch.from_numpy(w[part])), ("data", "space"), mesh)
        loss.backward()
        reduce_gradients(net.parameters(), ("data", "space"), mesh)
        spatial[shape] = {"coords": mesh.coords, "pred": pred.detach().numpy(),
                          "loss": float(loss),
                          "grads": {n: p.grad.numpy().copy()
                                    for n, p in net.named_parameters() if p.grad is not None}}
    out["spatial"] = spatial

    net = SceneNet.create(kernel_size=KS, seed=0, backend="cuda")
    rng = np.random.default_rng(3)
    xi = (rng.random((4, 1, 32, 16, 16)) > 0.9).astype(np.float32)
    dp = make_mesh((4, 1), device=dev)
    sp = make_mesh((2, 2), device=dev)
    out["dp_fns"] = dp_functions(dev)
    out["inference"] = {
        "dp_coords": dp.coords, "sp_coords": sp.coords,
        "dp_mxu": make_dp_inference_fn(net, dp, inference="mxu")(xi).numpy(),
        "sp": make_dp_inference_fn(net, sp, space_axis="space", inference=True)(xi).numpy(),
    }
    return out


def dp_step_inputs():
    rng = np.random.default_rng(4)
    return ((rng.random((4, 1, 32, 16, 16)) > 0.9).astype(np.float32),
            (rng.random((4, 1, 32, 16, 16)) > 0.97).astype(np.float32))


def dp_functions(dev, mesh_shape=(2, 2)):
    """``make_sharded_train_step`` (one SGD step on a global batch) and
    ``make_sharded_eval_step`` (a batch of 3, which the data axis does not
    divide: replicated over data) on ``mesh_shape``, or on one device."""
    from scenenet_tpu_torch.models import SceneNet
    from scenenet_tpu_torch.parallel import (
        make_mesh, make_sharded_eval_step, make_sharded_train_step,
    )
    from scenenet_tpu_torch.train.metrics import init_metric_state, metric_counts

    mesh = make_mesh(mesh_shape, device=dev) if mesh_shape else None
    x, y = dp_step_inputs()
    net = SceneNet.create(kernel_size=KS, seed=0)
    opt = torch.optim.SGD([p for p in net.parameters() if p.requires_grad], lr=1e-2)
    out = {}
    if mesh is None:
        from scenenet_tpu_torch.train import Trainer

        t = Trainer(net, criterion(), _config("/nonexistent", "dpf"), logger=Capture())
        t.optimizer = opt
        m, loss = t.train_step(init_metric_state(), torch.from_numpy(x), torch.from_numpy(y))
        m2, eloss, _ = t.eval_step(init_metric_state(), torch.from_numpy(x[:3]),
                                   torch.from_numpy(y[:3]))
    else:
        step = make_sharded_train_step(net, criterion(), opt, mesh)
        m, loss = step(init_metric_state(), x, y)
        evaluate = make_sharded_eval_step(net, criterion(), mesh)
        m2, eloss, _ = evaluate(init_metric_state(), x[:3], y[:3])
    out["train"] = {"loss": float(loss), "counts": metric_counts(m), "params": _params(net)}
    out["eval"] = {"loss": float(eloss), "counts": metric_counts(m2)}
    return out


def checkpoint_ranks(prefix):
    """2 ranks: a sharded checkpoint written and read back."""
    dev = _init()
    import json

    from scenenet_tpu_torch.parallel import batch_sharding, make_mesh
    from scenenet_tpu_torch.parallel.mesh import barrier
    from scenenet_tpu_torch.train.checkpoint import (
        LocalShard, restore_checkpoint_sharded, save_checkpoint_sharded,
    )

    mesh = make_mesh((2, 1), device=dev)
    grid = torch.arange(4 * 1 * 4 * 2 * 2, dtype=torch.float32).reshape(4, 1, 4, 2, 2)
    tree = {"params": {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
                       "b": torch.tensor(2.5)},
            "step": np.int64(7), "grid": LocalShard.of(grid, batch_sharding(mesh))}
    save_checkpoint_sharded(prefix, tree, {"epoch": 3})
    barrier(mesh)
    template = {"params": {"a": torch.zeros(3, 4), "b": torch.zeros(())},
                "step": np.int64(0),
                "grid": LocalShard.of(torch.zeros_like(grid), batch_sharding(mesh))}
    back = restore_checkpoint_sharded(prefix, template)
    with np.load(f"{prefix}.proc{mesh.rank}.npz") as data:
        keys = sorted(data.files)
    with open(f"{prefix}.proc{mesh.rank}.index.json") as f:
        index = json.load(f)
    return {"keys": keys, "index": index, "a": back["params"]["a"].numpy(),
            "b": float(back["params"]["b"]), "step": int(back["step"]),
            "grid": back["grid"].data.numpy(), "grid_want": tree["grid"].data.numpy()}


def training_2_ranks(tmp, data):
    """2 ranks, mesh (2, 1): the pure-DP legs."""
    dev = _init()
    from scenenet_tpu_torch.parallel import make_mesh

    mesh = make_mesh((2, 1), device=dev)
    out = {"rank": mesh.rank}
    for kind in ("dp", "raw", "quantile", "cnn", "unet"):
        out[kind] = fit_leg(kind, tmp, mesh)
    out["bf16"] = fit_leg("dp", tmp, mesh, tag="bf16", precision="bf16")
    out["lbfgs"] = fit_leg("dp", tmp, mesh, tag="lbfgs", optimizer="lbfgs",
                           learning_rate=0.1)
    out["acc2"] = fit_leg("dp", tmp, mesh, tag="acc2", accumulate_grad_batches=2)
    for kind in ("grids", "points"):
        out[f"cached_{kind}"] = cached_leg(kind, tmp, mesh)
    out["cached_acc2"] = cached_leg("plain", tmp, mesh, accumulate_grad_batches=2)
    out["eval"] = eval_leg(tmp, mesh, z=12)
    out["preempt"] = preempt_leg(tmp, mesh)
    out["admm"] = admm_leg(tmp, mesh)
    out["guards"] = guard_messages(tmp, mesh)
    out["cli"] = cli_leg(tmp, data)
    return out


def cli_leg(tmp, data):
    """``cli.train`` on the launch's ranks: a grid-cache fit over
    ``mesh_data=2``, and the guard of a dataset smaller than a batch."""
    from scenenet_tpu_torch.cli import train as tcli

    argv = ["--device", "cpu", "--dist-backend", "gloo", "--set", "mesh_data=2",
            f"data_path={data}", f"output_dir={os.path.join(tmp, 'cli')}", "batch_size=2",
            "voxel_grid_size=(8, 8, 8)", "kernel_size=(3, 3, 3)", "max_points=1024",
            "max_epochs=1", "num_workers=1"]
    out = {"scores": tcli.main(argv)}
    # the hybrid mesh through the CLI: mesh_dcn_data=2, one rank a slice
    out["dcn_scores"] = tcli.main(argv + ["mesh_data=1", "mesh_dcn_data=2",
                                          f"output_dir={os.path.join(tmp, 'cli_dcn')}"])
    try:
        tcli.main(argv + ["batch_size=64"])
    except ValueError as e:
        out["too_small"] = str(e)
    return out


def training_4_ranks(tmp):
    """4 ranks: data × space (2, 2), the hybrid mesh 2 × (1 × 2), and the
    space legs of the raw prep, evaluation and ADMM."""
    dev = _init()
    from scenenet_tpu_torch.parallel import make_hybrid_mesh, make_mesh

    out = {}
    mesh = make_mesh((2, 2), device=dev)
    out["coords"] = mesh.coords
    out["space"] = fit_leg("space", tmp, mesh)
    out["raw_space"] = fit_leg("raw", tmp, mesh, tag="raw_space")
    out["eval_space"] = eval_leg(tmp, mesh, z=16)
    out["admm_space"] = admm_leg(tmp, mesh, z=32)
    out["guards"] = guard_messages(tmp, mesh)
    hybrid = make_hybrid_mesh((2, 1), (1, 2), device=dev)
    out["hybrid_shape"] = hybrid.shape
    out["hybrid"] = fit_leg("hybrid", tmp, hybrid)
    return out


def hang_ranks():
    """2 ranks: rank 0 waits on a receive that rank 1 never sends."""
    _init()
    import time

    import torch.distributed as dist

    if dist.get_rank() == 0:
        dist.recv(torch.zeros(1), src=1)
    else:
        time.sleep(600)
    return None


# ---- on the card (tests/test_torch_cuda.py) -------------------------------------------

def card_ranks_2(tmp):
    """2 gloo ranks sharing cuda:0, mesh (2, 1): the grid fit and the grid
    cache on the kernels."""
    dev = _init("cuda")
    from scenenet_tpu_torch.parallel import make_mesh

    mesh = make_mesh((2, 1), device=dev)
    return {"dp": fit_leg("dp", tmp, mesh, device=dev),
            "cached_grids": cached_leg("grids", tmp, mesh, device=dev)}


def card_ranks_4(tmp):
    """4 gloo ranks sharing cuda:0, mesh (2, 2): Z sharded, every K2 and K4
    launch B10's halo form."""
    dev = _init("cuda")
    from scenenet_tpu_torch.ops import cuda_conv
    from scenenet_tpu_torch.parallel import make_mesh

    mesh = make_mesh((2, 2), device=dev)
    cuda_conv.LAUNCHES.reset()
    cuda_conv.DK_LAUNCHES.reset()
    out = {"space": fit_leg("space", tmp, mesh, device=dev)}
    out["launches"] = (cuda_conv.LAUNCHES.count, cuda_conv.DK_LAUNCHES.count)
    return out


def card_nccl_rank():
    """1 rank under NCCL: the all-reduce on the card, eagerly and captured in
    a CUDA graph and replayed."""
    dev = _init("cuda", "nccl")
    import torch.distributed as dist

    from scenenet_tpu_torch.parallel.mesh import all_reduce

    x = torch.arange(1024, dtype=torch.float32, device=dev)
    want = x.clone()
    eager = all_reduce(x, dist.group.WORLD)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        for _ in range(3):
            all_reduce(x, dist.group.WORLD)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = all_reduce(x, dist.group.WORLD)
    x.mul_(2.0)
    graph.replay()
    torch.cuda.synchronize(dev)
    return {"eager": bool(torch.equal(eager, want)), "replay": bool(torch.equal(out, 2 * want))}
