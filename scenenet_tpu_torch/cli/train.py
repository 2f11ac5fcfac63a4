"""Train + test entry point.

PyTorch twin of ``scenenet_tpu.cli.train``: builds criterion → model →
data → trainer from a config, fits with per-metric checkpoints and early
stopping, then tests with the best checkpoint. ``dataset`` is ``ts40k``
(the ``fit``/``test`` folders that ``cli.build_samples ts40k`` writes) or
``semantic_kitti`` (the pole crops of ``cli.build_samples semantic_kitti``,
split as ``SemanticKITTICrops`` splits them). ``device_voxelization: false``
voxelizes every sample on the host (``Voxelization`` + ``ToFullDense``) and
trains on the grids the loader stacks, with no batch prep. The streaming
train loader follows the JAX CLI's rule: the native C++ loader
(``NativePointCloudLoader``, bins computed on the card from the raw
points) where ``device_voxelization`` holds and the native library builds,
else the Python loader over ``PointPadding``, whose host-exact bin indices
the card counts; the route is printed. ``device_cache``
picks the training route as the JAX CLI does: ``auto`` (the default)
takes the grid cache (:class:`DeviceGridCache` + ``fit_grid_cached``,
voxelization paid once) when it fits 35% of the card's memory, the point
cache (:class:`DevicePointCache` + ``fit_cached``, voxelized every step)
first under ``augment: true``, and the streaming loader when neither
fits or the model is stateful (``unet``); ``points``/``true`` and
``grids`` ask for a cache, ``false`` for the streaming loader. ``model``
is ``scenenet``, ``quantile`` (:class:`QuantileSceneNet`, one SceneNet a
quantile of ``quantiles``, trained by the quantile criteria with the same
quantiles) or one of the black-box baselines, ``cnn``
(:class:`CnnBaseline` with the config's kernel size) and ``unet``
(:class:`UNet3D`, whose BatchNorm statistics ride along in every
checkpoint; ``precision: bf16`` computes it in bf16), and ``nnunet``
(:class:`NNUNet3D`, nnU-Net's ``3d_fullres`` network as its planner sizes
it for ``voxel_grid_size``, trained with deep supervision: the criterion
wrapped in :class:`DeepSupervision`; f32, one card, the streaming loader).
``precision: bf16``, ``accumulate_grad_batches`` and ``geneo_init: smart``
train as in the JAX CLI. So does the rest of its wiring, in its order:
``model_backend: autotune`` times a train step of ``cuda`` and
``cuda_mxu`` on the card (``auto`` under ``--device cpu``);
``resume_preempted`` continues from ``<checkpoint_dir>/preempt.npz``, the
snapshot a SIGTERM'd run leaves, on whichever fit runs;
``auto_scale_batch_size`` probes a grads step on zero batches, doubling up
to the training set; ``fast_dev_run`` trains one epoch over one batch a
split through the streaming loader; ``auto_lr_find`` runs the learning-rate
range test over up to 8 training batches (L-BFGS keeps its rate);
``constrained: admm`` trains an :class:`ADMMTrainer` on the streaming
loader; ``optimizer: lbfgs`` is L-BFGS with optax's zoom linesearch.

Usage:
    python -m scenenet_tpu_torch.cli.train --config experiments/defaults.yaml \\
        [--set key=value ...] [--device cuda|cpu] [--host-indices]

``--host-indices`` forces the Python loader: the route the JAX CLI takes
where its native library is absent, in which the loader computes each
point's bin in float64 (pyntcloud parity) and the device only counts; its
bins come from the host workers, so it streams. ``--device`` defaults to
``cuda`` and raises without a card; ``cpu`` runs the kernels' plain
versions. A run
configured by ``--set`` alone needs no PyYAML. ``--sweep spec.yaml``
trains ``--sweep-runs`` draws of a random sweep (:func:`run_sweep`) and
prints the best. ``export_stablehlo``, XLA's format, raises.

Mesh training (``mesh_data``, ``mesh_space``, ``mesh_dcn_data``; the
reference's DDP) runs one process a rank, launched by
``torch.distributed.run``; the product of the mesh axes must be its
``WORLD_SIZE``, and rank r computes on ``cuda:{LOCAL_RANK % cards}``::

    python -m torch.distributed.run --nproc-per-node 2 -m scenenet_tpu_torch.cli.train \
        --set mesh_data=2 [--dist-backend nccl|gloo]

``--dist-backend`` (port-only, like ``--device``) defaults to nccl on
``cuda`` and gloo on ``cpu``; ranks that share a card need gloo, since NCCL
refuses two ranks on one GPU. ``mesh_ensemble`` (``model=quantile``: the
ensemble's members over the mesh's ``model`` axis, on every fit route) and
``mesh_channel`` (``model=unet`` or ``cnn``: channel tensor parallelism,
streamed) make the inner axis ``model``, with the JAX CLI's guards::

    python -m torch.distributed.run --nproc-per-node 4 -m scenenet_tpu_torch.cli.train \
        --set model=quantile criterion=quantile_geneo quantiles="(0.1, 0.3, 0.5, 0.9)" \
        mesh_data=2 mesh_ensemble=2
    python -m torch.distributed.run --nproc-per-node 2 -m scenenet_tpu_torch.cli.train \
        --set model=unet criterion=dice_bce mesh_channel=2
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import math
import os
from typing import Dict, List, Optional, Union

import torch

from scenenet_tpu_torch import native
from scenenet_tpu_torch.parallel import launch
from scenenet_tpu_torch.cli.serve import resolve_device
from scenenet_tpu_torch.data import (
    TS40K, Compose, NativePointCloudLoader, PointPadding, SemanticKITTICrops, Subset,
    ToFullDense, Voxelization, VoxelLoader, random_split,
)
from scenenet_tpu_torch.data.device_cache import DeviceGridCache, DevicePointCache
from scenenet_tpu_torch.losses import DeepSupervision, resolve_criterion
from scenenet_tpu_torch.models import CnnBaseline, NNUNet3D, QuantileSceneNet, SceneNet, UNet3D
from scenenet_tpu_torch.train import TrainConfig, Trainer, make_device_voxelize_prep
from scenenet_tpu_torch.train.admm import ADMMConfig, ADMMTrainer
from scenenet_tpu_torch.train.checkpoint import restore_checkpoint
from scenenet_tpu_torch.train.loop import trains_by_replay
from scenenet_tpu_torch.train.preempt import SNAPSHOT_NAME
from scenenet_tpu_torch.train.tune import autotune_backend, find_max_batch_size, lr_range_test
from scenenet_tpu_torch.utils.config import ExperimentConfig, load_config, sample_sweep
from scenenet_tpu_torch.utils.seeding import fix_randomness

# the JAX package's backend names, mapped onto the port's
_BACKENDS = {"torch": "torch", "xla": "torch", "cuda": "cuda", "pallas": "cuda",
             "cuda_mxu": "cuda_mxu", "pallas_mxu": "cuda_mxu"}


def _refuse_unported(cfg: ExperimentConfig) -> None:
    """Raise on every value that asks for something the port does not
    write."""
    if cfg.export_stablehlo:
        raise NotImplementedError("export_stablehlo asks for XLA's StableHLO format, which "
                                  "the port does not write: it exports through "
                                  "utils/export.py (torch.export) and utils/onnx_export.py")
    if cfg.model == "nnunet":
        _refuse_for_nnunet(cfg)


def _refuse_for_nnunet(cfg: ExperimentConfig) -> None:
    """What ``model=nnunet`` does not train: it runs in f32 on one card from
    the streaming loader, as nnU-Net trains on one GPU."""
    if cfg.precision != "f32":
        raise ValueError(f"model=nnunet trains in f32; precision={cfg.precision!r} has no "
                         "route for it")
    wide = {k: int(getattr(cfg, k, 1)) for k in ("mesh_data", "mesh_space", "mesh_dcn_data",
                                                  "mesh_ensemble", "mesh_channel")}
    wide = {k: v for k, v in wide.items() if v > 1}
    if wide:
        raise ValueError(f"model=nnunet trains on one card; mesh axes {wide} are not supported")
    cache = cfg.device_cache
    if isinstance(cache, str) and cache.lower() in ("false", "none", "auto"):
        return
    if cache:
        raise ValueError(f"model=nnunet trains from the streaming loader; device_cache="
                         f"{cache!r} (a cached fit) is not supported: set false or auto")


def launch_command(n_ranks: int) -> str:
    return (f"python -m torch.distributed.run --nproc-per-node {n_ranks} "
            "-m scenenet_tpu_torch.cli.train [--config ...] --set ...")


def build_mesh(cfg: ExperimentConfig, device: str = "cuda",
               dist_backend: Optional[str] = None):
    """The mesh the config asks for, or None for one rank: ``mesh_dcn_data``
    × ``mesh_data`` shard the batch; the inner axis is ``space`` (Z-sharded
    grids, ``mesh_space``) or ``model`` (``mesh_ensemble``: the quantile
    ensemble's members; ``mesh_channel``: the conv stacks' channels), with
    the JAX CLI's guards and messages. The product of the axes must be the
    launch's ``WORLD_SIZE`` (the JAX CLI's devices visible); this process's
    group is initialised here (nccl on ``cuda``, gloo on ``cpu``, unless
    ``dist_backend`` says). A multi-rank mesh outside a launch raises and
    names the command."""
    md, msp = int(cfg.mesh_data), int(cfg.mesh_space)
    mdcn = int(getattr(cfg, "mesh_dcn_data", 1))
    mens, mchan = int(cfg.mesh_ensemble), int(cfg.mesh_channel)
    n = md * msp * mdcn * mens * mchan
    if n <= 1:
        return None
    desc = f"mesh {mdcn}(dcn)×{md}(data)×{msp}(space)×{mens}(ensemble)×{mchan}(channel)"
    if not launch.launched():
        print(f"[mesh] launch {n} ranks: {launch_command(n)}")
        raise RuntimeError(f"{desc} = {n} ranks, but this process was not launched as one: "
                           f"run {launch_command(n)}")
    world = int(os.environ["WORLD_SIZE"])
    if n != world:
        raise ValueError(f"{desc} = {n} devices, but {world} are visible")
    if sum(ax > 1 for ax in (msp, mens, mchan)) > 1:
        raise ValueError("mesh_space / mesh_ensemble / mesh_channel are mutually exclusive "
                         "(one non-data axis)")
    if mchan > 1:
        if cfg.model not in ("unet", "cnn"):
            raise ValueError("channel tensor parallelism (mesh_channel > 1) shards the "
                             "black-box conv stacks via GSPMD "
                             f"(model=unet/cnn; got model={cfg.model!r})")
        if mdcn > 1:
            raise ValueError("mesh_channel composes with mesh_data only (no DCN axis)")
    if msp > 1 and cfg.model != "scenenet":
        raise ValueError("spatial sharding (mesh_space > 1) is implemented for the scenenet "
                         f"model (got model={cfg.model!r})")
    if mens > 1:
        if cfg.model != "quantile":
            raise ValueError("ensemble parallelism (mesh_ensemble > 1) shards the quantile "
                             f"ensemble's members (got model={cfg.model!r})")
        n_members = len(cfg.quantiles)
        if n_members % mens:
            raise ValueError(f"{n_members} quantiles do not divide by mesh_ensemble ({mens})")
    if cfg.constrained == "admm" and mens * mchan > 1:
        raise ValueError("constrained=admm shards over data/space only (no ensemble/channel "
                         "axis)")
    if cfg.batch_size % (md * mdcn):
        raise ValueError(f"batch_size {cfg.batch_size} must divide by the data shards "
                         f"({md * mdcn})")
    if cfg.voxel_grid_size[2] % msp:
        raise ValueError(f"grid Z extent {cfg.voxel_grid_size[2]} must divide by mesh_space "
                         f"({msp})")
    from scenenet_tpu_torch.parallel import make_hybrid_mesh, make_mesh

    if not torch.distributed.is_initialized():
        launch.init_from_env(dist_backend, device)
    dev = launch.rank_device(device)
    # the inner axis: the ensemble's members or the channels (both 'model'; the
    # Trainer routes by the model), or the z slabs
    inner = ("model", mens * mchan) if mens * mchan > 1 else ("space", msp)
    names = ("data", inner[0])
    mesh = (make_hybrid_mesh((mdcn, 1), (md, inner[1]), axis_names=names, device=dev)
            if mdcn > 1 else make_mesh((md, inner[1]), axis_names=names, device=dev))
    if mesh.rank == 0:  # the ranks' outputs share one stream under torch.distributed.run
        print(f"[mesh] training over {dict(mesh.shape)}"
              + (f" ({mdcn}-way DP across slices)" if mdcn > 1 else "")
              + f" ({n} ranks, rank 0 on {dev}, {mesh.backend})", flush=True)
    return mesh


def _resolve_device_cache_auto(cfg: ExperimentConfig, n_samples: int,
                               device: torch.device) -> Union[str, bool]:
    """The training route ``device_cache: auto`` picks, logged as the JAX
    CLI logs it: the grid cache (uint8 x and y grids) before the point
    cache (f32 xyz, int32 label and bool mask a padded point), the point
    cache first when ``augment`` asks for arbitrary-angle rotations, each
    only within a budget of 35% of the card's memory (16 GiB on the CPU,
    the JAX package's fallback), and the streaming loader when neither
    fits or the model is stateful."""
    if not cfg.device_voxelization:
        print("[device_cache auto] -> false (needs device_voxelization)")
        return False
    if cfg.model == "unet":
        # BatchNorm running statistics: the cached fits are stateless-only
        print("[device_cache auto] -> false (stateful model)")
        return False
    if cfg.model == "nnunet":
        print("[device_cache auto] -> false (nnunet streams its batches)")
        return False
    memory = torch.cuda.mem_get_info(device)[1] if device.type == "cuda" else 16 << 30
    budget = int(0.35 * memory)  # room for the conv scratch, the model and evaluation
    grid_voxels = math.prod(cfg.voxel_grid_size)
    sizes = {"grids": n_samples * 2 * grid_voxels, "points": n_samples * cfg.max_points * 17}
    order = ("points", "grids") if cfg.augment else ("grids", "points")
    for cand in order:
        if sizes[cand] <= budget:
            print(f"[device_cache auto] -> {cand!r} "
                  f"(cache {sizes[cand] / 1e9:.2f} GB ≤ budget "
                  f"{budget / 1e9:.2f} GB; augment={cfg.augment})")
            return cand
    print(f"[device_cache auto] -> false (smallest cache "
          f"{min(sizes.values()) / 1e9:.2f} GB > budget {budget / 1e9:.2f} GB)")
    return False


def resolve_device_cache(cfg: ExperimentConfig, n_samples: int, device: torch.device,
                         host_indices: bool = False) -> Union[str, bool]:
    """The training route: ``"grids"``, ``"points"`` or False (the streaming
    loader). ``auto`` decides by :func:`_resolve_device_cache_auto`;
    ``true`` is the point cache, as in the JAX CLI. ``--host-indices``
    streams: its bin indices come from the host workers."""
    value = cfg.device_cache
    if isinstance(value, str) and value.lower() in ("false", "none", "true"):
        value = value.lower() == "true"
    if value == "auto":
        if host_indices:
            print("[device_cache auto] -> false (--host-indices: the bin indices come "
                  "from the host loader)")
            return False
        return _resolve_device_cache_auto(cfg, n_samples, device)
    if not value:
        return False
    if value not in (True, "points", "grids"):
        raise ValueError(f"device_cache must be auto, false, true, points or grids, "
                         f"got {cfg.device_cache!r}")
    if not cfg.device_voxelization:
        raise ValueError(f"device_cache={cfg.device_cache!r} caches padded points; "
                         "device_voxelization=false streams host grids")
    if host_indices:
        raise ValueError(f"device_cache={cfg.device_cache!r} bins on the card; "
                         "--host-indices needs the streaming loader (device_cache=false)")
    return "points" if value is True else value


def resolve_backend(cfg: ExperimentConfig, device) -> str:
    """``auto`` → ``cuda`` on a card, ``torch`` on the CPU."""
    if cfg.model_backend == "auto":
        return "cuda" if device.type == "cuda" else "torch"
    if cfg.model_backend not in _BACKENDS:
        raise ValueError(f"model_backend must be auto or one of {sorted(_BACKENDS)}, "
                         f"got {cfg.model_backend!r}")
    backend = _BACKENDS[cfg.model_backend]
    if backend == "cuda_mxu" and cfg.model not in ("scenenet", "quantile"):
        raise ValueError(f"model_backend={cfg.model_backend!r} is SceneNet's tensor-core "
                         f"stencil; model {cfg.model!r} takes auto, cuda/pallas or torch/xla")
    return backend


def build_criterion(cfg: ExperimentConfig):
    """The config's criterion; a quantile criterion targets the quantiles the
    ensemble's members are built for (``cfg.quantiles``), which the generic
    criterion parameters leave out."""
    kw = cfg.criterion_params()
    if cfg.criterion.startswith("quantile"):
        kw["quantiles"] = tuple(cfg.quantiles)
    criterion = resolve_criterion(cfg.criterion)(**kw)
    return DeepSupervision(criterion) if cfg.model == "nnunet" else criterion


def build_model(cfg: ExperimentConfig, device):
    """The config's model on ``device``, its weights drawn from ``cfg.seed``."""
    backend = resolve_backend(cfg, device)
    if cfg.model == "scenenet":
        model = SceneNet.create(cfg.geneo_num(), cfg.kernel_size, seed=cfg.seed,
                                smart=cfg.geneo_init == "smart", backend=backend)
    elif cfg.model == "quantile":
        model = QuantileSceneNet.create(cfg.geneo_num(), cfg.kernel_size, seed=cfg.seed,
                                        quantiles=tuple(cfg.quantiles), backend=backend)
    elif cfg.model == "cnn":
        model = CnnBaseline.create(conv_num=3, kernel_size=cfg.kernel_size, seed=cfg.seed,
                                   backend=backend)
    elif cfg.model == "unet":
        # precision bf16: bf16 compute inside the model, f32 parameters and
        # running statistics (the trainer's cast alone would leave the convs'
        # operands to the f32 statistics)
        dtype = torch.bfloat16 if cfg.precision == "bf16" else torch.float32
        model = UNet3D.create(seed=cfg.seed, backend=backend, dtype=dtype)
    elif cfg.model == "nnunet":
        model = NNUNet3D.create(tuple(cfg.voxel_grid_size), seed=cfg.seed, backend=backend)
    else:
        raise NotImplementedError(f"model {cfg.model!r}")
    return model.to(device)


def build_datasets(cfg: ExperimentConfig):
    """(train, val, test) datasets of the config, as the JAX CLI builds
    them: padded points (``PointPadding`` at its defaults, host-exact bin
    indices included) for device voxelization, else host grids
    (``Voxelization`` + ``ToFullDense``); ``random_split`` of the fit split
    into train and validation."""
    if cfg.device_voxelization:
        transform = PointPadding(max_points=cfg.max_points, vxg_size=cfg.voxel_grid_size,
                                 vox_size=cfg.voxel_size)
    else:
        transform = Compose([
            Voxelization(list(cfg.keep_labels), vox_size=cfg.voxel_size,
                         vxg_size=cfg.voxel_grid_size),
            ToFullDense((True, True)),
        ])
    if cfg.dataset == "ts40k":
        fit = TS40K(cfg.data_path, split="fit", transform=transform)
        test = TS40K(cfg.data_path, split="test", transform=transform)
    elif cfg.dataset == "semantic_kitti":
        fit = SemanticKITTICrops(cfg.data_path, split="train", transform=transform)
        test = SemanticKITTICrops(cfg.data_path, split="test", transform=transform)
    else:
        raise NotImplementedError(f"dataset {cfg.dataset!r}")
    train_idx, val_idx = random_split(len(fit), cfg.val_split, seed=cfg.seed)
    return Subset(fit, train_idx), Subset(fit, val_idx), test


def resolve_loader(cfg: ExperimentConfig, host_indices: bool = False) -> bool:
    """Whether the train loader is the native one, by the JAX CLI's rule
    (``device_voxelization`` and the native library available), unless
    ``--host-indices`` forces the Python loader. Prints the route."""
    if not cfg.device_voxelization:
        print("[loader] -> VoxelLoader (device_voxelization=false: host grids, "
              "no batch prep)")
        return False
    if host_indices:
        print("[loader] -> VoxelLoader + PointPadding (--host-indices: host-exact bin "
              "indices, use_indices=True)")
        return False
    if native.available():
        print(f"[loader] -> NativePointCloudLoader (threads={cfg.num_workers}; bins on "
              "the device, use_indices=False)")
        return True
    print("[loader] -> VoxelLoader + PointPadding (native library unavailable: host-exact "
          "bin indices, use_indices=True)")
    return False


class _OneBatch:
    """``fast_dev_run``'s loader: the first batch of ``loader`` alone."""

    def __init__(self, loader):
        self.loader = loader

    def __iter__(self):
        for batch in self.loader:
            yield batch
            return

    def __len__(self):
        return min(1, len(self.loader))


def _autotune(cfg: ExperimentConfig, criterion, device: torch.device,
              graph: bool = False, mesh=None) -> None:
    """``model_backend: autotune``: time a train step of each kernel backend
    on the card at the run's shapes and keep the fastest, by CUDA graph
    replays where ``graph`` says the run trains so (L-BFGS always eagerly);
    without a card, the ``auto`` rule (the JAX CLI's non-TPU fallback).
    Under a mesh the shapes are one rank's: its rows and its z slab."""
    if device.type != "cuda":
        print("[autotune] no CUDA device (--device cpu); using model_backend=auto")
        cfg.model_backend = "auto"
        return
    gz, gx, gy = cfg.grid_zxy()
    batch = cfg.batch_size
    if mesh is not None:
        batch, gz = batch // mesh.shape["data"], gz // mesh.shape.get("space", 1)
    grid = (gz, gx, gy)
    winner, times = autotune_backend(
        lambda b: SceneNet.create(cfg.geneo_num(), cfg.kernel_size, seed=cfg.seed,
                                  backend=b).to(device),
        criterion, batch, grid, optimizer=cfg.optimizer,
        cache_key_extra=f"ks={cfg.kernel_size},geneo={cfg.geneo_num()}", graph=graph)
    route = "graph replays" if graph else "eager steps"
    print(f"[autotune] backend -> {winner} at {'per-shard ' if mesh else ''}(batch {batch}, "
          f"grid {grid}; {route})  ("
          + ", ".join(f"{k}: {v:.2f} ms" for k, v in times.items()) + ")")
    cfg.model_backend = winner


def batch_probe_limit(cfg: ExperimentConfig, n_train: int) -> int:
    """The largest batch ``auto_scale_batch_size`` probes: the JAX
    package's 4096, the training set (a larger batch trains on no more
    data, and the cached routes need one full batch), and the largest batch
    whose grids the kernels take (B·Z·X·Y < 2³¹: past it they refuse the
    shape, which is no out-of-memory and would end the probe)."""
    return max(cfg.batch_size,
               min(4096, n_train, (2**31 - 1) // math.prod(cfg.grid_zxy())))


def make_batch_probe(cfg: ExperimentConfig, model, criterion, prep, device: torch.device):
    """``auto_scale_batch_size``'s probe: ``probe(b)`` runs one real grads
    step (the batch prep, the forward, the loss and the backward; no
    update) on a zero batch of ``b`` padded clouds on ``device``."""
    params = [p for p in model.parameters() if p.requires_grad]

    def probe(b: int) -> None:
        pts = torch.zeros((b, cfg.max_points, 3), dtype=torch.float32, device=device)
        labels = torch.zeros((b, cfg.max_points), dtype=torch.int32, device=device)
        mask = torch.ones((b, cfg.max_points), dtype=torch.bool, device=device)
        x, y = prep(pts, labels, mask)
        loss = criterion(model(x), y, model.cvx_coefficients(), model.geneo_params_flat(),
                         model.last_lambda)
        torch.autograd.grad(loss, params)
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    return probe


def run(cfg: ExperimentConfig, device: "str | None" = "cuda",
        host_indices: bool = False, dist_backend: Optional[str] = None) -> Dict[str, float]:
    _refuse_unported(cfg)
    # resolved first, so that the tuners below see one rank's shapes
    mesh = build_mesh(cfg, device or "cuda", dist_backend)
    device = mesh.device if mesh is not None else resolve_device(device)
    fix_randomness(cfg.seed)
    run_dir = os.path.join(cfg.output_dir, cfg.project)
    ckpt_dir = cfg.checkpoint_dir or os.path.join(run_dir, "checkpoints")

    if cfg.model_backend == "autotune" and cfg.model not in ("scenenet", "quantile"):
        raise ValueError("model_backend=autotune supports the scenenet family "
                         f"(got model={cfg.model!r})")
    criterion = build_criterion(cfg)
    train_ds, val_ds, test_ds = build_datasets(cfg)
    if mesh is not None and len(train_ds) < cfg.batch_size:
        # the loaders would fall back to drop_last=False and give one ragged
        # batch that the data shards do not divide
        raise ValueError(f"mesh training needs at least one full batch: {len(train_ds)} "
                         f"training samples < batch_size {cfg.batch_size}")
    native_loader = resolve_loader(cfg, host_indices)
    if (mesh is not None and cfg.device_cache
            and (mesh.shape.get("space", 1) > 1 or int(cfg.mesh_channel) > 1)):
        # the cached fits shard over the data axis (and the ensemble's members);
        # spatial sharding and channel TP stream their batches
        if cfg.device_cache != "auto":
            print("[mesh] device_cache disabled (cached epochs are pure-DP; spatial/channel "
                  "sharding streams batches)")
        cfg.device_cache = False
    device_cache = resolve_device_cache(cfg, len(train_ds), device, host_indices)
    # the fit the run takes: a cached one (replayed on a card), else ADMM's or the streamed one
    cached_fit = bool(device_cache) and not cfg.fast_dev_run and cfg.constrained != "admm"
    if cfg.model_backend == "autotune":
        # time the step as the run will take it
        _autotune(cfg, criterion, device,
                  graph=cached_fit and trains_by_replay(device, cfg.optimizer, mesh), mesh=mesh)
    model = build_model(cfg, device)
    if cfg.resume_from_checkpoint:
        ckpt_path = os.path.join(ckpt_dir, cfg.resume_checkpoint_name + ".npz")
        if not os.path.exists(ckpt_path):
            raise FileNotFoundError(f"Checkpoint {ckpt_path} does not exist.")
        restore_checkpoint(ckpt_path, model)

    def make_loaders(batch_size: int):
        drop_last = len(train_ds) >= batch_size
        if native_loader:
            train = NativePointCloudLoader(
                train_ds, batch_size, shuffle=True, seed=cfg.seed, max_points=cfg.max_points,
                threads=cfg.num_workers, drop_last=drop_last)
        else:
            train = VoxelLoader(train_ds, batch_size, shuffle=True,
                                num_workers=cfg.num_workers, seed=cfg.seed,
                                drop_last=drop_last)
        return (train, VoxelLoader(val_ds, batch_size, num_workers=cfg.num_workers),
                VoxelLoader(test_ds, batch_size, num_workers=cfg.num_workers))

    train_loader, val_loader, test_loader = make_loaders(cfg.batch_size)
    tcfg = TrainConfig(
        max_epochs=cfg.max_epochs, optimizer=cfg.optimizer,
        learning_rate=cfg.learning_rate, tau=cfg.tau,
        accumulate_grad_batches=cfg.accumulate_grad_batches,
        early_stop_metric=cfg.early_stop_metric,
        early_stop_patience=cfg.early_stop_patience, checkpoint_dir=ckpt_dir,
        checkpoint_top_k=cfg.checkpoint_top_k, run_dir=run_dir,
        use_wandb=cfg.use_wandb, precision=cfg.precision,
        compiler_options=cfg.compiler_options, epoch_chunks=cfg.epoch_chunks,
        checkpoint_every_n_steps=cfg.checkpoint_every_n_steps)
    # a SIGTERM'd run leaves a snapshot; the next launch of the experiment
    # continues from it
    preempt_snap = None
    if cfg.resume_preempted:
        candidate = os.path.join(ckpt_dir, SNAPSHOT_NAME)
        if os.path.exists(candidate):
            preempt_snap = candidate
            print(f"[preempt] resuming from snapshot {candidate}")
    # the native loader makes no bin index: the device bins the raw points
    prep = (make_device_voxelize_prep(cfg.voxel_grid_size, tuple(cfg.keep_labels),
                                      use_indices=not native_loader)
            if cfg.device_voxelization else None)

    if cfg.auto_scale_batch_size and mesh is not None:
        # the single-rank probe would measure one rank's share of the mesh
        print("[auto_scale_batch_size] skipped: the probe is single-device; size the "
              "global batch as shards × per-shard capacity")
    elif cfg.auto_scale_batch_size and cfg.device_voxelization and \
            cfg.model in ("scenenet", "quantile"):
        found = find_max_batch_size(make_batch_probe(cfg, model, criterion, prep, device),
                                    start=cfg.batch_size,
                                    max_batch=batch_probe_limit(cfg, len(train_ds)))
        print(f"[auto_scale_batch_size] largest batch whose step runs: {found}")
        if found != cfg.batch_size:
            print(f"[auto_scale_batch_size] batch_size {cfg.batch_size} → {found}")
            cfg.batch_size = found
            train_loader, val_loader, test_loader = make_loaders(found)

    if cfg.fast_dev_run:
        # Lightning's fast_dev_run: one epoch over one batch a split
        tcfg.max_epochs = 1
        tcfg.early_stop_metric = None
        train_loader, val_loader, test_loader = (
            _OneBatch(train_loader), _OneBatch(val_loader), _OneBatch(test_loader))
        print("[fast_dev_run] one epoch, one batch a split, the streaming loader")

    if cfg.auto_lr_find and cfg.model in ("scenenet", "quantile"):
        probe_batches = []
        for batch in train_loader:
            probe_batches.append(batch)
            if len(probe_batches) >= 8:
                break
        if probe_batches:
            try:
                suggested, _ = lr_range_test(model, criterion, probe_batches,
                                             optimizer=cfg.optimizer, batch_prep=prep)
            except NotImplementedError as e:
                # an optional convenience: an optimizer it does not take
                # (lbfgs) keeps the configured rate
                print(f"[auto_lr_find] skipped ({e}); keeping "
                      f"learning_rate={tcfg.learning_rate}")
            else:
                print(f"[auto_lr_find] suggested learning_rate={suggested:.3e} "
                      f"(was {tcfg.learning_rate})")
                tcfg.learning_rate = suggested

    val = val_loader if len(val_ds) else None
    if cfg.constrained == "admm":
        acfg = ADMMConfig(**{**dataclasses.asdict(tcfg), "admm_rho": cfg.admm_rho})
        print(f"[admm] augmented-Lagrangian training (rho={cfg.admm_rho}, "
              f"optimizer={cfg.optimizer}) on the streaming loader")
        trainer = ADMMTrainer(model, criterion, acfg, batch_prep=prep, mesh=mesh)
        _, best = trainer.fit(train_loader, val)
    elif cached_fit:
        # the dataset resident on the card, the epochs without the host loader:
        # "points" voxelizes every step (point-space augmentation), "grids" once
        trainer = Trainer(model, criterion, tcfg, batch_prep=prep, mesh=mesh)
        # seeded alike on every rank: each draws the same permutation and
        # augmentation and takes its own rows
        gen = torch.Generator(device).manual_seed(cfg.seed)
        cache = DevicePointCache(train_ds, device)
        if device_cache == "grids":
            grids = DeviceGridCache(cache, prep)
            del cache  # free the resident points
            _, best = trainer.fit_grid_cached(grids, cfg.batch_size, augment=cfg.augment,
                                              generator=gen, val_loader=val,
                                              resume_from=preempt_snap)
        else:
            _, best = trainer.fit_cached(cache, cfg.batch_size, augment=cfg.augment,
                                         generator=gen, val_loader=val,
                                         resume_from=preempt_snap)
    else:
        trainer = Trainer(model, criterion, tcfg, batch_prep=prep, mesh=mesh)
        _, best = trainer.fit(train_loader, val, resume_from=preempt_snap)
    if getattr(trainer, "preempted", False):
        print("[preempt] stopped early: the next launch of this experiment resumes from "
              "the snapshot")

    print(f"{'=' * 20} best scores {'=' * 20}")
    for k, v in sorted(best.items()):
        print(f"  {k}: {v:.4f}")

    # test with the best checkpoint; the final parameters where none qualified
    if cfg.test_checkpoint == "best":
        metric = cfg.early_stop_metric or "train_FBetaScore"
        try:
            trainer.restore_best(metric)
            print(f"[test] using best '{metric}' checkpoint")
        except (FileNotFoundError, KeyError) as e:
            print(f"[test] best checkpoint unavailable ({e}); using final params")
    test_scores = trainer.evaluate(test_loader, prefix="test")
    for k, v in sorted(test_scores.items()):
        print(f"  {k}: {v:.4f}")
    return {**best, **test_scores}


def parse_overrides(pairs: List[str]) -> Dict[str, object]:
    """``key=value`` strings → a dict, each value read as a Python literal
    where it is one (``(9, 5, 5)``, ``1e-3``, ``None``) and kept as a string
    where it is not."""
    overrides = {}
    for kv in pairs:
        key, val = kv.split("=", 1)
        try:
            overrides[key] = ast.literal_eval(val)
        except (ValueError, SyntaxError):
            overrides[key] = val
    return overrides


def run_sweep(draws: List[Dict[str, object]], config_path: Optional[str],
              overrides: Dict[str, object], device: "str | None" = "cuda",
              host_indices: bool = False, dist_backend: Optional[str] = None
              ) -> Dict[str, object]:
    """Train one run a draw (the draw under the config file and the
    ``--set`` overrides, as the JAX CLI merges them; the project named
    ``<project>_sweep<i>``) and score each by ``val_FBetaScore``, else
    ``train_FBetaScore``. Returns the best score and its draw."""
    best_score, best_cfg = -1.0, None
    for i, draw in enumerate(draws):
        cfg = load_config(config_path, {**draw, **overrides})
        cfg.project = f"{cfg.project}_sweep{i}"
        scores = run(cfg, device=device, host_indices=host_indices, dist_backend=dist_backend)
        score = scores.get("val_FBetaScore", scores.get("train_FBetaScore", 0.0))
        print(f"[sweep {i}] val_FBetaScore={score:.4f} draw={draw}")
        if score > best_score:
            best_score, best_cfg = score, draw
    print(f"[sweep] best val_FBetaScore={best_score:.4f} with {best_cfg}")
    return {"best_score": best_score, "best_draw": best_cfg}


def main(argv: Optional[List[str]] = None) -> Dict[str, object]:
    parser = argparse.ArgumentParser(description="Train SCENE-Net or a baseline (PyTorch)")
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--set", action="extend", nargs="*", default=[],
                        help="config overrides key=value (repeatable)")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cpu runs the kernels' plain versions")
    parser.add_argument("--host-indices", action="store_true",
                        help="force the Python loader: bins on the host in float64 "
                             "(pyntcloud parity), which the device counts; streams")
    parser.add_argument("--sweep", type=str, default=None,
                        help="wandb-style sweep spec (random search)")
    parser.add_argument("--sweep-runs", type=int, default=4)
    parser.add_argument("--dist-backend", default=None, choices=list(launch.BACKENDS),
                        help="the process group's backend under a mesh (default nccl on "
                             "cuda, gloo on cpu; gloo where ranks share a card)")
    args = parser.parse_args(argv)
    overrides = parse_overrides(args.set)
    if args.sweep:
        return run_sweep(sample_sweep(args.sweep, args.sweep_runs), args.config, overrides,
                         device=args.device, host_indices=args.host_indices,
                         dist_backend=args.dist_backend)
    return run(load_config(args.config, overrides), device=args.device,
               host_indices=args.host_indices, dist_backend=args.dist_backend)


if __name__ == "__main__":
    main()
