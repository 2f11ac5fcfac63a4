"""The training runtime: train step, epoch loop, checkpoints, early stop.

PyTorch twin of the streaming path of :mod:`scenenet_tpu.train.loop`:

- a **train step** takes a raw padded point batch to the device, voxelizes
  it there (:func:`make_device_voxelize_prep`), runs the forward, the loss
  with the GENEO penalties read from the live parameters, the backward and
  the optimizer step, and adds the batch's confusion counts to counts kept
  on the device — no host sync inside an epoch beyond the data feed;
- the epoch loop keeps per-metric top-k checkpoints and ``last.npz``, early
  stopping, the per-epoch log of the interpretable parameters, and one
  gradient snapshot per epoch;
- the device-resident epochs (:meth:`Trainer.fit_cached` from a
  :class:`~scenenet_tpu_torch.data.device_cache.DevicePointCache`,
  :meth:`Trainer.fit_grid_cached` from a
  :class:`~scenenet_tpu_torch.data.device_cache.DeviceGridCache`) run
  every batch of an epoch without the host loader: on a card, one train
  step captured as a CUDA graph and replayed once a batch
  (:class:`~scenenet_tpu_torch.train.step_graph.StepGraph`), the
  counterpart of the JAX package's ``lax.scan`` dispatch;
- ``precision: bf16`` runs the forward on bf16 copies of the floating
  parameters and a bf16 input, through ``torch.func.functional_call``, so
  the gradients land on the f32 masters; the prediction goes back to f32
  and the loss and the GENEO penalties are taken on the masters, as in the
  JAX package's ``Trainer._loss``;
- ``accumulate_grad_batches > 1`` wraps the optimizer in
  :class:`~scenenet_tpu_torch.train.state.MultiSteps` (``optax.MultiSteps``):
  the confusion counts and the loss are recorded every call, the update
  every k-th; on a card the cached routes capture two steps, one that
  accumulates and one that accumulates and updates, and replay the one the
  host's count names.

- ``optimizer: lbfgs`` is :class:`~scenenet_tpu_torch.train.lbfgs.LBFGS`
  (``optax.lbfgs`` with its zoom linesearch): the step hands it a closure
  that re-evaluates the loss on the step's batch. Its linesearch reads
  values on the host, so on every route its step runs eagerly; the cached
  routes capture no graph for it;
- every fit is preemption-safe, as in the JAX package: a SIGTERM (or
  :func:`~scenenet_tpu_torch.train.preempt.request_preemption`) flushes a
  resumable snapshot at the next batch or chunk boundary and the fit
  returns with ``self.preempted``; ``checkpoint_every_n_steps`` also
  snapshots periodically; ``resume_from`` continues from a snapshot, bit
  for bit on the cached routes and on the streamed route where the loader
  gives the epoch's batches in the same order;
- ``log_pointclouds_every`` writes PLYs of the first validation sample's
  input, target and prediction every N epochs of the streamed ``fit``
  (the JAX cached fits write none either); ``use_wandb`` mirrors the logs
  to wandb where it starts (:class:`RunLogger`);
- ``Trainer(mesh=...)`` trains over a mesh of ranks
  (:mod:`scenenet_tpu_torch.parallel`): every rank takes its rows of each
  batch (and, with a ``space`` axis, its z slab, through the halo-exchange
  forward), the criterion's global sums and the gradients are reduced over
  the ranks, and the confusion counts summed, so every rank holds the
  single-device fit's state. The streamed ``fit`` and both cached fits
  assemble each batch replicated and take the rank's rows; evaluation
  splits a batch by rows where the data axis divides it and replicates a
  ragged tail; the first rank alone writes checkpoints, snapshots and logs.
  A mesh of one rank runs the plain path. A ``model`` axis splits a quantile
  ensemble's members (:mod:`~scenenet_tpu_torch.parallel.ep`, every fit
  route) or a conv stack's channels (:mod:`~scenenet_tpu_torch.parallel.gspmd`,
  the streamed ``fit``); of size 1 it is data parallelism.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import time
import warnings
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import torch
from torch import nn
from torch.func import functional_call

from scenenet_tpu_torch.data.device_cache import (
    d4_transform_grids, draw_d4, draw_point_augmentation, gather_augment,
)
from scenenet_tpu_torch.ops._build import launch_counts
from scenenet_tpu_torch.ops.voxelize import (
    _is_tower, voxelize_batch, voxelize_batch_binary, voxelize_batch_from_indices,
)
from scenenet_tpu_torch.train.callbacks import BestMetricTracker, EarlyStopping
from scenenet_tpu_torch.train.checkpoint import CheckpointManager, restore_checkpoint
from scenenet_tpu_torch.train.metrics import (
    DEFAULT_BETA, DEFAULT_TAU, METRIC_NAMES, MetricState, compute_metrics,
    init_metric_state, metric_counts, update_metrics,
)
from scenenet_tpu_torch.train.lbfgs import LBFGS
from scenenet_tpu_torch.train.preempt import (
    SNAPSHOT_NAME, PreemptionGuard, chunk_starts, discard_snapshot,
    load_train_snapshot_if_compatible, save_train_snapshot,
)
from scenenet_tpu_torch.train.state import (
    MultiSteps, cast_half, load_optimizer_state, optimizer_needs_value_fn, optimizer_state,
    resolve_optimizer,
)
from scenenet_tpu_torch.train.step_graph import StepGraph
from scenenet_tpu_torch.utils.logging import NullLogger, RunLogger
from scenenet_tpu_torch.utils.profiling import phase, span, trace


@dataclasses.dataclass
class TrainConfig:
    max_epochs: int = 20
    optimizer: str = "adam"
    learning_rate: float = 1e-3
    tau: float = DEFAULT_TAU
    fbeta: float = DEFAULT_BETA
    accumulate_grad_batches: int = 1
    early_stop_metric: Optional[str] = "train_FBetaScore"
    early_stop_patience: int = 25
    checkpoint_dir: str = "checkpoints"
    checkpoint_top_k: int = 2
    run_dir: str = "runs/default"
    log_gradients: bool = True
    log_pointclouds_every: int = 0  # every N epochs export val sample PLYs (0 = off)
    use_wandb: bool = False
    debug_nans: bool = False        # torch.autograd.set_detect_anomaly around each step
    profile_dir: Optional[str] = None  # write a torch.profiler trace of epoch 0 there
    precision: str = "f32"
    compiler_options: Optional[dict] = None  # XLA's per-jit options: none apply here
    # chunks of a device-resident epoch: a chunk boundary is where a
    # preempted cached fit flushes its snapshot, so a SIGTERM loses at most
    # 1/K of the epoch (every step is one graph replay either way)
    epoch_chunks: int = 1
    checkpoint_every_n_steps: int = 0  # also snapshot every N steps (0: on SIGTERM only)


def _monitor_modes() -> Dict[str, str]:
    """Metric → 'max'|'min' for the per-metric top-k checkpoints, train_
    and val_ alike (a monitor absent from an epoch's scores is skipped)."""
    monitors = {}
    for m in METRIC_NAMES:
        monitors[f"train_{m}"] = "max"
        monitors[f"val_{m}"] = "max"
    monitors["train_loss"] = "min"
    monitors["val_loss"] = "min"
    return monitors


def make_device_voxelize_prep(grid_shape=(64, 64, 64), keep_labels=(15,),
                              binarize=(True, True), use_indices=True):
    """A ``batch_prep`` for :class:`Trainer`: a raw padded point batch
    (points, labels, mask[, flat_idx]) on the device → (x, y) voxel grids
    (B, 1, Z, X, Y) f32.

    ``use_indices`` with a ``flat_idx`` in the batch takes the host-exact
    bin indices of ``PointPadding(compute_indices=True)``
    (:func:`voxelize_batch_from_indices`); otherwise the bins are computed
    on the device from the raw coordinates, by :func:`voxelize_batch_binary`
    when both grids are binarized and by :func:`voxelize_batch` when not.
    ``binarize`` says for x (density) and y (tower fraction) whether the
    grid becomes ``> 0`` as {0, 1}. ``use_indices`` defaults to True, as in
    the JAX package and as ``PointPadding.compute_indices`` does; the train
    CLI sets it False for the native loader, which makes no index.
    """
    grid_shape = tuple(int(g) for g in grid_shape)
    keep_labels = tuple(int(k) for k in keep_labels)
    binarize = tuple(bool(v) for v in binarize)

    def prep(points, labels, mask, flat_idx=None):
        if use_indices and flat_idx is not None:
            is_tower = _is_tower(labels, keep_labels)
            hist, reg = voxelize_batch_from_indices(flat_idx, is_tower, mask, grid_shape)
        elif binarize == (True, True):
            x, y = voxelize_batch_binary(points, labels, mask, keep_labels, grid_shape)
            return x[:, None], y[:, None]
        else:
            hist, reg = voxelize_batch(points, labels, mask, keep_labels, grid_shape)
        x, y = hist[:, None], reg[:, None]
        if binarize[0]:
            x = (x > 0).to(torch.float32)
        if binarize[1]:
            y = (y > 0).to(torch.float32)
        return x, y

    return prep


def _in_mesh(method):
    """Run ``method`` with the trainer's mesh active, so that the criterion's
    and the BatchNorms' collectives name its axes."""
    @functools.wraps(method)
    def wrapped(self, *args, **kwargs):
        with (self.mesh.active() if self.mesh is not None else contextlib.nullcontext()):
            return method(self, *args, **kwargs)

    return wrapped


class Trainer:
    """Trainer for an ``nn.Module`` ``model(x) -> pred`` (optionally with
    ``cvx_coefficients()``, ``geneo_params_flat()``, ``last_lambda`` and
    ``parameters_in_dict()``, which SceneNet has). It trains on the device
    that holds the model's parameters and moves each batch there.

    ``mesh`` (:func:`scenenet_tpu_torch.parallel.make_mesh` or
    ``make_hybrid_mesh``, axes ``data`` and ``space`` or ``data`` and
    ``model``) trains over its ranks, each process a rank holding the model
    on ``mesh.device``: the batch over ``data``, the grid's Z over ``space``
    (SceneNet's halo-exchange forward; ``overlap`` picks its overlapped
    form), the gradients and the loss averaged and the confusion counts
    summed over both. A stateful model (the UNet) trains over ``data`` with
    its BatchNorms synchronised. A ``model`` axis wider than 1 splits a
    quantile ensemble's members (ensemble parallelism) or, for any other
    model, the conv stack's output channels (channel tensor parallelism:
    the ranks train their slices, ``self.model`` gets the full parameters
    back before every checkpoint and at the end of the fit). A mesh of one
    rank is the plain path."""

    def __init__(self, model: nn.Module, criterion: Callable, config: TrainConfig,
                 logger: Optional[RunLogger] = None,
                 batch_prep: Optional[Callable] = None, mesh: Optional[Any] = None,
                 overlap: bool = False):
        if config.precision not in ("f32", "bf16"):
            raise ValueError(f"precision must be 'f32' or 'bf16', got {config.precision!r}")
        if config.accumulate_grad_batches < 1:
            raise ValueError("accumulate_grad_batches must be >= 1, got "
                             f"{config.accumulate_grad_batches}")
        if config.compiler_options:
            raise ValueError(f"compiler_options {config.compiler_options!r} are XLA "
                             "compiler flags; the port compiles with nvcc and takes none")
        self.model = model
        self.criterion = criterion
        self.config = config
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.overlap = overlap
        self._axes: Tuple[str, ...] = ()
        self._space = 1
        # how the mesh splits the work: "dp" (data, and space), "ep" (the
        # ensemble's members over 'model') or "tp" (channels over 'model')
        self._mode: Optional[str] = None
        self._tp: Optional[nn.Module] = None  # the rank's channel-parallel copy
        if self.mesh is not None:
            from scenenet_tpu_torch.parallel.dp import mesh_axes

            self._space = self.mesh.shape.get("space", 1)
            self._mode = ("dp" if self.mesh.shape.get("model", 1) <= 1 else
                          "ep" if hasattr(model, "quantiles") else "tp")
            self._axes = {"dp": mesh_axes(self.mesh), "ep": ("data", "model"),
                          "tp": ("data",)}[self._mode]
            self._check_mesh_supported()
        # the first rank alone writes checkpoints, snapshots and logs: every
        # rank holds the same state and scores
        self._writes = self.mesh is None or self.mesh.rank == int(self.mesh.devices.flat[0])
        self.logger = logger or (RunLogger(config.run_dir, use_wandb=config.use_wandb)
                                 if self._writes else NullLogger())
        self.batch_prep = batch_prep
        self.device = next(model.parameters()).device
        # axes -> (the criterion, it made distributed over them)
        self._criteria: Dict[Tuple[str, ...], Tuple[Callable, Callable]] = {}
        self._spatial: Optional[nn.Module] = None
        if self.mesh is not None:
            from scenenet_tpu_torch.parallel.dp import SpatialForward
            from scenenet_tpu_torch.parallel.mesh import Placement

            self._place = Placement(self.mesh, "data", "space")
            if self.device != self.mesh.device:
                raise ValueError(f"the model is on {self.device}, the mesh's rank on "
                                 f"{self.mesh.device}")
            if self._mode == "ep":
                from scenenet_tpu_torch.parallel.ep import local_members

                self._members = local_members(model, self.mesh)
            elif self._mode == "tp":
                from scenenet_tpu_torch.parallel.gspmd import channel_parallel

                self._tp = channel_parallel(model, self.mesh)
                if getattr(model, "is_stateful", False):
                    self._tp.with_bn_sync("data")
            elif getattr(model, "is_stateful", False):
                model.with_bn_sync("data")
            if self._space > 1:
                self._spatial = SpatialForward(model, self.mesh, overlap=overlap)
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.multi_steps: Optional[MultiSteps] = None  # accumulate_grad_batches > 1
        self.step = 0
        self.best = BestMetricTracker()
        self._ckpt: Optional[CheckpointManager] = None
        # (tp, fp, fn, tn) of every training epoch, in order
        self.train_counts: List[Tuple[int, int, int, int]] = []
        self.cached_epochs: Optional["CachedEpochs"] = None  # the last cached fit's epochs
        self.preempted = False  # the last fit flushed a snapshot and returned early

    # ---- the mesh ------------------------------------------------------------

    @property
    def net(self) -> nn.Module:
        """The module that computes and trains: the model, or under channel
        tensor parallelism the rank's channel-parallel copy of it."""
        return self._tp if self._tp is not None else self.model

    def _check_mesh_supported(self, pure_dp: bool = False,
                              batch_size: Optional[int] = None) -> None:
        """The loud guards of every mesh fit: what the mesh paths do not
        train raises here rather than training something else."""
        shape = self.mesh.shape
        if "data" not in shape or set(shape) - {"data", "space", "model"}:
            raise ValueError(f"mesh axes {tuple(shape)}: the Trainer trains over 'data' with "
                             "'space' or 'model' (the pipeline's 'stage' axis is "
                             "parallel.pp's own step)")
        if pure_dp and self._mode == "tp":
            raise ValueError("GSPMD channel-TP training (mesh 'model' axis on a non-ensemble "
                             "model) streams batches via fit(); the cached-epoch fits shard "
                             "over 'data' only")
        if getattr(self.model, "is_stateful", False):
            if pure_dp:
                raise ValueError("cached-epoch mesh training supports stateless models "
                                 "only; stateful models (unet) stream batches via fit()")
            if self._space > 1:
                raise ValueError("stateful models do not support spatial sharding — got "
                                 f"{dict(shape)}")
            if self._mode == "dp" and not hasattr(self.model, "with_bn_sync"):
                raise ValueError(f"stateful model {type(self.model).__name__} lacks "
                                 "with_bn_sync(axis); cross-shard batch-stats sync is "
                                 "required for DP mesh training")
        if self._space > 1 and self._mode != "dp":
            raise ValueError(
                "a mesh cannot combine the channel-TP ('model') and spatial ('space') axes; "
                "use (data, model)" if self._mode == "tp" else
                "a mesh cannot combine the ensemble ('model') and spatial ('space') axes yet; "
                "use (data, model)")
        if self._mode == "ep":
            from scenenet_tpu_torch.parallel.ep import _check_criterion, _check_ensemble

            _check_ensemble(self.model, self.mesh)
            _check_criterion(self.criterion, self.model)
        if self._mode == "tp":
            from scenenet_tpu_torch.parallel.gspmd import _check_shardable
            from scenenet_tpu_torch.train.checkpoint import _module_state

            _check_shardable(_module_state(self.model), self.mesh)
        if self._space > 1 and not hasattr(self.model, "synthesize_kernels"):
            raise ValueError("spatial sharding (mesh space > 1) requires the SceneNet "
                             "forward protocol (synthesize_kernels/effective_lambdas); "
                             f"model {type(self.model).__name__} does not provide it — "
                             "pure-DP (space=1) supports any stateless model")
        if pure_dp and self._space > 1:
            raise ValueError("cached-epoch mesh training is pure-DP (mesh space must be 1); "
                             "spatially-sharded training streams batches via fit()")
        if batch_size is not None and batch_size % shape["data"]:
            raise ValueError(f"batch_size {batch_size} must divide by the mesh data axis "
                             f"({shape['data']})")

    def _rows(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's rows of ``t`` (along ``dim``) under a mesh, else ``t``."""
        return self._place.part(t, dim, "data") if self.mesh is not None else t

    def _slab(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's z slab of a (B, C, Z, X, Y) grid where Z is sharded."""
        return self._place.part(t, 2, "space") if self.mesh is not None else t

    def shard(self, batch) -> Tuple[torch.Tensor, ...]:
        """This rank's part of a global batch, on the device: its rows, and
        for (x, y) grids (no batch prep) its z slab. Without a mesh, the
        batch on the device."""
        if self.mesh is None:
            return self.to_device(batch)
        part = [self._rows(torch.as_tensor(b)) for b in batch]
        if self.batch_prep is None:
            part = [self._slab(t) if t.ndim >= 5 else t for t in part]
        return tuple(t.to(self.device) for t in part)

    def _replicate(self) -> None:
        """Under a mesh, the one-time broadcast of the parameters, the
        buffers and the optimizer's state from the first rank at fit start."""
        if self.mesh is None:
            return
        from scenenet_tpu_torch.parallel.mesh import ensure_replicated

        tensors = list(self.model.parameters()) + list(self.model.buffers())
        if self._tp is None:
            tensors += [v for st in self.optimizer.state.values() for v in st.values()
                        if torch.is_tensor(v)]
        with torch.no_grad():
            ensure_replicated(tensors, self.mesh)
        if self._tp is not None:
            # the shards are cut from the replicated full model; the optimizer's
            # state is the rank's own (fresh, or loaded from the same snapshot)
            from scenenet_tpu_torch.parallel.gspmd import shard_from

            shard_from(self._tp, self.model)

    def sync_model(self) -> nn.Module:
        """Under channel tensor parallelism, write the ranks' shards, gathered
        over ``model``, into ``self.model`` (a collective: every rank calls
        it); a no-op otherwise. Returns the model."""
        if self._tp is not None:
            from scenenet_tpu_torch.parallel.gspmd import gather_into

            gather_into(self._tp, self.model)
        return self.model

    def full_gradients(self) -> Dict[str, torch.Tensor]:
        """The last step's gradients by the model's parameter names, whole:
        under channel tensor parallelism gathered over ``model`` (a
        collective)."""
        grads = {n: p.grad for n, p in self.net.named_parameters() if p.grad is not None}
        if self._tp is None:
            return grads
        from scenenet_tpu_torch.parallel.mesh import _gather

        return {n: _gather(g, "model", 0, self.mesh) if n in self._tp.split_names else g
                for n, g in grads.items()}

    def _triggered(self, guard: PreemptionGuard) -> bool:
        """A SIGTERM on any rank: the ranks stop at the same boundary."""
        if self.mesh is None:
            return guard.triggered
        from scenenet_tpu_torch.parallel.mesh import any_rank

        return any_rank(guard.triggered, self.mesh)

    def _barrier(self) -> None:
        if self.mesh is not None:
            from scenenet_tpu_torch.parallel.mesh import barrier

            barrier(self.mesh)

    def _reduce_step(self, loss: torch.Tensor) -> torch.Tensor:
        """After the backward, under a mesh: the gradients averaged over the
        mesh's axes (one all-reduce) and the loss averaged (an identity for a
        distributed criterion, which is global already)."""
        if self.mesh is None:
            return loss
        self._reduce_grads()
        return self._reduce_loss(loss)

    def _reduce_grads(self) -> None:
        """The gradients of the rank's step made global in place: averaged
        over the mesh's axes (data parallelism, channel TP over ``data``
        only), or summed over the ensemble's members and averaged over
        ``data``."""
        if self._mode == "ep":
            from scenenet_tpu_torch.parallel.ep import reduce_ensemble_gradients

            reduce_ensemble_gradients(self.model, self.mesh)
            return
        from scenenet_tpu_torch.parallel.dp import reduce_gradients

        reduce_gradients(self.net.parameters(), self._axes, self.mesh)

    def _count(self, mstate: MetricState, pred: torch.Tensor, y: torch.Tensor,
               axes: Optional[Tuple[str, ...]] = None) -> MetricState:
        """The batch's confusion counts added, summed over the mesh's axes."""
        axes = self._axes if axes is None else axes
        if not axes:
            return update_metrics(mstate, pred, y, self.config.tau)
        from scenenet_tpu_torch.parallel.dp import psum_confusion_delta

        return psum_confusion_delta(mstate, pred, y, self.config.tau, axes, self.mesh)

    # ---- steps ---------------------------------------------------------------

    def to_device(self, batch) -> Tuple[torch.Tensor, ...]:
        return tuple(torch.as_tensor(b).to(self.device) for b in batch)

    def _forward(self, x: torch.Tensor):
        """The model's prediction in f32 (each output of a model that returns
        a sequence: deep supervision's); under ``precision: bf16`` taken
        from bf16 copies of the floating parameters and a bf16 x (the
        buffers, BatchNorm's running statistics, stay the model's own f32
        tensors)."""
        net = self._spatial if self._spatial is not None else self.net
        with span("snt/train/forward"):
            if self.config.precision == "bf16":
                half = cast_half(dict(net.named_parameters()))
                out = functional_call(net, half, (x.to(torch.bfloat16),))
            else:
                out = net(x)
            if isinstance(out, (list, tuple)):
                return [o.float() for o in out]
            return out.float()

    def _loss(self, x: torch.Tensor, y: torch.Tensor, axes: Optional[Tuple[str, ...]] = None):
        """The loss of the batch (x, y) and the prediction; under a mesh by
        the criterion made distributed over ``axes`` (default the mesh's).
        A model that returns a sequence of outputs (highest resolution
        first) gives the criterion all of them, and the first is the
        prediction returned: the one counted, validated and predicted."""
        if self._mode == "ep":
            # the rank's members and its part of the loss; the weights'
            # normalisation over the axes' data part
            from scenenet_tpu_torch.parallel.ep import local_quantile_loss

            axes = self._axes if axes is None else axes
            return local_quantile_loss(self.criterion, self.model, x, y, self._members,
                                       tuple(a for a in axes if a == "data"),
                                       half=self.config.precision == "bf16")
        pred = self._forward(x)
        m = self.model
        cvx = m.cvx_coefficients() if hasattr(m, "cvx_coefficients") else {}
        geneo = m.geneo_params_flat() if hasattr(m, "geneo_params_flat") else {}
        with span("snt/train/loss"):
            loss = self.distributed_criterion(axes)(pred, y, cvx, geneo,
                                                    getattr(m, "last_lambda", None))
        return loss, pred[0] if isinstance(pred, list) else pred

    def distributed_criterion(self, axes: Optional[Tuple[str, ...]] = None) -> Callable:
        """The criterion made distributed over ``axes`` (default the mesh's;
        ``()`` the criterion itself), made once."""
        axes = self._axes if axes is None else axes
        if not axes:
            return self.criterion
        made = self._criteria.get(axes)
        if made is None or made[0] is not self.criterion:
            from scenenet_tpu_torch.parallel.dp import make_distributed

            made = self._criteria[axes] = (self.criterion,
                                           make_distributed(self.criterion, axes))
        return made[1]

    def setup_optimizer(self, capturable: bool = False) -> torch.optim.Optimizer:
        """A fresh optimizer over the model's trainable parameters;
        ``capturable`` keeps its step counts on the device, so that a CUDA
        graph can hold its update. Its first call in a process imports
        ``torch._dynamo`` (``torch.optim`` does on its first optimizer)."""
        with phase("snt/train/setup_optimizer"):
            self.optimizer = resolve_optimizer(self.config.optimizer, self.net.parameters(),
                                               self.config.learning_rate,
                                               capturable=capturable)
        if self._tp is not None and isinstance(self.optimizer, LBFGS):
            # the linesearch's inner products over the whole vector: the split
            # leaves' parts summed over 'model', the replicated ones once
            from scenenet_tpu_torch.parallel.gspmd import global_dot

            self.optimizer.dot = global_dot(self._tp, self.optimizer.plist)
        k = self.config.accumulate_grad_batches
        self.multi_steps = MultiSteps(self.optimizer, k) if k > 1 else None
        return self.optimizer

    def _closure(self, x: torch.Tensor, y: torch.Tensor):
        """L-BFGS's objective on the batch (x, y): the loss at the
        parameters as they stand, its gradients in ``.grad``. The model's
        buffers (BatchNorm's running statistics) are put back after each
        evaluation, as the JAX package's ``value_fn`` drops the model state
        it computes."""
        saved = [b.detach().clone() for b in self.net.buffers()]

        def closure() -> torch.Tensor:
            self.optimizer.zero_grad(set_to_none=True)
            loss, _ = self._loss(x, y)
            loss.backward()
            with torch.no_grad():
                for b, v in zip(self.net.buffers(), saved):
                    b.copy_(v)
            return loss.detach()

        if self.mesh is None:
            return closure
        # every rank's linesearch must see the global value and slope
        from scenenet_tpu_torch.parallel.dp import linesearch_value_fn

        return linesearch_value_fn(closure, self.net.parameters(), self._axes, self.mesh,
                                   reduce_loss=self._reduce_loss,
                                   reduce_grads=self._reduce_grads)

    def _reduce_loss(self, loss: torch.Tensor,
                      axes: Optional[Tuple[str, ...]] = None) -> torch.Tensor:
        """The rank's loss made global over ``axes`` (default the mesh's):
        averaged, or for the ensemble summed over its members first."""
        from scenenet_tpu_torch.parallel.mesh import pmean, psum

        axes = self._axes if axes is None else axes
        if self._mode == "ep":
            loss = psum(loss, "model", self.mesh)
            axes = tuple(a for a in axes if a != "model")
        return pmean(loss, axes, self.mesh)

    def _update(self, apply: bool, x: Optional[torch.Tensor] = None,
                y: Optional[torch.Tensor] = None, loss: Optional[torch.Tensor] = None) -> None:
        """The optimizer's part of a step, after the backward: the update,
        or under accumulation the running mean and the update where
        ``apply`` says so. L-BFGS also takes the step's batch (x, y) and
        its loss."""
        lbfgs = isinstance(self.optimizer, LBFGS)
        if self.multi_steps is None:
            if lbfgs:
                self.optimizer.step(self._closure(x, y), loss)
            else:
                self.optimizer.step()
        elif lbfgs and apply:
            self.multi_steps.step(apply, self._closure(x, y), loss)
        else:
            self.multi_steps.step(apply)

    def train_state(self) -> Dict[str, torch.Tensor]:
        """The whole training state as flat name → tensor, for a snapshot:
        every parameter and buffer, the optimizer's state (made as a first
        step would make it where no step has run), the accumulation's, and
        the step."""
        self.sync_model()
        out = {f"params/{n}": p for n, p in self.model.named_parameters()}
        out.update((f"buffers/{n}", b) for n, b in self.model.named_buffers())
        opt = optimizer_state(self.optimizer)
        if self._tp is not None:
            # the rank's moments gathered into the full tree (collectives)
            from scenenet_tpu_torch.parallel.gspmd import gather_optimizer_state

            opt = gather_optimizer_state(self._tp, self.optimizer, opt)
        out.update((f"optimizer/{k}", v) for k, v in opt.items())
        if self.multi_steps is not None:
            out.update((f"multi_steps/{k}", v)
                       for k, v in self.multi_steps.state_tensors().items())
        out["step"] = torch.tensor(self.step, dtype=torch.int64)
        return out

    @torch.no_grad()
    def load_train_state(self, state: Dict[str, torch.Tensor]) -> None:
        """Load :meth:`train_state`'s ``state``: copied into the tensors the
        model and the optimizer hold, never rebinding them (a captured CUDA
        graph reads them); an optimizer that has taken no step gets its
        state through ``load_state_dict``."""
        for n, p in self.model.named_parameters():
            p.copy_(state[f"params/{n}"])
        for n, b in self.model.named_buffers():
            b.copy_(state[f"buffers/{n}"])
        opt = {k[len("optimizer/"):]: v for k, v in state.items() if k.startswith("optimizer/")}
        if self._tp is not None:
            from scenenet_tpu_torch.parallel.gspmd import shard_from, shard_optimizer_state

            shard_from(self._tp, self.model)
            opt = shard_optimizer_state(self._tp, self.optimizer, opt)
        load_optimizer_state(self.optimizer, opt)
        if self.multi_steps is not None:
            self.multi_steps.load_state_tensors(
                {k[len("multi_steps/"):]: v for k, v in state.items()
                 if k.startswith("multi_steps/")})
        self.step = int(state["step"])

    @_in_mesh
    def train_step(self, mstate: MetricState, *batch: torch.Tensor
                   ) -> Tuple[MetricState, torch.Tensor]:
        """One optimizer step on a batch already on the device: prep,
        forward, loss, backward, update, confusion counts (of the
        prediction before the update). Returns the counts and the loss.
        Under a mesh the batch is this rank's part (:meth:`shard`): a raw
        batch is prepared on the rank and, where Z is sharded, cut to its
        slab; the loss and the counts returned are the global ones."""
        with span("snt/train/step"):
            x, y = self.batch_prep(*batch) if self.batch_prep else batch
            if self.batch_prep is not None:
                x, y = self._slab(x), self._slab(y)
            self.net.train()
            self.optimizer.zero_grad(set_to_none=True)
            # debug_nans: a NaN made in the forward or the backward raises,
            # naming the operation that made it
            with torch.autograd.set_detect_anomaly(self.config.debug_nans):
                loss, pred = self._loss(x, y)
                if self.config.debug_nans and not bool(torch.isfinite(loss)):
                    raise FloatingPointError(f"debug_nans: loss {float(loss.detach())} at "
                                             f"step {self.step}")
                with span("snt/train/backward"):
                    loss.backward()
            loss = self._reduce_step(loss.detach())
            self._update(self.multi_steps is not None and self.multi_steps.advance(), x, y,
                         loss)
            self.step += 1
            return self._count(mstate, pred.detach(), y), loss

    @torch.no_grad()
    def eval_step(self, mstate: MetricState, *batch: torch.Tensor
                  ) -> Tuple[MetricState, torch.Tensor, torch.Tensor]:
        """Forward, loss and confusion counts of a batch on the device, on
        this process alone (a mesh's evaluation is :meth:`sharded_eval_step`)."""
        x, y = self.batch_prep(*batch) if self.batch_prep else batch
        self.model.eval()
        loss, pred = self._loss(x, y, ())
        return update_metrics(mstate, pred, y, self.config.tau), loss, pred

    @torch.no_grad()
    @_in_mesh
    def sharded_eval_step(self, mstate: MetricState, *batch
                          ) -> Tuple[MetricState, torch.Tensor, torch.Tensor]:
        """:meth:`eval_step` of a global batch over the mesh: split by rows
        where the data axis divides it, else replicated over ``data`` (a
        ragged tail: every rank takes every row, on its z slab) with the
        loss and counts reduced over ``space`` alone, so that no sample is
        counted twice. Returns the global counts and loss and the rank's
        part of the prediction. Without a mesh, :meth:`eval_step`."""
        if self.mesh is None:
            return self.eval_step(mstate, *self.to_device(batch))
        divisible = int(torch.as_tensor(batch[0]).shape[0]) % self.mesh.shape["data"] == 0
        axes = self._axes if divisible else tuple(a for a in self._axes if a != "data")
        part = [torch.as_tensor(b) for b in batch]
        if divisible:
            part = [self._rows(t) for t in part]
        part = [t.to(self.device) for t in part]
        x, y = self.batch_prep(*part) if self.batch_prep else part[:2]
        return self.local_eval_step(mstate, self._slab(x), self._slab(y), axes)

    @torch.no_grad()
    @_in_mesh
    def local_eval_step(self, mstate: MetricState, x: torch.Tensor, y: torch.Tensor,
                        axes: Tuple[str, ...]) -> Tuple[MetricState, torch.Tensor, torch.Tensor]:
        """The eval step of this rank's part (x, y) of a batch split over
        ``axes`` (the mesh's less ``data`` for a batch replicated over it):
        the global counts and loss and the rank's prediction."""
        self.net.eval()
        loss, pred = self._loss(x, y, axes)
        return self._count(mstate, pred, y, axes), self._reduce_loss(loss, axes), pred

    def _grad_stats(self) -> Dict[str, float]:
        """The gradient snapshot of the last step: a frozen parameter's
        gradient is logged as 0."""
        flat = {}
        grads = self.full_gradients()
        for name, p in self.model.named_parameters():
            key = name.replace(".", "/")
            g = grads.get(name)
            g = g if g is not None else torch.zeros_like(p)
            if g.ndim == 0:
                flat[f"grad/{key}"] = float(g)
            else:
                flat[f"gradnorm/{key}"] = float(torch.linalg.norm(g))
                flat[f"gradmean/{key}"] = float(g.mean())
                flat[f"gradstd/{key}"] = float(g.std(unbiased=False))
        return flat

    def _scores(self, loader: Iterable, prefix: str,
                cloud_epoch: Optional[int] = None) -> Dict[str, float]:
        """The loader's scores under ``prefix``; with ``cloud_epoch``, the
        first batch's first sample is also written as PLYs."""
        mstate = init_metric_state(self.device)
        losses = []
        for batch in loader:
            mstate, loss, pred = self.sharded_eval_step(mstate, *batch)
            losses.append(loss)
            if cloud_epoch is not None and self._writes and self._space == 1:
                # the first rank's rows start with the batch's first sample
                self._export_pointclouds(self.to_device(batch), pred, cloud_epoch)
                cloud_epoch = None
        scores = {f"{prefix}_{k}": v for k, v in
                  compute_metrics(mstate, self.config.fbeta).items()}
        if losses:
            scores[f"{prefix}_loss"] = float(torch.stack(losses).mean())
        return scores

    def _export_pointclouds(self, batch: Tuple[torch.Tensor, ...], pred: torch.Tensor,
                            epoch: int) -> None:
        """``epoch{e}_{input,gt,pred}.ply`` of the batch's first sample under
        ``run_dir/pointclouds``, colored by ranges (the reference logs
        ``wandb.Object3D`` of a validation sample every 10 epochs,
        ``lit_model_wrappers.py:222-233``)."""
        from scenenet_tpu_torch.utils.viz import voxelgrid_to_points, write_ply

        x, y = self.batch_prep(*batch) if self.batch_prep else batch[:2]
        out_dir = os.path.join(self.config.run_dir, "pointclouds")
        os.makedirs(out_dir, exist_ok=True)
        for name, grid in (("input", x), ("gt", y), ("pred", pred)):
            pts = voxelgrid_to_points(grid[0, 0].float().cpu().numpy(), "ranges")
            write_ply(os.path.join(out_dir, f"epoch{epoch}_{name}.ply"), pts)

    # ---- fit / evaluate ------------------------------------------------------

    @_in_mesh
    def fit(self, train_loader: Iterable, val_loader: Optional[Iterable] = None,
            resume_from: Optional[str] = None) -> Tuple[nn.Module, Dict[str, float]]:
        """Per-batch training loop over a host-fed loader; trains
        ``self.model`` in place from a fresh optimizer state. Returns the
        model and the best value seen of every score.

        A SIGTERM latched during a step flushes a snapshot at the batch
        boundary (the training state, the epoch's counts and loss sum, the
        (epoch, batch) cursor) and returns with ``self.preempted``;
        ``checkpoint_every_n_steps`` also snapshots every N batches.
        ``resume_from`` restores one and skips the batches of the resumed
        epoch it had taken: exact where the loader gives the epoch's
        batches in the same order again (a list, an unshuffled loader). A
        fit that completes deletes the snapshot.

        Under a mesh every rank iterates the same loader (seeded alike) and
        takes its part of each batch (:meth:`shard`).
        """
        cfg = self.config
        self.setup_optimizer()
        self._ckpt = ckpt = CheckpointManager(cfg.checkpoint_dir, _monitor_modes(),
                                              top_k=cfg.checkpoint_top_k, write=self._writes)
        stopper = (EarlyStopping(cfg.early_stop_metric, cfg.early_stop_patience)
                   if cfg.early_stop_metric else None)
        snap_path = os.path.join(cfg.checkpoint_dir, SNAPSHOT_NAME)
        epoch, skip_batches = 0, 0
        mstate, loss_count = init_metric_state(self.device), 0
        loss_sum = torch.zeros((), device=self.device)
        if resume_from is not None:
            restored = load_train_snapshot_if_compatible(resume_from, self.train_state(), {},
                                                         kind="batch")
            if restored is not None:
                state, mstate, loss_sum, _, cursor = restored
                self.load_train_state(state)
                mstate = MetricState(*(v.to(self.device) for v in mstate))
                loss_sum = loss_sum.to(self.device)
                epoch, skip_batches = int(cursor["epoch"]), int(cursor["next_batch"])
                loss_count = int(cursor["loss_count"])
        self._replicate()
        self.preempted = False
        with PreemptionGuard() as guard:
            while cfg.max_epochs < 0 or epoch < cfg.max_epochs:
                # epoch 0 under torch.profiler where profile_dir is set, its trace
                # written there when the epoch ends
                tracer = contextlib.ExitStack()
                if cfg.profile_dir and epoch == 0:
                    tracer.enter_context(trace(cfg.profile_dir, "epoch0_trace.json"))
                t0 = time.time()
                if not skip_batches:
                    mstate, loss_count = init_metric_state(self.device), 0
                    loss_sum = torch.zeros((), device=self.device)
                since_snap = 0  # a host count: reading the device's step would sync
                grad_logged = False
                for bi, batch in enumerate(train_loader):
                    if bi < skip_batches:
                        continue  # fast-forward the resumed epoch
                    mstate, loss = self.train_step(mstate, *self.shard(batch))
                    loss_sum = loss_sum + loss
                    loss_count += 1
                    since_snap += 1
                    snap_due = (cfg.checkpoint_every_n_steps > 0
                                and since_snap >= cfg.checkpoint_every_n_steps)
                    triggered = self._triggered(guard)
                    if triggered or snap_due:
                        state = self.train_state()  # every rank: TP gathers its shards
                        if self._writes:
                            save_train_snapshot(snap_path, state, mstate, loss_sum,
                                                {}, {"kind": "batch", "epoch": epoch,
                                                     "next_batch": bi + 1,
                                                     "loss_count": loss_count,
                                                     "step": self.step})
                        since_snap = 0
                        if triggered:
                            self.preempted = True
                            print(f"[preempt] SIGTERM: snapshot flushed to {snap_path} "
                                  f"(epoch {epoch}, batch {bi + 1})", flush=True)
                            tracer.close()
                            self._barrier()
                            return self.sync_model(), self.best.best
                    if cfg.log_gradients and not grad_logged and (self._writes
                                                                  or self._tp is not None):
                        # one gradient snapshot per epoch (TP: every rank gathers)
                        stats = self._grad_stats()
                        if self._writes:
                            self.logger.log_params(stats, self.step)
                        grad_logged = True
                skip_batches = 0

                self.train_counts.append(metric_counts(mstate))
                scores = {f"train_{k}": v for k, v in
                          compute_metrics(mstate, cfg.fbeta).items()}
                scores["train_loss"] = (float(loss_sum) / loss_count if loss_count
                                        else float("nan"))
                scores["epoch_time_s"] = time.time() - t0
                if val_loader is not None:
                    every = cfg.log_pointclouds_every
                    cloud = epoch if every > 0 and epoch % every == 0 else None
                    scores.update(self._scores(val_loader, "val", cloud_epoch=cloud))

                if hasattr(self.model, "parameters_in_dict"):
                    # the interpretable per-epoch parameter series
                    self.logger.log_params(self.model.parameters_in_dict(), epoch)
                self.logger.log_metrics(scores, epoch)
                self.best.update(scores)
                ckpt.step(self.sync_model(), scores, epoch)
                tracer.close()
                if stopper is not None and stopper.update(scores):
                    break
                epoch += 1
        # completed: a leftover snapshot (a periodic one, or the resumed one)
        # must not turn the next launch of the experiment into a resume
        if self._writes:
            discard_snapshot(snap_path)
        self._barrier()  # the first rank's checkpoints are written for every rank
        return self.sync_model(), self.best.best

    # ---- device-resident epochs ---------------------------------------------------

    @_in_mesh
    def fit_cached(self, cache, batch_size: int = 16, augment: bool = True,
                   generator: Optional[torch.Generator] = None,
                   val_loader: Optional[Iterable] = None,
                   resume_from: Optional[str] = None) -> Tuple[nn.Module, Dict[str, float]]:
        """Train from a :class:`~scenenet_tpu_torch.data.device_cache.DevicePointCache`.

        Every step gathers its rows of the epoch's permutation out of the
        resident points, applies the z-rotation and xy flips drawn for it
        (``augment``), voxelizes them by ``batch_prep`` and takes the
        optimizer step; on a card the step is one CUDA graph replay
        (:class:`CachedEpochs`). ``generator`` (on the cache's device)
        draws the permutations and augmentations; by default one seeded
        with ``max_epochs``, as the JAX package's key. Stateless models
        only; needs ``batch_prep``. Checkpoints, early stopping, the
        preemption snapshots and ``resume_from`` follow ``self.config`` as in
        :meth:`_run_cached_epochs`.
        """
        if self.batch_prep is None:
            raise ValueError("fit_cached needs a batch_prep (the voxelization of a batch)")
        self._check_cached("fit_cached", cache, batch_size)

        def draw(gen, n_batches):
            if not augment:
                return {}
            angles, flips = draw_point_augmentation(n_batches, batch_size, gen, cache.device)
            return {"angles": angles, "flips": flips}

        def load(rows, draws, cursor):
            # under a mesh the rank's rows and their draws: the prep (K3)
            # voxelizes the rank's own samples
            aug = ((self._rows(draws["angles"].index_select(0, cursor)[0]),
                    self._rows(draws["flips"].index_select(0, cursor)[0])) if augment else ())
            return self.batch_prep(*gather_augment(cache.points, cache.labels, cache.mask,
                                                   self._rows(rows), *aug))

        return self._run_cached_epochs(len(cache), batch_size, draw, load, generator,
                                       val_loader, resume_from)

    @_in_mesh
    def fit_grid_cached(self, grids, batch_size: int = 16, augment: bool = True,
                        generator: Optional[torch.Generator] = None,
                        val_loader: Optional[Iterable] = None,
                        resume_from: Optional[str] = None
                        ) -> Tuple[nn.Module, Dict[str, float]]:
        """Train from a :class:`~scenenet_tpu_torch.data.device_cache.DeviceGridCache`:
        voxelization was paid once at the cache's build, so a step gathers
        its rows, applies the D4 element drawn for each sample
        (``augment``, :func:`~scenenet_tpu_torch.data.device_cache.d4_transform_grids`),
        casts the grids to f32 and takes the optimizer step; on a card one
        CUDA graph replay. With ``augment=False`` and the same generator it
        trains as :meth:`fit_cached` does. Stateless models only.
        """
        self._check_cached("fit_grid_cached", grids, batch_size)

        def draw(gen, n_batches):
            return {"d4": draw_d4(n_batches, batch_size, gen, grids.device)} if augment else {}

        def load(rows, draws, cursor):
            rows = self._rows(rows)
            x, y = grids.x.index_select(0, rows), grids.y.index_select(0, rows)
            if augment:
                bits = self._rows(draws["d4"].index_select(0, cursor)[0], dim=1)
                x, y = d4_transform_grids(x, *bits), d4_transform_grids(y, *bits)
            return x.to(torch.float32), y.to(torch.float32)

        return self._run_cached_epochs(len(grids), batch_size, draw, load, generator,
                                       val_loader, resume_from)

    @torch.no_grad()
    @_in_mesh
    def evaluate_cached(self, grids, batch_size: int = 16,
                        prefix: str = "test") -> Dict[str, float]:
        """Scores of ``self.model`` over a
        :class:`~scenenet_tpu_torch.data.device_cache.DeviceGridCache` in
        order, the samples past the last full batch in one tail batch; the
        loss is the sample-weighted mean, so a ragged tail weighs by its
        samples. Under a mesh each batch goes through
        :meth:`sharded_eval_step` (the tail replicated where the data axis
        does not divide it)."""
        self._check_cached("evaluate_cached", grids, 1)
        cfg = self.config
        n = len(grids)
        self.net.eval()
        mstate = init_metric_state(self.device)
        weighted = torch.zeros((), dtype=torch.float64, device=self.device)
        for start in range(0, n, batch_size):
            x = grids.x[start:start + batch_size].to(torch.float32)
            y = grids.y[start:start + batch_size].to(torch.float32)
            if self.mesh is not None:
                mstate, loss, _ = self.sharded_eval_step(mstate, x, y)
            else:
                loss, pred = self._loss(x, y)
                mstate = update_metrics(mstate, pred, y, cfg.tau)
            weighted += loss.double() * x.shape[0]
        scores = {f"{prefix}_{k}": v for k, v in compute_metrics(mstate, cfg.fbeta).items()}
        scores[f"{prefix}_loss"] = float(weighted) / max(n, 1)
        self.logger.log_metrics(scores, -1)
        return scores

    def _check_cached(self, name: str, cache, batch_size: int) -> None:
        if self.mesh is not None and name != "evaluate_cached":
            self._check_mesh_supported(pure_dp=True, batch_size=batch_size)
        if getattr(self.model, "is_stateful", False):
            raise ValueError(f"{name} supports stateless models; a stateful model "
                             "(BatchNorm statistics) streams batches through fit()")
        if cache.device != self.device:
            raise ValueError(f"{name}: the cache is on {cache.device}, the model on "
                             f"{self.device}")
        if len(cache) < batch_size:
            raise ValueError(f"{name}: the cache holds {len(cache)} samples < batch "
                             f"{batch_size}")

    def _run_cached_epochs(self, n: int, batch_size: int, draw, load,
                           generator: Optional[torch.Generator],
                           val_loader: Optional[Iterable], resume_from: Optional[str]
                           ) -> Tuple[nn.Module, Dict[str, float]]:
        """The epoch loop the cached fits share: :class:`CachedEpochs` trains
        each epoch on the device in ``epoch_chunks`` chunks; counts, the
        loss, logging, checkpoints and early stopping come once an epoch,
        and the validation loader is streamed, as in the JAX package.

        A SIGTERM latched during a chunk flushes a snapshot at the chunk's
        end (the training state, the epoch's counts and loss sum, the
        generator's state and the epoch's permutation and draws, the
        (epoch, chunk) cursor) and returns with ``self.preempted``;
        ``checkpoint_every_n_steps`` also snapshots at chunk ends and at
        every epoch's end. ``resume_from`` continues from such a snapshot
        bit-identically. It is restored before the first warm-up step, so
        the warm-up steps are the steps at the restored cursor and the
        graph is captured reading the restored buffers. A snapshot of
        another chunk partition starts a fresh run; so does one of another
        structure, printing why.
        """
        cfg = self.config
        self.cached_epochs = epochs = CachedEpochs(self, n, batch_size, draw, load, generator)
        self._ckpt = ckpt = CheckpointManager(cfg.checkpoint_dir, _monitor_modes(),
                                              top_k=cfg.checkpoint_top_k, write=self._writes)
        stopper = (EarlyStopping(cfg.early_stop_metric, cfg.early_stop_patience)
                   if cfg.early_stop_metric else None)
        self.preempted = False
        chunks = epochs.chunks
        snap_path = os.path.join(cfg.checkpoint_dir, SNAPSHOT_NAME)
        epoch, start_chunk, mid_epoch = 0, 0, False
        if resume_from is not None:
            restored = load_train_snapshot_if_compatible(resume_from, self.train_state(),
                                                         epochs.keys(), kind="chunk")
            if restored is not None and int(restored[-1].get("n_chunks", len(chunks))) \
                    != len(chunks):
                # a next_chunk cursor names a batch only in its own partition
                print(f"[preempt] snapshot chunk partition ({restored[-1]['n_chunks']}) != "
                      f"current ({len(chunks)}); starting fresh")
                restored = None
            if restored is not None:
                state, mstate, loss_sum, keys, cursor = restored
                self.load_train_state(state)
                epochs.load(mstate, loss_sum, keys)
                epoch, start_chunk = int(cursor["epoch"]), int(cursor["next_chunk"])
                mid_epoch = start_chunk < len(chunks)
                if not mid_epoch:
                    epoch, start_chunk = epoch + 1, 0
        self._replicate()

        def flush(next_chunk: int) -> None:
            if not self._writes:
                return
            save_train_snapshot(snap_path, self.train_state(), epochs.mstate, epochs.loss_sum,
                                epochs.keys(), {"kind": "chunk", "epoch": epoch,
                                                "next_chunk": next_chunk,
                                                "n_chunks": len(chunks), "step": self.step})

        with PreemptionGuard() as guard:
            while cfg.max_epochs < 0 or epoch < cfg.max_epochs:
                t0 = time.time()
                if not mid_epoch:
                    epochs.begin_epoch()
                    start_chunk = 0
                mid_epoch = False
                last_snap_step = self.step
                for ci in range(start_chunk, len(chunks)):
                    epochs.run_chunk(ci)
                    boundary = ci + 1  # the resume position if the fit stops here
                    if self._triggered(guard):
                        flush(boundary)
                        self.preempted = True
                        self.logger.log_metrics({"preempted_at_step": self.step}, epoch)
                        print(f"[preempt] SIGTERM: snapshot flushed to {snap_path} (epoch "
                              f"{epoch}, chunk {boundary}/{len(chunks)})", flush=True)
                        self._barrier()
                        return self.model, self.best.best
                    if (cfg.checkpoint_every_n_steps > 0
                            and self.step - last_snap_step >= cfg.checkpoint_every_n_steps
                            and boundary < len(chunks)):
                        flush(boundary)
                        last_snap_step = self.step
                mstate, loss_sum = epochs.mstate, epochs.loss_sum
                self.train_counts.append(metric_counts(mstate))
                scores = {f"train_{k}": v for k, v in
                          compute_metrics(mstate, cfg.fbeta).items()}
                scores["train_loss"] = float(loss_sum) / epochs.n_batches
                scores["epoch_time_s"] = time.time() - t0
                if val_loader is not None:
                    scores.update(self._scores(val_loader, "val"))
                if hasattr(self.model, "parameters_in_dict"):
                    self.logger.log_params(self.model.parameters_in_dict(), epoch)
                self.logger.log_metrics(scores, epoch)
                self.best.update(scores)
                ckpt.step(self.model, scores, epoch)
                if cfg.checkpoint_every_n_steps > 0:
                    flush(len(chunks))  # the epoch's end: a resume starts the next epoch
                if stopper is not None and stopper.update(scores):
                    break
                epoch += 1
        # completed: the snapshot must not turn the next launch into a resume
        if self._writes:
            discard_snapshot(snap_path)
        self._barrier()
        return self.model, self.best.best

    @_in_mesh
    def evaluate(self, loader: Iterable, prefix: str = "test") -> Dict[str, float]:
        """Scores and mean loss of ``self.model`` over ``loader``."""
        scores = self._scores(loader, prefix)
        self.logger.log_metrics(scores, -1)
        return scores

    @torch.no_grad()
    def predict(self, loader: Iterable):
        """A generator of the model's predictions over ``loader`` as numpy
        arrays: each batch through ``batch_prep`` (where the trainer has one)
        and the eval-mode forward in f32, as the JAX package's ``predict``
        (under a mesh too: every rank forwards the whole batch)."""
        self.model.eval()
        for batch in loader:
            if self.batch_prep is not None:
                x, _ = self.batch_prep(*self.to_device(batch))
            else:
                x = batch[0] if isinstance(batch, (tuple, list)) else batch
                x = torch.as_tensor(x).to(self.device)
            yield self.model(x).cpu().numpy()

    def restore_best(self, metric: str, template: Optional[nn.Module] = None) -> nn.Module:
        """Load the best checkpoint for ``metric`` into ``template`` (default
        the trained model) and return it; where none was recorded (the
        metric absent or non-finite every epoch), load ``last.npz`` with a
        warning."""
        template = self.model if template is None else template
        if self._ckpt is None:
            raise FileNotFoundError("no fit has run: no checkpoint recorded")
        path = self._ckpt.best_path(metric)
        if path is None:
            last = self._ckpt.last_path()
            if last is None:
                raise FileNotFoundError(f"no checkpoint recorded for {metric}")
            warnings.warn(f"no checkpoint recorded for {metric!r} (metric absent or "
                          f"non-finite every epoch); restoring last.npz instead")
            path = last
        restored = restore_checkpoint(path, template)
        if template is self.model and self._tp is not None:
            from scenenet_tpu_torch.parallel.gspmd import shard_from

            shard_from(self._tp, self.model)
        return restored


def trains_by_replay(device: torch.device, optimizer, mesh: Optional[Any] = None) -> bool:
    """Whether a cached fit runs its step as a replayed CUDA graph: on a
    card, under any optimizer but L-BFGS (by name or instance), whose
    linesearch reads its values on the host, and, over a mesh of several
    ranks, under NCCL alone (its all-reduce may sit inside the graph; a gloo
    collective goes through the host and cannot be captured). The streamed
    fit always steps eagerly. ``model_backend: autotune`` times its
    candidates by this rule."""
    if mesh is not None and mesh.size > 1 and mesh.backend != "nccl":
        return False
    return torch.device(device).type == "cuda" and not optimizer_needs_value_fn(optimizer)


class CachedEpochs:
    """The device-resident epochs of one cached fit.

    Each epoch (:meth:`begin_epoch`) draws one permutation of the ``n``
    samples and, by ``draw(generator, n_batches)``, the augmentation of
    every batch into static device buffers; :meth:`run_chunk` runs one
    chunk of the epoch's ``n // batch_size`` steps (``config.epoch_chunks``
    chunks, :func:`chunk_starts`). A step reads the cursor's rows of the
    permutation, ``load(rows, draws, cursor)`` makes the batch's (x, y)
    grids, and the forward, the loss, the backward, the optimizer update
    and the confusion counts follow, all on the device, with no RNG call
    and no host sync. On a card the step runs under :class:`StepGraph`
    (warm-up steps, then one CUDA graph replayed a batch) with a
    capturable optimizer; on the CPU, eagerly. Under gradient accumulation
    there are two steps, each under its own :class:`StepGraph`: one that
    accumulates and one that accumulates and updates; the host's count of
    calls picks the one a batch runs (a captured graph cannot branch on a
    device value). L-BFGS's step reads its linesearch's values on the
    host, so under it the step runs eagerly on the card too. ``generator``
    defaults to one seeded with ``max_epochs``.

    :meth:`keys` and :meth:`load` give and take what a snapshot keeps of
    the epochs (the generator's state, the epoch's permutation and draws);
    :meth:`load` copies into the static buffers, which a captured graph
    reads.
    """

    def __init__(self, trainer: Trainer, n: int, batch_size: int, draw, load,
                 generator: Optional[torch.Generator] = None):
        cfg = trainer.config
        dev = trainer.device
        on_card = dev.type == "cuda"
        self.trainer = trainer
        self.n, self.batch_size = n, batch_size
        self.n_batches = n // batch_size
        self.chunks = chunk_starts(self.n_batches, cfg.epoch_chunks)
        self.draw = draw
        self.generator = (generator if generator is not None
                          else torch.Generator(dev).manual_seed(cfg.max_epochs))
        trainer.setup_optimizer(capturable=on_card)
        eager = not trains_by_replay(dev, trainer.optimizer, trainer.mesh)
        if optimizer_needs_value_fn(trainer.optimizer):
            print("[lbfgs] the linesearch reads its values on the host: the cached steps "
                  "run eagerly, no CUDA graph", flush=True)

        # the static buffers the step reads and writes; the draws' shapes from
        # a throwaway generator, so that the fit's own draws nothing yet
        self.order = order = torch.zeros(n, dtype=torch.int64, device=dev)
        self.draws: Dict[str, torch.Tensor] = {
            k: torch.zeros_like(v) for k, v in
            draw(torch.Generator(dev).manual_seed(0), self.n_batches).items()}
        self.cursor = cursor = torch.zeros(1, dtype=torch.int64, device=dev)
        offsets = torch.arange(batch_size, device=dev)
        self.mstate = mstate = init_metric_state(dev)
        self.loss_sum = loss_sum = torch.zeros((), device=dev)
        self.last_loss = last_loss = torch.zeros((), device=dev)
        draws = self.draws

        def step(apply: bool = True):
            rows = order.index_select(0, cursor * batch_size + offsets)
            x, y = load(rows, draws, cursor)
            trainer.net.train()
            trainer.optimizer.zero_grad(set_to_none=True)
            # debug_nans: anomaly checks read values on the host, which a
            # capture cannot hold; run_chunk checks the loss after each step
            anomaly = cfg.debug_nans and not (on_card
                                              and torch.cuda.is_current_stream_capturing())
            with torch.autograd.set_detect_anomaly(anomaly):
                loss, pred = trainer._loss(x, y)
                loss.backward()
            loss = trainer._reduce_step(loss.detach())
            trainer._update(apply, x, y, loss)
            for buf, v in zip(mstate, trainer._count(mstate, pred.detach(), y)):
                buf.copy_(v)
            loss_sum.add_(loss)
            last_loss.copy_(loss)
            cursor.add_(1)

        self.runner = StepGraph(step, dev, eager=eager)
        # under accumulation: the step that only accumulates (runner is the
        # one that updates)
        self.accumulate_runner = (StepGraph(lambda: step(False), dev, eager=eager)
                                  if trainer.multi_steps is not None else None)

    def keys(self) -> Dict[str, torch.Tensor]:
        """What a snapshot keeps of the epochs, in place of the JAX
        package's PRNG keys: the generator's state after the epoch's
        draws, and the epoch's permutation and draws."""
        out = {"generator": self.generator.get_state(), "order": self.order}
        out.update((f"draws/{k}", v) for k, v in self.draws.items())
        return out

    @torch.no_grad()
    def load(self, mstate: MetricState, loss_sum: torch.Tensor,
             keys: Dict[str, torch.Tensor]) -> None:
        """Restore a snapshot's epoch position into the static buffers."""
        self.generator.set_state(keys["generator"])
        self.order.copy_(keys["order"])
        for k, v in self.draws.items():
            v.copy_(keys[f"draws/{k}"])
        for buf, v in zip(self.mstate, mstate):
            buf.copy_(v)
        self.loss_sum.copy_(loss_sum)

    def begin_epoch(self) -> None:
        """Draw the epoch's permutation and augmentation, zero its counts."""
        dev = self.trainer.device
        self.order.copy_(torch.randperm(self.n, generator=self.generator, device=dev))
        for k, v in self.draw(self.generator, self.n_batches).items():
            self.draws[k].copy_(v)
        for buf in self.mstate:
            buf.zero_()
        self.loss_sum.zero_()

    def run_chunk(self, index: int) -> None:
        """The steps of chunk ``index`` of the epoch."""
        trainer = self.trainer
        start, length = self.chunks[index]
        with span("snt/train/chunk"):
            self.cursor.fill_(start)
            for _ in range(length):
                with span("snt/train/step"):
                    ms = trainer.multi_steps
                    if ms is None or ms.advance():
                        self.runner()
                    else:
                        self.accumulate_runner()
                    trainer.step += 1
                    if trainer.config.debug_nans and not bool(torch.isfinite(self.last_loss)):
                        raise FloatingPointError(f"debug_nans: loss {float(self.last_loss)} "
                                                 f"at step {trainer.step - 1}")

    def replay_launches(self) -> Dict[str, int]:
        """What this fit's graph replays ran beyond the wrappers' counts, by
        kernel (:meth:`StepGraph.replay_launches`)."""
        out = dict.fromkeys(launch_counts(), 0)
        for runner in (self.runner, self.accumulate_runner):
            if runner is not None:
                for k, v in runner.replay_launches().items():
                    out[k] += v
        return out

    def kernel_launches(self) -> Dict[str, int]:
        """The kernels' launches that ran, by kernel: the wrappers' own
        counts, which are process-wide (every launch since their last
        reset, this fit's eager warm-ups and captures among them), plus
        what this fit's replays ran."""
        counts = launch_counts()
        return {k: v + counts[k] for k, v in self.replay_launches().items()}

    def run_epoch(self) -> Tuple[MetricState, torch.Tensor]:
        """One epoch of training: the epoch's confusion counts and loss sum
        (device tensors, overwritten by the next epoch)."""
        self.begin_epoch()
        for index in range(len(self.chunks)):
            self.run_chunk(index)
        return self.mstate, self.loss_sum
