"""Mesh-parallel training and inference: data parallelism over ``data`` and
the z-sharded SceneNet over ``space``.

Counterpart of :mod:`scenenet_tpu.parallel.dp`, the scale-out of the
reference's implicit Lightning DDP. Every rank holds the whole model and
the same optimizer state, and a step is:

- the rank's rows of the batch (and, with a space axis, its z slab of
  them), made by the batch prep on the rank's own samples on a pure-DP
  mesh, so that the voxelization (K3) scales with the data axis;
- the forward: the plain model on a pure-DP mesh (any stateless model,
  and the UNet with sync BatchNorm), the halo-exchange forward
  (:func:`~scenenet_tpu_torch.parallel.spatial.spatial_scenenet_forward`)
  where Z is sharded;
- the loss by the criterion made distributed (:func:`make_distributed`):
  its global sums are summed over the ranks, differentiably;
- the backward, then the gradients averaged over every axis (the all-reduce
  DDP makes), so every rank takes the same update; the loss averaged too;
- the confusion counts of the rank's part, summed over the ranks (int64,
  exact).

The step itself is :class:`~scenenet_tpu_torch.train.loop.Trainer`'s,
built with a mesh: :func:`make_local_train_step` and
:func:`make_sharded_train_step` hand it out, so that the DDP arithmetic has
one implementation for the streamed fit, the cached fits and these
functions, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable, Optional, Tuple

import torch
from torch import nn

from scenenet_tpu_torch.parallel.mesh import (
    Mesh, Placement, all_reduce_mean_, pmean, psum,
)
from scenenet_tpu_torch.parallel.spatial import spatial_scenenet_forward
from scenenet_tpu_torch.train.metrics import (
    MetricState, merge_metric_states, update_metrics,
)
from scenenet_tpu_torch.train.state import cast_half

__all__ = ["cast_half", "linesearch_value_fn", "psum_confusion_delta", "make_distributed",
           "shard_batch", "make_dp_inference_fn", "make_sharded_eval_step",
           "make_local_train_step", "make_sharded_train_step", "reduce_gradients",
           "mesh_axes"]


def mesh_axes(mesh: Mesh, batch_axis: str = "data", space_axis: str = "space"
              ) -> Tuple[str, ...]:
    """The axes a step reduces over: the batch axis, and the space axis
    where the mesh has one."""
    return (batch_axis, space_axis) if space_axis in mesh.shape else (batch_axis,)


def reduce_gradients(params: Iterable[torch.Tensor], axes: Tuple[str, ...],
                     mesh: Optional[Mesh] = None) -> None:
    """Average the gradients of ``params`` over ``axes`` in place, in one
    all-reduce (the ``pmean`` of the JAX step). A parameter the backward did
    not reach has none on every rank alike, and stays without one."""
    all_reduce_mean_([p.grad for p in params if p.grad is not None], axes, mesh)


def linesearch_value_fn(closure: Callable[[], torch.Tensor], params: Iterable[torch.Tensor],
                        axes: Tuple[str, ...], mesh: Optional[Mesh] = None,
                        reduce_loss: Optional[Callable] = None,
                        reduce_grads: Optional[Callable[[], None]] = None
                        ) -> Callable[[], torch.Tensor]:
    """The objective a linesearch optimizer (L-BFGS) re-evaluates, made
    global: ``closure`` computes the rank's loss and its gradients in
    ``.grad``; the returned closure averages both over ``axes`` (the value
    by ``reduce_loss``, default the mean). Every rank then sees the same
    value and slope, takes the same linesearch decisions and makes the same
    number of evaluations; with the rank's own slope they would differ and
    the collectives of the trials would deadlock (the JAX package measured
    it: a rendezvous timeout). ``reduce_grads`` replaces the gradients'
    mean where a mesh assembles them otherwise (the ensemble's sum over its
    members)."""
    params = list(params)
    if reduce_loss is None:
        def reduce_loss(v):
            return pmean(v, axes, mesh)

    def value_fn() -> torch.Tensor:
        value = closure()
        if reduce_grads is not None:
            reduce_grads()
        else:
            reduce_gradients(params, axes, mesh)
        return reduce_loss(value.detach())

    return value_fn


def psum_confusion_delta(mstate: MetricState, pred: torch.Tensor, y: torch.Tensor,
                         tau: float, axes: Tuple[str, ...],
                         mesh: Optional[Mesh] = None) -> MetricState:
    """Add this batch's confusion counts, summed over ``axes``, to the
    carried (already global) counts. The counts are int64: exact."""
    zero = MetricState(*(torch.zeros_like(v) for v in mstate))
    delta = update_metrics(zero, pred, y, tau)
    if axes:
        stacked = psum(torch.stack(list(delta)), axes, mesh)
        delta = MetricState(*stacked.unbind(0))
    return merge_metric_states(mstate, delta)


def make_distributed(criterion: Any, axes: Tuple[str, ...]) -> Any:
    """``criterion`` (a frozen dataclass) with ``axis_names`` set on it and
    on every nested criterion, so that its global sums and means run over
    the mesh axes ``axes``."""
    if not dataclasses.is_dataclass(criterion) or isinstance(criterion, type):
        return criterion
    changes = {}
    for f in dataclasses.fields(criterion):
        val = getattr(criterion, f.name)
        if f.name == "axis_names":
            changes[f.name] = tuple(axes)
        elif dataclasses.is_dataclass(val) and not isinstance(val, type):
            changes[f.name] = make_distributed(val, axes)
    return dataclasses.replace(criterion, **changes) if changes else criterion


def shard_batch(batch: Iterable, mesh: Mesh, batch_axis: str = "data",
                space_axis: Optional[str] = None) -> Tuple[torch.Tensor, ...]:
    """This rank's part of a (x, y) voxel batch, on its device: its rows,
    and its z slab where ``space_axis`` is given. The rows are cut before
    the copy, so a rank moves only its own part."""
    place = Placement(mesh, batch_axis, space_axis)
    return tuple(place(torch.as_tensor(b)).to(mesh.device) for b in batch)


class SpatialForward(nn.Module):
    """SceneNet's halo-exchange forward as a module around the model (its
    parameters are the model's, under ``net.``), so that it runs under
    ``torch.func.functional_call`` with bf16 copies of them."""

    def __init__(self, net: nn.Module, mesh: Mesh, space_axis: str = "space",
                 overlap: bool = False, inference: "bool | str" = False):
        super().__init__()
        self.net = net
        self.mesh, self.space_axis = mesh, space_axis
        self.overlap, self.inference = overlap, inference

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return spatial_scenenet_forward(self.net, x, self.space_axis, inference=self.inference,
                                        overlap=self.overlap, mesh=self.mesh)


def make_dp_inference_fn(model: nn.Module, mesh: Mesh, space_axis: Optional[str] = None,
                         inference: "bool | str" = False, overlap: bool = False) -> Callable:
    """``run(x)``: the forward of this rank's part of a global batch, rows
    over ``data`` and, with ``space_axis``, the z slab over it (the
    halo-exchange forward). On a pure-DP mesh ``inference="mxu"`` runs the
    tensor-core stencil (K5) on every rank; with a space axis any true
    ``inference`` takes the forward-only halo form of the f32 stencil.
    ``run.forward`` takes an input already cut to the rank's part;
    ``run.placement`` cuts it."""
    placement = Placement(mesh, "data", space_axis)
    if space_axis is None:
        import inspect

        takes_inference = "inference" in inspect.signature(model.forward).parameters

        @torch.no_grad()
        def forward(x):
            return model(x, inference=inference) if takes_inference else model(x)
    else:
        spatial = SpatialForward(model, mesh, space_axis, overlap, inference)

        @torch.no_grad()
        def forward(x):
            return spatial(x)

    def run(x):
        return forward(placement(torch.as_tensor(x)).to(mesh.device))

    run.forward = forward
    run.placement = placement
    return run


def _trainer(model, criterion, mesh, tau, batch_prep, overlap, precision, optimizer=None,
             batch_axis="data", space_axis="space"):
    from scenenet_tpu_torch.train.loop import TrainConfig, Trainer
    from scenenet_tpu_torch.utils.logging import NullLogger

    if (batch_axis, space_axis) != ("data", "space"):
        raise ValueError("the port's mesh steps take the axes 'data' and 'space', got "
                         f"{(batch_axis, space_axis)}")
    trainer = Trainer(model, criterion, TrainConfig(tau=tau, precision=precision,
                                                    early_stop_metric=None),
                      logger=NullLogger(), batch_prep=batch_prep, mesh=mesh, overlap=overlap)
    trainer.optimizer = optimizer
    return trainer


def make_sharded_eval_step(model: nn.Module, criterion, mesh: Mesh, tau: float = 0.65,
                           batch_axis: str = "data", space_axis: str = "space",
                           batch_prep: Optional[Callable] = None, overlap: bool = False,
                           precision: str = "f32") -> Callable:
    """``eval_step(mstate, *batch) -> (mstate, loss, pred)`` over a global
    batch: forward, distributed loss and the summed confusion counts, in the
    memory of one rank's part. A batch that the data axis divides is split
    by rows; a ragged tail is replicated over ``data`` (every rank takes the
    whole batch, on its z slab), and its counts are summed over ``space``
    only, so nothing is counted twice. ``pred`` is the rank's part. A
    stateful model evaluates on its running statistics."""
    trainer = _trainer(model, criterion, mesh, tau, batch_prep, overlap, precision,
                       batch_axis=batch_axis, space_axis=space_axis)
    return trainer.sharded_eval_step


def make_local_train_step(model: nn.Module, criterion, optimizer: torch.optim.Optimizer,
                          mesh: Mesh, tau: float = 0.65, batch_axis: str = "data",
                          space_axis: str = "space", overlap: bool = False,
                          with_grads: bool = False, batch_prep: Optional[Callable] = None,
                          precision: str = "f32") -> Callable:
    """The shard-local train step: ``local_step(mstate, *local_batch) ->
    (mstate, loss[, grads])`` on this rank's rows (raw loader rows where
    ``batch_prep`` is given, else (x, y) grids of the rank's rows and, with
    a space axis, its z slab). ``grads`` are the averaged gradients by
    parameter name. A stateful model (the UNet) trains pure-DP with its
    BatchNorms synchronised over ``data``."""
    trainer = _trainer(model, criterion, mesh, tau, batch_prep, overlap, precision,
                       optimizer, batch_axis, space_axis)

    def local_step(mstate: MetricState, *batch: torch.Tensor):
        mstate, loss = trainer.train_step(mstate, *batch)
        if with_grads:
            return mstate, loss, {n: p.grad for n, p in model.named_parameters()
                                  if p.grad is not None}
        return mstate, loss

    local_step.trainer = trainer
    return local_step


def make_sharded_train_step(model: nn.Module, criterion, optimizer: torch.optim.Optimizer,
                            mesh: Mesh, tau: float = 0.65, batch_axis: str = "data",
                            space_axis: str = "space", overlap: bool = False,
                            batch_prep: Optional[Callable] = None, with_grads: bool = False,
                            precision: str = "f32") -> Callable:
    """The full (DP × spatial) train step on a global batch:
    ``step(mstate, *batch) -> (mstate, loss[, grads])``; each rank cuts its
    rows (and, for grids, its z slab) and runs :func:`make_local_train_step`.
    With ``batch_prep`` the rows are raw loader rows, prepared on the rank;
    with a space axis the rank prepares its rows' whole grids and keeps its
    slab."""
    local_step = make_local_train_step(model, criterion, optimizer, mesh, tau, batch_axis,
                                       space_axis, overlap, with_grads, batch_prep, precision)
    trainer = local_step.trainer

    def step(mstate: MetricState, *batch):
        return local_step(mstate, *trainer.shard(batch))

    step.trainer = trainer
    return step
