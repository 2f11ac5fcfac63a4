"""Ensemble parallelism (EP) for the quantile SCENE-Net ensemble.

Counterpart of :mod:`scenenet_tpu.parallel.ep`. ``QuantileSceneNet`` runs
one full SceneNet conv a quantile, so on one device the ensemble costs Q
convs a step. Here the members are split over the mesh's ``model`` axis:
rank r on that axis runs only the convs of members ``[r·Q/m, (r+1)·Q/m)``,
and the ``data`` axis splits the batch as in data parallelism.

Replicated parameters, member-sharded compute, as in the JAX package:

- every rank keeps every member's parameters (a few dozen scalars a
  member), the optimizer's state and the update replicated, so the
  checkpoints, the snapshots and the Trainer's routes stay as they are;
- the rank's loss is the pinball sum over its members plus its members'
  GENEO penalties (:func:`local_quantile_loss`); the weights' mean-1
  normalisation is averaged over ``data`` only (the target is replicated
  over ``model``), so ``pmean_data(psum_model(loss))`` is the unsharded
  criterion's value;
- the gradients of the other members' parameters are zero on this rank,
  so the sum over ``model`` assembles the full gradient and the mean over
  ``data`` is the DDP reduction (:func:`reduce_ensemble_gradients`);
- the confusion counts of the rank's members against the target are
  summed over both axes: every member's voxels count, as on one device.

The steps are :class:`~scenenet_tpu_torch.train.loop.Trainer`'s, built
with a ``(data, model)`` mesh: the functions here hand them out, so that the
streamed fit, the cached fits and these functions share one
implementation, as the JAX package's ``make_local_ensemble_train_step``
does. A ``model`` axis of size 1 is data parallelism.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.func import functional_call

from scenenet_tpu_torch.losses.geneo_loss import cvx_loss, positive_regularizer
from scenenet_tpu_torch.losses.quantile import QuantileGENEOLoss, QuantileLoss
from scenenet_tpu_torch.parallel.mesh import Mesh, Placement, all_gather, all_reduce_mean_
from scenenet_tpu_torch.train.metrics import MetricState
from scenenet_tpu_torch.train.state import cast_half

__all__ = ["local_members", "local_ensemble_forward", "local_quantile_loss",
           "reduce_ensemble_gradients", "make_ensemble_inference_fn",
           "make_local_ensemble_train_step", "make_ensemble_train_step",
           "make_local_ensemble_eval_step", "make_ensemble_eval_step"]


def _check_ensemble(model, mesh: Mesh, model_axis: str = "model") -> int:
    """Validate the (model, mesh) pairing; returns the members a rank."""
    quantiles = getattr(model, "quantiles", None)
    if quantiles is None or not hasattr(model, "net"):
        raise ValueError("ensemble parallelism requires a member-stacked ensemble model "
                         "(QuantileSceneNet: .net + .quantiles); got "
                         f"{type(model).__name__}")
    if model_axis not in mesh.shape:
        raise ValueError(f"mesh has no '{model_axis}' axis (axes: {tuple(mesh.axis_names)}); "
                         f"build it with make_mesh(..., axis_names=('data', '{model_axis}'))")
    n = len(quantiles)
    m = mesh.shape[model_axis]
    if n % m:
        raise ValueError(f"{n} ensemble members do not divide over the mesh '{model_axis}' "
                         f"axis ({m}); choose a divisible quantile count")
    return n // m


def _check_criterion(criterion, model) -> None:
    if not isinstance(criterion, QuantileLoss):
        raise ValueError("ensemble parallelism is defined for the quantile criterion family "
                         "(QuantileLoss/QuantileGENEOLoss); got "
                         f"{type(criterion).__name__}")
    if tuple(criterion.quantiles) != tuple(model.quantiles):
        raise ValueError(f"criterion quantiles {tuple(criterion.quantiles)} != model "
                         f"quantiles {tuple(model.quantiles)}")


def local_members(model, mesh: Mesh, model_axis: str = "model") -> range:
    """The indices of this rank's members: ``Q/m`` of them from
    ``coord(model) · Q/m`` (``_local_member_slice`` of the JAX package)."""
    q_local = _check_ensemble(model, mesh, model_axis)
    start = mesh.coords[model_axis] * q_local
    return range(start, start + q_local)


def local_ensemble_forward(model, x: torch.Tensor, members: Sequence[int],
                           inference: "bool | str" = False, half: bool = False) -> torch.Tensor:
    """(B, 1, Z, X, Y) × the given members → (B, Q_local, Z, X, Y) in f32.
    ``half`` runs each member on bf16 copies of its parameters and a bf16
    x (the gradients land on the f32 masters)."""
    preds = []
    for i in members:
        member = model.members[i]
        if half:
            params = cast_half(dict(member.named_parameters()))
            preds.append(functional_call(member, params, (x.to(torch.bfloat16),),
                                         {"inference": inference}).float())
        else:
            preds.append(member(x, inference=inference).float())
    return torch.cat(preds, dim=1)


def local_quantile_loss(criterion: QuantileLoss, model, x: torch.Tensor, y: torch.Tensor,
                        members: Sequence[int], batch_axes: Tuple[str, ...],
                        half: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's part of the global quantile loss, and its members'
    prediction: ``pmean_data(psum_model(loss))`` is the unsharded
    criterion's value.

    - pinball: ``mean_B(w · Σ_{q local} pin_q)``, the weights normalised to
      mean 1 over ``batch_axes`` (the data axis, whose shards are equal; none
      where the batch is replicated);
    - ``QuantileGENEOLoss``: the local members' GENEO penalties, on the f32
      masters, the same on every data rank.
    """
    pred = local_ensemble_forward(model, x, members, half=half)
    gt = y[:, 0] if y.ndim == pred.ndim and y.shape[1] == 1 else y
    w_mse = dataclasses.replace(criterion.w_mse, axis_names=tuple(batch_axes))
    w = w_mse.weight_target(gt)
    terms = []
    for j, i in enumerate(members):
        q = criterion.quantiles[i]
        d = gt - pred[:, j]
        terms.append(torch.maximum(q * d, (q - 1.0) * d))
    loss = torch.mean(w * sum(terms))
    if isinstance(criterion, QuantileGENEOLoss):
        last = model.last_lambda
        for i in members:
            member = model.members[i]
            loss = loss + cvx_loss(member.cvx_coefficients(), last, criterion.convex_weight)
            loss = loss + positive_regularizer(member.geneo_params_flat(),
                                               criterion.convex_weight)
    return loss, pred


def reduce_ensemble_gradients(model: nn.Module, mesh: Mesh, batch_axis: str = "data",
                              model_axis: str = "model") -> None:
    """Assemble the gradients in place: summed over ``model`` (the other
    members' are zero here) and averaged over ``batch_axis``, in one
    all-reduce. A parameter of a member not on this rank gets a zero
    gradient where the same parameter of a local member has one, so every
    rank reduces the same tensors."""
    members = list(local_members(model, mesh, model_axis))
    reached = {n for i in members for n, p in model.members[i].named_parameters()
               if p.grad is not None}
    grads = []
    for i, member in enumerate(model.members):
        for n, p in member.named_parameters():
            if n not in reached:
                continue
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
    all_reduce_mean_(grads, (batch_axis, model_axis), mesh, mean_over=batch_axis)


def make_ensemble_inference_fn(model, mesh: Mesh, batch_axis: str = "data",
                               model_axis: str = "model",
                               inference: "bool | str" = False) -> Callable:
    """``run(x)``: the ensemble's forward of this rank's rows of a global
    batch (B over ``data``), each rank convolving its members only, the
    members gathered over ``model``: (B_local, Q, Z, X, Y). ``inference``
    goes to each member (``True`` the f32 stencil, ``"mxu"`` the
    tensor-core one)."""
    members = local_members(model, mesh, model_axis)
    placement = Placement(mesh, batch_axis, None)

    @torch.no_grad()
    def forward(x):
        out = local_ensemble_forward(model, x, members, inference=inference)
        return all_gather(out, model_axis, 1, mesh)

    def run(x):
        x = torch.as_tensor(x)
        if x.shape[0] % mesh.shape[batch_axis]:
            raise ValueError(f"batch {x.shape[0]} not divisible by mesh '{batch_axis}' axis "
                             f"({mesh.shape[batch_axis]})")
        return forward(placement(x).to(mesh.device))

    run.forward = forward
    run.placement = placement
    return run


def _trainer(model, criterion, mesh, tau, batch_prep, precision, optimizer=None,
             batch_axis="data", model_axis="model"):
    from scenenet_tpu_torch.train.loop import TrainConfig, Trainer
    from scenenet_tpu_torch.utils.logging import NullLogger

    if (batch_axis, model_axis) != ("data", "model"):
        raise ValueError("the port's mesh steps take the axes 'data' and 'model', got "
                         f"{(batch_axis, model_axis)}")
    _check_ensemble(model, mesh, model_axis)
    _check_criterion(criterion, model)
    trainer = Trainer(model, criterion, TrainConfig(tau=tau, precision=precision,
                                                    early_stop_metric=None),
                      logger=NullLogger(), batch_prep=batch_prep, mesh=mesh)
    trainer.optimizer = optimizer
    return trainer


def make_local_ensemble_train_step(model, criterion, optimizer: torch.optim.Optimizer,
                                   mesh: Mesh, tau: float = 0.65, batch_axis: str = "data",
                                   model_axis: str = "model",
                                   batch_prep: Optional[Callable] = None,
                                   with_grads: bool = False,
                                   precision: str = "f32") -> Callable:
    """The rank-local EP train step: ``local_step(mstate, *local_batch) ->
    (mstate, loss[, grads])`` on this rank's rows (raw loader rows where
    ``batch_prep`` is given; each model rank prepares its data rows again,
    trivial next to the convs it feeds). ``loss`` and the counts are the
    global ones; ``grads`` the assembled gradients by parameter name. An
    L-BFGS optimizer's linesearch sees the global value and slope."""
    trainer = _trainer(model, criterion, mesh, tau, batch_prep, precision, optimizer,
                       batch_axis, model_axis)

    def local_step(mstate: MetricState, *batch: torch.Tensor):
        mstate, loss = trainer.train_step(mstate, *batch)
        if with_grads:
            return mstate, loss, {n: p.grad for n, p in model.named_parameters()
                                  if p.grad is not None}
        return mstate, loss

    local_step.trainer = trainer
    return local_step


def make_ensemble_train_step(model, criterion, optimizer: torch.optim.Optimizer, mesh: Mesh,
                             tau: float = 0.65, batch_axis: str = "data",
                             model_axis: str = "model", batch_prep: Optional[Callable] = None,
                             with_grads: bool = False, precision: str = "f32") -> Callable:
    """The full (DP × EP) train step on a global batch: ``step(mstate,
    *batch) -> (mstate, loss[, grads])``; each rank cuts its rows and runs
    :func:`make_local_ensemble_train_step`."""
    local_step = make_local_ensemble_train_step(model, criterion, optimizer, mesh, tau,
                                                batch_axis, model_axis, batch_prep,
                                                with_grads, precision)
    trainer = local_step.trainer

    def step(mstate: MetricState, *batch):
        return local_step(mstate, *trainer.shard(batch))

    step.trainer = trainer
    return step


def make_local_ensemble_eval_step(model, criterion, mesh: Mesh, tau: float = 0.65,
                                  batch_axis: str = "data", model_axis: str = "model",
                                  batch_sharded: bool = True,
                                  precision: str = "f32") -> Callable:
    """The rank-local EP eval step: ``local_eval(mstate, x, y) -> (mstate,
    loss, pred)`` with ``x, y`` this rank's rows (``batch_sharded``) or the
    whole batch, replicated over ``data`` (a ragged tail: the loss and
    counts then reduce over ``model`` alone). ``pred`` is the rank's
    members, (B, Q_local, ...)."""
    trainer = _trainer(model, criterion, mesh, tau, None, precision,
                       batch_axis=batch_axis, model_axis=model_axis)
    axes = (batch_axis, model_axis) if batch_sharded else (model_axis,)

    def local_eval(mstate: MetricState, x: torch.Tensor, y: torch.Tensor):
        return trainer.local_eval_step(mstate, torch.as_tensor(x).to(mesh.device),
                                       torch.as_tensor(y).to(mesh.device), axes)

    local_eval.trainer = trainer
    return local_eval


def make_ensemble_eval_step(model, criterion, mesh: Mesh, tau: float = 0.65,
                            batch_axis: str = "data", model_axis: str = "model",
                            batch_prep: Optional[Callable] = None,
                            precision: str = "f32") -> Callable:
    """Eval twin of :func:`make_ensemble_train_step`: ``eval_step(mstate,
    *batch) -> (mstate, loss, pred)`` over a global batch, the members over
    ``model``. A batch that the data axis divides is split by rows; a ragged
    tail is replicated over ``data``, each rank still convolving its own
    members. ``pred`` is the rank's rows with every member gathered:
    (B_local, Q, ...)."""
    trainer = _trainer(model, criterion, mesh, tau, batch_prep, precision,
                       batch_axis=batch_axis, model_axis=model_axis)

    def eval_step(mstate: MetricState, *batch):
        mstate, loss, pred = trainer.sharded_eval_step(mstate, *batch)
        return mstate, loss, all_gather(pred, model_axis, 1, mesh)

    eval_step.trainer = trainer
    return eval_step
