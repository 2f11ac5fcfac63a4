"""Pipeline parallelism (PP) for straight-through conv stacks: the GPipe
schedule over a ``stage`` mesh axis.

Counterpart of :mod:`scenenet_tpu.parallel.pp`. The depth of a sequential
conv stack becomes a mesh axis: each rank runs one stage, and the batch
streams through the chain as microbatches. Applied to the CNN baseline,
whose two stacked SAME convs (no activation between them) are a 2-stage
pipeline, and, for inference, to the UNet split at its bottleneck (the
encoder on stage 0, the decoder and the head on stage 1).

As in the JAX package:

- every stage is a SAME C → C conv with bias; the CNN's first 1 → C kernel
  is zero-embedded into a C → C kernel at input channel 0
  (:func:`cnn_pipeline_params`) and the input is zero-padded to C
  channels, so the embedded weights multiply zeros: exact in value and in
  gradient (theirs is zero). The channel sum and relu∘tanh head runs after
  the pipe. The stage-stacked tree is in the flax layout, the JAX one;
- every rank keeps the whole stage-stacked tree and computes its own
  stage; the slice's gradient is zero elsewhere;
- the schedule is T = M + S − 1 steps (M microbatches, S stages): at step
  t stage 0 starts microbatch t, stage s works on microbatch t − s, the
  last stage finishes microbatch t − (S − 1); after each step every rank
  hands its activation to the next stage by
  :func:`~scenenet_tpu_torch.parallel.mesh.shift` (the first stage gets
  zeros, which it discards, as JAX discards the ring's wrap). Every rank
  computes at every step and builds the same graph, as the JAX program
  does, so that every shift has its transpose in the backward on every
  rank, in the same order;
- the last stage's outputs are summed over ``stage`` (the other ranks add
  zeros), so every rank holds the assembled prediction and computes the
  loss. Each rank then differentiates a whole copy of the loss, and its
  stage's gradient comes back S times too large: the gradients are
  averaged over ``stage`` (and then over ``data``), where the ensemble's
  partial losses take a sum.

The stage conv is the CNN's own conv (:func:`~scenenet_tpu_torch.models.cnn_baseline.cnn_conv`):
the multi-channel conv kernel (K10) at (3, 3, 3) on ``backend="cuda"``, the
library conv elsewhere. Neither the Trainer nor the CLI calls this module,
as in the JAX package.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from scenenet_tpu_torch.models.cnn_baseline import cnn_conv
from scenenet_tpu_torch.parallel.mesh import (
    Mesh, PendingShift, Placement, all_reduce_mean_, psum, shift,
)
from scenenet_tpu_torch.train.metrics import MetricState

__all__ = ["make_stage_params", "cnn_pipeline_params", "cnn_unstack_params", "pipeline_apply",
           "make_pipeline_inference_fn", "make_pipeline_train_step",
           "make_unet_pipeline_inference_fn"]


def make_stage_params(kernels: Sequence[torch.Tensor],
                      biases: Sequence[torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Stack per-stage conv parameters into the stage-major tree:
    ``kernels`` S same-shape flax-layout (kd, kh, kw, C, C), ``biases`` S
    (C,). Returns ``{"kernel": (S, ...), "bias": (S, C)}``."""
    ks = torch.stack([torch.as_tensor(k) for k in kernels])
    bs = torch.stack([torch.as_tensor(b) for b in biases])
    if ks.ndim != 6 or ks.shape[-1] != ks.shape[-2]:
        raise ValueError("pipeline stages must be uniform C→C DHWIO convs; got stacked kernel "
                         f"shape {tuple(ks.shape)}")
    return {"kernel": ks, "bias": bs}


def cnn_pipeline_params(model) -> Dict[str, torch.Tensor]:
    """A two-conv ``CnnBaseline`` → the stage-stacked tree (S = 2), its first
    (kd, kh, kw, 1, C) kernel zero-embedded into a C → C one at input
    channel 0."""
    if not getattr(model, "two_layers", False):
        raise ValueError("pipeline parallelism needs a multi-stage stack; "
                         "CnnBaseline(two_layers=False) is a single conv")
    state = model.flax_state()
    k0, b0 = state["Conv_0.kernel"], state["Conv_0.bias"]
    k1, b1 = state["Conv_1.kernel"], state["Conv_1.bias"]
    c = k1.shape[-1]
    if k0.shape[-2] != 1 or k1.shape[-2] != c or k0.shape[-1] != c:
        raise ValueError(f"unexpected CnnBaseline kernel shapes {tuple(k0.shape)}/"
                         f"{tuple(k1.shape)}")
    k0_emb = torch.zeros(tuple(k0.shape[:3]) + (c, c), dtype=k0.dtype, device=k0.device)
    k0_emb[..., 0, :] = k0[..., 0, :]
    return make_stage_params([k0_emb, k1.clone()], [b0.clone(), b1.clone()])


def cnn_unstack_params(stacked: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`cnn_pipeline_params`: the ``CnnBaseline``'s
    flax-layout state (``load_flax_state`` takes it). Stage 0's input
    channel 0 alone: the embedded columns get zero gradient and stay zero."""
    k, b = stacked["kernel"], stacked["bias"]
    return {"Conv_0.kernel": k[0][..., :1, :], "Conv_0.bias": b[0],
            "Conv_1.kernel": k[1], "Conv_1.bias": b[1]}


def _stage_conv(backend: str) -> Callable:
    """One stage: the CNN's SAME conv + bias of the flax-layout stage
    kernel, on channels-first activations."""
    def fn(stage_params, h):
        kernel = stage_params["kernel"]
        w = kernel.permute(4, 3, 0, 1, 2)  # DHWIO → (C_out, C_in, kd, kh, kw)
        return cnn_conv(h, w, stage_params["bias"], tuple(kernel.shape[:3]), backend)

    return fn


def _cnn_head(h: torch.Tensor) -> torch.Tensor:
    """The CNN's head: the channel sum and relu∘tanh, (B, 1, Z, X, Y)."""
    return torch.relu(torch.tanh(h.sum(dim=1, keepdim=True)))


def _lift_input(x: torch.Tensor, channels: int) -> torch.Tensor:
    """(B, 1, Z, X, Y) → (B, C, Z, X, Y), the channels past the first zero."""
    return F.pad(x.float(), (0, 0, 0, 0, 0, 0, 0, channels - x.shape[1]))


def pipeline_apply(stacked: Mapping[str, torch.Tensor], x_mb: torch.Tensor, *,
                   stage_axis: str, n_stages: int, stage_fn: Optional[Callable] = None,
                   mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The GPipe schedule on this rank. ``x_mb``: (M, mb, C, Z, X, Y)
    microbatches, the same on every stage rank (stage 0 alone reads them).
    Returns the last stage's (M, mb, C, Z, X, Y) outputs, summed over the
    stage axis, so that every rank holds them. Differentiable: the shifts'
    backwards run the schedule in reverse. ``stage_fn(stage_params, h)``
    defaults to the CNN's conv on the library route."""
    from scenenet_tpu_torch.parallel.mesh import _resolve

    mesh = _resolve(mesh)
    stage_fn = stage_fn or _stage_conv("torch")
    idx, s, m = mesh.coords[stage_axis], n_stages, x_mb.shape[0]
    local = {k: v[idx] for k, v in stacked.items()}
    # the rank's place as tensors: every rank builds the same graph, with the
    # selections as `where`s (JAX's jnp.where on axis_index), so that every
    # shift has its backward on every rank, in the same order
    first = torch.tensor(idx == 0, device=x_mb.device)
    last = torch.tensor(idx == s - 1, device=x_mb.device)
    buf = torch.zeros_like(x_mb[0])
    outputs = []
    for t in range(m + s - 1):
        out = stage_fn(local, torch.where(first, x_mb[min(t, m - 1)], buf))
        if t >= s - 1:  # the last stage finishes microbatch t - (S - 1)
            outputs.append(torch.where(last, out, torch.zeros_like(out)))
        buf = shift(out, stage_axis, +1, mesh)
    return psum(torch.stack(outputs), stage_axis, mesh)


def _check_pipeline(mesh: Mesh, stage_axis: str, n_stages: int, n_microbatches: int,
                    model=None) -> None:
    if model is not None and not getattr(model, "two_layers", False):
        raise ValueError("pipeline parallelism needs a multi-stage stack; "
                         f"{type(model).__name__}(two_layers=False) is a single conv")
    if stage_axis not in mesh.shape:
        raise ValueError(f"mesh has no '{stage_axis}' axis (axes: {tuple(mesh.axis_names)}); "
                         f"build it with make_mesh(..., axis_names=('data', '{stage_axis}'))")
    if mesh.shape[stage_axis] != n_stages:
        raise ValueError(f"{n_stages} pipeline stages need a {n_stages}-wide '{stage_axis}' "
                         f"axis; mesh has {mesh.shape[stage_axis]}")
    if n_microbatches < 1:
        raise ValueError(f"n_microbatches must be ≥ 1, got {n_microbatches}")


def _microbatch(h: torch.Tensor, n_microbatches: int) -> torch.Tensor:
    b = h.shape[0]
    if b % n_microbatches:
        raise ValueError(f"shard-local batch {b} not divisible into {n_microbatches} "
                         "microbatches")
    return h.reshape((n_microbatches, b // n_microbatches) + tuple(h.shape[1:]))


def _cnn_pipeline_forward(stacked, x, *, stage_axis, n_microbatches, backend="torch",
                          mesh=None):
    """The rank's pipelined CnnBaseline forward of its (B_local, 1, Z, X, Y)
    rows: lift, microbatch, pipe, head."""
    c = stacked["bias"].shape[-1]
    h = _microbatch(_lift_input(x, c), n_microbatches)
    out = pipeline_apply(stacked, h, stage_axis=stage_axis, n_stages=2,
                         stage_fn=_stage_conv(backend), mesh=mesh)
    return _cnn_head(out.reshape((-1,) + tuple(out.shape[2:])))


def _rows(mesh: Mesh, batch_axis: str) -> Placement:
    return Placement(mesh, batch_axis if batch_axis in mesh.shape else None, None)


def make_pipeline_inference_fn(model, mesh: Mesh, n_microbatches: int = 4,
                               batch_axis: str = "data", stage_axis: str = "stage"
                               ) -> Callable:
    """``run(stacked, x)``: the pipelined CnnBaseline forward of this rank's
    rows of a global batch (B over ``data``, the conv depth over ``stage``)
    from the stage-stacked tree (:func:`cnn_pipeline_params`), equal to the
    unpipelined model's rows. The stage conv takes the model's backend."""
    _check_pipeline(mesh, stage_axis, 2, n_microbatches, model=model)
    placement = _rows(mesh, batch_axis)
    backend = getattr(model, "backend", "torch")

    @torch.no_grad()
    def forward(stacked, x):
        return _cnn_pipeline_forward(stacked, x, stage_axis=stage_axis,
                                     n_microbatches=n_microbatches, backend=backend,
                                     mesh=mesh)

    def run(stacked, x):
        x = torch.as_tensor(x)
        data = mesh.shape.get(batch_axis, 1)
        if x.shape[0] % data:
            raise ValueError(f"batch {x.shape[0]} not divisible by mesh '{batch_axis}' axis "
                             f"({data})")
        return forward(stacked, placement(x).to(mesh.device))

    run.forward = forward
    run.placement = placement
    return run


def _skip_shapes(x_shape: Tuple[int, ...], widths=(32, 64, 128, 256, 256)):
    """The shapes of the UNet's skip tuple x1..x5 for an input of x_shape:
    the channel ladder, each level's extent floor-halved by the pool."""
    b, _, *ext = x_shape
    out = []
    for level, c in enumerate(widths):
        out.append((b, c) + tuple(e // 2 ** level for e in ext))
    return out


def make_unet_pipeline_inference_fn(model, mesh: Mesh, n_microbatches: int = 4,
                                    batch_axis: str = "data",
                                    stage_axis: str = "stage") -> Callable:
    """2-stage GPipe inference for the UNet3D: stage 0 the encoder
    (``model(x, stage="encode")``), stage 1 the decoder and the head
    (``stage="decode"``). The skip tuple x1..x5 is the stage boundary and
    goes one hop a step, five shifts; T = M + 1 steps. Stage 1 posts its
    receives before it decodes the previous microbatch, so that stage 0's
    next encode runs meanwhile. Eval mode only (the running statistics), as
    in the JAX package: a microbatched train-mode BatchNorm would
    normalise otherwise than the whole batch. ``run(x)`` returns the rank's
    rows of the prediction, equal to ``model.eval()(x)``'s."""
    _check_pipeline(mesh, stage_axis, 2, n_microbatches)
    placement = _rows(mesh, batch_axis)
    m = n_microbatches

    @torch.no_grad()
    def forward(x):
        model.eval()
        idx = mesh.coords[stage_axis]
        xmb = _microbatch(x, m)
        dt = model.dtype
        zeros = [torch.zeros(s, dtype=dt, device=x.device) for s in _skip_shapes(xmb.shape[1:])]
        outputs = []
        buf = zeros
        for t in range(m + 1):
            if idx == 0:
                enc = model(xmb[t], stage="encode") if t < m else zeros
                pending = [PendingShift(e.contiguous(), stage_axis, +1, mesh) for e in enc]
            else:
                pending = [PendingShift(z, stage_axis, +1, mesh) for z in zeros]
                if t >= 1:
                    outputs.append(model(tuple(buf), stage="decode"))
            buf = [p.wait() for p in pending]
        if idx == 1:
            out = torch.cat(outputs)
        else:
            out = torch.zeros((x.shape[0], model.n_classes) + tuple(x.shape[2:]),
                              dtype=torch.float32, device=x.device)
        return psum(out, stage_axis, mesh)

    def run(x):
        x = torch.as_tensor(x)
        div = mesh.shape.get(batch_axis, 1) * n_microbatches
        if x.shape[0] % div:
            raise ValueError(f"batch {x.shape[0]} must divide into "
                             f"{mesh.shape.get(batch_axis, 1)} data shards × "
                             f"{n_microbatches} microbatches")
        return forward(placement(x).to(mesh.device))

    run.forward = forward
    run.placement = placement
    return run


def make_pipeline_train_step(model, criterion, optimizer: torch.optim.Optimizer, mesh: Mesh,
                             stacked: Mapping[str, nn.Parameter], n_microbatches: int = 4,
                             tau: float = 0.65, batch_axis: str = "data",
                             stage_axis: str = "stage", with_grads: bool = False) -> Callable:
    """The (DP × PP) train step of the CnnBaseline: ``step(mstate, x, y) ->
    (mstate, loss[, grads])`` on a global batch, ``stacked`` the
    stage-stacked tree as parameters (:func:`cnn_pipeline_params`; the
    ``optimizer`` holds them; map back with :func:`cnn_unstack_params`).

    The assembled prediction is the same on every stage rank, so the
    criterion is made distributed over ``data`` alone; the gradients are
    averaged over ``stage`` (every rank differentiated a whole copy of the
    loss) and over ``data``, in one all-reduce; the counts are summed over
    ``data``. The embedded weights' gradient is zero, so training the
    stacked tree trains the model. ``grads`` is the assembled gradient
    tree."""
    from scenenet_tpu_torch.parallel.dp import make_distributed, psum_confusion_delta
    from scenenet_tpu_torch.parallel.mesh import pmean

    _check_pipeline(mesh, stage_axis, 2, n_microbatches, model=model)
    has_data = batch_axis in mesh.shape
    data_axes = (batch_axis,) if has_data else ()
    data_size = mesh.shape.get(batch_axis, 1)
    dist_criterion = make_distributed(criterion, data_axes)
    placement = _rows(mesh, batch_axis)
    backend = getattr(model, "backend", "torch")
    params = [stacked["kernel"], stacked["bias"]]

    def step(mstate: MetricState, x, y):
        x, y = torch.as_tensor(x), torch.as_tensor(y)
        if x.shape[0] % (data_size * n_microbatches):
            raise ValueError(f"batch {x.shape[0]} must divide into {data_size} data shards "
                             f"× {n_microbatches} microbatches")
        x, y = placement(x).to(mesh.device), placement(y).to(mesh.device)
        with mesh.active():
            optimizer.zero_grad(set_to_none=True)
            pred = _cnn_pipeline_forward(stacked, x, stage_axis=stage_axis,
                                         n_microbatches=n_microbatches, backend=backend,
                                         mesh=mesh)
            loss = dist_criterion(pred, y, {}, {}, None)
            loss.backward()
            all_reduce_mean_([p.grad for p in params], (stage_axis,) + data_axes, mesh)
            loss = pmean(loss.detach(), data_axes, mesh) if data_axes else loss.detach()
            optimizer.step()
            mstate = psum_confusion_delta(mstate, pred.detach(), y, tau, data_axes, mesh)
        if with_grads:
            return mstate, loss, {"kernel": params[0].grad, "bias": params[1].grad}
        return mstate, loss

    return step
