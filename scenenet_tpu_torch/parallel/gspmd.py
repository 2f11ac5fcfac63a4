"""Channel tensor parallelism (TP) for the black-box conv stacks, UNet3D and
CnnBaseline, over a ``(data, model)`` mesh.

Counterpart of :mod:`scenenet_tpu.parallel.gspmd`. The JAX package writes
the one-device step and lets XLA's GSPMD partitioner place the collectives
from sharding annotations. Torch has no such partitioner, so here every
collective is placed by hand on :mod:`scenenet_tpu_torch.parallel.mesh`;
the result is still the JAX one: one logical step, equal to the one-device
step up to the order of its sums.

The sharding is JAX's leafwise rule (:func:`channel_spec`), applied to the
flax-layout shapes:

- a conv kernel ``(k_d, k_h, k_w, C_in, C_out)`` is split over ``model``
  on ``C_out`` where the axis divides it (a column-parallel conv);
- a per-channel vector (BatchNorm scale, bias, running statistics, a conv
  bias) is split likewise;
- everything else is replicated: the UNet's 32 → 1 head, scalars.

A rank holds its ``C_out/m`` slice of every split conv and BatchNorm
(:func:`channel_parallel` makes that module from the full model). Its conv
computes its output channels from every input channel, so after each conv's
BatchNorm and ReLU (the CNN: after each conv) the activation is gathered
over ``model`` along the channels (:func:`~scenenet_tpu_torch.parallel.mesh.all_gather`):
the next conv contracts all of ``C_in``. The gather's backward is a
reduce-scatter: each rank's conv gives only its part of the input's
cotangent. The last gather feeds the head and the loss, which every rank
computes identically; there every rank holds the whole cotangent, and a
reduce-scatter would count it m times, so that gather's backward keeps the
rank's slice alone (``reduce_backward=False``).

BatchNorm statistics are per local channel and averaged over ``data``
(the sync BatchNorm of data parallelism, flax's E[x²] − E[x]²): global-batch
statistics, as GSPMD's one logical program has. The optimizer holds the
rank's slices, so Adam's moments are sharded with their parameters; the
gradients of every leaf are averaged over ``data`` only (a replicated leaf's
gradient is the same on every model rank). The Trainer gathers the full
flax-layout tree into the model before it writes a checkpoint or a
snapshot (:func:`gather_into`).
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from scenenet_tpu_torch.parallel.mesh import Mesh, _gather, all_gather
from scenenet_tpu_torch.train.metrics import MetricState

__all__ = ["channel_spec", "channel_specs", "channel_shardings", "shard_state", "gather_state", "channel_parallel",
           "gather_into", "shard_from", "make_gspmd_train_step", "make_gspmd_eval_step"]


def channel_spec(shape, n_shards: int, axis: str = "model") -> Tuple:
    """The leafwise channel-TP rule: where (if anywhere) ``axis`` splits an
    array of this flax-layout shape, as a partition spec (a tuple of axis
    names and None, ``()`` replicated)."""
    shape = tuple(shape)
    if n_shards <= 1:
        return ()
    if len(shape) == 5 and shape[-1] >= n_shards and shape[-1] % n_shards == 0:
        return (None, None, None, None, axis)  # conv kernel (DHWIO): column-parallel
    if len(shape) == 1 and shape[0] >= n_shards and shape[0] % n_shards == 0:
        return (axis,)  # per-channel vector
    return ()


def channel_specs(state: Mapping[str, torch.Tensor], mesh: Mesh,
                  axis: str = "model") -> Dict[str, Tuple]:
    """:func:`channel_spec` of every leaf of a flax-layout state (a model's
    ``flax_state()``)."""
    m = int(mesh.shape.get(axis, 1))
    return {k: channel_spec(tuple(v.shape), m, axis) for k, v in state.items()}


class ChannelSharding:
    """A leaf's place under the channel rule (the counterpart of a
    ``NamedSharding``): ``spec`` and, called on the full leaf, this rank's
    part of it."""

    def __init__(self, mesh: Mesh, spec: Tuple):
        self.mesh, self.spec = mesh, tuple(spec)

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        for d, axis in enumerate(self.spec):
            if axis is not None:
                size = t.shape[d] // self.mesh.shape[axis]
                t = t.narrow(d, self.mesh.coords[axis] * size, size)
        return t

    def __repr__(self) -> str:
        return f"ChannelSharding({self.spec})"


def channel_shardings(state: Mapping[str, torch.Tensor], mesh: Mesh,
                      axis: str = "model") -> Dict[str, ChannelSharding]:
    """:class:`ChannelSharding` of every leaf of a flax-layout state."""
    return {k: ChannelSharding(mesh, spec) for k, spec in channel_specs(state, mesh, axis).items()}


def _split_dim(spec: Tuple, axis: str) -> Optional[int]:
    return spec.index(axis) if axis in spec else None


def shard_state(state: Mapping[str, torch.Tensor], mesh: Mesh,
                axis: str = "model") -> Dict[str, torch.Tensor]:
    """This rank's part of a full flax-layout state: every split leaf's
    ``1/m`` slice at the rank's coordinate on ``axis``, every other leaf
    whole."""
    m, c = int(mesh.shape.get(axis, 1)), mesh.coords.get(axis, 0)
    out = {}
    for k, v in state.items():
        d = _split_dim(channel_spec(tuple(v.shape), m, axis), axis)
        if d is None:
            out[k] = v
        else:
            size = v.shape[d] // m
            out[k] = v.narrow(d, c * size, size)
    return out


@torch.no_grad()
def gather_state(local: Mapping[str, torch.Tensor], specs: Mapping[str, Tuple], mesh: Mesh,
                 axis: str = "model") -> Dict[str, torch.Tensor]:
    """The inverse of :func:`shard_state` (a collective over ``axis``):
    ``specs`` are the full state's (:func:`channel_specs`)."""
    out = {}
    for k, v in local.items():
        d = _split_dim(specs[k], axis)
        out[k] = v if d is None or mesh.shape[axis] == 1 else _gather(v, axis, d, mesh)
    return out


def _torch_split(t: torch.Tensor, m: int) -> bool:
    """The same rule on a torch-layout tensor: a conv weight (C_out, C_in,
    k, k, k) on dim 0, a per-channel vector on dim 0."""
    return t.ndim in (1, 5) and t.shape[0] >= m and t.shape[0] % m == 0


def _check_shardable(state: Mapping[str, torch.Tensor], mesh: Mesh,
                     model_axis: str = "model") -> None:
    """A model axis wider than 1 must split something: otherwise every
    parameter stays replicated and the model ranks do the same work. Hit
    by models without channels (SceneNet's scalar parameters) and by a
    ``mesh_channel`` that divides no channel width (3 on the UNet's
    32/64/128/256 ladder)."""
    m = int(mesh.shape.get(model_axis, 1))
    if m <= 1:
        return
    if not any(channel_spec(tuple(v.shape), m, model_axis) for v in state.values()):
        raise ValueError(
            f"channel TP over a {m}-wide '{model_axis}' axis shards NO parameter of this "
            f"model — every channel width must be divisible by {m} for at least one conv "
            "kernel / channel vector. Use a divisor of the model's channel widths, or a mesh "
            "without a model axis (SceneNet-family scalar-parameter models have no channel "
            "dimension to shard — use data/space/ensemble axes for them).")


def _check_batch_divisible(b: int, data_size: int, data_axis: str = "data") -> None:
    if b % data_size:
        raise ValueError(f"batch {b} not divisible by mesh '{data_axis}' axis ({data_size}); "
                         "use drop_last or a divisible batch size")


def _layers(model: nn.Module) -> list:
    """The channel-carrying layers of a conv stack in forward order: the
    UNet's blocks (two convs each), the CNN itself (one conv a weight)."""
    from scenenet_tpu_torch.models.cnn_baseline import CnnBaseline
    from scenenet_tpu_torch.models.unet3d import BLOCKS, UNet3D

    if isinstance(model, UNet3D):
        return [getattr(model, b) for b in BLOCKS]
    if isinstance(model, CnnBaseline):
        return [model]
    raise ValueError(f"channel tensor parallelism shards UNet3D and CnnBaseline; got "
                     f"{type(model).__name__}")


def _split_tensors(model: nn.Module, m: int):
    """(module, name, kind, tensor) of every parameter and buffer that the
    rule splits."""
    out = []
    for mod in model.modules():
        for kind, table in (("param", mod._parameters), ("buffer", mod._buffers)):
            for name, t in table.items():
                if t is not None and _torch_split(t, m):
                    out.append((mod, name, kind, t))
    return out


def channel_parallel(model: nn.Module, mesh: Mesh, axis: str = "model") -> nn.Module:
    """This rank's channel-parallel copy of ``model`` (a ``UNet3D`` or a
    ``CnnBaseline``) on ``mesh.device``: the same class and parameter names,
    every split parameter and running statistic replaced by the rank's
    slice, and a gather over ``axis`` after each split conv's block output.
    The full model is left as it is; :func:`gather_into` writes the shards
    back into it."""
    from scenenet_tpu_torch.train.checkpoint import _module_state

    m = int(mesh.shape[axis])
    _check_shardable(_module_state(model), mesh, axis)
    layers = _layers(model)
    widths = [w.shape[0] for layer in layers for w in _layer_weights(layer)]
    if any(w % m for w in widths):
        raise ValueError(f"channel TP of {type(model).__name__} splits every conv: the "
                         f"'{axis}' axis ({m}) must divide every conv's output width "
                         f"{sorted(set(widths))}")
    tp = copy.deepcopy(model).to(mesh.device)
    c = mesh.coords[axis]
    prefix = {mod: (n + "." if n else "") for n, mod in tp.named_modules()}
    tp.split_names = set()
    with torch.no_grad():
        for mod, name, kind, t in _split_tensors(tp, m):
            tp.split_names.add(prefix[mod] + name)
            size = t.shape[0] // m
            part = t.narrow(0, c * size, size).clone()
            if kind == "param":
                mod._parameters[name] = nn.Parameter(part, requires_grad=t.requires_grad)
            else:
                mod._buffers[name] = part
    tp_layers = _layers(tp)
    n_gathers = sum(len(_layer_weights(layer)) for layer in tp_layers)
    k = 0
    for layer in tp_layers:
        gathers = []
        for _ in _layer_weights(layer):
            k += 1
            # the last gather feeds the replicated head: no reduce in its backward
            gathers.append(_Gather(axis, mesh, reduce_backward=k < n_gathers))
        layer.gathers = tuple(gathers)
    tp.channel_axis = axis
    tp.channel_mesh = mesh
    return tp


def _layer_weights(layer: nn.Module):
    from scenenet_tpu_torch.models.cnn_baseline import CnnBaseline

    if isinstance(layer, CnnBaseline):
        return list(layer.weights)
    return [layer.conv0, layer.conv1]


class _Gather:
    """The channel gather after a split conv's block output."""

    def __init__(self, axis: str, mesh: Mesh, reduce_backward: bool):
        self.axis, self.mesh, self.reduce_backward = axis, mesh, reduce_backward

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return all_gather(x, self.axis, 1, self.mesh, self.reduce_backward)

    def __deepcopy__(self, memo):
        return self  # a mesh holds process groups


def _named_tensors(model: nn.Module):
    return dict(list(model.named_parameters()) + list(model.named_buffers()))


@torch.no_grad()
def gather_into(tp: nn.Module, model: nn.Module) -> nn.Module:
    """Write the channel-parallel ``tp``'s shards, gathered over its axis,
    into the full ``model`` in place (a collective: every rank calls it)."""
    mesh, axis = tp.channel_mesh, tp.channel_axis
    full = _named_tensors(model)
    for name, t in _named_tensors(tp).items():
        dst = full[name]
        dst.copy_(t if t.shape == dst.shape else _gather(t, axis, 0, mesh))
    return model


@torch.no_grad()
def shard_from(tp: nn.Module, model: nn.Module) -> nn.Module:
    """Copy the full ``model``'s values into the channel-parallel ``tp``:
    each split tensor's slice, every other tensor whole (in place, so that
    an optimizer keeps its parameters)."""
    m, c = tp.channel_mesh.shape[tp.channel_axis], tp.channel_mesh.coords[tp.channel_axis]
    full = _named_tensors(model)
    for name, t in _named_tensors(tp).items():
        src = full[name]
        if t.shape != src.shape:
            size = src.shape[0] // m
            src = src.narrow(0, c * size, size)
        t.copy_(src)
    return tp


def _param_names(tp: nn.Module, params) -> list:
    names = {id(p): n for n, p in tp.named_parameters()}
    return [names[id(p)] for p in params]


def global_dot(tp: nn.Module, params) -> Callable:
    """``dot(a, b)`` of two flat vectors laid out as ``params`` (L-BFGS's
    flat view of the rank's shards), over the whole vector: the split
    parameters' part summed over the model axis, the replicated ones'
    counted once. Every model rank gets the same value."""
    from scenenet_tpu_torch.parallel.mesh import psum

    mesh, axis = tp.channel_mesh, tp.channel_axis
    names = _param_names(tp, params)
    split = torch.cat([torch.full((p.numel(),), n in tp.split_names, dtype=torch.bool)
                       for n, p in zip(names, params)]).to(params[0].device)

    def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        ab = a * b
        part = torch.where(split, ab, torch.zeros_like(ab)).sum()
        rest = torch.where(split, torch.zeros_like(ab), ab).sum()
        return psum(part, axis, mesh) + rest

    return dot


def _optimizer_params(optimizer) -> list:
    return [q for g in optimizer.param_groups for q in g["params"]]


@torch.no_grad()
def gather_optimizer_state(tp: nn.Module, optimizer, state: Mapping[str, torch.Tensor]
                           ) -> Dict[str, torch.Tensor]:
    """The optimizer's state (``optimizer_state``'s names) over the full
    tree, gathered over the model axis (a collective): a split parameter's
    moments whole. L-BFGS's flat vectors are gathered segment by segment,
    so that they are the flat vectors of the full model's parameters."""
    from scenenet_tpu_torch.train.lbfgs import LBFGS

    mesh, axis = tp.channel_mesh, tp.channel_axis
    params = _optimizer_params(optimizer)
    names = _param_names(tp, params)
    if isinstance(optimizer, LBFGS):
        out = {}
        for k, v in state.items():
            if v.ndim == 0 or k == "rho":
                out[k] = v
                continue
            segs, offset = [], 0
            for n, p in zip(names, params):
                seg = v[..., offset:offset + p.numel()]
                offset += p.numel()
                segs.append(_gather(seg.contiguous(), axis, seg.ndim - 1, mesh)
                            if n in tp.split_names else seg)
            out[k] = torch.cat(segs, dim=-1)
        return out
    out = {}
    for k, v in state.items():
        i = int(k.split("/", 1)[0])
        split = names[i] in tp.split_names and tuple(v.shape) == tuple(params[i].shape)
        out[k] = _gather(v, axis, 0, mesh) if split else v
    return out


@torch.no_grad()
def shard_optimizer_state(tp: nn.Module, optimizer, state: Mapping[str, torch.Tensor]
                          ) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`gather_optimizer_state`: this rank's slices of
    a full-tree optimizer state."""
    from scenenet_tpu_torch.train.lbfgs import LBFGS

    mesh, axis = tp.channel_mesh, tp.channel_axis
    m, c = mesh.shape[axis], mesh.coords[axis]
    params = _optimizer_params(optimizer)
    names = _param_names(tp, params)
    if isinstance(optimizer, LBFGS):
        out = {}
        for k, v in state.items():
            if v.ndim == 0 or k == "rho":
                out[k] = v
                continue
            segs, offset = [], 0
            for n, p in zip(names, params):
                full = p.numel() * (m if n in tp.split_names else 1)
                seg = v[..., offset:offset + full]
                offset += full
                segs.append(seg[..., c * p.numel():(c + 1) * p.numel()]
                            if n in tp.split_names else seg)
            out[k] = torch.cat(segs, dim=-1)
        return out
    out = {}
    for k, v in state.items():
        i = int(k.split("/", 1)[0])
        p = params[i]
        if names[i] in tp.split_names and v.ndim == p.ndim and v.ndim > 0 \
                and v.shape[0] == p.shape[0] * m:
            v = v.narrow(0, c * p.shape[0], p.shape[0])
        out[k] = v
    return out


def _trainer(model, criterion, mesh, tau, batch_prep, precision, optimizer=None,
             data_axis="data", model_axis="model"):
    from scenenet_tpu_torch.train.loop import TrainConfig, Trainer
    from scenenet_tpu_torch.utils.logging import NullLogger

    if (data_axis, model_axis) != ("data", "model"):
        raise ValueError("the port's mesh steps take the axes 'data' and 'model', got "
                         f"{(data_axis, model_axis)}")
    trainer = Trainer(model, criterion, TrainConfig(tau=tau, precision=precision,
                                                    early_stop_metric=None),
                      logger=NullLogger(), batch_prep=batch_prep, mesh=mesh)
    return trainer


def make_gspmd_train_step(model: nn.Module, criterion, optimizer: str, mesh: Mesh, *,
                          learning_rate: float = 1e-3, tau: float = 0.65,
                          batch_prep: Optional[Callable] = None, precision: str = "f32",
                          data_axis: str = "data", model_axis: str = "model") -> Callable:
    """The (DP × channel-TP) train step on a global batch: ``step(mstate,
    *batch) -> (mstate, loss, grads)``. The optimizer (``optimizer``:
    adam, sgd, rmsprop or lbfgs, whose linesearch takes its inner products
    over the whole vector; the name, as ``TrainConfig.optimizer``) is made
    over the rank's shards; ``grads`` are
    the full gradients gathered over ``model``, by the model's parameter
    names. ``step.trainer.model`` is the full model, gathered from the
    shards by ``step.trainer.sync_model()``."""
    trainer = _trainer(model, criterion, mesh, tau, batch_prep, precision,
                       data_axis=data_axis, model_axis=model_axis)
    trainer.config.optimizer, trainer.config.learning_rate = optimizer, learning_rate
    trainer.setup_optimizer()

    def step(mstate: MetricState, *batch):
        _check_batch_divisible(int(torch.as_tensor(batch[0]).shape[0]),
                               mesh.shape[data_axis], data_axis)
        mstate, loss = trainer.train_step(mstate, *trainer.shard(batch))
        return mstate, loss, trainer.full_gradients()

    step.trainer = trainer
    return step


def make_gspmd_eval_step(model: nn.Module, criterion, mesh: Mesh, *, tau: float = 0.65,
                         batch_prep: Optional[Callable] = None, precision: str = "f32",
                         data_axis: str = "data", model_axis: str = "model") -> Callable:
    """``eval_step(mstate, *batch) -> (mstate, loss, pred)`` over a global
    batch with the model's channels over ``model``: split by rows where the
    data axis divides the batch, replicated over ``data`` for a ragged tail
    (the same function, computed whole on every rank). ``pred`` is the
    rank's rows. A stateful model evaluates on its running statistics."""
    trainer = _trainer(model, criterion, mesh, tau, batch_prep, precision,
                       data_axis=data_axis, model_axis=model_axis)
    step = trainer.sharded_eval_step
    return step
