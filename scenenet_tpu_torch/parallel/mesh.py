"""The mesh of ranks and its collectives, on ``torch.distributed``.

Counterpart of :mod:`scenenet_tpu.parallel.mesh`. A JAX mesh is a grid of
devices inside one program; here it is a grid of ranks, one process a
device, over a process group that is already initialised
(:func:`scenenet_tpu_torch.parallel.launch.init_from_env`). The axes are
the JAX package's:

- ``data``: the batch is split over it (the reference's DDP);
- ``space``: the voxel grid's Z axis is split over it, and the SAME conv
  exchanges halo planes with the ±1 neighbours
  (:mod:`scenenet_tpu_torch.parallel.spatial`);
- ``model``: the quantile ensemble's members
  (:mod:`~scenenet_tpu_torch.parallel.ep`) or the conv stacks' output
  channels (:mod:`~scenenet_tpu_torch.parallel.gspmd`) are split over it;
- ``stage``: a conv stack's depth, one stage a rank
  (:mod:`~scenenet_tpu_torch.parallel.pp`).

Every line of ranks along a set of axes gets its own ``dist.new_group``,
made by every rank in one order, so that a collective names its axes as
``lax.psum`` does. The collectives here (:func:`psum`, :func:`pmean`,
:func:`shift`, :func:`all_gather`) are differentiable where JAX's are
transposed: the backward of a sum over ranks sums the cotangents over the
same ranks, the backward of a shift shifts the cotangent back to the rank
that sent the planes, and the backward of a gather is a reduce-scatter.

The backend is the caller's choice and nothing switches it: NCCL takes
device tensors as they are; gloo has no point-to-point for CUDA tensors,
so under gloo a CUDA tensor is copied to the host, exchanged, and copied
back, explicitly.
"""

from __future__ import annotations

import contextlib
import itertools
import math
import os
from typing import Dict, Iterable, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

Axes = Union[str, Sequence[str]]

_CURRENT: Optional["Mesh"] = None


class Mesh:
    """A named grid of ranks.

    ``devices`` is the grid of global ranks (the JAX name: ``mesh.devices``
    is the device grid there), ``shape`` maps each axis to its size, and
    ``coords`` gives this rank's place on each axis. ``device`` is the
    torch device this rank computes on. A mesh of one rank needs no process
    group; a larger one needs an initialised group of exactly its size.
    """

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 device: "torch.device | str | None" = None):
        devices = np.asarray(devices, dtype=np.int64)
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{len(axis_names)} axis names for a {devices.ndim}-d grid")
        if sorted(devices.reshape(-1).tolist()) != list(range(devices.size)):
            raise ValueError(f"the grid must hold the ranks 0..{devices.size - 1} once each")
        self.devices = devices
        self.axis_names = axis_names
        self.shape: Dict[str, int] = dict(zip(axis_names, devices.shape))
        if devices.size > 1:
            if not dist.is_initialized():
                raise RuntimeError(f"a mesh of {devices.size} ranks needs an initialised "
                                   "process group (parallel.launch.init_from_env, under "
                                   "python -m torch.distributed.run)")
            if dist.get_world_size() != devices.size:
                raise ValueError(f"mesh {self.shape} = {devices.size} ranks, but the "
                                 f"process group has {dist.get_world_size()}")
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        self.backend = dist.get_backend() if dist.is_initialized() else None
        where = np.argwhere(devices == self.rank)[0]
        self.coords: Dict[str, int] = {a: int(c) for a, c in zip(axis_names, where)}
        self.device = torch.device(device) if device is not None else _default_device()
        # frozenset of axes -> the process group of this rank's line along them;
        # new_group is collective over the whole world, so every rank makes
        # every line's group, in the same order, and keeps its own
        self._groups: Dict[frozenset, Optional[object]] = {}
        for k in range(1, len(axis_names) + 1):
            for axes in itertools.combinations(axis_names, k):
                size = math.prod(self.shape[a] for a in axes)
                idx = [axis_names.index(a) for a in axes]
                rest = [i for i in range(len(axis_names)) if i not in idx]
                lines = np.transpose(devices, rest + idx).reshape(-1, size)
                for line in lines:
                    group = dist.new_group(line.tolist()) if size > 1 else None
                    if self.rank in line:
                        self._groups[frozenset(axes)] = group

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_size(self, axes: Axes) -> int:
        return math.prod(self.shape[a] for a in _axes(axes))

    def group(self, axes: Axes):
        """The process group of the line through this rank along ``axes``;
        None where the line is this rank alone."""
        axes = frozenset(a for a in _axes(axes) if self.shape[a] > 1)
        return self._groups[axes] if axes else None

    def line(self, axis: str) -> list:
        """The global ranks of the line through this rank along ``axis``, in
        the order of their coordinate."""
        where = [self.coords[a] for a in self.axis_names]
        i = self.axis_names.index(axis)
        return [int(self.devices[tuple(where[:i] + [c] + where[i + 1:])])
                for c in range(self.shape[axis])]

    def neighbour(self, axis: str, offset: int) -> Optional[int]:
        """The global rank ``offset`` steps along ``axis``, None past an end."""
        c = self.coords[axis] + offset
        if not 0 <= c < self.shape[axis]:
            return None
        where = [self.coords[a] for a in self.axis_names]
        where[self.axis_names.index(axis)] = c
        return int(self.devices[tuple(where)])

    @contextlib.contextmanager
    def active(self):
        """Make this the mesh the collectives use where none is named (a
        criterion's ``axis_names``, a BatchNorm's ``axis_name``) inside the
        block, as a ``shard_map`` binds its axis names."""
        global _CURRENT
        before, _CURRENT = _CURRENT, self
        try:
            yield self
        finally:
            _CURRENT = before

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank {self.rank} at {self.coords}, {self.backend})"


def _axes(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _default_device() -> torch.device:
    """The card of this rank (``LOCAL_RANK`` modulo the cards seen) where
    there is one, else the CPU."""
    if torch.cuda.is_available():
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))
                            % torch.cuda.device_count())
    return torch.device("cpu")


def current_mesh() -> "Mesh":
    if _CURRENT is None:
        raise RuntimeError("no mesh is active: a collective named by axis runs inside "
                           "`with mesh.active():` (the Trainer enters it for its mesh)")
    return _CURRENT


def _resolve(mesh: Optional[Mesh]) -> Mesh:
    return mesh if mesh is not None else current_mesh()


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = ("data", "space"),
              devices: Optional[Sequence[int]] = None,
              device: "torch.device | str | None" = None) -> Mesh:
    """A mesh over the ranks of the process group (``make_mesh`` of the JAX
    package): by default every rank on ``data`` and size 1 on the other
    axes; ``shape=(2, 4)`` is 2-way DP × 4-way spatial on 8 ranks. The
    grid is the ranks in order, reshaped (the JAX package's layout off
    the TPU), or ``devices`` in the caller's order. The new mesh is made
    active."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    ranks = list(devices) if devices is not None else list(range(world))
    if shape is None:
        shape = (len(ranks),) + (1,) * (len(axis_names) - 1)
    if math.prod(shape) != len(ranks):
        raise ValueError(f"mesh shape {tuple(shape)} != {len(ranks)} devices")
    mesh = Mesh(np.asarray(ranks).reshape(shape), axis_names, device)
    global _CURRENT
    _CURRENT = mesh
    return mesh


def hybrid_rank_grid(dcn_shape: Tuple[int, ...], ici_shape: Tuple[int, ...],
                     ranks: Sequence[int]) -> np.ndarray:
    """The rank grid of a hybrid mesh: ``prod(dcn_shape)`` contiguous
    blocks of ranks are the slices, each laid out as ``ici_shape``, and the
    blocks are stacked by ``dcn_shape`` as the outer factor of each axis
    (``mesh_utils.create_hybrid_device_mesh``'s composition, which the JAX
    package also uses to emulate slices on one host)."""
    n_groups = math.prod(dcn_shape)
    if len(ranks) % n_groups:
        raise ValueError(f"{len(ranks)} devices not divisible into {n_groups} emulated slices")
    per = len(ranks) // n_groups
    ici = [np.asarray(ranks[g * per:(g + 1) * per]).reshape(ici_shape)
           for g in range(n_groups)]
    blocks = np.empty(dcn_shape, dtype=object)
    for g, idx in enumerate(np.ndindex(*dcn_shape)):
        blocks[idx] = ici[g]
    return np.block(blocks.tolist())


def make_hybrid_mesh(dcn_shape: Tuple[int, ...], ici_shape: Tuple[int, ...],
                     axis_names: Sequence[str] = ("data", "space"),
                     devices: Optional[Sequence[int]] = None,
                     device: "torch.device | str | None" = None) -> Mesh:
    """A mesh whose leading (DCN) factor of each axis crosses slices and
    whose trailing (ICI) factor stays inside one (``make_hybrid_mesh`` of
    the JAX package). A slice is a node: ``torch.distributed.run`` numbers
    ranks node by node, so the contiguous blocks of ``LOCAL_WORLD_SIZE``
    ranks are the nodes. On one node the slices are emulated by contiguous
    blocks of ranks, as JAX emulates them on its CPU backend; the rank
    order is JAX's device order for the same shapes. The standard shape is
    DP across slices and spatial sharding inside one::

        make_hybrid_mesh(dcn_shape=(n_nodes, 1), ici_shape=(dp_per_node, space))
    """
    dcn_shape, ici_shape = tuple(dcn_shape), tuple(ici_shape)
    if len(dcn_shape) != len(ici_shape):
        raise ValueError(f"dcn_shape {dcn_shape} and ici_shape {ici_shape} "
                         "must have one factor per mesh axis")
    if len(dcn_shape) != len(axis_names):
        raise ValueError(f"{len(axis_names)} axis names for {len(dcn_shape)}-axis shapes")
    world = dist.get_world_size() if dist.is_initialized() else 1
    ranks = list(devices) if devices is not None else list(range(world))
    total = math.prod(dcn_shape) * math.prod(ici_shape)
    if total != len(ranks):
        raise ValueError(f"hybrid mesh {dcn_shape}x{ici_shape} needs {total} devices, "
                         f"have {len(ranks)}")
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    per = len(ranks) // math.prod(dcn_shape)
    if local < world and per != local:
        raise ValueError(f"a slice is a node of {local} ranks; the hybrid mesh "
                         f"{dcn_shape}x{ici_shape} makes slices of {per}")
    mesh = Mesh(hybrid_rank_grid(dcn_shape, ici_shape, ranks), axis_names, device)
    global _CURRENT
    _CURRENT = mesh
    return mesh


# ---- placement -----------------------------------------------------------------

class Placement:
    """Where a rank's part of a (B, C, Z, X, Y) batch lies: its rows along
    ``batch_axis`` and, with ``space_axis``, its z slab (the counterpart of a
    ``NamedSharding``). ``placement(t)`` is the rank's part of the global
    tensor ``t``; tensors of fewer than 5 dimensions are split by rows
    only. No axis: the whole tensor (replicated)."""

    def __init__(self, mesh: Mesh, batch_axis: Optional[str] = "data",
                 space_axis: Optional[str] = None):
        self.mesh = mesh
        self.batch_axis = batch_axis
        self.space_axis = space_axis if space_axis in mesh.shape else None

    def part(self, t: torch.Tensor, dim: int, axis: Optional[str]) -> torch.Tensor:
        """This rank's equal share of ``t`` along ``dim`` over ``axis``."""
        if axis is None or self.mesh.shape.get(axis, 1) == 1:
            return t
        n = self.mesh.shape[axis]
        if t.shape[dim] % n:
            if axis == self.space_axis:
                raise ValueError(f"grid Z extent {t.shape[dim]} not divisible by mesh "
                                 f"'{axis}' axis ({n})")
            raise ValueError(f"batch {t.shape[dim]} not divisible by mesh '{axis}' axis "
                             f"({n}); use drop_last or a divisible batch size")
        size = t.shape[dim] // n
        return t.narrow(dim, self.mesh.coords[axis] * size, size)

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        t = self.part(t, 0, self.batch_axis)
        if t.ndim >= 5:
            t = self.part(t, 2, self.space_axis)
        return t


def batch_sharding(mesh: Mesh, batch_axis: str = "data",
                   space_axis: Optional[str] = None) -> Placement:
    """B over ``batch_axis``, optionally Z over ``space_axis``."""
    return Placement(mesh, batch_axis, space_axis)


def replicated_sharding(mesh: Mesh) -> Placement:
    return Placement(mesh, None, None)


# ---- collectives -----------------------------------------------------------------

def _staged(t: torch.Tensor, backend: Optional[str]) -> bool:
    """Whether ``t`` goes through the host: gloo takes no CUDA tensor in
    point-to-point and stages it in collectives itself, so the layer copies
    explicitly, in both."""
    return backend == "gloo" and t.is_cuda


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM,
               backend: Optional[str] = None) -> torch.Tensor:
    """A reduced copy of ``t`` over ``group`` (``t`` is left as it was).
    Every rank of the group gets the same bits."""
    backend = backend if backend is not None else dist.get_backend(group)
    if _staged(t, backend):
        host = t.detach().to("cpu", copy=True)
        dist.all_reduce(host, op=op, group=group)
        return host.to(t.device)
    out = t.detach().clone()
    dist.all_reduce(out, op=op, group=group)
    return out


class _PSum(torch.autograd.Function):
    """Σ over the ranks of a line; its backward sums the cotangents over
    the same ranks (the transpose of ``lax.psum`` in a ``shard_map``)."""

    @staticmethod
    def forward(ctx, x, group, backend):
        ctx.group, ctx.backend = group, backend
        return all_reduce(x, group, backend=backend)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), ctx.group, backend=ctx.backend), None, None


def psum(x: torch.Tensor, axes: Axes, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``axes`` (``lax.psum``),
    differentiable; ``x`` itself on an axis of one rank."""
    mesh = _resolve(mesh)
    group = mesh.group(axes)
    if group is None:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _PSum.apply(x, group, mesh.backend)
    return all_reduce(x, group, backend=mesh.backend)


def pmean(x: torch.Tensor, axes: Axes, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Mean of ``x`` over the ranks of ``axes`` (``lax.pmean``)."""
    mesh = _resolve(mesh)
    n = mesh.axis_size(tuple(a for a in _axes(axes)))
    return psum(x, axes, mesh) / n if n > 1 else x


def _gather(x: torch.Tensor, axis: str, dim: int, mesh: Mesh) -> torch.Tensor:
    """Every rank's ``x`` on the line along ``axis``, concatenated along
    ``dim`` in coordinate order. ``dist.all_gather`` fills its list in the
    group's rank order, which is the sorted global ranks (``new_group``
    sorts them); a hybrid mesh's lines need not be in that order."""
    line = mesh.line(axis)
    staged = _staged(x, mesh.backend)
    send = x.detach().to("cpu", copy=True) if staged else x.detach().contiguous()
    parts = [torch.empty_like(send) for _ in line]
    dist.all_gather(parts, send, group=mesh.group(axis))
    by_rank = dict(zip(sorted(line), parts))
    out = torch.cat([by_rank[r] for r in line], dim)
    return out.to(x.device) if staged else out


class _AllGather(torch.autograd.Function):
    """The gather of :func:`all_gather`; its backward is this rank's slice
    of the cotangent, summed over the line first where ``reduce`` says (a
    reduce-scatter, staged as an all-reduce and a slice)."""

    @staticmethod
    def forward(ctx, x, axis, dim, mesh, reduce):
        ctx.axis, ctx.dim, ctx.mesh, ctx.reduce = axis, dim, mesh, reduce
        return _gather(x, axis, dim, mesh)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim = ctx.mesh, ctx.axis, ctx.dim
        if ctx.reduce:
            g = all_reduce(g.contiguous(), mesh.group(axis), backend=mesh.backend)
        size = g.shape[dim] // mesh.shape[axis]
        return g.narrow(dim, mesh.coords[axis] * size, size).contiguous(), None, None, None, None


def all_gather(x: torch.Tensor, axis: str, dim: int = 1, mesh: Optional[Mesh] = None,
               reduce_backward: bool = True) -> torch.Tensor:
    """The ranks' ``x`` along ``axis`` concatenated along ``dim`` in
    coordinate order (``lax.all_gather(..., tiled=True)``), differentiable.

    ``reduce_backward`` (the transpose of the gather) sums the cotangents of
    the whole line and keeps this rank's slice: right where each rank's
    consumers of the gathered tensor contribute a part of its cotangent (a
    conv that computes this rank's output channels from every input
    channel). Where the consumer is computed identically on every rank (a
    replicated head and loss), every rank already holds the whole
    cotangent, and a sum would count it once a rank: there
    ``reduce_backward=False`` keeps the slice alone."""
    mesh = _resolve(mesh)
    if mesh.shape[axis] == 1:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllGather.apply(x, axis, dim, mesh, reduce_backward)
    return _gather(x, axis, dim, mesh)


def all_reduce_mean_(tensors: Iterable[torch.Tensor], axes: Axes,
                     mesh: Optional[Mesh] = None, mean_over: Optional[Axes] = None) -> None:
    """Replace each tensor by its mean over ``axes``, in place, in one
    collective over their concatenation: the DDP gradient reduction.
    ``mean_over`` (a part of ``axes``) divides by those axes' size alone:
    the sum over the others and the mean over these, ``pmean(psum(t,
    others), mean_over)``."""
    mesh = _resolve(mesh)
    group = mesh.group(axes)
    tensors = list(tensors)
    if group is None or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    n = mesh.axis_size(axes if mean_over is None else mean_over)
    flat = all_reduce(flat, group, backend=mesh.backend)
    if n > 1:
        flat = flat / n
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def broadcast_(tensors: Iterable[torch.Tensor], mesh: Optional[Mesh] = None,
               src: int = 0) -> None:
    """Overwrite each tensor in place with global rank ``src``'s."""
    mesh = _resolve(mesh)
    if mesh.size == 1:
        return
    for t in tensors:
        # gloo stages CUDA tensors through the host, NCCL host tensors through the card
        staged = (t.detach().to("cpu", copy=True) if _staged(t, mesh.backend)
                  else t.detach().to(mesh.device, copy=True)
                  if mesh.backend == "nccl" and not t.is_cuda else None)
        if staged is None:
            dist.broadcast(t.detach(), src)
        else:
            dist.broadcast(staged, src)
            t.copy_(staged.to(t.device))


def any_rank(flag: bool, mesh: Optional[Mesh] = None) -> bool:
    """Whether ``flag`` holds on any rank (one small collective): the ranks
    of a fit take their decisions together, or their collectives hang."""
    mesh = _resolve(mesh)
    if mesh.size == 1:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int64)
    if mesh.backend == "nccl":
        t = t.to(mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(int(t.item()))


def barrier(mesh: Optional[Mesh] = None) -> None:
    mesh = _resolve(mesh)
    if mesh.size > 1:
        if mesh.backend == "nccl":
            dist.barrier(device_ids=[mesh.device.index or 0])
        else:
            dist.barrier()


class PendingShift:
    """A shift whose transfers are posted and not yet waited on: the
    overlapped halo conv launches its interior conv in between."""

    def __init__(self, x: torch.Tensor, axis: str, offset: int, mesh: Mesh):
        self.x, self.axis, self.offset, self.mesh = x, axis, offset, mesh
        src, dst = mesh.neighbour(axis, -offset), mesh.neighbour(axis, offset)
        staged = _staged(x, mesh.backend)
        send = x.detach().to("cpu", copy=True) if staged else x.detach().contiguous()
        self.recv = torch.zeros_like(send) if src is not None else None
        # one tag a direction: the two halo exchanges of a conv may be in flight at once
        tag = 1 if offset > 0 else 2
        ops = []
        if dst is not None:
            ops.append(dist.P2POp(dist.isend, send, dst, tag=tag))
        if src is not None:
            ops.append(dist.P2POp(dist.irecv, self.recv, src, tag=tag))
        self._send = send  # kept alive until the transfer is waited on
        self.works = dist.batch_isend_irecv(ops) if ops else []
        self.staged = staged

    def wait(self) -> torch.Tensor:
        for w in self.works:
            w.wait()
        if self.recv is None:  # the axis's first rank: SAME's zero padding
            return torch.zeros_like(self.x)
        return self.recv.to(self.x.device) if self.staged else self.recv


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, offset, mesh, pending):
        ctx.axis, ctx.offset, ctx.mesh = axis, offset, mesh
        if pending is None:
            pending = PendingShift(x, axis, offset, mesh)
        return pending.wait()

    @staticmethod
    def backward(ctx, g):
        # the cotangent of the received planes goes back to the rank that sent them
        return (PendingShift(g.contiguous(), ctx.axis, -ctx.offset, ctx.mesh).wait(),
                None, None, None, None)


def shift(x: torch.Tensor, axis: str, offset: int = 1, mesh: Optional[Mesh] = None,
          pending: Optional[PendingShift] = None) -> torch.Tensor:
    """``lax.ppermute`` to the neighbour ``offset`` (±1) along ``axis``: each
    rank sends ``x`` to coordinate c + offset and returns what coordinate
    c − offset sent; the rank with no sender returns zeros.
    Differentiable: the backward shifts the cotangent by −offset.
    ``pending``, from :class:`PendingShift` on the same ``x``, waits on
    transfers posted earlier."""
    mesh = _resolve(mesh)
    if abs(offset) != 1:
        raise ValueError(f"shift offset must be +1 or -1, got {offset}")
    if mesh.shape[axis] == 1:
        return torch.zeros_like(x)
    return _Shift.apply(x, axis, offset, mesh, pending)


def ensure_replicated(tensors: Iterable[torch.Tensor], mesh: Mesh) -> None:
    """The one-time broadcast at fit start of the parameters, the buffers
    and the optimizer state from rank 0: every rank starts from the same
    bits. (In the JAX package this placed the carried state on the
    replicated sharding once, for XLA's compile cache.)"""
    broadcast_(tensors, mesh, src=int(mesh.devices.reshape(-1)[0]))
