"""Checkpoints: the JAX package's flat ``.npz`` format, read and written with
numpy, and the per-metric top-k manager of the trainer.

One ``.npz`` holds every parameter under its '/'-joined path
(``geneo/cy_0/radius``, ``lambdas/lambda_cy_0``), plus an optional JSON
sidecar of metadata. A module's ``state_dict`` name is the same path
joined with '.', so a checkpoint written by either package loads into the
other. A quantile ensemble is stored as the JAX package stores it: the
same names, every array with a leading Q axis (the module's
``stacked_state``). A module whose tensors are laid out otherwise than the
flax module's (``UNet3D``, ``CnnBaseline``: conv kernels (out, in, k_z,
k_x, k_y) against flax's (k_z, k_x, k_y, in, out), BatchNorm statistics in
a ``batch_stats`` collection beside ``params``) gives and takes the flax
names and layouts through ``flax_state`` / ``load_flax_state``, running
statistics included.

:func:`save_checkpoint_sharded` / :func:`restore_checkpoint_sharded` write
and read a tree whose leaves may be split over a mesh's ranks, one file a
rank, in the JAX package's multi-process layout.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import warnings
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn


def path_key(path) -> str:
    """'/'-joined string key for a parameter path (dict keys, sequence
    indices, named fields)."""
    return "/".join(
        str(getattr(p, "key", getattr(p, "idx", getattr(p, "name", p))))
        for p in path
    )


def _leaves(tree: Any, prefix: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    """(path, leaf) pairs of a nested mapping/sequence of arrays."""
    if isinstance(tree, Mapping):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (i,))
    else:
        yield prefix, tree


def _module_state(module: nn.Module) -> Dict[str, torch.Tensor]:
    """The module's parameters in checkpoint layout: an ensemble's stacked
    on a leading Q axis, a flax-layout module's ``flax_state``, any other
    module's ``state_dict``."""
    for layout in ("stacked_state", "flax_state"):
        if hasattr(module, layout):
            return getattr(module, layout)()
    return module.state_dict()


def load_module_state(module: nn.Module, state: Mapping[str, torch.Tensor]) -> nn.Module:
    """Load ``state`` ('.'-joined names in checkpoint layout, as
    :func:`params_from_jax` or a checkpoint gives them) into ``module`` in
    place and return it."""
    for layout in ("load_stacked_state", "load_flax_state"):
        if hasattr(module, layout):
            getattr(module, layout)(state)
            return module
    module.load_state_dict(state)
    return module


def _flatten(tree: Any) -> Dict[str, np.ndarray]:
    if isinstance(tree, nn.Module):
        return {k.replace(".", "/"): v.detach().cpu().numpy()
                for k, v in _module_state(tree).items()}
    return {path_key(p): np.asarray(leaf) for p, leaf in _leaves(tree)}


def params_from_jax(tree: Any) -> Dict[str, torch.Tensor]:
    """The JAX package's parameter pytree (nested dicts of arrays) as a
    ``state_dict`` for the port's module: ``{"geneo": {"cy_0": {"radius":
    a}}}`` → ``{"geneo.cy_0.radius": tensor(a)}``. A quantile ensemble's
    stacked pytree gives the ``load_stacked_state`` layout, the UNet's
    variables (``params`` and ``batch_stats``) and the CNN's parameters the
    ``load_flax_state`` layout; :func:`load_module_state` takes any of them
    into its module."""
    return {".".join(str(k) for k in p): torch.from_numpy(np.array(leaf, np.float32))
            for p, leaf in _leaves(tree)}


def save_checkpoint(path: str, tree: Any, metadata: Optional[Dict] = None) -> None:
    """Write ``tree`` (an ``nn.Module`` or nested mapping of arrays).

    Atomic: written under a temporary name, then ``os.replace``d, so a
    crash mid-write never leaves a truncated checkpoint.
    """
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    stem = path[:-4] if path.endswith(".npz") else path
    tmp = stem + ".tmp.npz"
    np.savez(tmp, **_flatten(tree))
    os.replace(tmp, stem + ".npz")
    if metadata is not None:
        side = stem + ".json"
        with open(side + ".tmp", "w") as f:
            json.dump(metadata, f, indent=2, default=float)
        os.replace(side + ".tmp", side)


class CheckpointManager:
    """Per-metric top-k checkpoint retention + a ``last`` snapshot, in the
    format above (twin of :class:`scenenet_tpu.train.checkpoint.CheckpointManager`)."""

    def __init__(self, directory: str, monitors: Dict[str, str], top_k: int = 2,
                 write: bool = True):
        """``monitors`` maps metric name → 'max'|'min'. ``write=False`` keeps
        the same rankings and paths and writes nothing: a mesh's ranks but
        the first, which share its scores and read its files."""
        self.directory = directory
        self.monitors = monitors
        self.top_k = top_k
        self.write = write
        self.best: Dict[str, List[Tuple[float, str]]] = {m: [] for m in monitors}
        self._warned: set = set()
        self._seen: set = set()
        if write:
            os.makedirs(directory, exist_ok=True)

    def _better(self, metric: str, a: float, b: float) -> bool:
        return a > b if self.monitors[metric] == "max" else a < b

    def _warn_once(self, metric: str, what: str) -> None:
        if metric not in self._warned:
            self._warned.add(metric)
            warnings.warn(
                f"checkpoint monitor {metric!r} {what}; no checkpoint will be "
                f"recorded for it this epoch (warning once)", stacklevel=3)

    def step(self, tree: Any, scores: Dict[str, float], step: int) -> List[str]:
        """Record new scores; save checkpoints that enter a top-k. Returns
        the paths written.

        A non-finite score is never admitted to a top-k: once admitted, no
        finite score would ever compare better against it."""
        written = []
        for metric, mode in self.monitors.items():
            if metric not in scores:
                # absent monitors are normal for val-less fits; warn only
                # when a metric that was being recorded disappears
                if metric in self._seen:
                    self._warn_once(metric, "disappeared from the epoch scores")
                continue
            self._seen.add(metric)
            score = float(scores[metric])
            if not math.isfinite(score):
                self._warn_once(metric, f"is non-finite ({score})")
                continue
            ranked = self.best[metric]
            if len(ranked) < self.top_k or self._better(metric, score, ranked[-1][0]):
                fname = os.path.join(self.directory, f"{metric}_step{step}.npz")
                if self.write:
                    save_checkpoint(fname, tree, {"step": step, metric: score, "mode": mode})
                ranked.append((score, fname))
                ranked.sort(key=lambda t: t[0], reverse=(mode == "max"))
                while len(ranked) > self.top_k:
                    _, evicted = ranked.pop()
                    for suffix in (".npz", ".json") if self.write else ():
                        p = evicted[:-4] + suffix
                        if os.path.exists(p):
                            os.remove(p)
                written.append(fname)
        fname = os.path.join(self.directory, "last.npz")
        if self.write:
            save_checkpoint(fname, tree, {"step": step, **scores})
        written.append(fname)
        return written

    def best_path(self, metric: str) -> Optional[str]:
        ranked = self.best.get(metric)
        return ranked[0][1] if ranked else None

    def last_path(self) -> Optional[str]:
        """Path of the ``last`` snapshot if one was written."""
        p = os.path.join(self.directory, "last.npz")
        return p if os.path.exists(p) else None

    def best_score(self, metric: str) -> Optional[float]:
        ranked = self.best.get(metric)
        return ranked[0][0] if ranked else None


def restore_checkpoint(path: str, template: nn.Module) -> nn.Module:
    """Load the checkpoint at ``path`` into ``template`` in place and return
    it. Every parameter must be present with its shape."""
    state = {}
    with np.load(path) as data:
        for name, want in _module_state(template).items():
            key = name.replace(".", "/")
            if key not in data:
                raise KeyError(f"checkpoint missing parameter {key!r}")
            arr = data[key]
            if tuple(arr.shape) != tuple(want.shape):
                raise ValueError(
                    f"checkpoint {key!r}: shape {tuple(arr.shape)} != template "
                    f"{tuple(want.shape)}")
            state[name] = torch.from_numpy(np.array(arr)).to(want.dtype)
    return load_module_state(template, state)


# ---- multi-process sharded checkpoints ---------------------------------------------

@dataclasses.dataclass
class LocalShard:
    """A rank's part of a tensor split over a mesh: ``data`` is the part,
    ``index`` the slices of the global tensor it holds, ``global_shape``
    the global tensor's shape (a leaf of :func:`save_checkpoint_sharded`,
    the counterpart of a sharded ``jax.Array``'s addressable shard)."""

    data: torch.Tensor
    index: Tuple[slice, ...]
    global_shape: Tuple[int, ...]

    @classmethod
    def of(cls, global_tensor: torch.Tensor, placement) -> "LocalShard":
        """The rank's part of ``global_tensor`` under a
        :class:`~scenenet_tpu_torch.parallel.mesh.Placement`."""
        index = [slice(None)] * global_tensor.ndim
        for dim, axis in ((0, placement.batch_axis), (2, placement.space_axis)):
            if axis is None or dim >= global_tensor.ndim or placement.mesh.shape[axis] == 1:
                continue
            if dim == 2 and global_tensor.ndim < 5:
                continue
            size = global_tensor.shape[dim] // placement.mesh.shape[axis]
            start = placement.mesh.coords[axis] * size
            index[dim] = slice(start, start + size)
        return cls(placement(global_tensor), tuple(index), tuple(global_tensor.shape))


def _process() -> Tuple[int, int]:
    """(this process's rank, the process count) of the process group."""
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _shard_leaves(tree: Any, prefix: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    """:func:`_leaves`, a :class:`LocalShard` being a leaf."""
    if isinstance(tree, LocalShard):
        yield prefix, tree
    elif isinstance(tree, Mapping):
        for k in sorted(tree):
            yield from _shard_leaves(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _shard_leaves(v, prefix + (i,))
    else:
        yield prefix, tree


def save_checkpoint_sharded(path_prefix: str, tree: Any,
                            metadata: Optional[Dict] = None) -> str:
    """Save a tree whose leaves may be split over a mesh's ranks: each rank
    writes only its own parts, with no gather. The JAX package's layout:
    ``{path_prefix}.proc{K}.npz`` a rank, its entries ``<key>@<ordinal>``
    for a device tensor (a rank has one device, so the ordinal is 0; a
    :class:`LocalShard` is the rank's part, a plain tensor a replica) and
    ``<key>@r`` for a host array or scalar, which every file carries;
    ``{path_prefix}.proc{K}.index.json``, each entry's slices of the global
    array; and from the first rank ``{path_prefix}.meta.json`` (the process
    count, the global shapes, ``metadata``). Restore under the same mesh
    and process count with :func:`restore_checkpoint_sharded`."""
    pid, count = _process()
    flat: Dict[str, np.ndarray] = {}
    index_meta: Dict[str, Any] = {}
    shapes: Dict[str, Any] = {}
    for path, leaf in _shard_leaves(tree):
        key = path_key(path)
        if isinstance(leaf, LocalShard):
            shapes[key] = list(leaf.global_shape)
            flat[f"{key}@0"] = leaf.data.detach().cpu().numpy()
            index_meta[f"{key}@0"] = [[sl.start, sl.stop] for sl in leaf.index]
        elif torch.is_tensor(leaf):
            shapes[key] = list(leaf.shape)
            flat[f"{key}@0"] = leaf.detach().cpu().numpy()
            index_meta[f"{key}@0"] = [[None, None] for _ in range(leaf.ndim)]
        else:
            shapes[key] = list(np.shape(leaf))
            flat[f"{key}@r"] = np.asarray(leaf)
    os.makedirs(os.path.dirname(path_prefix) or ".", exist_ok=True)
    np.savez(f"{path_prefix}.proc{pid}.npz", **flat)
    with open(f"{path_prefix}.proc{pid}.index.json", "w") as f:
        json.dump(index_meta, f)
    if pid == 0:
        with open(f"{path_prefix}.meta.json", "w") as f:
            json.dump({"process_count": count, "shapes": shapes, "metadata": metadata or {}},
                      f, default=float)
    return f"{path_prefix}.proc{pid}.npz"


def restore_checkpoint_sharded(path_prefix: str, template: Any) -> Any:
    """Inverse of :func:`save_checkpoint_sharded`: ``template`` gives the
    structure and each leaf's place (a :class:`LocalShard` the rank's part,
    a tensor its device and dtype). Each rank reads only its own file; a
    checkpoint written by another process count raises."""
    pid, count = _process()
    with open(f"{path_prefix}.meta.json") as f:
        meta = json.load(f)
    if meta["process_count"] != count:
        raise ValueError(f"checkpoint written by {meta['process_count']} processes, "
                         f"restoring under {count}")
    with np.load(f"{path_prefix}.proc{pid}.npz") as data:
        def restore(path, leaf):
            key = path_key(path)
            if f"{key}@r" in data:
                return np.asarray(data[f"{key}@r"], dtype=np.asarray(leaf).dtype)
            entry = f"{key}@0"
            if entry not in data:
                raise KeyError(f"checkpoint missing shard {entry!r}")
            if isinstance(leaf, LocalShard):
                part = torch.from_numpy(np.array(data[entry])).to(leaf.data.device,
                                                                   leaf.data.dtype)
                return LocalShard(part, leaf.index, leaf.global_shape)
            if not torch.is_tensor(leaf):
                raise KeyError(f"checkpoint has a device entry for {key!r} but the "
                               "template leaf is no tensor")
            return torch.from_numpy(np.array(data[entry])).to(leaf.device, leaf.dtype)

        return _rebuild(template, restore)


def _rebuild(tree: Any, fn, prefix: Tuple = ()) -> Any:
    """``tree`` with each leaf (a :class:`LocalShard` being one) replaced by
    ``fn(path, leaf)``."""
    if isinstance(tree, LocalShard):
        return fn(prefix, tree)
    if isinstance(tree, Mapping):
        return {k: _rebuild(tree[k], fn, prefix + (k,)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, fn, prefix + (i,)) for i, v in enumerate(tree))
    return fn(prefix, tree)
