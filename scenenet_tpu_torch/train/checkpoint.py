"""Checkpoints: the JAX package's flat ``.npz`` format, read and written with
numpy, and the per-metric top-k manager of the trainer.

One ``.npz`` holds every parameter under its '/'-joined path
(``geneo/cy_0/radius``, ``lambdas/lambda_cy_0``), plus an optional JSON
sidecar of metadata. A module's ``state_dict`` name is the same path
joined with '.', so a checkpoint written by either package loads into the
other.
"""

from __future__ import annotations

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


def _flatten(tree: Any) -> Dict[str, np.ndarray]:
    if isinstance(tree, nn.Module):
        return {k.replace(".", "/"): v.detach().cpu().numpy()
                for k, v in tree.state_dict().items()}
    return {path_key(p): np.asarray(leaf) for p, leaf in _leaves(tree)}


def params_from_jax(tree: Any) -> Dict[str, torch.Tensor]:
    """The JAX package's parameter pytree (nested dicts of arrays) as a
    ``state_dict`` for the port's module: ``{"geneo": {"cy_0": {"radius":
    a}}}`` → ``{"geneo.cy_0.radius": tensor(a)}``."""
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

    def __init__(self, directory: str, monitors: Dict[str, str], top_k: int = 2):
        """``monitors`` maps metric name → 'max'|'min'."""
        self.directory = directory
        self.monitors = monitors
        self.top_k = top_k
        self.best: Dict[str, List[Tuple[float, str]]] = {m: [] for m in monitors}
        self._warned: set = set()
        self._seen: set = set()
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
                save_checkpoint(fname, tree, {"step": step, metric: score, "mode": mode})
                ranked.append((score, fname))
                ranked.sort(key=lambda t: t[0], reverse=(mode == "max"))
                while len(ranked) > self.top_k:
                    _, evicted = ranked.pop()
                    for suffix in (".npz", ".json"):
                        p = evicted[:-4] + suffix
                        if os.path.exists(p):
                            os.remove(p)
                written.append(fname)
        fname = os.path.join(self.directory, "last.npz")
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
        for name, want in template.state_dict().items():
            key = name.replace(".", "/")
            if key not in data:
                raise KeyError(f"checkpoint missing parameter {key!r}")
            arr = data[key]
            if tuple(arr.shape) != tuple(want.shape):
                raise ValueError(
                    f"checkpoint {key!r}: shape {tuple(arr.shape)} != template "
                    f"{tuple(want.shape)}")
            state[name] = torch.from_numpy(np.array(arr)).to(want.dtype)
    template.load_state_dict(state)
    return template
