"""Checkpoints: the JAX package's flat ``.npz`` format, read and written with
numpy.

One ``.npz`` holds every parameter under its '/'-joined path
(``geneo/cy_0/radius``, ``lambdas/lambda_cy_0``), plus an optional JSON
sidecar of metadata. A module's ``state_dict`` name is the same path
joined with '.', so a checkpoint written by either package loads into the
other.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

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
