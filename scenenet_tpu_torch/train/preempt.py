"""Preemption-safe training: a SIGTERM latch and resumable train snapshots.

PyTorch twin of :mod:`scenenet_tpu.train.preempt`:

- :class:`PreemptionGuard` latches SIGTERM (a preemption notice) without
  interrupting the step in flight; the train loops poll it at batch and
  chunk boundaries and flush a snapshot;
- :func:`save_train_snapshot` / :func:`restore_train_snapshot` keep the
  whole training state (the parameters, the optimizer's state, the step,
  the confusion counts, the running loss sum, and in place of the JAX
  package's PRNG keys the ``torch.Generator`` state and the epoch's draws)
  with an (epoch, cursor) position, so a resumed run continues
  bit-identically.

Storage rides the flat ``.npz`` format of
:func:`scenenet_tpu_torch.train.checkpoint.save_checkpoint` (atomic); the
cursor lives in the JSON sidecar, as in the JAX package.
"""

from __future__ import annotations

import json
import os
import signal
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from scenenet_tpu_torch.train.checkpoint import save_checkpoint
from scenenet_tpu_torch.train.metrics import MetricState

SNAPSHOT_NAME = "preempt.npz"

_preemption_requested = False


def request_preemption() -> None:
    """Programmatic preemption notice: the running fit flushes a snapshot
    and returns at its next batch or chunk boundary, as for SIGTERM. For
    notices that do not arrive as SIGTERM, and for tests. Cleared when the
    guarded fit exits."""
    global _preemption_requested
    _preemption_requested = True


class PreemptionGuard:
    """Context manager that latches termination signals during a fit.

    The handler only sets a flag, so the step in flight completes and the
    loop flushes at the next boundary. Off the main thread no handler can
    be installed and the guard only polls :func:`request_preemption`.
    The previous handlers are restored on exit, and the programmatic
    request cleared. ``signals`` defaults to SIGTERM alone: ^C still
    interrupts.
    """

    def __init__(self, signals=(signal.SIGTERM,)):
        self.signals = tuple(signals)
        self._latched = False
        self._previous: Dict[int, Any] = {}

    @property
    def triggered(self) -> bool:
        return self._latched or _preemption_requested

    def _handler(self, signum, frame):
        self._latched = True

    def __enter__(self) -> "PreemptionGuard":
        self._latched = False
        for s in self.signals:
            try:
                self._previous[s] = signal.signal(s, self._handler)
            except ValueError:  # not the main thread: poll-only
                pass
        return self

    def __exit__(self, *exc) -> None:
        global _preemption_requested
        _preemption_requested = False
        for s, old in self._previous.items():
            signal.signal(s, old)
        self._previous.clear()


def _sidecar(path: str) -> str:
    return (path[:-4] if path.endswith(".npz") else path) + ".json"


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def save_train_snapshot(path: str, state: Mapping[str, torch.Tensor], mstate: MetricState,
                        loss_sum, keys: Mapping[str, torch.Tensor],
                        cursor: Dict[str, Any]) -> None:
    """Persist the whole mid-training state.

    ``state`` maps name → tensor (parameters, optimizer state, the step);
    ``keys`` name → tensor (the generator's state and the epoch's draws);
    ``cursor`` is the JSON position (epoch, next chunk or batch, ...).
    """
    tree = {"state": {k: _host(v) for k, v in state.items()},
            "mstate": tuple(_host(v) for v in mstate),
            "loss_sum": _host(loss_sum),
            "keys": {k: _host(v) for k, v in keys.items()}}
    save_checkpoint(path, tree, metadata={"cursor": cursor})


def _restore(data, prefix: str, template: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The arrays under ``prefix/`` as CPU tensors of the template's dtypes;
    the names and shapes must be the template's."""
    have = {k[len(prefix) + 1:] for k in data.files if k.startswith(prefix + "/")}
    if have != set(template):
        raise ValueError(f"snapshot {prefix!r} holds {sorted(have ^ set(template))} that "
                         "the run does not, or lacks them")
    out = {}
    for k, want in template.items():
        arr = data[f"{prefix}/{k}"]
        if tuple(arr.shape) != tuple(want.shape):
            raise ValueError(f"snapshot {prefix}/{k!r}: shape {tuple(arr.shape)} != "
                             f"{tuple(want.shape)}")
        out[k] = torch.from_numpy(np.array(arr)).to(want.dtype)
    return out


def restore_train_snapshot(path: str, state_template: Mapping[str, torch.Tensor],
                           keys_template: Mapping[str, torch.Tensor]
                           ) -> Tuple[Dict[str, torch.Tensor], MetricState, torch.Tensor,
                                      Dict[str, torch.Tensor], Dict[str, Any]]:
    """Inverse of :func:`save_train_snapshot`; the templates give names,
    shapes and dtypes. Returns (state, mstate, loss_sum, keys, cursor) on
    the CPU."""
    with np.load(path) as data:
        state = _restore(data, "state", state_template)
        keys = _restore(data, "keys", keys_template)
        mstate = MetricState(*(torch.from_numpy(np.array(data[f"mstate/{i}"], np.int64))
                               for i in range(4)))
        loss_sum = torch.from_numpy(np.array(data["loss_sum"], np.float32))
    with open(_sidecar(path)) as f:
        cursor = json.load(f)["cursor"]
    return state, mstate, loss_sum, keys, cursor


def load_train_snapshot_if_compatible(path: str, state_template, keys_template,
                                      kind: str) -> Optional[Tuple]:
    """Tolerant resume: :func:`restore_train_snapshot`, or ``None`` with a
    printed line where the snapshot is unusable (a corrupt or truncated
    file, another structure, or a cursor of another fit pipeline:
    ``cursor['kind']`` is 'batch' for the per-batch loop, 'chunk' for the
    device-resident epochs). A fresh run beats a crash at resume."""
    try:
        with open(_sidecar(path)) as f:
            cursor = json.load(f)["cursor"]
        if cursor.get("kind", kind) != kind:
            print(f"[preempt] snapshot {path} was written by the '{cursor['kind']}' fit "
                  f"pipeline, this run uses '{kind}'; starting fresh")
            return None
        return restore_train_snapshot(path, state_template, keys_template)
    except Exception as exc:  # corrupt zip or sidecar, missing key, other shapes
        print(f"[preempt] snapshot {path} unusable ({type(exc).__name__}: {exc}); "
              "starting fresh")
        return None


def discard_snapshot(path: str) -> None:
    """Remove a consumed or obsolete snapshot and its sidecar; a fit that
    completes calls it, so a later launch of the experiment starts fresh."""
    for p in (path, _sidecar(path)):
        if os.path.exists(p):
            os.remove(p)


def chunk_starts(n_batches: int, n_chunks: int) -> List[Tuple[int, int]]:
    """Split ``n_batches`` into ``min(n_chunks, n_batches)`` contiguous
    chunks: a list of (start_batch, length) with at most two distinct
    lengths."""
    k = max(1, min(n_chunks, n_batches))
    base, rem = divmod(n_batches, k)
    out = []
    start = 0
    for i in range(k):
        length = base + (1 if i < rem else 0)
        out.append((start, length))
        start += length
    return out
