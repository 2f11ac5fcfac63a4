"""Profiling / tracing hooks: spans and set-up phases on the profiler's
clock, a ``torch.profiler`` trace for TensorBoard, wall-clock step and
stage timers and the cards' memory counters.

PyTorch twin of :mod:`scenenet_tpu.utils.profiling`, where ``trace`` is a
``jax.profiler`` trace and the memory counters are each device's
``memory_stats()``.

The port's spans and phases are named ``snt/<layer>/<what>``:

- :func:`span` marks hot-path work (a train step, a loader wait, a served
  dispatch). While a ``torch.profiler`` runs it is a ``record_function``
  range, in the same trace as the device's kernels, so every idle gap of
  the card can be put down to the span open on the host; otherwise it is
  one shared no-op context, which reads no clock.
- :func:`phase` marks one-off set-up work; its host-clock seconds add up
  by name, process-wide (:func:`phase_seconds`), and it is a span too.

A profiler records the ranges of the thread that started it (and of
autograd's threads, which it follows); a span entered on another Python
thread is in no trace, so the serving threads keep :class:`Stage`
aggregates instead.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch

_NO_SPAN = contextlib.nullcontext()
_PHASES: Dict[str, float] = defaultdict(float)
_PHASES_LOCK = threading.Lock()


def span(name: str):
    """A ``record_function`` range named ``name`` while a profiler runs,
    else a shared no-op context (no range made, no clock read)."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


@contextlib.contextmanager
def phase(name: str) -> Iterator[None]:
    """One-off set-up work: its host-clock seconds added to
    ``phase_seconds()[name]`` (no synchronise: the card's queued work is
    not waited for), and a span while a profiler runs."""
    t0 = time.perf_counter()
    try:
        with span(name):
            yield
    finally:
        seconds = time.perf_counter() - t0
        with _PHASES_LOCK:
            _PHASES[name] += seconds


def phase_seconds() -> Dict[str, float]:
    """Seconds spent in each phase by name, since the process started."""
    with _PHASES_LOCK:
        return dict(_PHASES)


@contextlib.contextmanager
def trace(log_dir: str, file: Optional[str] = None) -> Iterator[torch.profiler.profile]:
    """Capture a ``torch.profiler`` trace of the host and, where a card is
    visible, the device, written when the block ends under ``log_dir``: as
    a TensorBoard trace (``*.pt.trace.json``), or with ``file`` as the one
    chrome trace ``log_dir/file``."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    handler = tensorboard_trace_handler(log_dir) if file is None else None
    with profile(activities=activities, on_trace_ready=handler) as prof:
        yield prof
    if file is not None:
        prof.export_chrome_trace(os.path.join(log_dir, file))


class Stage:
    """Count, sum and max of the host-clock seconds of one stage of work,
    under its own lock: for stages on threads that no profiler follows."""

    def __init__(self):
        self._lock = threading.Lock()
        self.count, self.total_s, self.max_s = 0, 0.0, 0.0

    def add(self, seconds: float, n: int = 1) -> None:
        """``n`` passes of ``seconds`` each (a stage that a batch of ``n``
        requests went through together)."""
        with self._lock:
            self.count += n
            self.total_s += seconds * n
            self.max_s = max(self.max_s, seconds)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return {"count": self.count, "sum_s": self.total_s, "max_s": self.max_s}


class StepTimer:
    """Rolling wall-clock step timing (mirrors the reference's ad-hoc
    timing in ``GENEO_kernel_torch.convolution``). Time a card's work after
    a ``torch.cuda.synchronize()``: PyTorch returns before the card ends."""

    def __init__(self, window: int = 50):
        self.window = window
        self.times: list[float] = []
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        assert self._t0 is not None, "start() first"
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        self._t0 = None
        return dt

    def stats(self) -> Dict[str, float]:
        if not self.times:
            return {}
        ts = sorted(self.times)
        return {
            "mean_s": sum(ts) / len(ts),
            "p50_s": ts[len(ts) // 2],
            "max_s": ts[-1],
        }


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """Each visible card's allocator counters (``torch.cuda.memory_stats``),
    the integer ``*bytes*`` keys only, by device name (``cuda:0``); empty
    without a card, as the JAX function is on a backend without them."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        if stats:
            out[f"cuda:{i}"] = {k: v for k, v in stats.items()
                                if "bytes" in k and isinstance(v, int)}
    return out
