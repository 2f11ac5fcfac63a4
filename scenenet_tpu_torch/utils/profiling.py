"""Profiling / tracing hooks: a ``torch.profiler`` trace for TensorBoard,
wall-clock step timers and the cards' memory counters.

PyTorch twin of :mod:`scenenet_tpu.utils.profiling`, where ``trace`` is a
``jax.profiler`` trace and the memory counters are each device's
``memory_stats()``.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Capture a ``torch.profiler`` trace of the host and, where a card is
    visible, the device, written under ``log_dir`` as a TensorBoard trace
    (``*.pt.trace.json``) when the block ends."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


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
