"""A ``torch.profiler`` trace of a traced run's window, reduced to what the
per-layer metrics read: the device's operations, the host's runtime calls,
the harness's own annotations, the busy time and the idle gaps.

The trace is written under the run's ``TMPDIR`` and deleted once read.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the runtime calls by which the host starts work on the card, as the profiler names them
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                     "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemsetAsync",
                     "cudaMemcpyAsync")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")


class Trace:
    """The events of one traced window (µs on the profiler's clock)."""

    def __init__(self, events: List[dict], window_s: float):
        self.window_s = window_s
        self.device = sorted((e for e in events if e.get("cat") in DEVICE_CATS
                              and e.get("ph") == "X"), key=lambda e: e["ts"])
        self.host = [e for e in events if e.get("cat") in HOST_CATS and e.get("ph") == "X"]

    def kernel_seconds(self, pattern: "re.Pattern | str") -> float:
        """Device seconds of the kernels whose name matches ``pattern``."""
        pat = re.compile(pattern) if isinstance(pattern, str) else pattern
        return sum(e["dur"] for e in self.device
                   if e["cat"] == "kernel" and pat.search(e["name"])) * 1e-6

    def runtime_calls(self, names=HOST_LAUNCH_CALLS) -> int:
        return sum(1 for e in self.host if e.get("cat") in ("cuda_runtime", "cuda_driver")
                   and e["name"] in names)

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device (the union of
        their intervals)."""
        total, end = 0.0, None
        start = None
        for e in self.device:
            s, f = e["ts"], e["ts"] + e["dur"]
            if end is None or s > end:
                if end is not None:
                    total += end - start
                start, end = s, f
            else:
                end = max(end, f)
        if end is not None:
            total += end - start
        return total * 1e-6

    def device_ops(self, top: int = 10) -> List[Tuple[str, float]]:
        """The device operations that took the most time, by name."""
        acc: Dict[str, float] = defaultdict(float)
        for e in self.device:
            acc[short(e["name"])] += e["dur"] * 1e-6
        return sorted(acc.items(), key=lambda kv: -kv[1])[:top]

    def idle_gaps(self, top: int = 10) -> List[Tuple[str, float]]:
        """The longest stretches with nothing on the device, each named by
        the innermost host event that covers its middle."""
        gaps, end = [], None
        for e in self.device:
            if end is not None and e["ts"] > end:
                gaps.append((end, e["ts"]))
            end = e["ts"] + e["dur"] if end is None else max(end, e["ts"] + e["dur"])
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, f in gaps[:top]:
            mid = (s + f) / 2
            cover = [e for e in self.host if e["ts"] <= mid <= e["ts"] + e["dur"]]
            name = min(cover, key=lambda e: e["dur"])["name"] if cover else "no host event"
            out.append((short(name), (f - s) * 1e-6))
        return out


def short(name: str) -> str:
    """An operation's name without its argument list (template arguments
    kept, at most 100 characters)."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    return name.strip()[:100]


class Phases:
    """Host-clock lengths of the named parts of a set-up, in order."""

    def __init__(self):
        self.seconds: Dict[str, float] = {}
        self._last = time.perf_counter()

    def mark(self, name: str) -> None:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        now = time.perf_counter()
        self.seconds[name] = now - self._last
        self._last = now

    def line(self) -> str:
        return ", ".join(f"{k} {v:.3f}" for k, v in self.seconds.items())


def record(fn) -> Tuple[object, Trace]:
    """Run ``fn()`` under ``torch.profiler`` (host and device), ending on a
    synchronise; return its result and the trace of that window."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    return out, Trace(events, window)
