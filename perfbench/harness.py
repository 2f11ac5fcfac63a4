"""One run of one cell: set-up, the measured (or traced) window, the
check against the plain reference, and the result line.

Order of a run: the route's set-up (program import, kernel build on the
first run in a checkout, inputs and weights from the seed, warm-up and the
first steps read for the check), then ``--seconds`` of work measured by the
host clock and ending on a synchronise (or, with ``--trace 1``, the
traffic's traced work under ``torch.profiler``), then the device memory
peak, then the program's state freed and the reference run, then the
import check and the result line: the compared numbers, each beside its
limit, as the last lines on standard error, and one JSON object as the
last line on standard output.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence

import torch

from perfbench import spec
from perfbench import trace as tracing

FORBIDDEN = ("jax", "jaxlib", "flax", "scenenet_tpu")


def forbidden_modules(modules: Optional[Sequence[str]] = None) -> List[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``, compared
    whole (``scenenet_tpu_torch`` is not ``scenenet_tpu``)."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


def cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    program's own, ``build/kernels`` and ``build/native``, are fixed in its
    code)."""
    build = spec.ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not measured"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not measured"


def pace(ends: List[float]) -> None:
    """The window's pace on standard error: the host clock's times of the
    window's chunks of work (epochs, steps or passes over the pool), as the
    quartiles of their lengths and the first and last quarter's means."""
    if len(ends) < 8:
        return
    lengths = [b - a for a, b in zip([0.0] + ends[:-1], ends)]
    q = sorted(lengths)
    k = len(lengths) // 4
    print(f"[window] {len(lengths)} chunks, s each: min {q[0]:.6f} q1 {q[k]:.6f} "
          f"median {q[len(q) // 2]:.6f} q3 {q[-k - 1]:.6f} max {q[-1]:.6f}; first quarter "
          f"{sum(lengths[:k]) / k:.6f}, last {sum(lengths[-k:]) / k:.6f}", file=sys.stderr)


class Context:
    """What a per-layer metric's reader reads."""

    def __init__(self, cell: spec.Cell, trace: tracing.Trace, counters: dict):
        self.trace, self.counters = trace, counters
        self.config, self.traffic = cell.config, cell.traffic


def run(cell_name: str, seed: int, seconds: float, traced: bool, start: float,
        device: str = "cuda", faults: Sequence[str] = (),
        overrides: Optional[Dict[str, dict]] = None) -> dict:
    """One run of ``cell_name``; returns the result line as a dict, with the
    compared numbers under ``checks``. ``overrides`` updates the cell's
    ``config`` and ``traffic`` (the tests' small sizes), ``faults`` breaks
    the program's timed path (the tests)."""
    cell = spec.Cell(cell_name)
    for part, values in (overrides or {}).items():
        getattr(cell, part).update(values)
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    route = spec.load_route(cell.traffic["route"]).Route(cell, seed, dev, faults)
    try:
        route.setup()
        if on_card:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - start
        print(f"[setup] {setup_s:.3f} s: before the route "
              f"{setup_s - sum(route.phases.seconds.values()):.3f}, {route.phases.line()}",
              file=sys.stderr)
        out = {"device": {"platform": "gpu" if on_card else "cpu",
                          "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
                          "count": cell.chips}}
        if traced:
            counters, tr = tracing.record(route.traced) if on_card else (route.traced(), None)
            metrics = {}
            if tr is not None:
                ctx = Context(cell, tr, counters)
                for m in cell.per_layer:
                    value = spec.load_metric(m["name"]).read(ctx)
                    if value is not None:
                        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
                out["device"].update(busy_s=tr.busy_s(), window_s=tr.window_s)
                out["breakdown"] = {"device_ops": [list(kv) for kv in tr.device_ops()],
                                    "idle_gaps": [list(kv) for kv in tr.idle_gaps()]}
        else:
            values, counters = route.window(seconds)
            pace(counters.get("pace_s", []))
            values["setup_s"] = setup_s
            metrics = {}
            for m in cell.end_to_end:
                if m["name"] not in values:
                    raise RuntimeError(f"the route measured no {m['name']}")
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
        out["device"]["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                              if on_card else 0)
        out["device"]["power_limit"] = power_limit() if on_card else "not measured"
        route.release()
        if on_card:
            torch.cuda.empty_cache()
        compared = route.check()
    finally:
        route.close()
    return {"correct": all(c.ok for c in compared),
            "attempted": counters.get("samples", counters.get("tiles", 0)),
            "failed": 0, "metrics": metrics, **out,
            "checks": {c.name: {"value": c.value, "limit": c.limit} for c in compared}}


def report(result: dict) -> int:
    """Print the compared numbers on standard error and the result line on
    standard output, after the import check; the exit code."""
    for name, c in result["checks"].items():
        print(f"[check] {name} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['value'] <= c['limit'] else 'FAIL'}", file=sys.stderr)
    found = forbidden_modules()
    if found:
        print(f"[imports] refused: loaded {found}", file=sys.stderr, flush=True)
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
