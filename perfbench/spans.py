"""The program's own spans in a traced window: the ranges that
``scenenet_tpu_torch`` marks with ``utils/profiling.py``'s ``span`` and
``phase`` (named ``snt/...``), read from the ``torch.profiler`` trace
beside the device's operations, on the same clock.

- :func:`program_spans`: the ``snt/`` ranges of the loop's thread (the
  thread that holds most of them), by name;
- :func:`device_seconds_by_span`: each kernel, copy and fill's device time
  under the innermost loop-thread span open when the runtime call that
  launched it was made, matched by the trace's ``correlation``, whichever
  thread made the call (autograd launches the backward from its own);
- :func:`idle_split`: the window's device idle time (the window less the
  union of the device's operations, as ``busy_s`` takes it), each idle
  stretch with the operation that ends it: inside a span where that
  operation was launched while the span was open, and, where a first
  inner span is named, after the first such span inside it had closed.
  The host runs ahead of the device (a chunk of graph replays is enqueued
  long before the card has run it), so the span open on the host during
  a stretch says little of what the card waits for; the launch of the
  work that ends the wait does. A chunk's start (its first step, the
  first replay after the epoch's synchronise) is where the card waits
  for the host to restart it, and goes with the edge;
- :func:`phase_seconds`: a set-up phase's seconds by the program's own
  process-wide total.

Each gives nothing to read where the program made no such span or phase,
so a reader returns ``None`` there, never 0.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

PREFIX = "snt/"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")

Intervals = List[Tuple[float, float]]  # µs on the profiler's clock


def program_spans(trace) -> Dict[str, Intervals]:
    """The program's spans on the loop's thread, by name, each name's in
    order of start; empty where the program made none."""
    by_thread: Dict[object, List[dict]] = defaultdict(list)
    for e in trace.host:
        if e.get("cat") == "user_annotation" and e["name"].startswith(PREFIX):
            by_thread[e.get("tid")].append(e)
    if not by_thread:
        return {}
    out: Dict[str, Intervals] = defaultdict(list)
    for e in sorted(max(by_thread.values(), key=len), key=lambda e: e["ts"]):
        out[e["name"]].append((e["ts"], e["ts"] + e["dur"]))
    return dict(out)


def total_s(intervals: Intervals) -> float:
    return sum(f - s for s, f in intervals) * 1e-6


def launch_times(trace) -> Dict[object, float]:
    """The runtime calls' times (µs) by ``correlation``."""
    return {e["args"]["correlation"]: e["ts"] for e in trace.host
            if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}


def idle_intervals(trace) -> List[Tuple[float, float, Optional[dict]]]:
    """The window's stretches with nothing on the device, each with the
    device operation that ends it (``None`` for the window's tail). The
    window is the last ``window_s`` before the trace's last event (the
    closing synchronise)."""
    end = max(e["ts"] + e["dur"] for e in trace.host + trace.device)
    cursor = end - trace.window_s * 1e6
    gaps = []
    for e in trace.device:  # in order of start
        if e["ts"] > cursor:
            gaps.append((cursor, e["ts"], e))
        cursor = max(cursor, e["ts"] + e["dur"])
    if end > cursor:
        gaps.append((cursor, end, None))
    return gaps


def _union(intervals: Intervals) -> Intervals:
    out: Intervals = []
    for s, f in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], f))
        else:
            out.append((s, f))
    return out


def _within(t: Optional[float], intervals: Intervals) -> bool:
    """Whether time ``t`` lies in one of the ordered, disjoint ``intervals``."""
    k = bisect.bisect_right(intervals, (t, float("inf"))) - 1 if t is not None else -1
    return k >= 0 and t <= intervals[k][1]


def idle_split(trace, name: str, first: Optional[str] = None
               ) -> Optional[Tuple[float, float]]:
    """Device idle seconds of the window (inside, outside) the loop
    thread's spans ``name``, each idle stretch by where the operation that
    ends it was launched; together the window's idle time. With ``first``,
    a span ``name`` counts only from the end of the first span ``first``
    that starts inside it (none of it where none does)."""
    spans = program_spans(trace)
    opened = spans.get(name)
    if not opened:
        return None
    opened = _union(opened)
    if first is not None:
        inner = sorted(spans.get(first, ()))
        steady = []
        for s, f in opened:
            ends = [b for a, b in inner if s <= a <= f]  # in order of start
            if ends:
                steady.append((ends[0], f))
        opened = steady
    launched = launch_times(trace)
    inside = outside = 0.0
    for start, end, op in idle_intervals(trace):
        at = launched.get(op.get("args", {}).get("correlation")) if op else None
        if _within(at, opened):
            inside += end - start
        else:
            outside += end - start
    return inside * 1e-6, outside * 1e-6


def device_seconds_by_span(trace) -> Dict[Optional[str], float]:
    """Device seconds of the window's operations by the innermost program
    span open on the loop's thread when their launch call was made (``None``:
    no span open, or no launch call found); empty where the program made no
    span."""
    spans = program_spans(trace)
    if not spans:
        return {}
    flat = [(s, f, n) for n, intervals in spans.items() for s, f in intervals]
    edges = sorted({t for s, f, _ in flat for t in (s, f)})
    owner: List[Optional[str]] = []  # of each stretch between consecutive edges
    for lo, hi in zip(edges, edges[1:]):
        mid = (lo + hi) / 2
        open_here = [(s, -f, n) for s, f, n in flat if s <= mid < f]
        # spans on one thread nest: the innermost started last (or ends first)
        owner.append(max(open_here)[2] if open_here else None)
    launched = launch_times(trace)
    out: Dict[Optional[str], float] = defaultdict(float)
    for e in trace.device:
        at = launched.get(e.get("args", {}).get("correlation"))
        k = bisect.bisect_right(edges, at) - 1 if at is not None else -1
        out[owner[k] if 0 <= k < len(owner) else None] += e["dur"] * 1e-6
    return dict(out)


def phase_seconds(name: str) -> Optional[float]:
    """The program's seconds in set-up phase ``name`` so far in this
    process; ``None`` where it keeps no such total."""
    from scenenet_tpu_torch.utils import profiling

    read = getattr(profiling, "phase_seconds", None)
    return None if read is None else read().get(name)
