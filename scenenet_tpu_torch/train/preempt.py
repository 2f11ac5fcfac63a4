"""Preemption support for the device-resident epochs.

PyTorch twin of :mod:`scenenet_tpu.train.preempt`. Only the epoch's chunk
partition is ported; the SIGTERM guard and the resumable snapshots are
ROADMAP A7.
"""

from __future__ import annotations

from typing import List, Tuple


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
