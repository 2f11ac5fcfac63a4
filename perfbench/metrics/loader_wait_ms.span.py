"""Milliseconds a train step waits for the streaming loader, by the
program's own span: the consumer's wait for the prefetched batch
(``snt/data/loader_wait``, host time) over the train steps
(``snt/train/step``) of the traced window. ``loader_wait_ms.train`` times
the harness's wrapper around the same ``next()``, which also holds the
generator's own time."""

from perfbench import spans


def read(ctx):
    found = spans.program_spans(ctx.trace)
    waits, steps = found.get("snt/data/loader_wait"), found.get("snt/train/step")
    if not waits or not steps:
        return None
    return spans.total_s(waits) / len(steps) * 1e3
