"""Milliseconds a train step waits for the streaming loader: the host
clock around each ``next()`` of the harness's wrapper of the loader handed
to the trainer, over the steps of the traced window."""


def read(ctx):
    waits = ctx.counters.get("loader_wait_s")
    steps = ctx.counters.get("steps", 0)
    if waits is None or not steps:
        return None
    return sum(waits) / steps * 1e3
