"""Seconds of the served pipeline's set-up spent warming its buckets: the
warm-up runs and the CUDA graph capture of every bucket, by the program's
own phase ``snt/serve/warm_buckets`` (host clock)."""

from perfbench import spans


def read(ctx):
    return spans.phase_seconds("snt/serve/warm_buckets")
