"""The share of the traced window in which the card sat idle at the
epoch's edge: waiting for work launched outside every chunk of the
device-resident epoch (``snt/train/chunk``), where the fit reads the
epoch's counts and loss and draws the next epoch's permutation; for a
chunk's start and its first ``snt/train/step``, the first replay after
that read's synchronise; and in the window's start and tail. With
``idle_in_chunk_share.grid_cache`` it makes the window's idle share."""

from perfbench import spans


def read(ctx):
    split = spans.idle_split(ctx.trace, "snt/train/chunk", "snt/train/step")
    return None if split is None else split[1] / ctx.trace.window_s * 100.0
