"""The share of the traced window in which the card sat idle waiting for
work launched inside a chunk of the device-resident epoch, past its first
step: each idle stretch with the operation that ends it, counted here
where that operation's launch call was made while the program's
``snt/train/chunk`` span was open on the loop's thread and its first
``snt/train/step`` had closed (the steps' own pacing: one graph launch a
step, enqueued ahead of the card)."""

from perfbench import spans


def read(ctx):
    split = spans.idle_split(ctx.trace, "snt/train/chunk", "snt/train/step")
    return None if split is None else split[0] / ctx.trace.window_s * 100.0
