"""Device milliseconds a train step spends in the loss's forward: the
kernels, copies and fills launched while the program's ``snt/train/loss``
span (``Trainer._loss``, around the criterion call: here deep
supervision's four weighted terms and their targets) was the innermost one
open, over the train steps (``snt/train/step``) of the traced window. The
loss's backward is launched under ``snt/train/backward``."""

from perfbench import spans


def read(ctx):
    found = spans.program_spans(ctx.trace)
    if not found.get("snt/train/loss") or not found.get("snt/train/step"):
        return None
    launched = spans.device_seconds_by_span(ctx.trace)
    return launched.get("snt/train/loss", 0.0) / len(found["snt/train/step"]) * 1e3
