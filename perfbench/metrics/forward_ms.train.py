"""Device milliseconds a train step spends in the model's forward: the
kernels, copies and fills launched while the program's
``snt/train/forward`` span was the innermost one open (the forward alone,
without the batch's voxelization or the loss), over the train steps
(``snt/train/step``) of the traced window."""

from perfbench import spans


def read(ctx):
    found = spans.program_spans(ctx.trace)
    if not found.get("snt/train/forward") or not found.get("snt/train/step"):
        return None
    launched = spans.device_seconds_by_span(ctx.trace)
    return launched.get("snt/train/forward", 0.0) / len(found["snt/train/step"]) * 1e3
