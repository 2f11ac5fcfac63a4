"""Device milliseconds a train step spends in the backward: the kernels,
copies and fills launched while the program's ``snt/train/backward`` span
was open on the loop's thread (autograd launches them from its own), over
the train steps (``snt/train/step``) of the traced window."""

from perfbench import spans


def read(ctx):
    found = spans.program_spans(ctx.trace)
    if not found.get("snt/train/backward") or not found.get("snt/train/step"):
        return None
    launched = spans.device_seconds_by_span(ctx.trace)
    return launched.get("snt/train/backward", 0.0) / len(found["snt/train/step"]) * 1e3
