"""Host milliseconds a served dispatch takes to enqueue: the program's
``snt/serve/dispatch`` span (``_Pipeline.run_batch``: the copies in, the
graph replay and the copies out, all enqueued, none waited for) over its
spans in the traced window."""

from perfbench import spans


def read(ctx):
    dispatches = spans.program_spans(ctx.trace).get("snt/serve/dispatch")
    return spans.total_s(dispatches) / len(dispatches) * 1e3 if dispatches else None
