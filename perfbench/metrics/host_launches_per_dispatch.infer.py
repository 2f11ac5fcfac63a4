"""Host launch calls a served dispatch: the runtime calls that start work
on the card in the traced window, over its dispatches. A warmed bucket's
dispatch is two copies in, one graph replay and two copies out."""


def read(ctx):
    dispatches = ctx.counters.get("dispatches", 0)
    return ctx.trace.runtime_calls() / dispatches if dispatches else None
