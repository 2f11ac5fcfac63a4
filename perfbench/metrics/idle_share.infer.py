"""The share of the traced window of an inference cell in which no kernel,
copy or fill ran on the card."""


def read(ctx):
    if not ctx.counters.get("dispatches"):
        return None
    return (1.0 - ctx.trace.busy_s() / ctx.trace.window_s) * 100.0
