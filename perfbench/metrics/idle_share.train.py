"""The share of the traced window of a training cell in which no kernel,
copy or fill ran on the card."""


def read(ctx):
    if not ctx.counters.get("steps"):
        return None
    return (1.0 - ctx.trace.busy_s() / ctx.trace.window_s) * 100.0
