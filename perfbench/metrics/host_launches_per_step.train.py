"""Host launch calls a train step: the runtime calls by which the host
starts work on the card (kernel launches, graph launches, async copies and
fills, as ``torch.profiler`` names them) in the traced window, over its
steps. A step replayed from one CUDA graph costs one."""


def read(ctx):
    steps = ctx.counters.get("steps", 0)
    return ctx.trace.runtime_calls() / steps if steps else None
