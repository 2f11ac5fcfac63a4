"""Seconds of a training cell's set-up spent making the optimizer, by the
program's own phase ``snt/train/setup_optimizer`` (host clock): the first
``torch.optim`` optimizer of a process imports ``torch._dynamo``."""

from perfbench import spans


def read(ctx):
    return spans.phase_seconds("snt/train/setup_optimizer")
