"""Optimizer resolution over ``torch.optim``.

PyTorch twin of :func:`scenenet_tpu.train.state.resolve_optimizer`. The
JAX package freezes parameters with ``optax.multi_transform(...,
set_to_zero)``; here the frozen parameters are the ``requires_grad=False``
ones, which go into no optimizer group and so never move.
"""

from __future__ import annotations

from typing import Iterable

import torch


def resolve_optimizer(name: str, params: Iterable[torch.nn.Parameter],
                      learning_rate: float) -> torch.optim.Optimizer:
    """An optimizer over the trainable ones of ``params``, with optax's
    defaults: Adam (β 0.9/0.999, ε 1e-8 outside the sqrt, as in optax),
    SGD without momentum, RMSprop (decay 0.9, ε 1e-8). torch's RMSprop adds
    ε outside the sqrt where optax adds it inside, so the two differ where
    the squared-gradient average is near ε."""
    name = name.lower()
    trainable = [p for p in params if p.requires_grad]
    if name == "adam":
        return torch.optim.Adam(trainable, lr=learning_rate)
    if name == "sgd":
        return torch.optim.SGD(trainable, lr=learning_rate)
    if name == "rmsprop":
        return torch.optim.RMSprop(trainable, lr=learning_rate, alpha=0.9, eps=1e-8)
    if name == "lbfgs":
        raise NotImplementedError("optimizer 'lbfgs' (with its zoom linesearch) is "
                                  "not ported yet: ROADMAP A7")
    raise NotImplementedError(f"Optimizer {name!r} not implemented")
