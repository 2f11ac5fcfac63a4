"""Optimizer resolution over ``torch.optim``, gradient accumulation and the
mixed-precision cast.

PyTorch twin of :func:`scenenet_tpu.train.state.resolve_optimizer`. The
JAX package freezes parameters with ``optax.multi_transform(...,
set_to_zero)``; here the frozen parameters are the ``requires_grad=False``
ones, which go into no optimizer group and so never move.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping

import torch


def resolve_optimizer(name: str, params: Iterable[torch.nn.Parameter],
                      learning_rate: float, capturable: bool = False) -> torch.optim.Optimizer:
    """An optimizer over the trainable ones of ``params``, with optax's
    defaults: Adam (β 0.9/0.999, ε 1e-8 outside the sqrt, as in optax),
    SGD without momentum, RMSprop (decay 0.9, ε 1e-8). torch's RMSprop adds
    ε outside the sqrt where optax adds it inside, so the two differ where
    the squared-gradient average is near ε. ``capturable`` (CUDA
    parameters) keeps Adam's and RMSprop's step counts on the device, so a
    CUDA graph can hold the update; SGD needs nothing for that."""
    name = name.lower()
    trainable = [p for p in params if p.requires_grad]
    if name == "adam":
        return torch.optim.Adam(trainable, lr=learning_rate, capturable=capturable)
    if name == "sgd":
        return torch.optim.SGD(trainable, lr=learning_rate)
    if name == "rmsprop":
        return torch.optim.RMSprop(trainable, lr=learning_rate, alpha=0.9, eps=1e-8,
                                   capturable=capturable)
    if name == "lbfgs":
        raise NotImplementedError("optimizer 'lbfgs' (with its zoom linesearch) is "
                                  "not ported yet: ROADMAP A7")
    raise NotImplementedError(f"Optimizer {name!r} not implemented")


def cast_half(params: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """bf16 copies of the floating tensors of ``params``, the rest as they
    are: the mixed-precision cast rule of the JAX package
    (``scenenet_tpu.parallel.dp.cast_half``). A copy is differentiable, so
    a gradient taken through it lands on the f32 master in f32."""
    return {k: v.to(torch.bfloat16) if v.is_floating_point() else v
            for k, v in params.items()}


class MultiSteps:
    """Gradient accumulation over ``every_k`` calls, as ``optax.MultiSteps``
    with its defaults.

    :meth:`step` takes the gradients of the call into a running mean,
    ``acc ← acc + (g − acc)/(n + 1)`` with n the calls since the last
    update, in the order optax rounds it, and on an updating call puts the
    mean into the parameters' gradients, runs the optimizer's step and
    starts a new mean: the inner update runs on every k-th call only, so
    nothing moves in between and Adam's step count advances once an update.
    The count n lives on the device, so either kind of call can run inside
    a captured CUDA graph; the host keeps its own count of the calls
    (:meth:`advance`), which names the calls that update.
    """

    def __init__(self, optimizer: torch.optim.Optimizer, every_k: int):
        if every_k < 1:
            raise ValueError(f"every_k must be >= 1, got {every_k}")
        self.optimizer = optimizer
        self.every_k = every_k
        self.params = [p for group in optimizer.param_groups for p in group["params"]]
        self.acc = [torch.zeros_like(p) for p in self.params]
        self.count = torch.zeros((), device=self.params[0].device if self.params else None)
        self.calls = 0  # the host's count of calls since the last update

    def advance(self) -> bool:
        """Count one call on the host; True where it is an update (the k-th
        call since the last)."""
        apply = self.calls == self.every_k - 1
        self.calls = 0 if apply else self.calls + 1
        return apply

    def step(self, apply: bool) -> None:
        """One call's device work: the gradients into the running mean,
        then, where ``apply`` says so, the update on the mean and a new
        mean. A parameter the backward did not reach counts a zero
        gradient, as in optax."""
        denom = self.count + 1
        for p, acc in zip(self.params, self.acc):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            acc.add_((g - acc) / denom)
        self.count.add_(1)
        if not apply:
            return
        for p, acc in zip(self.params, self.acc):
            if p.grad is None:
                p.grad = acc.clone()
            else:
                p.grad.copy_(acc)
        self.optimizer.step()
        for acc in self.acc:
            acc.zero_()
        self.count.zero_()
