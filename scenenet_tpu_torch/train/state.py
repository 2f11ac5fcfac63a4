"""Optimizer resolution over ``torch.optim`` and L-BFGS, gradient
accumulation, the optimizer state of a snapshot and the mixed-precision
cast.

PyTorch twin of :func:`scenenet_tpu.train.state.resolve_optimizer`. The
JAX package freezes parameters with ``optax.multi_transform(...,
set_to_zero)``; here the frozen parameters are the ``requires_grad=False``
ones, which go into no optimizer group and so never move.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Mapping, Optional

import torch

from scenenet_tpu_torch.train.lbfgs import LBFGS


def resolve_optimizer(name: str, params: Iterable[torch.nn.Parameter],
                      learning_rate: float, capturable: bool = False) -> torch.optim.Optimizer:
    """An optimizer over the trainable ones of ``params``, with optax's
    defaults: Adam (β 0.9/0.999, ε 1e-8 outside the sqrt, as in optax),
    SGD without momentum, RMSprop (decay 0.9, ε 1e-8), and L-BFGS with the
    zoom linesearch as ``optax.lbfgs`` (:class:`LBFGS`, whose step takes a
    closure: :func:`optimizer_needs_value_fn`). torch's RMSprop adds
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
        return LBFGS(trainable, lr=learning_rate)
    raise NotImplementedError(f"Optimizer {name!r} not implemented")


def optimizer_needs_value_fn(optimizer) -> bool:
    """True where the optimizer's step re-evaluates the objective (a
    linesearch optimizer: L-BFGS), by name or instance."""
    if isinstance(optimizer, str):
        return optimizer.lower() == "lbfgs"
    return isinstance(optimizer, LBFGS)


def _initial_state(optimizer: torch.optim.Optimizer, p: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The state ``optimizer``'s first step makes for ``p``: Adam's and
    RMSprop's step count and averages, nothing for SGD without momentum."""
    group = next(g for g in optimizer.param_groups if any(q is p for q in g["params"]))
    step_dev = p.device if group.get("capturable") or group.get("fused") else None
    step = torch.zeros((), dtype=torch.float32, device=step_dev)
    if isinstance(optimizer, torch.optim.Adam):
        return {"step": step, "exp_avg": torch.zeros_like(p),
                "exp_avg_sq": torch.zeros_like(p)}
    if isinstance(optimizer, torch.optim.RMSprop):
        return {"step": step, "square_avg": torch.zeros_like(p)}
    if isinstance(optimizer, torch.optim.SGD) and not group["momentum"]:
        return {}
    raise NotImplementedError(f"the initial state of {type(optimizer).__name__}")


def optimizer_state(optimizer: torch.optim.Optimizer) -> Dict[str, torch.Tensor]:
    """The optimizer's state as flat name → tensor (``"{i}/{key}"``, i the
    parameter's index in its groups), the state a first step would make
    where none exists yet: a snapshot's structure does not depend on
    whether a step has run."""
    if isinstance(optimizer, LBFGS):
        return optimizer.state_tensors()
    out = {}
    for i, p in enumerate(q for g in optimizer.param_groups for q in g["params"]):
        state = optimizer.state.get(p) or _initial_state(optimizer, p)
        out.update((f"{i}/{k}", v) for k, v in state.items())
    return out


def load_optimizer_state(optimizer: torch.optim.Optimizer,
                         state: Mapping[str, torch.Tensor]) -> None:
    """Load :func:`optimizer_state`'s ``state`` into ``optimizer``: copied
    into the tensors it holds where it has state (a captured CUDA graph
    reads those), else given to ``load_state_dict`` before its first step."""
    if isinstance(optimizer, LBFGS):
        optimizer.load_state_tensors(state)
        return
    params = [q for g in optimizer.param_groups for q in g["params"]]
    if all(p in optimizer.state for p in params):
        for i, p in enumerate(params):
            for k, v in optimizer.state[p].items():
                v.copy_(state[f"{i}/{k}"])
        return
    per_param: Dict[int, Dict[str, torch.Tensor]] = {}
    for name, v in state.items():
        i, k = name.split("/", 1)
        per_param.setdefault(int(i), {})[k] = v.clone()
    sd = optimizer.state_dict()
    sd["state"] = per_param
    optimizer.load_state_dict(sd)


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
    (:meth:`advance`), which names the calls that update. Over L-BFGS the
    updating call gives it the mean as the direction's input and the
    call's own value, gradients and objective (``closure``), as optax's
    ``MultiSteps`` passes its extra arguments on.
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

    def state_tensors(self) -> Dict[str, torch.Tensor]:
        out = {f"acc/{i}": a for i, a in enumerate(self.acc)}
        out.update(count=self.count, calls=torch.tensor(self.calls, dtype=torch.int64))
        return out

    def load_state_tensors(self, state: Mapping[str, torch.Tensor]) -> None:
        """Copy ``state`` (as :meth:`state_tensors` gives it) in place."""
        for i, a in enumerate(self.acc):
            a.copy_(state[f"acc/{i}"])
        self.count.copy_(state["count"])
        self.calls = int(state["calls"])

    def step(self, apply: bool, closure: Optional[Callable[[], torch.Tensor]] = None,
             value: Optional[torch.Tensor] = None) -> None:
        """One call's device work: the gradients into the running mean,
        then, where ``apply`` says so, the update on the mean and a new
        mean. A parameter the backward did not reach counts a zero
        gradient, as in optax. ``closure`` and ``value`` are the call's
        objective for a linesearch optimizer."""
        denom = self.count + 1
        for p, acc in zip(self.params, self.acc):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            acc.add_((g - acc) / denom)
        self.count.add_(1)
        if not apply:
            return
        if isinstance(self.optimizer, LBFGS):
            self.optimizer.step(closure, value, updates=self.acc)
            for acc in self.acc:
                acc.zero_()
            self.count.zero_()
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
