"""What the routes share where they touch the program: the benchmark's
weights written into its models, its training readings, and the faults the
tests plant in its timed path."""

from __future__ import annotations

from typing import Dict, Iterable

import torch

@torch.no_grad()
def write_weights(model: torch.nn.Module, values: Dict[str, "float | torch.Tensor"]) -> None:
    """Copy ``values`` into the model's parameters and buffers of those names
    (each must exist)."""
    own = dict(model.named_parameters())
    own.update(model.named_buffers())
    for name, v in values.items():
        own[name].copy_(torch.as_tensor(v, dtype=own[name].dtype))


def snapshot(model: torch.nn.Module, buffers: bool = False) -> Dict[str, torch.Tensor]:
    """The model's parameters (and running statistics) as copies on the host."""
    out = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
    if buffers:
        out.update((n, b.detach().cpu().clone()) for n, b in model.named_buffers())
    return out


def adam_gradients(model: torch.nn.Module, optimizer) -> Dict[str, torch.Tensor]:
    """The gradient Adam received at its first step, from its state after
    that step: the first moment over (1 − β1)."""
    beta1 = optimizer.param_groups[0]["betas"][0]
    return {n: (optimizer.state[p]["exp_avg"] / (1.0 - beta1)).detach().cpu().clone()
            for n, p in model.named_parameters() if p in optimizer.state}


def plant_training_faults(trainer, faults: Iterable[str]) -> None:
    """Break the trainer's step as the tests ask: ``frozen_step`` leaves the
    state unchanged (the optimizer's update does nothing); ``half_batch``
    takes the loss over the first half of each batch alone."""
    faults = set(faults)
    if "frozen_step" in faults:
        trainer.optimizer.step = lambda *a, **k: None
    if "half_batch" in faults:
        criterion = trainer.criterion

        def half(pred, y, *args):
            b = max(pred.shape[0] // 2, 1)
            return criterion(pred[:b], y[:b], *args)

        trainer.criterion = half
