"""Probability calibration: temperature scaling and Platt (logistic) scaling.

PyTorch twin of :mod:`scenenet_tpu.utils.calibration`: a scalar
temperature T (or a logistic ``a·logit(p) + b``) fitted on held-out
predictions by plain gradient steps on the mean BCE, with the same step
counts, learning rates and logit clip, the gradient by ``torch.autograd``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from scenenet_tpu_torch.losses.segmentation import binary_cross_entropy


def _logits(probs: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    p = torch.clamp(probs, eps, 1 - eps)
    return torch.log(p) - torch.log1p(-p)


def _descend(nll, start: torch.Tensor, steps: int, lr: float) -> torch.Tensor:
    """``steps`` plain gradient steps ``v ← v − lr·∇nll(v)`` from ``start``."""
    v = start
    for _ in range(steps):
        v = v.detach().requires_grad_()
        (grad,) = torch.autograd.grad(nll(v), v)
        v = v.detach() - lr * grad
    return v


def fit_temperature(probs: torch.Tensor, targets: torch.Tensor,
                    steps: int = 200, lr: float = 0.1) -> float:
    """Scalar temperature T minimizing the BCE of ``sigmoid(logit(p)/T)``
    (the descent runs on log T from 0)."""
    logits = _logits(probs.reshape(-1).float())
    y = targets.reshape(-1).float()

    def nll(log_t):
        return torch.mean(binary_cross_entropy(torch.sigmoid(logits / torch.exp(log_t)), y))

    log_t = _descend(nll, torch.zeros((), device=logits.device), steps, lr)
    return float(torch.exp(log_t))


def apply_temperature(probs: torch.Tensor, temperature: float) -> torch.Tensor:
    return torch.sigmoid(_logits(probs) / temperature)


def fit_platt(probs: torch.Tensor, targets: torch.Tensor,
              steps: int = 300, lr: float = 0.1) -> Tuple[float, float]:
    """Logistic recalibration ``sigmoid(a·logit(p) + b)`` from (1, 0)."""
    logits = _logits(probs.reshape(-1).float())
    y = targets.reshape(-1).float()

    def nll(ab):
        return torch.mean(binary_cross_entropy(torch.sigmoid(ab[0] * logits + ab[1]), y))

    ab = _descend(nll, torch.tensor([1.0, 0.0], device=logits.device), steps, lr)
    return float(ab[0]), float(ab[1])


def apply_platt(probs: torch.Tensor, a: float, b: float) -> torch.Tensor:
    return torch.sigmoid(a * _logits(probs) + b)
