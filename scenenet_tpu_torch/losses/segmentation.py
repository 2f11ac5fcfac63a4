"""Overlap-based segmentation losses: Tversky and focal Tversky.

PyTorch twins of the two criteria of :mod:`scenenet_tpu.losses.segmentation`
that the default training criterion uses. The index is taken over global
sums of the whole batch.
"""

from __future__ import annotations

import dataclasses

import torch


def _tversky_index(pred: torch.Tensor, target: torch.Tensor, alpha: float,
                   beta: float, smooth: float) -> torch.Tensor:
    tp = torch.sum(pred * target)
    fp = torch.sum((1.0 - target) * pred)
    fn = torch.sum(target * (1.0 - pred))
    return (tp + smooth) / (tp + alpha * fp + beta * fn + smooth)


@dataclasses.dataclass(frozen=True)
class TverskyLoss:
    """1 − Tversky index; α penalizes FP, β penalizes FN."""

    tversky_alpha: float = 0.5
    tversky_beta: float = 1.0
    tversky_smooth: float = 1.0

    def __call__(self, pred, target, *_args, **_kw):
        return 1.0 - _tversky_index(pred, target, self.tversky_alpha,
                                    self.tversky_beta, self.tversky_smooth)


@dataclasses.dataclass(frozen=True)
class FocalTverskyLoss:
    """(1 − Tversky)^γ — the focal exponent focuses on hard examples."""

    tversky_alpha: float = 0.5
    tversky_beta: float = 1.0
    focal_gamma: float = 2.0
    tversky_smooth: float = 1.0

    def __call__(self, pred, target, *_args, **_kw):
        t = _tversky_index(pred, target, self.tversky_alpha, self.tversky_beta,
                           self.tversky_smooth)
        return (1.0 - t) ** self.focal_gamma
