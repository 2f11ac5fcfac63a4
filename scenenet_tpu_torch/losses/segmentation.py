"""Overlap-based segmentation losses: Tversky, Dice, BCE, focal and IoU.

PyTorch twins of the criteria of :mod:`scenenet_tpu.losses.segmentation`.
The Tversky, focal-Tversky and IoU indices are taken over global sums of
the whole batch; Dice per sample, then reduced. The BCE clamps each log
term at −100, as ``torch.nn.BCELoss`` does (the JAX package copies that
clamp).

``axis_names`` (set by :func:`scenenet_tpu_torch.parallel.dp.make_distributed`
under mesh training) makes a criterion global over the ranks of those mesh
axes: the Tversky and IoU sums are summed over them, and a mean over equal
shards is averaged over them, so the sharded loss equals the unsharded one.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from scenenet_tpu_torch.losses.weighted_mse import WeightedMSE, _pmean, _psum

# torch.nn.BCELoss clamps each log term at -100
_BCE_CLAMP = 100.0


def binary_cross_entropy(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Elementwise BCE with the log terms clamped at −100 (no reduction)."""
    logp = torch.clamp(torch.log(pred), min=-_BCE_CLAMP)
    log1mp = torch.clamp(torch.log(1.0 - pred), min=-_BCE_CLAMP)
    return -(target * logp + (1.0 - target) * log1mp)


def _tversky_index(pred: torch.Tensor, target: torch.Tensor, alpha: float,
                   beta: float, smooth: float, axis_names: Tuple[str, ...] = ()) -> torch.Tensor:
    """The Tversky index of the global counts: under a mesh the TP/FP/FN
    sums are summed over its ranks (a mean of per-shard ratios would be
    another loss)."""
    tp = _psum(torch.sum(pred * target), axis_names)
    fp = _psum(torch.sum((1.0 - target) * pred), axis_names)
    fn = _psum(torch.sum(target * (1.0 - pred)), axis_names)
    return (tp + smooth) / (tp + alpha * fp + beta * fn + smooth)


def _reduce(loss: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return torch.mean(loss)
    if reduction == "sum":
        return torch.sum(loss)
    return loss


@dataclasses.dataclass(frozen=True)
class TverskyLoss:
    """1 − Tversky index; α penalizes FP, β penalizes FN."""

    tversky_alpha: float = 0.5
    tversky_beta: float = 1.0
    tversky_smooth: float = 1.0
    axis_names: Tuple[str, ...] = ()

    def __call__(self, pred, target, *_args, **_kw):
        return 1.0 - _tversky_index(pred, target, self.tversky_alpha,
                                    self.tversky_beta, self.tversky_smooth, self.axis_names)


@dataclasses.dataclass(frozen=True)
class FocalTverskyLoss:
    """(1 − Tversky)^γ — the focal exponent focuses on hard examples."""

    tversky_alpha: float = 0.5
    tversky_beta: float = 1.0
    focal_gamma: float = 2.0
    tversky_smooth: float = 1.0
    axis_names: Tuple[str, ...] = ()

    def __call__(self, pred, target, *_args, **_kw):
        t = _tversky_index(pred, target, self.tversky_alpha, self.tversky_beta,
                           self.tversky_smooth, self.axis_names)
        return (1.0 - t) ** self.focal_gamma


@dataclasses.dataclass(frozen=True)
class BinaryDiceLoss:
    """Per-sample Dice with a p-power denominator, then the ``reduction``
    (``mean``, ``sum``, anything else: the per-sample losses). Under a mesh
    a sample never crosses a batch shard, so ``mean`` is averaged and
    ``sum`` summed over the ranks."""

    smooth: float = 1.0
    p: float = 2.0
    reduction: str = "mean"
    axis_names: Tuple[str, ...] = ()

    def __call__(self, pred, target, *_args, **_kw):
        b = pred.shape[0]
        pred = pred.reshape(b, -1)
        target = target.reshape(b, -1)
        num = torch.sum(pred * target, dim=1) + self.smooth
        den = torch.sum(pred ** self.p + target ** self.p, dim=1) + self.smooth
        loss = _reduce(1.0 - num / den, self.reduction)
        if self.reduction == "mean":
            return _pmean(loss, self.axis_names)
        if self.reduction == "sum":
            return _psum(loss, self.axis_names)
        return loss


@dataclasses.dataclass(frozen=True)
class BinaryDiceBCE:
    """Histogram-weighted BCE + Dice, the weights those of ``w_mse``."""

    w_mse: WeightedMSE
    reduction: str = "mean"
    axis_names: Tuple[str, ...] = ()

    @classmethod
    def create(cls, targets=None, weighting_scheme_path=None, weight_alpha=1.0,
               weight_epsilon=0.1, mse_weight=1.0, reduction="mean", **kw):
        kwargs = ({} if weighting_scheme_path is None
                  else {"weighting_scheme_path": weighting_scheme_path})
        return cls(w_mse=WeightedMSE.create(targets=targets, weight_alpha=weight_alpha,
                                            weight_epsilon=weight_epsilon,
                                            mse_weight=mse_weight, **kwargs),
                   reduction=reduction)

    def __call__(self, pred, target, *_args, **_kw):
        weights = self.w_mse.weight_target(target)
        bce = binary_cross_entropy(pred, target)
        dice = BinaryDiceLoss(reduction=self.reduction,
                              axis_names=self.axis_names)(pred, target)
        if self.reduction == "mean":
            return _pmean(torch.mean(weights * bce), self.axis_names) + dice
        if self.reduction == "sum":
            return _psum(torch.sum(weights * bce), self.axis_names) + dice
        return weights * bce + dice


@dataclasses.dataclass(frozen=True)
class FocalLoss:
    """BCE-based focal loss, the focal factor applied to the *reduced* BCE
    (as the reference does)."""

    focal_alpha: float = 0.5
    focal_gamma: float = 2.0
    reduction: str = "mean"

    def __call__(self, pred, target, *_args, **_kw):
        bce = _reduce(binary_cross_entropy(pred.reshape(-1), target.reshape(-1)),
                      self.reduction)
        return self.focal_alpha * (1.0 - torch.exp(-bce)) ** self.focal_gamma * bce


@dataclasses.dataclass(frozen=True)
class IoULoss:
    """1 − soft IoU over the whole batch."""

    smooth: float = 1.0
    axis_names: Tuple[str, ...] = ()

    def __call__(self, pred, target, *_args, **_kw):
        inter = torch.sum(pred * target)
        union = torch.sum(pred + target) - inter
        inter, union = _psum(inter, self.axis_names), _psum(union, self.axis_names)
        return 1.0 - (inter + self.smooth) / (union + self.smooth)
