"""Pinball (quantile) losses for the quantile-ensemble SceneNet.

PyTorch twin of :mod:`scenenet_tpu.losses.quantile`. The prediction is
(B, Q, ...) against a ground truth (B, ...) or (B, 1, ...); the pinball
terms are summed over Q, weighted by the WeightedMSE histogram scheme,
then averaged. ``QuantileGENEOLoss`` adds the GENEO penalties summed over
the ensemble's members, whose coefficients and parameters come as lists,
one dict a member.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch

from scenenet_tpu_torch.losses.geneo_loss import _weighted_mse, cvx_loss, positive_regularizer
from scenenet_tpu_torch.losses.weighted_mse import WeightedMSE, _pmean


@dataclasses.dataclass(frozen=True)
class QuantileLoss:
    w_mse: WeightedMSE
    quantiles: Sequence[float] = (0.1, 0.5, 0.9)
    # set by parallel.dp.make_distributed under mesh training: the nested
    # w_mse then normalizes the weights globally and the final mean is
    # averaged over the ranks, so the sharded loss equals the unsharded one
    axis_names: Tuple[str, ...] = ()

    @classmethod
    def create(cls, targets=None, weighting_scheme_path=None, quantiles=(0.1, 0.5, 0.9),
               weight_alpha=1.0, weight_epsilon=0.1, mse_weight=1.0, **kw):
        return cls(w_mse=_weighted_mse(weighting_scheme_path, targets=targets,
                                       weight_alpha=weight_alpha,
                                       weight_epsilon=weight_epsilon, mse_weight=mse_weight),
                   quantiles=tuple(quantiles))

    def quantile_loss(self, pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
        """Sum over the quantiles of ``max(q·d, (q−1)·d)``, d = gt − pred_q."""
        terms = []
        for i, q in enumerate(self.quantiles):
            d = gt - pred[:, i]
            terms.append(torch.maximum(q * d, (q - 1.0) * d))
        return sum(terms)

    def __call__(self, pred, gt, *_args, **_kw):
        if gt.ndim == pred.ndim and gt.shape[1] == 1:
            gt = gt[:, 0]
        weights = self.w_mse.weight_target(gt)
        return _pmean(torch.mean(weights * self.quantile_loss(pred, gt)), self.axis_names)


@dataclasses.dataclass(frozen=True)
class QuantileGENEOLoss(QuantileLoss):
    """Quantile loss + the GENEO penalties of every member, summed."""

    convex_weight: float = 1.0

    @classmethod
    def create(cls, targets=None, weighting_scheme_path=None, quantiles=(0.1, 0.5, 0.9),
               weight_alpha=1.0, weight_epsilon=0.1, mse_weight=1.0, convex_weight=1.0,
               **kw):
        base = QuantileLoss.create(targets=targets, weighting_scheme_path=weighting_scheme_path,
                                   quantiles=quantiles, weight_alpha=weight_alpha,
                                   weight_epsilon=weight_epsilon, mse_weight=mse_weight)
        return cls(w_mse=base.w_mse, quantiles=base.quantiles, convex_weight=convex_weight)

    def __call__(self, pred, gt, cvx_coeffs=None, geneo_params=None, last_lambda=None):
        loss = QuantileLoss.__call__(self, pred, gt)
        if cvx_coeffs:
            loss = loss + sum(cvx_loss(c, last_lambda, self.convex_weight) for c in cvx_coeffs)
        if geneo_params:
            loss = loss + sum(positive_regularizer(g, self.convex_weight)
                              for g in geneo_params)
        return loss
