"""GENEO constraint losses: data term + convexity + non-negativity penalties.

PyTorch twin of :mod:`scenenet_tpu.losses.geneo_loss`. The convexity constraint ``Σλ = 1, λ ≥ 0`` is
relaxed into a hinge penalty on negative coefficients, with the derived
last coefficient ``λ_last = 1 − Σ λ_i``; the caller passes its name.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import torch

from scenenet_tpu_torch.losses.segmentation import (
    BinaryDiceBCE, BinaryDiceLoss, FocalTverskyLoss,
)
from scenenet_tpu_torch.losses.weighted_mse import WeightedMSE


def cvx_loss(cvx_coeffs: Mapping[str, torch.Tensor], last_lambda: Optional[str],
             cvx_w: float = 1.0) -> torch.Tensor:
    """``cvx_w · (Σ_{i≠last} relu(−λ_i) + relu(−(1 − Σλ + λ_last)))``; the
    stored λ_last enters the sum and cancels in the derived one."""
    if not cvx_coeffs:
        return torch.tensor(0.0)
    total = sum(cvx_coeffs.values())
    free = sum(torch.relu(-lam) for name, lam in cvx_coeffs.items() if name != last_lambda)
    derived_last = 1.0 - total + cvx_coeffs[last_lambda]
    return cvx_w * (free + torch.relu(-derived_last))


def positive_regularizer(params: Mapping[str, torch.Tensor],
                         cvx_w: float = 1.0) -> torch.Tensor:
    """Hinge penalty on negative GENEO parameters."""
    if not params:
        return torch.tensor(0.0)
    return cvx_w * sum(torch.relu(-g) for g in params.values())


def _weighted_mse(weighting_scheme_path, **kw) -> WeightedMSE:
    if weighting_scheme_path is not None:
        kw["weighting_scheme_path"] = weighting_scheme_path
    return WeightedMSE.create(**kw)


@dataclasses.dataclass(frozen=True)
class GENEOLoss:
    """WeightedMSE + convexity + non-negativity penalties."""

    w_mse: WeightedMSE
    convex_weight: float = 1.0

    @classmethod
    def create(cls, targets=None, weighting_scheme_path=None, weight_alpha=1.0,
               weight_epsilon=0.1, mse_weight=1.0, convex_weight=1.0, **kw):
        return cls(w_mse=_weighted_mse(weighting_scheme_path, targets=targets,
                                       weight_alpha=weight_alpha,
                                       weight_epsilon=weight_epsilon,
                                       mse_weight=mse_weight),
                   convex_weight=convex_weight)

    def penalties(self, cvx_coeffs, geneo_params, last_lambda):
        """The convexity and non-negativity penalties. A quantile ensemble
        passes lists, one dict a member, and its members' penalties are
        summed, as ``QuantileGENEOLoss`` sums them (the JAX package's GENEO
        criteria take dicts only and raise on the lists)."""
        if isinstance(cvx_coeffs, (list, tuple)):
            members = zip(cvx_coeffs, geneo_params or [{}] * len(cvx_coeffs))
            return sum(self.penalties(c, g, last_lambda) for c, g in members)
        return cvx_loss(cvx_coeffs or {}, last_lambda, self.convex_weight) + \
            positive_regularizer(geneo_params or {}, self.convex_weight)

    def __call__(self, pred, gt, cvx_coeffs=None, geneo_params=None, last_lambda=None):
        return self.w_mse(pred, gt) + self.penalties(cvx_coeffs, geneo_params, last_lambda)


@dataclasses.dataclass(frozen=True)
class GENEODiceLoss(GENEOLoss):
    """WMSE + Dice + penalties."""

    dice: BinaryDiceLoss = BinaryDiceLoss()

    def __call__(self, pred, gt, cvx_coeffs=None, geneo_params=None, last_lambda=None):
        return (self.w_mse(pred, gt) + self.dice(pred, gt)
                + self.penalties(cvx_coeffs, geneo_params, last_lambda))


@dataclasses.dataclass(frozen=True)
class GENEODiceBCE(GENEOLoss):
    """mse_weight·DiceBCE + penalties."""

    dice_bce: Optional[BinaryDiceBCE] = None

    @classmethod
    def create(cls, targets=None, weighting_scheme_path=None, weight_alpha=1.0,
               weight_epsilon=0.1, mse_weight=1.0, convex_weight=1.0,
               reduction="mean", **kw):
        base = GENEOLoss.create(targets=targets, weighting_scheme_path=weighting_scheme_path,
                                weight_alpha=weight_alpha, weight_epsilon=weight_epsilon,
                                mse_weight=mse_weight, convex_weight=convex_weight)
        dice_bce = BinaryDiceBCE.create(targets=targets,
                                        weighting_scheme_path=weighting_scheme_path,
                                        weight_alpha=weight_alpha,
                                        weight_epsilon=weight_epsilon,
                                        mse_weight=mse_weight, reduction=reduction)
        return cls(w_mse=base.w_mse, convex_weight=convex_weight, dice_bce=dice_bce)

    def __call__(self, pred, gt, cvx_coeffs=None, geneo_params=None, last_lambda=None):
        return (self.w_mse.mse_weight * self.dice_bce(pred, gt)
                + self.penalties(cvx_coeffs, geneo_params, last_lambda))


@dataclasses.dataclass(frozen=True)
class GENEOTverskyLoss(GENEOLoss):
    """WMSE + FocalTversky + penalties — the default training criterion."""

    tversky: FocalTverskyLoss = FocalTverskyLoss()

    @classmethod
    def create(cls, targets=None, weighting_scheme_path=None, weight_alpha=1.0,
               weight_epsilon=0.1, mse_weight=1.0, convex_weight=1.0,
               tversky_alpha=0.5, tversky_beta=1.0, focal_gamma=1.0,
               tversky_smooth=1.0, **kw):
        base = GENEOLoss.create(targets=targets, weighting_scheme_path=weighting_scheme_path,
                                weight_alpha=weight_alpha, weight_epsilon=weight_epsilon,
                                mse_weight=mse_weight, convex_weight=convex_weight)
        return cls(w_mse=base.w_mse, convex_weight=convex_weight,
                   tversky=FocalTverskyLoss(tversky_alpha, tversky_beta, focal_gamma,
                                            tversky_smooth))

    def __call__(self, pred, gt, cvx_coeffs=None, geneo_params=None, last_lambda=None):
        return (self.w_mse(pred, gt) + self.tversky(pred, gt)
                + self.penalties(cvx_coeffs, geneo_params, last_lambda))
