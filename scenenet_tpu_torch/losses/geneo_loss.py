"""GENEO constraint losses: data term + convexity + non-negativity penalties.

PyTorch twin of the parts of :mod:`scenenet_tpu.losses.geneo_loss` that the
default criterion uses. The convexity constraint ``Σλ = 1, λ ≥ 0`` is
relaxed into a hinge penalty on negative coefficients, with the derived
last coefficient ``λ_last = 1 − Σ λ_i``; the caller passes its name.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import torch

from scenenet_tpu_torch.losses.segmentation import FocalTverskyLoss
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
        return cvx_loss(cvx_coeffs or {}, last_lambda, self.convex_weight) + \
            positive_regularizer(geneo_params or {}, self.convex_weight)

    def __call__(self, pred, gt, cvx_coeffs=None, geneo_params=None, last_lambda=None):
        return self.w_mse(pred, gt) + self.penalties(cvx_coeffs, geneo_params, last_lambda)


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
