"""Training criteria."""

from scenenet_tpu_torch.losses.geneo_loss import (
    GENEOLoss, GENEOTverskyLoss, cvx_loss, positive_regularizer,
)
from scenenet_tpu_torch.losses.registry import resolve_criterion
from scenenet_tpu_torch.losses.segmentation import FocalTverskyLoss, TverskyLoss
from scenenet_tpu_torch.losses.weighted_mse import WeightedMSE

__all__ = ["GENEOLoss", "GENEOTverskyLoss", "FocalTverskyLoss", "TverskyLoss",
           "WeightedMSE", "cvx_loss", "positive_regularizer", "resolve_criterion"]
