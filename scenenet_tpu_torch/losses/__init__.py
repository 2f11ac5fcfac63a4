"""Training criteria."""

from scenenet_tpu_torch.losses.deep_supervision import (
    DeepSupervision, deep_supervision_weights, nearest_exact_target,
)
from scenenet_tpu_torch.losses.geneo_loss import (
    GENEODiceBCE, GENEODiceLoss, GENEOLoss, GENEOTverskyLoss, cvx_loss, positive_regularizer,
)
from scenenet_tpu_torch.losses.quantile import QuantileGENEOLoss, QuantileLoss
from scenenet_tpu_torch.losses.registry import CRITERION_REGISTRY, resolve_criterion
from scenenet_tpu_torch.losses.segmentation import (
    BinaryDiceBCE, BinaryDiceLoss, FocalLoss, FocalTverskyLoss, IoULoss, TverskyLoss,
    binary_cross_entropy,
)
from scenenet_tpu_torch.losses.weighted_mse import WeightedMSE

__all__ = ["BinaryDiceBCE", "BinaryDiceLoss", "CRITERION_REGISTRY", "DeepSupervision", "FocalLoss",
           "FocalTverskyLoss", "GENEODiceBCE", "GENEODiceLoss", "GENEOLoss",
           "GENEOTverskyLoss", "IoULoss", "QuantileGENEOLoss", "QuantileLoss", "TverskyLoss",
           "WeightedMSE", "binary_cross_entropy", "cvx_loss", "deep_supervision_weights",
           "nearest_exact_target", "positive_regularizer", "resolve_criterion"]
