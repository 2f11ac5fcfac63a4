"""Criterion name → constructor registry.

PyTorch twin of :mod:`scenenet_tpu.losses.registry`, with the same names.
Every constructor accepts the union of criterion kwargs from the
experiment config and ignores what it does not use.
"""

from __future__ import annotations

from typing import Callable, Dict

from scenenet_tpu_torch.losses.geneo_loss import (
    GENEODiceBCE, GENEODiceLoss, GENEOLoss, GENEOTverskyLoss,
)
from scenenet_tpu_torch.losses.quantile import QuantileGENEOLoss, QuantileLoss
from scenenet_tpu_torch.losses.segmentation import (
    BinaryDiceBCE, BinaryDiceLoss, FocalTverskyLoss, TverskyLoss,
)
from scenenet_tpu_torch.losses.weighted_mse import WeightedMSE


def _plain(cls):
    def make(**kw):
        return cls(**{k: v for k, v in kw.items() if k in cls.__dataclass_fields__})

    return make


CRITERION_REGISTRY: Dict[str, Callable] = {
    "mse": WeightedMSE.create,
    "dice": _plain(BinaryDiceLoss),
    "dice_bce": BinaryDiceBCE.create,
    "tversky": _plain(TverskyLoss),
    "focal_tversky": _plain(FocalTverskyLoss),
    "geneo": GENEOLoss.create,
    "geneo_dice": GENEODiceLoss.create,
    "geneo_dice_bce": GENEODiceBCE.create,
    "geneo_tversky": GENEOTverskyLoss.create,
    "quantile": QuantileLoss.create,
    "quantile_geneo": QuantileGENEOLoss.create,
}


def resolve_criterion(name: str) -> Callable:
    name = name.lower()
    if name not in CRITERION_REGISTRY:
        raise NotImplementedError(f"Criterion {name!r} not implemented")
    return CRITERION_REGISTRY[name]
