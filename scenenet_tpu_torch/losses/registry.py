"""Criterion name → constructor registry.

PyTorch twin of :mod:`scenenet_tpu.losses.registry`. Every constructor
accepts the union of criterion kwargs from the experiment config and
ignores what it does not use. The criteria not ported yet raise.
"""

from __future__ import annotations

from typing import Callable, Dict

from scenenet_tpu_torch.losses.geneo_loss import GENEOLoss, GENEOTverskyLoss
from scenenet_tpu_torch.losses.segmentation import FocalTverskyLoss, TverskyLoss
from scenenet_tpu_torch.losses.weighted_mse import WeightedMSE


def _plain(cls):
    def make(**kw):
        return cls(**{k: v for k, v in kw.items() if k in cls.__dataclass_fields__})

    return make


CRITERION_REGISTRY: Dict[str, Callable] = {
    "mse": WeightedMSE.create,
    "tversky": _plain(TverskyLoss),
    "focal_tversky": _plain(FocalTverskyLoss),
    "geneo": GENEOLoss.create,
    "geneo_tversky": GENEOTverskyLoss.create,
}

# in the JAX package's registry, not ported yet
NOT_PORTED = ("dice", "dice_bce", "geneo_dice", "geneo_dice_bce", "quantile",
              "quantile_geneo")


def resolve_criterion(name: str) -> Callable:
    name = name.lower()
    if name in NOT_PORTED:
        raise NotImplementedError(f"criterion {name!r} is not ported yet: ROADMAP A9")
    if name not in CRITERION_REGISTRY:
        raise NotImplementedError(f"Criterion {name!r} not implemented")
    return CRITERION_REGISTRY[name]
