"""nnU-Net's deep supervision around any criterion of the registry.

The prediction is a sequence of outputs, highest resolution first (the
training-mode output of :class:`~scenenet_tpu_torch.models.NNUNet3D`).
Output k is held to the full-resolution target resized by nearest-exact
interpolation (nnU-Net v2's ``DownsampleSegForDSTransform``): at an integer
factor s along an axis, the voxel at ``s·i + s // 2``. The terms are
weighted 1, ½, ¼, … with the last weight 0, then normalised to sum to 1
(``nnUNetTrainer._build_loss``); a term of weight 0 is not computed, so its
output gets no gradient. A single tensor (an evaluation-mode prediction)
takes the criterion as it is.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Sequence

import torch


def deep_supervision_weights(n: int) -> List[float]:
    """The normalised weights of ``n`` outputs: 1/2^k, the last set to 0."""
    w = [1.0 / 2 ** k for k in range(n)]
    if n > 1:
        w[-1] = 0.0
    total = sum(w)
    return [v / total for v in w]


def nearest_exact_target(target: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``target`` (B, C, Z, X, Y) at the spatial size of ``shape``'s last
    three axes, each an integer fraction of the target's: the voxel at
    ``s·i + s // 2`` along an axis of factor s."""
    index = []
    for full, part in zip(target.shape[2:], shape[-3:]):
        if part < 1 or full % part:
            raise ValueError(f"output {tuple(shape)} is no integer fraction of the target "
                             f"{tuple(target.shape)}")
        s = full // part
        index.append(slice(s // 2, None, s))
    return target[(..., *index)]


@dataclasses.dataclass(frozen=True)
class DeepSupervision:
    """``criterion`` summed over a sequence of outputs by
    :func:`deep_supervision_weights` against :func:`nearest_exact_target`'s
    targets. Extra arguments (the GENEO penalties' dicts) go to every term
    alike; as the weights sum to 1, a penalty counts once."""

    criterion: Callable

    def __call__(self, pred, gt: torch.Tensor, *args) -> torch.Tensor:
        if isinstance(pred, torch.Tensor):
            return self.criterion(pred, gt, *args)
        total = None
        for w, p in zip(deep_supervision_weights(len(pred)), pred):
            if w == 0.0:
                continue
            term = w * self.criterion(p, nearest_exact_target(gt, p.shape), *args)
            total = term if total is None else total + term
        return total
