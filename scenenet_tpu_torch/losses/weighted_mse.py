"""Density-weighted MSE — the base regression criterion.

PyTorch twin of :mod:`scenenet_tpu.losses.weighted_mse`: a function of
(pred, gt) with a static 10-bin weighting table. Ground-truth values are
looked up in a histogram of target densities (``freqs`` over ``ranges``);
rare target values get weight close to 1, dense ones are down-weighted to
``max(1 − α·density, ε)``, and the weights are normalized to mean 1.

The reference's quirks are kept:

- the bin lookup is the *nearest range start* (``argmin |y − ranges|``),
  not the containing bin;
- bin indices are replaced by frequencies **in place, one index after the
  other**, so a frequency equal to a still-unprocessed index is replaced
  again;
- the table ships as ``hist_estimation.npz`` beside this module.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Optional, Tuple

import numpy as np
import torch

_DEFAULT_TABLE = os.path.join(os.path.dirname(__file__), "hist_estimation.npz")


def load_weighting_scheme(path: str = _DEFAULT_TABLE) -> Tuple[np.ndarray, np.ndarray]:
    with np.load(path) as data:
        return data["freqs"].astype(np.int64), data["ranges"].astype(np.float32)


def hist_frequency_estimation(y: np.ndarray, hist_len: int = 10
                              ) -> Tuple[np.ndarray, np.ndarray]:
    """Histogram frequency estimation over targets in [0, 1]: counts fall
    in bin ``int(hist_len * y)`` (a value of exactly 1.0 lands in an extra
    bin, as with ``torch.bincount``)."""
    ranges = np.linspace(0, 1, hist_len + 1)[:-1].astype(np.float32)
    idxs = (hist_len * np.asarray(y).reshape(-1)).astype(np.int64)
    freqs = np.bincount(idxs, minlength=hist_len)
    return freqs, ranges


def _psum(x: torch.Tensor, axes: Tuple[str, ...]) -> torch.Tensor:
    """Σ of ``x`` over the ranks of the mesh axes ``axes`` (differentiable,
    :func:`scenenet_tpu_torch.parallel.mesh.psum`); ``x`` where there are none."""
    if not axes:
        return x
    from scenenet_tpu_torch.parallel.mesh import psum

    return psum(x, axes)


def _pmean(x: torch.Tensor, axes: Tuple[str, ...]) -> torch.Tensor:
    """The mean of ``x`` over the ranks of the mesh axes ``axes``."""
    if not axes:
        return x
    from scenenet_tpu_torch.parallel.mesh import pmean

    return pmean(x, axes)


@functools.lru_cache(maxsize=None)
def _table_on(values: Tuple[float, ...], dtype: torch.dtype,
              device: torch.device) -> torch.Tensor:
    """``values`` as a tensor on ``device``, made once: a copy from the host
    on every call could not be captured in a CUDA graph."""
    return torch.tensor(values, dtype=dtype, device=device)


@dataclasses.dataclass(frozen=True)
class WeightedMSE:
    """``mean(mse_weight · w(gt) · (gt − pred)²)`` with histogram weights.
    ``axis_names`` (under mesh training, over equal shards) makes the
    weights' normalization and the final mean global: both are averaged
    over the ranks of those mesh axes."""

    freqs: Tuple[int, ...]
    ranges: Tuple[float, ...]
    weight_alpha: float = 1.0
    weight_epsilon: float = 0.1
    mse_weight: float = 1.0
    axis_names: Tuple[str, ...] = ()

    @classmethod
    def create(cls, targets: Optional[np.ndarray] = None,
               weighting_scheme_path: Optional[str] = _DEFAULT_TABLE,
               weight_alpha: float = 1.0, weight_epsilon: float = 0.1,
               mse_weight: float = 1.0, **_: object) -> "WeightedMSE":
        """Load the weighting table, or estimate it from ``targets``."""
        if weighting_scheme_path is not None and os.path.exists(weighting_scheme_path):
            freqs, ranges = load_weighting_scheme(weighting_scheme_path)
        elif targets is not None:
            freqs, ranges = hist_frequency_estimation(np.asarray(targets).reshape(-1))
        else:
            raise ValueError("no weighting table nor targets provided")
        return cls(freqs=tuple(int(f) for f in freqs),
                   ranges=tuple(float(r) for r in ranges),
                   weight_alpha=weight_alpha, weight_epsilon=weight_epsilon,
                   mse_weight=mse_weight)

    def dens_target(self, y: torch.Tensor) -> torch.Tensor:
        """Normalized density of each target value."""
        ranges = _table_on(self.ranges, y.dtype, y.device)
        vals = torch.argmin(torch.abs(y[..., None] - ranges), dim=-1).to(torch.int32)
        for idx, f in enumerate(self.freqs):
            vals = vals.masked_fill(vals == idx, f)
        fmin, fmax = min(self.freqs), max(self.freqs)
        return (vals - fmin).to(y.dtype) / float(fmax - fmin)

    def weight_target(self, y: torch.Tensor) -> torch.Tensor:
        """Per-target weights, normalized to mean 1."""
        w = torch.clamp(1.0 - self.weight_alpha * self.dens_target(y),
                        min=self.weight_epsilon)
        return w / _pmean(w.mean(), self.axis_names)

    def __call__(self, pred: torch.Tensor, gt: torch.Tensor, *_args, **_kw) -> torch.Tensor:
        pred, gt = torch.broadcast_tensors(pred, gt)
        w = self.weight_target(gt)
        return _pmean(torch.mean(self.mse_weight * w * (gt - pred) ** 2), self.axis_names)
