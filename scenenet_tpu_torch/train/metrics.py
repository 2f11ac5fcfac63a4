"""Segmentation metrics as confusion-count accumulators on the device.

PyTorch twin of :mod:`scenenet_tpu.train.metrics`: four counts updated
inside the train step, with no host sync per batch, and reduced to the
reference's five scores once per epoch.

- Precision / Recall / F1 / Fβ are binary scores of the positive class at
  ``pred ≥ τ``; zero when the denominator is zero.
- JaccardIndex is the *macro* mean IoU over both classes.

The counts are int64 tensors: the JAX package carries each as two int32
limbs because the TPU has no 64-bit integers, which the card has.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

DEFAULT_TAU = 0.65
DEFAULT_BETA = 0.5
METRIC_NAMES = ("JaccardIndex", "Precision", "Recall", "F1Score", "FBetaScore")


class MetricState(NamedTuple):
    """Confusion counts for the binary task (positive class = tower), each
    a 0-d int64 tensor."""

    tp: torch.Tensor
    fp: torch.Tensor
    fn: torch.Tensor
    tn: torch.Tensor


def init_metric_state(device: "Optional[torch.device | str]" = None) -> MetricState:
    return MetricState(*(torch.zeros((), dtype=torch.int64, device=device)
                         for _ in range(4)))


def update_metrics(state: MetricState, pred: torch.Tensor, target: torch.Tensor,
                   tau: float = DEFAULT_TAU) -> MetricState:
    """Accumulate confusion counts; shapes broadcast."""
    pred, target = torch.broadcast_tensors(pred, target)
    p = (pred >= tau).reshape(-1)
    t = (target >= 0.5).reshape(-1)
    tp = (p & t).sum()
    fp = (p & ~t).sum()
    fn = (~p & t).sum()
    tn = p.numel() - tp - fp - fn
    return MetricState(state.tp + tp, state.fp + fp, state.fn + fn, state.tn + tn)


def merge_metric_states(a: MetricState, b: MetricState) -> MetricState:
    return MetricState(*(x + y for x, y in zip(a, b)))


def metric_counts(state: MetricState) -> Tuple[int, int, int, int]:
    """Exact (tp, fp, fn, tn) as Python ints."""
    return tuple(int(v) for v in state)


def _safe_div(num: float, den: float) -> float:
    return num / den if den > 0 else 0.0


def compute_metrics(state: MetricState, beta: float = DEFAULT_BETA) -> Dict[str, float]:
    """Reduce the counts to the reference's five scores."""
    tp, fp, fn, tn = (float(c) for c in metric_counts(state))
    precision = _safe_div(tp, tp + fp)
    recall = _safe_div(tp, tp + fn)
    f1 = _safe_div(2 * precision * recall, precision + recall)
    b2 = beta * beta
    fbeta = _safe_div((1 + b2) * precision * recall, b2 * precision + recall)
    iou_pos = _safe_div(tp, tp + fp + fn)
    iou_neg = _safe_div(tn, tn + fp + fn)
    return {
        "JaccardIndex": (iou_pos + iou_neg) / 2.0,  # macro over {background, tower}
        "Precision": precision,
        "Recall": recall,
        "F1Score": f1,
        "FBetaScore": fbeta,
    }
