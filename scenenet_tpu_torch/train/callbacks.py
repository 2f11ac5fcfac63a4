"""Training callbacks: early stopping + best-score tracking.

Twin of :mod:`scenenet_tpu.train.callbacks` (plain Python, no framework):
Lightning's ``EarlyStopping(monitor, patience=25, mode max)`` and the
best value seen per metric.
"""

from __future__ import annotations

import math
from typing import Dict, Optional


class EarlyStopping:
    def __init__(self, monitor: str, patience: int = 25, mode: str = "max",
                 min_delta: float = 0.0):
        self.monitor = monitor
        self.patience = patience
        self.mode = mode
        self.min_delta = min_delta
        self.best = -math.inf if mode == "max" else math.inf
        self.wait = 0
        self.stopped = False

    def update(self, scores: Dict[str, float]) -> bool:
        """Feed epoch scores; returns True when training should stop."""
        if self.monitor not in scores:
            return False
        value = float(scores[self.monitor])
        improved = (
            value > self.best + self.min_delta
            if self.mode == "max"
            else value < self.best - self.min_delta
        )
        if improved:
            self.best = value
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.stopped = True
        return self.stopped


class BestMetricTracker:
    """Keeps the best value seen per metric (for the end-of-fit report)."""

    def __init__(self, modes: Optional[Dict[str, str]] = None):
        self.modes = modes or {}
        self.best: Dict[str, float] = {}

    def update(self, scores: Dict[str, float]) -> None:
        for name, value in scores.items():
            mode = self.modes.get(name, "min" if "loss" in name else "max")
            value = float(value)
            if not math.isfinite(value):
                # never admit NaN/inf: ``max(nan, x)`` returns nan, so a
                # NaN first epoch would poison the tracker for the whole fit
                continue
            if name not in self.best:
                self.best[name] = value
            elif mode == "max":
                self.best[name] = max(self.best[name], value)
            else:
                self.best[name] = min(self.best[name], value)
