"""Offline analysis plots from run logs (λ/GENEO-parameter trajectories and
metric curves — reference ``utils/observer_utils.py:55-158``).

The port's own copy of :mod:`scenenet_tpu.utils.plots`. Reads the JSONL
streams written by :class:`scenenet_tpu_torch.utils.logging.RunLogger`;
writes PNGs when matplotlib is importable (it is imported inside the
plotting call, and a machine without it gets the series alone), and always
returns the assembled series for programmatic use.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Dict, List, Optional


def load_series(jsonl_path: str) -> Dict[str, List[float]]:
    """Column-wise series from a metrics/params JSONL stream."""
    series: Dict[str, List[float]] = defaultdict(list)
    with open(jsonl_path) as f:
        for line in f:
            rec = json.loads(line)
            for key, val in rec.items():
                if isinstance(val, (int, float)):
                    series[key].append(float(val))
    return dict(series)


def _try_plot(series: Dict[str, List[float]], keys: List[str], title: str,
              out_png: Optional[str]) -> None:
    if out_png is None:
        return
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return
    fig, ax = plt.subplots(figsize=(8, 5))
    for key in keys:
        ax.plot(series.get(key, []), label=key)
    ax.set_title(title)
    ax.set_xlabel("epoch")
    ax.legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(out_png, dpi=120)
    plt.close(fig)


def plot_lambda_trajectories(run_dir: str, out_png: Optional[str] = None):
    """Convex-coefficient time series (the white-box training view)."""
    series = load_series(os.path.join(run_dir, "params.jsonl"))
    keys = sorted(k for k in series if k.startswith("lambda"))
    _try_plot(series, keys, "convex coefficients", out_png)
    return {k: series[k] for k in keys}


def plot_geneo_trajectories(run_dir: str, out_png: Optional[str] = None):
    """GENEO scalar-parameter time series."""
    series = load_series(os.path.join(run_dir, "params.jsonl"))
    keys = sorted(k for k in series if "." in k and not k.startswith("grad/"))
    _try_plot(series, keys, "GENEO parameters", out_png)
    return {k: series[k] for k in keys}


def plot_metric_curves(run_dir: str, out_png: Optional[str] = None,
                       prefixes=("train_", "val_")):
    """Train/val metric curves."""
    series = load_series(os.path.join(run_dir, "metrics.jsonl"))
    keys = sorted(k for k in series if k.startswith(prefixes))
    _try_plot(series, keys, "metrics", out_png)
    return {k: series[k] for k in keys}
