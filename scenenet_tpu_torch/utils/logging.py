"""Run logging: JSON-lines metric streams and the per-epoch series of
interpretable parameters, with an optional wandb adapter.

Twin of :class:`scenenet_tpu.utils.logging.RunLogger`: every scalar GENEO
parameter and λ is logged each epoch as its own series in
``params.jsonl``, next to ``metrics.jsonl``; with ``use_wandb`` a wandb run
mirrors them where wandb imports and starts, and where it does not the
reason is printed and training goes on (the core never depends on it).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class RunLogger:
    def __init__(self, run_dir: str, use_wandb: bool = False,
                 wandb_kwargs: Optional[dict] = None):
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        self._metrics = open(os.path.join(run_dir, "metrics.jsonl"), "a")
        self._params = open(os.path.join(run_dir, "params.jsonl"), "a")
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb.init(dir=run_dir, **(wandb_kwargs or {}))
            except Exception as exc:  # wandb is strictly optional
                print(f"[RunLogger] wandb disabled ({exc})")

    def log_metrics(self, scores: Dict[str, float], step: int) -> None:
        rec = {"step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in scores.items()})
        self._metrics.write(json.dumps(rec) + "\n")
        self._metrics.flush()
        if self._wandb is not None:
            self._wandb.log(scores, step=step)

    def log_params(self, params: Dict[str, float], step: int) -> None:
        rec = {"step": step}
        rec.update({k: float(v) for k, v in params.items()})
        self._params.write(json.dumps(rec) + "\n")
        self._params.flush()
        if self._wandb is not None:
            self._wandb.log(params, step=step)

    def close(self) -> None:
        self._metrics.close()
        self._params.close()
        if self._wandb is not None:
            self._wandb.finish()


class NullLogger:
    """A logger that writes nothing: the ranks of a mesh other than the
    first, whose scores are the first's, and the mesh steps built alone."""

    def log_metrics(self, scores: Dict[str, float], step: int) -> None:
        pass

    def log_params(self, params: Dict[str, float], step: int) -> None:
        pass

    def close(self) -> None:
        pass
