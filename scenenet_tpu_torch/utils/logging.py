"""Run logging: JSON-lines metric streams and the per-epoch series of
interpretable parameters.

Twin of :class:`scenenet_tpu.utils.logging.RunLogger` without the wandb
adapter: every scalar GENEO parameter and λ is logged each epoch as its own
series in ``params.jsonl``, next to ``metrics.jsonl``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class RunLogger:
    def __init__(self, run_dir: str):
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        self._metrics = open(os.path.join(run_dir, "metrics.jsonl"), "a")
        self._params = open(os.path.join(run_dir, "params.jsonl"), "a")

    def log_metrics(self, scores: Dict[str, float], step: int) -> None:
        rec = {"step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in scores.items()})
        self._metrics.write(json.dumps(rec) + "\n")
        self._metrics.flush()

    def log_params(self, params: Dict[str, float], step: int) -> None:
        rec = {"step": step}
        rec.update({k: float(v) for k, v in params.items()})
        self._params.write(json.dumps(rec) + "\n")
        self._params.flush()

    def close(self) -> None:
        self._metrics.close()
        self._params.close()
