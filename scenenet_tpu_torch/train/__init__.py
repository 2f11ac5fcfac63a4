"""Training runtime: the trainer, its metrics, optimizer and checkpoints."""

from scenenet_tpu_torch.train.callbacks import BestMetricTracker, EarlyStopping
from scenenet_tpu_torch.train.checkpoint import (
    CheckpointManager, restore_checkpoint, save_checkpoint,
)
from scenenet_tpu_torch.train.loop import TrainConfig, Trainer, make_device_voxelize_prep
from scenenet_tpu_torch.train.metrics import (
    MetricState, compute_metrics, init_metric_state, update_metrics,
)

__all__ = ["BestMetricTracker", "CheckpointManager", "EarlyStopping", "MetricState",
           "TrainConfig", "Trainer", "compute_metrics", "init_metric_state",
           "make_device_voxelize_prep", "restore_checkpoint", "save_checkpoint",
           "update_metrics"]
