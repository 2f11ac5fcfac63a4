"""The training runtime: train step, epoch loop, checkpoints, early stop.

PyTorch twin of the streaming path of :mod:`scenenet_tpu.train.loop`:

- a **train step** takes a raw padded point batch to the device, voxelizes
  it there (:func:`make_device_voxelize_prep`), runs the forward, the loss
  with the GENEO penalties read from the live parameters, the backward and
  the optimizer step, and adds the batch's confusion counts to counts kept
  on the device — no host sync inside an epoch beyond the data feed;
- the epoch loop keeps per-metric top-k checkpoints and ``last.npz``, early
  stopping, the per-epoch log of the interpretable parameters, and one
  gradient snapshot per epoch.

Not ported yet, and raising where asked for: the device-resident epoch
caches and their ``epoch_chunks`` (ROADMAP A6), mesh training (A12),
resumable snapshots (A7), the bf16 forward and gradient accumulation
(A13), the point-cloud export of a validation sample (A11).
"""

from __future__ import annotations

import dataclasses
import os
import time
import warnings
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import torch
from torch import nn

from scenenet_tpu_torch.ops.voxelize import (
    voxelize_batch, voxelize_batch_binary, voxelize_batch_from_indices,
)
from scenenet_tpu_torch.train.callbacks import BestMetricTracker, EarlyStopping
from scenenet_tpu_torch.train.checkpoint import CheckpointManager, restore_checkpoint
from scenenet_tpu_torch.train.metrics import (
    DEFAULT_BETA, DEFAULT_TAU, METRIC_NAMES, MetricState, compute_metrics,
    init_metric_state, update_metrics,
)
from scenenet_tpu_torch.train.state import resolve_optimizer
from scenenet_tpu_torch.utils.logging import RunLogger


@dataclasses.dataclass
class TrainConfig:
    max_epochs: int = 20
    optimizer: str = "adam"
    learning_rate: float = 1e-3
    tau: float = DEFAULT_TAU
    fbeta: float = DEFAULT_BETA
    accumulate_grad_batches: int = 1
    early_stop_metric: Optional[str] = "train_FBetaScore"
    early_stop_patience: int = 25
    checkpoint_dir: str = "checkpoints"
    checkpoint_top_k: int = 2
    run_dir: str = "runs/default"
    log_gradients: bool = True
    log_pointclouds_every: int = 0  # every N epochs export val sample PLYs (0 = off)
    debug_nans: bool = False        # torch.autograd.set_detect_anomaly around each step
    profile_dir: Optional[str] = None  # write a torch.profiler trace of epoch 0 there
    precision: str = "f32"
    epoch_chunks: int = 1           # dispatches per device-resident epoch
    checkpoint_every_n_steps: int = 0


def _monitor_modes() -> Dict[str, str]:
    """Metric → 'max'|'min' for the per-metric top-k checkpoints, train_
    and val_ alike (a monitor absent from an epoch's scores is skipped)."""
    monitors = {}
    for m in METRIC_NAMES:
        monitors[f"train_{m}"] = "max"
        monitors[f"val_{m}"] = "max"
    monitors["train_loss"] = "min"
    monitors["val_loss"] = "min"
    return monitors


def make_device_voxelize_prep(grid_shape=(64, 64, 64), keep_labels=(15,),
                              binarize=(True, True), use_indices=False):
    """A ``batch_prep`` for :class:`Trainer`: a raw padded point batch
    (points, labels, mask[, flat_idx]) on the device → (x, y) voxel grids
    (B, 1, Z, X, Y) f32.

    ``use_indices`` with a ``flat_idx`` in the batch takes the host-exact
    bin indices of ``PointPadding(compute_indices=True)``
    (:func:`voxelize_batch_from_indices`); otherwise the bins are computed
    on the device from the raw coordinates, by :func:`voxelize_batch_binary`
    when both grids are binarized and by :func:`voxelize_batch` when not.
    ``binarize`` says for x (density) and y (tower fraction) whether the
    grid becomes ``> 0`` as {0, 1}. ``use_indices`` defaults to False here
    (True in the JAX package), as ``PointPadding.compute_indices`` does.
    """
    grid_shape = tuple(int(g) for g in grid_shape)
    keep_labels = tuple(int(k) for k in keep_labels)
    binarize = tuple(bool(v) for v in binarize)

    def prep(points, labels, mask, flat_idx=None):
        if use_indices and flat_idx is not None:
            is_tower = torch.isin(labels, torch.as_tensor(keep_labels, device=labels.device))
            hist, reg = voxelize_batch_from_indices(flat_idx, is_tower, mask, grid_shape)
        elif binarize == (True, True):
            x, y = voxelize_batch_binary(points, labels, mask, keep_labels, grid_shape)
            return x[:, None], y[:, None]
        else:
            hist, reg = voxelize_batch(points, labels, mask, keep_labels, grid_shape)
        x, y = hist[:, None], reg[:, None]
        if binarize[0]:
            x = (x > 0).to(torch.float32)
        if binarize[1]:
            y = (y > 0).to(torch.float32)
        return x, y

    return prep


class Trainer:
    """Trainer for an ``nn.Module`` ``model(x) -> pred`` (optionally with
    ``cvx_coefficients()``, ``geneo_params_flat()``, ``last_lambda`` and
    ``parameters_in_dict()``, which SceneNet has). It trains on the device
    that holds the model's parameters and moves each batch there."""

    def __init__(self, model: nn.Module, criterion: Callable, config: TrainConfig,
                 logger: Optional[RunLogger] = None,
                 batch_prep: Optional[Callable] = None, mesh: Optional[Any] = None):
        if mesh is not None:
            raise NotImplementedError("mesh training is not ported yet: ROADMAP A12")
        if config.precision != "f32":
            raise NotImplementedError(f"precision={config.precision!r} (the bf16 "
                                      "forward) is not ported yet: ROADMAP A13")
        if config.accumulate_grad_batches != 1:
            raise NotImplementedError("accumulate_grad_batches > 1 is not ported yet: "
                                      "ROADMAP A13")
        if config.checkpoint_every_n_steps > 0:
            raise NotImplementedError("checkpoint_every_n_steps > 0 (resumable "
                                      "snapshots) is not ported yet: ROADMAP A7")
        if config.log_pointclouds_every > 0:
            raise NotImplementedError("log_pointclouds_every > 0 (the PLY export of a "
                                      "validation sample, utils/viz.py) is not ported "
                                      "yet: ROADMAP A11")
        if config.epoch_chunks != 1:
            raise NotImplementedError("epoch_chunks != 1 (chunked device-resident "
                                      "epochs) is not ported yet: ROADMAP A6")
        self.model = model
        self.criterion = criterion
        self.config = config
        self.logger = logger or RunLogger(config.run_dir)
        self.batch_prep = batch_prep
        self.device = next(model.parameters()).device
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.step = 0
        self.best = BestMetricTracker()
        self._ckpt: Optional[CheckpointManager] = None

    # ---- steps ---------------------------------------------------------------

    def to_device(self, batch) -> Tuple[torch.Tensor, ...]:
        return tuple(torch.as_tensor(b).to(self.device) for b in batch)

    def _loss(self, x: torch.Tensor, y: torch.Tensor):
        pred = self.model(x).float()
        m = self.model
        cvx = m.cvx_coefficients() if hasattr(m, "cvx_coefficients") else {}
        geneo = m.geneo_params_flat() if hasattr(m, "geneo_params_flat") else {}
        return self.criterion(pred, y, cvx, geneo, getattr(m, "last_lambda", None)), pred

    def setup_optimizer(self) -> torch.optim.Optimizer:
        """A fresh optimizer over the model's trainable parameters."""
        self.optimizer = resolve_optimizer(self.config.optimizer, self.model.parameters(),
                                           self.config.learning_rate)
        return self.optimizer

    def train_step(self, mstate: MetricState, *batch: torch.Tensor
                   ) -> Tuple[MetricState, torch.Tensor]:
        """One optimizer step on a batch already on the device: prep,
        forward, loss, backward, update, confusion counts (of the
        prediction before the update). Returns the counts and the loss."""
        x, y = self.batch_prep(*batch) if self.batch_prep else batch
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        # debug_nans: a NaN made in the forward or the backward raises,
        # naming the operation that made it
        with torch.autograd.set_detect_anomaly(self.config.debug_nans):
            loss, pred = self._loss(x, y)
            if self.config.debug_nans and not bool(torch.isfinite(loss)):
                raise FloatingPointError(f"debug_nans: loss {float(loss.detach())} at step "
                                         f"{self.step}")
            loss.backward()
        self.optimizer.step()
        self.step += 1
        return update_metrics(mstate, pred.detach(), y, self.config.tau), loss.detach()

    @torch.no_grad()
    def eval_step(self, mstate: MetricState, *batch: torch.Tensor
                  ) -> Tuple[MetricState, torch.Tensor, torch.Tensor]:
        x, y = self.batch_prep(*batch) if self.batch_prep else batch
        self.model.eval()
        loss, pred = self._loss(x, y)
        return update_metrics(mstate, pred, y, self.config.tau), loss, pred

    def _grad_stats(self) -> Dict[str, float]:
        """The gradient snapshot of the last step: a frozen parameter's
        gradient is logged as 0."""
        flat = {}
        for name, p in self.model.named_parameters():
            key = name.replace(".", "/")
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            if g.ndim == 0:
                flat[f"grad/{key}"] = float(g)
            else:
                flat[f"gradnorm/{key}"] = float(torch.linalg.norm(g))
                flat[f"gradmean/{key}"] = float(g.mean())
                flat[f"gradstd/{key}"] = float(g.std(unbiased=False))
        return flat

    def _scores(self, loader: Iterable, prefix: str) -> Dict[str, float]:
        mstate = init_metric_state(self.device)
        losses = []
        for batch in loader:
            mstate, loss, _ = self.eval_step(mstate, *self.to_device(batch))
            losses.append(loss)
        scores = {f"{prefix}_{k}": v for k, v in
                  compute_metrics(mstate, self.config.fbeta).items()}
        if losses:
            scores[f"{prefix}_loss"] = float(torch.stack(losses).mean())
        return scores

    def _start_trace(self):
        """A running ``torch.profiler`` over the host and, on a card, the
        device; ``fit`` ends it after epoch 0 and writes the trace."""
        from torch.profiler import ProfilerActivity, profile

        os.makedirs(self.config.profile_dir, exist_ok=True)
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        tracer = profile(activities=activities)
        tracer.__enter__()
        return tracer

    # ---- fit / evaluate ------------------------------------------------------

    def fit(self, train_loader: Iterable, val_loader: Optional[Iterable] = None,
            resume_from: Optional[str] = None) -> Tuple[nn.Module, Dict[str, float]]:
        """Per-batch training loop over a host-fed loader; trains
        ``self.model`` in place from a fresh optimizer state. Returns the
        model and the best value seen of every score."""
        if resume_from is not None:
            raise NotImplementedError("resume_from (resumable snapshots) is not "
                                      "ported yet: ROADMAP A7")
        cfg = self.config
        self.setup_optimizer()
        self._ckpt = ckpt = CheckpointManager(cfg.checkpoint_dir, _monitor_modes(),
                                              top_k=cfg.checkpoint_top_k)
        stopper = (EarlyStopping(cfg.early_stop_metric, cfg.early_stop_patience)
                   if cfg.early_stop_metric else None)
        epoch = 0
        while cfg.max_epochs < 0 or epoch < cfg.max_epochs:
            tracer = self._start_trace() if cfg.profile_dir and epoch == 0 else None
            t0 = time.time()
            mstate = init_metric_state(self.device)
            loss_sum = torch.zeros((), device=self.device)
            loss_count = 0
            grad_logged = False
            for batch in train_loader:
                mstate, loss = self.train_step(mstate, *self.to_device(batch))
                loss_sum = loss_sum + loss
                loss_count += 1
                if cfg.log_gradients and not grad_logged:
                    # one gradient snapshot per epoch
                    self.logger.log_params(self._grad_stats(), self.step)
                    grad_logged = True

            scores = {f"train_{k}": v for k, v in
                      compute_metrics(mstate, cfg.fbeta).items()}
            scores["train_loss"] = (float(loss_sum) / loss_count if loss_count
                                    else float("nan"))
            scores["epoch_time_s"] = time.time() - t0
            if val_loader is not None:
                scores.update(self._scores(val_loader, "val"))

            if hasattr(self.model, "parameters_in_dict"):
                # the interpretable per-epoch parameter series
                self.logger.log_params(self.model.parameters_in_dict(), epoch)
            self.logger.log_metrics(scores, epoch)
            self.best.update(scores)
            ckpt.step(self.model, scores, epoch)
            if tracer is not None:
                tracer.__exit__(None, None, None)
                tracer.export_chrome_trace(os.path.join(cfg.profile_dir, "epoch0_trace.json"))
            if stopper is not None and stopper.update(scores):
                break
            epoch += 1
        return self.model, self.best.best

    def evaluate(self, loader: Iterable, prefix: str = "test") -> Dict[str, float]:
        """Scores and mean loss of ``self.model`` over ``loader``."""
        scores = self._scores(loader, prefix)
        self.logger.log_metrics(scores, -1)
        return scores

    def restore_best(self, metric: str, template: Optional[nn.Module] = None) -> nn.Module:
        """Load the best checkpoint for ``metric`` into ``template`` (default
        the trained model) and return it; where none was recorded (the
        metric absent or non-finite every epoch), load ``last.npz`` with a
        warning."""
        template = self.model if template is None else template
        if self._ckpt is None:
            raise FileNotFoundError("no fit has run: no checkpoint recorded")
        path = self._ckpt.best_path(metric)
        if path is None:
            last = self._ckpt.last_path()
            if last is None:
                raise FileNotFoundError(f"no checkpoint recorded for {metric}")
            warnings.warn(f"no checkpoint recorded for {metric!r} (metric absent or "
                          f"non-finite every epoch); restoring last.npz instead")
            path = last
        return restore_checkpoint(path, template)
