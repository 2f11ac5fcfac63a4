"""Augmented-Lagrangian (ADMM-style) constrained training.

PyTorch twin of :mod:`scenenet_tpu.train.admm`, on one device or over a
mesh of ranks (the ``data`` and ``space`` axes). The
constrained problem

    min_θ L(θ)   s.t.  Σλ = 1 (exact, by the derived last λ),
                        λ_i ≥ 0,  θ_geneo ≥ 0

takes its inequalities in the augmented-Lagrangian form with multipliers
μ ≥ 0 and penalty ρ (g = −x is the violation):

    L_A = L + Σ_c (ρ/2)·[ max(g_c + μ_c/ρ, 0)² − (μ_c/ρ)² ]

with the dual ascent μ ← max(0, μ + ρ·g) after each primal epoch. μ is a
device tensor the primal step reads, so no step depends on its value on
the host. Any resolvable optimizer takes the primal steps, L-BFGS with its
zoom linesearch included (``experiments/admm.yaml``). Over a mesh the
primal step is the Trainer's mesh step with the augmented term added to
the distributed data loss; the constraint term and the dual update read
only the parameters, which every rank holds alike.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import torch
from torch import nn

from scenenet_tpu_torch.geneo.kernels import KERNEL_REGISTRY
from scenenet_tpu_torch.train.callbacks import BestMetricTracker, EarlyStopping
from scenenet_tpu_torch.train.checkpoint import CheckpointManager
from scenenet_tpu_torch.train.lbfgs import LBFGS
from scenenet_tpu_torch.train.loop import TrainConfig, Trainer, _in_mesh, _monitor_modes
from scenenet_tpu_torch.train.metrics import compute_metrics, init_metric_state
from scenenet_tpu_torch.train.state import resolve_optimizer


@dataclasses.dataclass
class ADMMConfig(TrainConfig):
    admm_rho: float = 1.0


def _constraint_values(model: nn.Module) -> torch.Tensor:
    """The stacked constraint arguments x_c (feasible where x_c ≥ 0): the
    effective λs, then every GENEO scalar, observer by observer in its
    kernel's parameter order (the JAX package's order, and so its μ's)."""
    lams = model.effective_lambdas()
    geneo = [model.geneo[name][p] for name, kind in model.observers
             for p in KERNEL_REGISTRY[kind].parameters]
    return torch.cat([lams.reshape(-1), torch.stack(geneo).reshape(-1)])


def augmented_loss(data_loss: torch.Tensor, values: torch.Tensor, mu: torch.Tensor,
                   rho: float) -> torch.Tensor:
    """data loss + Σ_c (ρ/2)·[max(−x_c + μ_c/ρ, 0)² − (μ_c/ρ)²]."""
    g = -values
    shifted = torch.maximum(g + mu / rho, torch.zeros_like(g))
    return data_loss + torch.sum(0.5 * rho * (shifted ** 2 - (mu / rho) ** 2))


class ADMMTrainer:
    """The outer dual loop over primal steps on the augmented loss.

    ``criterion`` is a data-term criterion (WeightedMSE, FocalTversky, ...);
    its own constraint penalties are bypassed (it gets no coefficients):
    the multipliers own the constraints. Validation, the test scores,
    :meth:`predict` and :meth:`restore_best` run through a plain
    :class:`Trainer` on the data criterion. ``fit`` trains ``self.model``
    in place. ``history`` holds each epoch's largest violation, ‖μ‖ and
    train loss.

    ``mesh`` (the ``data`` and ``space`` axes): the primal step runs over the
    mesh's ranks as ``Trainer(mesh=...)``'s does: the batch over ``data``, Z
    over ``space`` (the halo-exchange forward), the gradients and the loss
    averaged and the confusion counts summed. A ``model`` axis wider than 1
    is refused, as the train CLI refuses ``constrained: admm`` with
    ``mesh_ensemble`` or ``mesh_channel``.
    """

    def __init__(self, model: nn.Module, criterion: Callable, config: ADMMConfig,
                 logger=None, batch_prep: Optional[Callable] = None, mesh: Optional[Any] = None):
        from scenenet_tpu_torch.utils.logging import NullLogger, RunLogger

        if mesh is not None and mesh.size > 1 and mesh.shape.get("model", 1) > 1:
            raise ValueError("constrained=admm shards over data/space only (no "
                             f"ensemble/channel axis); got mesh {dict(mesh.shape)}")
        self.model = model
        self.criterion = criterion
        self.config = config
        self.batch_prep = batch_prep
        self.device = next(model.parameters()).device
        self.history: list = []
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.step = 0
        self.best = BestMetricTracker()
        # validates the config as the trainer does (the mesh's guards too), runs
        # the mesh's pieces of the step, and evaluates on the data term
        self._inner = Trainer(model, criterion, config, logger=NullLogger(),
                              batch_prep=batch_prep, mesh=mesh)
        self.mesh = self._inner.mesh
        self.logger = logger or (RunLogger(config.run_dir, use_wandb=config.use_wandb)
                                 if self._inner._writes else NullLogger())
        self._inner.logger = self.logger
        self._ckpt: Optional[CheckpointManager] = None

    def _augmented(self, x: torch.Tensor, y: torch.Tensor, mu: torch.Tensor, rho: float):
        inner = self._inner
        net = inner._spatial if inner._spatial is not None else self.model
        pred = net(x)
        data = inner.distributed_criterion()(pred, y, {}, {}, None)
        return augmented_loss(data, _constraint_values(self.model), mu, rho), pred

    @_in_mesh
    def fit(self, train_loader: Iterable, val_loader: Optional[Iterable] = None
            ) -> Tuple[nn.Module, Dict[str, float]]:
        cfg = self.config
        model = self.model
        rho = float(cfg.admm_rho)
        with torch.no_grad():
            mu = torch.zeros(_constraint_values(model).shape[0], device=self.device)
        self.optimizer = opt = resolve_optimizer(cfg.optimizer, model.parameters(),
                                                 cfg.learning_rate)
        inner = self._inner
        inner.optimizer, inner.multi_steps = opt, None
        inner._replicate()
        self.best = BestMetricTracker()
        self._ckpt = ckpt = CheckpointManager(cfg.checkpoint_dir, _monitor_modes(),
                                              top_k=cfg.checkpoint_top_k, write=inner._writes)
        stopper = (EarlyStopping(cfg.early_stop_metric, cfg.early_stop_patience)
                   if cfg.early_stop_metric else None)
        for epoch in range(max(cfg.max_epochs, 1)):
            mstate = init_metric_state(self.device)
            losses = []
            for batch in train_loader:
                batch = inner.shard(batch)
                x, y = self.batch_prep(*batch) if self.batch_prep else batch
                if self.batch_prep is not None:
                    x, y = inner._slab(x), inner._slab(y)
                model.train()
                opt.zero_grad(set_to_none=True)
                loss, pred = self._augmented(x, y, mu, rho)
                loss.backward()
                loss = inner._reduce_step(loss.detach())
                if isinstance(opt, LBFGS):
                    def closure(x=x, y=y):
                        opt.zero_grad(set_to_none=True)
                        value, _ = self._augmented(x, y, mu, rho)
                        value.backward()
                        return value.detach()

                    if self.mesh is not None:
                        # every rank's linesearch sees the global value and slope
                        from scenenet_tpu_torch.parallel.dp import linesearch_value_fn

                        closure = linesearch_value_fn(closure, model.parameters(),
                                                      inner._axes, self.mesh)
                    opt.step(closure, loss)
                else:
                    opt.step()
                self.step += 1
                mstate = inner._count(mstate, pred.detach(), y)
                losses.append(loss)
            with torch.no_grad():  # the dual update
                g = -_constraint_values(model)
                mu = torch.maximum(torch.zeros_like(mu), mu + rho * g)
                max_violation = float(torch.clamp(g, min=0.0).max())
            mu_norm = float(torch.linalg.vector_norm(mu))
            scores = {f"train_{k}": v for k, v in compute_metrics(mstate, cfg.fbeta).items()}
            scores["train_loss"] = (float(torch.stack(losses).mean()) if losses
                                    else float("nan"))
            scores["admm_max_violation"] = max_violation
            scores["admm_mu_norm"] = mu_norm
            if val_loader is not None:
                # validation on the data criterion: the multipliers own the constraints
                scores.update(self._inner.evaluate(val_loader, "val"))
            self.logger.log_metrics(scores, epoch)
            self.best.update(scores)
            ckpt.step(model, scores, epoch)
            self.history.append({"epoch": epoch, "max_violation": max_violation,
                                 "mu_norm": mu_norm, "train_loss": scores["train_loss"]})
            if stopper is not None and stopper.update(scores):
                break
        self.mu = mu
        inner._barrier()  # the first rank's checkpoints are written for every rank
        return model, self.best.best

    # after the fit: a plain Trainer on the data criterion
    def evaluate(self, loader: Iterable, prefix: str = "test") -> Dict[str, float]:
        return self._inner.evaluate(loader, prefix)

    def predict(self, loader: Iterable):
        return self._inner.predict(loader)

    def restore_best(self, metric: str, template: Optional[nn.Module] = None) -> nn.Module:
        self._inner._ckpt = self._ckpt
        return self._inner.restore_best(metric, template)
