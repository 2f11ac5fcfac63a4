"""Train + test entry point.

PyTorch twin of ``scenenet_tpu.cli.train`` for SCENE-Net on TS40K: builds
criterion → model → data → trainer from a config, fits with per-metric
checkpoints and early stopping on the streaming loader, then tests with the
best checkpoint.

Usage:
    python -m scenenet_tpu_torch.cli.train --config experiments/defaults.yaml \\
        [--set key=value ...] [--device cuda|cpu] [--host-indices]

``--host-indices`` takes the host-exact route: the loader computes each
point's bin in float64 (pyntcloud parity) and the device only counts. The
JAX CLI takes that route whenever its native loader is absent; the port has
no native loader yet, so a flag selects it. ``--device`` defaults to ``cuda`` and raises without a card; ``cpu`` runs
the kernels' plain versions. A run configured by ``--set`` alone needs no
PyYAML. What the config asks for and the port does not have yet raises,
naming its ROADMAP item.
"""

from __future__ import annotations

import argparse
import ast
import os
from typing import Dict, List, Optional

from scenenet_tpu_torch.cli.serve import resolve_device
from scenenet_tpu_torch.data import PointCloudLoader, PointPadding, Subset, TS40K, random_split
from scenenet_tpu_torch.losses import resolve_criterion
from scenenet_tpu_torch.models import SceneNet
from scenenet_tpu_torch.train import TrainConfig, Trainer, make_device_voxelize_prep
from scenenet_tpu_torch.train.checkpoint import restore_checkpoint
from scenenet_tpu_torch.utils.config import ExperimentConfig, load_config
from scenenet_tpu_torch.utils.seeding import fix_randomness

# the JAX package's backend names, mapped onto the port's
_BACKENDS = {"torch": "torch", "xla": "torch", "cuda": "cuda", "pallas": "cuda",
             "cuda_mxu": "cuda_mxu", "pallas_mxu": "cuda_mxu"}


def _refuse_unported(cfg: ExperimentConfig) -> None:
    """Raise, naming the ROADMAP item, on every value that asks for
    something the port does not have yet."""
    if cfg.model != "scenenet":
        raise NotImplementedError(f"model {cfg.model!r} is not ported yet: ROADMAP A8")
    if cfg.dataset != "ts40k":
        raise NotImplementedError(f"dataset {cfg.dataset!r} is not ported yet: ROADMAP A0")
    meshes = {k: getattr(cfg, k) for k in ("mesh_data", "mesh_space", "mesh_dcn_data",
                                           "mesh_ensemble", "mesh_channel")}
    if any(int(v) > 1 for v in meshes.values()):
        raise NotImplementedError(f"mesh training {meshes} is not ported yet: ROADMAP A12")
    if cfg.constrained == "admm":
        raise NotImplementedError("constrained='admm' is not ported yet: ROADMAP A7")
    for tuner in ("auto_lr_find", "auto_scale_batch_size"):
        if getattr(cfg, tuner):
            raise NotImplementedError(f"{tuner} is not ported yet: ROADMAP A7")
    if cfg.model_backend == "autotune":
        raise NotImplementedError("model_backend='autotune' is not ported yet: ROADMAP A7")
    if cfg.fast_dev_run:
        raise NotImplementedError("fast_dev_run is not ported yet: ROADMAP A10")
    if not cfg.device_voxelization:
        raise NotImplementedError("device_voxelization=False (host voxelization) is "
                                  "not ported yet: ROADMAP A0")
    if cfg.geneo_init != "random":
        raise NotImplementedError(f"geneo_init={cfg.geneo_init!r} is not ported yet: "
                                  "ROADMAP A2")
    if cfg.export_stablehlo:
        raise NotImplementedError("export_stablehlo is not ported yet: ROADMAP A11")
    if cfg.use_wandb:
        raise NotImplementedError("use_wandb is not ported yet: ROADMAP A10")


def resolve_device_cache(cfg: ExperimentConfig) -> bool:
    """``auto`` resolves to the streaming loader (no device cache), and says
    so; an explicit cache raises."""
    if cfg.device_cache == "auto":
        print("[device_cache auto] -> false (device-resident epochs are not ported "
              "yet: ROADMAP A6)")
        return False
    if cfg.device_cache not in (False, None, "false", "False"):
        raise NotImplementedError(f"device_cache={cfg.device_cache!r} (device-resident "
                                  "epochs) is not ported yet: ROADMAP A6")
    return False


def resolve_backend(cfg: ExperimentConfig, device) -> str:
    """``auto`` → ``cuda`` on a card, ``torch`` on the CPU."""
    if cfg.model_backend == "auto":
        return "cuda" if device.type == "cuda" else "torch"
    if cfg.model_backend not in _BACKENDS:
        raise ValueError(f"model_backend must be auto or one of {sorted(_BACKENDS)}, "
                         f"got {cfg.model_backend!r}")
    return _BACKENDS[cfg.model_backend]


def run(cfg: ExperimentConfig, device: "str | None" = "cuda",
        host_indices: bool = False) -> Dict[str, float]:
    device = resolve_device(device)
    _refuse_unported(cfg)
    resolve_device_cache(cfg)
    fix_randomness(cfg.seed)
    run_dir = os.path.join(cfg.output_dir, cfg.project)
    ckpt_dir = cfg.checkpoint_dir or os.path.join(run_dir, "checkpoints")

    criterion = resolve_criterion(cfg.criterion)(**cfg.criterion_params())
    model = SceneNet.create(cfg.geneo_num(), cfg.kernel_size, seed=cfg.seed,
                            backend=resolve_backend(cfg, device)).to(device)
    if cfg.resume_from_checkpoint:
        ckpt_path = os.path.join(ckpt_dir, cfg.resume_checkpoint_name + ".npz")
        if not os.path.exists(ckpt_path):
            raise FileNotFoundError(f"Checkpoint {ckpt_path} does not exist.")
        restore_checkpoint(ckpt_path, model)

    # raw padded points; the bins are computed on the device (the route of
    # the JAX package's native loader) unless host_indices asks for the
    # host-exact float64 bin index of every point
    transform = PointPadding(max_points=cfg.max_points, vxg_size=cfg.voxel_grid_size,
                             vox_size=cfg.voxel_size, compute_indices=host_indices)
    fit = TS40K(cfg.data_path, split="fit", transform=transform)
    test_ds = TS40K(cfg.data_path, split="test", transform=transform)
    train_idx, val_idx = random_split(len(fit), cfg.val_split, seed=cfg.seed)
    train_ds, val_ds = Subset(fit, train_idx), Subset(fit, val_idx)
    train_loader = PointCloudLoader(train_ds, cfg.batch_size, shuffle=True,
                                    num_workers=cfg.num_workers, seed=cfg.seed,
                                    drop_last=len(train_ds) >= cfg.batch_size)
    val_loader = PointCloudLoader(val_ds, cfg.batch_size, num_workers=cfg.num_workers)
    test_loader = PointCloudLoader(test_ds, cfg.batch_size, num_workers=cfg.num_workers)

    tcfg = TrainConfig(
        max_epochs=cfg.max_epochs, optimizer=cfg.optimizer,
        learning_rate=cfg.learning_rate, tau=cfg.tau,
        accumulate_grad_batches=cfg.accumulate_grad_batches,
        early_stop_metric=cfg.early_stop_metric,
        early_stop_patience=cfg.early_stop_patience, checkpoint_dir=ckpt_dir,
        checkpoint_top_k=cfg.checkpoint_top_k, run_dir=run_dir,
        precision=cfg.precision, checkpoint_every_n_steps=cfg.checkpoint_every_n_steps)
    prep = make_device_voxelize_prep(cfg.voxel_grid_size, tuple(cfg.keep_labels),
                                     use_indices=host_indices)
    trainer = Trainer(model, criterion, tcfg, batch_prep=prep)
    _, best = trainer.fit(train_loader, val_loader if len(val_ds) else None)

    print(f"{'=' * 20} best scores {'=' * 20}")
    for k, v in sorted(best.items()):
        print(f"  {k}: {v:.4f}")

    # test with the best checkpoint; the final parameters where none qualified
    if cfg.test_checkpoint == "best":
        metric = cfg.early_stop_metric or "train_FBetaScore"
        try:
            trainer.restore_best(metric)
            print(f"[test] using best '{metric}' checkpoint")
        except (FileNotFoundError, KeyError) as e:
            print(f"[test] best checkpoint unavailable ({e}); using final params")
    test_scores = trainer.evaluate(test_loader, prefix="test")
    for k, v in sorted(test_scores.items()):
        print(f"  {k}: {v:.4f}")
    return {**best, **test_scores}


def parse_overrides(pairs: List[str]) -> Dict[str, object]:
    """``key=value`` strings → a dict, each value read as a Python literal
    where it is one (``(9, 5, 5)``, ``1e-3``, ``None``) and kept as a string
    where it is not."""
    overrides = {}
    for kv in pairs:
        key, val = kv.split("=", 1)
        try:
            overrides[key] = ast.literal_eval(val)
        except (ValueError, SyntaxError):
            overrides[key] = val
    return overrides


def main(argv: Optional[List[str]] = None) -> Dict[str, float]:
    parser = argparse.ArgumentParser(description="Train SCENE-Net (PyTorch)")
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--set", action="extend", nargs="*", default=[],
                        help="config overrides key=value (repeatable)")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cpu runs the kernels' plain versions")
    parser.add_argument("--host-indices", action="store_true",
                        help="bin on the host in float64 (pyntcloud parity); the device "
                             "counts the given indices")
    parser.add_argument("--sweep", type=str, default=None, help="not ported yet")
    args = parser.parse_args(argv)
    if args.sweep:
        raise NotImplementedError("--sweep (random-search sweeps) is not ported yet: "
                                  "ROADMAP A10")
    return run(load_config(args.config, parse_overrides(args.set)), device=args.device,
               host_indices=args.host_indices)


if __name__ == "__main__":
    main()
