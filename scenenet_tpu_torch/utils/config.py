"""Typed experiment configuration (YAML or ``--set`` overrides).

Twin of :mod:`scenenet_tpu.utils.config` with the same fields and
defaults, so one YAML file configures both packages: one dataclass covers
the key surface of ``experiments/defaults.yaml``; YAML files may be flat
(``key: value``) or wandb-style (``key: {value: ...}``). Tuples may be
written as YAML lists or as stringified tuples (``"(9, 5, 5)"``, parsed
with ``ast.literal_eval``).

``yaml`` is imported only when a file is given: a run configured by
overrides alone needs no PyYAML. Sweeps: :func:`sample_sweep` draws override
dicts from a wandb-style random sweep spec, the same draws as the JAX
function for the same seed.
"""

from __future__ import annotations

import ast
import dataclasses
import random
from typing import Any, Dict, List, Optional, Tuple


@dataclasses.dataclass
class ExperimentConfig:
    """Every field of the JAX package's config, with the same defaults. The
    port's train CLI reads what its path runs and raises, naming the
    ROADMAP item, where a value asks for what is not ported."""

    # experiment
    project: str = "scenenet_ts40k"
    output_dir: str = "experiments/outputs"
    seed: int = 0

    # dataset
    dataset: str = "ts40k"
    data_path: str = ""
    batch_size: int = 4
    voxel_grid_size: Tuple[int, int, int] = (64, 64, 64)
    voxel_size: Optional[Tuple[float, float, float]] = None
    num_workers: int = 8
    val_split: float = 0.1
    test_split: float = 0.3  # fit/test folder fraction at ETL time
    keep_labels: Tuple[int, ...] = (15,)
    device_voxelization: bool = True   # voxelize on the device, in the step
    max_points: int = 65536
    # epochs resident on the device: "auto" | False | True | "points" | "grids"
    device_cache: Any = "auto"
    augment: bool = False  # on-device augmentation of the cached epochs

    # model
    model: str = "scenenet"  # "scenenet" | "quantile" | "cnn" | "unet" | "nnunet"
    quantiles: Tuple[float, ...] = (0.1, 0.5, 0.9)  # model: quantile
    fast_dev_run: bool = False
    auto_lr_find: bool = False
    auto_scale_batch_size: bool = False
    # "auto" | "xla" | "pallas" | "pallas_mxu" | "autotune" in the JAX
    # package; the port reads "auto" | "torch" | "cuda" (auto: cuda on a
    # card, torch on the CPU)
    model_backend: str = "auto"
    cylinder_geneo: int = 1
    arrow_geneo: int = 1
    neg_sphere_geneo: int = 1
    kernel_size: Tuple[int, int, int] = (9, 5, 5)
    geneo_init: str = "random"  # "random" | "smart"

    # training
    optimizer: str = "adam"
    learning_rate: float = 1e-3
    constrained: str = "penalty"  # "penalty" (hinge penalties in the loss) | "admm"
    admm_rho: float = 1.0
    max_epochs: int = 20
    early_stop_metric: Optional[str] = "train_FBetaScore"
    early_stop_patience: int = 25
    accumulate_grad_batches: int = 1
    tau: float = 0.65
    compiler_options: Optional[Dict[str, Any]] = None  # XLA only
    precision: str = "f32"  # "f32" | "bf16"

    # criterion
    criterion: str = "geneo_tversky"
    weighting_scheme_path: Optional[str] = None  # None → bundled fixture
    weight_alpha: float = 1.0
    weight_epsilon: float = 0.1
    mse_weight: float = 1.0
    convex_weight: float = 5.0
    tversky_alpha: float = 2.0
    tversky_beta: float = 1.0
    tversky_smooth: float = 1e-6
    focal_gamma: float = 4.0

    # checkpoints / resume
    checkpoint_dir: str = ""
    checkpoint_top_k: int = 2
    resume_from_checkpoint: bool = False
    resume_checkpoint_name: str = "last"
    test_checkpoint: str = "best"  # test with the "best" or the "last" params
    epoch_chunks: int = 1
    checkpoint_every_n_steps: int = 0
    resume_preempted: bool = True

    # parallel: device-mesh axes; their product is the device count
    mesh_data: int = 1
    mesh_space: int = 1
    mesh_dcn_data: int = 1
    mesh_ensemble: int = 1
    mesh_channel: int = 1

    # logging / export
    use_wandb: bool = False
    export_stablehlo: bool = False

    def criterion_params(self) -> Dict[str, Any]:
        return {
            "weighting_scheme_path": self.weighting_scheme_path,
            "weight_alpha": self.weight_alpha,
            "weight_epsilon": self.weight_epsilon,
            "mse_weight": self.mse_weight,
            "convex_weight": self.convex_weight,
            "tversky_alpha": self.tversky_alpha,
            "tversky_beta": self.tversky_beta,
            "tversky_smooth": self.tversky_smooth,
            "focal_gamma": self.focal_gamma,
        }

    def grid_zxy(self) -> Tuple[int, int, int]:
        """Grid tensor extents in tensor order (n_z, n_x, n_y).
        ``voxel_grid_size`` is in config order (n_x, n_y, n_z); the voxel
        tensors are (B, 1, Z, X, Y), which is not the plain reverse."""
        g = self.voxel_grid_size
        return (g[2], g[0], g[1])

    def geneo_num(self) -> Dict[str, int]:
        return {
            "cy": self.cylinder_geneo,
            "cone": self.arrow_geneo,
            "neg": self.neg_sphere_geneo,
        }


_TUPLE_FIELDS = {"voxel_grid_size", "voxel_size", "kernel_size",
                 "keep_labels", "quantiles"}


def _coerce(name: str, value: Any) -> Any:
    if name in _TUPLE_FIELDS:
        if value is None or (isinstance(value, str)
                             and value.lower() in ("none", "null")):
            return None
        if isinstance(value, str):
            value = ast.literal_eval(value)
        if isinstance(value, (int, float)):
            # scalar spellings ("keep_labels: 15", "voxel_size: 0.5")
            # broadcast to the field's arity
            if name in ("keep_labels", "quantiles"):
                return (value,)
            return (value,) * 3
        return tuple(value)
    if isinstance(value, str) and value.lower() in ("none", "null"):
        # YAML-style null / python None spellings from --set overrides
        return None
    return value


def load_config(path: Optional[str] = None, overrides: Optional[Dict] = None) -> ExperimentConfig:
    raw: Dict[str, Any] = {}
    if path:
        import yaml

        with open(path) as f:
            doc = yaml.safe_load(f) or {}
        for key, val in doc.items():
            if isinstance(val, dict) and set(val) == {"value"}:
                val = val["value"]  # wandb defaults format
            raw[key] = val
    if overrides:
        raw.update(overrides)
    fields = {f.name for f in dataclasses.fields(ExperimentConfig)}
    known = {k: _coerce(k, v) for k, v in raw.items() if k in fields}
    unknown = set(raw) - fields
    if unknown:
        print(f"[config] ignoring unknown keys: {sorted(unknown)}")
    return ExperimentConfig(**known)


def sample_sweep(sweep_path: str, n: int, seed: int = 0) -> List[Dict[str, Any]]:
    """Draw ``n`` override dicts from a wandb-style random sweep spec: its
    ``parameters`` in file order, each a choice of ``values``, a uniform
    draw between ``min`` and ``max`` (an integer one where both are
    integers) or a fixed ``value``, from ``random.Random(seed)``."""
    import yaml

    with open(sweep_path) as f:
        spec = yaml.safe_load(f)
    params = spec.get("parameters", {})
    rng = random.Random(seed)
    draws = []
    for _ in range(n):
        cfg = {}
        for key, dist in params.items():
            if "values" in dist:
                cfg[key] = rng.choice(dist["values"])
            elif "min" in dist and "max" in dist:
                lo, hi = dist["min"], dist["max"]
                if isinstance(lo, int) and isinstance(hi, int):
                    cfg[key] = rng.randint(lo, hi)
                else:
                    cfg[key] = rng.uniform(lo, hi)
            elif "value" in dist:
                cfg[key] = dist["value"]
        draws.append(cfg)
    return draws
