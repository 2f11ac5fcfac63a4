"""nnU-Net's ``3d_fullres`` network trained from crops streamed off disk:
:mod:`perfbench.routes.stream_train`'s route (TS40K samples under
``TMPDIR``, the native loader, ``Trainer.train_step`` eagerly, the first
steps read for the check) with the program's ``NNUNet3D`` and its
criterion wrapped in ``DeepSupervision``, as ``cli.train --set
model=nnunet`` builds them.

Set-up imports the model first, so that a program without it fails at
once, before any crop is written. Weights are He-normal from the seed
(:func:`he_weights`); the reference is ``reference/nnunet.py`` on grids
binned by the divide recipe. A traced run also counts the wrappers'
launches over its steps (``launches``), which the per-layer readers check
their rules against.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from perfbench import check, program, synth
from perfbench.reference import nnunet as ref_nnunet
from perfbench.routes import stream_train
from perfbench.trace import Phases

HE_SLOPE = 1e-2


def he_weights(seed: int, shapes: Dict[str, Tuple[int, ...]], device) -> Dict[str, torch.Tensor]:
    """The network's weights from ``seed`` in one draw on ``device``, as
    nnU-Net's ``InitWeights_He(1e-2)``: every conv, transposed-conv and
    head weight normal with standard deviation ``sqrt(2 / (1 + 0.01²)) /
    sqrt(fan_in)`` (fan_in: ``shape[1]`` × the taps), biases 0,
    InstanceNorm scale 1 and bias 0."""
    gen = torch.Generator(device).manual_seed(synth.sub_seed(seed, 4))
    drawn = [n for n, s in shapes.items() if len(s) == 5]
    flat = torch.randn(sum(math.prod(shapes[n]) for n in drawn), generator=gen, device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        if name in drawn:
            size = math.prod(shape)
            std = math.sqrt(2.0 / (1.0 + HE_SLOPE ** 2)) / math.sqrt(math.prod(shape[1:]))
            out[name] = (flat[at:at + size] * std).view(shape)
            at += size
        elif name.endswith(".norm_weight"):
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


def plant_faults(trainer, faults) -> None:
    """:func:`perfbench.program.plant_training_faults` for a prediction that
    is a sequence of outputs: ``half_batch`` cuts every output and the
    target to the batch's first half."""
    faults = set(faults)
    program.plant_training_faults(trainer, faults - {"half_batch"})
    if "half_batch" in faults:
        criterion = trainer.criterion

        def half(pred, y, *args):
            b = max(y.shape[0] // 2, 1)
            pred = [p[:b] for p in pred] if isinstance(pred, (list, tuple)) else pred[:b]
            return criterion(pred, y[:b], *args)

        trainer.criterion = half


class Route(stream_train.Route):
    def setup(self) -> None:
        self.phases = phases = Phases()
        from scenenet_tpu_torch.models import NNUNet3D  # first: the parent's program has none
        from scenenet_tpu_torch import native
        from scenenet_tpu_torch.data import TS40K, NativePointCloudLoader
        from scenenet_tpu_torch.losses import DeepSupervision, resolve_criterion
        from scenenet_tpu_torch.train import TrainConfig, Trainer, make_device_voxelize_prep
        from scenenet_tpu_torch.train.metrics import init_metric_state
        from scenenet_tpu_torch.utils.logging import NullLogger

        cfg, tr, dev = self.cfg, self.traffic, self.device
        if not native.available():
            raise RuntimeError("the native loader did not build: the route needs it")
        phases.mark("import")
        root = self._write_crops()
        phases.mark("crops")
        loader = NativePointCloudLoader(
            TS40K(root, split="fit"), tr["batch_size"], shuffle=True,
            seed=synth.sub_seed(self.seed, 6), max_points=tr["points"]["pad"],
            threads=tr["loader_threads"], drop_last=True)
        self.loader = stream_train._Timed(loader)
        model = NNUNet3D(cfg["features"], cfg["strides"], cfg["in_channels"], cfg["n_classes"],
                         cfg["convs_per_stage"],
                         backend="cuda" if dev.type == "cuda" else "torch").to(dev)
        self.before = he_weights(self.seed, ref_nnunet.param_shapes(cfg), dev)
        program.write_weights(model, self.before)
        prep = make_device_voxelize_prep(tuple(cfg["voxel_grid_size"]), tuple(cfg["keep_labels"]),
                                         use_indices=False)
        criterion = DeepSupervision(resolve_criterion(cfg["criterion"])(**cfg["criterion_params"]))
        losses: List[torch.Tensor] = []

        def recorded(pred, y, *args):  # each step's loss, for the check's first steps
            loss = criterion(pred, y, *args)
            if len(losses) < tr["check_steps"]:
                losses.append(loss.detach())
            return loss

        tcfg = TrainConfig(optimizer=cfg["optimizer"], learning_rate=cfg["learning_rate"],
                           tau=cfg["tau"], precision=cfg["precision"], early_stop_metric=None,
                           log_gradients=False)
        trainer = Trainer(model, recorded, tcfg, logger=NullLogger(), batch_prep=prep)
        trainer.setup_optimizer()
        plant_faults(trainer, self.faults)
        self.model, self.trainer = model, trainer
        self.mstate = init_metric_state(dev)
        self.loss_sum = torch.zeros((), device=dev)
        phases.mark("model")
        self.batches, grads = [], {}
        for i in range(tr["check_steps"]):
            batch_np = self._step()
            self.batches.append(tuple(np.array(a) for a in batch_np[:3]))
            if i == 0:
                grads = program.adam_gradients(model, trainer.optimizer)
        self.program = {"losses": [float(v) for v in losses], "grads": grads,
                        "params": program.snapshot(model),
                        "counts": torch.stack(list(self.mstate)).cpu()}
        phases.mark("first_steps")

    def traced(self):
        from scenenet_tpu_torch.ops._build import launch_counts

        before = launch_counts()
        out = super().traced()
        out["launches"] = {k: v - before.get(k, 0) for k, v in launch_counts().items()}
        return out

    def reference(self, precision: str = "f32") -> dict:
        cfg = self.cfg
        inputs, mismatch = self._inputs()
        batches = [ref_nnunet.training_grids(p, l, m, cfg["keep_labels"],
                                             tuple(cfg["voxel_grid_size"]))
                   for p, l, m in inputs]
        out = ref_nnunet.train(cfg, self.before, batches, self.device, precision)
        out["batch_mismatch"] = mismatch
        return out

    def _compare(self, readings: dict, ref: dict) -> List[check.Compare]:
        limits = self.traffic["limits"]
        before = {n: v.cpu() for n, v in self.before.items()}
        return [check.Compare("batch_mismatch", ref["batch_mismatch"],
                              limits["batch_mismatch"])] + \
            check.training_numbers(readings, ref, before, limits)
