"""SceneNet trained from the device-resident grid cache: the route
``cli.train`` takes by ``device_cache: auto`` for the defaults.

Set-up makes the crops on the device, builds ``DeviceGridCache`` (K3 once
over the dataset), and drives ``CachedEpochs`` as ``Trainer.fit_grid_cached``
does: its first steps (three eager warm-ups, then the capture and the first
replay of the CUDA graph) are read for the check, and the rest of the
first epoch warms the epoch's boundary. The window runs whole epochs, each
one graph replay a step and, at its end, the fit's read of the epoch's
counts and loss (a synchronise); the fit's checkpoint writes are left out.
"""

from __future__ import annotations

import time
from typing import Dict, List

import torch

from perfbench import check, program, synth, weights
from perfbench.trace import Phases
from perfbench.reference import scenenet as ref_scenenet
from perfbench.reference import voxel as ref_voxel


class _Points:
    """The padded crops as ``DeviceGridCache`` reads a point cache."""

    def __init__(self, points, labels, mask):
        self.points, self.labels, self.mask = points, labels, mask

    def __len__(self) -> int:
        return int(self.points.shape[0])


class Route:
    def __init__(self, cell, seed: int, device: torch.device, faults=()):
        self.cfg, self.traffic, self.seed = cell.config, cell.traffic, seed
        self.device, self.faults = device, tuple(faults)

    def setup(self) -> None:
        self.phases = phases = Phases()
        from scenenet_tpu_torch.data.device_cache import DeviceGridCache
        from scenenet_tpu_torch.losses import resolve_criterion
        from scenenet_tpu_torch.models import SceneNet
        from scenenet_tpu_torch.train import TrainConfig, Trainer, make_device_voxelize_prep
        from scenenet_tpu_torch.train.loop import CachedEpochs
        from scenenet_tpu_torch.utils.logging import NullLogger

        phases.mark("import")
        cfg, tr, dev = self.cfg, self.traffic, self.device
        batch, steps = tr["batch_size"], tr["check_steps"]
        pts = tr["points"]
        sizes = synth.crop_sizes(self.seed, tr["crops"], pts["min"], pts["max"])
        points, labels, mask = synth.crops(self.seed, sizes, pts["pad"], dev)
        # the epochs' permutations come from this generator, as cli.train seeds one
        gen_seed = synth.sub_seed(self.seed, 5)
        order = torch.randperm(len(sizes), generator=torch.Generator(dev).manual_seed(gen_seed),
                               device=dev)
        self.rows = order[: steps * batch]
        self.inputs = tuple(t.index_select(0, self.rows) for t in (points, labels, mask))
        phases.mark("crops")

        grid = tuple(cfg["voxel_grid_size"])
        prep = make_device_voxelize_prep(grid, tuple(cfg["keep_labels"]), use_indices=False)
        grids = DeviceGridCache(_Points(points, labels, mask), prep)
        del points, labels, mask
        phases.mark("grid_cache")
        self.weights = weights.scenenet_weights(self.seed, cfg)
        model = SceneNet(geneo_num=tuple(cfg["geneo_num"].items()),
                         kernel_size=tuple(cfg["kernel_size"]), version=cfg["version"],
                         last_lambda=self.weights["last_lambda"],
                         backend="cuda" if dev.type == "cuda" else "torch").to(dev)
        program.write_weights(model, self.weights["values"])
        criterion = resolve_criterion(cfg["criterion"])(**cfg["criterion_params"])
        tcfg = TrainConfig(optimizer=cfg["optimizer"], learning_rate=cfg["learning_rate"],
                           tau=cfg["tau"], precision=cfg["precision"], early_stop_metric=None,
                           log_gradients=False)
        trainer = Trainer(model, criterion, tcfg, logger=NullLogger(), batch_prep=prep)

        def draw(gen, n_batches):  # augment: false
            return {}

        def load(rows, draws, cursor):
            return (grids.x.index_select(0, rows).to(torch.float32),
                    grids.y.index_select(0, rows).to(torch.float32))

        epochs = CachedEpochs(trainer, len(grids), batch, draw, load,
                              torch.Generator(dev).manual_seed(gen_seed))
        program.plant_training_faults(trainer, self.faults)
        self.grids, self.model, self.trainer, self.epochs = grids, model, trainer, epochs

        phases.mark("model")
        # the first steps, read for the check
        losses: List[float] = []
        grads: Dict[str, torch.Tensor] = {}
        epochs.begin_epoch()
        epochs.cursor.fill_(0)
        for i in range(steps):
            self._step()
            losses.append(float(epochs.last_loss))
            if i == 0:
                grads = program.adam_gradients(model, trainer.optimizer)
        self.program = {"losses": losses, "grads": grads,
                        "params": program.snapshot(model),
                        "counts": torch.stack(list(epochs.mstate)).cpu()}
        self.cached = (grids.x.index_select(0, self.rows).cpu(),
                       grids.y.index_select(0, self.rows).cpu())
        phases.mark("first_steps")
        for _ in range(steps, epochs.n_batches):
            self._step()
        self._epoch_end()
        phases.mark("first_epoch")

    def _step(self) -> None:
        self.epochs.runner()
        self.trainer.step += 1

    def _epoch_end(self) -> None:
        """What the fit does between epochs, but the checkpoints: the
        epoch's counts and mean loss read on the host."""
        from scenenet_tpu_torch.train.metrics import compute_metrics, metric_counts

        with torch.profiler.record_function("epoch_boundary"):
            self.trainer.train_counts.append(metric_counts(self.epochs.mstate))
            compute_metrics(self.epochs.mstate, self.trainer.config.fbeta)
            float(self.epochs.loss_sum)

    def _epochs(self, count: int) -> int:
        for _ in range(count):
            self.epochs.run_epoch()
            self._epoch_end()
        return count * self.epochs.n_batches

    def window(self, seconds: float):
        steps, t0, ends = 0, time.perf_counter(), []
        while True:
            steps += self._epochs(1)
            ends.append(time.perf_counter() - t0)
            if ends[-1] >= seconds:
                break
        elapsed = ends[-1]  # the epoch's end read the device: all done
        samples = steps * self.traffic["batch_size"]
        return {self.traffic["rate_metric"]: samples / elapsed}, {"steps": steps, "samples": samples,
                                                           "pace_s": ends}

    def traced(self):
        steps = self._epochs(self.traffic["trace_epochs"])
        return {"steps": steps, "samples": steps * self.traffic["batch_size"]}

    def release(self) -> None:
        del self.epochs, self.trainer, self.model, self.grids

    def reference(self, precision: str = "f32") -> dict:
        """The reference's steps on the same crops and weights."""
        cfg, batch = self.cfg, self.traffic["batch_size"]
        x, y = ref_voxel.training_grids(*self.inputs, cfg["keep_labels"],
                                        tuple(cfg["voxel_grid_size"]))
        batches = [(x[i:i + batch], y[i:i + batch]) for i in range(0, x.shape[0], batch)]
        out = ref_scenenet.train(cfg, self.weights, batches, self.device, precision)
        out["grids"] = (x, y)
        return out

    def _compare(self, readings: dict, cached, ref: dict) -> List[check.Compare]:
        x, y = ref["grids"]
        cx, cy = cached
        mismatch = int((cx.to(x.device).float() != x).sum() + (cy.to(y.device).float() != y).sum())
        before = {k: torch.tensor(v) for k, v in self.weights["values"].items()}
        limits = self.traffic["limits"]
        return [check.Compare("grid_mismatch", mismatch, limits["grid_mismatch"])] + \
            check.training_numbers(readings, ref, before, limits)

    def check(self) -> List[check.Compare]:
        return self._compare(self.program, self.cached, self.reference())

    def control(self) -> List[check.Compare]:
        """The reference in TF32 in the program's place."""
        ref, low = self.reference(), self.reference("tf32")
        return self._compare(low, low["grids"], ref)

    def close(self) -> None:
        pass
