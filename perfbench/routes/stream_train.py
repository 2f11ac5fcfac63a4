"""A model trained from crops streamed off disk: the route ``cli.train``
takes for a stateful model (``device_cache: auto`` → false for the UNet).

Set-up makes the crops on the device from the seed and writes them as
TS40K samples ((N, 4) float64 ``.npy``, xyz and class) under the run's
``TMPDIR``; the native loader (``NativePointCloudLoader``, C++ threads)
reads them, shuffled, in batches of padded points, and each step is
``Trainer.train_step``: the upload, K3's voxelization on the card, the
forward, the loss, the backward, Adam and the confusion counts, eagerly.
The first steps are read for the check. The window runs the fit's loop over
the loader (``Trainer.fit`` without its checkpoint writes and logs) and
ends on a synchronise; the host time spent in each ``next()`` of the loader
is recorded.
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from perfbench import check, program, synth, weights
from perfbench.trace import Phases
from perfbench.reference import unet as ref_unet
from perfbench.reference import voxel as ref_voxel


class _Timed:
    """The loader as the trainer sees it, with the host time of every
    ``next()`` kept."""

    def __init__(self, loader):
        self.loader = loader
        self.waits: List[float] = []
        self._it = None

    def next(self):
        while True:
            if self._it is None:
                self._it = iter(self.loader)
            t0 = time.perf_counter()
            with torch.profiler.record_function("loader_next"):
                batch = next(self._it, None)
            self.waits.append(time.perf_counter() - t0)
            if batch is not None:
                return batch, False
            self._it = None
            return None, True  # the epoch ended


class Route:
    def __init__(self, cell, seed: int, device: torch.device, faults=()):
        self.cfg, self.traffic, self.seed = cell.config, cell.traffic, seed
        self.device, self.faults = device, tuple(faults)
        self.tmp = None

    def _write_crops(self) -> str:
        """The crops as TS40K's ``fit`` split; keeps them, by point count, for
        the reference."""
        tr = self.traffic
        pts = tr["points"]
        sizes = synth.crop_sizes(self.seed, tr["crops"], pts["min"], pts["max"], distinct=True)
        points, labels, mask = synth.crops(self.seed, sizes, pts["pad"], self.device)
        cloud = torch.cat([points, labels[..., None].float()], dim=-1).cpu().numpy()
        self.tmp = tempfile.TemporaryDirectory(prefix="perfbench_")
        root = os.path.join(self.tmp.name, "fit")
        os.makedirs(root)
        self.crops: Dict[int, np.ndarray] = {}
        for i, n in enumerate(sizes):
            sample = cloud[i, :n].astype(np.float64)
            np.save(os.path.join(root, f"sample_{i:04d}.npy"), sample)
            self.crops[int(n)] = sample
        return self.tmp.name

    def setup(self) -> None:
        self.phases = phases = Phases()
        from scenenet_tpu_torch import native
        from scenenet_tpu_torch.data import TS40K, NativePointCloudLoader
        from scenenet_tpu_torch.losses import resolve_criterion
        from scenenet_tpu_torch.models import UNet3D
        from scenenet_tpu_torch.train import TrainConfig, Trainer, make_device_voxelize_prep
        from scenenet_tpu_torch.train.metrics import init_metric_state
        from scenenet_tpu_torch.utils.logging import NullLogger

        cfg, tr, dev = self.cfg, self.traffic, self.device
        if not native.available():
            raise RuntimeError("the native loader did not build: the route needs it")
        phases.mark("import")
        root = self._write_crops()
        phases.mark("crops")
        batch = tr["batch_size"]
        loader = NativePointCloudLoader(
            TS40K(root, split="fit"), batch, shuffle=True, seed=synth.sub_seed(self.seed, 6),
            max_points=tr["points"]["pad"], threads=tr["loader_threads"], drop_last=True)
        self.loader = _Timed(loader)
        model = UNet3D(n_classes=cfg["n_classes"],
                       backend="cuda" if dev.type == "cuda" else "torch").to(dev)
        self.before = weights.unet_weights(self.seed, ref_unet.param_shapes(cfg), dev)
        program.write_weights(model, self.before)
        prep = make_device_voxelize_prep(tuple(cfg["voxel_grid_size"]), tuple(cfg["keep_labels"]),
                                         use_indices=False)
        criterion = resolve_criterion(cfg["criterion"])(**cfg["criterion_params"])
        losses: List[float] = []

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
        program.plant_training_faults(trainer, self.faults)
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
                        "params": program.snapshot(model, buffers=True),
                        "counts": torch.stack(list(self.mstate)).cpu()}
        phases.mark("first_steps")

    def _step(self):
        """One step of the fit's loop; at an epoch's end the fit's read of
        its counts and mean loss comes first."""
        batch, ended = self.loader.next()
        if ended:
            self._epoch_end()
            batch, _ = self.loader.next()
        self.mstate, loss = self.trainer.train_step(self.mstate, *self.trainer.shard(batch))
        self.loss_sum = self.loss_sum + loss
        return batch

    def _epoch_end(self) -> None:
        from scenenet_tpu_torch.train.metrics import (
            compute_metrics, init_metric_state, metric_counts,
        )

        with torch.profiler.record_function("epoch_boundary"):
            self.trainer.train_counts.append(metric_counts(self.mstate))
            compute_metrics(self.mstate, self.trainer.config.fbeta)
            float(self.loss_sum)
        self.mstate = init_metric_state(self.device)
        self.loss_sum = torch.zeros((), device=self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self, seconds: float):
        steps, t0, ends = 0, time.perf_counter(), []
        while not ends or ends[-1] < seconds:
            self._step()
            steps += 1
            ends.append(time.perf_counter() - t0)
        self._sync()
        elapsed = time.perf_counter() - t0
        samples = steps * self.traffic["batch_size"]
        return {self.traffic["rate_metric"]: samples / elapsed}, {"steps": steps, "samples": samples,
                                                           "pace_s": ends}

    def traced(self):
        self.loader.waits.clear()
        steps = self.traffic["trace_steps"]
        for _ in range(steps):
            self._step()
        return {"steps": steps, "samples": steps * self.traffic["batch_size"],
                "loader_wait_s": list(self.loader.waits)}

    def release(self) -> None:
        del self.trainer, self.model, self.loader

    def _inputs(self):
        """The first steps' batches as the reference loads them from the
        crops: each row found by its point count, centred at its minimum in
        float64, then f32, padded with zeros. The loader's rows that differ
        are counted."""
        pad = self.traffic["points"]["pad"]
        mismatch, out = 0, []
        for pts_p, lab_p, mask_p in self.batches:
            b = pts_p.shape[0]
            pts = np.zeros((b, pad, 3), np.float32)
            lab = np.zeros((b, pad), np.int32)
            mask = np.zeros((b, pad), bool)
            for i in range(b):
                sample = self.crops.get(int(mask_p[i].sum()))
                if sample is None:
                    mismatch += 1
                    continue
                n = len(sample)
                pts[i, :n] = (sample[:, :3] - sample[:, :3].min(0)).astype(np.float32)
                lab[i, :n] = sample[:, 3].astype(np.int32)
                mask[i, :n] = True
                mismatch += int(not (np.array_equal(pts[i], pts_p[i])
                                     and np.array_equal(lab[i], lab_p[i])
                                     and np.array_equal(mask[i], mask_p[i])))
            out.append(tuple(torch.from_numpy(a).to(self.device) for a in (pts, lab, mask)))
        return out, mismatch

    def reference(self, precision: str = "f32") -> dict:
        cfg = self.cfg
        inputs, mismatch = self._inputs()
        batches = [ref_voxel.training_grids(p, l, m, cfg["keep_labels"],
                                            tuple(cfg["voxel_grid_size"])) for p, l, m in inputs]
        out = ref_unet.train(cfg, self.before, batches, self.device, precision)
        out["batch_mismatch"] = mismatch
        return out

    def _compare(self, readings: dict, ref: dict) -> List[check.Compare]:
        limits = self.traffic["limits"]
        before = {n: v.cpu() for n, v in self.before.items()}
        before.update((n, (torch.ones if n.endswith(".var") else torch.zeros)(s))
                      for n, s in ref_unet.buffer_shapes(self.cfg).items())
        return [check.Compare("batch_mismatch", ref["batch_mismatch"],
                              limits["batch_mismatch"])] + \
            check.training_numbers(readings, ref, before, limits)

    def check(self) -> List[check.Compare]:
        return self._compare(self.program, self.reference())

    def control(self) -> List[check.Compare]:
        """The reference in TF32 in the program's place."""
        return self._compare(self.reference("tf32"), self.reference())

    def close(self) -> None:
        if self.tmp is not None:
            self.tmp.cleanup()
            self.tmp = None
