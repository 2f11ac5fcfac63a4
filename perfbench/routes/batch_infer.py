"""Batched tile scoring through the served dispatch: ``cli.serve``'s
``_Pipeline`` with ``max_batch`` set, whose every power-of-two bucket is
captured at start-up as one CUDA graph; a dispatch copies its tiles into
the bucket's static inputs, replays the graph (occupancy by K1, kernel
synthesis, K5 with the relu∘tanh head, the bin ids and the voxel→point
gather) and copies the outputs out.

Set-up makes a pool of padded tiles on the device from the seed and writes
the benchmark's weights into the pipeline's model (the graph reads them at
every replay). The window cycles the pool through ``run_batch`` without a
synchronise between dispatches and ends on one. The dispatches that the
seed picks, the one holding the pool's largest tile among them, are kept
and compared once the window has closed.
"""

from __future__ import annotations

import time
from typing import List

import numpy as np
import torch

from perfbench import check, program, synth, weights
from perfbench.trace import Phases
from perfbench.reference import scenenet as ref_scenenet
from perfbench.reference import voxel as ref_voxel


class Route:
    def __init__(self, cell, seed: int, device: torch.device, faults=()):
        self.cfg, self.traffic, self.seed = cell.config, cell.traffic, seed
        self.device, self.faults = device, tuple(faults)
        self.pipeline = None

    def setup(self) -> None:
        self.phases = phases = Phases()
        from scenenet_tpu_torch.cli.serve import _Pipeline

        phases.mark("import")
        cfg, tr, dev = self.cfg, self.traffic, self.device
        pts = tr["points"]
        sizes = synth.crop_sizes(self.seed, tr["pool"], pts["min"], pts["max"])
        self.pool, _, self.mask = synth.crops(self.seed, sizes, pts["pad"], dev)
        phases.mark("tiles")
        batch = tr["batch_size"]
        self.n_batches = tr["pool"] // batch
        # the dispatches compared: the seed's draw, and the first one that
        # holds the pool's largest tile
        rng = np.random.default_rng(synth.sub_seed(self.seed, 7))
        keep = set(rng.choice(tr["sample_range"], tr["check_dispatches"] - 1, replace=False))
        keep.add(int(np.argmax(sizes)) // batch)
        self.keep = sorted(int(k) for k in keep)
        self.kept = {}
        self.weights = weights.scenenet_weights(self.seed, cfg)
        pipeline = _Pipeline(None, grid=tuple(cfg["voxel_grid_size"]), max_points=pts["pad"],
                             kernel_size=tuple(cfg["kernel_size"]), inference=tr["inference"],
                             max_batch=batch, device=dev)
        self.pipeline = pipeline
        phases.mark("pipeline")
        program.write_weights(pipeline.net, self.weights["values"])
        self._plant(pipeline)
        self.dispatched = 0
        self._run(self.n_batches)  # every batch of the pool once: the copies, the buffers
        self.dispatched = 0
        self.kept.clear()
        phases.mark("first_pass")

    def _plant(self, pipeline) -> None:
        """The tests' faults in the dispatch: ``frozen_step`` returns the
        first dispatch's outputs ever after, ``half_batch`` zeroes the
        second half of every batch, ``altered_answer`` moves one point's
        output of every batch."""
        run = pipeline.run_batch
        first = []

        def broken(pts, mask):
            pred, probs = (t.clone() for t in run(pts, mask))
            if "frozen_step" in self.faults:
                if not first:
                    first.append((pred.clone(), probs.clone()))
                return first[0]
            if "half_batch" in self.faults:
                h = pred.shape[0] // 2
                pred[h:], probs[h:] = 0.0, 0.0
            if "altered_answer" in self.faults:
                probs[0, 0] += 0.5
            return pred, probs

        if self.faults:
            pipeline.run_batch = broken

    def _dispatch(self, i: int):
        b = self.traffic["batch_size"]
        k = i % self.n_batches
        out = self.pipeline.run_batch(self.pool[k * b:(k + 1) * b], self.mask[k * b:(k + 1) * b])
        if i in self.keep:
            self.kept[i] = out
        return out

    def _run(self, count: int) -> None:
        for _ in range(count):
            self._dispatch(self.dispatched)
            self.dispatched += 1

    def window(self, seconds: float):
        t0, ends = time.perf_counter(), []
        while not ends or ends[-1] < seconds:
            self._run(self.n_batches)
            ends.append(time.perf_counter() - t0)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        elapsed = time.perf_counter() - t0
        tiles = self.dispatched * self.traffic["batch_size"]
        return {self.traffic["rate_metric"]: tiles / elapsed}, {"dispatches": self.dispatched,
                                                       "tiles": tiles, "pace_s": ends}

    def traced(self):
        self._run(self.traffic["trace_dispatches"])
        return {"dispatches": self.dispatched,
                "tiles": self.dispatched * self.traffic["batch_size"]}

    def release(self) -> None:
        self.kept = {i: tuple(t.cpu() for t in out) for i, out in self.kept.items()}
        self.close()

    def _batch(self, i: int):
        b, k = self.traffic["batch_size"], i % self.n_batches
        return self.pool[k * b:(k + 1) * b], self.mask[k * b:(k + 1) * b]

    def reference(self, i: int, precision: str = "f32") -> torch.Tensor:
        """The reference's voxel probabilities of dispatch ``i``."""
        pts, mask = self._batch(i)
        x = ref_voxel.occupancy(pts, mask, tuple(self.cfg["voxel_grid_size"]))[:, None]
        with torch.no_grad():
            return ref_scenenet.SceneNet(self.cfg, self.weights,
                                         self.device).forward(x, precision)[:, 0]

    def check(self, outputs=None) -> List[check.Compare]:
        """``voxel_gap``: the widest gap of a voxel's probability between the
        program's kept dispatches (or ``outputs``, a control's) and the
        reference's. ``gather_mismatch``: the points whose output is not
        the dispatch's own voxel probability at the point's bin (the
        reference's ids), 0 for padding: exact."""
        outputs = self.kept if outputs is None else outputs
        limits = self.traffic["limits"]
        voxel, mismatch = (float("inf"), 1) if not outputs else (0.0, 0)
        grid = tuple(self.cfg["voxel_grid_size"])
        for i, (pred, probs) in outputs.items():
            pts, mask = self._batch(i)
            pred, probs = pred.to(self.device), probs.to(self.device)
            voxel = max(voxel, float((pred - self.reference(i)).abs().max()))
            own = ref_voxel.gather(pred, ref_voxel.ids_divide(pts, mask, grid), mask)
            mismatch += int((probs != own).sum())
        return [check.Compare("voxel_gap", voxel, limits["voxel_gap"]),
                check.Compare("gather_mismatch", mismatch, limits["gather_mismatch"])]

    def control(self) -> List[check.Compare]:
        """The reference in TF32 in the program's place."""
        outputs = {}
        for i in self.kept:
            pred = self.reference(i, "tf32")
            pts, mask = self._batch(i)
            ids = ref_voxel.ids_divide(pts, mask, tuple(self.cfg["voxel_grid_size"]))
            outputs[i] = (pred, ref_voxel.gather(pred, ids, mask))
        return self.check(outputs)

    def close(self) -> None:
        if self.pipeline is not None:
            self.pipeline.close()
            self.pipeline = None
