"""Milliseconds a step of the streamed SceneNet train route, one checkout
against another.

Run on a machine with the card, from the root of a checkout:

    python3 scenenet_tpu_torch/csrc/bench/streamed_step_times.py [--root DIR ...]
        [--rounds 8]

It times what ``chip_smoke.py``'s ``[timing] train step by cache route``
calls ``streaming native``: the defaults' width (batch 16, 64^3, 65536
padded points of 40k-70k synthetic 1 cm LiDAR points, (9,5,5),
``geneo_tversky``, Adam), the native loader's batches (4 threads) through
``Trainer.train_step``, K3 in the step; 256 samples an epoch, a warm epoch,
then the median of 4. Each round runs one process a root, in an order that
alternates round by round, so that two versions share the host's state;
the last lines give each root's rounds, their median and quartiles, and
the rounds the first root ran faster than the second. ``--root`` (repeat
it) names the checkouts, this one by default: unpack an earlier commit into
a git-ignored directory to compare with it. Not part of the library; the
numbers in PERF.md name it.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parents[3]
SAMPLES, BATCH, POINTS, GRID, TOWER = 256, 16, 65536, (64, 64, 64), 15


def write_crops(root: Path, n: int = 51, seed: int = 7) -> None:
    """``n`` seeded crops under ``root/fit``: ground, three tower columns,
    clutter, 40k-70k points at 1 cm, world coordinates."""
    rng = np.random.default_rng(seed)
    (root / "fit").mkdir(parents=True)
    for i in range(n):
        m = int(rng.integers(40000, 70000))
        span = rng.uniform(40.0, 80.0)
        ng, nt = int(m * 0.5), int(m * 0.2)
        ground = np.column_stack([rng.uniform(0, span, (ng, 2)), rng.normal(0, 0.15, ng)])
        towers = [np.column_stack([rng.normal(c[0], 1.0, len(s)), rng.normal(c[1], 1.0, len(s)),
                                   rng.uniform(0, 35.0, len(s))])
                  for s in np.array_split(np.arange(nt), 3)
                  for c in [rng.uniform(0.2 * span, 0.8 * span, 2)]]
        rest = rng.uniform([0, 0, 0], [span, span, 12.0], (m - ng - nt, 3))
        xyz = np.round(np.concatenate([ground, *towers, rest]), 2) + rng.uniform(0, 1000, 3)
        labels = np.repeat([2, TOWER, 1], [ng, nt, m - ng - nt])
        np.save(root / "fit" / f"sample_{i}.npy", np.concatenate([xyz, labels[:, None]], 1))


def child(root: str) -> None:
    sys.path.insert(0, root)
    import torch

    from scenenet_tpu_torch.data import NativePointCloudLoader, PointPadding, Subset, TS40K
    from scenenet_tpu_torch.losses import resolve_criterion
    from scenenet_tpu_torch.models.scenenet import SceneNet
    from scenenet_tpu_torch.train import TrainConfig, Trainer, make_device_voxelize_prep, metrics
    from scenenet_tpu_torch.utils.config import ExperimentConfig

    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        write_crops(Path(tmp) / "ts40k")
        ds = TS40K(str(Path(tmp) / "ts40k"), "fit",
                   transform=PointPadding(max_points=POINTS, compute_indices=False))
        ds = Subset(ds, [i % len(ds) for i in range(SAMPLES)])
        loader = NativePointCloudLoader(ds, BATCH, shuffle=True, max_points=POINTS, threads=4,
                                        seed=0, drop_last=True)
        crit = resolve_criterion("geneo_tversky")(**ExperimentConfig().criterion_params())
        t = Trainer(SceneNet.create(kernel_size=(9, 5, 5), seed=0, backend="cuda").to(dev), crit,
                    TrainConfig(run_dir=str(Path(tmp) / "run"), checkpoint_dir=str(Path(tmp) / "c"),
                                max_epochs=1, early_stop_metric=None),
                    batch_prep=make_device_voxelize_prep(GRID, (TOWER,), use_indices=False))
        t.setup_optimizer()

        def epoch() -> float:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ms = metrics.init_metric_state(dev)
            for batch in loader:
                ms, _ = t.train_step(ms, *t.to_device(batch))
            metrics.metric_counts(ms)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / (SAMPLES // BATCH)

        epoch()
        print(json.dumps({"ms": float(np.median([epoch() for _ in range(4)]))}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", action="append", default=None)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--child", default=None)
    args = ap.parse_args()
    if args.child:
        child(args.child)
        return 0
    roots = [str(Path(r).resolve()) for r in (args.root or [str(HERE)])]
    got = {r: [] for r in roots}
    for rnd in range(args.rounds):
        for r in (roots if rnd % 2 == 0 else roots[::-1]):
            out = subprocess.run([sys.executable, __file__, "--child", r], check=True,
                                 capture_output=True, text=True, cwd=r,
                                 env=dict(os.environ, PYTHONPATH=r)).stdout
            got[r].append(json.loads(out.strip().splitlines()[-1])["ms"])
            print(f"round {rnd} {r}: {got[r][-1]:.3f} ms a step", flush=True)
    for r, v in got.items():
        q1, q2, q3 = np.percentile(v, [25, 50, 75])
        print(f"{r}: median {q2:.3f} ms a step, quartiles {q1:.3f}-{q3:.3f}, rounds "
              + " ".join(f"{x:.3f}" for x in v))
    if len(roots) == 2:
        a, b = got[roots[0]], got[roots[1]]
        print(f"{roots[0]} faster in {sum(x < y for x, y in zip(a, b))} of {len(a)} rounds")
    return 0


if __name__ == "__main__":
    sys.exit(main())
