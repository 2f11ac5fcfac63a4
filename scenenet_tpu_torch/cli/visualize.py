"""Prediction + visualization entry point.

PyTorch twin of ``scenenet_tpu.cli.visualize`` (the reference's
``scripts/visualize.py``): loads a checkpoint, predicts over the test
split, and exports colored point clouds (input / GT / prediction /
pred-vs-GT composite) plus tower-proposal coordinates, and
``summary.json``. The forward runs on ``--device`` (``cuda`` by default:
the config's kernel backend there, K2 for SceneNet; it raises without a
card) in ``eval()`` under ``torch.no_grad()``; the grids are voxelized on
the host, as in the JAX CLI, and the PLYs and proposals are host numpy.
Each sample's line gives its stages' milliseconds (the forward with its
copies to and from the device, the four PLYs, the proposals).

Usage:
    python -m scenenet_tpu_torch.cli.visualize --config experiments/defaults.yaml \\
        --checkpoint path/to/ckpt.npz --out out_dir [--n 4] [--set key=value ...] \\
        [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from scenenet_tpu_torch.cli.serve import resolve_device
from scenenet_tpu_torch.cli.train import build_datasets, build_model, parse_overrides
from scenenet_tpu_torch.ops.voxel_np import prob_to_label_np
from scenenet_tpu_torch.train.checkpoint import restore_checkpoint
from scenenet_tpu_torch.utils.config import load_config
from scenenet_tpu_torch.utils.proposals import get_tower_proposals
from scenenet_tpu_torch.utils.viz import pred_vs_gt_points, voxelgrid_to_points, write_ply


def main(argv=None):
    parser = argparse.ArgumentParser(description="Visualize SCENE-Net predictions")
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--set", action="extend", nargs="*", default=[],
                        help="config overrides key=value (no PyYAML needed)")
    parser.add_argument("--checkpoint", type=str, required=True)
    parser.add_argument("--out", type=str, default="visualizations")
    parser.add_argument("--n", type=int, default=4, help="number of test samples")
    parser.add_argument("--tau", type=float, default=0.65)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where the forward runs")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    cfg = load_config(args.config, parse_overrides(args.set))
    cfg.device_voxelization = False  # visualization wants host (x, y) grids
    model = restore_checkpoint(args.checkpoint, build_model(cfg, device)).eval()
    _, _, test_ds = build_datasets(cfg)
    os.makedirs(args.out, exist_ok=True)

    summary = []
    for i in range(min(args.n, len(test_ds))):
        x, y = test_ds[i]
        t0 = time.perf_counter()
        with torch.no_grad():
            xt = torch.from_numpy(np.asarray(x, np.float32))[None].to(device)
            pred = model(xt)[0].cpu().numpy()
        t1 = time.perf_counter()
        mask = prob_to_label_np(pred, args.tau)

        write_ply(os.path.join(args.out, f"sample{i}_input.ply"),
                  voxelgrid_to_points(np.squeeze(x), "ranges"))
        write_ply(os.path.join(args.out, f"sample{i}_gt.ply"),
                  voxelgrid_to_points(np.squeeze(y), "ranges"))
        write_ply(os.path.join(args.out, f"sample{i}_pred.ply"),
                  voxelgrid_to_points(np.squeeze(pred), "ranges"))
        write_ply(os.path.join(args.out, f"sample{i}_pred_vs_gt.ply"),
                  pred_vs_gt_points(mask, np.squeeze(y)))
        t2 = time.perf_counter()

        proposals = get_tower_proposals(pred, density_grid=np.squeeze(x), tau=args.tau)
        t3 = time.perf_counter()
        summary.append({
            "sample": i,
            "pred_voxels": int(mask.sum()),
            "gt_voxels": int((np.squeeze(y) > 0).sum()),
            "proposals": proposals.tolist(),
        })
        print(f"sample {i}: {int(mask.sum())} pred voxels, "
              f"{len(proposals)} tower proposals (ms: forward {(t1 - t0) * 1e3:.3f}, "
              f"ply {(t2 - t1) * 1e3:.3f}, proposals {(t3 - t2) * 1e3:.3f})")

    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    return summary


if __name__ == "__main__":
    main()
