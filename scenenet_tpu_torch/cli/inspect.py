"""White-box model inspection: the interpretability story of SCENE-Net.

PyTorch twin of ``scenenet_tpu.cli.inspect``. Dumps, from a checkpoint
(the port's npz, restored into the config's model, or an imported
reference Lightning ``.ckpt``):

- every GENEO scalar parameter and convex coefficient (with the derived
  last λ), as a table and as ``parameters.json``;
- each observer's synthesized 3D kernel as a colored PLY point cloud
  (positive weights red, negative blue; the reference shows these in an
  open3d window, ``GENEO_kernel_torch.plot_kernel``);
- the combined (λ-weighted) kernel.

The kernels are synthesized on ``--device`` (``cuda`` by default, which
raises without a card; ``cpu`` runs on the host).

Usage:
    python -m scenenet_tpu_torch.cli.inspect --checkpoint ckpt.npz \\
        [--config cfg.yaml] [--set key=value ...] [--out inspect_out] [--device cpu]
    python -m scenenet_tpu_torch.cli.inspect --reference-ckpt FBetaScore.ckpt
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from scenenet_tpu_torch.cli.serve import resolve_device
from scenenet_tpu_torch.utils.viz import voxelgrid_to_points, write_ply


def main(argv=None):
    parser = argparse.ArgumentParser(description="Inspect a SCENE-Net checkpoint")
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="the port's npz checkpoint")
    parser.add_argument("--reference-ckpt", type=str, default=None,
                        help="reference Lightning .ckpt to import")
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--set", action="extend", nargs="*", default=[],
                        help="config overrides key=value (no PyYAML needed)")
    parser.add_argument("--out", type=str, default="inspect_out")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where the kernels are synthesized")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    if args.reference_ckpt:
        from scenenet_tpu_torch.compat import import_scenenet_params

        model = import_scenenet_params(args.reference_ckpt).to(device)
    else:
        from scenenet_tpu_torch.cli.train import build_model, parse_overrides
        from scenenet_tpu_torch.train.checkpoint import restore_checkpoint
        from scenenet_tpu_torch.utils.config import load_config

        if args.checkpoint is None:
            parser.error("provide --checkpoint or --reference-ckpt")
        cfg = load_config(args.config, parse_overrides(args.set))
        model = restore_checkpoint(args.checkpoint, build_model(cfg, device))

    os.makedirs(args.out, exist_ok=True)
    table = model.parameters_in_dict()
    print(f"{'parameter':34s} value")
    print("-" * 46)
    for name, value in table.items():
        print(f"{name:34s} {value: .5f}")
    with open(os.path.join(args.out, "parameters.json"), "w") as f:
        json.dump(table, f, indent=2)

    with torch.no_grad():
        kernels = model.synthesize_kernels().cpu().numpy()
        lams = model.effective_lambdas().cpu().numpy()
    for (name, _), k in zip(model.observers, kernels):
        scale = max(abs(k.min()), abs(k.max()), 1e-9)
        pts = voxelgrid_to_points(k / scale, "density")
        write_ply(os.path.join(args.out, f"kernel_{name}.ply"), pts)
        print(f"kernel {name}: shape {k.shape}, sum {k.sum():+.5f}, "
              f"range [{k.min():+.4f}, {k.max():+.4f}]")
    combined = np.einsum("g,gzxy->zxy", lams, kernels)
    scale = max(abs(combined.min()), abs(combined.max()), 1e-9)
    write_ply(os.path.join(args.out, "kernel_combined.ply"),
              voxelgrid_to_points(combined / scale, "density"))
    print(f"combined kernel sum {combined.sum():+.5f} "
          f"(λ = {np.round(lams, 4).tolist()})")
    return table


if __name__ == "__main__":
    main()
