"""Dataset-build CLI — the reference's offline ETL entry points
(``core/datasets/ts40k.py:229`` ``main`` and the semKITTI pole builders,
``semKITTI.py:91-158``) as one command; the port's counterpart of
``scenenet_tpu.cli.build_samples`` (host code, numpy only):

    python -m scenenet_tpu_torch.cli.build_samples ts40k \
        --las-dir /data/las_a --las-dir /data/las_b --out /data/ts40k \
        --test-split 0.4

    python -m scenenet_tpu_torch.cli.build_samples semantic_kitti \
        --dataset /data/semantic_kitti --out /data/kitti_poles

(``kitti`` is the JAX package's name of the second subcommand, and is
accepted as an alias.)

The TS40K path reads ``.las`` tiles, DBSCAN-extracts towers, writes
``sample_N.npy`` crops and shuffles them into ``fit/`` / ``test/``
folders (resumable — see :func:`scenenet_tpu_torch.data.ts40k.build_data_samples`).
``--test-split`` is the config's ``test_split`` fraction (reference
``data_split = {fit: .6, test: .4}``, ``ts40k.py:33``).
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Build training samples (offline ETL)")
    # dest must not be "dataset": the semantic_kitti subparser's --dataset option
    # would overwrite the subcommand name in the namespace
    sub = parser.add_subparsers(dest="command", required=True)

    ts = sub.add_parser("ts40k", help=".las tiles -> tower-crop npy samples")
    ts.add_argument("--las-dir", action="append", required=True,
                    help="directory of .las tiles (repeatable)")
    ts.add_argument("--out", required=True, help="output dataset root")
    ts.add_argument("--test-split", type=float, default=0.4,
                    help="fraction moved to test/ (reference ts40k.py:33)")
    ts.add_argument("--two-towers", action="store_true",
                    help="crop between tower pairs instead of tower radii")
    ts.add_argument("--seed", type=int, default=0)

    kt = sub.add_parser("semantic_kitti", aliases=["kitti"],
                        help="SemanticKITTI scans -> pole crops")
    kt.add_argument("--dataset", required=True,
                    help="SemanticKITTI root (sequences/NN/velodyne+labels)")
    kt.add_argument("--out", required=True, help="output crop root")
    kt.add_argument("--min-pole-points", type=int, default=5)

    args = parser.parse_args(argv)
    if args.command == "ts40k":
        from scenenet_tpu_torch.data.ts40k import build_data_samples

        if not 0.0 <= args.test_split < 1.0:
            parser.error(f"--test-split {args.test_split} not in [0, 1)")
        split = {"fit": 1.0 - args.test_split, "test": args.test_split}
        n = build_data_samples(args.las_dir, args.out,
                               tower_radius=not args.two_towers,
                               data_split=split, seed=args.seed)
        print(f"[build_samples] wrote {n} ts40k samples to {args.out} "
              f"(split {split})")
    else:
        from scenenet_tpu_torch.data.semantic_kitti import build_pole_radius_samples

        n = build_pole_radius_samples(args.dataset, args.out,
                                      min_pole_points=args.min_pole_points)
        print(f"[build_samples] wrote {n} kitti pole crops to {args.out}")
    return n


if __name__ == "__main__":
    main()
