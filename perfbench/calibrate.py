"""The readings that the limits of ``correct`` are set from, for one cell,
in one process: the program's compared numbers on many seeds, the
control's (the plain reference in TF32 put in the program's place), and
the numbers that planted faults read, each on its own seeds.

    python3 -m perfbench.calibrate --workload <cell> --seeds 12 --controls 3 \\
        [--faults half_batch=3] [--seconds 1] [--first-seed N]

Prints one JSON line a run: the seed, what ran (``program``, ``control``
or the fault's name) and each number. The benchmark's own runs never run
this. Training reads its first steps with no window; inference runs a
window of ``--seconds`` so that the dispatches a run compares are reached.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from perfbench import harness, spec


def one(cell: spec.Cell, seed: int, kind: str, seconds: float, device: torch.device) -> dict:
    faults = () if kind in ("program", "control") else (kind,)
    route = spec.load_route(cell.traffic["route"]).Route(cell, seed, device, faults)
    t0 = time.perf_counter()
    try:
        route.setup()
        setup_s = time.perf_counter() - t0
        if cell.traffic["route"] == "batch_infer":
            route.window(seconds)
        route.release()
        torch.cuda.empty_cache()
        compared = route.control() if kind == "control" else route.check()
    finally:
        route.close()
    return {"seed": seed, "kind": kind, "setup_s": setup_s,
            "numbers": {c.name: c.value for c in compared}}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--controls", type=int, default=3)
    parser.add_argument("--faults", nargs="*", default=[], help="name=seeds")
    parser.add_argument("--seconds", type=float, default=1.0)
    parser.add_argument("--first-seed", type=int, default=3_000_000_000)
    args = parser.parse_args(argv)
    harness.cache_dirs()
    if not torch.cuda.is_available():
        print("[device] no CUDA device", file=sys.stderr)
        return 2
    cell = spec.Cell(args.workload)
    dev = torch.device("cuda")
    plan = [("program", args.seeds), ("control", args.controls)]
    plan += [(f.split("=")[0], int(f.split("=")[1])) for f in args.faults]
    seed = args.first_seed
    for kind, count in plan:
        for _ in range(count):
            print(json.dumps(one(cell, seed, kind, args.seconds, dev)), flush=True)
            seed += 7919
            gc.collect()
    return 0


if __name__ == "__main__":
    sys.exit(main())
