"""Run one cell of ``BENCHMARK.json`` once on the card and print its result.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Exits non-zero, printing no result, where torch finds no CUDA device or
fewer than the cell asks for, where the program is missing, and where JAX,
flax or the JAX package was loaded.
"""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from perfbench import harness, spec

    harness.cache_dirs()
    import torch

    cell = spec.Cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"[device] {args.workload} needs {cell.chips} CUDA device(s); torch finds "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), START)
    return harness.report(result)


if __name__ == "__main__":
    sys.exit(main())
