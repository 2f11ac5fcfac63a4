"""Device times of the occupancy kernel (K1) and the kernel gradient (K4).

Run on a machine with the card, from the root of a checkout:

    python3 scenenet_tpu_torch/csrc/bench/points_dk_times.py [--root DIR] [--passes]

It times K1 at batch 1 and 64 (64^3, 131072 padded points of 40k-70k
synthetic 1 cm LiDAR points) and K4 at batch 1 and 16 (64^3, (9,5,5), ~20%
occupancy), each as a loop of calls (which at batch 1 measures the host's
launch rate) and as one call captured in a CUDA graph and replayed (the
device's time), medians of five, in ms. ``--root`` times the package of
another checkout instead (an unpacked earlier commit, to compare two
versions in one run: this tree, the other, this tree, the other).
``--passes`` adds K1's time by kernel from ``torch.profiler``. Not part of
the kernel library; the numbers in PERF.md name it.
"""

import argparse
import sys

import numpy as np
import torch


def crop(rng, n):
    span = rng.uniform(40, 80)
    ng, nt = int(n * 0.6), int(n * 0.3)
    ground = np.column_stack([rng.uniform(0, span, (ng, 2)), rng.normal(0, 0.15, ng)])
    tower = np.column_stack([rng.normal(span / 2, 1, nt), rng.normal(span / 2, 1, nt),
                             rng.uniform(0, 35, nt)])
    rest = rng.uniform([0, 0, 0], [span, span, 12], (n - ng - nt, 3))
    xyz = np.round(np.concatenate([ground, tower, rest]), 2)
    return (xyz - xyz.min(0)).astype(np.float32)


def batch(seed, b, n_pad=131072, lo=40000, hi=70000):
    rng = np.random.default_rng(seed)
    pts = np.zeros((b, n_pad, 3), np.float32)
    mask = np.zeros((b, n_pad), bool)
    for i in range(b):
        n = int(rng.integers(lo, hi))
        pts[i, :n] = crop(rng, n)
        mask[i, :n] = True
    return pts, mask


def loop_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters=200):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return loop_ms(graph.replay, iters)


def median(fn, k=5):
    return float(np.median([fn() for _ in range(k)]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=".", help="checkout whose scenenet_tpu_torch to time")
    ap.add_argument("--passes", action="store_true", help="K1's time by kernel (profiler)")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("points_dk_times: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, opts.root)
    from scenenet_tpu_torch.ops import _build, cuda_conv, cuda_hist

    _build.load()
    dev = torch.device("cuda")
    print(f"{opts.root}: {torch.cuda.get_device_name(0)}, {_build.library_path().name}")
    grid = (64, 64, 64)
    for b in (1, 64):
        pts, mask = (torch.from_numpy(a).to(dev) for a in batch(10 + b, b))
        fn = lambda: cuda_hist.points_occupancy(pts, mask, grid)  # noqa: E731
        print(f"K1 points_occupancy B={b}: loop {median(lambda: loop_ms(fn)):.4f} ms, "
              f"graph {median(lambda: graph_ms(fn)):.4f} ms", flush=True)
        if opts.passes:
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    fn()
                torch.cuda.synchronize()
            for e in prof.key_averages():
                if e.device_type == torch.autograd.DeviceType.CUDA:
                    print(f"  B={b} {e.key[:70]}: {e.self_device_time_total / e.count / 1e3:.4f} "
                          f"ms x{e.count}")
    for b in (1, 16):
        rng = np.random.default_rng(b)
        shape = (b, 1, *grid)
        x = torch.from_numpy((rng.random(shape) > 0.8).astype(np.float32)).to(dev)
        g = torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(dev)
        fn = lambda: cuda_conv.stencil_dk(x, g, (9, 5, 5))  # noqa: E731
        print(f"K4 stencil_dk (9,5,5) B={b}: loop {median(lambda: loop_ms(fn)):.4f} ms, "
              f"graph {median(lambda: graph_ms(fn)):.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
