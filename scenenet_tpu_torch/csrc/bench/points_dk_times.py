"""Device times of the points kernels (K1, K3, K6, K9), the ids counts (K7,
K8), the f32 stencil (K2), its kernel gradient (K4) and the tensor-core
stencil (K5).

Run on a machine with the card, from the root of a checkout:

    python3 scenenet_tpu_torch/csrc/bench/points_dk_times.py [--root DIR] [--passes]
        [--kernels k1,k4,k3,k8,k5,k7,k6,k9,k2]

It times K1 at batch 1 and 64 (64^3, 131072 padded points of 40k-70k
synthetic 1 cm LiDAR points), K4 at batch 1 and 16 (64^3, (9,5,5), ~20%
occupancy), K3 at batch 1 and 16 (64^3, 65536 padded points, the tower
points flagged: the train step's shapes) and K8 at 128^3 batch 4 and 256^3
batch 1 (131072 padded points, their bin ids made by the plain version of
the ids kernel, the tower points flagged), K5 at batch 1 and 64 (64^3,
(9,5,5), ~20% occupancy, split, relu(tanh), and at 64 without the head),
K7 at 64^3 batch 16 (65536
padded points, int32 ids as the host-exact loader makes them, the tower
points flagged: two channels) and 128^3 batch 4 (131072), with K8 on the
64^3 input beside it, K6 at 64^3 batch 1 (131072 padded points) and 16
(65536), two channels, the tower points flagged, and K9 at 64^3 batch 1
and 16 and at 128^3 batch 4 (131072), K2 at batch 1, 16 and 64 (64^3,
(9,5,5), ~20% occupancy, relu(tanh)), each as a loop of calls (which
at small batch measures the host's launch rate) and as one call captured
in a CUDA graph and replayed (the device's time), medians of five, in ms.
``--root`` times the package of another checkout instead (an unpacked
earlier commit, to compare two versions in one run: this tree, the other,
this tree, the other). ``--passes`` adds each kernel's time by pass from
``torch.profiler``. Not part of the kernel library; the numbers in PERF.md
name it.
"""

import argparse
import sys

import numpy as np
import torch


def crop(rng, n):
    """A crop and its tower mask: 60% ground, 30% a tower column, 10% clutter."""
    span = rng.uniform(40, 80)
    ng, nt = int(n * 0.6), int(n * 0.3)
    ground = np.column_stack([rng.uniform(0, span, (ng, 2)), rng.normal(0, 0.15, ng)])
    tower = np.column_stack([rng.normal(span / 2, 1, nt), rng.normal(span / 2, 1, nt),
                             rng.uniform(0, 35, nt)])
    rest = rng.uniform([0, 0, 0], [span, span, 12], (n - ng - nt, 3))
    xyz = np.round(np.concatenate([ground, tower, rest]), 2)
    is_tower = np.zeros(n, bool)
    is_tower[ng:ng + nt] = True
    return (xyz - xyz.min(0)).astype(np.float32), is_tower


def batch(seed, b, n_pad=131072, lo=40000, hi=70000):
    rng = np.random.default_rng(seed)
    pts = np.zeros((b, n_pad, 3), np.float32)
    mask = np.zeros((b, n_pad), bool)
    tower = np.zeros((b, n_pad), bool)
    for i in range(b):
        n = min(int(rng.integers(lo, hi)), n_pad)
        pts[i, :n], tower[i, :n] = crop(rng, n)
        mask[i, :n] = True
    return pts, mask, tower


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


def report(label, fn, passes):
    try:
        graph = f"{median(lambda: graph_ms(fn)):.4f} ms"
    except RuntimeError as e:  # a version whose call cannot be captured
        graph = f"not capturable ({str(e)[:80]})"
    print(f"{label}: loop {median(lambda: loop_ms(fn)):.4f} ms, graph {graph}", flush=True)
    if not passes:
        return
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            print(f"  {e.key[:70]}: {e.self_device_time_total / e.count / 1e3:.4f} "
                  f"ms x{e.count}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=".", help="checkout whose scenenet_tpu_torch to time")
    ap.add_argument("--passes", action="store_true", help="each kernel's time by pass")
    ap.add_argument("--kernels", default="k1,k4,k3,k8,k5,k7,k6,k9,k2",
                    help="which of k1,k4,k3,k8,k5,k7,k6,k9,k2 to time")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("points_dk_times: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, opts.root)
    from scenenet_tpu_torch.ops import _build, cuda_conv, cuda_hist

    _build.load()
    dev = torch.device("cuda")
    which = set(opts.kernels.split(","))
    print(f"{opts.root}: {torch.cuda.get_device_name(0)}, {_build.library_path().name}")
    grid = (64, 64, 64)
    for b in (1, 64) if "k1" in which else ():
        pts, mask, _ = (torch.from_numpy(a).to(dev) for a in batch(10 + b, b))
        report(f"K1 points_occupancy B={b}",
               lambda: cuda_hist.points_occupancy(pts, mask, grid), opts.passes)
    for b in (1, 16) if "k4" in which else ():
        rng = np.random.default_rng(b)
        shape = (b, 1, *grid)
        x = torch.from_numpy((rng.random(shape) > 0.8).astype(np.float32)).to(dev)
        g = torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(dev)
        report(f"K4 stencil_dk (9,5,5) B={b}",
               lambda: cuda_conv.stencil_dk(x, g, (9, 5, 5)), opts.passes)
    for b in (1, 16) if "k3" in which else ():
        pts, mask, tower = (torch.from_numpy(a).to(dev) for a in batch(30 + b, b, 65536))
        report(f"K3 points_binary B={b} N=65536",
               lambda: cuda_hist.points_binary(pts, mask, tower, grid), opts.passes)
    for b, side in ((4, 128), (1, 256)) if "k8" in which else ():
        pts, mask, tower = (torch.from_numpy(a).to(dev) for a in batch(50 + b, b))
        ids = cuda_hist.flat_ids_plain(pts, mask, (side,) * 3)
        report(f"K8 sorted_bin_counts {side}^3 B={b} N=131072",
               lambda: cuda_hist.sorted_bin_counts(ids, mask, tower, side ** 3), opts.passes)
    kern = torch.from_numpy(np.random.default_rng(5).normal(0, 0.1, (9, 5, 5))
                            .astype(np.float32)).to(dev)
    for b in (1, 64) if "k5" in which else ():
        rng = np.random.default_rng(60 + b)
        x = torch.from_numpy((rng.random((b, 1, *grid)) > 0.8).astype(np.float32)).to(dev)
        report(f"K5 stencil_mma (9,5,5) B={b}",
               lambda: cuda_conv.geneo_stencil_conv_mxu(x, kern), opts.passes)
        if b == 64:  # what the relu(tanh) head costs
            report(f"K5 stencil_mma (9,5,5) B={b} without the head",
                   lambda: cuda_conv.geneo_stencil_conv_mxu(x, kern, activation=False), False)
    for b, side, n in ((16, 64, 65536), (4, 128, 131072)) if "k7" in which else ():
        pts, mask, tower = (torch.from_numpy(a).to(dev) for a in batch(70 + b, b, n))
        ids = cuda_hist.flat_ids_plain(pts, mask, (side,) * 3)
        report(f"K7 bin_counts {side}^3 B={b} N={n} two channels",
               lambda: cuda_hist.bin_counts(ids, mask, side ** 3, tower), opts.passes)
        if side == 64:
            report(f"K8 sorted_bin_counts {side}^3 B={b} N={n} (beside K7)",
                   lambda: cuda_hist.sorted_bin_counts(ids, mask, tower, side ** 3),
                   opts.passes)
    for b, n in ((1, 131072), (16, 65536)) if "k6" in which else ():
        pts, mask, tower = (torch.from_numpy(a).to(dev) for a in batch(80 + b, b, n))
        report(f"K6 points_bin_counts 64^3 B={b} N={n} two channels",
               lambda: cuda_hist.points_bin_counts(pts, mask, tower, grid), opts.passes)
    for b, side, n in ((1, 64, 131072), (16, 64, 65536), (4, 128, 131072)) if "k9" in which \
            else ():
        pts, mask, _ = (torch.from_numpy(a).to(dev) for a in batch(90 + b, b, n))
        report(f"K9 flat_ids {side}^3 B={b} N={n}",
               lambda: cuda_hist.flat_ids(pts, mask, (side,) * 3), opts.passes)
    for b in (1, 16, 64) if "k2" in which else ():
        rng = np.random.default_rng(20 + b)
        x = torch.from_numpy((rng.random((b, 1, *grid)) > 0.8).astype(np.float32)).to(dev)
        report(f"K2 stencil_conv (9,5,5) B={b}",
               lambda: cuda_conv.geneo_stencil_conv(x, kern), opts.passes)
    return 0


if __name__ == "__main__":
    sys.exit(main())
