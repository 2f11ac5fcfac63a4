#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``scenenet_tpu_torch``) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

It builds the hand-written kernels from ``scenenet_tpu_torch/csrc`` with
nvcc, holds each against its plain PyTorch version on the card and times
both, with one PyTorch library call beside those that have one (the
multi-channel conv at every shape its plan treats differently, twice for
bit-equal outputs; the f32 stencil and its kernel gradient through both
of their kernels; at batch 1 the occupancy kernel and the kernel gradient,
the tensor-core stencil at batch 1 and 64, the training grids and the ids
counts (beside the sorted-ids counts) at batch 16 and the sorted-ids counts
at 128³ also inside a CUDA graph, whose replay times the device where a
loop of calls would time the host). Then it
drives the port's main paths through their entry points, at the serving
defaults (64³ grid, 131072 points, SceneNet (9,5,5)) and the width of
experiments/defaults.yaml (batch 16, 64³, 65536 points, geneo_tversky):

- it serves a few requests through the HTTP server at batch 1 and
  compares every reply with the same request through a CPU pipeline;
- it runs the batched pipeline at batch 64 with ``inference="mxu"`` and
  the fused τ-mask (occupancy kernel → tensor-core stencil) against the
  f32 stencil route;
- it serves 16 concurrent requests through a server built as
  ``serve --inference mxu --max-batch 8`` builds it, then through
  ``--max-batch auto``, and one request through ``--model quantile``;
- it trains for two epochs through the train CLI on seeded synthetic
  TS40K-style crops, then checks three train steps of the kernel backend
  against the plain one;
- it trains through ``cli.train --host-indices`` at the same width (bins
  from the host in float64, counted by the ids kernel), and at a 128³
  grid (batch 4, 131072 points) with and without ``--host-indices`` (both
  through the sorted-ids kernel), and serves one request at ``--grid 128``;
- it takes three train steps on a tower-fraction target and makes density
  grids (the counts kernel), and asks for the bin ids alone (the ids
  kernel);
- it trains UNet3D at its full ladder (32-64-128-256-256, 18 3x3x3 convs)
  through ``cli.train --set model=unet`` at the defaults' width (batch 16,
  64³), every conv and its input gradient in the multi-channel conv
  kernel, checks three steps of that backend against the plain one, times
  the step on both, and trains ``model=cnn`` with a (3,3,3) kernel.

It prints one line per phase, the card's name and power limit, a JSON line
of kernel results and, last, ``{"ok": true, "device": {...}}``. Any failure
raises and exits non-zero; without a CUDA device it exits non-zero at
once. ``--profile`` adds ``torch.profiler`` passes over the batched
serving and over the train step at both widths (device busy share, device
items per dispatch or step; for the UNet step also the conv kernel's and
the weight gradient's share of the device time).
"""

from __future__ import annotations

import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from http.server import ThreadingHTTPServer
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
GRID = (64, 64, 64)
MAX_POINTS = 131072       # serving default
TRAIN_POINTS = 65536      # experiments/defaults.yaml max_points
TRAIN_BATCH = 16          # experiments/defaults.yaml batch_size
BIG_GRID = (128, 128, 128)  # the large-grid configuration: batch 4, 131072 points
BIG_BATCH = 4
KITTI_GRID, KITTI_POINTS = (64, 64, 256), 32768  # a non-cubic grid of 2048 rows of 512 bins
HUGE_GRID = (256, 256, 256)  # one channel of counts is 64 MB, more than the L2
DENSE_POINTS = 4 * 1024 * 1024  # a dense cloud for it: a point to every fourth bin
TAU = 0.65
PROB_TOL = 1e-5  # f32 conv: the kernel sums its 225 taps in another order than cuDNN
DK_REL_TOL = 1e-4  # dk: f32 sums of 4.2 M products per tap in another order
# tensor-core stencil vs its plain version: the same exact bf16 x bf16 products,
# summed in f32 in another order
MXU_TOL = 1e-5
# tensor-core stencil (split) vs the f32 stencil: what hi + lo/512 leaves of the
# kernel (2^-17 relative a tap) over up to 225 taps
MXU_F32_TOL = 1e-4
# float-weight bin counts: the same bf16-rounded weights, summed in f32 by atomics in
# another order than index_add_ (relative, and absolute near 0)
WEIGHTED_TOL = 1e-5
# device grids against the float64 host oracle: one f32 division a voxel
ORACLE_TOL = 1e-6
# published peaks of one H100 SXM: device memory, f32 outside the tensor cores,
# dense bf16 and dense TF32 in them
HBM_BPS, F32_FLOPS, BF16_FLOPS = 3.35e12, 67e12, 989e12
TF32_FLOPS = 495e12
TOWER, GROUND, WIRE, CLUTTER = 15, 2, 14, 1  # TS40K class ids

# experiments/defaults.yaml as train-CLI overrides: the card machine may
# lack PyYAML, so the smoke passes the defaults by --set, not --config
DEFAULTS_SET = [
    "project=scenenet_ts40k", "output_dir=experiments/outputs", "seed=0",
    "dataset=ts40k", "data_path=''", "batch_size=16", "voxel_grid_size=(64, 64, 64)",
    "voxel_size=None", "num_workers=8", "val_split=0.1", "test_split=0.3",
    "model=scenenet", "cylinder_geneo=1", "arrow_geneo=1", "neg_sphere_geneo=1",
    "kernel_size=(9, 5, 5)", "model_backend=auto",
    "optimizer=adam", "learning_rate=0.001", "max_epochs=20",
    "early_stop_metric=train_FBetaScore", "early_stop_patience=25",
    "accumulate_grad_batches=1", "tau=0.65",
    "criterion=geneo_tversky", "weight_alpha=1", "weight_epsilon=0.1", "mse_weight=1",
    "convex_weight=5", "tversky_alpha=2", "tversky_beta=1", "tversky_smooth=1.0e-6",
    "focal_gamma=4",
    "mesh_data=1", "mesh_space=1", "mesh_dcn_data=1", "mesh_ensemble=1", "mesh_channel=1",
    "device_voxelization=True", "device_cache=auto", "augment=False", "max_points=65536",
    "precision=f32", "fast_dev_run=False", "auto_lr_find=False",
    "auto_scale_batch_size=False",
]
N_FIT, N_TEST, TRAIN_EPOCHS = 56, 16, 2
# multi-channel conv vs F.conv3d (cuDNN f32, TF32 off): f32 sums of 27*C_in products
# in another order, on outputs of magnitude ~1. 2e-5 + 1e-5 relative up to 160 input
# channels (the JAX package's own test bound and range); past that the absolute
# part grows with the square root of the sum's length (x 1.8 at 512 channels)
MC_ATOL, MC_RTOL, MC_ATOL_CHANNELS = 2e-5, 1e-5, 160
MC_DW_REL_TOL = 1e-4  # the library's dw in two formulations: sums over 4.2 M voxels
# the shapes the multi-channel conv's plan treats differently, beside the UNet's layers
# at the train batch: (batch, C_in, C_out, (Z, X, Y))
MC_EXTRA = [(1, 256, 256, (4, 4, 4)),   # batch 1 in the four-sample tile, the K split at its cap
            (1, 128, 256, (8, 8, 8)),   # batch 1 at 8^3
            (2, 100, 64, (8, 8, 8)),    # a K split whose C_in is no multiple of the K step
            (3, 40, 30, (6, 10, 7)),    # C_out no multiple of 8, Y no multiple of 4
            (2, 16, 24, (5, 9, 7))]
# UNet3D's 18 3x3x3 convs in forward order: (C_in, C_out, cubic extent at a 64^3 grid)
UNET_CONVS = [(1, 32, 64), (32, 32, 64), (32, 64, 32), (64, 64, 32), (64, 128, 16),
              (128, 128, 16), (128, 256, 8), (256, 256, 8), (256, 256, 4), (256, 256, 4),
              (512, 256, 8), (256, 128, 8), (256, 128, 16), (128, 64, 16), (128, 64, 32),
              (64, 32, 32), (64, 32, 64), (32, 32, 64)]
UNET_TRAIN_LAUNCHES, UNET_EVAL_LAUNCHES = 35, 18  # 18 forward + 17 dx (none at C_in = 1)
# UNet train steps, kernel backend vs plain: the convs round differently, and Adam
# turns a gradient entry near 0 into a step of +-lr = 1e-3 in either; the running
# statistics are held to 3e-3 absolute plus 3e-3 relative
UNET_LOSS_RTOL, UNET_STATS_TOL = 1e-3, 3e-3
BIG_FIT, BIG_TEST = 18, 4  # the 128³ runs' smaller directory: 4 train steps an epoch


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def synthetic_crop(rng: np.random.Generator, n: int):
    """A LiDAR-like crop: ground, three tower-like columns, a wire and
    clutter, rounded to 1 cm like real scans (points land on voxel edges).
    Returns (xyz (n, 3) float64, TS40K labels (n,))."""
    span = rng.uniform(40.0, 80.0)
    n_ground, n_tower, n_wire = int(n * 0.5), int(n * 0.2), int(n * 0.1)
    n_rest = n - n_ground - n_tower - n_wire
    ground = np.column_stack([rng.uniform(0, span, (n_ground, 2)),
                              rng.normal(0.0, 0.15, n_ground)])
    towers = []
    for i, share in enumerate(np.array_split(np.arange(n_tower), 3)):
        cx, cy = rng.uniform(0.2 * span, 0.8 * span, 2)
        towers.append(np.column_stack([rng.normal(cx, 1.0, len(share)),
                                       rng.normal(cy, 1.0, len(share)),
                                       rng.uniform(0, 35.0 + 5 * i, len(share))]))
    t = rng.uniform(0, 1, n_wire)
    wire = np.column_stack([t * span, 0.5 * span + 0.1 * t * span,
                            25.0 - 4.0 * np.sin(np.pi * t)])
    clutter = rng.uniform([0, 0, 0], [span, span, 12.0], (n_rest, 3))
    labels = np.repeat([GROUND, TOWER, WIRE, CLUTTER], [n_ground, n_tower, n_wire, n_rest])
    return np.round(np.concatenate([ground, *towers, wire, clutter]), 2), labels


def synthetic_cloud(rng: np.random.Generator, n: int) -> np.ndarray:
    xyz, _ = synthetic_crop(rng, n)
    return (xyz - xyz.min(0)).astype(np.float32)


def padded_batch(rng, b, n_pad=MAX_POINTS, lo=40000, hi=70000):
    """(B, n_pad, 3) f32 centred points, (B, n_pad) mask, (B, n_pad) labels."""
    pts = np.zeros((b, n_pad, 3), np.float32)
    mask = np.zeros((b, n_pad), bool)
    labels = np.zeros((b, n_pad), np.int32)
    for i in range(b):
        n = min(int(rng.integers(lo, hi)), n_pad)
        xyz, lab = synthetic_crop(rng, n)
        pts[i, :n] = (xyz - xyz.min(0)).astype(np.float32)
        labels[i, :n] = lab
        mask[i, :n] = True
    return pts, mask, labels


def full_column_case():
    """Every voxel of y column 0 holds ≥ 2 points: there the occupancy rule
    (count > column min) differs from count > 0."""
    pts = [[ix + 0.5, 0.5, iz + 0.5] for iz in range(8) for ix in range(8) for _ in range(2)]
    pts += [[0.5, 0.5, 0.5], [7.9, 7.9, 7.9]]
    pts = np.asarray(pts, np.float32)[None]
    return pts, np.ones(pts.shape[:2], bool)


def mixed_full_column_case():
    """Full columns in part of a batch: sample 0 fills y columns 0 and 3 (one
    voxel of column 3 holds three more points), sample 1 is
    ``full_column_case``, sample 2 has no full column."""
    col0, _ = full_column_case()
    col3 = [[ix + 0.5, 3.5, iz + 0.5] for iz in range(8) for ix in range(8)]
    clouds = [np.concatenate([col0[0], np.asarray(col3 + [[1.5, 3.5, 1.5]] * 3, np.float32)]),
              col0[0], np.random.default_rng(6).uniform(0, 8, (200, 3)).astype(np.float32)]
    pts = np.zeros((3, max(len(c) for c in clouds), 3), np.float32)
    mask = np.zeros(pts.shape[:2], bool)
    for i, c in enumerate(clouds):
        pts[i, :len(c)], mask[i, :len(c)] = c, True
    return pts, mask


def indexed_batch(pad, rng: np.random.Generator, b: int, lo=40000, hi=65000):
    """b synthetic crops in world coordinates through ``pad``, a
    PointPadding with compute_indices=True, as the loader of the host-exact
    route makes them: stacked [points, labels, mask, flat_idx], and the
    float64 crops (none longer than the pad, so none is subsampled)."""
    crops = []
    for _ in range(b):
        xyz, lab = synthetic_crop(rng, min(int(rng.integers(lo, hi)), pad.max_points))
        crops.append((xyz + rng.uniform(0, 1000, 3).round(2), lab))
    return [np.stack(col) for col in zip(*(pad(c) for c in crops))], crops


def write_dataset(root: Path, seed: int = 7, n_fit: int = N_FIT, n_test: int = N_TEST) -> None:
    """Seeded synthetic TS40K directory: fit/ and test/ of sample_i.npy,
    (N, 4) float64 xyz + label, 40k–70k points each, 1 cm."""
    rng = np.random.default_rng(seed)
    for split, n in (("fit", n_fit), ("test", n_test)):
        (root / split).mkdir(parents=True)
        for i in range(n):
            xyz, lab = synthetic_crop(rng, int(rng.integers(40000, 70000)))
            xyz = xyz + rng.uniform(0, 1000, 3).round(2)  # world coordinates
            np.save(root / split / f"sample_{i}.npy",
                    np.concatenate([xyz, lab[:, None]], axis=1))


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 200) -> float:
    """Device ms per call of ``fn`` captured once in a CUDA graph and
    replayed: what the card spends, without the host's launch time."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, iters)


def paired_ms(kernel_fn, plain_fn, iters: int, rounds: int = 4, library_fn=None,
              warmup: int = 3):
    """Median ms per call of the kernel, of its plain version and, where
    given, of the one library call that computes the same function, timed
    in alternating order (plain, library, kernel, kernel, library, plain,
    ...), with each side's min and max."""
    sides = [("plain", plain_fn), ("library", library_fn), ("kernel", kernel_fn)]
    sides = [(k, fn) for k, fn in sides if fn is not None]
    acc = {k: [] for k, _ in sides}
    for r in range(rounds):
        for k, fn in (sides if r % 2 == 0 else sides[::-1]):
            acc[k].append(cuda_ms(fn, iters, warmup))
    out = {"ms": float(np.median(acc["kernel"])), "plain_ms": float(np.median(acc["plain"])),
           "range": (min(acc["kernel"]), max(acc["kernel"])),
           "plain_range": (min(acc["plain"]), max(acc["plain"])), "library_ms": None}
    if library_fn is not None:
        out["library_ms"] = float(np.median(acc["library"]))
        out["library_range"] = (min(acc["library"]), max(acc["library"]))
    return out


def fmt_times(t: dict) -> str:
    parts = []
    for k, v in t.items():
        text = (f"{k} kernel {v['ms']:.4f} [{v['range'][0]:.4f}-{v['range'][1]:.4f}] vs plain "
                f"{v['plain_ms']:.4f} [{v['plain_range'][0]:.4f}-{v['plain_range'][1]:.4f}]")
        if v["library_ms"] is not None:
            text += (f" vs library {v['library_ms']:.4f} [{v['library_range'][0]:.4f}-"
                     f"{v['library_range'][1]:.4f}]")
        parts.append(text)
    return " | ".join(parts)


def bound_ms(bytes_moved: float, flops: float = 0.0, peak_flops: float = F32_FLOPS):
    """The least time the card could take: the larger of the bytes (each
    input read once, each output written once) over the memory rate and
    the operations over the peak rate of their type. Returns (ms, which)."""
    t_bytes, t_ops = bytes_moved / HBM_BPS * 1e3, flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def post(url: str, points: np.ndarray, tau: float):
    buf = io.BytesIO()
    np.savez(buf, points=points, tau=np.float32(tau))
    req = urllib.request.Request(url, data=buf.getvalue(), method="POST")
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as r:
        status, body, server_ms = r.status, r.read(), float(r.headers["X-Latency-Ms"])
    return status, np.load(io.BytesIO(body)), (time.perf_counter() - t0) * 1e3, server_ms


def post_concurrently(url: str, clouds, tau: float):
    """One client thread per cloud, all started together; the replies in order."""
    out = [None] * len(clouds)

    def client(i):
        try:
            out[i] = post(url, clouds[i], tau)
        except Exception as exc:  # re-raised below, in the main thread
            out[i] = exc

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(len(clouds))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    check(not any(t.is_alive() for t in threads), "a client never got its reply")
    for r in out:
        if isinstance(r, Exception):
            raise r
    return out, time.perf_counter() - t0


class running:
    """Serve (server, pipeline) from a thread for the length of a with-block."""

    def __init__(self, server, pipeline):
        self.server, self.pipeline = server, pipeline
        self.thread = threading.Thread(target=server.serve_forever, daemon=True)

    def __enter__(self):
        self.thread.start()
        return f"http://127.0.0.1:{self.server.server_address[1]}"

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=30)
        self.pipeline.close()
        check(not self.thread.is_alive(), "the server thread did not end")


def healthz(url: str) -> dict:
    with urllib.request.urlopen(f"{url}/healthz", timeout=60) as r:
        return json.loads(r.read())


def main(argv=None) -> int:
    import argparse

    import torch
    import torch.nn.functional as F

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="also profile the batched serving and the train step with "
                             "torch.profiler")
    opts = parser.parse_args(argv)
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device; nothing was run", file=sys.stderr)
        return 1
    if not (ROOT / "scenenet_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from the root of a checkout of the repo", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from scenenet_tpu_torch.cli import train as train_cli
    from scenenet_tpu_torch.cli.serve import _Pipeline, build_server, make_handler
    from scenenet_tpu_torch.data import PointCloudLoader, PointPadding, TS40K
    from scenenet_tpu_torch.losses import resolve_criterion
    from scenenet_tpu_torch.models.scenenet import SceneNet
    from scenenet_tpu_torch.models.unet3d import BLOCKS, UNet3D
    from scenenet_tpu_torch.ops import _build, cuda_conv, cuda_conv_mc, cuda_hist
    from scenenet_tpu_torch.ops.conv3d import conv3d_same, same_pads
    from scenenet_tpu_torch.ops import voxel_np
    from scenenet_tpu_torch.ops.voxelize import (
        batch_flat_ids, voxelize_batch, voxelize_batch_from_indices, voxelize_batch_hist,
        voxelize_batch_occupancy,
    )
    from scenenet_tpu_torch.train import (
        TrainConfig, Trainer, make_device_voxelize_prep, metrics,
    )
    from scenenet_tpu_torch.train.checkpoint import restore_checkpoint
    from scenenet_tpu_torch.utils.config import load_config

    counters = {"points_occupancy": cuda_hist.LAUNCHES,
                "stencil_conv": cuda_conv.LAUNCHES,
                "points_binary": cuda_hist.BINARY_LAUNCHES,
                "stencil_dk": cuda_conv.DK_LAUNCHES,
                "stencil_mma": cuda_conv.MXU_LAUNCHES,
                "points_bin_counts": cuda_hist.BIN_COUNTS_LAUNCHES,
                "bin_counts": cuda_hist.FLAT_COUNTS_LAUNCHES,
                "sorted_bin_counts": cuda_hist.SORTED_COUNTS_LAUNCHES,
                "flat_ids": cuda_hist.FLAT_IDS_LAUNCHES,
                "conv3d_mc": cuda_conv_mc.MC_LAUNCHES}

    def reset_counts():
        for c in counters.values():
            c.reset()

    def read_counts():
        return {k: c.count for k, c in counters.items()}

    def profiled(fn):
        """fn under torch.profiler: wall seconds, device busy µs, the count of
        device items, the six largest of them as text, and the device µs by
        kernel name and (inclusive of its kernels) by host operator."""
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        on_dev = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_us = sum(e.self_device_time_total for e in on_dev)
        check(busy_us > 0, "the profiler recorded no device time")
        top = sorted(on_dev, key=lambda e: -e.self_device_time_total)[:6]
        by_name = {e.key: e.device_time_total for e in prof.key_averages()
                   if e.device_type != torch.autograd.DeviceType.CUDA}
        by_name.update((e.key, e.self_device_time_total) for e in on_dev)
        return wall, busy_us, sum(e.count for e in on_dev), ", ".join(
            f"{e.key[:40]} {e.self_device_time_total / 1e3:.3f} ms x{e.count}"
            for e in top), by_name

    # ---- 1. device --------------------------------------------------------
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[device] {name} | {smi} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| devices {torch.cuda.device_count()}", flush=True)

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    _build.load()
    log = _build.library_path().with_suffix(".log").read_text()
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    spills = sum(int(s) for s in re.findall(r"(\d+) bytes spill stores", log))
    print(f"[build] {time.perf_counter() - t0:.2f} s (nvcc {_build.build_seconds:.2f} s, "
          f"one process per source) -> {_build.library_path().name}; max registers "
          f"{max(regs, default=-1)}, spill stores {spills} B", flush=True)

    rng = np.random.default_rng(0)

    # ---- 3. K1 occupancy kernel vs plain ------------------------------------
    pts8, mask8, _ = padded_batch(rng, 8)
    col_pts, col_mask = full_column_case()
    ng_pts, ng_mask, _ = padded_batch(rng, 4)
    mix_pts, mix_mask = mixed_full_column_case()
    k1_cases = [("B8_N131072_64^3", pts8, mask8, GRID),
                ("full_column_8^3", col_pts, col_mask, (8, 8, 8)),
                ("B3_mixed_full_columns_8^3", mix_pts, mix_mask, (8, 8, 8)),
                ("B4_grid48x40x56", ng_pts, ng_mask, (48, 40, 56))]
    k1_err, occ64, occ_ng = 0.0, None, None
    parts = []
    for label, p, m, g in k1_cases:
        pt, mt = torch.from_numpy(p).to(dev), torch.from_numpy(m).to(dev)
        got = cuda_hist.points_occupancy(pt, mt, g)
        want = cuda_hist.points_occupancy_plain(pt, mt, g)
        torch.cuda.synchronize()
        diff = int((got != want).sum())
        k1_err = max(k1_err, float((got - want).abs().max()))
        check(diff == 0, f"K1 {label}: {diff} voxels differ from the plain version")
        check(torch.equal(got, cuda_hist.points_occupancy(pt, mt, g)), f"K1 {label}: two runs differ")
        if label.startswith("full_column"):
            occ = got.reshape(8, 8, 8).cpu().numpy()
            check(occ[:, :, 0].sum() == 1 and occ[0, 0, 0] == 1 and occ[7, 7, 7] == 1,
                  "K1 full-column case: column-min rule broken")
        if "mixed" in label:
            occ = got.reshape(3, 8, 8, 8).cpu().numpy()
            check(occ[0, :, :, 0].sum() == occ[0, :, :, 3].sum() == occ[1, :, :, 0].sum() == 1,
                  "K1 mixed full-column case: column-min rule broken")
        if g == GRID:
            occ64 = got
        if g == (48, 40, 56):
            occ_ng = got.reshape(len(p), 1, g[2], g[0], g[1])
        parts.append(f"{label}: {int(got.sum())} occupied, 0 differ")
    print(f"[K1 occupancy] exact on all {len(k1_cases)} inputs | " + " | ".join(parts),
          flush=True)

    # ---- 4. K2 stencil kernel vs plain --------------------------------------
    x = occ64.reshape(8, 1, GRID[2], GRID[0], GRID[1])
    k2_err, parts = 0.0, []
    for ks in ((9, 5, 5), (9, 6, 6)):
        with torch.no_grad():
            kern = SceneNet.create(kernel_size=ks, seed=0).combined_kernel().to(dev)
            got = cuda_conv.geneo_stencil_conv(x, kern)
            want = cuda_conv.geneo_stencil_conv_plain(x, kern)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        flips = (got >= TAU) != (want >= TAU)
        bad_flips = int((flips & ((want - TAU).abs() > PROB_TOL)).sum())
        check(torch.isfinite(got).all().item(), f"K2 {ks}: non-finite output")
        check(err <= PROB_TOL, f"K2 {ks}: max|dprob| {err:.3g} > {PROB_TOL}")
        check(bad_flips == 0, f"K2 {ks}: {bad_flips} tau-mask flips outside the 1e-5 band")
        k2_err = max(k2_err, err)
        parts.append(f"k{ks}: max|dprob| {err:.3g}, tau flips {int(flips.sum())} "
                     f"(outside band {bad_flips})")
    # the unrolled kernel ((9,5,5)) against the generic one on the same input, and
    # each against itself
    kern = SceneNet.create(kernel_size=(9, 5, 5), seed=0).combined_kernel().detach().to(dev)
    x32 = torch.cat([x, x.flip(2), x.flip(3), x.flip(4)])
    check(cuda_conv.stencil_route((9, 5, 5)) == "fast"
          and cuda_conv.stencil_route((9, 6, 6)) == "generic",
          "the stencil's routes are not what the smoke expects")
    want = cuda_conv.geneo_stencil_conv_plain(x32, kern)
    routes = {r: cuda_conv._launch_stencil(x32, kern, True, r) for r in ("fast", "generic")}
    torch.cuda.synchronize()
    check(torch.equal(routes["fast"], cuda_conv.geneo_stencil_conv(x32, kern)),
          "K2: a (9,5,5) launch did not take the unrolled kernel")
    for r, got in routes.items():
        err = float((got - want).abs().max())
        check(err <= PROB_TOL, f"K2 {r} route: max|dprob| {err:.3g} > {PROB_TOL}")
        check(torch.equal(got, cuda_conv._launch_stencil(x32, kern, True, r)),
              f"K2 {r} route: two runs differ")
        k2_err = max(k2_err, err)
    route_err = float((routes["fast"] - routes["generic"]).abs().max())
    check(route_err <= PROB_TOL, f"K2: the two routes differ by {route_err:.3g}")
    parts.append(f"B=32 k(9, 5, 5): unrolled vs generic kernel max|d| {route_err:.3g}, each "
                 "bit-identical run to run")
    print("[K2 stencil] " + " | ".join(parts), flush=True)
    del x32, routes, want

    # ---- 5. K3 two-channel kernel vs plain ----------------------------------
    tp, tm, tl = padded_batch(np.random.default_rng(16), TRAIN_BATCH, n_pad=TRAIN_POINTS)
    tower16 = (tl == TOWER) & tm
    col_tower = np.zeros(col_mask.shape, bool)
    col_tower[0, ::3] = True
    ng_tower = np.random.default_rng(5).random(ng_mask.shape) < 0.05
    k3_cases = [("B16_N65536_64^3", tp, tm, tower16, GRID),
                ("full_column_8^3", col_pts, col_mask, col_tower, (8, 8, 8)),
                ("B4_grid48x40x56", ng_pts, ng_mask, ng_tower & ng_mask, (48, 40, 56))]
    k3_err, occ16, parts = 0.0, None, []
    for label, p, m, w, g in k3_cases:
        args = [torch.from_numpy(a).to(dev) for a in (p, m, w)]
        got = cuda_hist.points_binary(*args, g)
        want = cuda_hist.points_binary_plain(*args, g)
        torch.cuda.synchronize()
        for ch, a, b in zip("xy", got, want):
            diff = int((a != b).sum())
            k3_err = max(k3_err, float((a - b).abs().max()))
            check(diff == 0, f"K3 {label} channel {ch}: {diff} voxels differ from plain")
        check(torch.equal(got[0], cuda_hist.points_occupancy(args[0], args[1], g)),
              f"K3 {label}: occupancy channel differs from K1")
        check(int(got[1].sum()) > 0, f"K3 {label}: no tower voxel")
        if g == GRID:
            occ16 = got[0]
        parts.append(f"{label}: {int(got[0].sum())} occupied, {int(got[1].sum())} tower, "
                     "0 differ")
    print(f"[K3 points_binary] exact on both channels of all {len(k3_cases)} inputs | "
          + " | ".join(parts), flush=True)

    # ---- 6. K4 kernel gradient vs plain -------------------------------------
    x16 = occ16.reshape(TRAIN_BATCH, 1, GRID[2], GRID[0], GRID[1])
    g16 = torch.from_numpy(np.random.default_rng(6).normal(
        0, 1, tuple(x16.shape)).astype(np.float32)).to(dev)
    k4_err, parts = 0.0, []
    for ks in ((9, 5, 5), (9, 6, 6)):
        got = cuda_conv.stencil_dk(x16, g16, ks)
        again = cuda_conv.stencil_dk(x16, g16, ks)
        want = cuda_conv.stencil_dk_plain(x16, g16, ks)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        check(bool(torch.isfinite(got).all()), f"K4 {ks}: non-finite dk")
        check(err <= DK_REL_TOL * scale, f"K4 {ks}: max|ddk| {err:.3g} > 1e-4 x {scale:.3g}")
        check(torch.equal(got, again), f"K4 {ks}: two runs differ")
        k4_err = max(k4_err, err)
        parts.append(f"k{ks}: max|ddk| {err:.3g} (max|dk| {scale:.3g}), two runs "
                     "bit-identical")
    # the unrolled kernel ((9,5,5)) against the generic one on the same input, each
    # against itself, at B=16 and at a ragged B=2 volume; other sizes, generic
    check(cuda_conv.stencil_route((9, 5, 5)) == "fast"
          and cuda_conv.stencil_route((9, 6, 6)) == "generic",
          "the kernel gradient's routes are not what the smoke expects")
    ragged = (torch.rand((2, 1, 13, 37, 70), device=dev,
                         generator=torch.Generator(dev).manual_seed(7)) > 0.8).float()
    g_ragged = torch.randn(tuple(ragged.shape), device=dev,
                           generator=torch.Generator(dev).manual_seed(8))
    for label, xk, gk in (("B=16 64^3", x16, g16), ("B=2 13x37x70", ragged, g_ragged)):
        want = cuda_conv.stencil_dk_plain(xk, gk, (9, 5, 5))
        scale = float(want.abs().max())
        routes = {r: cuda_conv._launch_dk(xk, gk, (9, 5, 5), r) for r in ("fast", "generic")}
        check(torch.equal(routes["fast"], cuda_conv.stencil_dk(xk, gk, (9, 5, 5))),
              "K4: a (9,5,5) launch did not take the unrolled kernel")
        for r, got in routes.items():
            err = float((got - want).abs().max())
            check(err <= DK_REL_TOL * scale, f"K4 {r} route {label}: max|ddk| {err:.3g}")
            check(torch.equal(got, cuda_conv._launch_dk(xk, gk, (9, 5, 5), r)),
                  f"K4 {r} route {label}: two runs differ")
            k4_err = max(k4_err, err)
        parts.append(f"{label} k(9, 5, 5): unrolled vs generic kernel max|d| "
                     f"{float((routes['fast'] - routes['generic']).abs().max()):.3g} "
                     f"(max|dk| {scale:.3g}), each bit-identical run to run")
    for ks in ((1, 1, 1), (16, 3, 3)):
        got = cuda_conv.stencil_dk(ragged, g_ragged, ks)
        want = cuda_conv.stencil_dk_plain(ragged, g_ragged, ks)
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        check(err <= DK_REL_TOL * scale and torch.equal(got, cuda_conv.stencil_dk(
            ragged, g_ragged, ks)), f"K4 {ks}: max|ddk| {err:.3g} of {scale:.3g}, or runs differ")
        k4_err = max(k4_err, err)
        parts.append(f"B=2 13x37x70 k{ks}: max|ddk| {err:.3g} (max|dk| {scale:.3g}), bit-identical")
    del ragged, g_ragged
    print("[K4 stencil_dk] B=16 64^3 | " + " | ".join(parts), flush=True)

    # ---- 7. fused_geneo_conv gradients vs autograd of the plain conv -------
    w16 = torch.from_numpy(np.random.default_rng(8).normal(
        0, 1, tuple(x16.shape)).astype(np.float32)).to(dev)
    parts = []
    for ks in ((9, 5, 5), (9, 6, 6)):
        k0 = SceneNet.create(kernel_size=ks, seed=0).combined_kernel().detach().to(dev)
        xa, ka = x16.clone().requires_grad_(), k0.clone().requires_grad_()
        (cuda_conv.fused_geneo_conv(xa, ka) * w16).sum().backward()
        xb, kb = x16.clone().requires_grad_(), k0.clone().requires_grad_()
        (torch.relu(torch.tanh(conv3d_same(xb, kb[None, None]))) * w16).sum().backward()
        torch.cuda.synchronize()
        dk_err = float((ka.grad - kb.grad).abs().max())
        dk_scale = float(kb.grad.abs().max())
        dx_err = float((xa.grad - xb.grad).abs().max())
        check(dk_err <= DK_REL_TOL * dk_scale, f"fused {ks}: dk off by {dk_err:.3g}")
        check(dx_err <= 1e-5, f"fused {ks}: dx off by {dx_err:.3g}")
        parts.append(f"k{ks}: max|ddk| {dk_err:.3g} (max|dk| {dk_scale:.3g}), "
                     f"max|ddx| {dx_err:.3g}")
    print("[fused_geneo_conv] grads vs autograd of relu(tanh(conv3d)), TF32 off, "
          "B=16 64^3 | " + " | ".join(parts), flush=True)

    # ---- 7b. K5 tensor-core stencil vs plain, and vs K2 -------------------------
    x_big = (torch.rand((1, 1, 40, 144, 200), device=dev,
                        generator=torch.Generator(dev).manual_seed(3)) > 0.7).float()
    k5_err, k5_f32_err, parts = 0.0, 0.0, []
    for label, xk, sizes in (("B8_64^3", x, ((9, 5, 5), (9, 6, 6))),
                             ("B4_56x48x40", occ_ng, ((9, 5, 5), (9, 6, 6))),
                             ("B1_40x144x200", x_big, ((9, 5, 5),))):
        for ks in sizes:
            with torch.no_grad():
                kern = SceneNet.create(kernel_size=ks, seed=0).combined_kernel().to(dev)
            worst = 0.0
            for split in (True, False):
                for act in (True, False):
                    got = cuda_conv.geneo_stencil_conv_mxu(xk, kern, activation=act, split=split)
                    again = cuda_conv.geneo_stencil_conv_mxu(xk, kern, activation=act,
                                                             split=split)
                    want = cuda_conv.geneo_stencil_conv_mxu_plain(xk, kern, activation=act,
                                                                  split=split)
                    torch.cuda.synchronize()
                    check(torch.equal(got, again), f"K5 {label} {ks}: two runs differ")
                    err = float((got - want).abs().max())
                    tol = MXU_TOL * max(1.0, float(want.abs().max()))
                    check(bool(torch.isfinite(got).all()), f"K5 {label} {ks}: non-finite")
                    check(err <= tol, f"K5 {label} {ks} split={split} activation={act}: "
                                      f"max|d| {err:.3g} > {tol:.3g}")
                    worst = max(worst, err)
                    if split and act:
                        k5_err = max(k5_err, err)
                        probs, plain = got, want
            mask = cuda_conv.geneo_stencil_conv_mxu(xk, kern, tau=TAU)
            check(torch.equal(mask, (probs >= TAU).float()),
                  f"K5 {label} {ks}: fused mask differs from its own probabilities")
            flips = mask != (plain >= TAU).float()
            bad = int((flips & ((plain - TAU).abs() > MXU_TOL)).sum())
            check(bad == 0, f"K5 {label} {ks}: {bad} tau-mask flips outside the 1e-5 band")
            f32 = cuda_conv.geneo_stencil_conv(xk, kern)
            torch.cuda.synchronize()
            f32_err = float((probs - f32).abs().max())
            check(f32_err <= MXU_F32_TOL, f"K5 {label} {ks}: {f32_err:.3g} from the f32 "
                                          f"stencil, > {MXU_F32_TOL}")
            k5_f32_err = max(k5_f32_err, f32_err)
            f32_flips = int((mask != (f32 >= TAU).float()).sum())
            parts.append(f"{label} k{ks}: max|d| vs plain {worst:.3g} (split/single, with/"
                         f"without head), fused tau flips vs plain {int(flips.sum())} "
                         f"(outside band {bad}); vs K2 f32 max|dprob| {f32_err:.3g}, tau "
                         f"flips {f32_flips} of {int(mask.sum())} set")
    print("[K5 stencil_mma] bit-identical run to run | " + " | ".join(parts), flush=True)
    del x_big

    # ---- 7c. fused_geneo_conv_mxu: K5 forward, the shared f32 backward -----------
    # The gradients are held against the plain backward of the kernel's own
    # output. Against fused_geneo_conv they are only printed: where the conv is
    # within the forward's rounding of 0, relu's gate opens in one and not in
    # the other, and that voxel's whole cotangent differs.
    parts = []
    for ks in ((9, 5, 5), (9, 6, 6)):
        k0 = SceneNet.create(kernel_size=ks, seed=0).combined_kernel().detach().to(dev)
        xa, ka = x16.clone().requires_grad_(), k0.clone().requires_grad_()
        out_a = cuda_conv.fused_geneo_conv_mxu(xa, ka)
        (out_a * w16).sum().backward()
        xb, kb = x16.clone().requires_grad_(), k0.clone().requires_grad_()
        out_b = cuda_conv.fused_geneo_conv(xb, kb)
        (out_b * w16).sum().backward()
        out_a, out_b = out_a.detach(), out_b.detach()
        act = w16 * torch.where(out_a > 0, 1.0 - out_a * out_a, torch.zeros_like(out_a))
        dk_ref = cuda_conv.stencil_dk_plain(x16, act, ks)
        dx_ref = cuda_conv._conv_transpose_same(act, k0)
        torch.cuda.synchronize()
        fwd_err = float((out_a - out_b).abs().max())
        dk_err = float((ka.grad - dk_ref).abs().max())
        dk_scale = float(dk_ref.abs().max())
        dx_err = float((xa.grad - dx_ref).abs().max())
        gates = int(((out_a > 0) != (out_b > 0)).sum())
        check(fwd_err <= MXU_F32_TOL, f"fused mxu {ks}: forward off by {fwd_err:.3g}")
        check(dk_err <= DK_REL_TOL * dk_scale, f"fused mxu {ks}: dk off by {dk_err:.3g}")
        check(dx_err <= 1e-5, f"fused mxu {ks}: dx off by {dx_err:.3g}")
        parts.append(
            f"k{ks}: max|dout| vs K2 {fwd_err:.3g}; vs the plain backward of its own output "
            f"max|ddk| {dk_err:.3g} (max|dk| {dk_scale:.3g}), max|ddx| {dx_err:.3g}; vs "
            f"fused_geneo_conv max|ddk| {float((ka.grad - kb.grad).abs().max()):.3g}, max|ddx| "
            f"{float((xa.grad - xb.grad).abs().max()):.3g}, relu gates that differ {gates}")
    print("[fused_geneo_conv_mxu] tensor-core forward, shared f32 backward, B=16 64^3 | "
          + " | ".join(parts), flush=True)

    def on_card(*arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]

    def exact(label, got, want):
        """Every grid of ``got`` equal to ``want``'s; the largest difference (0)."""
        worst = 0.0
        for ch, (a, b) in enumerate(zip(got, want)):
            if b is None:
                check(a is None, f"{label}: channel {ch} should be None")
                continue
            diff = int((a != b).sum())
            check(a.dtype == b.dtype and diff == 0,
                  f"{label} channel {ch}: {diff} entries differ from the plain version")
            worst = max(worst, float((a.double() - b.double()).abs().max()))
        return worst

    # ---- 7d. K6 counts and K9 ids vs plain: exact -----------------------------
    t1p, t1m, t1l = padded_batch(np.random.default_rng(21), 1)
    hist_cases = [("B1_N131072_64^3", t1p, t1m, (t1l == TOWER) & t1m, GRID),
                  ("B16_N65536_64^3", tp, tm, tower16, GRID),
                  ("full_column_8^3", col_pts, col_mask, col_tower, (8, 8, 8))]
    k6_err, k9_err, parts = 0.0, 0.0, []
    for label, p, m, w, g in hist_cases:
        args = on_card(p, m, w)
        size = g[0] * g[1] * g[2]
        for ch in (1, 2):
            got = cuda_hist.points_bin_counts(*args, g, channels=ch)
            want = cuda_hist.points_bin_counts_plain(*args, g, ch)
            torch.cuda.synchronize()
            k6_err = max(k6_err, exact(f"K6 {label} channels={ch}", got, want))
        check(float(got[0].sum()) == m.sum() and float(got[1].sum()) == w.sum(),
              f"K6 {label}: the counts do not add up to the points")
        occ, pres = cuda_hist.points_binary(*args, g)
        cols = got[0].reshape(len(p), -1, g[1])
        check(torch.equal((cols > cols.amin(1, keepdim=True)).float().reshape(len(p), -1), occ)
              and torch.equal((got[1] > 0).float(), pres),
              f"K6 {label}: binarized counts differ from K3")
        if label.startswith("full_column"):
            c = got[0].reshape(8, 8, 8)
            check(float(c[:, :, 0].min()) == 2 and float(c[0, 0, 0]) == 3,
                  "K6 full-column case: wrong counts")
        ids = cuda_hist.flat_ids(args[0], args[1], g)
        want_ids = cuda_hist.flat_ids_plain(args[0], args[1], g)
        torch.cuda.synchronize()
        k9_err = max(k9_err, exact(f"K9 {label}", [ids], [want_ids]))
        check(bool((ids[~args[1]] == cuda_hist.invalid_id(size)).all()),
              f"K9 {label}: a masked point without the sentinel id")
        from_ids = cuda_hist.bin_counts(ids, args[1], size, args[2])
        check(torch.equal(from_ids[0], got[0]) and torch.equal(from_ids[1], got[1]),
              f"K7 over K9's ids differs from K6 on {label}")
        parts.append(f"{label}: {int((got[0] > 0).sum())} voxels hold {int(got[0].sum())} "
                     f"points, {int(got[1].sum())} tower, 0 differ")
    print(f"[K6 points_bin_counts, K9 flat_ids] exact (1 and 2 channels; ids) on all "
          f"{len(hist_cases)} inputs; K6 binarized = K3; K7 over K9's ids = K6 | "
          + " | ".join(parts), flush=True)

    # ---- 7e. K7 counts from host-exact ids vs plain, and vs the host oracle --
    pad64 = PointPadding(max_points=TRAIN_POINTS, vxg_size=GRID, compute_indices=True)
    (ip, il, im, iflat), crops64 = indexed_batch(pad64, np.random.default_rng(31), TRAIN_BATCH)
    check(bool((~im).any()) and int(np.abs(iflat[~im]).max()) == 0 and int(iflat.max()) > 0,
          "the host-exact batch should carry padded points with flat_idx 0")
    d_ip, d_il, d_im, d_iflat = on_card(ip, il, im, iflat)
    d_itow = (d_il == TOWER) & d_im
    col_ids = cuda_hist.flat_ids_plain(*on_card(col_pts, col_mask), (8, 8, 8))
    k7_cases = [("B16_N65536_64^3_host_ids", d_iflat, d_im, d_itow, 64 ** 3),
                ("full_column_8^3", col_ids, *on_card(col_mask, col_tower), 512)]
    k7_err, parts = 0.0, []
    for label, f, m, w, size in k7_cases:
        for weights in (None, w):
            got = cuda_hist.bin_counts(f, m, size, weights)
            want = cuda_hist.bin_counts_plain(f, m, size, weights)
            # the route past 2**24 points a sample: 64-bit counters, a finishing pass
            counter = cuda_hist._launch_bin_counts(f, m, size, weights, "counter")
            torch.cuda.synchronize()
            k7_err = max(k7_err, exact(f"K7 {label}", got, want),
                         exact(f"K7 counter route {label}", counter, want))
        check(float(got[0].sum()) == float(m.sum()), f"K7 {label}: a padded point was counted")
        parts.append(f"{label}: {int(got[0].sum())} points, {int(got[1].sum())} tower, 0 differ")
    fw = torch.from_numpy(np.random.default_rng(32).normal(1.0, 0.5, iflat.shape)
                          .astype(np.float32)).to(dev)
    got = cuda_hist.bin_counts(d_iflat, d_im, 64 ** 3, fw, indicator=False)
    want = cuda_hist.bin_counts_plain(d_iflat, d_im, 64 ** 3, fw, indicator=False)
    torch.cuda.synchronize()
    fw_err = float((got[1] - want[1]).abs().max())
    check(torch.equal(got[0], want[0]) and bool(
        ((got[1] - want[1]).abs() <= WEIGHTED_TOL * (1 + want[1].abs())).all()),
        f"K7 float weights: max|d| {fw_err:.3g} outside {WEIGHTED_TOL} (rel + abs)")
    hist, reg = voxelize_batch_from_indices(d_iflat, d_il == TOWER, d_im, GRID)
    dev_hist, dev_reg = voxelize_batch(d_ip, d_il, d_im, (TOWER,), GRID)
    torch.cuda.synchronize()
    o_err, moved = 0.0, 0
    for i, (xyz, lab) in enumerate(crops64):
        want_h = torch.from_numpy(voxel_np.hist_on_voxel_np(xyz, GRID)).to(dev)
        want_r = torch.from_numpy(voxel_np.reg_on_voxel_np(xyz, lab, TOWER, GRID)).to(dev)
        o_err = max(o_err, float((hist[i] - want_h).abs().max()),
                    float((reg[i] - want_r).abs().max()))
        moved += int(((dev_hist[i] - want_h).abs() > ORACLE_TOL).sum())
    check(o_err <= ORACLE_TOL, f"voxelize_batch_from_indices is {o_err:.3g} from the host oracle")
    check(moved <= 0.01 * hist.numel(), f"voxelize_batch: {moved} voxels off the host oracle")
    print(f"[K7 bin_counts] exact (1 and 2 channels, padded ids of 0 never counted; "
          f"route {cuda_hist.bin_counts_route(TRAIN_POINTS)} at N={TRAIN_POINTS}, the counter "
          f"route too) | "
          + " | ".join(parts) + f" | float weights (bf16, f32 atomics): max|d| {fw_err:.3g} "
          f"of sums up to {float(want[1].abs().max()):.3g}, counts exact | "
          f"voxelize_batch_from_indices vs hist_on_voxel_np/reg_on_voxel_np on {TRAIN_BATCH} "
          f"crops: max|d| {o_err:.3g} (limit {ORACLE_TOL}); voxelize_batch (f32 bins on the "
          f"card, K6): {moved} of {hist.numel()} density voxels differ from the oracle",
          flush=True)
    del hist, reg, dev_hist, dev_reg, want_h, want_r

    # ---- 7f. K8 counts from sorted ids vs plain, at the large grids; vs K7 ------
    def host_ids(grid, n_pad, b, seed, lo=40000, hi=70000):
        pad = PointPadding(max_points=n_pad, vxg_size=grid, compute_indices=True)
        (_, lab, m, flat), _ = indexed_batch(pad, np.random.default_rng(seed), b, lo, hi)
        f, m, lab = on_card(flat, m, lab)
        return f, m, (lab == TOWER) & m

    big_ids = host_ids(BIG_GRID, MAX_POINTS, BIG_BATCH, 41)
    huge_ids = host_ids(HUGE_GRID, MAX_POINTS, 1, 43)
    k8_cases = [("B4_N131072_128^3", *big_ids, 128 ** 3),
                ("B4_N32768_64x64x256", *host_ids(KITTI_GRID, KITTI_POINTS, 4, 42, 20000, 32000),
                 64 * 64 * 256),
                ("B1_N131072_256^3", *huge_ids, 256 ** 3),
                ("B16_N65536_64^3", d_iflat, d_im, d_itow, 64 ** 3),
                ("full_column_8^3", col_ids, *on_card(col_mask, col_tower), 512)]
    k8_err, parts = 0.0, []
    for label, f, m, w, size in k8_cases:
        for ch in (1, 2):
            got = cuda_hist.sorted_bin_counts(f, m, w if ch == 2 else None, size, channels=ch)
            want = cuda_hist.sorted_bin_counts_plain(f, m, w if ch == 2 else None, size, ch)
            torch.cuda.synchronize()
            k8_err = max(k8_err, exact(f"K8 {label} channels={ch}", got, want))
        other = cuda_hist.bin_counts(f, m, size, w)
        check(torch.equal(other[0], got[0]) and torch.equal(other[1], got[1]),
              f"K8 differs from K7 on {label}")
        parts.append(f"{label}: {int((got[0] > 0).sum())} voxels hold {int(got[0].sum())} "
                     f"points, {int(got[1].sum())} tower, 0 differ, = K7")
        del got, want, other
    # a dense cloud at 256^3 (uniform ids, one point in four bins): what K8 is for
    gen = torch.Generator(dev).manual_seed(44)
    dense_ids = (torch.randint(0, 256 ** 3, (1, DENSE_POINTS), device=dev, generator=gen,
                               dtype=torch.int32),
                 torch.ones((1, DENSE_POINTS), dtype=torch.bool, device=dev),
                 torch.rand((1, DENSE_POINTS), device=dev, generator=gen) < 0.2)
    got = cuda_hist.sorted_bin_counts(*dense_ids, 256 ** 3)
    k8_err = max(k8_err, exact("K8 dense 256^3", got,
                               cuda_hist.sorted_bin_counts_plain(*dense_ids, 256 ** 3)))
    other = cuda_hist.bin_counts(dense_ids[0], dense_ids[1], 256 ** 3, dense_ids[2])
    check(torch.equal(other[0], got[0]) and torch.equal(other[1], got[1]),
          "K8 differs from K7 on the dense 256^3 input")
    parts.append(f"B1_N{DENSE_POINTS}_256^3 uniform ids: {int((got[0] > 0).sum())} voxels hold "
                 f"{int(got[0].sum())} points, 0 differ, = K7")
    del got, other
    print(f"[K8 sorted_bin_counts] exact (1 and 2 channels) on all {len(k8_cases)} inputs, "
          "and equal to K7 on each | " + " | ".join(parts), flush=True)
    torch.cuda.empty_cache()

    # ---- 8. kernel timing ---------------------------------------------------
    times = {}
    kern = SceneNet.create(kernel_size=(9, 5, 5), seed=0).combined_kernel().detach().to(dev)
    for b in (1, 64):
        p, m, _ = padded_batch(np.random.default_rng(b), b)
        pt, mt = torch.from_numpy(p).to(dev), torch.from_numpy(m).to(dev)
        iters = 20 if b == 1 else 5
        xb = cuda_hist.points_occupancy(pt, mt, GRID).reshape(b, 1, GRID[2], GRID[0], GRID[1])
        xb_pad = F.pad(xb, same_pads(kern.shape))
        w5 = kern[None, None]

        def conv_library():  # one cuDNN call (f32, TF32 off) and the head
            return torch.relu(torch.tanh(F.conv3d(xb_pad, w5)))

        with torch.no_grad():
            times[b] = {
                "occupancy": paired_ms(lambda: cuda_hist.points_occupancy(pt, mt, GRID),
                                       lambda: cuda_hist.points_occupancy_plain(pt, mt, GRID),
                                       iters),
                "stencil (9,5,5)": paired_ms(lambda: cuda_conv.geneo_stencil_conv(xb, kern),
                                             lambda: cuda_conv.geneo_stencil_conv_plain(xb, kern),
                                             iters, library_fn=conv_library),
                "stencil_mma (9,5,5)": paired_ms(
                    lambda: cuda_conv.geneo_stencil_conv_mxu(xb, kern),
                    lambda: cuda_conv.geneo_stencil_conv_mxu_plain(xb, kern),
                    iters, library_fn=conv_library)}
        del pt, mt, xb, xb_pad
        torch.cuda.empty_cache()
    for b, t in times.items():
        print(f"[timing] B={b} 64^3 N={MAX_POINTS} ({smi}), median of 4 alternating rounds "
              "[min-max] ms; library = F.conv3d on the padded grid, tanh, relu (cuDNN f32, "
              "TF32 off): " + fmt_times(t) + " | stencil's bound (f32 FMA pipe) "
              f"{bound_ms(8.0 * b * 64 ** 3, 2.0 * 225 * b * 64 ** 3)[0]:.4f} ms, through its "
              f"{cuda_conv.stencil_route((9, 5, 5))} kernel", flush=True)
    train_times = {}
    for b in (1, TRAIN_BATCH):
        p, m, lab = padded_batch(np.random.default_rng(100 + b), b, n_pad=TRAIN_POINTS)
        args = [torch.from_numpy(a).to(dev) for a in (p, m, (lab == TOWER) & m)]
        xb = cuda_hist.points_binary(*args, GRID)[0].reshape(b, 1, GRID[2], GRID[0], GRID[1])
        gb = torch.from_numpy(np.random.default_rng(b).normal(
            0, 1, tuple(xb.shape)).astype(np.float32)).to(dev)
        iters = 20 if b == 1 else 5
        xb_pad = F.pad(xb, same_pads((9, 5, 5)))
        train_times[b] = {
            "points_binary": paired_ms(lambda: cuda_hist.points_binary(*args, GRID),
                                       lambda: cuda_hist.points_binary_plain(*args, GRID),
                                       iters),
            "stencil_dk (9,5,5)": paired_ms(
                lambda: cuda_conv.stencil_dk(xb, gb, (9, 5, 5)),
                lambda: cuda_conv.stencil_dk_plain(xb, gb, (9, 5, 5)), iters,
                library_fn=lambda: torch.nn.grad.conv3d_weight(xb_pad, (1, 1, 9, 5, 5), gb))}
        del args, xb, gb, xb_pad
        torch.cuda.empty_cache()
    for b, t in train_times.items():
        print(f"[timing] B={b} 64^3 N={TRAIN_POINTS} ({smi}), median of 4 alternating "
              "rounds [min-max] ms; library = torch.nn.grad.conv3d_weight on the padded "
              "grid (cuDNN f32, TF32 off): " + fmt_times(t), flush=True)
    # at small batch the loops above time the host's launch rate: the device
    # time of a call, captured in a CUDA graph and replayed, median of 3
    p1, m1, _ = padded_batch(np.random.default_rng(1), 1)
    p1, m1 = torch.from_numpy(p1).to(dev), torch.from_numpy(m1).to(dev)
    x1 = cuda_hist.points_occupancy(p1, m1, GRID).reshape(1, 1, GRID[2], GRID[0], GRID[1])
    g1 = torch.from_numpy(np.random.default_rng(1).normal(
        0, 1, tuple(x1.shape)).astype(np.float32)).to(dev)
    p16, m16, l16 = padded_batch(np.random.default_rng(100 + TRAIN_BATCH), TRAIN_BATCH,
                                 n_pad=TRAIN_POINTS)
    k3_args = on_card(p16, m16, (l16 == TOWER) & m16)
    p64, m64, _ = padded_batch(np.random.default_rng(64), 64)
    x64 = cuda_hist.points_occupancy(*on_card(p64, m64), GRID).reshape(64, 1, GRID[2], GRID[0],
                                                                     GRID[1])
    big_f, big_m, big_w = big_ids
    graph_fns = {
        "points_occupancy B=1": lambda: cuda_hist.points_occupancy(p1, m1, GRID),
        "stencil_dk (9,5,5) B=1": lambda: cuda_conv.stencil_dk(x1, g1, (9, 5, 5)),
        "stencil_mma (9,5,5) B=1": lambda: cuda_conv.geneo_stencil_conv_mxu(x1, kern),
        "stencil_mma (9,5,5) B=64": lambda: cuda_conv.geneo_stencil_conv_mxu(x64, kern),
        f"points_binary B={TRAIN_BATCH}": lambda: cuda_hist.points_binary(*k3_args, GRID),
        f"bin_counts B={TRAIN_BATCH} 2ch": lambda: cuda_hist.bin_counts(
            d_iflat, d_im, 64 ** 3, d_itow),
        f"sorted_bin_counts B={TRAIN_BATCH} 2ch (beside K7)": lambda: cuda_hist.sorted_bin_counts(
            d_iflat, d_im, d_itow, 64 ** 3),
        f"sorted_bin_counts B={BIG_BATCH} 128^3": lambda: cuda_hist.sorted_bin_counts(
            big_f, big_m, big_w, 128 ** 3)}
    with torch.no_grad():
        graph_times = {k: float(np.median([graph_ms(fn) for _ in range(3)]))
                       for k, fn in graph_fns.items()}
    print(f"[timing] 64^3, K8 at 128^3 ({smi}), device ms a call inside a CUDA graph: "
          + ", ".join(f"{k} {v:.4f}" for k, v in graph_times.items()), flush=True)
    del p1, m1, x1, g1, k3_args, graph_fns, p64, m64, x64

    def bincount_library(f, m, w, size):
        """One torch.bincount per channel over b·size + flat (points that do not
        count go to one bin past the end); the ids are made outside the timing."""
        b = f.shape[0]
        offs = torch.arange(b, device=dev)[:, None] * size
        keep = m & (f >= 0) & (f < size)
        ids = [torch.where(k, f.long() + offs, b * size).reshape(-1) for k in (keep, keep & w)]
        return lambda: [torch.bincount(i, minlength=b * size + 1) for i in ids]

    tower16_d = on_card(tower16)[0]
    tp_d, tm_d = on_card(tp, tm)
    hist_times = {
        "points_bin_counts": paired_ms(
            lambda: cuda_hist.points_bin_counts(tp_d, tm_d, tower16_d, GRID),
            lambda: cuda_hist.points_bin_counts_plain(tp_d, tm_d, tower16_d, GRID), 5),
        "flat_ids": paired_ms(lambda: cuda_hist.flat_ids(tp_d, tm_d, GRID),
                              lambda: cuda_hist.flat_ids_plain(tp_d, tm_d, GRID), 5),
        "bin_counts": paired_ms(
            lambda: cuda_hist.bin_counts(d_iflat, d_im, 64 ** 3, d_itow),
            lambda: cuda_hist.bin_counts_plain(d_iflat, d_im, 64 ** 3, d_itow), 5,
            library_fn=bincount_library(d_iflat, d_im, d_itow, 64 ** 3)),
    }
    print(f"[timing] B={TRAIN_BATCH} 64^3 N={TRAIN_POINTS}, two channels ({smi}), median of "
          "4 alternating rounds [min-max] ms; library = one torch.bincount a channel: "
          + fmt_times(hist_times), flush=True)
    big_times = {
        "sorted_bin_counts": paired_ms(
            lambda: cuda_hist.sorted_bin_counts(big_f, big_m, big_w, 128 ** 3),
            lambda: cuda_hist.sorted_bin_counts_plain(big_f, big_m, big_w, 128 ** 3), 5,
            library_fn=bincount_library(big_f, big_m, big_w, 128 ** 3)),
        "bin_counts at 128^3": paired_ms(
            lambda: cuda_hist.bin_counts(big_f, big_m, 128 ** 3, big_w),
            lambda: cuda_hist.bin_counts_plain(big_f, big_m, 128 ** 3, big_w), 5)}

    # the two id kernels in turns, at three sizes: "plain" is K7 here
    versus = {f"sorted_bin_counts vs bin_counts {label}": paired_ms(
        lambda: cuda_hist.sorted_bin_counts(f, m, w, size),
        lambda: cuda_hist.bin_counts(f, m, size, w), 5)
        for label, f, m, w, size in (("B4 N131072 128^3", big_f, big_m, big_w, 128 ** 3),
                                     ("B16 N65536 64^3", d_iflat, d_im, d_itow, 64 ** 3),
                                     ("B1 N131072 256^3", *huge_ids, 256 ** 3),
                                     (f"B1 N{DENSE_POINTS} 256^3 uniform ids", *dense_ids,
                                      256 ** 3))}
    slower = [k for k, v in versus.items() if "128^3" in k or "256^3" in k
              if v["ms"] > v["plain_ms"]]
    print(f"[timing] B={BIG_BATCH} 128^3 N={MAX_POINTS}, two channels ({smi}), median of 4 "
          "alternating rounds [min-max] ms; library = one torch.bincount a channel: "
          + fmt_times(big_times) + " | K8 ('kernel') against K7 ('plain') in turns: "
          + fmt_times(versus) + f" | K8 slower than K7 at: {slower or 'none'}", flush=True)
    del tp_d, tm_d, tower16_d, big_ids, huge_ids, dense_ids, big_f, big_m, big_w
    torch.cuda.empty_cache()

    # ---- 8b. K10 multi-channel conv vs plain: every UNet layer shape -----------
    def mc_case(seed, b, cin, cout, shape, last=False):
        """x ~ U(0, 1) and weights of variance 1/(27 C_in): outputs of magnitude ~1."""
        gen = torch.Generator(dev).manual_seed(seed)
        xs = (b, *shape, cin) if last else (b, cin, *shape)
        xm = torch.rand(xs, device=dev, generator=gen)
        wm = torch.randn((cout, cin, 3, 3, 3), device=dev, generator=gen) / math.sqrt(27 * cin)
        return xm, wm

    def mc_check(label, xm, wm, last=False):
        """The kernel against cuDNN f32 and against itself: the largest
        difference; two runs on the same inputs must give the same bits."""
        got = cuda_conv_mc.conv3d_mc_same(xm, wm, channels_last=last)
        again = cuda_conv_mc.conv3d_mc_same(xm, wm, channels_last=last)
        want = cuda_conv_mc.conv3d_mc_same_plain(xm, wm, channels_last=last)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        atol = MC_ATOL * max(1.0, math.sqrt(wm.shape[1] / MC_ATOL_CHANNELS))
        check(bool(torch.isfinite(got).all()) and got.shape == want.shape,
              f"K10 {label}: non-finite or misshapen output")
        check(bool(((got - want).abs() <= atol + MC_RTOL * want.abs()).all()),
              f"K10 {label}: max|d| {err:.3g} outside {atol:.3g} + {MC_RTOL} relative")
        check(torch.equal(got, again), f"K10 {label}: two runs on the same inputs differ")
        return err

    def mc_plan(b, cin, cout, shape, last=False):
        tile, k_splits = cuda_conv_mc.conv3d_mc_plan(b, cin, cout, *shape, channels_last=last)
        if tile == cuda_conv_mc.FMA_TILE:
            return "FMA kernel"
        (tb, *vox), bn = cuda_conv_mc.TC_TILES[tile]
        return (f"{tb}x" if tb > 1 else "") + "x".join(map(str, vox)) + f"x{bn}ch" \
            + (f" K/{k_splits}" if k_splits > 1 else "")

    mc_shapes = list(dict.fromkeys(UNET_CONVS))  # the 16 distinct layer shapes
    net_shapes = []
    for blk in (getattr(UNet3D(), n) for n in BLOCKS):
        net_shapes += [tuple(blk.conv0.shape[1::-1]), tuple(blk.conv1.shape[1::-1])]
    check(net_shapes == [c[:2] for c in UNET_CONVS], f"UNet3D's convs are {net_shapes}")
    k10_err, parts = 0.0, []
    for cin, cout, n in mc_shapes:
        xm, wm = mc_case(cin + cout + n, TRAIN_BATCH, cin, cout, (n, n, n))
        err = mc_check(f"{cin}->{cout} {n}^3", xm, wm)
        k10_err = max(k10_err, err)
        parts.append(f"{cin}->{cout} {n}^3 {err:.3g}")
        del xm, wm
    extra_parts, seen_tiles, seen_splits = [], set(), set()
    for b, cin, cout, shape in MC_EXTRA:
        err = mc_check(f"B={b} {cin}->{cout} {shape}", *mc_case(b + cin, b, cin, cout, shape))
        k10_err = max(k10_err, err)
        extra_parts.append(f"B={b} {cin}->{cout} {shape} [{mc_plan(b, cin, cout, shape)}] "
                           f"{err:.3g}")
    for b, cin, cout, shape in MC_EXTRA + [(TRAIN_BATCH, c, o, (n, n, n)) for c, o, n in mc_shapes]:
        tile, k_splits = cuda_conv_mc.conv3d_mc_plan(b, cin, cout, *shape)
        seen_tiles.add(tile)
        seen_splits.add(k_splits)
        check(k_splits <= cuda_conv_mc.conv3d_mc_split_cap(tile, cin), "K10: a plan past its cap")
    check(seen_tiles == {cuda_conv_mc.FMA_TILE, *cuda_conv_mc.TC_TILES}
          and cuda_conv_mc.MAX_K_SPLITS in seen_splits and 1 in seen_splits,
          f"K10: the checks reach tiles {seen_tiles} and K splits {seen_splits} only")
    xl, wl = mc_case(2, 2, 24, 16, (10, 10, 10), last=True)
    last = mc_check("channels-last 24->16 10^3", xl, wl, last=True)
    k10_err = max(k10_err, last)
    # fused_conv3d_mc: dx (the kernel on the flipped, swapped weights) and dw (the
    # library call) against autograd through the plain version
    grad_parts = []
    for cin, cout, n in ((64, 32, 32), (256, 128, 8)):
        xm, wm = mc_case(3, 4, cin, cout, (n, n, n))
        gm = torch.randn((4, cout, n, n, n), device=dev,
                         generator=torch.Generator(dev).manual_seed(4))
        xa, wa = xm.clone().requires_grad_(), wm.clone().requires_grad_()
        before = cuda_conv_mc.MC_LAUNCHES.count
        (cuda_conv_mc.fused_conv3d_mc(xa, wa) * gm).sum().backward()
        check(cuda_conv_mc.MC_LAUNCHES.count == before + 2, "fused_conv3d_mc: forward + dx")
        xb, wb = xm.clone().requires_grad_(), wm.clone().requires_grad_()
        (cuda_conv_mc.conv3d_mc_same_plain(xb, wb) * gm).sum().backward()
        wc = wm.clone().requires_grad_()
        before = cuda_conv_mc.MC_LAUNCHES.count
        (cuda_conv_mc.fused_conv3d_mc(xm, wc) * gm).sum().backward()
        check(cuda_conv_mc.MC_LAUNCHES.count == before + 1,
              "fused_conv3d_mc launched dx for an input that needs no gradient")
        torch.cuda.synchronize()
        dx_err = float((xa.grad - xb.grad).abs().max())
        dw_err, dw_scale = float((wa.grad - wb.grad).abs().max()), float(wb.grad.abs().max())
        dx_atol = MC_ATOL * max(1.0, math.sqrt(cout / MC_ATOL_CHANNELS))
        check(bool(((xa.grad - xb.grad).abs() <= dx_atol + MC_RTOL * xb.grad.abs()).all()),
              f"fused_conv3d_mc {cin}->{cout}: dx off by {dx_err:.3g}")
        check(dw_err <= MC_DW_REL_TOL * dw_scale,
              f"fused_conv3d_mc {cin}->{cout}: dw off by {dw_err:.3g} of {dw_scale:.3g}")
        grad_parts.append(f"{cin}->{cout} {n}^3: max|ddx| {dx_err:.3g}, max|ddw| {dw_err:.3g} "
                          f"(max|dw| {dw_scale:.3g})")
        del xm, wm, gm, xa, wa, xb, wb, wc
    print(f"[K10 conv3d_mc] B={TRAIN_BATCH}, max|d| vs F.conv3d (cuDNN f32, TF32 off), limit "
          f"{MC_ATOL} (x sqrt(C_in/{MC_ATOL_CHANNELS}) past {MC_ATOL_CHANNELS} channels) + "
          f"{MC_RTOL} relative; every case run twice, bit-identical | " + ", ".join(parts)
          + " | the other shapes the plan separates [tile, K split]: " + ", ".join(extra_parts)
          + f" | channels-last 24->16 10^3 [FMA kernel] {last:.3g} | "
          "fused_conv3d_mc grads vs autograd of the plain version: " + "; ".join(grad_parts),
          flush=True)
    torch.cuda.empty_cache()

    # K10 times at the batch the path runs; library = plain = one F.conv3d (timed apart)
    mc_times, mc_bounds, mc_x3_bounds, mc_fma_bounds = {}, {}, {}, {}
    with torch.no_grad():
        for cin, cout, n in mc_shapes:
            xm, wm = mc_case(cin + cout + n, TRAIN_BATCH, cin, cout, (n, n, n))
            mc_times[cin, cout, n] = paired_ms(
                lambda: cuda_conv_mc.conv3d_mc_same(xm, wm),
                lambda: cuda_conv_mc.conv3d_mc_same_plain(xm, wm), iters=3,
                library_fn=lambda: F.conv3d(xm, wm, padding=1), warmup=1)
            vox = TRAIN_BATCH * n ** 3
            moved, flops = 4.0 * (vox * (cin + cout) + 27 * cin * cout), 2.0 * 27 * cin * cout * vox
            # the cheapest arithmetic found that holds the f32 tolerance: for each f32
            # product one TF32 product and two bf16 ones (the cross terms), which
            # take the tensor cores as long as two TF32 products
            mc_bounds[cin, cout, n] = bound_ms(
                moved, flops * (1 + 2 * TF32_FLOPS / BF16_FLOPS), TF32_FLOPS)
            mc_x3_bounds[cin, cout, n] = bound_ms(moved, 3 * flops, TF32_FLOPS)  # as 3xTF32
            mc_fma_bounds[cin, cout, n] = bound_ms(moved, flops, F32_FLOPS)  # the f32 FMA pipe
            del xm, wm
            torch.cuda.empty_cache()
    # the library's dw as the port calls it (cuDNN off) and through cuDNN
    dw_ms = {}
    for cin, cout, n in ((1, 32, 64), (32, 32, 64), (512, 256, 8)):
        xm, _ = mc_case(5, TRAIN_BATCH, cin, cout, (n, n, n))
        gm = torch.randn((TRAIN_BATCH, cout, n, n, n), device=dev)
        dw_ms[cin, cout, n] = (
            cuda_ms(lambda: cuda_conv_mc.conv3d_mc_weight_grad(xm, gm), 3, 1),
            cuda_ms(lambda: torch.nn.grad.conv3d_weight(xm, (cout, cin, 3, 3, 3), gm,
                                                        padding=1), 3, 1))
        del xm, gm
        torch.cuda.empty_cache()
    mc_sums = {k: sum(mc_times[c][k] for c in UNET_CONVS) for k in ("ms", "plain_ms", "library_ms")}
    mc_bound_sum = sum(mc_bounds[c][0] for c in UNET_CONVS)
    mc_fma_bound_sum = sum(mc_fma_bounds[c][0] for c in UNET_CONVS)
    mc_x3_bound_sum = sum(mc_x3_bounds[c][0] for c in UNET_CONVS)
    worst = max(mc_times, key=lambda c: mc_times[c]["ms"] / mc_times[c]["library_ms"])
    worst_ratio = mc_times[worst]["ms"] / mc_times[worst]["library_ms"]
    check(mc_sums["ms"] < mc_sums["library_ms"],
          f"K10: the 18 convs take {mc_sums['ms']:.4f} ms, cuDNN f32 {mc_sums['library_ms']:.4f}")
    check(worst_ratio <= 1.1, f"K10 {worst}: {worst_ratio:.2f}x cuDNN's time")
    for c, t in mc_times.items():
        check(t["ms"] >= mc_bounds[c][0], f"K10 {c}: {t['ms']:.4f} ms is under its bound")
    print(f"[timing] K10 conv3d_mc B={TRAIN_BATCH} ({smi}), median of 4 alternating rounds, ms "
          "kernel / plain / library (one F.conv3d, cuDNN f32, TF32 off) / bound (one TF32 and "
          "two bf16 products an f32 product at 495 and 989 TFLOP/s, or the bytes) [the plan's "
          "tile, K split]: "
          + " | ".join(f"{c}->{o} {n}^3 {t['ms']:.4f} / {t['plain_ms']:.4f} / "
                       f"{t['library_ms']:.4f} / {mc_bounds[c, o, n][0]:.4f} "
                       f"({mc_bounds[c, o, n][1]}) [{mc_plan(TRAIN_BATCH, c, o, (n, n, n))}]"
                       for (c, o, n), t in mc_times.items())
          + f" | the UNet's 18 forward convs: kernel {mc_sums['ms']:.4f}, plain "
          f"{mc_sums['plain_ms']:.4f}, cuDNN {mc_sums['library_ms']:.4f}, bound "
          f"{mc_bound_sum:.4f} ({mc_bound_sum / mc_sums['ms']:.1%} of it reached), the bound "
          f"as 3xTF32 {mc_x3_bound_sum:.4f}, the f32 FMA pipe's bound {mc_fma_bound_sum:.4f}; "
          f"slowest against cuDNN {worst[0]}->{worst[1]} "
          f"{worst[2]}^3 at {worst_ratio:.2f}x"
          + " | the library's dw (torch.nn.grad.conv3d_weight, full f32), ms with cuDNN off "
          "(as fused_conv3d_mc calls it) / through cuDNN: "
          + ", ".join(f"{c}->{o} {n}^3 {a:.4f} / {b:.4f}" for (c, o, n), (a, b) in dw_ms.items()),
          flush=True)

    # ---- 9. main path: serve ------------------------------------------------
    gpu = _Pipeline(None)  # serving defaults: 64³, 131072 points, (9,5,5), card
    check(gpu.device.type == "cuda" and gpu.backend == "cuda", "pipeline not on the card")
    cpu = _Pipeline(None, device="cpu")
    srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(gpu))
    requests = [synthetic_cloud(np.random.default_rng(100 + i), n)
                for i, n in enumerate((41000, 52000, 63000, 69000, 131072 + 5000))]

    def check_reply(out, pts, ref, tol, what, grid=(64, 64, 64)):
        """Shapes, range, and agreement with a reference (voxel_pred,
        point_probs); returns the largest difference."""
        n = min(len(pts), MAX_POINTS)
        probs, vox, msk = out["point_probs"], out["voxel_pred"], out["mask"]
        check(probs.shape == (n,) and vox.shape[-3:] == grid and msk.shape == (n,),
              f"{what}: reply shapes {probs.shape} {vox.shape} {msk.shape}")
        for a in (probs, vox):
            check(bool(np.isfinite(a).all()) and a.min() >= 0 and a.max() <= 1,
                  f"{what}: reply not finite in [0, 1]")
        ref_vox, ref_probs = ref
        err = max(float(np.abs(probs - ref_probs).max()), float(np.abs(vox - ref_vox).max()))
        flips = (msk != (ref_probs >= TAU)) & (np.abs(ref_probs - TAU) > tol)
        check(err <= tol, f"{what}: reply differs from the CPU pipeline by {err:.3g}")
        check(not flips.any(), f"{what}: {int(flips.sum())} mask flips outside the band")
        return err

    with running(srv, gpu) as url:
        reset_counts()
        lat, worst = [], 0.0
        for pts in requests:
            status, out, wall_ms, server_ms = post(f"{url}/predict", pts, TAU)
            check(status == 200, f"/predict returned {status}")
            worst = max(worst, check_reply(out, pts, cpu.predict(pts), PROB_TOL, "serve"))
            lat.append((wall_ms, server_ms))
        serve_counts = read_counts()
        health = healthz(url)
    for k in ("points_occupancy", "stencil_conv"):
        check(serve_counts[k] >= len(requests),
              f"{k} launched {serve_counts[k]} times for {len(requests)} requests")
    served = {k: serve_counts[k] for k in ("points_occupancy", "sorted_bin_counts",
                                           "stencil_conv", "stencil_mma")}
    check(health["kernel_launches"] == served, f"/healthz counts {health['kernel_launches']}")
    print(f"[serve] {len(requests)} requests match the CPU pipeline (max|d| {worst:.3g}) | "
          "latency ms wall/server: " + ", ".join(f"{w:.2f}/{s:.2f}" for w, s in lat)
          + f" | launches {serve_counts} | healthz device {health['device']}", flush=True)
    del gpu, cpu
    torch.cuda.empty_cache()

    # ---- 9b. main path: the batched pipeline, inference="mxu", fused tau-mask ----
    HEAD_B = 64
    hp, hm, _ = padded_batch(np.random.default_rng(64), HEAD_B)
    hpt, hmt = torch.from_numpy(hp).to(dev), torch.from_numpy(hm).to(dev)
    net = SceneNet.create(kernel_size=(9, 5, 5), seed=0, backend="cuda").to(dev).eval()

    def route(inference):
        with torch.inference_mode():
            xg = voxelize_batch_occupancy(hpt, hmt, GRID)[:, None]
            return net(xg, inference=inference, tau=TAU)

    reset_counts()
    mask_mxu = route("mxu")
    torch.cuda.synchronize()
    headline_counts = read_counts()
    check((headline_counts["points_occupancy"], headline_counts["stencil_mma"],
           headline_counts["stencil_conv"]) == (1, 1, 0),
          f"headline pipeline launched {headline_counts}")
    mask_f32 = route(True)
    with torch.inference_mode():
        probs_f32 = net(voxelize_batch_occupancy(hpt, hmt, GRID)[:, None], inference=True)
    check(tuple(mask_mxu.shape) == (HEAD_B, 1, 64, 64, 64)
          and bool(((mask_mxu == 0) | (mask_mxu == 1)).all()), "headline mask not {0,1}")
    flips = mask_mxu != mask_f32
    bad = int((flips & ((probs_f32 - TAU).abs() > MXU_F32_TOL)).sum())
    check(bad == 0, f"headline: {bad} mask flips outside the {MXU_F32_TOL} band of tau")
    check(0 < int(mask_mxu.sum()) < mask_mxu.numel(), "headline mask is trivial")
    head_t = paired_ms(lambda: route("mxu"), lambda: route(True), iters=5)
    print(f"[headline] B={HEAD_B} N={MAX_POINTS} 64^3 (9,5,5): points -> K1 occupancy -> "
          f"SceneNet(backend='cuda')(x, inference='mxu', tau={TAU}) | launches per call "
          f"{headline_counts} | mask: {int(mask_mxu.sum())} set of {mask_mxu.numel()}, "
          f"{int(flips.sum())} differ from the f32 route (outside the {MXU_F32_TOL} band: "
          f"{bad}) | ({smi}) median of 4 alternating rounds [min-max]: mxu route "
          f"{head_t['ms']:.4f} ms [{head_t['range'][0]:.4f}-{head_t['range'][1]:.4f}] = "
          f"{HEAD_B / head_t['ms'] * 1e3:.0f} grids/s; f32 route (inference=True, then >= tau) "
          f"{head_t['plain_ms']:.4f} ms [{head_t['plain_range'][0]:.4f}-"
          f"{head_t['plain_range'][1]:.4f}] = {HEAD_B / head_t['plain_ms'] * 1e3:.0f} grids/s",
          flush=True)
    del hpt, hmt, mask_mxu, mask_f32, probs_f32, flips
    torch.cuda.empty_cache()

    # ---- 9c. main path: batched serving, --inference mxu --max-batch 8 ----------
    clouds = [synthetic_cloud(np.random.default_rng(200 + i), 40000 + 1900 * i)
              for i in range(16)]
    cpu_mxu = _Pipeline(None, inference="mxu", device="cpu")
    refs = [cpu_mxu.predict(c) for c in clouds]
    del cpu_mxu
    server, batched = build_server(["--inference", "mxu", "--max-batch", "8", "--port", "0"])
    check(batched.device.type == "cuda" and batched._batcher.max_batch == 8,
          "batched server not on the card at max batch 8")
    with running(server, batched) as url:
        reset_counts()
        replies, wall = post_concurrently(f"{url}/predict", clouds, TAU)
        batched_counts = read_counts()
        health = healthz(url)
        worst = max(check_reply(out, c, ref, MXU_TOL, "batched serve")
                    for (_, out, _, _), c, ref in zip(replies, clouds, refs))
        stats = health["batching"]
        check(stats["requests"] == 16 and stats["failed_dispatches"] == 0, f"batching {stats}")
        check(stats["dispatches"] < stats["requests"] and stats["max_batch_seen"] > 1,
              f"requests did not coalesce: {stats}")
        check(batched_counts["stencil_mma"] == batched_counts["points_occupancy"]
              == stats["dispatches"] and batched_counts["stencil_conv"] == 0,
              f"batched serving launched {batched_counts} in {stats['dispatches']} dispatches")
        check(health["kernel_launches"]["stencil_mma"] >= batched_counts["stencil_mma"],
              f"/healthz counts {health['kernel_launches']}")
        line = (f"[serve batched] --inference mxu --max-batch 8: 16 concurrent requests match "
                f"the CPU pipeline with inference='mxu' (max|d| {worst:.3g}) in "
                f"{wall * 1e3:.1f} ms | batching {stats} | launches {batched_counts} | "
                "server ms: " + ", ".join(f"{r[3]:.1f}" for r in replies))
        if opts.profile:
            before = healthz(url)["batching"]["dispatches"]
            prof_wall, busy_us, n_items, largest, _ = profiled(
                lambda: post_concurrently(f"{url}/predict", clouds, TAU))
            n_disp = healthz(url)["batching"]["dispatches"] - before
            line += (f" | [profile] 16 requests in {n_disp} dispatches, {prof_wall * 1e3:.1f} ms "
                     f"wall, device busy {busy_us / 1e3:.3f} ms = idle share "
                     f"{1 - busy_us / 1e6 / prof_wall:.4f}, {n_items} device items = "
                     f"{n_items / n_disp:.1f} per dispatch; largest: " + largest)
    print(line, flush=True)
    del batched
    torch.cuda.empty_cache()

    # ---- 9d. --max-batch auto, and --model quantile -----------------------------
    server, auto = build_server(["--inference", "mxu", "--max-batch", "auto", "--port", "0"])
    with running(server, auto) as url:
        replies, wall = post_concurrently(f"{url}/predict", clouds, TAU)
        worst = max(check_reply(out, c, ref, MXU_TOL, "adaptive serve")
                    for (_, out, _, _), c, ref in zip(replies, clouds, refs))
        stats = healthz(url)["batching"]
        check(stats["requests"] == 16 and stats["failed_dispatches"] == 0
              and stats["mode"] == "adaptive" and stats["max_batch"] == 32, f"batching {stats}")
    print(f"[serve auto] --inference mxu --max-batch auto: 16 concurrent requests match the "
          f"CPU pipeline (max|d| {worst:.3g}) in {wall * 1e3:.1f} ms | batching {stats}",
          flush=True)
    del auto
    torch.cuda.empty_cache()

    server, quant = build_server(["--model", "quantile", "--port", "0"])
    cpu_q = _Pipeline(None, model="quantile", device="cpu")
    with running(server, quant) as url:
        status, out, wall_ms, _ = post(f"{url}/predict", clouds[0], TAU)
        info = healthz(url)
    n = len(clouds[0])
    ref_vox, ref_probs = cpu_q.predict(clouds[0])
    check(status == 200 and info["model"] == "quantile" and info["quantiles"] == [0.1, 0.5, 0.9],
          f"quantile server: {status} {info}")
    check(out["point_quantiles"].shape == (3, n) and out["uncertainty"].shape == (n,)
          and out["voxel_pred"].shape == (3, 64, 64, 64) and out["point_probs"].shape == (n,),
          "quantile reply shapes")
    q_err = max(float(np.abs(out["point_quantiles"] - ref_probs).max()),
                float(np.abs(out["voxel_pred"] - ref_vox).max()))
    check(q_err <= PROB_TOL, f"quantile reply differs from the CPU pipeline by {q_err:.3g}")
    check(bool((out["uncertainty"] >= 0).all())
          and np.array_equal(out["point_probs"], out["point_quantiles"][1]),
          "quantile reply: uncertainty or median member wrong")
    print(f"[serve quantile] --model quantile: point_quantiles {out['point_quantiles'].shape}, "
          f"uncertainty max {float(out['uncertainty'].max()):.4f}, matches the CPU pipeline "
          f"(max|d| {q_err:.3g}), {wall_ms:.1f} ms", flush=True)
    del quant, cpu_q
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="snt_chip_smoke_") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        write_dataset(tmp / "ts40k")
        data_s = time.perf_counter() - t0

        # ---- 10. main path: the train CLI at the defaults' width ------------
        out_dir = tmp / "out"
        ckpt_dir = out_dir / "ckpt"
        argv = ["--set", *DEFAULTS_SET, "--set", f"data_path={tmp / 'ts40k'}",
                f"max_epochs={TRAIN_EPOCHS}", "device_cache=False", "num_workers=4",
                f"output_dir={out_dir}", f"checkpoint_dir={ckpt_dir}"]
        n_train = N_FIT - int(N_FIT * 0.1)
        steps = TRAIN_EPOCHS * (n_train // TRAIN_BATCH)
        reset_counts()
        t0 = time.perf_counter()
        scores = train_cli.main(argv)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        train_counts = read_counts()
        losses = {k: v for k, v in scores.items() if k.endswith("loss")}
        check(set(losses) == {"train_loss", "val_loss", "test_loss"}, f"losses {losses}")
        check(all(math.isfinite(v) for v in losses.values()), f"non-finite loss {losses}")
        check(all(f"test_{m}" in scores for m in metrics.METRIC_NAMES), "test scores missing")
        check((ckpt_dir / "last.npz").exists(), "no last.npz")
        topk = sorted(f.name for f in ckpt_dir.glob("train_loss_step*.npz"))
        check(len(topk) >= 1, "no top-k checkpoint")
        trained = restore_checkpoint(str(ckpt_dir / "last.npz"),
                                     SceneNet.create(kernel_size=(9, 5, 5), seed=0))
        init = SceneNet.create(kernel_size=(9, 5, 5), seed=0)
        moved = {n for (n, a), b in zip(trained.state_dict().items(),
                                        init.state_dict().values()) if not torch.equal(a, b)}
        frozen = {n for n, p in init.named_parameters() if not p.requires_grad}
        # a scalar whose gradient underflows at this draw (an arrow cone
        # much thinner than a voxel) may stay put; frozen ones must
        check(not moved & frozen and len(moved) >= init.num_trainable_params() // 2,
              f"moved {sorted(moved)}, frozen {sorted(frozen)}")
        for k in ("points_binary", "stencil_conv", "stencil_dk"):
            check(train_counts[k] >= steps, f"{k} launched {train_counts[k]} times in "
                                            f"{steps} train steps")
        check(train_counts["stencil_dk"] == steps,
              f"stencil_dk launched {train_counts['stencil_dk']} times, {steps} steps")
        print(f"[train] train CLI, defaults width (B={TRAIN_BATCH}, 64^3, {TRAIN_POINTS} "
              f"points, (9,5,5), geneo_tversky), {N_FIT}+{N_TEST} synthetic crops "
              f"(written in {data_s:.1f} s), {TRAIN_EPOCHS} epochs = {steps} steps in "
              f"{train_s:.1f} s | losses " + ", ".join(f"{k} {v:.6f}" for k, v in
                                                       sorted(losses.items()))
              + f" | test_F1Score {scores['test_F1Score']:.4f} | {len(moved)} of "
              f"{init.num_trainable_params()} trainable parameters moved | checkpoints "
              f"last.npz + {topk} | launches {train_counts}", flush=True)

        # ---- 11. train parity: cuda backend vs plain backend ---------------
        ds = TS40K(str(tmp / "ts40k"), "fit", transform=PointPadding(max_points=TRAIN_POINTS))
        loader = PointCloudLoader(ds, TRAIN_BATCH, shuffle=True, num_workers=4, seed=0,
                                  drop_last=True)
        batches = list(loader)[:3]
        crit = resolve_criterion("geneo_tversky")(**load_config(
            None, train_cli.parse_overrides(DEFAULTS_SET)).criterion_params())
        prep = make_device_voxelize_prep(GRID, (TOWER,))
        trainers = {}
        for backend in ("cuda", "torch"):
            net = SceneNet.create(kernel_size=(9, 5, 5), seed=0, backend=backend).to(dev)
            trainers[backend] = Trainer(net, crit, TrainConfig(
                run_dir=str(tmp / f"parity_{backend}"),
                checkpoint_dir=str(tmp / f"parity_ckpt_{backend}")), batch_prep=prep)
            trainers[backend].setup_optimizer()
        parts, max_dloss, band_total = [], 0.0, 0
        reset_counts()
        for i, b in enumerate(batches):
            dbatch = trainers["cuda"].to_device(b)
            x, _ = prep(*dbatch)
            with torch.no_grad():
                p_plain = trainers["torch"].model(x)
            band = int(((p_plain - TAU).abs() <= PROB_TOL).sum())
            res = {k: t.train_step(metrics.init_metric_state(dev), *dbatch)
                   for k, t in trainers.items()}
            lc, lt = float(res["cuda"][1]), float(res["torch"][1])
            cc, ct = (metrics.metric_counts(res[k][0]) for k in ("cuda", "torch"))
            check(abs(lc - lt) <= 1e-4 * abs(lt), f"step {i}: loss {lc} vs {lt}")
            dcount = sum(abs(a - c) for a, c in zip(cc, ct))
            check(dcount <= 2 * band, f"step {i}: counts {cc} vs {ct}, {band} voxels in "
                                      "the 1e-5 band of tau")
            max_dloss = max(max_dloss, abs(lc - lt) / abs(lt))
            band_total += band
            parts.append(f"step {i}: loss {lc:.7f} / {lt:.7f}, counts {cc} / {ct}")
        parity_counts = read_counts()
        check(parity_counts["stencil_conv"] == parity_counts["stencil_dk"] == len(batches),
              f"parity: the cuda backend's kernels launched {parity_counts}")
        pmax = 0.0
        for (n, a), c in zip(trainers["cuda"].model.named_parameters(),
                             trainers["torch"].model.parameters()):
            d = float((a - c).detach().abs())
            check(d <= 1e-5, f"parameter {n} differs by {d:.3g} after 3 steps")
            pmax = max(pmax, d)
        print(f"[train parity] 3 steps, cuda vs torch backend (cuDNN, TF32 off): max "
              f"rel|dloss| {max_dloss:.3g}, max|dparam| {pmax:.3g}, voxels within 1e-5 "
              f"of tau {band_total} | launches {parity_counts} | " + " | ".join(parts), flush=True)

        # ---- 12. train step timing -----------------------------------------
        dbatch = trainers["cuda"].to_device(batches[0])
        ms = {k: metrics.init_metric_state(dev) for k in trainers}
        step_t = paired_ms(lambda: trainers["cuda"].train_step(ms["cuda"], *dbatch),
                           lambda: trainers["torch"].train_step(ms["torch"], *dbatch),
                           iters=5)
        print(f"[timing] train step B={TRAIN_BATCH} 64^3 N={TRAIN_POINTS} (9,5,5) "
              f"geneo_tversky adam ({smi}), median of 4 alternating rounds [min-max] "
              f"ms/step: " + fmt_times({"backend cuda vs torch": step_t}), flush=True)
        del trainers, dbatch

        # ---- 13. main path: host-exact training, cli.train --host-indices ------
        def train_run(tag, extra, host_indices):
            """One epoch through the train CLI; the scores, the seconds and the
            launch counts of that run alone."""
            run_argv = ((["--host-indices"] if host_indices else [])
                        + ["--set", *DEFAULTS_SET, "--set", "max_epochs=1", "device_cache=False",
                           "num_workers=4", f"output_dir={tmp / tag}",
                           f"checkpoint_dir={tmp / tag / 'ckpt'}", *extra])
            reset_counts()
            t0 = time.perf_counter()
            run_scores = train_cli.main(run_argv)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            run_counts = read_counts()
            run_losses = {k: v for k, v in run_scores.items() if k.endswith("loss")}
            check(set(run_losses) == {"train_loss", "val_loss", "test_loss"}
                  and all(math.isfinite(v) for v in run_losses.values()),
                  f"{tag}: losses {run_losses}")
            check((tmp / tag / "ckpt" / "last.npz").exists(), f"{tag}: no last.npz")
            return run_scores, run_losses, seconds, run_counts

        def only(counts, used, steps, tag):
            """The histogram kernel ``used`` ran every step and the other
            histogram kernels of a train step never; K2 and K4 ran."""
            check(counts[used] >= steps, f"{tag}: {used} launched {counts[used]} times in "
                                         f"{steps} steps")
            for k in ("points_binary", "points_bin_counts", "bin_counts", "sorted_bin_counts",
                      "points_occupancy", "flat_ids"):
                check(k == used or counts[k] == 0, f"{tag}: {k} launched {counts[k]} times")
            check(counts["stencil_dk"] == steps and counts["stencil_conv"] >= steps,
                  f"{tag}: stencil kernels launched {counts}")

        host_steps = n_train // TRAIN_BATCH
        _, host_losses, host_s, host_counts = train_run(
            "host_exact", [f"data_path={tmp / 'ts40k'}"], host_indices=True)
        only(host_counts, "bin_counts", host_steps, "host-exact training")
        print(f"[train host-exact] cli.train --host-indices, defaults width (B={TRAIN_BATCH}, "
              f"64^3, {TRAIN_POINTS} points): float64 bin indices from the loader, counted by "
              f"K7; 1 epoch = {host_steps} steps in {host_s:.1f} s | losses "
              + ", ".join(f"{k} {v:.6f}" for k, v in sorted(host_losses.items()))
              + f" | launches {host_counts}", flush=True)

        # ---- 14. main path: the 128^3 grid, both train routes and one request --
        write_dataset(tmp / "ts40k_big", seed=9, n_fit=BIG_FIT, n_test=BIG_TEST)
        big_steps = (BIG_FIT - int(BIG_FIT * 0.1)) // BIG_BATCH
        big_set = [f"data_path={tmp / 'ts40k_big'}", f"voxel_grid_size={BIG_GRID}",
                   f"batch_size={BIG_BATCH}", f"max_points={MAX_POINTS}"]
        big_counts, parts = {}, []
        for tag, host_indices in (("big_host", True), ("big_device", False)):
            _, big_losses, big_s, big_counts[tag] = train_run(tag, big_set, host_indices)
            only(big_counts[tag], "sorted_bin_counts", big_steps, tag)
            parts.append(f"{'--host-indices' if host_indices else 'bins on the card'}: "
                         f"{big_steps} steps in {big_s:.1f} s, losses "
                         + ", ".join(f"{k} {v:.6f}" for k, v in sorted(big_losses.items()))
                         + f", launches {big_counts[tag]}")
        print(f"[train 128^3] cli.train, voxel_grid_size {BIG_GRID}, B={BIG_BATCH}, "
              f"{MAX_POINTS} points, both through K8 | " + " | ".join(parts), flush=True)

        def route_step_ms(data, grid, n_pad, batch_size):
            """ms a train step from host-exact indices ('kernel') and from
            bins computed on the card ('plain'), in turns, on one batch."""
            pad = PointPadding(max_points=n_pad, vxg_size=grid, compute_indices=True)
            one = next(iter(PointCloudLoader(TS40K(str(tmp / data), "fit", transform=pad),
                                             batch_size, num_workers=4, drop_last=True)))
            pair = {}
            for use_indices in (True, False):
                model = SceneNet.create(kernel_size=(9, 5, 5), seed=0, backend="cuda").to(dev)
                pair[use_indices] = Trainer(model, crit, TrainConfig(
                    run_dir=str(tmp / f"route_{data}_{use_indices}"),
                    checkpoint_dir=str(tmp / f"route_ckpt_{data}_{use_indices}")),
                    batch_prep=make_device_voxelize_prep(grid, (TOWER,),
                                                         use_indices=use_indices))
                pair[use_indices].setup_optimizer()
            dbatch = pair[True].to_device(one)
            state = metrics.init_metric_state(dev)
            step_t = paired_ms(lambda: pair[True].train_step(state, *dbatch),
                               lambda: pair[False].train_step(state, *dbatch), iters=5)
            if opts.profile:
                n_prof = 5
                wall, busy_us, n_items, largest, _ = profiled(lambda: [
                    pair[False].train_step(state, *dbatch) for _ in range(n_prof)])
                print(f"[profile] train step, bins on the card, B={batch_size} grid {grid} "
                      f"N={n_pad} ({smi}): {n_prof} steps in {wall * 1e3:.1f} ms wall, device "
                      f"busy {busy_us / 1e3:.3f} ms = idle share {1 - busy_us / 1e6 / wall:.4f}, "
                      f"{n_items / n_prof:.1f} device items a step; largest: {largest}",
                      flush=True)
            return step_t

        route_t = {
            f"B={BIG_BATCH} 128^3 N={MAX_POINTS}: host indices (K8) vs bins on the card (K8)":
                route_step_ms("ts40k_big", BIG_GRID, MAX_POINTS, BIG_BATCH),
            f"B={TRAIN_BATCH} 64^3 N={TRAIN_POINTS}: host indices (K7) vs bins on the card (K3)":
                route_step_ms("ts40k", GRID, TRAIN_POINTS, TRAIN_BATCH)}
        print(f"[timing] train step by route, (9,5,5) geneo_tversky adam, backend cuda ({smi}), "
              "median of 4 alternating rounds [min-max] ms/step; 'kernel' = from host-exact "
              "indices, 'plain' = bins on the card: " + fmt_times(route_t), flush=True)

        server, big = build_server(["--grid", "128", "--port", "0"])
        cpu_big = _Pipeline(None, grid=BIG_GRID, device="cpu")
        with running(server, big) as url:
            reset_counts()
            status, out, wall_ms, server_ms = post(f"{url}/predict", clouds[0], TAU)
            big_serve_counts = read_counts()
        check(status == 200, f"/predict at --grid 128 returned {status}")
        err = check_reply(out, clouds[0], cpu_big.predict(clouds[0]), PROB_TOL,
                          "serve --grid 128", grid=BIG_GRID)
        check(big_serve_counts["sorted_bin_counts"] >= 1 and big_serve_counts["stencil_conv"] >= 1
              and big_serve_counts["points_occupancy"] == 0,
              f"the 128^3 request launched {big_serve_counts}")
        print(f"[serve 128^3] --grid 128: the reply matches the CPU pipeline (max|d| {err:.3g}), "
              f"{wall_ms:.1f}/{server_ms:.1f} ms wall/server | launches {big_serve_counts}",
              flush=True)
        del big, cpu_big
        torch.cuda.empty_cache()

        # ---- 15. main path: the counts kernel under the Trainer, and the ids ---
        frac_prep = make_device_voxelize_prep(GRID, (TOWER,), binarize=(True, False))
        net = SceneNet.create(kernel_size=(9, 5, 5), seed=0, backend="cuda").to(dev)
        frac = Trainer(net, crit, TrainConfig(run_dir=str(tmp / "frac"),
                                              checkpoint_dir=str(tmp / "frac_ckpt")),
                       batch_prep=frac_prep)
        frac.setup_optimizer()
        reset_counts()
        frac_losses = []
        for b in batches:
            _, loss = frac.train_step(metrics.init_metric_state(dev), *frac.to_device(b))
            frac_losses.append(float(loss))
        pts_b, lab_b, mask_b, _ = frac.to_device(batches[0])
        density = voxelize_batch_hist(pts_b, mask_b, GRID)
        ids = cuda_hist.flat_ids(pts_b, mask_b, GRID)
        torch.cuda.synchronize()
        counts_path = read_counts()
        check(all(math.isfinite(v) for v in frac_losses), f"tower-fraction losses {frac_losses}")
        check(counts_path["points_bin_counts"] == len(batches) + 1 and counts_path["flat_ids"] == 1
              and counts_path["points_binary"] == 0 and counts_path["stencil_dk"] == len(batches),
              f"the counts path launched {counts_path}")
        x_frac, y_frac = frac_prep(pts_b, lab_b, mask_b)
        x_bin, y_bin = prep(pts_b, lab_b, mask_b)
        check(torch.equal(x_frac, x_bin) and torch.equal((y_frac > 0).float(), y_bin)
              and 0 < float(y_frac[y_frac > 0].min()) < 1,
              "the tower-fraction prep disagrees with the binarized prep")
        check(torch.equal((density > 0).float()[:, None], x_bin) and float(density.max()) == 1,
              "voxelize_batch_hist > 0 is not the occupancy")
        same = ids.long()[mask_b] == batch_flat_ids(pts_b, mask_b, GRID)[mask_b]
        check(float(same.float().mean()) > 0.99, "flat_ids far from batch_flat_ids")
        print(f"[counts path] 3 train steps on a tower-fraction target (binarize=(True, False), "
              f"K6): losses " + ", ".join(f"{v:.6f}" for v in frac_losses)
              + f"; voxelize_batch_hist > 0 = the occupancy; flat_ids (K9, multiply recipe) "
              f"agrees with batch_flat_ids (divide) on {int(same.sum())} of {same.numel()} "
              f"points | launches {counts_path}", flush=True)
        del frac, density, ids

        # ---- 16. main path: UNet3D through the train CLI, every conv in K10 ------
        unet_steps = n_train // TRAIN_BATCH
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        unet_scores, unet_losses, unet_s, unet_counts = train_run(
            "unet", [f"data_path={tmp / 'ts40k'}", "model=unet", "device_cache=auto"], False)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        # 3 steps, one validation batch and one test batch
        check(unet_counts["conv3d_mc"] == UNET_TRAIN_LAUNCHES * unet_steps
              + UNET_EVAL_LAUNCHES * 2,
              f"unet: K10 launched {unet_counts['conv3d_mc']} times in {unet_steps} steps and "
              "2 evaluation batches")
        check(unet_counts["points_binary"] == unet_steps + 2
              and unet_counts["stencil_conv"] == unet_counts["stencil_dk"] == 0,
              f"unet: launches {unet_counts}")
        check(all(f"test_{m}" in unet_scores for m in metrics.METRIC_NAMES), "unet test scores")
        best_ckpt = sorted((tmp / "unet" / "ckpt").glob("train_FBetaScore_step*.npz"))
        check(len(best_ckpt) >= 1, "unet: no best checkpoint")
        unet = restore_checkpoint(str(best_ckpt[0]), UNet3D.create(seed=1, backend="cuda")).to(dev)
        fresh = UNet3D.create(seed=0)
        check(float((unet.down0.bn0.mean.cpu() - fresh.down0.bn0.mean).abs().max()) > 0
              and not torch.equal(unet.up3.conv1.cpu(), fresh.up3.conv1),
              "unet: the checkpoint holds the initial weights or statistics")
        with torch.no_grad():
            probs = unet.eval()(prep(*(torch.as_tensor(a).to(dev) for a in batches[0]))[0])
        check(bool(torch.isfinite(probs).all()) and 0 <= float(probs.min())
              and float(probs.max()) <= 1 and tuple(probs.shape) == (TRAIN_BATCH, 1, 64, 64, 64),
              "unet: restored model's prediction")
        print(f"[train unet] cli.train model=unet, defaults width (B={TRAIN_BATCH}, 64^3, "
              f"{TRAIN_POINTS} points, ladder 32-64-128-256-256, geneo_tversky, adam), 1 epoch = "
              f"{unet_steps} steps + 1 validation + 1 test batch in {unet_s:.1f} s | losses "
              + ", ".join(f"{k} {v:.6f}" for k, v in sorted(unet_losses.items()))
              + f" | test_F1Score {unet_scores['test_F1Score']:.4f} | best checkpoint "
              f"{best_ckpt[0].name} restored, probabilities in [{float(probs.min()):.4f}, "
              f"{float(probs.max()):.4f}] | peak device memory {peak_gb:.2f} GB | launches "
              f"{unet_counts}", flush=True)
        del unet, probs

        # ---- 17. UNet train parity and step time: K10 backend vs plain backend ---
        unets = {}
        for backend in ("cuda", "torch"):
            unets[backend] = Trainer(UNet3D.create(seed=0, backend=backend).to(dev), crit,
                                     TrainConfig(run_dir=str(tmp / f"unet_{backend}"),
                                                 checkpoint_dir=str(tmp / f"unet_ckpt_{backend}")),
                                     batch_prep=prep)
            unets[backend].setup_optimizer()
        parts, max_dloss = [], 0.0
        reset_counts()
        for i, b in enumerate(batches):
            dbatch = unets["cuda"].to_device(b)
            res = {k: t.train_step(metrics.init_metric_state(dev), *dbatch)
                   for k, t in unets.items()}
            lc, lt = float(res["cuda"][1]), float(res["torch"][1])
            check(math.isfinite(lc) and abs(lc - lt) <= UNET_LOSS_RTOL * abs(lt),
                  f"unet step {i}: loss {lc} vs {lt}")
            max_dloss = max(max_dloss, abs(lc - lt) / abs(lt))
            parts.append(f"step {i}: loss {lc:.7f} / {lt:.7f}")
        unet_parity_counts = read_counts()
        check(unet_parity_counts["conv3d_mc"] == UNET_TRAIN_LAUNCHES * len(batches),
              f"unet parity: K10 launched {unet_parity_counts['conv3d_mc']} times")
        stats_err, stats_at = max(
            (float(((a - c).abs() / (1 + c.abs())).max()), n) for (n, a), c in zip(
                unets["cuda"].model.named_buffers(), unets["torch"].model.buffers()))
        check(stats_err <= UNET_STATS_TOL, f"unet: running statistics differ by {stats_err:.3g}")
        print(f"[train unet parity] 3 steps, backend cuda (K10) vs torch (cuDNN, TF32 off) from "
              f"the same weights: max rel|dloss| {max_dloss:.3g} (limit {UNET_LOSS_RTOL}), "
              f"max|d running statistics|/(1 + |s|) {stats_err:.3g} (at {stats_at}; limit {UNET_STATS_TOL}) | "
              + " | ".join(parts), flush=True)
        dbatch = unets["cuda"].to_device(batches[0])
        ms = {k: metrics.init_metric_state(dev) for k in unets}
        unet_step_t = paired_ms(lambda: unets["cuda"].train_step(ms["cuda"], *dbatch),
                                lambda: unets["torch"].train_step(ms["torch"], *dbatch),
                                iters=2, warmup=1)
        print(f"[timing] UNet3D train step B={TRAIN_BATCH} 64^3 N={TRAIN_POINTS} geneo_tversky "
              f"adam ({smi}), median of 4 alternating rounds [min-max] ms/step: "
              + fmt_times({"backend cuda (K10 forward and dx) vs torch": unet_step_t}),
              flush=True)
        if opts.profile:
            n_prof = 3
            wall, busy_us, n_items, largest, by_name = profiled(lambda: [
                unets["cuda"].train_step(ms["cuda"], *dbatch) for _ in range(n_prof)])
            k10_us = sum(v for k, v in by_name.items() if "conv3d_mc_" in k)
            dw_us = by_name.get("aten::convolution_backward", 0.0)
            print(f"[profile] UNet3D train step, backend cuda, B={TRAIN_BATCH} 64^3 ({smi}): "
                  f"{n_prof} steps in {wall * 1e3:.1f} ms wall, device busy {busy_us / 1e3:.3f} "
                  f"ms = idle share {1 - busy_us / 1e6 / wall:.4f}, {n_items / n_prof:.1f} "
                  f"device items a step; K10 {k10_us / busy_us:.4f} of the device time, the "
                  f"library's weight gradients (aten::convolution_backward) "
                  f"{dw_us / busy_us:.4f}; largest: {largest}", flush=True)
        del unets, dbatch, batches
        torch.cuda.empty_cache()

        # ---- 18. main path: CnnBaseline with a (3,3,3) kernel through K10 --------
        _, cnn_losses, cnn_s, cnn_counts = train_run(
            "cnn", [f"data_path={tmp / 'ts40k'}", "model=cnn", "kernel_size=(3, 3, 3)"], False)
        # two convs forward, dx of the second alone; two convs an evaluation batch
        check(cnn_counts["conv3d_mc"] == 3 * unet_steps + 2 * 2,
              f"cnn: K10 launched {cnn_counts['conv3d_mc']} times")
        print(f"[train cnn] cli.train model=cnn kernel_size=(3,3,3): 1 epoch = {unet_steps} "
              f"steps in {cnn_s:.1f} s | losses "
              + ", ".join(f"{k} {v:.6f}" for k, v in sorted(cnn_losses.items()))
              + f" | launches {cnn_counts}", flush=True)

    main_runs = [serve_counts, headline_counts, batched_counts, train_counts, host_counts,
                 *big_counts.values(), big_serve_counts, counts_path, unet_counts, cnn_counts]
    total = {k: sum(run[k] for run in main_runs) for k in counters}
    # bounds at the shapes the times below were taken at: 64^3, kernel (9,5,5);
    # K1, K2, K5 at batch 64 (the batched pipeline), K3, K4 at the train batch
    vox = GRID[0] * GRID[1] * GRID[2]
    taps = 9 * 5 * 5

    def grid_bytes(b):  # one f32 grid
        return 4.0 * b * vox

    def conv_flops(b):  # a multiply and an add per tap and voxel
        return 2.0 * taps * b * vox

    bounds = {
        # points f32 x 3 and the bool mask in, one f32 grid out
        "points_occupancy": bound_ms(64 * MAX_POINTS * 13.0 + grid_bytes(64)),
        "stencil_conv": bound_ms(2 * grid_bytes(64), conv_flops(64), F32_FLOPS),
        # points, mask and tower flags in, two f32 grids out
        "points_binary": bound_ms(TRAIN_BATCH * TRAIN_POINTS * 14.0
                                  + 2 * grid_bytes(TRAIN_BATCH)),
        # x and g in, 225 floats out
        "stencil_dk": bound_ms(2 * grid_bytes(TRAIN_BATCH) + 4.0 * taps,
                               conv_flops(TRAIN_BATCH), F32_FLOPS),
        # the hi and the lo sum, both on the bf16 tensor cores
        "stencil_mma": bound_ms(2 * grid_bytes(64), 2 * conv_flops(64), BF16_FLOPS),
        # points, mask and tower flags in, two f32 count grids out
        "points_bin_counts": bound_ms(TRAIN_BATCH * TRAIN_POINTS * 14.0
                                      + 2 * grid_bytes(TRAIN_BATCH)),
        # int32 ids, mask and flags in, two f32 count grids out
        "bin_counts": bound_ms(TRAIN_BATCH * TRAIN_POINTS * 6.0 + 2 * grid_bytes(TRAIN_BATCH)),
        "sorted_bin_counts": bound_ms(BIG_BATCH * MAX_POINTS * 6.0
                                      + 2 * 4.0 * BIG_BATCH * 128 ** 3),
        # points and mask in, int32 ids out
        "flat_ids": bound_ms(TRAIN_BATCH * TRAIN_POINTS * 17.0),
    }
    # K10: the UNet's 18 forward convs at the train batch, one after the other
    # (x and w in, the result out, 2*27*C_in*C_out TF32 and twice as many bf16
    # operations a voxel; the sum of the 18 bounds)
    mc_sum = mc_sums
    bounds["conv3d_mc"] = (mc_bound_sum,
                           "operations" if sum(mc_bounds[c][0] for c in UNET_CONVS
                                               if mc_bounds[c][1] == "operations")
                           >= sum(mc_bounds[c][0] for c in UNET_CONVS
                                  if mc_bounds[c][1] == "bytes") else "bytes")

    def entry(name, source, replaces, err, t, shape):
        b_ms, by = bounds[name]
        return {"name": name, "route": "cuda", "source": f"scenenet_tpu_torch/csrc/{source}",
                "replaces": f"scenenet_tpu/ops/{replaces}", "launches": total[name],
                "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": b_ms, "bound_by": by, "library_ms": t["library_ms"],
                "shape": shape}

    big = f"B=64 N={MAX_POINTS} 64^3 k(9,5,5)"
    small = f"B={TRAIN_BATCH} N={TRAIN_POINTS} 64^3 k(9,5,5)"
    kernels = [
        entry("points_occupancy", "points_occupancy.cu", "pallas_hist.py:297", k1_err,
              times[64]["occupancy"], big),
        entry("stencil_conv", "stencil_conv.cu", "pallas_conv.py:103", k2_err,
              times[64]["stencil (9,5,5)"], big),
        entry("points_binary", "points_occupancy.cu", "pallas_hist.py:356", k3_err,
              train_times[TRAIN_BATCH]["points_binary"], small),
        entry("stencil_dk", "stencil_dk.cu", "pallas_conv.py:729", k4_err,
              train_times[TRAIN_BATCH]["stencil_dk (9,5,5)"], small),
        entry("stencil_mma", "stencil_mma.cu", "pallas_conv.py:448", k5_err,
              times[64]["stencil_mma (9,5,5)"], big),
        entry("points_bin_counts", "points_occupancy.cu", "pallas_hist.py:228", k6_err,
              hist_times["points_bin_counts"], f"B={TRAIN_BATCH} N={TRAIN_POINTS} 64^3 2ch"),
        entry("bin_counts", "bin_counts.cu", "pallas_hist.py:417", k7_err,
              hist_times["bin_counts"], f"B={TRAIN_BATCH} N={TRAIN_POINTS} 64^3 2ch"),
        entry("sorted_bin_counts", "bin_counts.cu", "pallas_hist.py:540", k8_err,
              big_times["sorted_bin_counts"], f"B={BIG_BATCH} N={MAX_POINTS} 128^3 2ch"),
        entry("flat_ids", "points_occupancy.cu", "pallas_hist.py:647", k9_err,
              hist_times["flat_ids"], f"B={TRAIN_BATCH} N={TRAIN_POINTS} 64^3"),
        entry("conv3d_mc", "conv3d_mc.cu", "pallas_conv_mc.py:100", k10_err, mc_sum,
              f"B={TRAIN_BATCH} 64^3, the sum over UNet3D's 18 forward convs"),
    ]
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} was launched no time on the main paths")
        check(k["ms"] >= k["bound_ms"], f"{k['name']}: {k['ms']:.4f} ms is under its bound")
    print("[bounds] " + " | ".join(
        f"{k['name']} {k['shape']}: {k['ms']:.4f} ms, bound {k['bound_ms']:.4f} ms by "
        f"{k['bound_by']} ({k['bound_ms'] / k['ms']:.1%} of it)" for k in kernels), flush=True)
    print(f"[total] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
