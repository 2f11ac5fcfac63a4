#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``scenenet_tpu_torch``) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

It builds the hand-written kernels from ``scenenet_tpu_torch/csrc`` with
nvcc, holds each against its plain PyTorch version on the card and times
both. Then it drives the port's two main paths through their entry
points: it serves a few requests through the HTTP server at the serving
defaults (64³ grid, 131072 points, SceneNet (9,5,5)) and compares every
reply with the same request through a CPU pipeline; and it trains for two
epochs through the train CLI at the width of experiments/defaults.yaml
(batch 16, 64³, 65536 points, (9,5,5), geneo_tversky) on seeded synthetic
TS40K-style crops, then checks three train steps of the kernel backend
against the plain one. It prints one line per phase, the card's name and
power limit, a JSON line of kernel results and, last,
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero;
without a CUDA device it exits non-zero at once.
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
TAU = 0.65
PROB_TOL = 1e-5  # f32 conv: the kernel sums its 225 taps in another order than cuDNN
DK_REL_TOL = 1e-4  # dk: f32 sums of 4.2 M products per tap in another order
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


def write_dataset(root: Path, seed: int = 7) -> None:
    """Seeded synthetic TS40K directory: fit/ and test/ of sample_i.npy,
    (N, 4) float64 xyz + label, 40k–70k points each, 1 cm."""
    rng = np.random.default_rng(seed)
    for split, n in (("fit", N_FIT), ("test", N_TEST)):
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


def paired_ms(kernel_fn, plain_fn, iters: int, rounds: int = 4):
    """Median ms per call of the kernel and of its plain version, timed in
    alternating order (plain, kernel, kernel, plain, ...), with each side's
    min and max."""
    ks, ps = [], []
    for r in range(rounds):
        pairs = [(plain_fn, ps), (kernel_fn, ks)]
        for fn, acc in (pairs if r % 2 == 0 else pairs[::-1]):
            acc.append(cuda_ms(fn, iters))
    return {"ms": float(np.median(ks)), "plain_ms": float(np.median(ps)),
            "range": (min(ks), max(ks)), "plain_range": (min(ps), max(ps))}


def fmt_times(t: dict) -> str:
    return " | ".join(
        f"{k} kernel {v['ms']:.4f} [{v['range'][0]:.4f}-{v['range'][1]:.4f}] vs plain "
        f"{v['plain_ms']:.4f} [{v['plain_range'][0]:.4f}-{v['plain_range'][1]:.4f}]"
        for k, v in t.items())


def post(url: str, points: np.ndarray, tau: float):
    buf = io.BytesIO()
    np.savez(buf, points=points, tau=np.float32(tau))
    req = urllib.request.Request(url, data=buf.getvalue(), method="POST")
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as r:
        status, body, server_ms = r.status, r.read(), float(r.headers["X-Latency-Ms"])
    return status, np.load(io.BytesIO(body)), (time.perf_counter() - t0) * 1e3, server_ms


def main() -> int:
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device; nothing was run", file=sys.stderr)
        return 1
    if not (ROOT / "scenenet_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from the root of a checkout of the repo", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from scenenet_tpu_torch.cli import train as train_cli
    from scenenet_tpu_torch.cli.serve import _Pipeline, make_handler
    from scenenet_tpu_torch.data import PointCloudLoader, PointPadding, TS40K
    from scenenet_tpu_torch.losses import resolve_criterion
    from scenenet_tpu_torch.models.scenenet import SceneNet
    from scenenet_tpu_torch.ops import _build, cuda_conv, cuda_hist
    from scenenet_tpu_torch.ops.conv3d import conv3d_same
    from scenenet_tpu_torch.train import (
        TrainConfig, Trainer, make_device_voxelize_prep, metrics,
    )
    from scenenet_tpu_torch.train.checkpoint import restore_checkpoint
    from scenenet_tpu_torch.utils.config import load_config

    counters = {"points_occupancy": cuda_hist.LAUNCHES,
                "stencil_conv": cuda_conv.LAUNCHES,
                "points_binary": cuda_hist.BINARY_LAUNCHES,
                "stencil_dk": cuda_conv.DK_LAUNCHES}

    def reset_counts():
        for c in counters.values():
            c.reset()

    def read_counts():
        return {k: c.count for k, c in counters.items()}

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
    k1_cases = [("B8_N131072_64^3", pts8, mask8, GRID),
                ("full_column_8^3", col_pts, col_mask, (8, 8, 8)),
                ("B4_grid48x40x56", ng_pts, ng_mask, (48, 40, 56))]
    k1_err, occ64 = 0.0, None
    parts = []
    for label, p, m, g in k1_cases:
        pt, mt = torch.from_numpy(p).to(dev), torch.from_numpy(m).to(dev)
        got = cuda_hist.points_occupancy(pt, mt, g)
        want = cuda_hist.points_occupancy_plain(pt, mt, g)
        torch.cuda.synchronize()
        diff = int((got != want).sum())
        k1_err = max(k1_err, float((got - want).abs().max()))
        check(diff == 0, f"K1 {label}: {diff} voxels differ from the plain version")
        if label.startswith("full_column"):
            occ = got.reshape(8, 8, 8).cpu().numpy()
            check(occ[:, :, 0].sum() == 1 and occ[0, 0, 0] == 1 and occ[7, 7, 7] == 1,
                  "K1 full-column case: column-min rule broken")
        if g == GRID:
            occ64 = got
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
    print("[K2 stencil] " + " | ".join(parts), flush=True)

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

    # ---- 8. kernel timing ---------------------------------------------------
    times = {}
    kern = SceneNet.create(kernel_size=(9, 5, 5), seed=0).combined_kernel().detach().to(dev)
    for b in (1, 64):
        p, m, _ = padded_batch(np.random.default_rng(b), b)
        pt, mt = torch.from_numpy(p).to(dev), torch.from_numpy(m).to(dev)
        iters = 20 if b == 1 else 5
        xb = cuda_hist.points_occupancy(pt, mt, GRID).reshape(b, 1, GRID[2], GRID[0], GRID[1])
        with torch.no_grad():
            times[b] = {
                "occupancy": paired_ms(lambda: cuda_hist.points_occupancy(pt, mt, GRID),
                                       lambda: cuda_hist.points_occupancy_plain(pt, mt, GRID),
                                       iters),
                "stencil (9,5,5)": paired_ms(lambda: cuda_conv.geneo_stencil_conv(xb, kern),
                                             lambda: cuda_conv.geneo_stencil_conv_plain(xb, kern),
                                             iters)}
        del pt, mt, xb
        torch.cuda.empty_cache()
    for b, t in times.items():
        print(f"[timing] B={b} 64^3 N={MAX_POINTS} ({smi}), median of 4 alternating rounds "
              "[min-max] ms: " + fmt_times(t), flush=True)
    train_times = {}
    for b in (1, TRAIN_BATCH):
        p, m, lab = padded_batch(np.random.default_rng(100 + b), b, n_pad=TRAIN_POINTS)
        args = [torch.from_numpy(a).to(dev) for a in (p, m, (lab == TOWER) & m)]
        xb = cuda_hist.points_binary(*args, GRID)[0].reshape(b, 1, GRID[2], GRID[0], GRID[1])
        gb = torch.from_numpy(np.random.default_rng(b).normal(
            0, 1, tuple(xb.shape)).astype(np.float32)).to(dev)
        iters = 20 if b == 1 else 5
        train_times[b] = {
            "points_binary": paired_ms(lambda: cuda_hist.points_binary(*args, GRID),
                                       lambda: cuda_hist.points_binary_plain(*args, GRID),
                                       iters),
            "stencil_dk (9,5,5)": paired_ms(
                lambda: cuda_conv.stencil_dk(xb, gb, (9, 5, 5)),
                lambda: cuda_conv.stencil_dk_plain(xb, gb, (9, 5, 5)), iters)}
        del args, xb, gb
        torch.cuda.empty_cache()
    for b, t in train_times.items():
        print(f"[timing] B={b} 64^3 N={TRAIN_POINTS} ({smi}), median of 4 alternating "
              "rounds [min-max] ms: " + fmt_times(t), flush=True)

    # ---- 9. main path: serve ------------------------------------------------
    gpu = _Pipeline(None)  # serving defaults: 64³, 131072 points, (9,5,5), card
    check(gpu.device.type == "cuda" and gpu.backend == "cuda", "pipeline not on the card")
    cpu = _Pipeline(None, device="cpu")
    srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(gpu))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    requests = [synthetic_cloud(np.random.default_rng(100 + i), n)
                for i, n in enumerate((41000, 52000, 63000, 69000, 131072 + 5000))]
    try:
        reset_counts()
        lat, worst = [], 0.0
        for pts in requests:
            status, out, wall_ms, server_ms = post(f"{url}/predict", pts, TAU)
            check(status == 200, f"/predict returned {status}")
            n = min(len(pts), MAX_POINTS)
            probs, vox, msk = out["point_probs"], out["voxel_pred"], out["mask"]
            check(probs.shape == (n,) and vox.shape == (64, 64, 64) and msk.shape == (n,),
                  f"reply shapes {probs.shape} {vox.shape} {msk.shape}")
            for a in (probs, vox):
                check(bool(np.isfinite(a).all()) and a.min() >= 0 and a.max() <= 1,
                      "reply not finite in [0, 1]")
            ref_vox, ref_probs = cpu.predict(pts)
            err = max(float(np.abs(probs - ref_probs).max()),
                      float(np.abs(vox - ref_vox).max()))
            flips = (msk != (ref_probs >= TAU)) & (np.abs(ref_probs - TAU) > PROB_TOL)
            check(err <= PROB_TOL, f"served reply differs from the CPU pipeline by {err:.3g}")
            check(not flips.any(), f"{int(flips.sum())} mask flips outside the 1e-5 band")
            worst = max(worst, err)
            lat.append((wall_ms, server_ms))
        serve_counts = read_counts()
        with urllib.request.urlopen(f"{url}/healthz", timeout=60) as r:
            health = json.loads(r.read())
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    for k in ("points_occupancy", "stencil_conv"):
        check(serve_counts[k] >= len(requests),
              f"{k} launched {serve_counts[k]} times for {len(requests)} requests")
    served = {k: serve_counts[k] for k in ("points_occupancy", "stencil_conv")}
    check(health["kernel_launches"] == served, f"/healthz counts {health['kernel_launches']}")
    print(f"[serve] {len(requests)} requests match the CPU pipeline (max|d| {worst:.3g}) | "
          "latency ms wall/server: " + ", ".join(f"{w:.2f}/{s:.2f}" for w, s in lat)
          + f" | launches {serve_counts} | healthz device {health['device']}", flush=True)
    del gpu, cpu
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
        del trainers, batches, dbatch

    total = {k: serve_counts[k] + train_counts[k] for k in counters}
    kernels = [
        {"name": "points_occupancy", "route": "cuda",
         "source": "scenenet_tpu_torch/csrc/points_occupancy.cu",
         "replaces": "scenenet_tpu/ops/pallas_hist.py:297",
         "launches": total["points_occupancy"], "max_abs_err": k1_err,
         "ms": times[1]["occupancy"]["ms"], "plain_ms": times[1]["occupancy"]["plain_ms"]},
        {"name": "stencil_conv", "route": "cuda",
         "source": "scenenet_tpu_torch/csrc/stencil_conv.cu",
         "replaces": "scenenet_tpu/ops/pallas_conv.py:103",
         "launches": total["stencil_conv"], "max_abs_err": k2_err,
         "ms": times[1]["stencil (9,5,5)"]["ms"],
         "plain_ms": times[1]["stencil (9,5,5)"]["plain_ms"]},
        {"name": "points_binary", "route": "cuda",
         "source": "scenenet_tpu_torch/csrc/points_occupancy.cu",
         "replaces": "scenenet_tpu/ops/pallas_hist.py:356",
         "launches": total["points_binary"], "max_abs_err": k3_err,
         "ms": train_times[TRAIN_BATCH]["points_binary"]["ms"],
         "plain_ms": train_times[TRAIN_BATCH]["points_binary"]["plain_ms"]},
        {"name": "stencil_dk", "route": "cuda",
         "source": "scenenet_tpu_torch/csrc/stencil_dk.cu",
         "replaces": "scenenet_tpu/ops/pallas_conv.py:729",
         "launches": total["stencil_dk"], "max_abs_err": k4_err,
         "ms": train_times[TRAIN_BATCH]["stencil_dk (9,5,5)"]["ms"],
         "plain_ms": train_times[TRAIN_BATCH]["stencil_dk (9,5,5)"]["plain_ms"]},
    ]
    print(f"[total] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
