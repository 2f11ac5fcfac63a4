#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``scenenet_tpu_torch``) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

It builds the hand-written kernels from ``scenenet_tpu_torch/csrc`` with
nvcc, holds each against its plain PyTorch version on the card, times
both, then serves a few requests through the port's HTTP server at the
serving defaults (64³ grid, 131072 points, SceneNet (9,5,5)) and compares
every reply with the same request through a CPU pipeline. It prints one
line per phase, the card's name and power limit, a JSON line of kernel
results and, last, ``{"ok": true, "device": {...}}``. Any failure raises
and exits non-zero; without a CUDA device it exits non-zero at once.
"""

from __future__ import annotations

import io
import json
import re
import subprocess
import sys
import threading
import time
import urllib.request
from http.server import ThreadingHTTPServer
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
GRID = (64, 64, 64)
MAX_POINTS = 131072
TAU = 0.65
PROB_TOL = 1e-5  # f32 conv: the kernel sums its 225 taps in another order than cuDNN


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def synthetic_cloud(rng: np.random.Generator, n: int) -> np.ndarray:
    """A LiDAR-like crop: ground, a few tower-like columns, wires, clutter,
    rounded to 1 cm like real scans, so points on voxel edges occur."""
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
    cloud = np.concatenate([ground, *towers, wire, clutter])
    cloud = np.round(cloud, 2)
    return (cloud - cloud.min(0)).astype(np.float32)


def padded_batch(rng, b, n_pad=MAX_POINTS, lo=40000, hi=70000):
    pts = np.zeros((b, n_pad, 3), np.float32)
    mask = np.zeros((b, n_pad), bool)
    for i in range(b):
        n = int(rng.integers(lo, hi))
        pts[i, :n] = synthetic_cloud(rng, n)
        mask[i, :n] = True
    return pts, mask


def full_column_case():
    """Every voxel of y column 0 holds ≥ 2 points: there the occupancy rule
    (count > column min) differs from count > 0."""
    pts = [[ix + 0.5, 0.5, iz + 0.5] for iz in range(8) for ix in range(8) for _ in range(2)]
    pts += [[0.5, 0.5, 0.5], [7.9, 7.9, 7.9]]
    pts = np.asarray(pts, np.float32)[None]
    return pts, np.ones(pts.shape[:2], bool)


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

    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device; nothing was run", file=sys.stderr)
        return 1
    if not (ROOT / "scenenet_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from the root of a checkout of the repo", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from scenenet_tpu_torch.cli.serve import _Pipeline, make_handler
    from scenenet_tpu_torch.models.scenenet import SceneNet
    from scenenet_tpu_torch.ops import _build, cuda_conv, cuda_hist

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
    print(f"[build] {time.perf_counter() - t0:.2f} s (nvcc {_build.build_seconds:.2f} s) "
          f"-> {_build.library_path().name}; max registers {max(regs, default=-1)}, "
          f"spill stores {spills} B", flush=True)

    rng = np.random.default_rng(0)

    # ---- 3. K1 occupancy kernel vs plain ------------------------------------
    pts8, mask8 = padded_batch(rng, 8)
    col_pts, col_mask = full_column_case()
    ng_pts, ng_mask = padded_batch(rng, 4)
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

    # ---- 5. timing ----------------------------------------------------------
    times = {}
    kern = SceneNet.create(kernel_size=(9, 5, 5), seed=0).combined_kernel().detach().to(dev)
    for b in (1, 64):
        p, m = padded_batch(np.random.default_rng(b), b)
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
              "[min-max] ms: " + " | ".join(
                  f"{k} kernel {v['ms']:.4f} [{v['range'][0]:.4f}-{v['range'][1]:.4f}] vs plain "
                  f"{v['plain_ms']:.4f} [{v['plain_range'][0]:.4f}-{v['plain_range'][1]:.4f}]"
                  for k, v in t.items()), flush=True)

    # ---- 6. serve -----------------------------------------------------------
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
        cuda_hist.LAUNCHES.reset()
        cuda_conv.LAUNCHES.reset()
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
        launches = {"points_occupancy": cuda_hist.LAUNCHES.count,
                    "stencil_conv": cuda_conv.LAUNCHES.count}
        with urllib.request.urlopen(f"{url}/healthz", timeout=60) as r:
            health = json.loads(r.read())
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    for k, v in launches.items():
        check(v >= len(requests), f"{k} launched {v} times for {len(requests)} requests")
    check(health["kernel_launches"] == launches, f"/healthz counts {health['kernel_launches']}")
    print(f"[serve] {len(requests)} requests match the CPU pipeline (max|d| {worst:.3g}) | "
          "latency ms wall/server: " + ", ".join(f"{w:.2f}/{s:.2f}" for w, s in lat)
          + f" | launches {launches} | healthz device {health['device']}", flush=True)

    kernels = [
        {"name": "points_occupancy", "route": "cuda",
         "source": "scenenet_tpu_torch/csrc/points_occupancy.cu",
         "replaces": "scenenet_tpu/ops/pallas_hist.py:297",
         "launches": launches["points_occupancy"], "max_abs_err": k1_err,
         "ms": times[1]["occupancy"]["ms"], "plain_ms": times[1]["occupancy"]["plain_ms"]},
        {"name": "stencil_conv", "route": "cuda",
         "source": "scenenet_tpu_torch/csrc/stencil_conv.cu",
         "replaces": "scenenet_tpu/ops/pallas_conv.py:103",
         "launches": launches["stencil_conv"], "max_abs_err": k2_err,
         "ms": times[1]["stencil (9,5,5)"]["ms"],
         "plain_ms": times[1]["stencil (9,5,5)"]["plain_ms"]},
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
