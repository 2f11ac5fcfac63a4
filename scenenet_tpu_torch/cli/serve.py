"""Inference server: point clouds in, tower probabilities/labels out.

PyTorch twin of ``scenenet_tpu.cli.serve``: a single-process stdlib HTTP
server holding the end-to-end pipeline — padded points → on-device
occupancy (CUDA kernel) → SceneNet with the stencil-conv kernel →
probabilities → optional τ-mask and voxel→point gather.

Protocol (POST /predict):
    request body: npz with ``points`` (N, 3) float and optional ``tau``
    response body: npz with ``point_probs`` (N,), ``mask`` (N,) (if tau),
                   and ``voxel_pred`` (Z, X, Y)

GET /healthz returns the model, grid, device and both kernels' launch
counts.

Usage:
    python -m scenenet_tpu_torch.cli.serve [--checkpoint ckpt.npz] [--port 8400]
"""

from __future__ import annotations

import argparse
import io
import json
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from scenenet_tpu_torch.models.scenenet import SceneNet
from scenenet_tpu_torch.ops import cuda_conv, cuda_hist
from scenenet_tpu_torch.ops.voxelize import (
    batch_flat_ids, gather_point_values, voxelize_batch_occupancy,
)
from scenenet_tpu_torch.train.checkpoint import restore_checkpoint


def resolve_device(device: "str | torch.device | None") -> torch.device:
    """``None`` → the card when one is present, else the CPU. An explicit
    ``cuda`` without a card raises instead of running on the CPU."""
    if device is None:
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch finds no CUDA device")
    return device


class _Pipeline:
    def __init__(self, checkpoint: "str | None", grid=(64, 64, 64),
                 max_points: int = 131072, kernel_size=(9, 5, 5),
                 inference: "bool | str" = True,
                 device: "str | torch.device | None" = None):
        if inference in ("mxu", "mxu_fast"):
            raise NotImplementedError(
                f"--inference {inference} (banded-y tensor-core stencil) is "
                "not ported yet: ROADMAP B2")
        self.device = resolve_device(device)
        self.backend = "cuda" if self.device.type == "cuda" else "torch"
        self.model = "scenenet"
        self.net = SceneNet.create(kernel_size=kernel_size, seed=0,
                                   backend=self.backend)
        if checkpoint:
            restore_checkpoint(checkpoint, self.net)
        self.net.to(self.device).eval()
        self.grid = tuple(grid)
        self.max_points = max_points
        # occupancy input is {0,1}: the f32 stencil forward is exact there
        self.inference = bool(inference)
        # first call builds the kernels (cuda) and warms the allocator
        self.predict(np.zeros((16, 3), np.float32))

    @torch.inference_mode()
    def run_batch(self, pts: torch.Tensor, mask: torch.Tensor):
        """(B, N, 3) f32 / (B, N) bool on the pipeline's device →
        (pred (B, Z, X, Y), probs (B, N))."""
        x = voxelize_batch_occupancy(pts, mask, self.grid)[:, None]
        pred = self.net(x, inference=self.inference)[:, 0]
        flat = batch_flat_ids(pts, mask, self.grid)
        return pred, gather_point_values(pred, flat, mask)

    def predict(self, points: np.ndarray):
        """(N, 3) raw points → (voxel_pred (Z, X, Y), point_probs (N,))
        numpy. Points beyond ``max_points`` are dropped; the cloud is
        centred on the host (its min subtracted) before upload."""
        n = min(len(points), self.max_points)
        pts = np.zeros((1, self.max_points, 3), np.float32)
        mask = np.zeros((1, self.max_points), bool)
        pts[0, :n] = points[:n] - points[:n].min(0)
        mask[0, :n] = True
        pred, probs = self.run_batch(torch.from_numpy(pts).to(self.device),
                                     torch.from_numpy(mask).to(self.device))
        return pred[0].cpu().numpy(), probs[0, :n].cpu().numpy()


def kernel_launches() -> dict:
    return {c.name: c.count for c in (cuda_hist.LAUNCHES, cuda_conv.LAUNCHES)}


def make_handler(pipeline: _Pipeline):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _reply(self, code: int, body: bytes, ctype: str, headers=()):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in headers:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path != "/healthz":
                self.send_error(404)
                return
            info = {
                "model": pipeline.model,
                "grid": pipeline.grid,
                "max_points": pipeline.max_points,
                "backend": pipeline.backend,
                "device": str(pipeline.device),
                "kernel_launches": kernel_launches(),
            }
            self._reply(200, json.dumps(info).encode(), "application/json")

        def do_POST(self):
            if self.path != "/predict":
                self.send_error(404)
                return
            # a malformed body gets a 400, not a dropped connection
            try:
                length = int(self.headers.get("Content-Length", 0))
                data = np.load(io.BytesIO(self.rfile.read(length)))
                points = np.asarray(data["points"], np.float32)
                if points.ndim != 2 or points.shape[1] != 3:
                    raise ValueError(f"points must be (N, 3), got {points.shape}")
                if len(points) == 0:
                    raise ValueError("points is empty")
                tau = float(data["tau"]) if "tau" in data else None
            except Exception as exc:
                self.send_error(400, explain=f"bad request body: {exc}")
                return

            try:
                t0 = time.perf_counter()
                pred, probs = pipeline.predict(points)
                latency = time.perf_counter() - t0
            except Exception as exc:  # keep the server alive
                self.send_error(500, explain=f"inference failed: {exc}")
                return

            payload = {"point_probs": probs, "voxel_pred": pred}
            if tau is not None:
                payload["mask"] = (probs >= tau).astype(np.float32)
            out = io.BytesIO()
            np.savez_compressed(out, **payload)
            self._reply(200, out.getvalue(), "application/octet-stream",
                        [("X-Latency-Ms", f"{latency * 1e3:.2f}")])

    return Handler


def main(argv=None):
    parser = argparse.ArgumentParser(description="Serve SCENE-Net inference (PyTorch)")
    parser.add_argument("--checkpoint", type=str, default=None)
    parser.add_argument("--port", type=int, default=8400)
    parser.add_argument("--grid", type=int, default=64)
    parser.add_argument("--max-points", type=int, default=131072)
    parser.add_argument("--model", default="scenenet", choices=["scenenet", "quantile"])
    parser.add_argument("--quantiles", default="0.1,0.5,0.9",
                        help="quantile levels for --model quantile")
    parser.add_argument("--mesh-ensemble", type=int, default=1,
                        help="shard the quantile ensemble over this many devices")
    parser.add_argument("--inference", default="bf16", choices=["bf16", "mxu", "mxu_fast"],
                        help="conv forward: the f32 stencil kernel (bf16 is the JAX "
                             "package's name for it), or the banded-y variants")
    parser.add_argument("--max-batch", type=str, default="1",
                        help=">1 or 'auto' enables dynamic micro-batching")
    parser.add_argument("--batch-window-ms", type=float, default=2.0,
                        help="how long the first queued request waits for company")
    parser.add_argument("--device", default=None, choices=["cuda", "cpu"],
                        help="default: cuda when a card is present, else cpu")
    args = parser.parse_args(argv)

    if args.model == "quantile":
        raise NotImplementedError("--model quantile (QuantileSceneNet) is not "
                                  "ported yet: ROADMAP A8")
    if args.mesh_ensemble != 1:
        raise NotImplementedError("--mesh-ensemble (ensemble-parallel serving) is "
                                  "not ported yet: ROADMAP A12")
    if args.max_batch.strip().lower() == "auto" or int(args.max_batch) > 1:
        raise NotImplementedError("--max-batch > 1 (the micro-batcher) is not "
                                  "ported yet: ROADMAP A10")
    inference = True if args.inference == "bf16" else args.inference
    pipeline = _Pipeline(args.checkpoint, (args.grid,) * 3, args.max_points,
                         inference=inference, device=args.device)
    server = ThreadingHTTPServer(("127.0.0.1", args.port), make_handler(pipeline))
    print(f"serving SCENE-Net (scenenet) on http://127.0.0.1:{args.port} "
          f"(grid {args.grid}³, ≤{args.max_points} pts, {pipeline.device})")
    server.serve_forever()


if __name__ == "__main__":
    main()
