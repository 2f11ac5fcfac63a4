"""Inference server: point clouds in, tower probabilities/labels out.

PyTorch twin of ``scenenet_tpu.cli.serve``: a single-process stdlib HTTP
server holding the end-to-end pipeline — padded points → on-device
occupancy (CUDA kernel) → SceneNet with the stencil-conv kernel (f32, or
the tensor-core one for ``--inference mxu``) → probabilities → optional
τ-mask and voxel→point gather.

Protocol (POST /predict):
    request body: npz with ``points`` (N, 3) float and optional ``tau``
    response body: npz with ``point_probs`` (N,), ``mask`` (N,) (if tau),
                   and ``voxel_pred`` (Z, X, Y)

``--model quantile`` serves the aleatoric-uncertainty ensemble: the
response additionally carries ``point_quantiles`` (Q, N) and
``uncertainty`` (N,), the spread between the extreme quantiles;
``point_probs``/``mask`` come from the member closest to the median.

``--max-batch B`` (with ``--batch-window-ms w``) enables dynamic
micro-batching: concurrent requests queue for up to ``w`` ms and run as
ONE batched dispatch, padded to a power-of-two bucket, pipelined so that
uploads, compute and downloads of consecutive batches overlap (see
:class:`_MicroBatcher`). ``--max-batch auto`` decides from measurements
whether and how long to coalesce. The batched path produces the same
results as the batch-1 path.

GET /healthz returns the model, grid, device, the kernels' launch counts
and, when batching, its live stats.

Usage:
    python -m scenenet_tpu_torch.cli.serve [--checkpoint ckpt.npz] [--port 8400]
"""

from __future__ import annotations

import argparse
import io
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from scenenet_tpu_torch.models.scenenet import QuantileSceneNet, SceneNet
from scenenet_tpu_torch.ops import cuda_conv, cuda_hist
from scenenet_tpu_torch.ops.voxelize import (
    batch_flat_ids, gather_point_values, voxelize_batch_occupancy,
)
from scenenet_tpu_torch.train.checkpoint import restore_checkpoint


def resolve_device(device: "str | torch.device | None") -> torch.device:
    """``None`` means ``cuda``. ``cuda`` without a card raises: the CPU is
    used only when it is asked for."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch finds no CUDA device")
    return device


class _Pipeline:
    def __init__(self, checkpoint: "str | None", grid=(64, 64, 64),
                 max_points: int = 131072, kernel_size=(9, 5, 5),
                 inference: "bool | str" = True, model: str = "scenenet",
                 quantiles=(0.1, 0.5, 0.9), max_batch: int = 1,
                 batch_window_ms: float = 2.0, warm_buckets: bool = True,
                 adaptive: bool = False,
                 device: "str | torch.device | None" = None):
        self.device = resolve_device(device)
        self.backend = "cuda" if self.device.type == "cuda" else "torch"
        self.model = model
        self.quantiles = tuple(quantiles)
        if model == "quantile":
            self.net = QuantileSceneNet.create(kernel_size=kernel_size,
                                               quantiles=self.quantiles, seed=0,
                                               backend=self.backend)
        elif model == "scenenet":
            self.net = SceneNet.create(kernel_size=kernel_size, seed=0,
                                       backend=self.backend)
        else:
            raise ValueError(f"serve supports scenenet/quantile, got {model!r}")
        if checkpoint:
            restore_checkpoint(checkpoint, self.net)
        self.net.to(self.device).eval()
        self.grid = tuple(grid)
        self.max_points = max_points
        # True: the f32 stencil forward, exact on {0,1} occupancy input;
        # "mxu" / "mxu_fast": the tensor-core stencil (near f32 / single bf16)
        self.inference = inference if inference in ("mxu", "mxu_fast") else bool(inference)
        self._batcher = None
        # the first call builds the kernels (cuda) and warms the allocator,
        # each bucket's shapes included, before any worker thread exists
        self.predict(np.zeros((16, 3), np.float32))
        if max_batch > 1:
            batcher = _MicroBatcher(self, max_batch, batch_window_ms, adaptive=adaptive)
            if warm_buckets:
                b = 1
                while b <= batcher.max_batch:
                    pts = torch.zeros((b, self.max_points, 3), device=self.device)
                    msk = torch.zeros((b, self.max_points), dtype=torch.bool,
                                      device=self.device)
                    msk[:, 0] = True
                    self.run_batch(pts, msk)
                    b *= 2
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
            batcher.start()
            self._batcher = batcher

    @torch.inference_mode()
    def run_batch(self, pts: torch.Tensor, mask: torch.Tensor):
        """(B, N, 3) f32 / (B, N) bool on the pipeline's device →
        (pred (B[, Q], Z, X, Y), probs (B[, Q], N))."""
        x = voxelize_batch_occupancy(pts, mask, self.grid)[:, None]
        pred = self.net(x, inference=self.inference)
        flat = batch_flat_ids(pts, mask, self.grid)
        if self.model == "quantile":  # (B, Q, ...): gather per member
            flat_q = flat[:, None].expand(-1, pred.shape[1], -1)
            return pred, gather_point_values(pred, flat_q, mask[:, None])
        pred = pred[:, 0]
        return pred, gather_point_values(pred, flat, mask)

    def predict(self, points: np.ndarray):
        """(N, 3) raw points → (voxel_pred, point_probs) numpy: (Z, X, Y) and
        (N,) for scenenet, (Q, Z, X, Y) and (Q, N) for the quantile
        ensemble. Points beyond ``max_points`` are dropped; the cloud is
        centred on the host (its min subtracted) before upload."""
        n = min(len(points), self.max_points)
        pts = np.zeros((self.max_points, 3), np.float32)
        mask = np.zeros(self.max_points, bool)
        pts[:n] = points[:n] - points[:n].min(0)
        mask[:n] = True
        # the upload happens here, in the caller's (handler) thread: uploads
        # of concurrent requests overlap each other and the dispatches in flight
        pts_d = torch.from_numpy(pts).to(self.device)
        mask_d = torch.from_numpy(mask).to(self.device)
        batcher = self._batcher
        if batcher is not None and not (batcher.adaptive and batcher.direct_mode()):
            pred, probs = batcher.submit(pts_d, mask_d)
            return pred, probs[..., :n]
        # batch 1 in this thread: no batcher, or its adaptive "single" phase,
        # in which concurrent handler threads dispatch in parallel like a
        # --max-batch 1 server and their completions feed the throughput probe
        if batcher is not None:
            batcher.note_direct_request()
        pred, probs = self.run_batch(pts_d[None], mask_d[None])
        pred, probs = pred[0].cpu().numpy(), probs[0, ..., :n].cpu().numpy()
        if batcher is not None:
            batcher.note_direct_completion()
        return pred, probs

    def close(self) -> None:
        """Stop the batcher's threads, if any."""
        if self._batcher is not None:
            self._batcher.close()


class _MicroBatcher:
    """Dynamic micro-batching: coalesce concurrent requests into one
    batched dispatch, pipelined so that transfers overlap the device.

    Static mode: the first queued request opens a window of ``window_ms``;
    whatever arrives before it closes (up to ``max_batch``) rides the same
    dispatch. A single request on an idle server pays at most the window
    on top of batch-1 latency; under concurrency the server moves to the
    throughput regime of the batched kernels.

    Adaptive mode (``adaptive=True``, ``--max-batch auto``): the coalescing
    decisions are made from measurements, on two levels.

    1. Whether to coalesce at all: a phase-based THROUGHPUT probe. Whether
       batching pays depends on the link and the load, and per-request
       latency cannot decide it: under saturation the queue delay divides
       by the batch size, so batched dispatches always look better per
       request even where throughput is worse. So the batcher alternates
       fixed-length phases (coalescing on/off), measures completed requests
       per second in each, commits to the winner for ``_COMMIT_LEN``
       requests, and periodically re-probes the other mode. Phases that
       straggle past ``_PHASE_MAX_S`` are low-load phases and discard their
       sample (coalescing is moot on an empty queue).
    2. Whether to WAIT for company: draining the queue is free; the window
       additionally opens only when the EWMA arrival rate predicts at
       least ``_GAIN_MIN`` more arrivals within it.

    Low load therefore behaves like static batch-1 (no window, bucket 1).

    Pipelining: handler threads upload their request *before* queueing,
    the dispatch thread only stacks device tensors and enqueues
    ``run_batch`` on the stream — it never waits for results — and a
    separate fetch thread drains the bounded, depth-2 queue of dispatches
    in flight, where ``.cpu()`` is what waits. Batch k+1 computes while
    batch k's results come back. All threads share the default stream,
    which keeps the order right.
    """

    _GAIN_MIN = 8          # open the window only if ≥ this many arrivals
    # are predicted within it
    _EWMA_ALPHA = 0.2      # arrival-interval smoothing
    _PROBE_LEN = 48        # requests per throughput-probe phase
    _COMMIT_LEN = 384      # requests to stay on the measured winner
    # before re-probing the other mode
    _PHASE_MAX_S = 10.0    # a probe phase that takes longer than this is
    # a low-load phase: discard its sample

    def __init__(self, pipeline: _Pipeline, max_batch: int,
                 window_ms: float, adaptive: bool = False):
        # round DOWN to a power of two (bucket set == warmed set): the
        # operator's --max-batch is a memory/latency CAP; dispatching
        # bigger batches than asked for is never acceptable
        b = 1
        while b * 2 <= max_batch:
            b *= 2
        self.max_batch = b
        self.window = max(window_ms, 0.0) / 1e3
        self.adaptive = adaptive
        self._stats_lock = threading.Lock()
        self.stats = {"requests": 0, "dispatches": 0,
                      "max_batch_seen": 0, "failed_dispatches": 0,
                      "windows_opened": 0}
        # EWMA of request inter-arrival time (seconds); inf = idle
        self._ewma_interval = float("inf")
        self._last_arrival = None
        self._mode = "multi"          # current phase's coalescing mode
        self._phase_len = self._PROBE_LEN
        self._phase_count = 0         # dispatches completed this phase
        self._phase_reqs = 0          # requests completed this phase
        self._phase_t0 = None         # first completion time in phase
        self._tp = {"multi": None, "single": None}  # measured req/s
        self._pipeline = pipeline
        self._q: "queue.Queue" = queue.Queue()
        self._fetch_q: "queue.Queue" = queue.Queue(maxsize=2)
        self._dispatch = threading.Thread(target=self._dispatch_loop, daemon=True)
        self._fetch = threading.Thread(target=self._fetch_loop, daemon=True)

    def start(self) -> None:
        self._dispatch.start()
        self._fetch.start()

    def close(self) -> None:
        """End both threads once what is queued has been served."""
        self._q.put(None)
        self._dispatch.join(timeout=30)
        self._fetch.join(timeout=30)

    def _note_arrival(self):
        now = time.monotonic()
        with self._stats_lock:
            if self._last_arrival is not None:
                dt = now - self._last_arrival
                prev = self._ewma_interval
                self._ewma_interval = dt if prev == float("inf") else \
                    (1 - self._EWMA_ALPHA) * prev + self._EWMA_ALPHA * dt
            self._last_arrival = now

    def _should_wait(self) -> bool:
        """Adaptive coalescing decision (adaptive mode only): wait the
        window only when the measured arrival rate predicts ≥ _GAIN_MIN
        more requests within it. A stale rate estimate expires (no
        arrival for 10×EWMA: a burst that ended must not keep opening
        windows for lone stragglers)."""
        with self._stats_lock:
            ew = self._ewma_interval
            last = self._last_arrival
        if self.window <= 0 or ew == float("inf") or ew <= 0:
            return False
        if last is not None and time.monotonic() - last > 10 * ew:
            return False
        return self.window / ew >= self._GAIN_MIN

    def _should_coalesce(self) -> bool:
        """Adaptive: follow the current throughput-probe phase."""
        with self._stats_lock:
            return self._mode == "multi"

    def direct_mode(self) -> bool:
        """True while the probe has the server in its "single" phase:
        handler threads dispatch batch-1 directly (in parallel), bypassing
        the batcher; leftovers already queued keep draining."""
        with self._stats_lock:
            return self._mode == "single"

    def note_direct_request(self) -> None:
        self._note_arrival()
        with self._stats_lock:
            self.stats["requests"] += 1
            self.stats["direct_requests"] = self.stats.get("direct_requests", 0) + 1

    def note_direct_completion(self) -> None:
        self._note_completion(1)

    @staticmethod
    def _other(mode: str) -> str:
        return "single" if mode == "multi" else "multi"

    def _note_completion(self, n_requests: int) -> None:
        """Fetch-side phase accounting: count completed requests; at the
        phase's request quota, measure its throughput and pick the next
        phase: probe the unmeasured/other mode, or commit to the
        measured winner for _COMMIT_LEN requests."""
        now = time.monotonic()
        with self._stats_lock:
            if self._phase_t0 is None:
                self._phase_t0 = now
            self._phase_reqs += n_requests
            self._phase_count += 1
            if self._phase_reqs < self._phase_len:
                return
            wall = now - self._phase_t0
            mode = self._mode
            if 0 < wall <= self._PHASE_MAX_S and self._phase_count > 1:
                self._tp[mode] = self._phase_reqs / wall
            # else: low-load/idle phase, the sample is discarded
            tp_m, tp_s = self._tp["multi"], self._tp["single"]
            if tp_m is None or tp_s is None:
                nxt, ln = self._other(mode), self._PROBE_LEN
            else:
                best = "multi" if tp_m >= tp_s else "single"
                if mode == best:
                    # been committed: re-probe the other mode briefly
                    nxt, ln = self._other(mode), self._PROBE_LEN
                else:
                    nxt, ln = best, self._COMMIT_LEN
            self._mode, self._phase_len = nxt, ln
            self._phase_count = 0
            self._phase_reqs = 0
            self._phase_t0 = None

    def submit(self, pts: torch.Tensor, mask: torch.Tensor):
        """pts (N, 3) / mask (N,) are tensors on the pipeline's device (the
        caller paid the upload in its own thread); returns this request's
        numpy (pred, probs)."""
        if self.adaptive:
            self._note_arrival()
        done = threading.Event()
        slot = {"done": done}
        self._q.put((pts, mask, slot))
        # bounded wait: if a worker thread ever dies, surface an error to
        # this request instead of wedging the handler thread forever
        while not done.wait(timeout=5.0):
            if not (self._dispatch.is_alive() and self._fetch.is_alive()):
                raise RuntimeError("micro-batcher worker thread died; restart the server")
        if "exc" in slot:
            raise slot["exc"]
        return slot["result"]

    @staticmethod
    def _fail(batch, exc):
        # per-slot exception instances: several handler threads re-raise
        # concurrently, and `raise` mutates the exception's __traceback__
        for _, _, slot in batch:
            wrapped = RuntimeError(f"batched inference failed: {exc!r}")
            wrapped.__cause__ = exc
            slot["exc"] = wrapped
            slot["done"].set()

    def _dispatch_loop(self):
        while True:
            first = self._q.get()
            if first is None:  # close()
                self._fetch_q.put(None)
                return
            batch = [first]
            closing = False
            # the WHOLE iteration is guarded: any exception fails this
            # batch's slots (handlers return 500) instead of killing the
            # thread and wedging every later request
            try:
                if self.adaptive:
                    coalesce = self._should_coalesce()
                    wait = coalesce and self._should_wait()
                    if wait:
                        with self._stats_lock:
                            self.stats["windows_opened"] += 1
                else:
                    coalesce, wait = True, True
                if coalesce:
                    deadline = time.monotonic() + (self.window if wait else 0.0)
                    while len(batch) < self.max_batch:
                        left = deadline - time.monotonic()
                        if left <= 0 and self._q.empty():
                            break
                        try:
                            item = self._q.get(timeout=max(left, 0))
                        except queue.Empty:
                            break
                        if item is None:
                            closing = True
                            break
                        batch.append(item)
                n = len(batch)
                bucket = 1
                while bucket < n:
                    bucket *= 2
                # bucket-pad by repeating request 0's device tensors: the
                # padding rows cost no upload
                rows_p = [b[0] for b in batch] + [batch[0][0]] * (bucket - n)
                rows_m = [b[1] for b in batch] + [batch[0][1]] * (bucket - n)
                pred, probs = self._pipeline.run_batch(torch.stack(rows_p),
                                                       torch.stack(rows_m))
                # slice the padding rows off ON THE DEVICE so only live
                # results are downloaded at fetch time
                pred, probs = pred[:n], probs[:n]
                # stats AFTER the dispatch call succeeds: a batch that
                # fails must not count as served work
                with self._stats_lock:  # healthz snapshots under this lock
                    self.stats["requests"] += n
                    self.stats["dispatches"] += 1
                    self.stats["max_batch_seen"] = max(self.stats["max_batch_seen"], n)
            except Exception as exc:  # shape and launch errors surface here
                with self._stats_lock:
                    self.stats["failed_dispatches"] += 1
                self._fail(batch, exc)
            else:
                # the device works on; hand over to the fetcher and go
                # collect the next batch (bounded queue = backpressure)
                self._fetch_q.put((batch, pred, probs))
            if closing:
                self._fetch_q.put(None)
                return

    def _fetch_loop(self):
        while True:
            item = self._fetch_q.get()
            if item is None:  # close()
                return
            batch, pred, probs = item
            try:
                pred, probs = pred.cpu().numpy(), probs.cpu().numpy()
                results = [(pred[i], probs[i]) for i in range(len(batch))]
                if self.adaptive:
                    # completed requests drive the throughput probe
                    self._note_completion(len(batch))
            except Exception as exc:  # errors of the run surface at the copy
                self._fail(batch, exc)
                continue
            for (_, _, slot), res in zip(batch, results):
                slot["result"] = res
                slot["done"].set()

    def stats_snapshot(self) -> dict:
        """Mutually consistent copy of the counters (healthz derives the
        average batch as requests/dispatches)."""
        with self._stats_lock:
            out = dict(self.stats)
            if self.adaptive:
                out["coalesce_mode"] = self._mode
                out["tp_multi_rps"] = (round(self._tp["multi"], 1)
                                       if self._tp["multi"] else None)
                out["tp_single_rps"] = (round(self._tp["single"], 1)
                                        if self._tp["single"] else None)
            return out


def kernel_launches() -> dict:
    return {c.name: c.count for c in (cuda_hist.LAUNCHES, cuda_hist.SORTED_COUNTS_LAUNCHES,
                                      cuda_conv.LAUNCHES, cuda_conv.MXU_LAUNCHES)}


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
            if pipeline.model == "quantile":
                info["quantiles"] = list(pipeline.quantiles)
            if pipeline._batcher is not None:
                info["batching"] = dict(
                    pipeline._batcher.stats_snapshot(),
                    max_batch=pipeline._batcher.max_batch,
                    mode="adaptive" if pipeline._batcher.adaptive else "static")
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

            if probs.ndim == 2:  # quantile ensemble (Q, N)
                med = int(np.argmin(np.abs(np.asarray(pipeline.quantiles) - 0.5)))
                payload = {
                    "point_probs": probs[med],
                    "point_quantiles": probs,
                    # spread between the extreme quantiles
                    "uncertainty": probs.max(0) - probs.min(0),
                    "voxel_pred": pred,
                }
                probs = probs[med]
            else:
                payload = {"point_probs": probs, "voxel_pred": pred}
            if tau is not None:
                payload["mask"] = (probs >= tau).astype(np.float32)
            out = io.BytesIO()
            np.savez_compressed(out, **payload)
            self._reply(200, out.getvalue(), "application/octet-stream",
                        [("X-Latency-Ms", f"{latency * 1e3:.2f}")])

    return Handler


def build_server(argv=None):
    """Parse the command line and build (server, pipeline), not yet serving."""
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
                             "package's name for it), the tensor-core stencil with the "
                             "split-bf16 kernel (mxu, near f32) or single bf16 (mxu_fast)")
    parser.add_argument("--max-batch", type=str, default="1",
                        help=">1 enables dynamic micro-batching: concurrent requests "
                             "coalesce into one batched dispatch (power-of-two buckets, "
                             "warmed at startup; non-powers round DOWN: this is a cap). "
                             "'auto' = adaptive mode (cap 32)")
    parser.add_argument("--batch-window-ms", type=float, default=2.0,
                        help="how long the first queued request waits for company")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cpu runs the kernels' plain versions")
    args = parser.parse_args(argv)

    if args.mesh_ensemble != 1:
        raise NotImplementedError("--mesh-ensemble (ensemble-parallel serving) is "
                                  "not ported yet: ROADMAP A12")
    inference = True if args.inference == "bf16" else args.inference
    quantiles = tuple(float(q) for q in args.quantiles.split(","))
    adaptive = args.max_batch.strip().lower() == "auto"
    max_batch = 32 if adaptive else int(args.max_batch)
    pipeline = _Pipeline(args.checkpoint, (args.grid,) * 3, args.max_points,
                         inference=inference, model=args.model, quantiles=quantiles,
                         max_batch=max_batch, batch_window_ms=args.batch_window_ms,
                         adaptive=adaptive, device=args.device)
    server = ThreadingHTTPServer(("127.0.0.1", args.port), make_handler(pipeline))
    batching = (f", micro-batching ≤{pipeline._batcher.max_batch} @ "
                f"{args.batch_window_ms} ms{' (adaptive)' if adaptive else ''}"
                if pipeline._batcher is not None else "")
    print(f"serving SCENE-Net ({args.model}) on "
          f"http://127.0.0.1:{server.server_address[1]} "
          f"(grid {args.grid}³, ≤{args.max_points} pts, {pipeline.device}{batching})")
    return server, pipeline


def main(argv=None):
    server, pipeline = build_server(argv)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        pipeline.close()


if __name__ == "__main__":
    main()
