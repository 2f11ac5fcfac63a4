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
``--mesh-ensemble m`` splits the ensemble's Q members into m groups, one on
each of the first m CUDA devices (ensemble parallelism,
:mod:`~scenenet_tpu_torch.parallel.ep`): each group convolves its members,
and the (Q, Z, X, Y) prediction is concatenated on the serving device. It
raises, naming the count, where fewer than m cards are visible. The JAX
server forms its mesh from the first m devices inside its one process; so
does this one, with no rank processes. ``_Pipeline(devices=...)`` places
the groups on given devices (the same card m times, or the CPU). Where
every group is on the serving device, a dispatch is still one CUDA graph a
bucket; with groups on other cards it runs eagerly.

``--max-batch B`` (with ``--batch-window-ms w``) enables dynamic
micro-batching: concurrent requests queue for up to ``w`` ms and run as
ONE batched dispatch, padded to a power-of-two bucket, pipelined so that
uploads, compute and downloads of consecutive batches overlap (see
:class:`_MicroBatcher`). ``--max-batch auto`` decides from measurements
whether and how long to coalesce. The batched path produces the same
results as the batch-1 path.

On a card every bucket the server warms (batch 1 always; with
``--max-batch`` every power of two up to it) is captured at start-up as one
CUDA graph of :meth:`_Pipeline.run_batch` (:class:`_BucketGraph`), the
counterpart of the JAX server's executable per bucket: a dispatch copies
the rows into the bucket's static inputs, replays the graph, and copies
its static outputs on the device, so that the next replay cannot overwrite
what the fetch thread still has to download. On the CPU
``run_batch`` runs eagerly.

GET /healthz returns the model, grid, device, the kernels' launch counts
(the wrappers' own counts plus the launches that the graph replays ran),
under ``stages`` the count, sum and max seconds of each host stage of a
request (the handler's parse, predict and compress; when batching, the
batcher's queue wait, window, dispatch and fetch) and, when batching, its
live stats.

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
from scenenet_tpu_torch.ops._build import launch_counts
from scenenet_tpu_torch.ops.voxelize import (
    batch_flat_ids, gather_point_values, voxelize_batch_occupancy,
)
from scenenet_tpu_torch.train.checkpoint import restore_checkpoint
from scenenet_tpu_torch.train.step_graph import WARMUP, StepGraph
from scenenet_tpu_torch.utils.profiling import Stage, phase, span

# the kernels on the serving path
SERVE_KERNELS = ("points_occupancy", "sorted_bin_counts", "stencil_conv", "stencil_mma")


def resolve_device(device: "str | torch.device | None") -> torch.device:
    """``None`` means ``cuda``. ``cuda`` without a card raises: the CPU is
    used only when it is asked for."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch finds no CUDA device")
    return device


def _canonical(device: torch.device) -> torch.device:
    """``cuda`` as the card it means (the current one)."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def wrapper_launches() -> dict:
    """The serving path's wrappers' own launch counts, by kernel."""
    counts = launch_counts()
    return {k: counts[k] for k in SERVE_KERNELS}


def _warm_inputs(b: int, max_points: int, device: torch.device):
    """A batch of ``b`` padded clouds of one point each, for warming."""
    pts = torch.zeros((b, max_points, 3), device=device)
    mask = torch.zeros((b, max_points), dtype=torch.bool, device=device)
    mask[:, 0] = True
    return pts, mask


class _BucketGraph:
    """``run_batch`` of one bucket captured as a CUDA graph, with its static
    inputs and outputs: the counterpart of one executable of the JAX
    server's ``jax.jit`` per bucket.

    :class:`~scenenet_tpu_torch.train.step_graph.StepGraph` makes it:
    ``WARMUP`` eager runs on a side stream, then the capture (a failed
    capture raises), in its own memory pool. Kernel synthesis from the
    parameters is inside the graph, so a restored checkpoint (copied into
    the parameters in place) takes effect at the next replay.

    A call holds the bucket's lock around copy-in, replay and copy-out: the
    static buffers are shared by every thread that dispatches this bucket
    (the dispatch thread, and handler threads in the adaptive "single"
    phase). All three are enqueued on the one stream, so the lock orders
    only the enqueueing. The copies out are made on the stream right after
    the replay, so that the next replay cannot overwrite what the fetch
    thread still has to download. ``launches`` are the serving wrappers'
    launches that the capture recorded, which every replay runs again
    without calling a wrapper; ``replays`` the calls since start-up.
    """

    def __init__(self, run, bucket: int, max_points: int, device: torch.device):
        self.pts, self.mask = _warm_inputs(bucket, max_points, device)
        self.out = None
        self.lock = threading.Lock()

        def step():
            self.out = run(self.pts, self.mask)

        self.graph = StepGraph(step, device, counts=wrapper_launches)
        for _ in range(WARMUP + 1):  # the warm-ups, then the capture and one replay
            self.graph()

    @property
    def launches(self) -> dict:
        return self.graph.launches

    @property
    def replays(self) -> int:
        return self.graph.later_calls

    def __call__(self, pts: torch.Tensor, mask: torch.Tensor):
        with self.lock:
            self.pts.copy_(pts)
            self.mask.copy_(mask)
            self.graph()
            return tuple(t.clone() for t in self.out)


class _Pipeline:
    def __init__(self, checkpoint: "str | None", grid=(64, 64, 64),
                 max_points: int = 131072, kernel_size=(9, 5, 5),
                 inference: "bool | str" = True, model: str = "scenenet",
                 quantiles=(0.1, 0.5, 0.9), max_batch: int = 1,
                 batch_window_ms: float = 2.0, warm_buckets: bool = True,
                 adaptive: bool = False,
                 device: "str | torch.device | None" = None, mesh_ensemble: int = 1,
                 devices=None):
        self.device = resolve_device(device)
        self.backend = "cuda" if self.device.type == "cuda" else "torch"
        self.model = model
        self.quantiles = tuple(quantiles)
        self.mesh_ensemble = int(mesh_ensemble)
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
        # ensemble parallelism: (device, member indices) of each group
        self._groups = self._ensemble_groups(devices) if self.mesh_ensemble > 1 else None
        self.grid = tuple(grid)
        self.max_points = max_points
        # True: the f32 stencil forward, exact on {0,1} occupancy input;
        # "mxu" / "mxu_fast": the tensor-core stencil (near f32 / single bf16)
        self.inference = inference if inference in ("mxu", "mxu_fast") else bool(inference)
        self._batcher = None
        self._graphs = {}  # bucket -> _BucketGraph (on a card)
        # the first call builds the kernels (cuda) and warms the allocator; then
        # every bucket is warmed (on a card: captured), all before any worker
        # thread exists
        self.predict(np.zeros((16, 3), np.float32))
        batcher = (_MicroBatcher(self, max_batch, batch_window_ms, adaptive=adaptive)
                   if max_batch > 1 else None)
        buckets = [1]
        while batcher is not None and warm_buckets and buckets[-1] * 2 <= batcher.max_batch:
            buckets.append(buckets[-1] * 2)
        # one graph a bucket where every kernel runs on the serving card
        capture = self.device.type == "cuda" and all(
            _canonical(d) == _canonical(self.device) for d, _ in (self._groups or ()))
        with phase("snt/serve/warm_buckets"), torch.inference_mode():
            for b in buckets:
                if capture:
                    self._graphs[b] = _BucketGraph(self._run, b, max_points, self.device)
                elif (batcher is not None and warm_buckets) or self.device.type == "cuda":
                    self.run_batch(*_warm_inputs(b, max_points, self.device))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        if batcher is not None:
            batcher.start()
            self._batcher = batcher

    def _ensemble_groups(self, devices):
        """The members split into ``mesh_ensemble`` groups, each moved to its
        device: the first ``mesh_ensemble`` CUDA devices by default (the CPU
        m times on a CPU pipeline)."""
        m = self.mesh_ensemble
        if self.model != "quantile":
            raise ValueError(f"--mesh-ensemble {m} shards the quantile ensemble's members; "
                             f"model {self.model!r} has none")
        q = len(self.quantiles)
        if q % m:
            raise ValueError(f"{q} ensemble members do not divide over the mesh 'model' axis "
                             f"({m}); choose a divisible quantile count")
        if devices is None:
            if self.device.type == "cuda":
                seen = torch.cuda.device_count()
                if seen < m:
                    raise RuntimeError(f"--mesh-ensemble {m} needs {m} CUDA devices; "
                                       f"{seen} visible")
                devices = [torch.device("cuda", i) for i in range(m)]
            else:
                devices = [self.device] * m
        devices = [torch.device(d) for d in devices]
        if len(devices) != m:
            raise ValueError(f"--mesh-ensemble {m} takes {m} devices, got {len(devices)}")
        groups = []
        for g, dev in enumerate(devices):
            members = list(range(g * q // m, (g + 1) * q // m))
            for i in members:
                self.net.members[i].to(dev)
            groups.append((dev, members))
        return groups

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        """The model on the occupancy grids; an ensemble split into groups
        runs each group on its device and concatenates the members here."""
        if self._groups is None:
            return self.net(x, inference=self.inference)
        from scenenet_tpu_torch.parallel.ep import local_ensemble_forward

        return torch.cat([local_ensemble_forward(self.net, x.to(dev), members,
                                                 inference=self.inference).to(self.device)
                          for dev, members in self._groups], dim=1)

    @torch.inference_mode()
    def run_batch(self, pts: torch.Tensor, mask: torch.Tensor):
        """(B, N, 3) f32 / (B, N) bool on the pipeline's device →
        (pred (B[, Q], Z, X, Y), probs (B[, Q], N)), tensors that the caller
        owns. A bucket captured at start-up replays its graph and returns
        copies of its static outputs; any other batch runs eagerly."""
        with span("snt/serve/dispatch"):
            graph = self._graphs.get(pts.shape[0])
            if graph is not None:
                return graph(pts, mask)
            return self._run(pts, mask)

    def _run(self, pts: torch.Tensor, mask: torch.Tensor):
        """The pipeline on a batch: occupancy, SceneNet (kernel synthesis
        included), the ids and the voxel→point gather."""
        x = voxelize_batch_occupancy(pts, mask, self.grid)[:, None]
        pred = self._forward(x)
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

    def kernel_launches(self) -> dict:
        """The serving path's launches by kernel: the wrappers' own counts
        plus what every captured bucket's replays ran."""
        out = wrapper_launches()
        for g in self._graphs.values():
            for k, v in g.graph.replay_launches().items():
                out[k] += v
        return out

    def graph_replays(self) -> dict:
        """Replays so far of each captured bucket's graph."""
        return {b: g.replays for b, g in sorted(self._graphs.items())}

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

    ``stages`` times each request's way through, on the host clock:
    ``queue_wait`` (submitted → taken by the dispatch thread), ``window``
    (taken → its batch closed), ``dispatch`` (its batch stacked and handed
    to ``run_batch``) and ``fetch`` (its batch's download).
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
        self.stages = {k: Stage() for k in ("queue_wait", "window", "dispatch", "fetch")}
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
        slot = {"done": done, "submitted": time.perf_counter()}
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
            first[2]["taken"] = time.perf_counter()
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
                        item[2]["taken"] = time.perf_counter()
                        batch.append(item)
                closed = time.perf_counter()
                for _, _, slot in batch:
                    self.stages["queue_wait"].add(slot["taken"] - slot["submitted"])
                    self.stages["window"].add(closed - slot["taken"])
                n = len(batch)
                bucket = 1
                while bucket < n:
                    bucket *= 2
                # bucket-pad by repeating request 0's device tensors: the
                # padding rows cost no upload
                rows_p = [b[0] for b in batch] + [batch[0][0]] * (bucket - n)
                rows_m = [b[1] for b in batch] + [batch[0][1]] * (bucket - n)
                # the outputs are the caller's own (a graph's static outputs,
                # which the next replay overwrites, are copied on the device);
                # slice the padding rows off there so that only live results
                # are downloaded at fetch time
                pred, probs = self._pipeline.run_batch(torch.stack(rows_p),
                                                       torch.stack(rows_m))
                pred, probs = pred[:n], probs[:n]
                self.stages["dispatch"].add(time.perf_counter() - closed, n)
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
                t0 = time.perf_counter()
                pred, probs = pred.cpu().numpy(), probs.cpu().numpy()
                self.stages["fetch"].add(time.perf_counter() - t0, len(batch))
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


def make_handler(pipeline: _Pipeline):
    # the host-clock stages of a request in the handler's thread; /healthz
    # reports them beside the batcher's
    stages = {k: Stage() for k in ("parse", "predict", "compress")}

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
                "kernel_launches": pipeline.kernel_launches(),
                "graph_replays": pipeline.graph_replays(),
            }
            timed = dict(stages, **(pipeline._batcher.stages if pipeline._batcher else {}))
            info["stages"] = {k: v.snapshot() for k, v in timed.items()}
            if pipeline.model == "quantile":
                info["quantiles"] = list(pipeline.quantiles)
                info["mesh_ensemble"] = pipeline.mesh_ensemble
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
            t0 = time.perf_counter()
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
            stages["parse"].add(time.perf_counter() - t0)

            try:
                t0 = time.perf_counter()
                pred, probs = pipeline.predict(points)
                latency = time.perf_counter() - t0
                stages["predict"].add(latency)
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
            t0 = time.perf_counter()
            out = io.BytesIO()
            np.savez_compressed(out, **payload)
            stages["compress"].add(time.perf_counter() - t0)
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
                        help="shard the quantile ensemble's members over this many CUDA "
                             "devices")
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

    inference = True if args.inference == "bf16" else args.inference
    quantiles = tuple(float(q) for q in args.quantiles.split(","))
    adaptive = args.max_batch.strip().lower() == "auto"
    max_batch = 32 if adaptive else int(args.max_batch)
    pipeline = _Pipeline(args.checkpoint, (args.grid,) * 3, args.max_points,
                         inference=inference, model=args.model, quantiles=quantiles,
                         max_batch=max_batch, batch_window_ms=args.batch_window_ms,
                         adaptive=adaptive, device=args.device,
                         mesh_ensemble=args.mesh_ensemble)
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
