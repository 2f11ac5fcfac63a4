"""The port's tracing (``scenenet_tpu_torch/utils/profiling.py``): spans
that cost one check with no profiler running, the spans and phases at the
train loop, the loaders and the served dispatch as a CPU profiler records
them, the graphs' launch bookkeeping, the serving stages' aggregates on
``/healthz``, and ``perfbench/spans.py``'s readers on hand-built traces.

All on the CPU at a tiny size (16³ grid, batch 2, 1024 points): the cached
steps run eagerly here, as on a card before their graph's capture.
"""

import io
import json
import os
import threading
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from perfbench import spans as pspans
from perfbench import spec
from perfbench.trace import Trace
from scenenet_tpu_torch import native
from scenenet_tpu_torch.cli import serve as tserve
from scenenet_tpu_torch.data import TS40K, NativePointCloudLoader, PointCloudLoader
from scenenet_tpu_torch.losses import resolve_criterion
from scenenet_tpu_torch.models import SceneNet
from scenenet_tpu_torch.ops._build import launch_counts
from scenenet_tpu_torch.train import TrainConfig, Trainer, make_device_voxelize_prep
from scenenet_tpu_torch.train.loop import CachedEpochs
from scenenet_tpu_torch.train.metrics import init_metric_state
from scenenet_tpu_torch.train.step_graph import WARMUP, StepGraph
from scenenet_tpu_torch.utils import profiling

GRID = (16, 16, 16)
POINTS = 1024
BATCH = 2
CPU = torch.device("cpu")
DEFAULTS = dict(weight_alpha=1, weight_epsilon=0.1, mse_weight=1, convex_weight=5,
                tversky_alpha=2, tversky_beta=1, tversky_smooth=1e-6, focal_gamma=4)


def _clouds(seed, n):
    """n padded clouds (points, labels, mask) of 600-1024 points."""
    rng = np.random.default_rng(seed)
    pts = np.zeros((n, POINTS, 3), np.float32)
    labels = np.zeros((n, POINTS), np.int32)
    mask = np.zeros((n, POINTS), bool)
    for i in range(n):
        m = int(rng.integers(600, POINTS + 1))
        pts[i, :m] = rng.uniform(0, 16, (m, 3))
        labels[i, :m] = rng.choice([1, 15], size=m, p=[0.8, 0.2])
        mask[i, :m] = True
    return pts, labels, mask


def _trainer(tmp_path):
    config = TrainConfig(run_dir=str(tmp_path / "run"), checkpoint_dir=str(tmp_path / "ckpt"),
                         early_stop_metric=None, max_epochs=1)
    return Trainer(SceneNet.create(kernel_size=(9, 5, 5), seed=3, backend="torch"),
                   resolve_criterion("geneo_tversky")(**DEFAULTS), config,
                   batch_prep=make_device_voxelize_prep(GRID, (15,), use_indices=False))


def _train_steps(tmp_path):
    """Two ``Trainer.train_step`` calls."""
    trainer = _trainer(tmp_path)
    trainer.setup_optimizer()
    batch = tuple(torch.from_numpy(a) for a in _clouds(1, BATCH))

    def run():
        mstate = init_metric_state(CPU)
        for _ in range(2):
            mstate, _ = trainer.train_step(mstate, *batch)
        return 2

    return run


def _cached_epoch(tmp_path):
    """One epoch of ``CachedEpochs``, 2 chunks of 2 steps."""
    trainer = _trainer(tmp_path)
    trainer.config.epoch_chunks = 2
    pts, labels, mask = (torch.from_numpy(a) for a in _clouds(2, 4 * BATCH))
    x, y = trainer.batch_prep(pts, labels, mask)
    epochs = CachedEpochs(trainer, 4 * BATCH, BATCH, lambda gen, n: {},
                          lambda rows, draws, cursor: (x.index_select(0, rows),
                                                       y.index_select(0, rows)),
                          torch.Generator().manual_seed(0))

    def run():
        epochs.run_epoch()
        # no replay on the CPU
        assert epochs.replay_launches() == dict.fromkeys(launch_counts(), 0)
        assert epochs.kernel_launches() == launch_counts()
        return epochs.n_batches

    return run


def _loader(tmp_path, kind):
    """The loader of ``kind`` over 5 crops in batches of 2 (the native one,
    or the Python one where the native library is absent)."""
    if kind == "native" and native.available():
        root = tmp_path / "ts40k"
        (root / "fit").mkdir(parents=True)
        pts, labels, mask = _clouds(3, 5)
        for i in range(5):
            m = int(mask[i].sum())
            np.save(root / "fit" / f"sample_{i}.npy",
                    np.concatenate([pts[i, :m], labels[i, :m, None]], 1).astype(np.float64))
        return NativePointCloudLoader(TS40K(str(root), split="fit"), BATCH, max_points=POINTS,
                                      threads=1)
    pts, labels, mask = _clouds(3, 5)
    rows = [(pts[i], labels[i], mask[i], np.zeros(POINTS, np.int32)) for i in range(5)]
    return PointCloudLoader(rows, BATCH, num_workers=1)


def _loader_epoch(tmp_path, kind):
    """One epoch of the loader: 3 batches."""
    loader = _loader(tmp_path, kind)
    return lambda: sum(1 for _ in loader)


def _dispatches(tmp_path):
    """Three ``_Pipeline.run_batch`` calls on the CPU."""
    p = tserve._Pipeline(None, grid=GRID, max_points=POINTS, device="cpu")
    batch = tserve._warm_inputs(2, POINTS, CPU)

    def run():
        for _ in range(3):
            p.run_batch(*batch)
        return 3

    return run


CASES = {"train_step": _train_steps, "cached_epoch": _cached_epoch,
         "python_loader": lambda tmp: _loader_epoch(tmp, "python"),
         "native_loader": lambda tmp: _loader_epoch(tmp, "native"),
         "dispatch": _dispatches}


@pytest.mark.parametrize("case", CASES)
def test_no_profiler_enters_no_record_function(case, tmp_path, monkeypatch):
    def refused(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    assert not torch.autograd._profiler_enabled()
    assert CASES[case](tmp_path)() > 0


def _traced(case, tmp_path):
    """``case``'s work (made ready first) under a CPU ``torch.profiler``:
    its count and the program spans of the exported trace, by name."""
    from torch.profiler import ProfilerActivity, profile

    run = CASES[case](tmp_path)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        count = run()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return count, pspans.program_spans(Trace(events, 1.0))


def _inside(inner, outer):
    return all(any(s <= a and b <= f for s, f in outer) for a, b in inner)


@pytest.mark.parametrize("case", CASES)
def test_a_profiler_records_the_spans_nested(case, tmp_path):
    count, found = _traced(case, tmp_path)
    assert all(name.startswith("snt/") for name in found)
    if case == "train_step":
        steps = found["snt/train/step"]
        assert len(steps) == count and len(found["snt/train/backward"]) == count
        assert len(found["snt/train/forward"]) == count
        assert _inside(found["snt/train/forward"], steps)
        assert _inside(found["snt/train/backward"], steps)
    elif case == "cached_epoch":
        assert len(found["snt/train/chunk"]) == 2 and len(found["snt/train/step"]) == count
        assert _inside(found["snt/train/step"], found["snt/train/chunk"])
        assert _inside(found["snt/train/forward"], found["snt/train/step"])
    elif case.endswith("loader"):
        assert set(found) == {"snt/data/loader_wait"}
        assert len(found["snt/data/loader_wait"]) == count == 3
    else:
        assert set(found) == {"snt/serve/dispatch"} and len(found["snt/serve/dispatch"]) == count


@pytest.mark.parametrize("name", ["snt/train/setup_optimizer", "snt/serve/warm_buckets"])
def test_phase_seconds_grow_across_the_phase(name, tmp_path):
    before = profiling.phase_seconds().get(name, 0.0)
    if name == "snt/train/setup_optimizer":
        _trainer(tmp_path).setup_optimizer()
    else:
        tserve._Pipeline(None, grid=GRID, max_points=POINTS, max_batch=2, device="cpu").close()
    assert profiling.phase_seconds()[name] > before


def test_a_phase_counts_its_time_when_the_block_raises():
    before = profiling.phase_seconds().get("snt/test/raises", 0.0)
    with pytest.raises(ValueError):
        with profiling.phase("snt/test/raises"):
            raise ValueError("inside the phase")
    assert profiling.phase_seconds()["snt/test/raises"] > before


def test_trace_with_a_file_writes_that_chrome_trace_alone(tmp_path):
    with profiling.trace(str(tmp_path / "t"), "epoch0_trace.json"):
        with profiling.span("snt/test/span"):
            torch.ones(4) + 1
    assert os.listdir(tmp_path / "t") == ["epoch0_trace.json"]
    with open(tmp_path / "t" / "epoch0_trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "snt/test/span" in names


# ---- the graphs' launch bookkeeping --------------------------------------------------

def test_step_graph_replay_launches_leave_out_the_capture():
    """The capture counts its recorded launches once and runs none; each
    replay runs them all."""
    graph = StepGraph(lambda: None, CPU)
    assert graph.launches == dict.fromkeys(launch_counts(), 0)
    assert {"points_occupancy", "stencil_conv", "conv3d_mc"} <= set(graph.launches)
    graph.launches = {"stencil_conv": 2, "stencil_dk": 1}
    assert graph.replay_launches() == {"stencil_conv": 0, "stencil_dk": 0}
    graph.eager_calls, graph.replays = WARMUP, 1  # as on a card: warmed, captured, replayed
    assert graph.later_calls == 0
    assert graph.replay_launches() == {"stencil_conv": 0, "stencil_dk": 0}
    graph.replays = 4
    assert graph.later_calls == 3
    assert graph.replay_launches() == {"stencil_conv": 6, "stencil_dk": 3}


def test_bucket_graph_counts_calls_since_start_up_on_the_graphs_counters():
    p = tserve._Pipeline(None, grid=GRID, max_points=POINTS, device="cpu")
    graph = tserve._BucketGraph(p._run, 1, POINTS, CPU)
    assert graph.replays == 0 and graph.launches is graph.graph.launches
    assert set(graph.launches) == set(tserve.wrapper_launches())
    graph(*tserve._warm_inputs(1, POINTS, CPU))
    assert graph.replays == 1 and graph.graph.eager_calls == tserve.WARMUP + 2


# ---- the serving stages --------------------------------------------------------------

def test_one_request_moves_every_stage_count_by_one():
    p = tserve._Pipeline(None, grid=GRID, max_points=POINTS, max_batch=2, batch_window_ms=0.0,
                         device="cpu")
    srv = ThreadingHTTPServer(("127.0.0.1", 0), tserve.make_handler(p))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"

    def health():
        with urllib.request.urlopen(f"{url}/healthz", timeout=60) as r:
            return json.loads(r.read())

    try:
        before = health()
        buf = io.BytesIO()
        np.savez(buf, points=np.random.default_rng(4).uniform(0, 9, (300, 3)))
        req = urllib.request.Request(f"{url}/predict", data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            assert r.status == 200
        after = health()
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
        p.close()
    assert not thread.is_alive()
    stages = ("parse", "predict", "compress", "queue_wait", "window", "dispatch", "fetch")
    assert set(after["stages"]) == set(stages)
    for k in stages:
        assert after["stages"][k]["count"] - before["stages"][k]["count"] == 1, k
        assert after["stages"][k]["max_s"] >= 0.0
    assert after["batching"]["requests"] == 1


def test_stage_keeps_count_sum_and_max_under_threads():
    stage = profiling.Stage()

    def add():
        for _ in range(500):
            stage.add(0.001, 2)

    threads = [threading.Thread(target=add) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    got = stage.snapshot()
    assert got["count"] == 8000 and got["max_s"] == 0.001
    assert got["sum_s"] == pytest.approx(8.0)


# ---- perfbench/spans.py on hand-built traces -----------------------------------------

def _event(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _idle_trace():
    """Two chunks on the loop's thread, each opening with a step, and a
    host that runs ahead: B is launched in the first chunk's first step, D
    inside the first chunk and runs after it closed, E at the epoch's edge,
    F inside the second chunk after its first step, G by no launch call
    found. The device is busy 320 of a 1000 µs window; of the 680 idle,
    570 wait for work launched inside a chunk, 70 of them (B's) in its
    first step."""
    host = [_event("user_annotation", "snt/train/chunk", 100, 200),
            _event("user_annotation", "snt/train/step", 105, 40),
            _event("user_annotation", "snt/train/step", 150, 100),
            _event("user_annotation", "snt/train/chunk", 600, 100),
            _event("user_annotation", "snt/train/step", 605, 30),
            _event("cuda_runtime", "cudaDeviceSynchronize", 960, 40)]
    ops = (("A", 5, 20, 30), ("B", 110, 120, 80), ("C", 160, 250, 10), ("D", 290, 400, 50),
           ("E", 500, 520, 40), ("G", None, 580, 10), ("F", 650, 900, 100))
    for corr, (name, launched, ts, dur) in enumerate(ops):
        if launched is not None:
            host.append(_event("cuda_runtime", "cudaLaunchKernel", launched, 2, corr=corr))
        host.append(_event("kernel", name, ts, dur, tid=7, corr=corr))
    return Trace(host, 1000e-6)


@pytest.mark.parametrize("first, inside_us", [(None, 570), ("snt/train/step", 500)])
def test_the_idle_split_partitions_the_windows_idle_by_launch(first, inside_us):
    trace = _idle_trace()
    inside, outside = pspans.idle_split(trace, "snt/train/chunk", first)
    assert inside == pytest.approx(inside_us * 1e-6, abs=1e-12)
    assert outside == pytest.approx((680 - inside_us) * 1e-6, abs=1e-12)
    assert inside + outside == pytest.approx(trace.window_s - trace.busy_s(), abs=1e-12)
    assert pspans.idle_split(trace, "snt/data/loader_wait") is None
    # a chunk in which no first span starts counts as outside whole
    assert pspans.idle_split(trace, "snt/train/chunk", "snt/train/forward") == pytest.approx(
        (0.0, 680e-6), abs=1e-12)


def _launch_trace():
    """A step with its forward and backward on the loop's thread (tid 1);
    launches from the loop's thread and from autograd's (tid 2), one after
    every span, and a device operation with no launch call."""
    host = [_event("user_annotation", "snt/train/step", 0, 1000),
            _event("user_annotation", "snt/train/forward", 100, 200),
            _event("user_annotation", "snt/train/backward", 400, 500),
            _event("user_annotation", "snt/data/loader_wait", 1000, 60),
            _event("user_annotation", "snt/elsewhere", 450, 10, tid=3),
            _event("cuda_runtime", "cudaLaunchKernel", 150, 5, corr=1),
            _event("cuda_runtime", "cudaLaunchKernel", 500, 5, tid=2, corr=2),
            _event("cuda_runtime", "cudaMemcpyAsync", 950, 5, corr=3),
            _event("cuda_runtime", "cudaLaunchKernel", 1200, 5, corr=4)]
    device = [_event("kernel", "fwd", 160, 10, tid=7, corr=1),
              _event("kernel", "bwd", 1100, 40, tid=7, corr=2),
              _event("gpu_memcpy", "copy", 960, 20, tid=7, corr=3),
              _event("kernel", "late", 1210, 3, tid=7, corr=4),
              _event("gpu_memset", "orphan", 1300, 7, tid=7, corr=99)]
    return Trace(host + device, 1400e-6)


def test_device_time_goes_to_the_innermost_span_at_its_launch_call():
    by = pspans.device_seconds_by_span(_launch_trace())
    assert by == pytest.approx({"snt/train/forward": 10e-6, "snt/train/backward": 40e-6,
                                "snt/train/step": 20e-6, None: 10e-6})
    assert set(pspans.program_spans(_launch_trace())) == {
        "snt/train/step", "snt/train/forward", "snt/train/backward", "snt/data/loader_wait"}


class _Ctx:
    def __init__(self, cell, trace):
        c = spec.Cell(cell)
        self.config, self.traffic, self.trace, self.counters = c.config, c.traffic, trace, {}


SPAN_READERS = [
    ("idle_in_chunk_share.grid_cache", "scenenet.train.grid64", _idle_trace, 50.0),
    ("idle_at_epoch_edge_share.grid_cache", "scenenet.train.grid64", _idle_trace, 18.0),
    ("forward_ms.train", "unet3d.train.stream64", _launch_trace, 0.010),
    ("backward_ms.train", "unet3d.train.stream64", _launch_trace, 0.040),
    ("loader_wait_ms.span", "unet3d.train.stream64", _launch_trace, 0.060),
]


@pytest.mark.parametrize("name,cell,make,value", SPAN_READERS, ids=[r[0] for r in SPAN_READERS])
def test_span_readers_on_hand_built_traces(name, cell, make, value):
    assert spec.load_metric(name).read(_Ctx(cell, make())) == pytest.approx(value)


def test_dispatch_reader_on_a_hand_built_trace():
    trace = Trace([_event("user_annotation", "snt/serve/dispatch", 100 * i, 30)
                   for i in range(4)], 1e-3)
    got = spec.load_metric("host_ms_per_dispatch.infer").read(_Ctx("scenenet.infer.b64", trace))
    assert got == pytest.approx(0.030)


NEW_READERS = [("idle_in_chunk_share.grid_cache", "scenenet.train.grid64"),
               ("idle_at_epoch_edge_share.grid_cache", "scenenet.train.grid64"),
               ("loader_wait_ms.span", "unet3d.train.stream64"),
               ("forward_ms.train", "unet3d.train.stream64"),
               ("backward_ms.train", "unet3d.train.stream64"),
               ("host_ms_per_dispatch.infer", "scenenet.infer.b64"),
               ("setup_capture_s.infer", "scenenet.infer.b64"),
               ("setup_optimizer_s", "scenenet.train.grid64")]


@pytest.mark.parametrize("name,cell", NEW_READERS, ids=[r[0] for r in NEW_READERS])
def test_a_reader_without_its_spans_returns_none(name, cell, monkeypatch):
    """A program without the spans or phases (the trace holds the device's
    work and the harness's own annotations alone) reads nothing, never 0."""
    monkeypatch.delattr(profiling, "phase_seconds")
    trace = Trace([_event("user_annotation", "loader_next", 0, 50),
                   _event("cuda_runtime", "cudaLaunchKernel", 10, 5, corr=1),
                   _event("kernel", "k", 20, 30, tid=7, corr=1)], 1e-4)
    assert spec.load_metric(name).read(_Ctx(cell, trace)) is None


@pytest.mark.parametrize("name", ["snt/serve/warm_buckets", "snt/train/setup_optimizer"])
def test_phase_readers_read_the_programs_total(name, monkeypatch):
    monkeypatch.setattr(profiling, "phase_seconds", lambda: {name: 2.5})
    reader = {"snt/serve/warm_buckets": "setup_capture_s.infer",
              "snt/train/setup_optimizer": "setup_optimizer_s"}[name]
    assert spec.load_metric(reader).read(None) == 2.5
