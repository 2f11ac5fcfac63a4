"""The port's serving path as a whole, against the JAX package's server.

On the CPU the port's pipeline runs the kernels' plain versions; a
``/predict`` through the port's HTTP server must agree with the JAX
``_Pipeline`` at the same seed. The micro-batcher tests mirror the JAX
package's (``tests/test_serve.py``); every wait in them is bounded.
"""

import io
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

from scenenet_tpu_torch.cli import serve as tserve

GRID = (16, 16, 16)
MAX_POINTS = 4096
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def server():
    pipeline = tserve._Pipeline(None, grid=GRID, max_points=MAX_POINTS, device="cpu")
    srv = ThreadingHTTPServer(("127.0.0.1", 0), tserve.make_handler(pipeline))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def _post(url, body):
    req = urllib.request.Request(f"{url}/predict", data=body, method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return np.load(io.BytesIO(r.read()))


def _npz(**arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def test_predict_matches_jax_pipeline(server):
    from scenenet_tpu.cli.serve import _Pipeline as JaxPipeline

    rng = np.random.default_rng(0)
    points = rng.uniform(0, 30, (3000, 3)).astype(np.float32) + np.float32(100.0)
    out = _post(server, _npz(points=points, tau=np.float32(0.5)))
    want_vox, want_probs = JaxPipeline(None, grid=GRID, max_points=MAX_POINTS).predict(points)
    assert out["point_probs"].shape == (3000,)
    assert out["voxel_pred"].shape == GRID
    np.testing.assert_allclose(out["point_probs"], want_probs, rtol=0, atol=1e-5)
    np.testing.assert_allclose(out["voxel_pred"], want_vox, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(out["mask"], (want_probs >= 0.5).astype(np.float32))
    assert 0 < out["mask"].sum() < 3000


def test_checkpoint_pipeline_matches_jax(tmp_path):
    """A JAX-written checkpoint served by both pipelines."""
    import jax

    from scenenet_tpu.cli.serve import _Pipeline as JaxPipeline
    from scenenet_tpu.models import SceneNet as JaxSceneNet
    from scenenet_tpu.train.checkpoint import save_checkpoint

    _, params = JaxSceneNet.create(kernel_size=(9, 5, 5), seed=0)
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, jax.tree.map(lambda v: v * 0.9, params))
    points = np.random.default_rng(1).uniform(0, 20, (5000, 3)).astype(np.float32)
    got_vox, got_probs = tserve._Pipeline(path, grid=GRID, max_points=MAX_POINTS,
                                          device="cpu").predict(points)
    want_vox, want_probs = JaxPipeline(path, grid=GRID, max_points=MAX_POINTS).predict(points)
    assert got_probs.shape == (MAX_POINTS,)  # truncated at max_points, like JAX
    np.testing.assert_allclose(got_probs, want_probs, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_vox, want_vox, rtol=0, atol=1e-5)


def test_large_grid_request_matches_jax_pipeline(monkeypatch):
    """--grid 128 at a pad length where the sorted route holds: the
    occupancy comes from batch_flat_ids and sorted_bin_counts (the divide
    recipe), never the occupancy kernel, and the reply agrees with the JAX
    pipeline within 1e-5."""
    from scenenet_tpu.cli.serve import _Pipeline as JaxPipeline
    from scenenet_tpu_torch.ops import voxelize as tv

    calls = []
    for name in ("sorted_bin_counts", "points_occupancy"):
        real = getattr(tv, name)
        monkeypatch.setattr(tv, name, lambda *a, _n=name, _f=real, **k: (calls.append(_n),
                                                                          _f(*a, **k))[1])
    server, pipeline = tserve.build_server(["--device", "cpu", "--grid", "128",
                                            "--max-points", "49152", "--port", "0"])
    try:
        points = np.round(np.random.default_rng(3).uniform(0, 30, (3000, 3)), 2
                          ).astype(np.float32)
        vox, probs = pipeline.predict(points)
    finally:
        server.server_close()
        pipeline.close()
    assert calls and set(calls) == {"sorted_bin_counts"}  # the warm-up and the request
    want_vox, want_probs = JaxPipeline(None, grid=(128, 128, 128),
                                       max_points=49152).predict(points)
    assert vox.shape == (128, 128, 128) and probs.shape == (3000,)
    np.testing.assert_allclose(vox, want_vox, rtol=0, atol=1e-5)
    np.testing.assert_allclose(probs, want_probs, rtol=0, atol=1e-5)


def test_healthz(server):
    with urllib.request.urlopen(f"{server}/healthz", timeout=60) as r:
        info = json.loads(r.read())
    assert info["model"] == "scenenet"
    assert info["grid"] == list(GRID)
    assert info["device"] == "cpu" and info["backend"] == "torch"
    assert set(info["kernel_launches"]) == {"points_occupancy", "sorted_bin_counts",
                                            "stencil_conv", "stencil_mma"}
    assert "batching" not in info and "quantiles" not in info


@pytest.mark.parametrize("body", [b"not an npz", "wrong_shape", "empty", "no_points"])
def test_bad_body_is_400(server, body):
    bodies = {"wrong_shape": _npz(points=np.zeros((4, 2), np.float32)),
              "empty": _npz(points=np.zeros((0, 3), np.float32)),
              "no_points": _npz(tau=np.float32(0.5))}
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(server, bodies.get(body, body))
    assert err.value.code == 400


SMALL = ["--device", "cpu", "--grid", "8", "--max-points", "64", "--port", "0"]


def test_unported_flags_raise():
    """--mesh-ensemble is ported (ensemble-parallel serving, A12): it splits a
    quantile ensemble's members and refuses a model that has none."""
    with pytest.raises(ValueError, match="shards the quantile ensemble's members"):
        tserve.main(["--mesh-ensemble", "2"] + SMALL)


@pytest.mark.parametrize("argv,want", [
    (["--model", "quantile", "--quantiles", "0.2,0.5"],
     dict(model="quantile", quantiles=(0.2, 0.5), inference=True, batcher=None)),
    (["--max-batch", "4"], dict(inference=True, batcher=(4, False))),
    (["--max-batch", "6", "--batch-window-ms", "5"], dict(inference=True, batcher=(4, False))),
    (["--max-batch", "auto"], dict(inference=True, batcher=(32, True))),
    (["--inference", "mxu"], dict(inference="mxu", batcher=None)),
    (["--inference", "mxu_fast", "--max-batch", "2"],
     dict(inference="mxu_fast", batcher=(2, False)))])
def test_flags_build_the_pipeline(argv, want):
    """--model quantile, --max-batch N|auto and --inference mxu|mxu_fast
    build a server that answers (they raised before their port)."""
    server, pipeline = tserve.build_server(argv + SMALL)
    try:
        assert pipeline.model == want.get("model", "scenenet")
        assert pipeline.inference == want["inference"]
        if "quantiles" in want:
            assert pipeline.quantiles == want["quantiles"]
        b = pipeline._batcher
        assert (b and (b.max_batch, b.adaptive)) == want["batcher"]
        _, probs = pipeline.predict(np.random.default_rng(0).uniform(0, 9, (50, 3))
                                    .astype(np.float32))
        assert probs.shape[-1] == 50 and np.isfinite(probs).all()
    finally:
        server.server_close()
        pipeline.close()


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda is a valid request here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve._Pipeline(None, grid=(8, 8, 8), max_points=64, device="cuda")


@pytest.mark.parametrize("entry", ["resolve_device", "pipeline", "main"])
def test_default_device_is_cuda(entry):
    """No device given means cuda: without a card that raises, and nothing
    runs on the CPU unless asked for."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    calls = {"resolve_device": lambda: tserve.resolve_device(None),
             "pipeline": lambda: tserve._Pipeline(None, grid=(8, 8, 8), max_points=64),
             "main": lambda: tserve.main(["--grid", "8", "--max-points", "64"])}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
    assert tserve.resolve_device("cpu") == torch.device("cpu")


def test_port_never_imports_jax():
    """A fresh interpreter importing the serve entry point (and every module
    of the port) loads neither jax nor the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import scenenet_tpu_torch.cli.serve\n"
        "from scenenet_tpu_torch.cli.serve import _MicroBatcher, build_server\n"
        "from scenenet_tpu_torch.models import QuantileSceneNet\n"
        "from scenenet_tpu_torch.models import CnnBaseline, SceneNetClassifier, UNet3D\n"
        "from scenenet_tpu_torch.ops.cuda_conv_mc import conv3d_mc_same, fused_conv3d_mc\n"
        "import scenenet_tpu_torch.cli.train\n"
        "import scenenet_tpu_torch.cli.build_samples\n"
        "from scenenet_tpu_torch import native\n"
        "from scenenet_tpu_torch.data import (NativePointCloudLoader, SemanticKITTICrops,\n"
        "    VoxelLoader, Voxelization, build_data_samples, build_pole_radius_samples)\n"
        "from scenenet_tpu_torch.data import cache, las, pcd, semantic_kitti, transforms\n"
        "from scenenet_tpu_torch.ops.dbscan import dbscan, extract_clusters\n"
        "from scenenet_tpu_torch.train.admm import ADMMConfig, ADMMTrainer, augmented_loss\n"
        "from scenenet_tpu_torch.train.lbfgs import LBFGS, ZoomLinesearch\n"
        "from scenenet_tpu_torch.train.preempt import PreemptionGuard, save_train_snapshot\n"
        "from scenenet_tpu_torch.train.tune import autotune_backend, lr_range_test\n"
        "import scenenet_tpu_torch.cli.inspect, scenenet_tpu_torch.cli.visualize\n"
        "from scenenet_tpu_torch.cli.train import run_sweep\n"
        "from scenenet_tpu_torch.compat import import_scenenet_params, onnx_pb2, scan_model_zoo\n"
        "from scenenet_tpu_torch.compat.reference_oracle import load_reference\n"
        "from scenenet_tpu_torch.utils import export, onnx_export, plots, profiling\n"
        "from scenenet_tpu_torch.utils import proposals, viz\n"
        "from scenenet_tpu_torch.utils.config import sample_sweep\n"
        "assert native.available()\n"
        "native.load_batch_native([], 16)\n"
        "from scenenet_tpu_torch.ops.cuda_conv import geneo_stencil_conv_mxu, "
        "fused_geneo_conv_mxu\n"
        "import scenenet_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, 'scenenet_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'scenenet_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok', len([m for m in sys.modules if m.startswith('scenenet_tpu_torch')]))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


# ---- inference="mxu" and the quantile model through the pipeline ---------------

def test_inference_mxu_pipeline_matches_f32_pipeline():
    """On the CPU the mxu route runs the tensor-core stencil's plain
    version: near f32 against the default pipeline, and itself through
    run_batch at batch 2."""
    kw = dict(grid=GRID, max_points=MAX_POINTS, device="cpu")
    mxu = tserve._Pipeline(None, inference="mxu", **kw)
    f32 = tserve._Pipeline(None, **kw)
    points = np.random.default_rng(2).uniform(0, 25, (1500, 3)).astype(np.float32)
    vox, probs = mxu.predict(points)
    ref_vox, ref_probs = f32.predict(points)
    assert probs.shape == (1500,) and vox.shape == GRID
    np.testing.assert_allclose(vox, ref_vox, atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(probs, ref_probs, atol=2e-4, rtol=1e-4)
    assert np.abs(vox - ref_vox).max() > 0  # not the f32 route


def test_quantile_pipeline_matches_jax():
    from scenenet_tpu.cli.serve import _Pipeline as JaxPipeline

    kw = dict(grid=GRID, max_points=MAX_POINTS, model="quantile",
              quantiles=(0.1, 0.3, 0.5, 0.9))
    points = np.random.default_rng(3).uniform(0, 25, (1500, 3)).astype(np.float32)
    vox, probs = tserve._Pipeline(None, device="cpu", **kw).predict(points)
    want_vox, want_probs = JaxPipeline(None, **kw).predict(points)
    assert probs.shape == (4, 1500) and vox.shape == (4, *GRID)
    np.testing.assert_allclose(vox, want_vox, rtol=0, atol=1e-5)
    np.testing.assert_allclose(probs, want_probs, rtol=0, atol=1e-5)


def test_quantile_reply_and_healthz():
    pipeline = tserve._Pipeline(None, grid=GRID, max_points=MAX_POINTS, model="quantile",
                                quantiles=(0.1, 0.3, 0.5, 0.9), device="cpu")
    srv = ThreadingHTTPServer(("127.0.0.1", 0), tserve.make_handler(pipeline))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        with urllib.request.urlopen(f"{url}/healthz", timeout=60) as r:
            info = json.loads(r.read())
        assert info["model"] == "quantile" and info["quantiles"] == [0.1, 0.3, 0.5, 0.9]
        points = np.random.default_rng(0).uniform(0, 30, (2000, 3)).astype(np.float32)
        out = _post(url, _npz(points=points, tau=np.float32(0.5)))
        assert set(out.files) == {"point_probs", "point_quantiles", "uncertainty",
                                  "voxel_pred", "mask"}
        assert out["point_quantiles"].shape == (4, 2000)
        assert out["point_probs"].shape == (2000,) and out["uncertainty"].shape == (2000,)
        assert (out["uncertainty"] >= 0).all() and out["voxel_pred"].shape == (4, *GRID)
        np.testing.assert_array_equal(out["point_probs"], out["point_quantiles"][2])  # q=0.5
        np.testing.assert_array_equal(out["mask"],
                                      (out["point_probs"] >= 0.5).astype(np.float32))
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


# ---- micro-batching (mirrors tests/test_serve.py::TestMicroBatching) -----------

BKW = dict(grid=GRID, max_points=2048, device="cpu")


def _concurrently(fn, n, timeout=120):
    """Run fn(i) in n threads; returns the results, or the exceptions."""
    out = [None] * n

    def worker(i):
        try:
            out[i] = fn(i)
        except Exception as exc:
            out[i] = exc

    threads = [threading.Thread(target=worker, args=(i,), daemon=True) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    assert not any(t.is_alive() for t in threads), "a request never returned"
    return out


@pytest.mark.parametrize("inference", [True, "mxu"])
def test_batched_equals_direct_and_coalesces(inference):
    direct = tserve._Pipeline(None, inference=inference, **BKW)
    batched = tserve._Pipeline(None, inference=inference, max_batch=4,
                               batch_window_ms=300.0, **BKW)
    try:
        assert batched._batcher is not None
        rng = np.random.default_rng(7)
        clouds = [rng.uniform(0, 20 + 5 * i, (800 + 100 * i, 3)).astype(np.float32)
                  for i in range(3)]
        results = _concurrently(lambda i: batched.predict(clouds[i]), 3)
        for cloud, (pred, probs) in zip(clouds, results):
            ref_pred, ref_probs = direct.predict(cloud)
            assert probs.shape == (len(cloud),)
            np.testing.assert_allclose(pred, ref_pred, rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(probs, ref_probs, rtol=1e-5, atol=1e-6)
        # 3 requests inside a 300 ms window coalesce (≤ 2 dispatches: a
        # loaded machine can delay one thread past the window)
        stats = batched._batcher.stats_snapshot()
        assert stats["requests"] == 3
        assert stats["dispatches"] <= 2
        assert stats["max_batch_seen"] >= 2
        assert batched._batcher.max_batch == 4
    finally:
        batched.close()
    assert not batched._batcher._dispatch.is_alive() and not batched._batcher._fetch.is_alive()


@pytest.mark.parametrize("asked,got", [(3, 2), (4, 4), (7, 4), (33, 32)])
def test_max_batch_rounds_down(asked, got):
    """--max-batch is a cap: non-powers of two round DOWN."""
    p = tserve._Pipeline(None, grid=(8, 8, 8), max_points=64, device="cpu",
                         max_batch=asked, batch_window_ms=0.0, warm_buckets=False)
    try:
        assert p._batcher.max_batch == got
    finally:
        p.close()


def test_bucket_padding_repeats_request_zero():
    """Three queued requests run as one bucket of 4 whose padding row is
    request 0's tensors; each slot gets its own row back."""
    p = tserve._Pipeline(None, **BKW)
    seen = []

    def spy(pts, mask):
        seen.append((pts.clone(), mask.clone()))
        return tserve._Pipeline.run_batch(p, pts, mask)

    p.run_batch = spy
    batcher = tserve._MicroBatcher(p, 4, 0.0)
    rng = np.random.default_rng(1)
    rows = []
    for i in range(3):  # queued before the threads start: one drain takes all three
        pts = torch.zeros((2048, 3))
        pts[:500 + i] = torch.from_numpy(rng.uniform(0, 20, (500 + i, 3)).astype(np.float32))
        mask = torch.arange(2048) < 500 + i
        slot = {"done": threading.Event(), "submitted": time.perf_counter()}  # as submit()
        batcher._q.put((pts, mask, slot))
        rows.append((pts, mask, slot))
    batcher.start()
    try:
        for _, _, slot in rows:
            assert slot["done"].wait(timeout=60)
    finally:
        batcher.close()
    assert len(seen) == 1 and seen[0][0].shape == (4, 2048, 3)
    pts4, mask4 = seen[0]
    for i, (pts, mask, _) in enumerate(rows):
        assert torch.equal(pts4[i], pts) and torch.equal(mask4[i], mask)
    assert torch.equal(pts4[3], pts4[0]) and torch.equal(mask4[3], mask4[0])
    for pts, mask, slot in rows:
        want_pred, want_probs = tserve._Pipeline.run_batch(p, pts[None], mask[None])
        np.testing.assert_allclose(slot["result"][0], want_pred[0].numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(slot["result"][1], want_probs[0].numpy(), rtol=1e-5,
                                   atol=1e-6)
    assert batcher.stats_snapshot() == {"requests": 3, "dispatches": 1, "max_batch_seen": 3,
                                        "failed_dispatches": 0, "windows_opened": 0}


def test_adaptive_low_load_skips_window():
    """--max-batch auto: a lone request on an idle server dispatches at
    once, with no coalescing window."""
    p = tserve._Pipeline(None, max_batch=4, batch_window_ms=1000.0, adaptive=True, **BKW)
    try:
        assert p._batcher.adaptive
        cloud = np.random.default_rng(3).uniform(0, 20, (700, 3)).astype(np.float32)
        p.predict(cloud)  # prime the EWMA (the first request has no interval)
        time.sleep(2.0)   # low-load spacing: 0.5 requests/s
        t0 = time.perf_counter()
        p.predict(cloud)
        dt = time.perf_counter() - t0
        assert dt < 0.9, f"adaptive lone request waited the window ({dt:.3f}s)"
        stats = p._batcher.stats_snapshot()
        assert stats["windows_opened"] == 0
        assert stats["requests"] == 2
    finally:
        p.close()


def _bare_batcher(**attrs):
    """A _MicroBatcher with its decision state only: no pipeline, no threads."""
    b = tserve._MicroBatcher.__new__(tserve._MicroBatcher)
    b.adaptive = True
    b._stats_lock = threading.Lock()
    for k, v in attrs.items():
        setattr(b, k, v)
    return b


def test_adaptive_wait_decision():
    """Fast arrivals (≥ _GAIN_MIN predicted within the window) open it; slow
    or stale arrival rates do not."""
    b = _bare_batcher(window=0.05)
    b._ewma_interval = 0.001  # 1 ms apart → 50 predicted in a 50 ms window
    b._last_arrival = time.monotonic()
    assert b._should_wait()
    b._ewma_interval = 0.1    # 100 ms apart → 0.5 predicted
    assert not b._should_wait()
    b._ewma_interval = 0.001  # stale burst: the last arrival long past 10×EWMA
    b._last_arrival = time.monotonic() - 1.0
    assert not b._should_wait()
    b._ewma_interval = float("inf")  # idle server: no estimate yet
    b._last_arrival = None
    assert not b._should_wait()
    b._ewma_interval, b._last_arrival, b.window = 0.001, time.monotonic(), 0.0
    assert not b._should_wait()  # no window to wait


class _SteppingClock:
    """``time`` as ``cli.serve`` sees it, with ``monotonic`` a counter that
    advances ``step`` seconds a call: a phase's throughput is then its
    requests a call over ``step``, whatever the scheduler does."""

    def __init__(self, step):
        self.step, self.now = step, 0.0

    def monotonic(self):
        self.now += self.step
        return self.now

    def __getattr__(self, name):
        return getattr(time, name)


def test_adaptive_throughput_probe_decision(monkeypatch):
    """Probe both modes, commit to the measured winner, re-probe later."""
    monkeypatch.setattr(tserve, "time", _SteppingClock(1e-3))
    MB = tserve._MicroBatcher
    b = _bare_batcher(_mode="multi", _phase_len=MB._PROBE_LEN, _phase_count=0,
                      _phase_reqs=0, _phase_t0=None, _tp={"multi": None, "single": None})
    assert b._should_coalesce()  # optimistic initial probe

    def run_until_rotation(reqs_per_call, bound=1000):
        start = b._mode
        for _ in range(bound):
            b._note_completion(reqs_per_call)
            if b._mode != start or b._phase_reqs == 0:
                return
        raise AssertionError("phase never rotated")

    run_until_rotation(4)  # the multi probe completes → the single probe
    assert b._mode == "single" and not b._should_coalesce()
    assert b._tp["multi"] is not None
    run_until_rotation(1)  # both measured → committed to the winner
    assert b._tp["single"] is not None
    best = "multi" if b._tp["multi"] >= b._tp["single"] else "single"
    assert b._mode == best
    assert b._phase_len == MB._COMMIT_LEN
    assert b.direct_mode() == (b._mode == "single")
    run_until_rotation(2)  # the commitment ends → the other mode is re-probed
    assert b._mode != best and b._phase_len == MB._PROBE_LEN


def test_adaptive_phase_discards_idle_samples():
    """A probe phase stretched past _PHASE_MAX_S records no throughput."""
    b = _bare_batcher(_mode="multi", _phase_len=2, _phase_count=1, _phase_reqs=3,
                      _phase_t0=time.monotonic() - 60.0,
                      _tp={"multi": None, "single": None})
    b._note_completion(1)  # closes the phase, wall ≈ 60 s > max
    assert b._tp["multi"] is None   # sample discarded
    assert b._mode == "single"      # still rotates to probe the other


def test_adaptive_concurrent_requests_coalesce_and_match():
    direct = tserve._Pipeline(None, **BKW)
    adaptive = tserve._Pipeline(None, max_batch=4, batch_window_ms=50.0, adaptive=True, **BKW)
    try:
        rng = np.random.default_rng(5)
        clouds = [rng.uniform(0, 25 + 3 * i, (600 + 90 * i, 3)).astype(np.float32)
                  for i in range(4)]
        results = _concurrently(lambda i: adaptive.predict(clouds[i]), 4)
        for cloud, (pred, probs) in zip(clouds, results):
            ref_pred, ref_probs = direct.predict(cloud)
            np.testing.assert_allclose(pred, ref_pred, rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(probs, ref_probs, rtol=1e-5, atol=1e-6)
        assert adaptive._batcher.stats_snapshot()["requests"] == 4
    finally:
        adaptive.close()


def test_adaptive_direct_mode_bypasses_the_batcher():
    """In the probe's "single" phase predict() runs batch 1 in the caller's
    thread; the request still counts, and its completion feeds the probe."""
    direct = tserve._Pipeline(None, **BKW)
    p = tserve._Pipeline(None, max_batch=4, batch_window_ms=50.0, adaptive=True, **BKW)
    try:
        p._batcher._mode = "single"
        cloud = np.random.default_rng(6).uniform(0, 20, (650, 3)).astype(np.float32)
        pred, probs = p.predict(cloud)
        ref_pred, ref_probs = direct.predict(cloud)
        np.testing.assert_array_equal(pred, ref_pred)
        np.testing.assert_array_equal(probs, ref_probs)
        stats = p._batcher.stats_snapshot()
        assert stats["requests"] == 1 and stats["direct_requests"] == 1
        assert stats["dispatches"] == 0 and stats["coalesce_mode"] == "single"
        assert p._batcher._phase_reqs == 1
    finally:
        p.close()


def test_quantile_batched_gather():
    kw = dict(model="quantile", quantiles=(0.1, 0.5, 0.9), **BKW)
    direct = tserve._Pipeline(None, **kw)
    batched = tserve._Pipeline(None, max_batch=2, batch_window_ms=0.0, **kw)
    try:
        cloud = np.random.default_rng(11).uniform(0, 30, (900, 3)).astype(np.float32)
        ref_pred, ref_probs = direct.predict(cloud)
        pred, probs = batched.predict(cloud)  # window 0 → solo dispatch
        assert probs.shape == (3, 900) and pred.shape == (3, *GRID)
        np.testing.assert_allclose(pred, ref_pred, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(probs, ref_probs, rtol=1e-5, atol=1e-6)
        clouds = [cloud[:700], cloud[100:]]
        batched._batcher.window = 0.3
        for c, (pred, probs) in zip(clouds, _concurrently(
                lambda i: batched.predict(clouds[i]), 2)):
            ref_pred, ref_probs = direct.predict(c)
            assert probs.shape == (3, len(c))
            np.testing.assert_allclose(probs, ref_probs, rtol=1e-5, atol=1e-6)
    finally:
        batched.close()


def test_failed_dispatch_per_slot_exceptions_and_stats():
    """A failing batched dispatch raises a DISTINCT exception instance in
    each waiting thread, chained to the cause, and counts as a failed
    dispatch, not as served requests."""
    batched = tserve._Pipeline(None, max_batch=4, batch_window_ms=300.0, **BKW)
    boom = ValueError("injected failure")

    def failing_run_batch(pts, mask):
        raise boom

    batched.run_batch = failing_run_batch
    try:
        rng = np.random.default_rng(5)
        clouds = [rng.uniform(0, 20, (600 + 50 * i, 3)).astype(np.float32) for i in range(3)]
        caught = _concurrently(lambda i: batched.predict(clouds[i]), 3)
        assert all(isinstance(c, RuntimeError) for c in caught)
        assert len({id(c) for c in caught}) == 3
        assert all(c.__cause__ is boom for c in caught)
        stats = batched._batcher.stats_snapshot()
        assert stats["failed_dispatches"] >= 1
        assert stats["requests"] == 0
        assert stats["dispatches"] == 0
        # the threads survived the failure and serve the next request
        del batched.run_batch
        _, probs = batched.predict(clouds[0])
        assert probs.shape == (600,)
    finally:
        batched.close()


def test_submit_after_worker_death_raises():
    p = tserve._Pipeline(None, max_batch=2, batch_window_ms=0.0, **BKW)
    p.close()  # both threads have ended
    with pytest.raises(RuntimeError, match="worker thread died"):
        p._batcher.submit(torch.zeros((2048, 3)), torch.zeros(2048, dtype=torch.bool))


@pytest.mark.parametrize("adaptive", [False, True])
def test_http_healthz_reports_batching(adaptive):
    pipeline = tserve._Pipeline(None, max_batch=4, batch_window_ms=100.0,
                                adaptive=adaptive, **BKW)
    srv = ThreadingHTTPServer(("127.0.0.1", 0), tserve.make_handler(pipeline))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        points = np.random.default_rng(5).uniform(0, 20, (700, 3)).astype(np.float32)
        body = _npz(points=points, tau=np.float32(0.5))
        outs = _concurrently(lambda i: _post(base, body), 3)
        for o in outs:
            assert o["point_probs"].shape == (700,)
        with urllib.request.urlopen(f"{base}/healthz", timeout=60) as r:
            info = json.loads(r.read())
        assert info["batching"]["requests"] == 3
        assert info["batching"]["max_batch"] == 4
        assert info["batching"]["dispatches"] <= 3
        assert info["batching"]["mode"] == ("adaptive" if adaptive else "static")
        assert ("coalesce_mode" in info["batching"]) == adaptive
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
        pipeline.close()
    assert not thread.is_alive()


def test_batcher_stress_counts_every_request():
    """More client threads than cores and a short switch interval: every
    request is answered with its own cloud's result and counted once."""
    direct = tserve._Pipeline(None, grid=(8, 8, 8), max_points=256, device="cpu")
    p = tserve._Pipeline(None, grid=(8, 8, 8), max_points=256, device="cpu",
                         max_batch=8, batch_window_ms=5.0)
    n = 48
    rng = np.random.default_rng(9)
    clouds = [rng.uniform(0, 10 + i, (100 + i, 3)).astype(np.float32) for i in range(n)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        results = _concurrently(lambda i: p.predict(clouds[i]), n)
    finally:
        sys.setswitchinterval(old)
        p.close()
    for cloud, res in zip(clouds, results):
        assert isinstance(res, tuple), res
        np.testing.assert_allclose(res[1], direct.predict(cloud)[1], rtol=1e-5, atol=1e-6)
    stats = p._batcher.stats_snapshot()
    assert stats["requests"] == n and stats["failed_dispatches"] == 0
    assert stats["dispatches"] < n and stats["max_batch_seen"] <= 8


# ---- the served dispatch as one CUDA graph a bucket -------------------------------
# On the CPU run_batch stays eager and no graph is made; a _BucketGraph is
# built here over a stand-in for the graph's static outputs (a run that
# writes into the same tensors every call, as a replay does), so that what
# the copy-out protects against shows on the CPU.

def _static_run(pipeline):
    """pipeline._run writing into one pair of tensors, as a replay writes
    into a graph's static outputs."""
    bufs = []

    def run(pts, mask):
        out = pipeline._run(pts, mask)
        if not bufs:
            bufs.extend(t.clone() for t in out)
        for buf, t in zip(bufs, out):
            buf.copy_(t)
        return tuple(bufs)

    return run


def test_cpu_pipeline_makes_no_graph():
    p = tserve._Pipeline(None, max_batch=4, batch_window_ms=0.0, **BKW)
    try:
        assert p._graphs == {} and p.graph_replays() == {}
        assert p.kernel_launches() == tserve.wrapper_launches()
        pts, mask = tserve._warm_inputs(2, 2048, torch.device("cpu"))
        pred, probs = p.run_batch(pts, mask)
        want = p._run(pts, mask)
        assert torch.equal(pred, want[0]) and torch.equal(probs, want[1])
    finally:
        p.close()


def test_bucket_graph_outputs_survive_the_next_replay():
    """Each call returns copies: a result is the same after later replays
    have overwritten the static outputs, and the replays are counted."""
    p = tserve._Pipeline(None, **BKW)
    graph = tserve._BucketGraph(_static_run(p), 2, 2048, torch.device("cpu"))
    assert graph.replays == 0 and set(graph.launches) == set(tserve.wrapper_launches())
    rng = np.random.default_rng(0)
    batches, results = [], []
    for _ in range(3):
        pts = torch.from_numpy(rng.uniform(0, 20, (2, 2048, 3)).astype(np.float32))
        mask = torch.from_numpy(rng.random((2, 2048)) < 0.7)
        batches.append((pts, mask))
        results.append(graph(pts, mask))
    assert graph.replays == 3
    for (pts, mask), (pred, probs) in zip(batches, results):
        want = p._run(pts, mask)
        assert torch.equal(pred, want[0]) and torch.equal(probs, want[1])
    assert results[0][0].data_ptr() != graph.out[0].data_ptr()
    assert not torch.equal(results[0][1], graph.out[1])


@pytest.mark.parametrize("adaptive", [False, True])
def test_batcher_copes_with_outputs_the_next_dispatch_overwrites(adaptive):
    """Requests through the batcher (and, adaptive, its direct phase) over
    buckets whose outputs are overwritten by every dispatch: each reply is
    its own request's, checked after every request has been served (on
    the CPU a download does not copy, so an aliased reply would show the
    last dispatch's values)."""
    direct = tserve._Pipeline(None, **BKW)
    p = tserve._Pipeline(None, max_batch=4, batch_window_ms=100.0, adaptive=adaptive, **BKW)
    try:
        p._graphs = {b: tserve._BucketGraph(_static_run(p), b, 2048, torch.device("cpu"))
                     for b in (1, 2, 4)}
        rng = np.random.default_rng(8)
        clouds = [rng.uniform(0, 25, (500 + 90 * i, 3)).astype(np.float32) for i in range(8)]
        got = _concurrently(lambda i: p.predict(clouds[i]), 8)
        got += [p.predict(c) for c in clouds[:3]]
        for c, (pred, probs) in zip(clouds + clouds[:3], got):
            want_pred, want_probs = direct.predict(c)
            np.testing.assert_array_equal(pred, want_pred)
            np.testing.assert_array_equal(probs, want_probs)
        assert sum(p.graph_replays().values()) >= 4
    finally:
        p.close()


def test_healthz_counts_replayed_launches():
    """/healthz adds each bucket's recorded launches once a replay to the
    wrappers' own counts."""
    p = tserve._Pipeline(None, **BKW)
    graph = tserve._BucketGraph(_static_run(p), 1, 2048, torch.device("cpu"))
    graph.graph.launches = dict(dict.fromkeys(graph.launches, 0), points_occupancy=1,
                                stencil_conv=1)
    p._graphs = {1: graph}
    srv = ThreadingHTTPServer(("127.0.0.1", 0), tserve.make_handler(p))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        seen = []
        for _ in range(3):
            _post(url, _npz(points=np.random.default_rng(1).uniform(0, 9, (300, 3))))
            with urllib.request.urlopen(f"{url}/healthz", timeout=60) as r:
                seen.append(json.loads(r.read()))
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
    base = tserve.wrapper_launches()
    assert [h["graph_replays"] for h in seen] == [{"1": 1}, {"1": 2}, {"1": 3}]
    assert [h["kernel_launches"]["stencil_conv"] - base["stencil_conv"]
            for h in seen] == [1, 2, 3]
    assert seen[-1]["kernel_launches"]["stencil_mma"] == base["stencil_mma"]
