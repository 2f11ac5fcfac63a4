"""The port's serving path as a whole, against the JAX package's server.

On the CPU the port's pipeline runs the kernels' plain versions; a
``/predict`` through the port's HTTP server must agree with the JAX
``_Pipeline`` at the same seed.
"""

import io
import json
import os
import subprocess
import sys
import threading
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


def test_healthz(server):
    with urllib.request.urlopen(f"{server}/healthz", timeout=60) as r:
        info = json.loads(r.read())
    assert info["model"] == "scenenet"
    assert info["grid"] == list(GRID)
    assert info["device"] == "cpu" and info["backend"] == "torch"
    assert set(info["kernel_launches"]) == {"points_occupancy", "stencil_conv"}


@pytest.mark.parametrize("body", [b"not an npz", "wrong_shape", "empty", "no_points"])
def test_bad_body_is_400(server, body):
    bodies = {"wrong_shape": _npz(points=np.zeros((4, 2), np.float32)),
              "empty": _npz(points=np.zeros((0, 3), np.float32)),
              "no_points": _npz(tau=np.float32(0.5))}
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(server, bodies.get(body, body))
    assert err.value.code == 400


@pytest.mark.parametrize("argv,item", [
    (["--model", "quantile"], "A8"), (["--mesh-ensemble", "2"], "A12"),
    (["--max-batch", "4"], "A10"), (["--max-batch", "auto"], "A10"),
    (["--inference", "mxu"], "B2"), (["--inference", "mxu_fast"], "B2")])
def test_unported_flags_raise(argv, item):
    with pytest.raises(NotImplementedError, match=item):
        tserve.main(argv + ["--device", "cpu", "--grid", "8", "--max-points", "64"])


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
