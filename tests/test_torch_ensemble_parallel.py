"""Port parity: ensemble parallelism (``parallel/ep.py``), the quantile
ensemble's members over the mesh's ``model`` axis, on gloo ranks on the CPU.

One launch of 4 ranks (``tests/torch_model_axis_legs.py:ensemble_ranks``,
its own timeout) runs every leg over (data 2, model 2) and the other
meshes; each is held against the same code with no mesh (the port's
one-rank twin, run here) and, for the steps and the forward, against the
JAX package's EP functions over the same mesh of virtual CPU devices; the
cases follow ``tests/test_ensemble_parallel.py``'s classes. Serving's
``mesh_ensemble=4`` cases follow ``tests/test_serve.py``'s.

Tolerances: confusion counts exact; losses rtol 1e-5 and parameters and
gradients atol 1e-6 against the twin (the members' pinball terms summed
over the model ranks in another order); against JAX losses, parameters
and gradients rtol 1e-4 with atol 1e-6 (XLA's CPU sums the weighted
pinball loss over 18k voxels 3.4e-5 away from torch's; the kernel
synthesis rounds 2e-7 apart, ROADMAP Traps); forward probabilities atol
1e-5; the bf16 fit losses rtol 1e-4 and parameters atol 5e-5 (a bf16
forward rounds a sum's last bit into a bf16 unit, 2^-8 of a value: 2
epochs end 1.3e-5 and 1.6e-5 apart); L-BFGS parameters atol 1e-5 (its linesearch decisions on the same
values, its two-loop products summed over the ranks); the preempted and
resumed fit bit for bit.
"""

import os
import sys

import numpy as np
import pytest

import jax
import torch

from scenenet_tpu.losses import resolve_criterion as jax_criterion
from scenenet_tpu.models import QuantileSceneNet as JaxQuantileSceneNet
from scenenet_tpu.parallel import (
    make_ensemble_eval_step as jax_ep_eval, make_ensemble_inference_fn as jax_ep_inference,
    make_ensemble_train_step as jax_ep_train, make_mesh as jax_make_mesh,
)
from scenenet_tpu.train import make_device_voxelize_prep as jax_prep
from scenenet_tpu.train.metrics import init_metric_state as jax_metric_state
from scenenet_tpu.train.metrics import metric_counts as jax_counts
from scenenet_tpu.train.state import create_train_state
from scenenet_tpu_torch.cli import serve as tserve
from scenenet_tpu_torch.cli import train as tcli
from scenenet_tpu_torch.parallel import launch
from scenenet_tpu_torch.utils.config import load_config

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_model_axis_legs as legs  # noqa: E402  (torch and the port only)

RTOL, ATOL = 1e-5, 1e-6
JAX_RTOL = 1e-4


def _write_dataset(root, n_fit=8, n_test=2):
    rng = np.random.default_rng(0)
    for split, n in (("fit", n_fit), ("test", n_test)):
        os.makedirs(os.path.join(root, split))
        for i in range(n):
            m = int(rng.integers(600, 1000))
            xyz = rng.uniform([0, 0, 0], [30, 30, 60], (m, 3))
            labels = rng.choice([1, 2, 15], size=m, p=[0.5, 0.35, 0.15])
            np.save(os.path.join(root, split, f"sample_{i}.npy"),
                    np.concatenate([xyz, labels[:, None]], axis=1))
    return root


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("ep_ranks"))
    data = _write_dataset(os.path.join(tmp, "data"))
    return launch.run_ranks("torch_model_axis_legs:ensemble_ranks", 4,
                            {"tmp": tmp, "data": data}, timeout=240, path=HERE)


@pytest.fixture(scope="module")
def twin_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("ep_twins"))


@pytest.fixture(scope="module")
def devices8():
    assert len(jax.devices()) == 8
    return jax.devices()


def _jax_model(quantiles=legs.QUANTILES):
    return JaxQuantileSceneNet.create(legs.GENEO, kernel_size=legs.KS, quantiles=quantiles,
                                      seed=legs.QSEED)


def _jax_criterion(kind="quantile_geneo"):
    kw = dict(quantiles=legs.QUANTILES, weight_alpha=1.0, weight_epsilon=0.1, mse_weight=1.0)
    if kind == "quantile_geneo":
        kw["convex_weight"] = 5.0
    return jax_criterion(kind)(**kw)


def _jflat(tree):
    return {".".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _stacked(grads, q=len(legs.QUANTILES)):
    """Port gradients by member parameter name → the JAX stacked layout."""
    names = {k.split(".", 2)[2] for k in grads}
    out = {}
    for n in names:
        parts = [grads.get(f"members.{i}.{n}") for i in range(q)]
        ref = next(p for p in parts if p is not None)
        out[n] = np.stack([p if p is not None else np.zeros_like(ref) for p in parts])
    return out


def _close(got, want, rtol=0.0, atol=ATOL):
    """Every leaf of ``want`` in ``got``; a leaf the port gives no gradient
    (a frozen parameter: the derived last λ, a non-trainable GENEO scalar)
    is zero in ``want``."""
    for k, v in want.items():
        if k not in got:
            assert not np.any(v), k
            continue
        np.testing.assert_allclose(got[k], v, rtol=rtol, atol=atol, err_msg=k)


def _ep_mesh(devices8, shape):
    return jax_make_mesh(shape, axis_names=("data", "model"),
                         devices=devices8[:shape[0] * shape[1]])


def _rows(r, full, axis="data"):
    n = full.shape[0] // 2
    d = r["coords"][axis]
    return full[d * n:(d + 1) * n]


def test_port_model_starts_from_jax_parameters():
    _, jparams = _jax_model()
    _close(legs._params(legs.ep_model()), _jflat(jparams), atol=0)


class TestEnsembleInference:
    @pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
    def test_matches_single_device(self, ranks, devices8, shape):
        """The rank's rows with every member gathered over 'model', against
        the one-rank forward and JAX's EP forward."""
        x, _ = legs.ep_batch(b=8)
        with torch.no_grad():
            twin = legs.ep_model()(torch.from_numpy(x)).numpy()
        model, params = _jax_model()
        want = np.asarray(jax_ep_inference(model, _ep_mesh(devices8, shape))(params, x))
        key = f"{shape[0]}x{shape[1]}"
        for r in ranks:
            got = r["inference"][key]
            rows = slice(0, 8) if shape[0] == 1 else (
                slice(0, 4) if r["coords"]["data"] == 0 else slice(4, 8))
            assert got.shape == (8 // shape[0], 4, 16, 12, 12)
            np.testing.assert_allclose(got, twin[rows], rtol=0, atol=ATOL)
            np.testing.assert_allclose(got, want[rows], rtol=0, atol=1e-5)

    def test_indivisible_members_raise(self, ranks):
        assert "do not divide" in ranks[0]["guards"]["indivisible"]

    def test_non_ensemble_model_raises(self, ranks):
        assert "member-stacked" in ranks[0]["guards"]["non_ensemble"]


@pytest.fixture(scope="module")
def jax_steps(devices8):
    """JAX's EP train step over (data 2, model 2): 3 SGD steps a kind, and
    one on a raw point batch prepared on each shard."""
    out = {}
    model, params = _jax_model()
    mask = model.trainable_mask(params)
    mesh = _ep_mesh(devices8, (2, 2))
    for kind in ("quantile", "quantile_geneo"):
        state, tx = create_train_state(params, "sgd", 1e-2, mask)
        step = jax_ep_train(model, _jax_criterion(kind), tx, mesh, with_grads=True)
        m, losses, grads = jax_metric_state(), [], []
        for i in range(3):
            state, m, loss, g = step(state, m, *legs.ep_batch(seed=i))
            losses.append(float(loss))
            grads.append(_jflat(g))
        out[kind] = {"losses": losses, "grads": grads, "params": _jflat(state.params),
                     "counts": jax_counts(m)}
    state, tx = create_train_state(params, "sgd", 1e-2, mask)
    step = jax_ep_train(model, _jax_criterion(), tx, mesh,
                        batch_prep=jax_prep(grid_shape=(16, 12, 12), use_indices=False))
    state, m, loss = step(state, jax_metric_state(), *legs.ep_raw())
    out["raw"] = {"losses": [float(loss)], "params": _jflat(state.params),
                  "counts": jax_counts(m)}
    return out


class TestEnsembleTrainStep:
    @pytest.mark.parametrize("kind", ["quantile", "quantile_geneo"])
    def test_matches_single_device(self, ranks, jax_steps, kind):
        twin = legs.ep_steps(None, kind)
        want = jax_steps[kind]
        for r in ranks:
            got = r[f"steps_{kind}"]
            assert got["counts"] == twin["counts"] == want["counts"]
            np.testing.assert_allclose(got["losses"], twin["losses"], rtol=RTOL)
            np.testing.assert_allclose(got["losses"], want["losses"], rtol=JAX_RTOL)
            for i in range(3):
                _close(got["grads"][i], twin["grads"][i])
                _close(_stacked(got["grads"][i]), want["grads"][i], rtol=JAX_RTOL)
            _close(got["params"], twin["params"])
            _close(got["params"], want["params"], rtol=JAX_RTOL)

    def test_criterion_mismatch_raises(self, ranks):
        g = ranks[0]["guards"]
        assert "quantile criterion" in g["criterion"]
        assert "quantiles" in g["quantiles"]

    def test_batch_prep_runs_shard_local(self, ranks, jax_steps):
        """Raw point batches: each rank voxelizes its own rows."""
        twin = legs.ep_steps(None, "quantile_geneo", raw=True)
        want = jax_steps["raw"]
        got = ranks[0]["steps_raw"]
        assert got["counts"] == twin["counts"] == want["counts"]
        np.testing.assert_allclose(got["losses"], twin["losses"], rtol=RTOL)
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=JAX_RTOL)
        _close(got["params"], twin["params"])
        _close(got["params"], want["params"], rtol=JAX_RTOL)


class TestEnsembleEvalStep:
    @pytest.mark.parametrize("b", [8, 5])  # 5: a ragged tail, replicated over data
    def test_matches_single_device(self, ranks, devices8, b):
        twin = legs.ep_eval(None, b)
        model, params = _jax_model()
        m, loss, pred = jax_ep_eval(model, _jax_criterion(), _ep_mesh(devices8, (2, 2)))(
            params, None, jax_metric_state(), *legs.ep_batch(b=b))
        for r in ranks:
            got = r["eval"][b]
            assert got["counts"] == twin["counts"] == jax_counts(m)
            assert got["loss"] == pytest.approx(twin["loss"], rel=RTOL)
            assert got["loss"] == pytest.approx(float(loss), rel=JAX_RTOL)
            rows = _rows(r, twin["pred"]) if b == 8 else twin["pred"]
            np.testing.assert_allclose(got["pred"], rows, rtol=0, atol=ATOL)
            jrows = _rows(r, np.asarray(pred)) if b == 8 else np.asarray(pred)
            np.testing.assert_allclose(got["pred"], jrows, rtol=0, atol=1e-5)


    @pytest.mark.parametrize("b", [8, 5])
    def test_local_eval_step_matches_single_device(self, ranks, b):
        """The rank-local eval body on the rank's rows (8) or on the whole
        batch replicated over data (5)."""
        twin = legs.ep_eval(None, b)
        for r in ranks:
            got = r["local_eval"][b]
            assert got["counts"] == twin["counts"]
            assert got["loss"] == pytest.approx(twin["loss"], rel=RTOL)


def _assert_same_fit(got, want, atol=ATOL, rtol=RTOL):
    assert got["counts"] == want["counts"]
    for a, b in zip(got["scores"], want["scores"]):
        for k in ("train_loss", "val_loss"):
            if k in b:
                assert a[k] == pytest.approx(b[k], rel=rtol), k
    _close(got["params"], want["params"], atol=atol)


class TestTrainerEnsembleMesh:
    """Trainer(mesh=(data, model)) routes fit, the cached fits and the
    evaluations through the EP step."""

    def test_fit_matches_single_device(self, ranks, twin_dir):
        want = legs.ep_fit(twin_dir, None, "streamed", "fit_one")
        for r in ranks:
            _assert_same_fit(r["fit_streamed"], want)

    @pytest.mark.parametrize("route", ["grids", "grids_aug", "points"])
    def test_cached_fits_match_single_device(self, ranks, twin_dir, route):
        """The grid cache (with and without D4 draws) and the point cache,
        each rank its rows of the replicated cache."""
        want = legs.ep_fit(twin_dir, None, route, f"{route}_one")
        _assert_same_fit(ranks[0][f"fit_{route}"], want)
        if route == "grids":
            got = ranks[0]["fit_grids"]["evaluate_cached"]
            for k, v in want["evaluate_cached"].items():
                assert got[k] == pytest.approx(v, rel=RTOL, abs=1e-9), k

    def test_bf16_fit_matches_single_device(self, ranks, twin_dir):
        want = legs.ep_fit(twin_dir, None, "streamed", "bf16_one", precision="bf16")
        _assert_same_fit(ranks[0]["bf16"], want, atol=5e-5, rtol=1e-4)

    def test_space_and_model_axes_conflict(self, ranks):
        assert "cannot combine" in ranks[0]["guards"]["conflict"]


class TestCliEnsembleMesh:
    def test_cli_ep_end_to_end(self, ranks):
        """model=quantile with mesh_data × mesh_ensemble from the CLI: the
        grid cache, EP cached epochs and the sharded evaluation."""
        first, second = (dict(r["cli"]["scores"]) for r in ranks[:2])
        assert np.isfinite(first["test_loss"])
        first.pop("epoch_time_s"), second.pop("epoch_time_s")
        assert first == second

    @pytest.mark.parametrize("overrides,message", [
        ({"model": "scenenet", "mesh_data": 2, "mesh_ensemble": 4}, "quantile ensemble"),
        ({"model": "quantile", "mesh_data": 2, "mesh_ensemble": 4,
          "quantiles": (0.1, 0.5, 0.9)}, "do not divide"),
        ({"model": "quantile", "mesh_space": 2, "mesh_ensemble": 4,
          "quantiles": (0.1, 0.5, 0.9, 0.95)}, "mutually exclusive"),
        ({"model": "quantile", "mesh_ensemble": 2, "quantiles": (0.1, 0.9),
          "constrained": "admm"},
         "constrained=admm shards over data/space only"),
    ])
    def test_cli_ep_guards(self, monkeypatch, overrides, message):
        world = overrides.get("mesh_data", 1) * overrides.get("mesh_ensemble", 1) * \
            overrides.get("mesh_space", 1)
        monkeypatch.setenv("WORLD_SIZE", str(world))
        with pytest.raises(ValueError, match=message):
            tcli.build_mesh(load_config(None, overrides), "cpu")

    def test_build_criterion_forwards_quantiles(self):
        cfg = load_config(None, {"model": "quantile", "criterion": "quantile_geneo",
                                 "quantiles": (0.05, 0.25, 0.5, 0.75, 0.95)})
        assert tcli.build_criterion(cfg).quantiles == (0.05, 0.25, 0.5, 0.75, 0.95)


class TestDegenerateEnsembleMesh:
    """A (data, model) mesh with a model axis of size 1 trains as DP."""

    def test_fit_routes_to_dp(self, ranks, twin_dir):
        want = legs.ep_fit(twin_dir, None, "streamed", "deg_one")
        _assert_same_fit(ranks[0]["degenerate"]["fit"], want)

    @pytest.mark.parametrize("b", [8, 5])  # 5: ragged tail, no sharded axis
    def test_eval_ragged_tail_no_space_axis(self, ranks, b):
        twin = legs.ep_eval(None, b)
        got = ranks[0]["degenerate"]["eval"][b]
        assert got["counts"] == twin["counts"]
        assert got["loss"] == pytest.approx(twin["loss"], rel=RTOL)

    def test_missing_model_axis_raises(self, ranks):
        assert "no 'model' axis" in ranks[0]["guards"]["missing_axis"]


class TestEnsembleLinesearch:
    @pytest.mark.parametrize("route", ["streamed", "grids"])
    def test_lbfgs_ep_fit_matches_single_device(self, ranks, twin_dir, route):
        """L-BFGS over EP: every rank's linesearch sees the assembled value
        and slope, so the trial counts equal the twin's."""
        want = legs.ep_lbfgs(twin_dir, None, route)
        for r in ranks:
            got = r[f"lbfgs_{route}"]
            assert got["trials"] == want["trials"] and got["counts"] == want["counts"]
            _close(got["params"], want["params"], atol=1e-5)


class TestEnsembleMeshFeatures:
    def test_hybrid_dcn_ep_mesh_fit(self, ranks, twin_dir):
        """mesh_dcn_data × mesh_ensemble: DP across the emulated slices,
        the members inside one."""
        assert ranks[0]["hybrid_shape"] == {"data": 2, "model": 2}
        _assert_same_fit(ranks[0]["hybrid"], legs.ep_fit(twin_dir, None, "streamed", "hyb"))

    def test_preempt_resume_matches_unkilled(self, ranks):
        for r in ranks:
            p = r["preempt"]
            assert p["preempted"] and p["killed_step"] == 2 and p["resumed_step"] == 4
            for k, v in p["full"].items():
                np.testing.assert_array_equal(p["resumed"][k], v, err_msg=k)


class TestServeEnsembleMesh:
    """``serve --mesh-ensemble 4``: the members in 4 groups (here the CPU 4
    times), the prediction concatenated on the serving device."""

    KW = dict(grid=(16, 16, 16), max_points=4096, model="quantile",
              quantiles=(0.1, 0.3, 0.5, 0.9), device="cpu")

    def test_healthz_and_reply(self):
        import json
        import threading
        import urllib.request
        from http.server import ThreadingHTTPServer

        pipeline = tserve._Pipeline(None, mesh_ensemble=4, **self.KW)
        srv = ThreadingHTTPServer(("127.0.0.1", 0), tserve.make_handler(pipeline))
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        try:
            url = f"http://127.0.0.1:{srv.server_address[1]}"
            with urllib.request.urlopen(f"{url}/healthz", timeout=60) as r:
                info = json.loads(r.read())
            assert info["model"] == "quantile" and info["mesh_ensemble"] == 4
            import io

            buf = io.BytesIO()
            points = np.random.default_rng(0).uniform(0, 30, (2000, 3)).astype(np.float32)
            np.savez(buf, points=points, tau=np.float32(0.5))
            req = urllib.request.Request(f"{url}/predict", data=buf.getvalue(), method="POST")
            with urllib.request.urlopen(req, timeout=60) as r:
                out = np.load(io.BytesIO(r.read()))
            assert out["point_quantiles"].shape == (4, 2000)
            assert out["voxel_pred"].shape == (4, 16, 16, 16)
            np.testing.assert_array_equal(out["point_probs"], out["point_quantiles"][2])
        finally:
            srv.shutdown()
            srv.server_close()

    def test_ep_matches_unsharded_pipeline_and_jax(self):
        from scenenet_tpu.cli.serve import _Pipeline as JaxPipeline

        points = np.random.default_rng(3).uniform(0, 25, (1500, 3)).astype(np.float32)
        ref_pred, ref_probs = tserve._Pipeline(None, **self.KW).predict(points)
        ep = tserve._Pipeline(None, mesh_ensemble=4, devices=["cpu"] * 4, **self.KW)
        assert [m for _, m in ep._groups] == [[0], [1], [2], [3]]
        pred, probs = ep.predict(points)
        np.testing.assert_array_equal(pred, ref_pred)
        np.testing.assert_array_equal(probs, ref_probs)
        kw = {k: v for k, v in self.KW.items() if k != "device"}
        want_pred, want_probs = JaxPipeline(None, mesh_ensemble=4, **kw).predict(points)
        np.testing.assert_allclose(pred, want_pred, rtol=0, atol=1e-5)
        np.testing.assert_allclose(probs, want_probs, rtol=0, atol=1e-5)

    def test_batched_ep_matches_unsharded(self):
        import threading

        kw = dict(self.KW, max_points=2048)
        direct = tserve._Pipeline(None, **kw)
        batched = tserve._Pipeline(None, mesh_ensemble=4, max_batch=2,
                                   batch_window_ms=300.0, **kw)
        try:
            rng = np.random.default_rng(13)
            clouds = [rng.uniform(0, 20 + 8 * i, (700 + 150 * i, 3)).astype(np.float32)
                      for i in range(2)]
            results = [None] * 2

            def worker(i):
                results[i] = batched.predict(clouds[i])

            threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            for cloud, (pred, probs) in zip(clouds, results):
                ref_pred, ref_probs = direct.predict(cloud)
                np.testing.assert_allclose(pred, ref_pred, rtol=0, atol=ATOL)
                np.testing.assert_allclose(probs, ref_probs, rtol=0, atol=ATOL)
        finally:
            batched.close()

    def test_guards(self):
        with pytest.raises(ValueError, match="do not divide"):
            tserve._Pipeline(None, mesh_ensemble=3, **self.KW)
        with pytest.raises(ValueError, match="has none"):
            tserve._Pipeline(None, grid=(8, 8, 8), max_points=64, mesh_ensemble=2,
                             device="cpu")
