"""Port parity: ``scenenet_tpu_torch.parallel`` on gloo ranks on the CPU
against ``scenenet_tpu.parallel`` on the 8-device virtual mesh.

The ranks run once a launch (a module-scoped fixture,
``tests/torch_mesh_legs.py``: 4 ranks for the meshes, the collectives,
the halo conv, the spatial forward and the inference functions; 2 ranks
for the sharded checkpoint), each launch under its own timeout, and the
tests hold what they returned.

Tolerances: the halo conv within 1e-6 relative (and 1e-6 absolute near 0)
of the unsharded conv and of JAX's ``halo_conv3d``: torch's CPU conv may
take another algorithm for a slab than for the whole volume, so the sums
of 225 products of values in [0, 1] (outputs up to ~7) differ by a few f32
units, not bit for bit; the spatial forward and its
parameter gradients rtol 1e-5 against JAX's ``spatial_scenenet_forward``
under ``shard_map``; mesh layouts exact.
"""

import json
import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from scenenet_tpu.losses import resolve_criterion as jax_criterion
from scenenet_tpu.models import SceneNet as JaxSceneNet
from scenenet_tpu.ops.conv3d import conv3d_same as jax_conv3d_same
from scenenet_tpu.parallel import make_hybrid_mesh as jax_hybrid_mesh
from scenenet_tpu.parallel import make_mesh as jax_make_mesh
from scenenet_tpu.parallel.dp import make_distributed as jax_make_distributed
from scenenet_tpu.parallel.spatial import halo_conv3d as jax_halo_conv3d
from scenenet_tpu.parallel.spatial import spatial_scenenet_forward as jax_spatial
from scenenet_tpu.train.checkpoint import save_checkpoint_sharded as jax_save_sharded
from scenenet_tpu_torch.losses import resolve_criterion
from scenenet_tpu_torch.models import SceneNet
from scenenet_tpu_torch.ops.conv3d import conv3d_same
from scenenet_tpu_torch.parallel import launch, make_distributed, make_hybrid_mesh, make_mesh

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_mesh_legs as legs  # noqa: E402  (torch and the port only)

HALO_TOL = 1e-6
RTOL = 1e-5


@pytest.fixture(scope="module")
def ranks4():
    return launch.run_ranks("torch_mesh_legs:parallel_ranks", 4, timeout=240, path=HERE)


@pytest.fixture(scope="module")
def devices8():
    assert len(jax.devices()) == 8
    return jax.devices()


def _jflat(tree):
    return {".".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ---- meshes and collectives --------------------------------------------------------

def test_mesh_rank_order_is_jax_device_order(ranks4, devices8):
    d = devices8[:4]
    want = {
        "mesh_4x1": jax_make_mesh((4, 1), devices=d),
        "mesh_2x2": jax_make_mesh((2, 2), devices=d),
        "hybrid_dcn_data": jax_hybrid_mesh((2, 1), (1, 2), devices=d),
        "hybrid_dcn_space": jax_hybrid_mesh((1, 2), (2, 1), devices=d),
    }
    for r in ranks4:
        for name, mesh in want.items():
            ids = np.vectorize(lambda dev: dev.id)(mesh.devices)
            np.testing.assert_array_equal(r["order"][name], ids, err_msg=name)


def test_hybrid_rank_grid_matches_jax_at_8(devices8):
    from scenenet_tpu_torch.parallel.mesh import hybrid_rank_grid

    for dcn, ici in (((2, 1), (2, 2)), ((2, 1), (1, 4)), ((1, 2), (4, 1)), ((4, 1), (1, 2))):
        ids = np.vectorize(lambda dev: dev.id)(jax_hybrid_mesh(dcn, ici, devices=devices8).devices)
        np.testing.assert_array_equal(hybrid_rank_grid(dcn, ici, list(range(8))), ids)


def test_mesh_shape_errors_match_jax(devices8):
    cases = [(lambda m: m((2, 1), (1,)), "one factor per mesh axis"),
             (lambda m: m((2, 1, 1), (1, 2, 1)), "axis names for"),
             (lambda m: m((2, 1), (1, 2)), "needs 4 devices")]
    for make, what in cases:
        with pytest.raises(ValueError, match=what) as port:
            make(lambda a, b: make_hybrid_mesh(a, b, devices=list(range(3))))
        with pytest.raises(ValueError, match=what) as ref:
            make(lambda a, b: jax_hybrid_mesh(a, b, devices=devices8[:3]))
        assert str(port.value) == str(ref.value)
    with pytest.raises(ValueError, match=r"mesh shape \(2, 2\) != 1 devices"):
        make_mesh((2, 2))


def test_collectives_shift_psum_and_their_gradients(ranks4):
    """ppermute ±1 with zeros at the ends; psum's backward sums the
    cotangents over the ranks (JAX's transpose: d/dx psum(x²) = 4·2x)."""
    for r in ranks4:
        c = r["collectives"]
        s = c["coords"]["space"]
        assert c["up"] == (float(s) if s > 0 else 0.0)
        assert c["down"] == (float(s + 2) if s < 3 else 0.0)
        assert c["psum"] == 1 + 4 + 9 + 16 and c["pmean"] == 2.5
        assert c["grad"] == 4 * 2 * (s + 1)


def test_local_batch_size_and_global_batch_from_local(ranks4):
    rows = np.arange(2 * 3 * 4 * 2 * 2, dtype=np.float32).reshape(2, 3, 4, 2, 2)
    for r in ranks4:
        assert r["local_batch"] == 8
        assert r["local_batch_error"] == "global batch 15 not divisible by 2 processes"
        s = r["local_rows"]["coords"]["space"]
        grid, flat = r["local_rows"]["parts"]
        np.testing.assert_array_equal(grid, rows[:, :, 2 * s:2 * s + 2])
        np.testing.assert_array_equal(flat, rows[:, 0])  # no Z axis: kept whole


@pytest.mark.parametrize("name", ["geneo_tversky", "geneo_dice_bce", "dice_bce", "geneo_dice",
                                  "quantile_geneo", "mse", "tversky"])
def test_make_distributed_sets_the_same_axes_as_jax(name):
    axes = ("data", "space")

    def named(c, prefix=""):
        import dataclasses

        out = {}
        for f in dataclasses.fields(c):
            v = getattr(c, f.name)
            if f.name == "axis_names":
                out[prefix + f.name] = tuple(v)
            elif dataclasses.is_dataclass(v):
                out.update(named(v, f"{prefix}{f.name}."))
        return out

    port = named(make_distributed(resolve_criterion(name)(), axes))
    ref = named(jax_make_distributed(jax_criterion(name)(), axes))
    assert port == ref and port and set(port.values()) == {axes}


# ---- the halo conv and the spatial forward -----------------------------------------

@pytest.mark.parametrize("kz", legs.HALO_KZ)
@pytest.mark.parametrize("n_space", [2, 4])
@pytest.mark.parametrize("overlap", [False, True])
def test_halo_conv3d_matches_unsharded_and_jax(ranks4, devices8, kz, n_space, overlap):
    x, k = legs.halo_inputs(kz)
    ref = conv3d_same(torch.from_numpy(x), torch.from_numpy(k)).numpy()
    mesh = jax_make_mesh((1, n_space), devices=devices8[:n_space])
    spec = P(None, None, "space", None, None)
    jout = np.asarray(jax.jit(shard_map(
        lambda xs: jax_halo_conv3d(xs, jnp.asarray(k), "space", overlap=overlap),
        mesh=mesh, in_specs=spec, out_specs=spec))(
        jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec))))
    np.testing.assert_allclose(ref, np.asarray(jax_conv3d_same(jnp.asarray(x), jnp.asarray(k))),
                               atol=HALO_TOL, rtol=HALO_TOL)
    for backend in ("torch", "cuda"):
        slabs = [r["halo"][(n_space, kz, overlap, backend)] for r in
                 sorted((r for r in ranks4 if r["coords"][n_space]["data"] == 0),
                        key=lambda r: r["coords"][n_space]["space"])]
        got = np.concatenate(slabs, axis=2)
        np.testing.assert_allclose(got, ref, atol=HALO_TOL, rtol=HALO_TOL, err_msg=backend)
        np.testing.assert_allclose(got, jout, atol=HALO_TOL, rtol=HALO_TOL, err_msg=backend)


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_spatial_forward_and_gradients_match_jax(ranks4, devices8, shape):
    """SceneNet's z-sharded forward (overlapped on (2, 2)) and the
    parameter gradients of a global-sum loss against JAX's
    ``spatial_scenenet_forward`` under ``shard_map``."""
    x, w = legs.spatial_inputs()
    jnet, jparams = JaxSceneNet.create(kernel_size=legs.KS, seed=0)
    mesh = jax_make_mesh(shape, devices=devices8[:4])
    spec = P("data", None, "space", None, None)
    fwd = shard_map(lambda p, xs: jax_spatial(jnet, p, xs, "space", overlap=shape == (2, 2)),
                    mesh=mesh, in_specs=(P(), spec), out_specs=spec, check_vma=False)
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec))

    def loss(p):
        return jnp.sum(fwd(p, xs) * jnp.asarray(w))

    jpred = np.asarray(jax.jit(fwd)(jparams, xs))
    jloss, jgrads = jax.jit(jax.value_and_grad(loss))(jparams)
    jgrads = _jflat(jgrads)
    rows, zs = x.shape[0] // shape[0], x.shape[2] // shape[1]
    pred = np.zeros_like(x)
    for r in ranks4:
        got = r["spatial"][shape]
        d, s = got["coords"]["data"], got["coords"]["space"]
        pred[d * rows:(d + 1) * rows, :, s * zs:(s + 1) * zs] = got["pred"]
        assert got["loss"] == pytest.approx(float(jloss), rel=RTOL)
        # the derived last λ and a parameter the kernel does not read get no
        # gradient in torch; JAX gives them zeros
        assert set(got["grads"]) <= set(jgrads)
        for name in set(jgrads) - set(got["grads"]):
            assert not np.any(jgrads[name]), name
        for name, g in got["grads"].items():
            np.testing.assert_allclose(g, jgrads[name], rtol=RTOL, atol=1e-6, err_msg=name)
        # every rank holds the same averaged gradients
        for name, g in got["grads"].items():
            np.testing.assert_array_equal(g, ranks4[0]["spatial"][shape]["grads"][name])
    np.testing.assert_allclose(pred, jpred, rtol=RTOL, atol=1e-6)
    net = SceneNet.create(kernel_size=legs.KS, seed=0)
    np.testing.assert_allclose(pred, net(torch.from_numpy(x)).detach().numpy(), atol=1e-6)


def test_dp_inference_fns(ranks4):
    """Pure DP with ``inference="mxu"`` (K5's plain version here) and the
    z-sharded forward-only halo form, against the unsharded forwards."""
    rng = np.random.default_rng(3)
    xi = (rng.random((4, 1, 32, 16, 16)) > 0.9).astype(np.float32)
    net = SceneNet.create(kernel_size=legs.KS, seed=0, backend="cuda")
    with torch.no_grad():
        want_mxu = net(torch.from_numpy(xi), inference="mxu").numpy()
        want = net(torch.from_numpy(xi), inference=True).numpy()
    for r in ranks4:
        inf = r["inference"]
        d = inf["dp_coords"]["data"]
        np.testing.assert_allclose(inf["dp_mxu"], want_mxu[d:d + 1], atol=1e-6)
        d, s = inf["sp_coords"]["data"], inf["sp_coords"]["space"]
        np.testing.assert_allclose(inf["sp"], want[2 * d:2 * d + 2, :, 16 * s:16 * s + 16],
                                   atol=1e-6)


def test_sharded_train_and_eval_steps(ranks4, devices8):
    """``make_sharded_train_step`` and ``make_sharded_eval_step`` (a ragged
    batch of 3) on (2, 2): against the one-device step of the same code and
    JAX's ``make_sharded_train_step`` on the same mesh shape."""
    from scenenet_tpu.parallel import make_sharded_train_step as jax_step
    from scenenet_tpu.train import metrics as jmetrics
    from scenenet_tpu.train.state import create_train_state

    want = legs.dp_functions(torch.device("cpu"), None)
    for r in ranks4:
        got = r["dp_fns"]
        assert got["train"]["counts"] == want["train"]["counts"]
        assert got["eval"]["counts"] == want["eval"]["counts"]
        assert got["train"]["loss"] == pytest.approx(want["train"]["loss"], rel=RTOL)
        assert got["eval"]["loss"] == pytest.approx(want["eval"]["loss"], rel=RTOL)
        for k, v in want["train"]["params"].items():
            np.testing.assert_allclose(got["train"]["params"][k], v, atol=1e-6, err_msg=k)
    jnet, jparams = JaxSceneNet.create(kernel_size=legs.KS, seed=0)
    state, tx = create_train_state(jparams, "sgd", 1e-2, jnet.trainable_mask(jparams))
    step = jax_step(jnet, jax_criterion("geneo_tversky")(**legs.DEFAULTS), tx,
                    jax_make_mesh((2, 2), devices=devices8[:4]))
    x, y = legs.dp_step_inputs()
    _, m, loss = step(state, jmetrics.init_metric_state(), x, y)[:3]
    assert jmetrics.metric_counts(m) == tuple(want["train"]["counts"])
    assert float(loss) == pytest.approx(want["train"]["loss"], rel=1e-4)


# ---- sharded checkpoints ---------------------------------------------------------------

def test_sharded_checkpoint_round_trip_and_jax_layout(tmp_path, devices8):
    prefix = str(tmp_path / "port" / "ckpt")
    got = launch.run_ranks("torch_mesh_legs:checkpoint_ranks", 2, {"prefix": prefix},
                           timeout=120, path=HERE)
    grid = np.arange(4 * 1 * 4 * 2 * 2, dtype=np.float32).reshape(4, 1, 4, 2, 2)
    for r in got:
        np.testing.assert_array_equal(r["a"], np.arange(12, dtype=np.float32).reshape(3, 4))
        assert r["b"] == 2.5 and r["step"] == 7
        np.testing.assert_array_equal(r["grid"], r["grid_want"])
    np.testing.assert_array_equal(np.concatenate([r["grid"] for r in got]), grid)
    # JAX's writer on the same tree, the grid split over 2 devices of one process
    mesh = jax_make_mesh((2, 1), devices=devices8[:2])
    jprefix = str(tmp_path / "jax" / "ckpt")
    jax_save_sharded(jprefix, {
        "params": {"a": jnp.arange(12, dtype=jnp.float32).reshape(3, 4),
                   "b": jnp.asarray(2.5, jnp.float32)},
        "step": np.int64(7),
        "grid": jax.device_put(jnp.asarray(grid), NamedSharding(
            mesh, P("data", None, None, None, None)))}, {"epoch": 3})
    with np.load(jprefix + ".proc0.npz") as data:
        jkeys = sorted(data.files)
    with open(jprefix + ".proc0.index.json") as f:
        jindex = json.load(f)
    # a rank has one device: JAX's ordinal k of the grid is rank k's @0
    assert got[0]["keys"] == [k for k in jkeys if k != "grid@1"]
    assert got[1]["keys"] == got[0]["keys"]
    for rank, r in enumerate(got):
        assert r["index"]["grid@0"] == jindex[f"grid@{rank}"]
        assert r["index"]["params/a@0"] == jindex["params/a@0"]
    with open(prefix + ".meta.json") as f:
        meta = json.load(f)
    with open(jprefix + ".meta.json") as f:
        jmeta = json.load(f)
    assert meta["shapes"] == jmeta["shapes"] and meta["metadata"] == jmeta["metadata"]
    assert meta["process_count"] == 2 and jmeta["process_count"] == 1
    assert sorted(os.listdir(tmp_path / "port")) == [
        "ckpt.meta.json", "ckpt.proc0.index.json", "ckpt.proc0.npz",
        "ckpt.proc1.index.json", "ckpt.proc1.npz"]


def test_sharded_checkpoint_refuses_another_process_count(tmp_path):
    from scenenet_tpu_torch.train.checkpoint import (
        restore_checkpoint_sharded, save_checkpoint_sharded,
    )

    prefix = str(tmp_path / "c")
    save_checkpoint_sharded(prefix, {"a": torch.ones(2)})
    with open(prefix + ".meta.json") as f:
        meta = json.load(f)
    meta["process_count"] = 2
    with open(prefix + ".meta.json", "w") as f:
        json.dump(meta, f)
    with pytest.raises(ValueError, match="written by 2 processes, restoring under 1"):
        restore_checkpoint_sharded(prefix, {"a": torch.zeros(2)})


def test_run_ranks_kills_a_hung_launch():
    """A rank that never reaches its collective's partner ends the launch
    at its timeout, with every rank killed."""
    with pytest.raises(RuntimeError, match="timed out after 10 s"):
        launch.run_ranks("torch_mesh_legs:hang_ranks", 2, timeout=10, path=HERE)
