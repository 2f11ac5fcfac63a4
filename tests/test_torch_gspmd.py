"""Port parity: channel tensor parallelism (``parallel/gspmd.py``) for the
UNet and the CNN over a (data 2, model 2) mesh of gloo ranks on the CPU.

One launch of 4 ranks (``tests/torch_model_axis_legs.py:channel_ranks``,
its own timeout) runs every leg; each is held against the same code with
no mesh (the port's one-rank twin, run here, its BatchNorms in flax's
E[x²] − E[x]² form, the form the sharded step and the JAX package take) and
the UNet's and the CNN's steps also against the JAX package's
``make_gspmd_train_step`` over the same mesh of virtual CPU devices. The
cases follow ``tests/test_gspmd.py``'s classes.

Tolerances are the JAX package's own bands for its GSPMD step against one
device (``tests/test_gspmd.py``), as ``|d| ≤ atol + rtol·|ref|``: the UNet's
parameters and running statistics after a step rtol 5e-4 atol 1e-4, its
per-parameter gradients rtol 5e-3 atol 6e-4 (the channel-split convs sum
in another order, and a 1³ bottleneck BatchNorm over the batch's 8
values amplifies it), the loss rtol 1e-4; the fit rtol 5e-3 atol 5e-5; the bf16
step rtol 2e-2 atol 2e-3; the CNN's step and L-BFGS steps rtol 5e-4 atol
1e-5; forwards rtol 1e-5 atol 1e-6; confusion counts exact on a step
(they may move where a probability sits within rounding of τ over a fit:
the fit's counts within 0.05% of the voxels, as the JAX mesh legs allow).
"""

import functools
import os
import sys

import numpy as np
import pytest

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from scenenet_tpu.losses import resolve_criterion as jax_criterion
from scenenet_tpu.models import CnnBaseline as JaxCnnBaseline
from scenenet_tpu.models import UNet3D as JaxUNet3D
from scenenet_tpu.parallel import make_mesh as jax_make_mesh
from scenenet_tpu.parallel.gspmd import channel_spec as jax_channel_spec
from scenenet_tpu.parallel.gspmd import channel_specs as jax_channel_specs
from scenenet_tpu.parallel.gspmd import make_gspmd_eval_step as jax_gspmd_eval
from scenenet_tpu.parallel.gspmd import make_gspmd_train_step as jax_gspmd_train
from scenenet_tpu.train.metrics import init_metric_state as jax_metric_state
from scenenet_tpu.train.metrics import metric_counts as jax_counts
from scenenet_tpu.train.state import create_train_state
from scenenet_tpu_torch.cli import train as tcli
from scenenet_tpu_torch.parallel import launch
from scenenet_tpu_torch.parallel.gspmd import channel_spec, channel_specs
from scenenet_tpu_torch.utils.config import load_config

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_model_axis_legs as legs  # noqa: E402  (torch and the port only)

STEP_STATE = (5e-4, 1e-4)
STEP_GRADS = (5e-3, 6e-4)
FIT = (5e-3, 5e-5)
BF16 = (2e-2, 2e-3)
CNN = (5e-4, 1e-5)


def _write_dataset(root, n_fit=5, n_test=2):
    rng = np.random.default_rng(17)
    for split, n in (("fit", n_fit), ("test", n_test)):
        os.makedirs(os.path.join(root, split))
        for i in range(n):
            xyz = rng.uniform([0, 0, 0], [30, 30, 60], (1200, 3))
            labels = rng.choice([1, 2, 15], size=1200, p=[0.5, 0.35, 0.15])
            np.save(os.path.join(root, split, f"s{i}.npy"),
                    np.concatenate([xyz, labels[:, None]], axis=1))
    return root


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("tp_ranks"))
    data = _write_dataset(os.path.join(tmp, "data"))
    return launch.run_ranks("torch_model_axis_legs:channel_ranks", 4,
                            {"tmp": tmp, "data": data}, timeout=300, path=HERE)


@pytest.fixture(scope="module")
def devices8():
    assert len(jax.devices()) == 8
    return jax.devices()


@pytest.fixture(scope="module")
def tp_mesh(devices8):
    return jax_make_mesh((2, 2), axis_names=("data", "model"), devices=devices8[:4])


def _jflat(tree):
    return {".".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _agree(ranks, key, *parts):
    """The ranks after the first return hashes of their arrays: every rank
    ends with the first rank's bits."""
    first = ranks[0][key]
    for r in ranks[1:]:
        for part in parts:
            assert r[key][part] == legs.digest(first[part]), (key, part)


def _data(v):
    """An array, or the (shape, hash) a rank after the first returns."""
    return v if isinstance(v, np.ndarray) else None


def _band(got, want, rtol, atol):
    assert set(got) == set(want), set(got) ^ set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=rtol, atol=atol, err_msg=k)


def _nest(flat):
    tree = {}
    for k, v in flat.items():
        node = tree
        *path, leaf = k.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jax.numpy.asarray(v)
    return tree


@functools.lru_cache(maxsize=None)
def _load_jax(kind):
    """The JAX model and its variables, with the port model's initial values
    (the flax layout's names are JAX's: the port's checkpoints load either
    package's), nested as flax nests them."""
    flat = {k: v.detach().numpy() for k, v in legs.tp_model(kind).flax_state().items()}
    if kind == "unet":
        return JaxUNet3D(), _nest(flat)
    return JaxCnnBaseline(conv_num=4, kernel_size=(3, 3, 3)), _nest(flat)


def _jax_unet():
    return _load_jax("unet")


@functools.lru_cache(maxsize=None)
def _twin(kind, **kw):
    return legs.tp_step(None, kind, **kw)


@pytest.fixture(scope="module")
def unet_twin(tmp_path_factory):
    """The UNet's one-step fit on one rank."""
    return legs.tp_fit(str(tmp_path_factory.mktemp("tp_twin")), None, "fit_one")


@pytest.fixture(scope="module")
def jax_unet_step(tp_mesh):
    model, variables = _load_jax("unet")
    params, ms = model.split_variables(variables)
    state, tx = create_train_state(params, "sgd", 1e-2, None)
    state = state.replace(model_state=ms)
    step = jax_gspmd_train(model, jax_criterion("dice_bce")(), tx, tp_mesh)
    new, m, loss, grads = step(state, jax_metric_state(), *legs.cube_batches(n=1)[0])
    out = {f"params.{k}": v for k, v in _jflat(new.params).items()}
    out.update((f"batch_stats.{k[len('batch_stats.'):]}", v)
               for k, v in _jflat(new.model_state).items())
    return {"loss": float(loss), "counts": jax_counts(m), "state": out,
            "grads": {f"params.{k}": v for k, v in _jflat(grads).items()}}


class TestChannelRule:
    @pytest.mark.parametrize("shape,n", [((3, 3, 3, 16, 32), 4), ((3, 3, 3, 16, 1), 4),
                                         ((3, 3, 3, 16, 30), 4), ((32,), 4), ((3,), 4),
                                         ((), 4), ((32,), 1)])
    def test_spec_shapes(self, shape, n):
        assert channel_spec(shape, n) == tuple(jax_channel_spec(shape, n))

    def test_unet_sharded_leaves_equal_jax(self, tp_mesh):
        """The same leaves split as JAX's rule splits them: every kernel
        and BatchNorm vector of the ladder, not the 32 → 1 head."""
        _, variables = _jax_unet()
        want = _jspecs(variables, tp_mesh)
        port = channel_specs(legs.tp_model("unet").flax_state(),
                             _FakeMesh({"data": 2, "model": 2}))
        assert port == want
        sharded = [k for k, s in port.items() if s]
        assert len(sharded) / len(port) > 0.9 and "params.out.kernel" not in sharded


def _jspecs(variables, mesh):
    """JAX's channel specs by flattened name, as tuples."""
    return {".".join(str(getattr(k, "key", k)) for k in p): tuple(s)
            for p, s in jax.tree_util.tree_flatten_with_path(
                jax_channel_specs(variables, mesh), is_leaf=lambda s: isinstance(s, P))[0]}


class _FakeMesh:
    def __init__(self, shape):
        self.shape = shape


class TestGspmdStep:
    def test_unet_step_matches_single_device(self, ranks, jax_unet_step, unet_twin):
        """One SGD step (the Trainer's fit of one batch): the loss, every
        parameter's gradient, the parameters and the running statistics
        after it, against the twin and JAX's GSPMD step."""
        twin = unet_twin
        got = ranks[0]["fit"]
        assert got["counts"] == twin["counts"] == [jax_unet_step["counts"]]
        assert got["losses"][0] == pytest.approx(twin["losses"][0], rel=1e-4)
        assert got["losses"][0] == pytest.approx(jax_unet_step["loss"], rel=1e-4)
        _band(got["grads"], twin["grads"], *STEP_GRADS)
        _band(got["grads"], jax_unet_step["grads"], *STEP_GRADS)
        _band(got["state"], twin["state"], *STEP_STATE)
        _band(got["state"], jax_unet_step["state"], *STEP_STATE)
        _agree(ranks, "fit", "counts", "losses", "grads", "state")

    def test_params_actually_sharded(self, ranks, tp_mesh, jax_unet_step, unet_twin):
        """Each rank holds its slice of every split leaf (half of it over a
        2-wide model axis), the slice JAX's sharding puts on its device."""
        full = unet_twin["state"]
        _, variables = _jax_unet()
        jleaves = {k: P(*v) for k, v in _jspecs(variables, tp_mesh).items()}
        n_split = 0
        for r in ranks:
            local = r["fit"]["local"]
            dev = tp_mesh.devices[r["coords"]["data"], r["coords"]["model"]]
            for k, v in local.items():
                shape = v.shape if _data(v) is not None else v[0]
                if tuple(shape) != full[k].shape:
                    n_split += 1
                    assert np.prod(shape) * 2 == full[k].size, k
                want = jax.device_put(jax_unet_step["state"][k],
                                      NamedSharding(tp_mesh, jleaves[k]))
                shard = next(s for s in want.addressable_shards if s.device == dev)
                assert shard.data.shape == tuple(shape), k
        assert n_split >= 4 * 20

    def test_optimizer_state_is_sharded(self, ranks):
        """Adam's moments have the shard's shape; a snapshot gathers them."""
        got = ranks[0]["adam_state"]
        assert got["local"]["exp_avg"] == (2, 1, 3, 3, 3)
        assert got["full"]["optimizer/0/exp_avg"] == (4, 1, 3, 3, 3)
        assert got["full"]["params/weights.0"] == (4, 1, 3, 3, 3)

    def test_cnn_stateless_and_eval(self, ranks, tp_mesh):
        """The CNN (C_out 4 → 2 a rank) under Adam, and the eval twin."""
        twin = legs.tp_step(None, "cnn", optimizer="adam", lr=1e-3)
        model, params = _load_jax("cnn")
        state, tx = create_train_state(params, "adam", 1e-3, None)
        jstep = jax_gspmd_train(model, jax_criterion("dice_bce")(), tx, tp_mesh)
        (x, y), = legs.cube_batches(n=1)
        new, _, jloss, _ = jstep(state, jax_metric_state(), x, y)
        got = ranks[0]["cnn"]
        assert got["losses"][0] == pytest.approx(twin["losses"][0], rel=1e-5)
        assert got["losses"][0] == pytest.approx(float(jloss), rel=1e-4)
        _band(got["state"], twin["state"], *CNN)
        _band(got["state"], _jflat(new.params), *CNN)
        want = legs.tp_eval(None, "cnn", 8)
        _, eloss, jpred = jax_gspmd_eval(model, jax_criterion("dice_bce")(), tp_mesh)(
            params, None, jax_metric_state(), x, y)
        for r in ranks:
            e = r["eval"][8]
            d = r["coords"]["data"]
            assert e["counts"] == want["counts"]
            np.testing.assert_allclose(e["pred"], want["pred"][d * 4:(d + 1) * 4],
                                       rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(e["pred"], np.asarray(jpred)[d * 4:(d + 1) * 4],
                                       rtol=1e-5, atol=1e-6)
            assert e["loss"] == pytest.approx(float(eloss), rel=1e-4)

    def test_eval_ragged_tail_falls_back_replicated(self, ranks):
        """A batch of 5 over a 2-wide data axis: replicated, the same counts
        and loss as one device, the whole prediction on every rank."""
        want = legs.tp_eval(None, "cnn", 5)
        for r in ranks:
            got = r["eval"][5]
            assert got["counts"] == want["counts"]
            assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
            np.testing.assert_allclose(got["pred"], want["pred"], rtol=1e-5, atol=1e-6)

    def test_unshardable_model_axis_rejected(self, ranks):
        g = ranks[0]["guards"]
        assert "shards NO parameter" in g["scenenet"]
        assert "shards NO parameter" in g["cnn3"]  # 3 channels over a 4-wide axis

    def test_train_step_rejects_indivisible_batch(self, ranks):
        assert "not divisible" in ranks[0]["guards"]["indivisible"]

    def test_bf16_matches_single_device_bf16(self, ranks):
        """precision=bf16 on the bf16 UNet: K10's bf16 form on the card."""
        twin = _twin("unet", precision="bf16")
        got = ranks[0]["bf16"]
        assert got["losses"][0] == pytest.approx(twin["losses"][0], rel=5e-3)
        _band(got["state"], twin["state"], *BF16)
        _agree(ranks, "bf16", "losses", "state")

    def test_lbfgs_matches_single_device(self, ranks):
        """needs_value_fn: L-BFGS on the shards, its inner products over the
        whole vector, so every rank takes the twin's linesearch decisions."""
        twin = legs.tp_step(None, "cnn", optimizer="lbfgs", lr=0.1, n_steps=2)
        for r in ranks:
            got = r["lbfgs"]
            np.testing.assert_allclose(got["losses"], twin["losses"], rtol=1e-5)
            assert got["counts"] == twin["counts"]
            _band(got["state"], twin["state"], *CNN)


class TestTrainerIntegration:
    def test_fit_matches_single_device(self, ranks, unet_twin):
        """Trainer(mesh=(data, model)).fit on the UNet, streamed, validated
        and its gradients logged, against the twin; its best checkpoint is
        the full flax tree and loads into a one-device UNet3D."""
        want = unet_twin
        got = ranks[0]["fit"]
        _band(got["state"], want["state"], *FIT)
        voxels = 8 * 16 ** 3
        for a, b in zip(got["counts"], want["counts"]):
            assert max(abs(i - j) for i, j in zip(a, b)) <= 5e-4 * voxels
        for a, b in zip(got["scores"], want["scores"]):
            for k in ("train_loss", "val_loss"):
                assert a[k] == pytest.approx(b[k], rel=1e-3), k
        for k, v in got["restored"].items():
            np.testing.assert_array_equal(v, got["state"][k], err_msg=k)
        _agree(ranks, "fit", "state", "counts", "restored")
        assert all(r["shards"]["back_equal"] for r in ranks)

    def test_guards(self, ranks):
        assert "stream" in ranks[0]["guards"]["cached"]

    def test_preempt_resume_matches_unkilled(self, ranks):
        """A snapshot under TP holds the full tree (the shards and Adam's
        moments gathered); a fresh trainer cuts it again and ends where the
        unkilled fit ends, bit for bit."""
        for r in ranks:
            p = r["preempt"]
            assert p["preempted"] and p["killed_step"] == 2 and p["resumed_step"] == 3
            for k, v in p["full"].items():
                np.testing.assert_array_equal(p["resumed"][k], v, err_msg=k)

    def test_cli_unet_mesh_channel_end_to_end(self, ranks):
        first, second = (dict(r["cli"]["scores"]) for r in ranks[:2])
        assert np.isfinite(first["test_loss"])
        first.pop("epoch_time_s"), second.pop("epoch_time_s")
        assert first == second

    @pytest.mark.parametrize("overrides,message", [
        ({"model": "scenenet", "mesh_data": 2, "mesh_channel": 2}, "mesh_channel"),
        ({"model": "unet", "mesh_dcn_data": 2, "mesh_channel": 2}, "no DCN axis"),
        ({"model": "cnn", "mesh_channel": 2, "constrained": "admm"},
         "constrained=admm shards over data/space only"),
    ])
    def test_cli_rejects_scenenet_mesh_channel(self, monkeypatch, overrides, message):
        world = (overrides.get("mesh_data", 1) * overrides.get("mesh_dcn_data", 1)
                 * overrides["mesh_channel"])
        monkeypatch.setenv("WORLD_SIZE", str(world))
        with pytest.raises(ValueError, match=message):
            tcli.build_mesh(load_config(None, overrides), "cpu")


def test_shard_state_matches_jax_shards(ranks, tp_mesh):
    """``shard_state`` gives each rank the slice JAX's channel sharding puts
    on its device, and ``gather_state`` gives the full tree back."""
    model, variables = _load_jax("unet")
    jspecs = jax_channel_specs(variables, tp_mesh)
    placed = jax.tree.map(lambda a, s: jax.device_put(a, NamedSharding(tp_mesh, s)),
                          variables, jspecs, is_leaf=lambda s: isinstance(s, P))
    flat = {".".join(str(getattr(k, "key", k)) for k in p): a
            for p, a in jax.tree_util.tree_flatten_with_path(placed)[0]}
    for r in ranks:
        dev = tp_mesh.devices[r["coords"]["data"], r["coords"]["model"]]
        assert r["shards"]["back_equal"]
        for k, v in r["shards"]["local"].items():
            shard = np.asarray(next(s for s in flat[k].addressable_shards
                                    if s.device == dev).data)
            if _data(v) is not None:
                np.testing.assert_array_equal(v, shard, err_msg=k)
            else:
                assert v == legs.digest(shard), k
