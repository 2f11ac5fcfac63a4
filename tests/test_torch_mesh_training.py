"""Port parity: mesh training (``Trainer(mesh=...)``, ``ADMMTrainer(mesh=...)``,
``cli.train --set mesh_data=...``) on gloo ranks on the CPU.

Two launches (module-scoped fixtures, ``tests/torch_mesh_legs.py``), each
under its own timeout: 2 ranks on a (data 2, space 1) mesh, and 4 ranks on
(2, 2) and on the hybrid mesh 2 × (1 × 2). Every leg is a short fit, held
against the same code with no mesh (the single-device twin, run here), and
the grid fits over (2, 1), (2, 2) and the hybrid also against the JAX
package's single-device ``Trainer`` on the same batches, which its own
tests hold equal to its ``Trainer(mesh=...)``.

Tolerances: losses rtol 1e-5 against the twin (f32 sums in another order,
and bf16 forwards on the same values), 1e-4 against JAX (XLA's CPU sums the
f32 weighted MSE over 36864 voxels 3.7e-4 away from its float64 value at
z=32, where torch's sum is within 2e-7 of it); confusion counts exact;
parameters after the fit atol 1e-6 (bf16 1e-5: the slab's conv rounds a
few outputs to the neighbouring bf16 value, which moves 6 SGD steps of lr
1e-2 by up to 3e-6); the sync-BN UNet's running statistics rtol 1e-5 (1e-7 absolute
near 0); the preempted-and-resumed fit bit for bit; the scores against JAX
1e-6 (JAX computes them in f32 from the same counts).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from scenenet_tpu.losses import resolve_criterion as jax_criterion
from scenenet_tpu.models import SceneNet as JaxSceneNet
from scenenet_tpu.train import TrainConfig as JaxTrainConfig
from scenenet_tpu.train import Trainer as JaxTrainer
from scenenet_tpu_torch.cli import train as tcli
from scenenet_tpu_torch.parallel import launch
from scenenet_tpu_torch.utils.config import load_config

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_mesh_legs as legs  # noqa: E402  (torch and the port only)

RTOL = 1e-5
RTOL_JAX = 1e-4
PARAM_ATOL = 1e-6
SCORES = ("JaccardIndex", "Precision", "Recall", "F1Score", "FBetaScore")


def _write_dataset(root, n_fit=8, n_test=2):
    """A TS40K-style directory of (N, 4) xyz + label crops."""
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
def dataset(tmp_path_factory):
    return _write_dataset(str(tmp_path_factory.mktemp("mesh_ts40k") / "data"))


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory, dataset):
    tmp = str(tmp_path_factory.mktemp("mesh2"))
    return launch.run_ranks("torch_mesh_legs:training_2_ranks", 2,
                            {"tmp": tmp, "data": dataset}, timeout=300, path=HERE)


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("mesh4"))
    return launch.run_ranks("torch_mesh_legs:training_4_ranks", 4, {"tmp": tmp},
                            timeout=300, path=HERE)


@pytest.fixture(scope="module")
def twin_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("twins"))


def _losses(result, key="train_loss"):
    return [s[key] for _, s in result["scores"] if key in s]


def _assert_same_fit(got, want, param_atol=PARAM_ATOL):
    assert got["counts"] == want["counts"]
    np.testing.assert_allclose(_losses(got), _losses(want), rtol=RTOL)
    np.testing.assert_allclose(_losses(got, "val_loss"), _losses(want, "val_loss"), rtol=RTOL)
    assert set(got["params"]) == set(want["params"])
    for k, v in want["params"].items():
        np.testing.assert_allclose(got["params"][k], v, rtol=0, atol=param_atol, err_msg=k)


def _assert_ranks_agree(results, key):
    """Every rank ends the fit with the same parameters and scores."""
    first = results[0][key]
    for r in results[1:]:
        for k, v in first["params"].items():
            np.testing.assert_array_equal(r[key]["params"][k], v, err_msg=k)
        assert r[key]["counts"] == first["counts"]


def _jax_fit(tmp, z):
    """The JAX package's single-device Trainer on the legs' grid batches:
    its per-epoch scores from its metrics log."""
    jnet, jparams = JaxSceneNet.create(kernel_size=legs.KS, seed=0)
    run_dir = os.path.join(tmp, f"jax_run_{z}")
    cfg = JaxTrainConfig(max_epochs=2, optimizer="sgd", learning_rate=1e-2,
                         early_stop_metric=None, run_dir=run_dir, log_gradients=False,
                         checkpoint_dir=os.path.join(tmp, f"jax_ckpt_{z}"))
    batches = [tuple(jnp.asarray(a) for a in b) for b in legs.grid_batches(z=z)]
    JaxTrainer(jnet, jax_criterion("geneo_tversky")(**legs.DEFAULTS), cfg).fit(
        jparams, batches, val_loader=batches[:1])
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def jax_fits(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("jax_fits"))
    return {z: _jax_fit(tmp, z) for z in (16, 32)}


def _assert_matches_jax(got, jax_epochs):
    scores = [s for _, s in got["scores"]]
    assert len(scores) == len(jax_epochs) == 2
    for mine, ref in zip(scores, jax_epochs):
        for key in ("train_loss", "val_loss"):
            assert mine[key] == pytest.approx(ref[key], rel=RTOL_JAX), key
        for name in SCORES:
            for split in ("train", "val"):
                key = f"{split}_{name}"
                assert mine[key] == pytest.approx(ref[key], rel=1e-6, abs=1e-6), key


# ---- the grid fits over (2, 1), (2, 2) and the hybrid, against JAX ----------------------

def test_dp_fit_matches_jax_and_the_twin(ranks2, twin_dir, jax_fits):
    _assert_ranks_agree(ranks2, "dp")
    _assert_same_fit(ranks2[0]["dp"], legs.fit_leg("dp", twin_dir))
    _assert_matches_jax(ranks2[0]["dp"], jax_fits[16])


def test_data_space_fit_matches_jax_and_the_twin(ranks4, twin_dir, jax_fits):
    """(2, 2), Z sharded with the overlapped halo conv: the counts exact."""
    _assert_ranks_agree(ranks4, "space")
    _assert_same_fit(ranks4[0]["space"], legs.fit_leg("space", twin_dir))
    _assert_matches_jax(ranks4[0]["space"], jax_fits[32])


def test_hybrid_mesh_fit_matches_jax_and_the_twin(ranks4, twin_dir, jax_fits):
    """dcn 2 × (data 1 × space 2): the data axis crosses the emulated slices."""
    assert ranks4[0]["hybrid_shape"] == {"data": 2, "space": 2}
    _assert_ranks_agree(ranks4, "hybrid")
    _assert_same_fit(ranks4[0]["hybrid"], legs.fit_leg("hybrid", twin_dir))
    _assert_matches_jax(ranks4[0]["hybrid"], jax_fits[32])


# ---- the other legs, against the single-device twin ---------------------------------------

@pytest.mark.parametrize("kind", ["raw", "quantile", "cnn"])
def test_pure_dp_fits_match_the_twin(ranks2, twin_dir, kind):
    """The raw prep voxelizes each rank's own samples; the quantile ensemble
    and the CNN train pure-DP as any stateless model."""
    _assert_ranks_agree(ranks2, kind)
    _assert_same_fit(ranks2[0][kind], legs.fit_leg(kind, twin_dir))


def test_raw_prep_with_a_space_axis_matches_the_twin(ranks4, twin_dir):
    """Each rank prepares its rows' whole grids and keeps its z slab."""
    _assert_ranks_agree(ranks4, "raw_space")
    _assert_same_fit(ranks4[0]["raw_space"], legs.fit_leg("raw", twin_dir, tag="raw_sp"))


def test_bf16_fit_matches_the_twin(ranks2, twin_dir):
    _assert_ranks_agree(ranks2, "bf16")
    _assert_same_fit(ranks2[0]["bf16"], legs.fit_leg("dp", twin_dir, tag="bf16",
                                                     precision="bf16"), param_atol=1e-5)


def test_lbfgs_trial_counts_equal_on_every_rank_and_the_twin(ranks2, twin_dir):
    want = legs.fit_leg("dp", twin_dir, tag="lbfgs", optimizer="lbfgs", learning_rate=0.1)
    for r in ranks2:
        assert r["lbfgs"]["trials"] == want["trials"]
        np.testing.assert_allclose(r["lbfgs"]["losses"], want["losses"], rtol=RTOL)
        for k, v in want["params"].items():
            np.testing.assert_allclose(r["lbfgs"]["params"][k], v, atol=PARAM_ATOL, err_msg=k)
    assert max(want["trials"]) > 1  # the linesearch searched


def test_sync_bn_unet_matches_the_twin(ranks2, twin_dir):
    """The UNet at 32³, batch 4 over 2 ranks: BatchNorm statistics averaged
    over the data axis, so the running statistics are the single-device
    fit's, and the same on both ranks."""
    want = legs.fit_leg("unet", twin_dir)
    got = ranks2[0]["unet"]
    assert got["counts"] == want["counts"]
    np.testing.assert_allclose(_losses(got), _losses(want), rtol=RTOL)
    assert set(got["stats"]) == set(want["stats"]) and len(want["stats"]) == 36
    for k, v in want["stats"].items():
        np.testing.assert_allclose(got["stats"][k], v, rtol=RTOL, atol=1e-7, err_msg=k)
        np.testing.assert_array_equal(ranks2[1]["unet"]["stats"][k], got["stats"][k])


@pytest.mark.parametrize("kind", ["grids", "points"])
def test_cached_fits_match_the_twin(ranks2, twin_dir, kind):
    """Replicated cache and draws, each rank its rows: the grid cache with
    D4 draws, the point cache with rotations and flips (the prep on the
    rank's samples)."""
    _assert_ranks_agree(ranks2, f"cached_{kind}")
    _assert_same_fit(ranks2[0][f"cached_{kind}"], legs.cached_leg(kind, twin_dir))


@pytest.mark.parametrize("route", ["streamed", "cached"])
def test_accumulation_matches_the_twin(ranks2, twin_dir, route):
    if route == "streamed":
        want = legs.fit_leg("dp", twin_dir, tag="acc2", accumulate_grad_batches=2)
        got = ranks2[0]["acc2"]
    else:
        want = legs.cached_leg("plain", twin_dir, accumulate_grad_batches=2)
        got = ranks2[0]["cached_acc2"]
    _assert_same_fit(got, want)


def test_ragged_tail_evaluation_matches_the_twin(ranks2, ranks4, twin_dir):
    """A loader of batches 8, 8, 5 (the 5 replicated over data, reduced over
    space alone) and a grid cache of 21 in batches of 8."""
    for got, z in ((ranks2[0]["eval"], 12), (ranks4[0]["eval_space"], 16)):
        want = legs.eval_leg(twin_dir, z=z)
        for part, scores in want.items():
            for k, v in scores.items():
                assert got[part][k] == pytest.approx(v, rel=RTOL, abs=1e-9), (part, k)


def test_preempt_and_resume_is_bit_identical(ranks2):
    for r in ranks2:
        p = r["preempt"]
        # 2 steps, the snapshot, then a fresh trainer takes the third
        assert p["preempted"] and p["killed_step"] == 2 and p["resumed_step"] == 3
        for k, v in p["full"].items():
            np.testing.assert_array_equal(p["resumed"][k], v, err_msg=k)


def test_admm_over_a_mesh_matches_the_twin(ranks2, ranks4, twin_dir):
    for got, z in ((ranks2[0]["admm"], 16), (ranks4[0]["admm_space"], 32)):
        want = legs.admm_leg(twin_dir, z=z)
        for a, b in zip(got["history"], want["history"]):
            for k in ("max_violation", "mu_norm", "train_loss"):
                assert a[k] == pytest.approx(b[k], rel=RTOL), k
        for k, v in want["params"].items():
            np.testing.assert_allclose(got["params"][k], v, atol=PARAM_ATOL, err_msg=k)


def test_guards(ranks2, ranks4):
    g2 = ranks2[0]["guards"]
    assert g2["indivisible"] == ("batch 3 not divisible by mesh 'data' axis (2); use "
                                 "drop_last or a divisible batch size")
    assert g2["cached_batch"] == "batch_size 3 must divide by the mesh data axis (2)"
    assert g2["unet_cached"].startswith("cached-epoch mesh training supports stateless "
                                        "models only")
    g4 = ranks4[0]["guards"]
    assert g4["z_indivisible"] == "grid Z extent 15 not divisible by mesh 'space' axis (2)"
    assert g4["cached_space"].startswith("cached-epoch mesh training is pure-DP")
    assert g4["unet_space"].startswith("stateful models do not support spatial sharding")
    assert "SceneNet forward protocol" in g4["cnn_space"]


# ---- cli.train --------------------------------------------------------------------------------

def test_cli_train_on_the_ranks(ranks2):
    """``cli.train --set mesh_data=2`` on the launch's ranks (the grid cache,
    pure DP), and the guard of a dataset smaller than one batch."""
    for r in ranks2:
        scores = r["cli"]["scores"]
        assert np.isfinite(scores["train_loss"]) and np.isfinite(scores["test_loss"])
        assert r["cli"]["too_small"].startswith("mesh training needs at least one full batch")
        assert np.isfinite(r["cli"]["dcn_scores"]["train_loss"])
    first, second = (dict(r["cli"]["scores"]) for r in ranks2)
    first.pop("epoch_time_s"), second.pop("epoch_time_s")  # each rank's own clock
    assert first == second


@pytest.mark.parametrize("overrides,message", [
    ({"mesh_data": 2, "mesh_space": 2}, "= 4 devices, but 2 are visible"),
    ({"mesh_space": 2, "model": "unet"}, "spatial sharding (mesh_space > 1) is implemented "
                                         "for the scenenet model (got model='unet')"),
    ({"mesh_data": 2, "batch_size": 3}, "batch_size 3 must divide by the data shards (2)"),
    ({"mesh_space": 2, "voxel_grid_size": (16, 16, 15)},
     "grid Z extent 15 must divide by mesh_space (2)"),
])
def test_cli_mesh_guards(monkeypatch, overrides, message):
    """The JAX CLI's guards, with its messages, before any process group."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    cfg = load_config(None, overrides)
    with pytest.raises(ValueError) as err:
        tcli.build_mesh(cfg, "cpu")
    assert message in str(err.value)


def test_nccl_refuses_two_ranks_on_one_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="NCCL refuses two ranks on one GPU"):
        launch.check_backend("nccl", torch.device("cuda", 0), 2)
    launch.check_backend("gloo", torch.device("cuda", 0), 2)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        launch.check_backend("nccl", torch.device("cpu"), 1)


def test_cli_model_axis_still_raises(monkeypatch):
    """The model axis is ported: on a model it does not fit it raises the
    JAX CLI's guard, before any process group (the EP and TP runs are in
    tests/test_torch_ensemble_parallel.py and tests/test_torch_gspmd.py)."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    for key, message in (("mesh_ensemble", "ensemble parallelism \\(mesh_ensemble > 1\\)"),
                         ("mesh_channel", "channel tensor parallelism \\(mesh_channel > 1\\)")):
        with pytest.raises(ValueError, match=message):
            tcli.run(load_config(None, {key: 2}), device="cpu")


def test_cli_train_under_torch_distributed_run(dataset, tmp_path):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
           "--master-addr", "localhost", "--master-port", str(launch.free_port()),
           "-m", "scenenet_tpu_torch.cli.train", "--device", "cpu", "--dist-backend", "gloo",
           "--set", "mesh_data=2", f"data_path={dataset}", f"output_dir={tmp_path}",
           "batch_size=2", "voxel_grid_size=(8, 8, 8)", "kernel_size=(3, 3, 3)",
           "max_points=1024", "max_epochs=1", "num_workers=1", "device_cache=false"]
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(p for p in (os.path.dirname(HERE),
                                                     os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=180, env=env)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "[mesh] training over {'data': 2, 'space': 1}" in proc.stdout
    assert proc.stdout.count("test_loss") == 2  # each rank tests the same model
