"""Port parity: the reference-checkpoint compat layer and the inspect CLI,
against the JAX package.

The reference's Lightning ``.ckpt`` files and its source tree are not
in the repository, so the checkpoints here are written with
``torch.save`` in the reference's layout (``model.geneos.<obs>.
geneo_params.<p>``, ``model.lambdas_dict.lambda_<obs>``, hyper
parameters, a class from a package that does not import), one of them
without ``kernel_size`` (the reference's default (9, 6, 6), an even
kernel). Both packages import each file: the parameters are equal, and the
effective λ and the synthesized kernels agree within 1e-6 (the two
packages' synthesis arithmetic rounds apart by a few units in the last
place). Exports round-trip across the packages; the model-zoo scan
reports the same entries; the inspect CLI writes the same table and
kernel PLYs.
"""

import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from scenenet_tpu.cli import inspect as jax_inspect
from scenenet_tpu.compat import export_torch_state_dict as jax_export
from scenenet_tpu.compat import import_scenenet_params as jax_import
from scenenet_tpu.compat import load_legacy_state_dict as jax_legacy
from scenenet_tpu.compat import load_lightning_checkpoint as jax_load_lightning
from scenenet_tpu.compat import scan_model_zoo as jax_scan
from scenenet_tpu.compat.reference_oracle import load_reference as jax_load_reference
from scenenet_tpu.models import SceneNet as JaxSceneNet
from scenenet_tpu_torch.cli import inspect as tinspect
from scenenet_tpu_torch.compat import (
    export_torch_state_dict, import_scenenet_params, load_legacy_state_dict,
    load_lightning_checkpoint, scan_model_zoo,
)
from scenenet_tpu_torch.compat import reference_oracle
from scenenet_tpu_torch.models import SceneNet
from scenenet_tpu_torch.train.checkpoint import save_checkpoint


class _Callback:
    """A class of a package the importer does not have (Lightning's
    callbacks in a real ``.ckpt``)."""

    def __init__(self):
        self.best = 0.25


def _with_foreign_class(obj_factory):
    """An object whose class lives in a module that is gone at load time."""
    mod = types.ModuleType("pl_stub_callbacks")
    cls = type("ModelCheckpoint", (_Callback,), {"__module__": "pl_stub_callbacks"})
    mod.ModelCheckpoint = cls
    sys.modules["pl_stub_callbacks"] = mod
    return obj_factory(cls)


def _write_ckpt(path, geneo_num, kernel_size, seed, with_kernel_size=True, hp_geneo_num=None):
    """A Lightning-shaped checkpoint of random parameters in the reference's
    key layout; the frozen λ already synced to 1 − Σ others. ``hp_geneo_num``
    writes other observer counts into the hyper parameters."""
    src = SceneNet.create(geneo_num, kernel_size or (9, 6, 6), seed=seed)
    sd = {}
    for name, _ in src.observers:
        for p, v in src.geneo[name].items():
            sd[f"model.geneos.{name}.geneo_params.{p}"] = v.detach().clone()
    with torch.no_grad():
        for ln, v in zip(src.lambda_names, src.effective_lambdas()):
            sd[f"model.lambdas_dict.{ln}"] = v.clone()
    hp = {"geneo_num": dict(hp_geneo_num or geneo_num)}
    if with_kernel_size:
        hp["kernel_size"] = tuple(kernel_size)
    try:
        ck = _with_foreign_class(lambda cls: {
            "state_dict": sd, "hyper_parameters": hp, "epoch": 7, "global_step": 91,
            "callbacks": {"ModelCheckpoint": cls()}})
        torch.save(ck, path)
    finally:
        sys.modules.pop("pl_stub_callbacks", None)
    return src


CKPTS = {
    "955": ({"cy": 1, "cone": 1, "neg": 1}, (9, 5, 5), True),
    "no_kernel_size": ({"cy": 1, "cone": 1, "neg": 1}, None, False),  # → (9, 6, 6)
    "two_cy": ({"cy": 2, "cone": 1, "neg": 1}, (7, 5, 5), True),
}


def _assert_same_model(port, jmodel, jparams):
    assert port.kernel_size == jmodel.kernel_size
    assert port.observers == jmodel.observers
    assert port.last_lambda == jmodel.last_lambda
    for name, _ in port.observers:
        for p, v in port.geneo[name].items():
            assert float(v.detach()) == float(jparams["geneo"][name][p]), (name, p)
    for ln in port.lambda_names:
        assert float(port.lambdas[ln].detach()) == float(jparams["lambdas"][ln]), ln
    with torch.no_grad():
        np.testing.assert_allclose(port.effective_lambdas().numpy(),
                                   np.asarray(jmodel.effective_lambdas(jparams)),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(port.synthesize_kernels().numpy(),
                                   np.asarray(jmodel.synthesize_kernels(jparams)),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", sorted(CKPTS))
def test_lightning_import_equals_jax(case, tmp_path):
    geneo_num, ks, with_ks = CKPTS[case]
    path = str(tmp_path / "run.ckpt")
    _write_ckpt(path, geneo_num, ks, seed=11, with_kernel_size=with_ks)
    raw, jraw = load_lightning_checkpoint(path), jax_load_lightning(path)
    assert (raw["epoch"], raw["global_step"]) == (jraw["epoch"], jraw["global_step"]) == (7, 91)
    assert raw["hyper_parameters"] == jraw["hyper_parameters"]
    assert raw["state_dict"].keys() == jraw["state_dict"].keys()
    port = import_scenenet_params(path)
    jmodel, jparams = jax_import(path)
    _assert_same_model(port, jmodel, jparams)
    if case == "no_kernel_size":
        assert port.kernel_size == (9, 6, 6)
    # the imported model's forward (a 32³ grid at LiDAR-like occupancy)
    x = (np.random.default_rng(0).random((1, 1, 32, 32, 32)) > 0.97).astype(np.float32)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmodel.apply(jparams, x)), rtol=0, atol=1e-5)


def test_import_of_a_checkpoint_missing_an_observer_raises(tmp_path):
    path = str(tmp_path / "bad.ckpt")
    _write_ckpt(path, {"cy": 1, "cone": 1}, (9, 5, 5), seed=1,
                hp_geneo_num={"cy": 1, "cone": 1, "neg": 1})
    for fn in (import_scenenet_params, jax_import):
        with pytest.raises(KeyError, match="neg_0"):
            fn(path)


def test_legacy_state_dict_equals_jax(tmp_path):
    rng = np.random.default_rng(3)
    sd = {"geneos.cy_0.geneo_params.radius": torch.tensor(rng.random()),
          "lambdas_dict.phi_cy_0": torch.tensor(rng.random()),
          "phi_neg_0": torch.tensor(rng.random())}
    path = str(tmp_path / "gnet.pt")
    torch.save({"models": {"best_loss": {"model_state_dict": sd}, "last": {
        "model_state_dict": sd}}, "model_props": {"kernel_size": (9, 5, 5)}}, path)
    for tag in ("loss", "last"):
        got, want = load_legacy_state_dict(path, tag), jax_legacy(path, tag)
        assert got.keys() == want.keys() == {"geneos.cy_0.geneo_params.radius",
                                             "lambdas_dict.lambda_cy_0", "lambda_neg_0"}
        assert all(np.array_equal(got[k], want[k]) for k in got)
    for fn in (load_legacy_state_dict, jax_legacy):
        with pytest.raises(KeyError, match="missing"):
            fn(path, "missing")


@pytest.mark.parametrize("ks", [(9, 5, 5), (9, 6, 6)])
def test_exports_round_trip_across_packages(ks, tmp_path):
    """The port's export read by the JAX import, and the JAX export read by
    the port's import: the same model either way."""
    port = SceneNet.create({"cy": 1, "cone": 2, "neg": 1}, ks, seed=4)
    export_torch_state_dict(port, str(tmp_path / "port.ckpt"))
    jmodel, jparams = jax_import(str(tmp_path / "port.ckpt"))
    back = import_scenenet_params(str(tmp_path / "port.ckpt"))
    _assert_same_model(back, jmodel, jparams)
    with torch.no_grad():
        # the file holds the effective λs; the import freezes seed 0's λ, so the
        # derived one is re-summed (within 1e-6), the kernels are the same bits
        np.testing.assert_allclose(back.effective_lambdas().numpy(),
                                   port.effective_lambdas().numpy(), rtol=0, atol=1e-6)
        assert torch.equal(back.synthesize_kernels(), port.synthesize_kernels())

    jnet, jp = JaxSceneNet.create({"cy": 1, "cone": 2, "neg": 1}, ks, seed=4)
    jax_export(jnet, jp, str(tmp_path / "jax.ckpt"))
    port2 = import_scenenet_params(str(tmp_path / "jax.ckpt"))
    _assert_same_model(port2, *jax_import(str(tmp_path / "jax.ckpt")))
    want = torch.load(str(tmp_path / "jax.ckpt"), weights_only=False)
    got = torch.load(str(tmp_path / "port.ckpt"), weights_only=False)
    assert got["hyper_parameters"] == want["hyper_parameters"]
    assert got["state_dict"].keys() == want["state_dict"].keys()


def test_scan_model_zoo_equals_jax(tmp_path):
    zoo = tmp_path / "zoo"
    (zoo / "run1" / "checkpoints").mkdir(parents=True)
    _write_ckpt(str(zoo / "run1" / "checkpoints" / "FBetaScore.ckpt"),
                {"cy": 1, "cone": 1, "neg": 1}, (9, 5, 5), seed=0)
    (zoo / "run1" / "checkpoints" / "broken.ckpt").write_bytes(b"not a checkpoint")
    torch.save({"models": {"best_loss": {}, "last": {}}}, str(zoo / "gnet.pt"))
    save_checkpoint(str(zoo / "last.npz"), SceneNet.create(seed=0))
    (zoo / "notes.txt").write_text("skipped")
    got, want = scan_model_zoo(str(zoo)), jax_scan(str(zoo))
    assert got == want
    assert sorted(e["kind"] for e in got) == ["legacy", "lightning", "native", "unreadable"]


def test_load_reference_without_the_tree(tmp_path, monkeypatch):
    """No reference tree: None, in both packages (the parity tests then
    skip); a tree with the reference's modules is imported with the heavy
    packages stubbed, and sys.path is left as it was."""
    assert reference_oracle.load_reference(str(tmp_path / "absent")) is None
    assert jax_load_reference(str(tmp_path / "absent")) is None
    root = tmp_path / "ref"
    mods = ["core/models/geneos/cylinder", "core/models/geneos/arrow",
            "core/models/geneos/neg_sphere", "core/models/SCENE_Net",
            "core/criterions/w_mse", "core/criterions/geneo_loss",
            "core/criterions/tversky_loss", "core/criterions/dice_loss",
            "core/criterions/focal_loss", "core/criterions/iou_loss",
            "core/criterions/quant_loss"]
    for m in mods:
        f = root / (m + ".py")
        f.parent.mkdir(parents=True, exist_ok=True)
        f.write_text("import open3d\nNAME = __name__\n")
    monkeypatch.setattr(reference_oracle, "_cache", None)
    # the loader remaps torch's storage unpickling to the CPU: undone after the test
    monkeypatch.setattr(torch.storage, "_load_from_bytes", torch.storage._load_from_bytes)
    monkeypatch.setattr(torch.storage, "_snt_cpu_patch", False, raising=False)
    path_before, modules_before = list(sys.path), set(sys.modules)
    try:
        ref = reference_oracle.load_reference(str(root))
        assert ref.scene_net.NAME == "core.models.SCENE_Net"
        assert ref.quant.NAME == "core.criterions.quant_loss"
        assert sys.path == path_before
    finally:
        # the reference's packages and the stubs (laspy, open3d, ...) must not
        # outlive the test: other tests ask whether laspy imports
        for name in set(sys.modules) - modules_before:
            sys.modules.pop(name)


# ---- the inspect CLI ---------------------------------------------------------

def _ply_array(path):
    lines = open(path).read().splitlines()
    body = lines[lines.index("end_header") + 1:]
    return np.array([[float(v) for v in ln.split()] for ln in body])


@pytest.mark.parametrize("source", ["checkpoint", "reference_ckpt"])
def test_inspect_cli_equals_jax(source, tmp_path, capsys):
    if source == "checkpoint":
        cfg = tmp_path / "cfg.yaml"
        cfg.write_text("seed: 3\nkernel_size: (9, 5, 5)\n")
        save_checkpoint(str(tmp_path / "ckpt.npz"), SceneNet.create(kernel_size=(9, 5, 5),
                                                                     seed=8))
        args = ["--checkpoint", str(tmp_path / "ckpt.npz"), "--config", str(cfg)]
    else:
        _write_ckpt(str(tmp_path / "r.ckpt"), {"cy": 1, "cone": 1, "neg": 1}, None, seed=2,
                    with_kernel_size=False)
        args = ["--reference-ckpt", str(tmp_path / "r.ckpt")]
    table = tinspect.main([*args, "--out", str(tmp_path / "port"), "--device", "cpu"])
    port_out = capsys.readouterr().out
    jax_inspect.main([*args, "--out", str(tmp_path / "jax")])
    jax_out = capsys.readouterr().out
    got = json.load(open(tmp_path / "port" / "parameters.json"))
    want = json.load(open(tmp_path / "jax" / "parameters.json"))
    assert got.keys() == want.keys() == table.keys()
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)
        assert got[k] == want[k] or k.startswith("lambda_"), k  # scalars as stored
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    assert "kernel_combined.ply" in os.listdir(tmp_path / "port")
    for name in os.listdir(tmp_path / "jax"):
        if name.endswith(".ply"):
            a, b = _ply_array(tmp_path / "port" / name), _ply_array(tmp_path / "jax" / name)
            assert a.shape == b.shape, name
            np.testing.assert_array_equal(a[:, :3], b[:, :3], err_msg=name)
            # colors are 255·(value/scale) truncated: a 1e-6 kernel difference
            # moves one by at most one unit
            assert np.abs(a[:, 3:] - b[:, 3:]).max() <= 1, name
    assert port_out.splitlines()[:2] == jax_out.splitlines()[:2]
