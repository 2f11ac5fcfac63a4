"""Port parity: the ONNX export and the ``torch.export`` program.

ONNX: the port writes its file against its own copy of the schema subset.
Given the same combined kernel, its bytes equal the JAX export's; through
each package's own kernel synthesis the files differ only in the
initializer's bytes, by a few units in the last place (the synthesis
arithmetic of XLA and torch rounds apart, ≤ 2.4e-7 here). Each package's
``load_onnx`` runs the other's file to 1e-5 of the JAX forward, and the
four checks of ``tests/test_onnx.py`` hold for the port's file.

``torch.export``: the program's output equals the model's forward within
1e-6 (``tests/test_utils.py::test_stablehlo_roundtrip``), and a model on a
kernel backend exports through its ``torch``-backend forward.
"""

import numpy as np
import pytest
import torch

from scenenet_tpu.models import SceneNet as JaxSceneNet
from scenenet_tpu.utils.onnx_export import export_scenenet_onnx as jax_export_onnx
from scenenet_tpu.utils.onnx_export import load_onnx as jax_load_onnx
from scenenet_tpu_torch.compat import onnx_pb2 as O
from scenenet_tpu_torch.models import SceneNet
from scenenet_tpu_torch.train.checkpoint import load_module_state, params_from_jax
from scenenet_tpu_torch.utils.export import export_forward, load_exported
from scenenet_tpu_torch.utils.onnx_export import (
    export_kernel_onnx, export_scenenet_onnx, load_onnx,
)


def _pair(ks, seed):
    """The JAX model and the port's with the same parameters."""
    jnet, jparams = JaxSceneNet.create(kernel_size=ks, seed=seed)
    net = load_module_state(SceneNet.create(kernel_size=ks, seed=seed), params_from_jax(jparams))
    return jnet, jparams, net


def _x(shape, seed=0):
    return (np.random.default_rng(seed).random(shape) > 0.9).astype(np.float32)


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    jnet, jparams, net = _pair((9, 5, 5), 3)
    tmp = tmp_path_factory.mktemp("onnx")
    blob = export_scenenet_onnx(net, (16, 16, 16), str(tmp / "port.onnx"))
    jblob = jax_export_onnx(jnet, jparams, (16, 16, 16), str(tmp / "jax.onnx"))
    return jnet, jparams, net, tmp, blob, jblob


@pytest.mark.parametrize("ks", [(9, 5, 5), (9, 6, 6), (3, 3, 3)])
@pytest.mark.parametrize("seed", [1, 2])
def test_onnx_bytes_equal_jax(ks, seed, tmp_path):
    jnet, jparams, net = _pair(ks, seed)
    jblob = jax_export_onnx(jnet, jparams, (8, 12, 10), str(tmp_path / "jax.onnx"))
    kernels = np.asarray(jnet.synthesize_kernels(jparams), np.float32)
    lams = np.asarray(jnet.effective_lambdas(jparams), np.float32)
    combined = np.einsum("g,gzxy->zxy", lams, kernels).astype(np.float32)
    assert export_kernel_onnx(combined, (8, 12, 10), str(tmp_path / "k.onnx")) == jblob
    blob = export_scenenet_onnx(net, (8, 12, 10), str(tmp_path / "port.onnx"))
    got, want = O.ModelProto.FromString(blob), O.ModelProto.FromString(jblob)
    w_got = np.frombuffer(got.graph.initializer[0].raw_data, "<f4")
    w_want = np.frombuffer(want.graph.initializer[0].raw_data, "<f4")
    np.testing.assert_allclose(w_got, w_want, rtol=0, atol=1e-6)
    got.graph.initializer[0].raw_data = want.graph.initializer[0].raw_data
    assert got.SerializeToString() == jblob


def test_load_onnx_runs_either_file(exported):
    jnet, jparams, _, tmp, _, _ = exported
    x = _x((2, 1, 16, 16, 16))
    want = np.asarray(jnet.apply(jparams, x))
    for path in ("port.onnx", "jax.onnx"):
        got = load_onnx(str(tmp / path))(torch.from_numpy(x))
        assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5, err_msg=path)
        np.testing.assert_allclose(np.asarray(jax_load_onnx(str(tmp / path))(x)), want,
                                   rtol=0, atol=1e-5, err_msg=path)


def test_onnx_numeric_roundtrip(exported):
    _, _, net, tmp, _, _ = exported
    x = torch.from_numpy(_x((2, 1, 16, 16, 16)))
    got = load_onnx(str(tmp / "port.onnx"))(x)
    with torch.no_grad():
        want = net(x)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-6)


def test_onnx_model_structure(exported, tmp_path):
    _, _, _, tmp, blob, _ = exported
    assert (tmp / "port.onnx").read_bytes() == blob
    m = O.ModelProto.FromString(blob)
    assert m.ir_version == 8 and m.opset_import[0].version == 13
    assert [n.op_type for n in m.graph.node] == ["Conv", "Tanh", "Relu"]
    w = m.graph.initializer[0]
    assert tuple(w.dims) == (1, 1, 9, 5, 5) and w.data_type == O.TensorProto.FLOAT
    assert m.graph.input[0].type.tensor_type.shape.dim[0].dim_param == "N"
    pads = [list(a.ints) for a in m.graph.node[0].attribute if a.name == "pads"][0]
    assert pads == [4, 2, 2, 4, 2, 2]
    # an even kernel: torch-SAME's asymmetric pads, low (k-1)//2, high k//2
    even = O.ModelProto.FromString(export_scenenet_onnx(
        SceneNet.create(kernel_size=(9, 6, 6), seed=0), (8, 8, 8), str(tmp_path / "e.onnx")))
    pads = [list(a.ints) for a in even.graph.node[0].attribute if a.name == "pads"][0]
    assert pads == [4, 2, 2, 4, 3, 3]


def test_onnx_trained_params_are_baked(tmp_path):
    b1 = export_scenenet_onnx(SceneNet.create(kernel_size=(9, 5, 5), seed=1), (8, 8, 8),
                              str(tmp_path / "a.onnx"))
    b2 = export_scenenet_onnx(SceneNet.create(kernel_size=(9, 5, 5), seed=2), (8, 8, 8),
                              str(tmp_path / "b.onnx"))
    assert b1 != b2


def test_onnx_wire_format_tags(exported):
    blob = exported[4]
    # tag = (field << 3) | wire_type; ir_version: field 1, varint → 0x08
    assert blob[0] == 0x08 and blob[1] == 8
    assert bytes([0x3A]) in blob  # the graph: field 7, length-delimited


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_torch_export_roundtrip(backend, tmp_path):
    """The saved program, loaded back, computes the forward (1e-6); a
    ``cuda``-backend model (built here on the CPU) exports through its
    ``torch`` forward and keeps its own backend and mode."""
    net = SceneNet.create(kernel_size=(9, 5, 5), seed=0, backend=backend)
    path = str(tmp_path / "scenenet.pt2")
    program = export_forward(net, (1, 1, 16, 16, 16), path)
    assert net.backend == backend and net.training
    assert "aten.conv3d.default" in {str(n.target) for n in program.graph.nodes}
    fn = load_exported(path)
    x = torch.from_numpy(_x((1, 1, 16, 16, 16), seed=4))
    with torch.no_grad():
        want = SceneNet.create(kernel_size=(9, 5, 5), seed=0)(x)
        np.testing.assert_allclose(fn(x).numpy(), want.numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(fn(torch.zeros(1, 1, 16, 16, 16)).numpy(), 0.0)
