"""ONNX export for SceneNet (reference parity: ``scripts/main.py:259-264``
exports the trained model to ONNX and uploads it as a wandb artifact).

PyTorch twin of :mod:`scenenet_tpu.utils.onnx_export`: the ModelProto is
built against the port's copy of the schema subset
(:mod:`scenenet_tpu_torch.compat.onnx_pb2`, the public ``onnx/onnx.proto``'s
messages and field numbers), so no ``onnx`` package is needed, and the
file is the same bytes as the JAX export's for the same parameters.
:func:`load_onnx` is an independent evaluator of the artifact: it parses
the file back and runs the graph with ``F.conv3d`` on the tensor's device.

The exported graph is the inference contract of the trained net: the
GENEO kernels are synthesized from the trained scalars, combined with
the effective convex coefficients (exact by linearity, the same fusion
``SceneNet.forward`` performs), and baked as a single Conv initializer:

    x (N,1,Z,X,Y) → Conv(w=(1,1,k_z,k_x,k_y), pads=torch-SAME) → Tanh
      → Relu → y

Opset 13; the batch dim is symbolic ("N").
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

import numpy as np
import torch
import torch.nn.functional as F

_IR_VERSION = 8
_OPSET = 13


def _schema():
    """The schema's message classes, imported where a file is written or
    read: they need ``google.protobuf``."""
    from scenenet_tpu_torch.compat import onnx_pb2

    return onnx_pb2


def _tensor(name: str, arr: np.ndarray):
    O = _schema()
    t = O.TensorProto(name=name, data_type=O.TensorProto.FLOAT)
    t.dims.extend(arr.shape)
    t.raw_data = np.ascontiguousarray(arr, dtype="<f4").tobytes()
    return t


def _value_info(name: str, shape):
    O = _schema()
    vi = O.ValueInfoProto(name=name)
    vi.type.tensor_type.elem_type = O.TensorProto.FLOAT
    for d in shape:
        dim = vi.type.tensor_type.shape.dim.add()
        if isinstance(d, str):
            dim.dim_param = d
        else:
            dim.dim_value = int(d)
    return vi


def export_scenenet_onnx(model: Any, input_shape: Tuple[int, int, int],
                         path: str) -> bytes:
    """Serialize the trained SceneNet forward to ``path`` as ONNX.

    ``input_shape`` is the spatial (Z, X, Y); batch is symbolic. Returns
    the serialized bytes (also written to ``path``). The kernels are
    synthesized on the model's device and combined on the host, as the
    JAX export combines them.
    """
    with torch.no_grad():
        kernels = model.synthesize_kernels().float().cpu().numpy()
        lams = model.effective_lambdas().float().cpu().numpy()
    combined = np.einsum("g,gzxy->zxy", lams, kernels).astype(np.float32)
    return export_kernel_onnx(combined, input_shape, path)


def export_kernel_onnx(combined: np.ndarray, input_shape: Tuple[int, int, int],
                       path: str) -> bytes:
    """The graph of :func:`export_scenenet_onnx` around a given combined
    (k_z, k_x, k_y) f32 kernel: the bytes depend on the kernel alone. (Each
    package synthesizes the kernels in its own arithmetic, and the two
    round apart by a few units in the last place.)"""
    O = _schema()
    k_z, k_x, k_y = combined.shape

    g = O.GraphProto(name="scenenet_forward")
    g.initializer.append(_tensor("w", combined[None, None]))
    g.input.append(_value_info("x", ("N", 1, *input_shape)))
    g.output.append(_value_info("y", ("N", 1, *input_shape)))

    conv = g.node.add(op_type="Conv", name="conv", input=["x", "w"],
                      output=["c"])
    a = conv.attribute.add(name="kernel_shape", type=O.AttributeProto.INTS)
    a.ints.extend([k_z, k_x, k_y])
    a = conv.attribute.add(name="pads", type=O.AttributeProto.INTS)
    # ONNX pads = [begin_z, begin_x, begin_y, end_z, end_x, end_y]; the
    # torch asymmetric SAME rule (low=(k-1)//2, high=k//2), as
    # ops/conv3d.conv3d_same pads
    a.ints.extend([(k_z - 1) // 2, (k_x - 1) // 2, (k_y - 1) // 2,
                   k_z // 2, k_x // 2, k_y // 2])
    a = conv.attribute.add(name="strides", type=O.AttributeProto.INTS)
    a.ints.extend([1, 1, 1])
    a = conv.attribute.add(name="group", type=O.AttributeProto.INT)
    a.i = 1
    g.node.add(op_type="Tanh", name="tanh", input=["c"], output=["t"])
    g.node.add(op_type="Relu", name="relu", input=["t"], output=["y"])

    m = O.ModelProto(ir_version=_IR_VERSION, producer_name="scenenet_tpu",
                     producer_version="1.0",
                     doc_string="SceneNet fused GENEO forward "
                                "(kernels synthesized from trained scalars)")
    m.opset_import.add(domain="", version=_OPSET)
    m.graph.CopyFrom(g)
    blob = m.SerializeToString()
    with open(path, "wb") as f:
        f.write(blob)
    return blob


def load_onnx(path: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """Parse ``path`` back through the protobuf schema and return a
    callable evaluating the graph on a tensor, on the tensor's device
    (``F.conv3d`` with the file's pads; the exporter's op set: Conv / Tanh
    / Relu / Add / Mul) — the numeric round-trip check for the exported
    artifact, which needs no onnxruntime. A numpy input is taken as a CPU
    tensor."""
    O = _schema()
    with open(path, "rb") as f:
        m = O.ModelProto.FromString(f.read())
    graph = m.graph
    inits = {}
    for t in graph.initializer:
        if t.data_type != O.TensorProto.FLOAT:
            raise NotImplementedError(f"initializer dtype {t.data_type}")
        if t.raw_data:
            arr = np.frombuffer(t.raw_data, "<f4")
        else:
            arr = np.asarray(t.float_data, np.float32)
        inits[t.name] = torch.from_numpy(arr.reshape(tuple(t.dims)).copy())

    nodes = list(graph.node)
    in_name = graph.input[0].name
    out_name = graph.output[0].name

    def run(x) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=torch.float32)
        env = {k: v.to(x.device) for k, v in inits.items()}
        env[in_name] = x
        for n in nodes:
            if n.op_type == "Conv":
                attrs = {a.name: list(a.ints) if a.ints else a.i
                         for a in n.attribute}
                pads = attrs["pads"]
                sp = len(pads) // 2
                # F.pad takes the last dim first: (y_lo, y_hi, x_lo, x_hi, z_lo, z_hi)
                pad_cfg = [int(v) for i in reversed(range(sp))
                           for v in (pads[i], pads[i + sp])]
                env[n.output[0]] = F.conv3d(F.pad(env[n.input[0]], pad_cfg),
                                            env[n.input[1]],
                                            stride=attrs.get("strides", [1] * sp))
            elif n.op_type == "Tanh":
                env[n.output[0]] = torch.tanh(env[n.input[0]])
            elif n.op_type == "Relu":
                env[n.output[0]] = torch.relu(env[n.input[0]])
            elif n.op_type == "Add":
                env[n.output[0]] = env[n.input[0]] + env[n.input[1]]
            elif n.op_type == "Mul":
                env[n.output[0]] = env[n.input[0]] * env[n.input[1]]
            else:
                raise NotImplementedError(f"op {n.op_type}")
        return env[out_name]

    return run
