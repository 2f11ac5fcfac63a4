"""Model export: a ``torch.export`` program of the forward (the port's twin
of :mod:`scenenet_tpu.utils.export`, which serializes the jitted forward to
StableHLO; the reference exports ONNX, ``scripts/main.py:259-264``).

``torch.export`` traces the forward into a portable ``ExportedProgram``
with the parameters baked in, saved as a ``.pt2`` archive that any
PyTorch runtime loads without this package. The port's CUDA kernels are
``ctypes`` calls on ``data_ptr()`` that it cannot trace, so a model on the
``cuda`` or ``cuda_mxu`` backend is exported through its ``torch``-backend
forward with the same parameters: the JAX package's default backend,
``xla``, exports likewise, through XLA's own ops.
"""

from __future__ import annotations

import copy
from typing import Tuple

import torch
from torch import nn


def export_forward(model: nn.Module, input_shape: Tuple[int, ...], path: str
                   ) -> torch.export.ExportedProgram:
    """Export ``model(x)`` for an f32 ``x`` of ``input_shape`` (on the
    model's device) to ``path`` with :func:`torch.export.save`; returns the
    program. The model is exported in ``eval()`` mode (its own mode is put
    back), and a kernel-backend model through a copy of it on the
    ``torch`` backend."""
    if getattr(model, "backend", "torch") != "torch":
        model = copy.deepcopy(model)
        model.backend = "torch"
    training = model.training
    dev = next(model.parameters()).device
    example = torch.zeros(input_shape, dtype=torch.float32, device=dev)
    try:
        with torch.no_grad():
            program = torch.export.export(model.eval(), (example,))
    finally:
        model.train(training)
    torch.export.save(program, path)
    return program


def load_exported(path: str):
    """The module of the program saved at ``path``, callable as the
    forward."""
    return torch.export.load(path).module()
