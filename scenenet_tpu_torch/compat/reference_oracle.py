"""Import the ACTUAL reference implementation as a test oracle.

The port's own copy of :mod:`scenenet_tpu.compat.reference_oracle`:
hand-transcribed torch oracles can share a misreading with the
implementation under test. This module imports the real reference
modules (``<reference>/core/models/geneos/*.py``,
``core/models/SCENE_Net.py``) by stubbing only the heavy dependencies the
environment doesn't ship (sympytorch / pyntcloud / laspy / open3d) — the
same tolerance trick :mod:`scenenet_tpu_torch.compat.torch_import` uses for
unpicklable classes. The reference kernels never touch those packages on
the synthesis path (they're imported for plotting / notebook cells).

The loader is read-only with respect to the reference tree and degrades
gracefully: :func:`load_reference` returns ``None`` when the tree is
absent, so parity tests can ``pytest.skip``.
"""

from __future__ import annotations

import importlib
import os
import sys
import types
from typing import Optional

# packages the reference imports at module top that this image doesn't
# ship; none of them participate in kernel synthesis or the forward pass
_STUB_MODULES = ("sympytorch", "pyntcloud", "laspy", "open3d")


class _StubAny:
    """Inert stand-in: constructible, callable, attribute-transparent."""

    def __init__(self, *args, **kwargs):
        pass

    def __call__(self, *args, **kwargs):
        return self

    def __getattr__(self, name):
        return _StubAny()


def _install_stubs() -> None:
    for name in _STUB_MODULES:
        if name in sys.modules:
            continue
        try:
            importlib.import_module(name)
            continue
        except ImportError:
            pass
        mod = types.ModuleType(name)

        # PEP 562 module __getattr__: every non-dunder attribute resolves
        # to a stub; dunders (``__file__`` etc) must raise AttributeError
        # or stdlib inspect/import machinery chokes on stub values
        def _module_getattr(attr):
            if attr.startswith("__") and attr.endswith("__"):
                raise AttributeError(attr)
            return _StubAny()

        mod.__getattr__ = _module_getattr
        sys.modules[name] = mod


_cache: Optional[types.SimpleNamespace] = None


def load_reference(root: str) -> Optional[types.SimpleNamespace]:
    """Import the reference geneo + SCENE_Net modules from the reference
    checkout at ``root``, which the caller names; None if absent.

    Returns a namespace with ``cylinder``, ``arrow``, ``neg_sphere``,
    ``scene_net`` (the real modules). NOTE: the reference uses generic
    top-level package names (``core``, ``utils``, ``scripts``) — they stay
    in ``sys.modules`` after this call. Nothing in this repo or its deps
    uses those names as top-level imports.
    """
    global _cache
    if _cache is not None:
        return _cache
    if not os.path.isdir(os.path.join(root, "core")):
        return None
    os.environ.setdefault("MPLBACKEND", "Agg")  # headless matplotlib
    _install_stubs()
    # the reference's hist_estimation.pickle stores CUDA tensors; raw
    # unpickling routes storage bytes through torch.load WITHOUT a
    # map_location and dies on CPU-only machines — remap to CPU globally
    # (the oracle runs on the host)
    import io

    import torch

    if not getattr(torch.storage, "_snt_cpu_patch", False):
        torch.storage._load_from_bytes = (
            lambda b: torch.load(io.BytesIO(b), map_location="cpu",
                                 weights_only=False))
        torch.storage._snt_cpu_patch = True
    added = False
    if root not in sys.path:
        sys.path.insert(0, root)
        added = True
    try:
        cylinder = importlib.import_module("core.models.geneos.cylinder")
        arrow = importlib.import_module("core.models.geneos.arrow")
        neg_sphere = importlib.import_module("core.models.geneos.neg_sphere")
        scene_net = importlib.import_module("core.models.SCENE_Net")
        w_mse = importlib.import_module("core.criterions.w_mse")
        geneo_loss = importlib.import_module("core.criterions.geneo_loss")
        tversky = importlib.import_module("core.criterions.tversky_loss")
        dice = importlib.import_module("core.criterions.dice_loss")
        focal = importlib.import_module("core.criterions.focal_loss")
        iou = importlib.import_module("core.criterions.iou_loss")
        # core/criterions/quant_loss.py imports from a
        # ``scenenet_pipeline.torch_geneo.criterions`` tree that does not
        # exist anywhere in the reference (quant_loss.py:9-10). The classes
        # it wants — WeightedMSE (+HIST_PATH) and GENEO_Loss — are the very
        # ones the reference ALSO ships at core/criterions/{w_mse,
        # geneo_loss}.py, so aliasing those module paths makes quant_loss
        # executable with true semantics (VERDICT r2 #3). NOTE the executed
        # MRO consequences, asserted by tests/test_reference_oracle.py:
        # QuantileLoss alone is constructor-broken (its super().__init__
        # passes 6 positionals into WeightedMSE's 5), while
        # QuantileGENEOLoss constructs fine because its MRO routes the same
        # call through GENEO_Loss.__init__ (6 slots): alpha→weight_alpha,
        # rho→weight_epsilon, epsilon→mse_weight, gamma→convex_weight.
        for alias in ("scenenet_pipeline", "scenenet_pipeline.torch_geneo",
                      "scenenet_pipeline.torch_geneo.criterions"):
            sys.modules.setdefault(alias, types.ModuleType(alias))
        sys.modules["scenenet_pipeline.torch_geneo.criterions.w_mse"] = w_mse
        sys.modules["scenenet_pipeline.torch_geneo.criterions.geneo_loss"] = (
            geneo_loss)
        quant = importlib.import_module("core.criterions.quant_loss")
    finally:
        if added:
            sys.path.remove(root)
    _cache = types.SimpleNamespace(
        cylinder=cylinder, arrow=arrow, neg_sphere=neg_sphere,
        scene_net=scene_net, w_mse=w_mse, geneo_loss=geneo_loss,
        tversky=tversky, dice=dice, focal=focal, iou=iou, quant=quant,
        hist_pickle=os.path.join(root, "core/criterions/hist_estimation.pickle"),
    )
    return _cache
