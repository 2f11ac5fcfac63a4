"""Import reference (PyTorch/Lightning) SCENE-Net checkpoints into the
port's :class:`~scenenet_tpu_torch.models.SceneNet`.

PyTorch twin of :mod:`scenenet_tpu.compat.torch_import`, for users of the
reference migrating trained models:

- Lightning ``.ckpt`` files: ``state_dict`` keys
  ``model.geneos.<obs>.geneo_params.<p>`` and
  ``model.lambdas_dict.lambda_<obs>`` plus ``hyper_parameters``
  (``geneo_num`` / ``kernel_size``; a file without ``kernel_size`` takes
  the reference's default (9, 6, 6), an even kernel, whose SAME pads are
  asymmetric and which runs K2's generic kernel on the card, not the
  (9, 5, 5) unrolled one);
- legacy ``gnet.pt`` dicts ``{models: {tag: {model_state_dict}},
  model_props}`` including the ``phi`` → ``lambda`` key migration
  (reference ``core/models/SCENE_Net.py:18-49``).

Unpickling is *tolerant*: classes from packages the port does not ship
(torchvision, pytorch_lightning) resolve to inert stubs, since only the
tensor leaves matter. Everything is read on the host; move the model with
``.to(device)``.
"""

from __future__ import annotations

import os
import pickle
import sys
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


class _Stub:
    """Inert stand-in for unimportable classes inside a checkpoint."""

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        self.__dict__["_state"] = state

    def __reduce__(self):
        return (_Stub, ())


class _TolerantUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        try:
            __import__(module)
            return getattr(sys.modules[module], name)
        except Exception:
            return _Stub


class _PickleModule:
    Unpickler = _TolerantUnpickler

    @staticmethod
    def load(*args, **kwargs):
        return pickle.load(*args, **kwargs)


def _torch_load(path: str) -> Any:
    import torch

    return torch.load(path, map_location="cpu", weights_only=False,
                      pickle_module=_PickleModule)


def load_lightning_checkpoint(path: str) -> Dict[str, Any]:
    """Raw Lightning checkpoint dict (state_dict values → numpy)."""
    ck = _torch_load(path)
    state = {k: np.asarray(v) for k, v in ck["state_dict"].items()}
    return {
        "state_dict": state,
        "hyper_parameters": dict(ck.get("hyper_parameters", {}) or {}),
        "epoch": ck.get("epoch"),
        "global_step": ck.get("global_step"),
    }


def load_legacy_state_dict(path: str, model_tag: str = "loss") -> Dict[str, np.ndarray]:
    """Legacy ``gnet.pt`` format with phi→lambda migration."""
    run = _torch_load(path)
    models = run.get("models", {})
    if model_tag == "loss" and "best_loss" in models:
        model_tag = "best_loss"
    if model_tag not in models:
        raise KeyError(f"{model_tag!r} not in checkpoint; has {list(models)}")
    sd = models[model_tag]["model_state_dict"]
    out = {}
    for key, val in sd.items():
        out[key.replace("phi", "lambda")] = np.asarray(val)
    return out


def _scalar(val: np.ndarray) -> "torch.Tensor":
    import torch

    return torch.from_numpy(np.asarray(val, np.float32).reshape(()).copy())


def _params_from_state(state: Dict[str, np.ndarray], model) -> Dict[str, "torch.Tensor"]:
    """The reference's keys → the port model's ``state_dict`` (every
    GENEO scalar the model's observers take and every coefficient)."""
    geneo: Dict[str, Dict[str, np.ndarray]] = {}
    lambdas: Dict[str, np.ndarray] = {}
    for key, val in state.items():
        parts = key.split(".")
        if "geneo_params" in parts:
            obs = parts[parts.index("geneos") + 1]
            geneo.setdefault(obs, {})[parts[-1]] = val
        elif "lambdas_dict" in parts or parts[-1].startswith("lambda"):
            lambdas[parts[-1]] = val
    # sanity: every observer the model expects is present
    for name, _ in model.observers:
        if name not in geneo:
            raise KeyError(f"checkpoint missing observer {name!r}")
    for ln in model.lambda_names:
        if ln not in lambdas:
            raise KeyError(f"checkpoint missing coefficient {ln!r}")
    out = {}
    for name, _ in model.observers:
        for p in model.geneo[name]:
            if p not in geneo[name]:
                raise KeyError(f"checkpoint missing parameter {p!r} of observer {name!r}")
            out[f"geneo.{name}.{p}"] = _scalar(geneo[name][p])
    for ln in model.lambda_names:
        out[f"lambdas.{ln}"] = _scalar(lambdas[ln])
    return out


def import_scenenet_params(path: str, version: str = "v2", backend: str = "torch"):
    """Lightning ``.ckpt`` → the port's SceneNet with the checkpoint's
    parameters, on the host, its forward on ``backend``.

    Note on the non-trainable "last" λ: the state dict does not record
    which coefficient was frozen, but the reference stores the frozen one
    already synced to ``1 − Σ others``, so any choice of ``last_lambda``
    yields the same effective coefficients. The model keeps the default of
    :meth:`SceneNet.create` at seed 0, as the JAX package's import does.
    """
    from scenenet_tpu_torch.models import SceneNet

    ck = load_lightning_checkpoint(path)
    hp = ck["hyper_parameters"]
    geneo_num = dict(hp.get("geneo_num") or {"cy": 1, "cone": 1, "neg": 1})
    kernel_size = tuple(hp.get("kernel_size") or (9, 6, 6))
    model = SceneNet.create(geneo_num, kernel_size, version=version, seed=0, backend=backend)
    model.load_state_dict(_params_from_state(ck["state_dict"], model))
    return model


def export_torch_state_dict(model, path: str) -> None:
    """Inverse migration: write the port's SceneNet parameters as a torch
    state dict with the reference's key layout
    (``model.geneos.<obs>.geneo_params.<p>`` / ``model.lambdas_dict.lambda_<obs>``,
    the effective λs), loadable by the reference's Lightning wrapper."""
    import torch

    sd = {}
    for name, _ in model.observers:
        for p, v in model.geneo[name].items():
            sd[f"model.geneos.{name}.geneo_params.{p}"] = torch.tensor(float(v.detach()))
    with torch.no_grad():
        lams = model.effective_lambdas().tolist()
    for ln, v in zip(model.lambda_names, lams):
        sd[f"model.lambdas_dict.{ln}"] = torch.tensor(float(v))
    torch.save({
        "state_dict": sd,
        "hyper_parameters": {
            "geneo_num": dict(model.geneo_num),
            "kernel_size": tuple(model.kernel_size),
        },
    }, path)


def scan_model_zoo(root: str) -> List[Dict[str, Any]]:
    """Walk a directory tree of checkpoints and report what's loadable
    (reference ``observer_utils.py:658-723`` best-model search)."""
    report = []
    for dirpath, _, files in os.walk(root):
        for fname in files:
            path = os.path.join(dirpath, fname)
            entry: Dict[str, Any] = {"path": path}
            try:
                if fname.endswith(".ckpt"):
                    ck = load_lightning_checkpoint(path)
                    entry.update(kind="lightning", epoch=ck["epoch"],
                                 step=ck["global_step"],
                                 params=len(ck["state_dict"]))
                elif fname.endswith((".pt", ".pth")):
                    run = _torch_load(path)
                    entry.update(kind="legacy", tags=list(run.get("models", {})))
                elif fname.endswith(".npz"):
                    entry.update(kind="native", params=len(np.load(path).files))
                else:
                    continue
            except Exception as exc:
                entry.update(kind="unreadable", error=str(exc))
            report.append(entry)
    return report
