"""SCENE-Net: GENEO observers combined by trainable convex coefficients.

PyTorch twin of :class:`scenenet_tpu.models.scenenet.SceneNet` as an
``nn.Module``. Every GENEO scalar and every convex coefficient is a 0-d
``nn.Parameter`` under the same nested names as the JAX params pytree:
``geneo.<observer>.<param>`` and ``lambdas.lambda_<observer>`` (the flat
checkpoint keys join them with '/').

- λ_last is derived as ``1 − Σ_{i≠last} λ_i`` on every call; its stored
  slot is kept for checkpoint parity and ignored by the forward.
- The forward folds the observer kernels by their convex coefficients
  first (convolution is linear in the kernel) and runs one 1-channel
  conv, then the relu∘tanh head.

``backend="torch"`` runs the plain, differentiable conv (the JAX
``"xla"``). ``backend="cuda"`` (the JAX ``"pallas"``) runs the
hand-written stencil kernel for ``inference=True``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from scenenet_tpu_torch.geneo.kernels import KERNEL_REGISTRY, random_geneo_params
from scenenet_tpu_torch.ops.conv3d import conv3d_same
from scenenet_tpu_torch.ops.cuda_conv import geneo_stencil_conv

# geneo_num keys → kernel registry kinds, per model version
_KIND_MAP = {
    "v1": {"cy": "cylinder", "cone": "cone", "neg": "neg_sphere"},
    "v2": {"cy": "cylinder_v2", "cone": "arrow", "neg": "neg_sphere_v2"},
}
_BACKENDS = ("torch", "cuda")


class SceneNet(nn.Module):
    """Build with :meth:`create` to draw the parameters from a seed."""

    def __init__(
        self,
        geneo_num: Tuple[Tuple[str, int], ...] = (("cy", 1), ("cone", 1), ("neg", 1)),
        kernel_size: Tuple[int, int, int] = (9, 6, 6),
        version: str = "v2",
        last_lambda: str = "lambda_neg_0",
        backend: str = "torch",
    ):
        super().__init__()
        if backend not in _BACKENDS:
            raise ValueError(f"backend must be one of {_BACKENDS}, got {backend!r}")
        self.geneo_num = tuple((k, int(v)) for k, v in geneo_num)
        self.kernel_size = tuple(int(k) for k in kernel_size)
        self.version = version
        self.last_lambda = last_lambda
        self.backend = backend
        self.geneo = nn.ModuleDict({
            name: nn.ParameterDict({
                p: nn.Parameter(torch.zeros(()),
                                requires_grad=p not in KERNEL_REGISTRY[kind].non_trainable)
                for p in KERNEL_REGISTRY[kind].parameters
            })
            for name, kind in self.observers
        })
        self.lambdas = nn.ParameterDict({
            ln: nn.Parameter(torch.zeros(()), requires_grad=ln != last_lambda)
            for ln in self.lambda_names
        })

    # ---- structure -------------------------------------------------------

    @property
    def observers(self) -> Tuple[Tuple[str, str], ...]:
        """Ordered (observer_name, kernel_kind) pairs, e.g. ('cy_0','cylinder_v2')."""
        kinds = _KIND_MAP[self.version]
        return tuple((f"{key}_{i}", kinds[key])
                     for key, num in self.geneo_num for i in range(num))

    @property
    def lambda_names(self) -> Tuple[str, ...]:
        return tuple(f"lambda_{name}" for name, _ in self.observers)

    # ---- init ------------------------------------------------------------

    @classmethod
    def create(
        cls,
        geneo_num: Optional[Mapping[str, int]] = None,
        kernel_size: Tuple[int, int, int] = (9, 6, 6),
        version: str = "v2",
        seed: int = 0,
        backend: str = "torch",
    ) -> "SceneNet":
        """A model with parameters drawn from ``seed``.

        The numpy ``Generator`` is drawn in the JAX package's order (the
        last λ's index, the GENEO scalars observer by observer, the λs), and
        the λ arithmetic is the same float32 arithmetic, so a seed gives
        bit-identical parameters in both packages.
        """
        geneo_num = dict(geneo_num or {"cy": 1, "cone": 1, "neg": 1})
        rng = np.random.default_rng(seed)
        items = tuple((k, int(v)) for k, v in geneo_num.items())
        n = sum(v for _, v in items)

        lambda_names = [f"lambda_{k}_{i}" for k, v in items for i in range(v)]
        last = lambda_names[int(rng.integers(0, n))]
        model = cls(geneo_num=items, kernel_size=kernel_size, version=version,
                    last_lambda=last, backend=backend)

        with torch.no_grad():
            for name, kind in model.observers:
                for p, v in random_geneo_params(kind, rng, kernel_size).items():
                    model.geneo[name][p].fill_(v)
            lo, hi = (0.0, 0.6) if version == "v1" else (-2.0 / n, 1.0 / n)
            lam = {ln: torch.tensor(rng.uniform(lo, hi), dtype=torch.float32)
                   for ln in lambda_names}
            lam[last] = 1.0 - sum(lam[ln] for ln in lambda_names) + lam[last]
            for ln, v in lam.items():
                model.lambdas[ln].copy_(v)
        return model

    # ---- functional pieces -------------------------------------------------

    def synthesize_kernels(self) -> torch.Tensor:
        """Stack per-observer GENEO kernels: (G, k_z, k_x, k_y)."""
        return torch.stack([
            KERNEL_REGISTRY[kind].fn(dict(self.geneo[name]), self.kernel_size)
            for name, kind in self.observers
        ])

    def effective_lambdas(self) -> torch.Tensor:
        """Convex coefficients with λ_last := 1 − Σ others, observer order."""
        free_sum = sum(self.lambdas[ln] for ln in self.lambda_names
                       if ln != self.last_lambda)
        return torch.stack([
            1.0 - free_sum if ln == self.last_lambda else self.lambdas[ln]
            for ln in self.lambda_names
        ])

    def combined_kernel(self) -> torch.Tensor:
        """The observers folded by their convex coefficients into one
        (k_z, k_x, k_y) kernel — an elementwise sum, as in the JAX
        package (a matmul there would round the kernels to bf16)."""
        lams = self.effective_lambdas()
        return torch.sum(lams[:, None, None, None] * self.synthesize_kernels(), dim=0)

    def forward(
        self,
        x: torch.Tensor,
        inference: "bool | str" = False,
        tau: Optional[float] = None,
    ) -> torch.Tensor:
        """x (B, 1, Z, X, Y) → tower-probability grid of the same shape.

        With ``backend="cuda"`` and ``inference=True`` the conv and the
        relu∘tanh head run in the stencil kernel; that path carries no
        gradient, like the JAX inference forward. ``tau`` returns the
        ``(prob >= τ)`` mask instead of probabilities.
        """
        if inference in ("mxu", "mxu_fast"):
            raise NotImplementedError(
                f"inference={inference!r} (the banded-y tensor-core stencil) "
                "is not ported yet: ROADMAP B2")
        combined = self.combined_kernel().to(x.dtype)
        if self.backend == "cuda":
            if not inference:
                raise NotImplementedError(
                    "backend='cuda' training forward (stencil forward with "
                    "kernel backward) is not ported yet: ROADMAP B5")
            out = geneo_stencil_conv(x.detach().float(),
                                     combined.detach().float(), activation=True)
        else:
            out = torch.relu(torch.tanh(conv3d_same(x, combined[None, None])))
        return (out >= tau).to(out.dtype) if tau is not None else out

    # ---- constraint plumbing ------------------------------------------------

    def trainable_mask(self) -> Dict:
        """Nested bools: False for per-kernel non-trainables and λ_last
        (the same structure as the JAX params pytree)."""
        kinds = dict(self.observers)
        geneo = {
            name: {p: p not in KERNEL_REGISTRY[kinds[name]].non_trainable
                   for p in self.geneo[name]}
            for name, _ in self.observers
        }
        lam = {ln: ln != self.last_lambda for ln in self.lambda_names}
        return {"geneo": geneo, "lambdas": lam}
