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
  conv, then the relu∘tanh head. ``fuse_observers=False`` convolves with
  each observer's kernel and weights the responses after, and
  :meth:`SceneNet.observer_responses` returns those responses, the
  white-box view; both take the plain conv on every backend, as the JAX
  package takes its XLA conv there.
- Under bf16 parameters and input (the trainer's ``precision: bf16``)
  the kernels and coefficients are folded in bf16; the kernel backends
  then widen the folded kernel and x to f32 for the conv, as the JAX
  package casts them for its Pallas kernels, and the plain conv computes
  in bf16 (f32 sums, rounded once).

``backend="torch"`` runs the plain, differentiable conv (the JAX
``"xla"``). ``backend="cuda"`` (the JAX ``"pallas"``) runs the
hand-written kernels: the stencil alone for ``inference=True``, and
:func:`~scenenet_tpu_torch.ops.cuda_conv.fused_geneo_conv` (stencil
forward, ``stencil_dk`` backward) for training. ``backend="cuda_mxu"``
(the JAX ``"pallas_mxu"``) trains through
:func:`~scenenet_tpu_torch.ops.cuda_conv.fused_geneo_conv_mxu`, the
tensor-core forward with the same backward. On every backend
``inference="mxu"`` / ``"mxu_fast"`` take the tensor-core stencil
(:func:`~scenenet_tpu_torch.ops.cuda_conv.geneo_stencil_conv_mxu`).

:class:`QuantileSceneNet` is an ensemble of one SceneNet per quantile;
:class:`SceneNetClassifier` is a SceneNet with a trainable threshold τ
and a hard {0, 1} output.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from scenenet_tpu_torch.geneo.kernels import (
    KERNEL_REGISTRY, random_geneo_params, smart_geneo_params,
)
from scenenet_tpu_torch.ops.conv3d import conv3d_same, geneo_conv
from scenenet_tpu_torch.ops.cuda_conv import (
    fused_geneo_conv, fused_geneo_conv_mxu, geneo_stencil_conv, geneo_stencil_conv_mxu,
)

# geneo_num keys → kernel registry kinds, per model version
_KIND_MAP = {
    "v1": {"cy": "cylinder", "cone": "cone", "neg": "neg_sphere"},
    "v2": {"cy": "cylinder_v2", "cone": "arrow", "neg": "neg_sphere_v2"},
}
_BACKENDS = ("torch", "cuda", "cuda_mxu")


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
        smart: bool = False,
        backend: str = "torch",
    ) -> "SceneNet":
        """A model with parameters drawn from ``seed``.

        The numpy ``Generator`` is drawn in the JAX package's order (the
        last λ's index, the GENEO scalars observer by observer, the λs), and
        the λ arithmetic is the same float32 arithmetic, so a seed gives
        bit-identical parameters in both packages. ``smart`` takes every
        observer's hand-tuned scalars (``smart_geneo_params``) in place of
        the random draws, which then leave the ``Generator`` to the λs.
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
                init = (smart_geneo_params(kind) if smart
                        else random_geneo_params(kind, rng, kernel_size))
                for p, v in init.items():
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

    def combined_kernel(self, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """The observers folded by their convex coefficients into one
        (k_z, k_x, k_y) kernel — an elementwise sum, as in the JAX
        package (a matmul there would round the kernels to bf16). The
        kernels and coefficients are cast to ``dtype`` first, the input's
        dtype, as the JAX package casts them."""
        lams = self.effective_lambdas().to(dtype)
        return torch.sum(lams[:, None, None, None] * self.synthesize_kernels().to(dtype), dim=0)

    def forward(
        self,
        x: torch.Tensor,
        inference: "bool | str" = False,
        tau: Optional[float] = None,
        fuse_observers: bool = True,
    ) -> torch.Tensor:
        """x (B, 1, Z, X, Y) → tower-probability grid of the same shape.

        ``inference="mxu"`` (split bf16, near f32) and ``"mxu_fast"``
        (single bf16) run the conv, the relu∘tanh head and, when ``tau`` is
        given, the ``>= τ`` threshold in the tensor-core stencil; so does
        ``inference=True`` on ``backend="cuda_mxu"``. With ``backend="cuda"``
        and ``inference=True`` they run in the f32 stencil kernel. Neither
        carries a gradient, like the JAX inference forward. With
        ``inference=False`` the kernel backends run :func:`fused_geneo_conv`
        (``"cuda"``) or :func:`fused_geneo_conv_mxu` (``"cuda_mxu"``),
        differentiable in the parameters. ``tau`` returns the
        ``(prob >= τ)`` mask instead of probabilities.

        ``fuse_observers=False`` convolves x with every observer's kernel
        (the plain conv, on every backend) and sums the responses weighted
        by the convex coefficients: the same function as the fused conv,
        summed in another order.
        """
        if not fuse_observers:
            lams = self.effective_lambdas().to(x.dtype)
            conv = torch.sum(lams[None, :, None, None, None] * self.observer_responses(x),
                             dim=1, keepdim=True)
            out = torch.relu(torch.tanh(conv))
            return (out >= tau).to(out.dtype) if tau is not None else out
        combined = self.combined_kernel(x.dtype)
        if inference in ("mxu", "mxu_fast") or (inference and self.backend == "cuda_mxu"):
            return geneo_stencil_conv_mxu(
                x.detach().float(), combined.detach().float(), activation=True,
                split=inference != "mxu_fast", tau=tau)
        if self.backend != "torch" and inference:
            out = geneo_stencil_conv(x.detach().float(),
                                     combined.detach().float(), activation=True)
        elif self.backend == "cuda_mxu":
            out = fused_geneo_conv_mxu(x.float(), combined.float())
        elif self.backend == "cuda":
            out = fused_geneo_conv(x.float(), combined.float())
        else:
            out = torch.relu(torch.tanh(conv3d_same(x, combined[None, None])))
        return (out >= tau).to(out.dtype) if tau is not None else out

    def observer_responses(self, x: torch.Tensor) -> torch.Tensor:
        """Per-observer convolution responses (B, G, Z, X, Y): the white-box
        view, before the coefficients and the head."""
        return geneo_conv(x, self.synthesize_kernels().to(x.dtype))

    # ---- constraint/loss plumbing -------------------------------------------

    def cvx_coefficients(self) -> Dict[str, torch.Tensor]:
        """The stored convex coefficients by name, λ_last's frozen slot
        included (the convexity penalty reads it)."""
        return dict(self.lambdas)

    def geneo_params_flat(self) -> Dict[str, torch.Tensor]:
        """Every GENEO scalar, trainable or not, under the JAX package's
        flat keys ``geneos_{observer}_geneo_params_{param}``."""
        return {f"geneos_{name}_geneo_params_{p}": v
                for name, _ in self.observers for p, v in self.geneo[name].items()}

    def parameters_in_dict(self) -> Dict[str, float]:
        """Scalar snapshot for the per-epoch parameter log, with the
        *effective* λ_last."""
        out = {f"{name}.{p}": float(v.detach())
               for name, _ in self.observers for p, v in self.geneo[name].items()}
        with torch.no_grad():
            lams = self.effective_lambdas().tolist()
        out.update(zip(self.lambda_names, lams))
        return out

    def num_trainable_params(self) -> int:
        return sum(p.requires_grad for p in self.parameters())

    def num_total_params(self) -> int:
        return sum(1 for _ in self.parameters())

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


def GENEONet(geneo_num: Optional[Mapping[str, int]] = None,
             kernel_size: Tuple[int, int, int] = (9, 6, 6), seed: int = 0,
             backend: str = "torch") -> SceneNet:
    """SceneNet v1 (the v1 kernels and the U[0, 0.6] λ draw): the reference's
    ``GENEONet`` is a duplicate of its ``SCENE_Net``, and the JAX package's
    ``GENEONet`` is this alias."""
    return SceneNet.create(geneo_num, kernel_size, version="v1", seed=seed, backend=backend)


class QuantileSceneNet(nn.Module):
    """Ensemble of one SceneNet per target quantile (aleatoric uncertainty).

    PyTorch twin of :class:`scenenet_tpu.models.scenenet.QuantileSceneNet`.
    The members are ``SceneNet`` submodules that all share member 0's
    structure, its ``last_lambda`` included, as they do there; the JAX
    ``vmap`` over the members is a loop here, one conv per member. The JAX
    package stacks the members' parameters on a leading Q axis;
    :meth:`stacked_state` and :meth:`load_stacked_state` give and take that
    layout, which is also the checkpoint format.
    """

    def __init__(self, members: Sequence[SceneNet],
                 quantiles: Tuple[float, ...] = (0.1, 0.5, 0.9)):
        super().__init__()
        if len(members) != len(quantiles) or not members:
            raise ValueError(f"{len(members)} members for quantiles {tuple(quantiles)}")
        self.quantiles = tuple(float(q) for q in quantiles)
        self.members = nn.ModuleList(members)

    @property
    def net(self) -> SceneNet:
        """The member whose structure all share."""
        return self.members[0]

    @property
    def last_lambda(self) -> str:
        return self.net.last_lambda

    @classmethod
    def create(cls, geneo_num: Optional[Mapping[str, int]] = None,
               kernel_size: Tuple[int, int, int] = (9, 6, 6),
               quantiles: Tuple[float, ...] = (0.1, 0.5, 0.9), version: str = "v2",
               seed: int = 0, backend: str = "torch") -> "QuantileSceneNet":
        """Member q takes the parameters drawn from ``seed + q`` and the
        structure drawn from ``seed``, as in the JAX package."""
        drawn = [SceneNet.create(geneo_num, kernel_size, version, seed=seed + q,
                                 backend=backend) for q in range(len(quantiles))]
        first = drawn[0]
        members = []
        for src in drawn:
            m = SceneNet(first.geneo_num, first.kernel_size, first.version,
                         first.last_lambda, first.backend)
            m.load_state_dict(src.state_dict())
            members.append(m)
        return cls(members, quantiles)

    def forward(self, x: torch.Tensor, inference: "bool | str" = False) -> torch.Tensor:
        """x (B, 1, Z, X, Y) → (B, Q, Z, X, Y); ``inference`` goes to each
        member's :meth:`SceneNet.forward`."""
        return torch.cat([m(x, inference=inference) for m in self.members], dim=1)

    def stacked_state(self) -> Dict[str, torch.Tensor]:
        """``{"geneo.cy_0.radius": (Q,), ...}``: every member parameter
        stacked on a leading Q axis, under a single SceneNet's names."""
        states = [m.state_dict() for m in self.members]
        return {k: torch.stack([s[k] for s in states]) for k in states[0]}

    def load_stacked_state(self, state: Mapping[str, torch.Tensor]) -> None:
        for q, m in enumerate(self.members):
            m.load_state_dict({k: v[q] for k, v in state.items()})

    def cvx_coefficients(self) -> List[Dict[str, torch.Tensor]]:
        return [m.cvx_coefficients() for m in self.members]

    def geneo_params_flat(self) -> List[Dict[str, torch.Tensor]]:
        return [m.geneo_params_flat() for m in self.members]

    def trainable_mask(self) -> Dict:
        return self.net.trainable_mask()


class SceneNetClassifier(SceneNet):
    """SceneNet + trainable threshold τ → hard {0, 1} grid.

    PyTorch twin of :class:`scenenet_tpu.models.scenenet.SceneNetClassifier`.
    The JAX class wraps a SceneNet and keeps ``tau`` beside its parameters;
    here τ is one more 0-d parameter of a SceneNet subclass, so the
    checkpoint keys are the same (``geneo/...``, ``lambdas/...``, ``tau``)
    and the constraint hooks (``cvx_coefficients``, ``geneo_params_flat``,
    ``last_lambda``, ``synthesize_kernels``) are the inner net's own. The
    hard comparison carries no gradient; ``straight_through=True`` gives τ
    and the net the gradient of a sigmoid of slope 50 around it.
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.tau = nn.Parameter(torch.zeros(()))

    @classmethod
    def create(cls, geneo_num: Optional[Mapping[str, int]] = None,
               kernel_size: Tuple[int, int, int] = (9, 6, 6), version: str = "v2",
               seed: int = 0, backend: str = "torch") -> "SceneNetClassifier":
        """The SceneNet of ``seed``, and τ = 0.4·u with u the first draw of a
        numpy ``Generator`` seeded ``seed + 17``: U[0, 0.4], as the JAX
        package draws it."""
        model = super().create(geneo_num, kernel_size, version, seed=seed, backend=backend)
        tau = 0.4 * np.random.default_rng(seed + 17).random()
        with torch.no_grad():
            model.tau.copy_(torch.tensor(tau, dtype=torch.float32))
        return model

    def forward(self, x: torch.Tensor, straight_through: bool = False) -> torch.Tensor:
        """x (B, 1, Z, X, Y) → the {0, 1} grid ``probs >= τ`` in x's dtype."""
        probs = super().forward(x)
        hard = (probs >= self.tau).to(x.dtype)
        if straight_through:
            soft = torch.sigmoid((probs - self.tau) * 50.0)
            return soft + (hard - soft).detach()
        return hard

    def parameters_in_dict(self) -> Dict[str, float]:
        out = super().parameters_in_dict()
        out["tau"] = float(self.tau.detach())
        return out

    def trainable_mask(self) -> Dict:
        return {**super().trainable_mask(), "tau": True}
