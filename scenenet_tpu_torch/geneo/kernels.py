"""Differentiable GENEO kernel synthesis — torch functions of scalar params.

PyTorch twin of :mod:`scenenet_tpu.geneo.kernels`. A GENEO kernel is a
closed-form geometric pattern (cylinder, cone-on-cylinder "arrow",
negative sphere) discretized on a (k_z, k_x, k_y) voxel lattice from a few
interpretable scalars. Kernels are synthesized from the scalars on every
forward pass, so autograd flows through the geometry.

Each family is a function ``params dict → (k_z, k_x, k_y) float32
tensor`` on the device of its ``radius`` parameter, with the same
operations in the same order as the JAX reference, so the two agree to
float32 rounding. The arrow apex is floored and detached (the JAX
``stop_gradient``); the cylinder/cone split is a per-plane ``where`` mask.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Mapping, Tuple

import numpy as np
import torch

Params = Mapping[str, torch.Tensor]
KernelSize = Tuple[int, int, int]

_EPS = 1e-8


def _get(params: Params, name: str, default: float) -> torch.Tensor:
    """Optional scalar parameter, defaulting on the device of ``radius`` (a
    fill on the device: no copy from the host, so a CUDA graph can hold it)."""
    if name in params:
        return params[name]
    return torch.full((), default, dtype=torch.float32, device=params["radius"].device)


def _iota(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=torch.float32, device=like.device)


def _floor_dist2(kernel_size: KernelSize, like: torch.Tensor) -> torch.Tensor:
    """Squared distance of each (x, y) floor cell to the floor center."""
    _, k_x, k_y = kernel_size
    xs = (_iota(k_x, like) - (k_x - 1) / 2.0)[:, None]
    ys = (_iota(k_y, like) - (k_y - 1) / 2.0)[None, :]
    return xs * xs + ys * ys


def _vol_dist2(kernel_size: KernelSize, like: torch.Tensor) -> torch.Tensor:
    """Squared distance of each (z, x, y) cell to the volume center."""
    k_z, k_x, k_y = kernel_size
    zs = (_iota(k_z, like) - (k_z - 1) / 2.0)[:, None, None]
    xs = (_iota(k_x, like) - (k_x - 1) / 2.0)[None, :, None]
    ys = (_iota(k_y, like) - (k_y - 1) / 2.0)[None, None, :]
    return zs * zs + xs * xs + ys * ys


def _sum_zero_planes(kernel: torch.Tensor) -> torch.Tensor:
    """Subtract each z-plane's mean."""
    plane_cells = kernel.shape[1] * kernel.shape[2]
    return kernel - torch.sum(kernel, dim=(1, 2), keepdim=True) / plane_cells


# ---------------------------------------------------------------------------
# Cylinder
# ---------------------------------------------------------------------------

def cylinder_v1(params: Params, kernel_size: KernelSize) -> torch.Tensor:
    """Ring gaussian on the floor plane, zero-sum, tiled over z:
    ``exp(-((d² - r²)²) / (2σ²))``."""
    radius = params["radius"]
    sigma = _get(params, "sigma", 1.0)
    d2 = _floor_dist2(kernel_size, radius)
    circ = d2 - radius * radius
    plane = torch.exp(circ * circ * (-1.0 / (2.0 * (sigma * sigma))))
    plane = plane - torch.sum(plane) / (kernel_size[1] * kernel_size[2])
    return plane[None].expand(kernel_size[0], -1, -1)


def cylinder_v2(params: Params, kernel_size: KernelSize) -> torch.Tensor:
    """Filled gaussian disc ``σ·exp(-(d²)² / (2(r+ε)²))``, zero-sum per
    plane, tiled over z (the live kernel of ``SceneNet``)."""
    radius = params["radius"]
    sigma = _get(params, "sigma", 1.0)
    d2 = _floor_dist2(kernel_size, radius)
    r = radius + _EPS
    plane = sigma * torch.exp(d2 * d2 * (-1.0 / (2.0 * (r * r))))
    plane = plane - torch.sum(plane) / (kernel_size[1] * kernel_size[2])
    return plane[None].expand(kernel_size[0], -1, -1)


# ---------------------------------------------------------------------------
# Cone / arrow
# ---------------------------------------------------------------------------

def _apex_cut(params: Params, kernel_size: KernelSize
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Non-differentiable integer apex height and the cone-region mask.

    Returns (z, is_cone[z], cone_height) with is_cone[z] = z < k_z - h_c.
    """
    h_c = torch.floor(params["apex"].detach())
    z = _iota(kernel_size[0], params["apex"])[:, None, None]
    cone_height = kernel_size[0] - h_c
    return z, z < cone_height, cone_height


def cone_v1(params: Params, kernel_size: KernelSize) -> torch.Tensor:
    """v1 cone: ring gaussians with a per-height sigma schedule.

    Cone planes use ``σ_h = cone_radius·sin(cone_inc·π/(2+h))`` with
    h = cone_height−1−z; cylinder planes use the base (radius, sigma).
    """
    radius = params["radius"]
    sigma = _get(params, "sigma", 1.0)
    cone_radius = _get(params, "cone_radius", float(kernel_size[1] - 1))
    cone_inc = params["cone_inc"]
    z, is_cone, cone_height = _apex_cut(params, kernel_size)
    h = cone_height - 1.0 - z
    sig_z = torch.where(is_cone,
                        cone_radius * torch.sin(cone_inc * math.pi / (2.0 + h)),
                        sigma)
    d2 = _floor_dist2(kernel_size, radius)[None]
    circ = d2 - radius * radius
    kernel = torch.exp(circ * circ * (-1.0 / (2.0 * (sig_z * sig_z))))
    return _sum_zero_planes(kernel)


def arrow_v2(params: Params, kernel_size: KernelSize) -> torch.Tensor:
    """Live arrow kernel: gaussian discs whose radius grows linearly with z.

    Cone planes (z < k_z − h_c): ``r_z = cone_radius·z·tan(clamp(cone_inc,
    0, 0.499)·π)``; cylinder planes: base radius. Every plane is
    ``σ·exp(-(d²)²/(2(r_z+ε)²))``, zero-sum.
    """
    radius = params["radius"]
    sigma = _get(params, "sigma", 1.0)
    cone_radius = _get(params, "cone_radius", float(kernel_size[1] - 1))
    cone_inc = torch.clamp(params["cone_inc"], 0.0, 0.499)
    z, is_cone, _ = _apex_cut(params, kernel_size)
    r_z = torch.where(is_cone, cone_radius * z * torch.tan(cone_inc * math.pi),
                      radius)
    d2 = _floor_dist2(kernel_size, radius)[None]
    r = r_z + _EPS
    kernel = sigma * torch.exp(d2 * d2 * (-1.0 / (2.0 * (r * r))))
    return _sum_zero_planes(kernel)


# ---------------------------------------------------------------------------
# Negative sphere
# ---------------------------------------------------------------------------

def neg_sphere_v1(params: Params, kernel_size: KernelSize) -> torch.Tensor:
    """3D ring gaussian, volume-mean-centered, shifted by −neg_factor."""
    radius = params["radius"]
    sigma = _get(params, "sigma", 1.0)
    neg_factor = params["neg_factor"]
    d2 = _vol_dist2(kernel_size, radius)
    circ = d2 - radius * radius
    g = torch.exp(circ * circ * (-1.0 / (2.0 * (sigma * sigma))))
    volume = math.prod(kernel_size)
    return g - torch.sum(g) / volume - neg_factor


def neg_sphere_v2(params: Params, kernel_size: KernelSize) -> torch.Tensor:
    """Live neg-sphere: ``−neg_factor·σ·exp(-(d²)²/(2(r+ε)²))`` then a mean
    shift of ``(sum + neg_factor)/volume``."""
    radius = params["radius"]
    sigma = _get(params, "sigma", 1.0)
    neg_factor = params["neg_factor"]
    d2 = _vol_dist2(kernel_size, radius)
    r = radius + _EPS
    g = sigma * torch.exp(d2 * d2 * (-1.0 / (2.0 * (r * r))))
    kernel = -neg_factor * g
    volume = math.prod(kernel_size)
    return kernel - (torch.sum(kernel) + neg_factor) / volume


# ---------------------------------------------------------------------------
# Registry + initialization
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class KernelDef:
    """A GENEO kernel family: synthesis fn + parameter schema + initializers."""

    name: str
    fn: Callable[[Params, KernelSize], torch.Tensor]
    mandatory: Tuple[str, ...]
    parameters: Tuple[str, ...]
    non_trainable: Tuple[str, ...]
    random_init: Callable[[np.random.Generator, KernelSize], Dict[str, float]]
    smart_init: Dict[str, float]


# The draws below take the same calls on the numpy Generator in the same
# order as the JAX package, so one seed gives bit-identical parameters.

def _cyl_random(rng: np.random.Generator, ks: KernelSize) -> Dict[str, float]:
    return {
        "radius": float(rng.integers(1, ks[1])) / 2.0,
        "sigma": float(rng.integers(5, 10)) / 5.0,
    }


def _cone_random(rng: np.random.Generator, ks: KernelSize) -> Dict[str, float]:
    return {
        "radius": float(rng.integers(1, ks[1])) / 2.0,
        "apex": float(rng.integers(ks[0] // 2, ks[0] - 1)),
        "cone_radius": float(rng.integers(1, ks[1])) / 2.0,
        "cone_inc": float(rng.random()),
        "sigma": float(rng.integers(5, 10)) / 5.0,
    }


def _neg_random(rng: np.random.Generator, ks: KernelSize) -> Dict[str, float]:
    return {
        "radius": float(rng.integers(1, ks[1])),
        "neg_factor": float(rng.integers(1, 10)) / 10.0,
        "sigma": float(rng.integers(5, 10)) / 10.0,
    }


KERNEL_REGISTRY: Dict[str, KernelDef] = {
    "cylinder": KernelDef(
        "cylinder", cylinder_v1, ("radius",), ("radius", "sigma"), (),
        _cyl_random, {"radius": 1.0, "sigma": 2.0},
    ),
    "cylinder_v2": KernelDef(
        "cylinder_v2", cylinder_v2, ("radius",), ("radius", "sigma"), (),
        _cyl_random, {"radius": 1.0, "sigma": 2.0},
    ),
    "cone": KernelDef(
        "cone", cone_v1, ("radius", "apex", "cone_radius", "cone_inc"),
        ("radius", "apex", "cone_radius", "cone_inc", "sigma"), ("apex",),
        _cone_random,
        {"radius": 1.0, "apex": 3.0, "cone_radius": 2.0, "cone_inc": 0.1, "sigma": 2.0},
    ),
    "arrow": KernelDef(
        "arrow", arrow_v2, ("radius", "apex", "cone_radius", "cone_inc"),
        ("radius", "apex", "cone_radius", "cone_inc", "sigma"), ("apex",),
        _cone_random,
        {"radius": 1.0, "apex": 3.0, "cone_radius": 2.0, "cone_inc": 0.1, "sigma": 2.0},
    ),
    "neg_sphere": KernelDef(
        "neg_sphere", neg_sphere_v1, ("radius", "neg_factor"),
        ("radius", "neg_factor", "sigma"), (),
        _neg_random, {"radius": 3.0, "sigma": 2.0, "neg_factor": 0.5},
    ),
    "neg_sphere_v2": KernelDef(
        "neg_sphere_v2", neg_sphere_v2, ("radius", "neg_factor"),
        ("radius", "neg_factor", "sigma"), (),
        _neg_random, {"radius": 3.0, "sigma": 2.0, "neg_factor": 0.5},
    ),
}


def random_geneo_params(
    kind: str, rng: np.random.Generator, kernel_size: KernelSize
) -> Dict[str, float]:
    """Random init: the reference's ``geneo_random_config`` draws."""
    return KERNEL_REGISTRY[kind].random_init(rng, kernel_size)


def smart_geneo_params(kind: str) -> Dict[str, float]:
    """Hand-tuned init: the reference's ``geneo_smart_config``."""
    return dict(KERNEL_REGISTRY[kind].smart_init)
