"""SCENE-Net v2 in plain PyTorch: GENEO kernels from their scalars, folded
by the convex coefficients into one 3D kernel, a SAME correlation of the
occupancy grid with it, and the relu∘tanh head; its loss; Adam.

The kernel families follow the reference implementation's v2 kernels
(``cylinder_v2``, ``arrow``, ``neg_sphere_v2``) with their f32
arithmetic. ``precision="tf32"`` rounds the conv's operands to TF32: the
control that has to come out as not correct.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from perfbench.reference import full_f32, tf32_st
from perfbench.weights import FROZEN, observer_names

_EPS = 1e-8


def _iota(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.float32, device=device)


def _floor_d2(ks, device) -> torch.Tensor:
    _, kx, ky = ks
    xs = (_iota(kx, device) - (kx - 1) / 2.0)[:, None]
    ys = (_iota(ky, device) - (ky - 1) / 2.0)[None, :]
    return xs * xs + ys * ys


def _vol_d2(ks, device) -> torch.Tensor:
    kz, kx, ky = ks
    zs = (_iota(kz, device) - (kz - 1) / 2.0)[:, None, None]
    xs = (_iota(kx, device) - (kx - 1) / 2.0)[None, :, None]
    ys = (_iota(ky, device) - (ky - 1) / 2.0)[None, None, :]
    return zs * zs + xs * xs + ys * ys


def cylinder(p: Dict[str, torch.Tensor], ks) -> torch.Tensor:
    """A gaussian disc ``σ·exp(−(d²)²/(2(r+ε)²))`` on the floor plane, its
    mean taken off, repeated over z."""
    d2 = _floor_d2(ks, p["radius"].device)
    r = p["radius"] + _EPS
    plane = p["sigma"] * torch.exp(d2 * d2 * (-1.0 / (2.0 * (r * r))))
    plane = plane - torch.sum(plane) / (ks[1] * ks[2])
    return plane[None].expand(ks[0], -1, -1)


def arrow(p: Dict[str, torch.Tensor], ks) -> torch.Tensor:
    """Gaussian discs whose radius grows linearly with z below the apex
    (``cone_radius·z·tan(clamp(cone_inc, 0, 0.499)·π)``) and is the base
    radius above it; each plane's mean taken off."""
    dev = p["radius"].device
    cone_inc = torch.clamp(p["cone_inc"], 0.0, 0.499)
    h_c = torch.floor(p["apex"].detach())
    z = _iota(ks[0], dev)[:, None, None]
    r_z = torch.where(z < ks[0] - h_c, p["cone_radius"] * z * torch.tan(cone_inc * math.pi),
                      p["radius"])
    d2 = _floor_d2(ks, dev)[None]
    r = r_z + _EPS
    k = p["sigma"] * torch.exp(d2 * d2 * (-1.0 / (2.0 * (r * r))))
    return k - torch.sum(k, dim=(1, 2), keepdim=True) / (ks[1] * ks[2])


def neg_sphere(p: Dict[str, torch.Tensor], ks) -> torch.Tensor:
    """``−neg_factor·σ·exp(−(d²)²/(2(r+ε)²))`` over the volume, shifted by
    ``(sum + neg_factor)/volume``."""
    d2 = _vol_d2(ks, p["radius"].device)
    r = p["radius"] + _EPS
    k = -p["neg_factor"] * (p["sigma"] * torch.exp(d2 * d2 * (-1.0 / (2.0 * (r * r)))))
    return k - (torch.sum(k) + p["neg_factor"]) / math.prod(ks)


FAMILIES = {"cylinder_v2": cylinder, "arrow": arrow, "neg_sphere_v2": neg_sphere}


class SceneNet:
    """The model as a dict of 0-d f32 tensors (the benchmark's weights)."""

    def __init__(self, config: dict, weights: dict, device):
        self.ks = tuple(config["kernel_size"])
        self.observers = observer_names(config["geneo_num"])
        self.last = weights["last_lambda"]
        self.params = {k: torch.tensor(v, dtype=torch.float32, device=device)
                       for k, v in weights["values"].items()}

    def trainable(self) -> List[str]:
        """The names Adam moves: all but the apex heights and the derived λ."""
        return [k for k in self.params
                if k.split(".")[-1] not in FROZEN and k != f"lambdas.{self.last}"]

    def combined_kernel(self) -> torch.Tensor:
        lam = {n: self.params[f"lambdas.lambda_{n}"] for n, _ in self.observers}
        free = sum(v for n, v in lam.items() if f"lambda_{n}" != self.last)
        total = 0.0
        for name, kind in self.observers:
            p = {k.split(".")[-1]: v for k, v in self.params.items()
                 if k.startswith(f"geneo.{name}.")}
            coeff = 1.0 - free if f"lambda_{name}" == self.last else lam[name]
            total = total + coeff * FAMILIES[kind](p, self.ks)
        return total

    def forward(self, x: torch.Tensor, precision: str = "f32") -> torch.Tensor:
        """x (B, 1, Z, X, Y) → relu(tanh(x ⋆ kernel)), SAME padding."""
        k = self.combined_kernel()
        if precision == "tf32":
            x, k = tf32_st(x), tf32_st(k)
        pads = tuple(p for kk in reversed(self.ks) for p in ((kk - 1) // 2, kk // 2))
        with full_f32():
            conv = F.conv3d(F.pad(x, pads), k[None, None])
        return torch.relu(torch.tanh(conv))

    def penalties(self, convex_weight: float) -> torch.Tensor:
        """Hinge penalties on negative convex coefficients (the derived last
        one included) and on negative GENEO scalars, times the weight."""
        lam = {k: v for k, v in self.params.items() if k.startswith("lambdas.")}
        total = sum(lam.values())
        free = sum(torch.relu(-v) for k, v in lam.items() if k != f"lambdas.{self.last}")
        derived = 1.0 - total + lam[f"lambdas.{self.last}"]
        cvx = convex_weight * (free + torch.relu(-derived))
        geneo = convex_weight * sum(torch.relu(-v) for k, v in self.params.items()
                                    if k.startswith("geneo."))
        return cvx + geneo


def weighted_mse(pred: torch.Tensor, gt: torch.Tensor, c: dict) -> torch.Tensor:
    """``mean(mse_weight · w(gt) · (gt − pred)²)``: a target's weight from
    the density table (its nearest range start's frequency, min-max
    normalised), ``max(1 − α·density, ε)``, normalised to mean 1."""
    p = c["criterion_params"]
    table = c["weighting_table"]
    ranges = torch.tensor(table["ranges"], dtype=torch.float32, device=gt.device)
    freqs = torch.tensor(table["freqs"], dtype=torch.float32, device=gt.device)
    idx = torch.argmin(torch.abs(gt[..., None] - ranges), dim=-1)
    dens = (freqs[idx] - freqs.min()) / (freqs.max() - freqs.min())
    w = torch.clamp(1.0 - p["weight_alpha"] * dens, min=p["weight_epsilon"])
    w = w / w.mean()
    return torch.mean(p["mse_weight"] * w * (gt - pred) ** 2)


def focal_tversky(pred: torch.Tensor, gt: torch.Tensor, c: dict) -> torch.Tensor:
    """``(1 − Tversky)^γ`` over the batch's sums."""
    p = c["criterion_params"]
    tp = torch.sum(pred * gt)
    fp = torch.sum((1.0 - gt) * pred)
    fn = torch.sum(gt * (1.0 - pred))
    s = p["tversky_smooth"]
    t = (tp + s) / (tp + p["tversky_alpha"] * fp + p["tversky_beta"] * fn + s)
    return (1.0 - t) ** p["focal_gamma"]


def geneo_tversky(pred, gt, c: dict, penalties=None) -> torch.Tensor:
    """The default criterion: weighted MSE + focal Tversky (+ the GENEO
    penalties where the model has them)."""
    loss = weighted_mse(pred, gt, c) + focal_tversky(pred, gt, c)
    return loss if penalties is None else loss + penalties


class Adam:
    """Adam with β (0.9, 0.999) and ε 1e-8 added to the bias-corrected root."""

    def __init__(self, params: Dict[str, torch.Tensor], names: List[str], config: dict):
        self.params = params
        self.names = names
        a = config.get("adam", {})
        self.lr = float(config["learning_rate"])
        self.b1, self.b2 = float(a.get("beta1", 0.9)), float(a.get("beta2", 0.999))
        self.eps = float(a.get("eps", 1e-8))
        self.t = 0
        self.m = {n: torch.zeros_like(params[n]) for n in names}
        self.v = {n: torch.zeros_like(params[n]) for n in names}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        bc1, bc2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        for n in self.names:
            g = grads[n]
            self.m[n].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[n].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = self.v[n].sqrt() / math.sqrt(bc2) + self.eps
            self.params[n].addcdiv_(self.m[n], denom, value=-self.lr / bc1)


def confusion(pred: torch.Tensor, gt: torch.Tensor, tau: float) -> torch.Tensor:
    """(tp, fp, fn, tn) of ``pred >= τ`` against ``gt >= 0.5``."""
    p, t = (pred >= tau).reshape(-1), (gt >= 0.5).reshape(-1)
    tp, fp, fn = (p & t).sum(), (p & ~t).sum(), (~p & t).sum()
    return torch.stack([tp, fp, fn, p.numel() - tp - fp - fn])


def train(config: dict, weights: dict, batches, device, precision: str = "f32") -> dict:
    """Adam steps of SceneNet from ``weights`` on ``batches`` of (x, y)
    grids: each step's loss, the first step's gradients, the parameters
    after the last step and the summed confusion counts (of each step's
    prediction before its update)."""
    net = SceneNet(config, weights, device)
    names = net.trainable()
    for n in names:
        net.params[n].requires_grad_(True)
    opt = Adam(net.params, names, config)
    losses, first, counts = [], None, torch.zeros(4, dtype=torch.int64, device=device)
    for x, y in batches:
        pred = net.forward(x, precision)
        loss = geneo_tversky(pred, y, config,
                             net.penalties(config["criterion_params"]["convex_weight"]))
        grads = torch.autograd.grad(loss, [net.params[n] for n in names])
        grads = dict(zip(names, grads))
        if first is None:
            first = {n: g.detach().clone() for n, g in grads.items()}
        counts += confusion(pred.detach(), y, config["tau"])
        losses.append(float(loss.detach()))
        opt.step(grads)
    return {"losses": losses, "grads": first,
            "params": {n: v.detach().clone() for n, v in net.params.items()},
            "counts": counts}
