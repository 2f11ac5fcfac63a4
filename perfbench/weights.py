"""The weights of a run, drawn from its seed by the benchmark itself.

Both sides get the same values: the program has them written into its
model by parameter name, and the plain reference builds its own model from
the same dict. The program's own initialisers are not used.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from perfbench.synth import sub_seed

# SceneNet v2: observer → (kernel family, its parameters in draw order)
OBSERVERS = {"cy": ("cylinder_v2", ("radius", "sigma")),
             "cone": ("arrow", ("radius", "apex", "cone_radius", "cone_inc", "sigma")),
             "neg": ("neg_sphere_v2", ("radius", "neg_factor", "sigma"))}
FROZEN = ("apex",)  # the arrow's apex height is floored and not trained


def observer_names(geneo_num: Dict[str, int]) -> List[Tuple[str, str]]:
    """(observer name, kernel family) in model order: ``cy_0``, ``cone_0``, ..."""
    return [(f"{key}_{i}", OBSERVERS[key][0])
            for key, num in geneo_num.items() for i in range(int(num))]


def _draw(kind: str, rng: np.random.Generator, ks) -> Dict[str, float]:
    """The reference's random GENEO configuration of one observer."""
    if kind == "cylinder_v2":
        return {"radius": float(rng.integers(1, ks[1])) / 2.0,
                "sigma": float(rng.integers(5, 10)) / 5.0}
    if kind == "arrow":
        return {"radius": float(rng.integers(1, ks[1])) / 2.0,
                "apex": float(rng.integers(ks[0] // 2, ks[0] - 1)),
                "cone_radius": float(rng.integers(1, ks[1])) / 2.0,
                "cone_inc": float(rng.random()),
                "sigma": float(rng.integers(5, 10)) / 5.0}
    return {"radius": float(rng.integers(1, ks[1])),
            "neg_factor": float(rng.integers(1, 10)) / 10.0,
            "sigma": float(rng.integers(5, 10)) / 10.0}


def scenenet_weights(seed: int, config: dict) -> dict:
    """SceneNet's scalars from ``seed``: ``{"values": {name: float},
    "last_lambda": name}`` with the program's parameter names
    (``geneo.cy_0.radius``, ``lambdas.lambda_cy_0``). The convex
    coefficients are drawn in [-2/G, 1/G] (SceneNet v2's draw) and the last
    one set to 1 minus the others, so that they sum to 1 whichever is
    derived."""
    rng = np.random.default_rng(sub_seed(seed, 3))
    observers = observer_names(config["geneo_num"])
    ks = tuple(config["kernel_size"])
    g = len(observers)
    last = f"lambda_{observers[int(rng.integers(0, g))][0]}"
    values = {}
    for name, kind in observers:
        for p, v in _draw(kind, rng, ks).items():
            values[f"geneo.{name}.{p}"] = v
    lams = {f"lambda_{name}": float(np.float32(rng.uniform(-2.0 / g, 1.0 / g)))
            for name, _ in observers}
    lams[last] = float(np.float32(1.0) - np.float32(sum(v for k, v in lams.items()
                                                          if k != last)))
    values.update((f"lambdas.{k}", v) for k, v in lams.items())
    return {"values": values, "last_lambda": last}


def unet_weights(seed: int, shapes: Dict[str, Tuple[int, ...]], device) -> Dict[str, torch.Tensor]:
    """The UNet's weights from ``seed`` in one draw on ``device``: every conv
    kernel and the head uniform with variance 1/fan_in (fan_in = input
    channels × taps), the head's bias 0, BatchNorm scale 1 and bias 0."""
    gen = torch.Generator(device).manual_seed(sub_seed(seed, 4))
    drawn = [n for n, s in shapes.items() if len(s) == 5]
    total = sum(math.prod(shapes[n]) for n in drawn)
    flat = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    out, at = {}, 0
    for name, shape in shapes.items():
        if name in drawn:
            size = math.prod(shape)
            bound = math.sqrt(3.0 / math.prod(shape[1:]))
            out[name] = (flat[at:at + size] * bound).view(shape)
            at += size
        elif name.endswith(".scale"):
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out
