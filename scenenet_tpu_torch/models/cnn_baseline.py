"""Black-box CNN baselines with SceneNet's I/O contract.

PyTorch twin of :class:`scenenet_tpu.models.cnn_baseline.CnnBaseline`:
one or two plain SAME 3D convolutions with bias, a channel sum and a
relu∘tanh head, with empty ``cvx_coefficients`` / ``geneo_params_flat``
so the GENEO losses accept it unchanged.

With ``backend="cuda"`` a (3, 3, 3) kernel runs the hand-written
multi-channel conv (:func:`~scenenet_tpu_torch.ops.cuda_conv_mc.fused_conv3d_mc`)
and adds the bias after it. Every other kernel size runs ``F.conv3d``
under the asymmetric SAME pads on either backend, as the JAX model runs
XLA's conv: the hand-written kernel is 3³ only in both packages.

A checkpoint holds the flax layout (:meth:`CnnBaseline.flax_state`):
``Conv_i/kernel`` (k_z, k_x, k_y, in, out) and ``Conv_i/bias``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from scenenet_tpu_torch.models.unet3d import (
    conv3d_kernel_to_flax, lecun_normal_, load_flax_views,
)
from scenenet_tpu_torch.ops.conv3d import conv3d_f32, same_pads
from scenenet_tpu_torch.ops.cuda_conv_mc import fused_conv3d_mc

_BACKENDS = ("torch", "cuda")


def cnn_conv(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
             kernel_size: Tuple[int, int, int], backend: str) -> torch.Tensor:
    """The baseline's SAME conv with bias: on ``backend="cuda"`` at (3, 3, 3)
    the hand-written multi-channel conv, else the library conv under the
    asymmetric SAME pads (also the pipeline's stage conv, ``parallel/pp.py``)."""
    if backend == "cuda" and tuple(kernel_size) == (3, 3, 3):
        return fused_conv3d_mc(x, w) + bias[None, :, None, None, None]
    return conv3d_f32(F.pad(x, same_pads(kernel_size)), w, bias)


class CnnBaseline(nn.Module):
    """Build with :meth:`create` to draw the weights from a seed."""

    def __init__(self, conv_num: int = 3, kernel_size: Tuple[int, int, int] = (9, 9, 9),
                 two_layers: bool = True, backend: str = "torch"):
        super().__init__()
        if backend not in _BACKENDS:
            raise ValueError(f"backend must be one of {_BACKENDS}, got {backend!r}")
        self.conv_num = int(conv_num)
        self.kernel_size = tuple(int(k) for k in kernel_size)
        self.two_layers = bool(two_layers)
        self.backend = backend
        self.weights = nn.ParameterList()
        self.biases = nn.ParameterList()
        for c_in in (1, self.conv_num)[:2 if self.two_layers else 1]:
            self.weights.append(nn.Parameter(torch.zeros((self.conv_num, c_in,
                                                          *self.kernel_size))))
            self.biases.append(nn.Parameter(torch.zeros(self.conv_num)))
        # channel tensor parallelism (parallel/gspmd.py): the gather over the
        # model axis after each conv, where the convs hold a slice of their
        # output channels
        self.gathers = None

    @classmethod
    def create(cls, conv_num: int = 3, kernel_size=(9, 9, 9), seed: int = 0,
               two_layers: bool = True, backend: str = "torch") -> "CnnBaseline":
        """A model with flax's initial values: lecun-normal kernels drawn from
        an explicit generator seeded with ``seed``, zero biases."""
        model = cls(conv_num, kernel_size, two_layers, backend)
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for w in model.weights:
                lecun_normal_(w, gen)
        return model

    def _conv(self, x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        return cnn_conv(x, w, bias, self.kernel_size, self.backend)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, 1, Z, X, Y) → relu(tanh(Σ channels)) (B, 1, Z, X, Y)."""
        h = x.float()
        for i, (w, bias) in enumerate(zip(self.weights, self.biases)):
            h = self._conv(h, w, bias)
            if self.gathers is not None:
                h = self.gathers[i](h)
        return torch.relu(torch.tanh(h.sum(dim=1, keepdim=True)))

    def flax_state(self) -> Dict[str, torch.Tensor]:
        """The parameters under the JAX package's names ('.'-joined) and in
        its layouts."""
        state = {}
        for i, (w, bias) in enumerate(zip(self.weights, self.biases)):
            state[f"Conv_{i}.kernel"] = conv3d_kernel_to_flax(w.detach())
            state[f"Conv_{i}.bias"] = bias.detach()
        return state

    def load_flax_state(self, state: Mapping[str, torch.Tensor]) -> None:
        load_flax_views(self.flax_state(), state, "CnnBaseline")

    # GENEO-loss API compatibility
    def cvx_coefficients(self) -> Dict:
        return {}

    def geneo_params_flat(self) -> Dict:
        return {}


def CnnBaseline2(conv_num: int = 1, kernel_size=(3, 2, 2), seed: int = 0,
                 backend: str = "torch") -> CnnBaseline:
    """Single-conv variant, kernel (3, 2, 2)."""
    return CnnBaseline.create(conv_num=conv_num, kernel_size=kernel_size, seed=seed,
                              two_layers=False, backend=backend)
