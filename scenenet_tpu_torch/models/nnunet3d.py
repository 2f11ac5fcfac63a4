"""nnU-Net's ``3d_fullres`` network, ``PlainConvUNet`` (Isensee et al.,
*Nature Methods* 18:203–211, 2021; nnunetv2 ``get_network_from_plans`` →
``dynamic_network_architectures``), as its planner sets it for an
isotropic patch. It has no counterpart in the JAX package.

- **Stages.** Stage s has ``min(32·2^s, 320)`` channels; stage 0 keeps the
  input's resolution and every later stage halves it, while the edge stays
  at least 4 (:func:`plan`): at 128³ six stages, 32-64-128-256-320-320 at
  128, 64, 32, 16, 8 and 4.
- **Encoder.** Two 3³ convs a stage, each with a bias and followed by
  InstanceNorm (affine, ε 1e-5, no running statistics) and LeakyReLU(0.01);
  the first conv of every stage but the first has stride 2 and pad 1.
- **Decoder.** At each level, from the deepest up, a transposed conv of
  kernel 2 and stride 2 with a bias takes the level below to the skip's
  width; ``cat((up, skip), 1)``; two 3³ stride-1 convs with the norm and
  the nonlinearity.
- **Deep supervision.** Each level has a 1×1×1 head with a bias. In
  training with ``deep_supervision`` the forward returns every level's
  sigmoid output, highest resolution first; otherwise the top one alone
  (nnU-Net turns deep supervision off to predict). The heads end in a
  sigmoid so that the port's criteria take probabilities, as for the UNet;
  nnU-Net's take logits.

``backend="cuda"`` runs the stride-1 3³ convs through
:func:`~scenenet_tpu_torch.ops.cuda_conv_mc.fused_conv3d_mc` (K10 forward
and dx, K10's dw) and adds their bias after; ``backend="torch"`` through
``F.conv3d``. On both the strided and transposed convs and the norm are
the library calls of :mod:`~scenenet_tpu_torch.ops.library_conv`, and the
heads matrix products over the channels. The model is f32 only.

Parameter names: ``encoder.<stage>.<conv>.{weight,bias,norm_weight,norm_bias}``,
``up.<level>.{weight,bias}``, ``decoder.<level>.<conv>...`` and
``heads.<level>.{weight,bias}``, level 0 the deepest. Checkpoints hold the
``state_dict``.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
from torch import nn

from scenenet_tpu_torch.ops.cuda_conv_mc import conv3d_mc_same_plain, fused_conv3d_mc
from scenenet_tpu_torch.ops.library_conv import (
    conv3d_strided, conv_transpose3d_k2, instance_norm_lrelu,
)

_BACKENDS = ("torch", "cuda")
BASE_FEATURES = 32
MAX_FEATURES = 320      # nnU-Net's cap for 3D networks
MIN_EDGE = 4            # the planner's smallest feature map
HE_SLOPE = 1e-2         # InitWeights_He(1e-2)


def plan(grid: Sequence[int]) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(features, strides) of the stages nnU-Net's planner gives an
    isotropic patch of edge ``grid[0]``: halve while the edge stays even and
    at least ``MIN_EDGE``; ``min(32·2^s, 320)`` channels a stage."""
    if len(set(grid)) != 1:
        raise ValueError(f"an isotropic grid is planned here, got {tuple(grid)}")
    edge, strides = int(grid[0]), [1]
    while edge % 2 == 0 and edge // 2 >= MIN_EDGE:
        edge //= 2
        strides.append(2)
    features = tuple(min(BASE_FEATURES * 2 ** s, MAX_FEATURES) for s in range(len(strides)))
    return features, tuple(strides)


def he_normal_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """``kaiming_normal_(w, a=1e-2)`` (fan in: ``w.shape[1]`` × the taps,
    as torch takes it for conv and transposed-conv weights alike) from
    ``generator``, in place."""
    fan_in = w.shape[1] * math.prod(w.shape[2:])
    std = math.sqrt(2.0 / (1.0 + HE_SLOPE ** 2)) / math.sqrt(fan_in)
    with torch.no_grad():
        return w.normal_(0.0, std, generator=generator)


class _ConvNorm(nn.Module):
    """3³ conv with a bias (stride 1 or 2, pad 1) → InstanceNorm → LeakyReLU."""

    def __init__(self, c_in: int, c_out: int, stride: int, backend: str):
        super().__init__()
        self.stride, self.backend = stride, backend
        self.weight = nn.Parameter(torch.zeros((c_out, c_in, 3, 3, 3)))
        self.bias = nn.Parameter(torch.zeros(c_out))
        self.norm_weight = nn.Parameter(torch.ones(c_out))
        self.norm_bias = nn.Parameter(torch.zeros(c_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stride == 2:
            y = conv3d_strided(x, self.weight, self.bias)
        else:
            conv = fused_conv3d_mc if self.backend == "cuda" else conv3d_mc_same_plain
            y = conv(x, self.weight) + self.bias.view(1, -1, 1, 1, 1)
        return instance_norm_lrelu(y, self.norm_weight, self.norm_bias)


class _Up(nn.Module):
    """The transposed conv of kernel 2 and stride 2, with a bias."""

    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros((c_in, c_out, 2, 2, 2)))
        self.bias = nn.Parameter(torch.zeros(c_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_transpose3d_k2(x, self.weight, self.bias)


class _Head(nn.Module):
    """The 1×1×1 segmentation head with a bias and a sigmoid, as one matrix
    product over the channels."""

    def __init__(self, c_in: int, n_classes: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros((n_classes, c_in, 1, 1, 1)))
        self.bias = nn.Parameter(torch.zeros(n_classes))

    def forward(self, u: torch.Tensor) -> torch.Tensor:
        out = torch.matmul(self.weight.flatten(1), u.flatten(2))
        return torch.sigmoid(out.view(u.shape[0], -1, *u.shape[2:])
                             + self.bias.view(1, -1, 1, 1, 1))


class NNUNet3D(nn.Module):
    """Build with :meth:`create` to draw the weights from a seed."""

    is_stateful = False  # InstanceNorm keeps no running statistics

    def __init__(self, features: Sequence[int] = (32, 64, 128, 256, 320, 320),
                 strides: Sequence[int] = (1, 2, 2, 2, 2, 2), in_channels: int = 1,
                 n_classes: int = 1, convs_per_stage: int = 2, deep_supervision: bool = True,
                 backend: str = "torch"):
        super().__init__()
        if backend not in _BACKENDS:
            raise ValueError(f"backend must be one of {_BACKENDS}, got {backend!r}")
        if len(features) != len(strides) or len(features) < 2 or strides[0] != 1 \
                or any(s != 2 for s in strides[1:]):
            raise ValueError(f"features {tuple(features)} and strides {tuple(strides)}: want "
                             "two or more stages, stride 1 then 2 at every later stage")
        if convs_per_stage < 1:
            raise ValueError(f"convs_per_stage must be >= 1, got {convs_per_stage}")
        self.features, self.strides = tuple(features), tuple(strides)
        self.n_classes, self.backend = n_classes, backend
        self.deep_supervision = deep_supervision

        def stage(c_in: int, c_out: int, stride: int) -> nn.Sequential:
            return nn.Sequential(*[_ConvNorm(c_in if i == 0 else c_out, c_out,
                                             stride if i == 0 else 1, backend)
                                   for i in range(convs_per_stage)])

        chans = [in_channels] + list(features)
        self.encoder = nn.ModuleList(stage(chans[s], chans[s + 1], strides[s])
                                     for s in range(len(features)))
        deep = list(reversed(features))  # the levels from the bottleneck up
        self.up = nn.ModuleList(_Up(deep[i], deep[i + 1]) for i in range(len(deep) - 1))
        self.decoder = nn.ModuleList(stage(2 * deep[i + 1], deep[i + 1], 1)
                                     for i in range(len(deep) - 1))
        self.heads = nn.ModuleList(_Head(deep[i + 1], n_classes) for i in range(len(deep) - 1))

    @classmethod
    def create(cls, grid: Sequence[int] = (128, 128, 128), n_classes: int = 1, seed: int = 0,
               backend: str = "torch", deep_supervision: bool = True) -> "NNUNet3D":
        """The network :func:`plan` gives ``grid``, initialised as nnU-Net's
        ``InitWeights_He(1e-2)``: He-normal conv, transposed-conv and head
        weights from a generator seeded with ``seed``, zero biases,
        InstanceNorm scale 1 and bias 0."""
        features, strides = plan(grid)
        model = cls(features, strides, n_classes=n_classes, backend=backend,
                    deep_supervision=deep_supervision)
        gen = torch.Generator().manual_seed(seed)
        for name, p in model.named_parameters():
            if name.endswith(".weight") and p.ndim == 5:
                he_normal_(p, gen)
        return model

    def forward(self, x: torch.Tensor) -> "torch.Tensor | List[torch.Tensor]":
        """x (B, C_in, Z, X, Y) → sigmoid probabilities: every level's, highest
        resolution first, in training with deep supervision; else the top
        level's (B, n_classes, Z, X, Y) alone."""
        every = self.training and self.deep_supervision
        skips = []
        for stage in self.encoder:
            x = stage(x)
            skips.append(x)
        u, outs = skips.pop(), []
        for level, (up, stage, head) in enumerate(zip(self.up, self.decoder, self.heads)):
            u = stage(torch.cat([up(u), skips.pop()], dim=1))
            if every or level == len(self.heads) - 1:
                outs.append(head(u))
        return outs[::-1] if every else outs[0]

    # ---- the GENEO-loss hooks: a black box has none of either ----------------

    def cvx_coefficients(self) -> dict:
        return {}

    def geneo_params_flat(self) -> dict:
        return {}
