"""3D U-Net comparison baseline.

PyTorch twin of :class:`scenenet_tpu.models.unet3d.UNet3D` as an
``nn.Module``: an encoder/decoder of [Conv→BN→ReLU]×2 blocks, 2× max-pool
downscaling, nearest-neighbour upsampling with pad-and-concat skip
connections, a 1×1×1 output conv and a sigmoid head. Channel ladder
32→64→128→256→256 (the bottleneck halved for the non-transposed
upsampling). The blocks carry the JAX module's names (``down0..down4``,
``up0..up3``, ``out``); tensors are channels first throughout (the flax
module is channels last inside, for the TPU).

``backend="torch"`` runs every 3³ conv as ``F.conv3d`` (TF32 off); ``backend="cuda"``
runs it through :func:`~scenenet_tpu_torch.ops.cuda_conv_mc.fused_conv3d_mc`,
the hand-written kernel forward and for dx. The 1×1×1 head is a matrix
product on both (the JAX package computes it outside any kernel too).

``dtype=torch.bfloat16`` mirrors the flax module's ``dtype``: the convs,
the BatchNorms and the head compute in bf16 (a conv's products and sums
in f32 from bf16 operands, rounded once: on the kernel backend K10's bf16
form), while the parameters and the running statistics stay f32 and the
sigmoid is taken in f32. A bf16 BatchNorm reduces and normalises in f32,
as flax's does (its statistics as E[x²] − E[x]², clipped at 0), and
rounds the result to bf16.

:class:`FlaxBatchNorm` follows ``flax.linen.BatchNorm``'s defaults, not
``nn.BatchNorm3d``'s: the running statistics move by 0.01 a step
(momentum 0.99) and store the **biased** batch variance. The batch
variance comes from the library's two-pass kernel where flax computes
E[x²] − E[x]²: they agree to f32 rounding of the sums (about 1e-6
relative).

A checkpoint holds the flax layout (:meth:`UNet3D.flax_state`):
``params/<block>/Conv_i/kernel`` (k_z, k_x, k_y, in, out),
``params/<block>/BatchNorm_i/{scale,bias}``,
``batch_stats/<block>/BatchNorm_i/{mean,var}``, ``params/out/{kernel,bias}``.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from scenenet_tpu_torch.ops.cuda_conv_mc import conv3d_mc_same_plain, fused_conv3d_mc

_BACKENDS = ("torch", "cuda")
_DTYPES = (torch.float32, torch.bfloat16)
BLOCKS = ("down0", "down1", "down2", "down3", "down4", "up0", "up1", "up2", "up3")


def lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """flax's default kernel init, in place: a normal of variance 1/fan_in
    truncated at two standard deviations (and rescaled for the cut)."""
    fan_in = w[0].numel()
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(w, mean=0.0, std=std, a=-2 * std, b=2 * std,
                                 generator=generator)


def conv3d_kernel_to_flax(w: torch.Tensor) -> torch.Tensor:
    """(out, in, k_z, k_x, k_y) → flax's (k_z, k_x, k_y, in, out)."""
    return w.permute(2, 3, 4, 1, 0)


def load_flax_views(own: Mapping[str, torch.Tensor], state: Mapping[str, torch.Tensor],
                    what: str) -> None:
    """Copy ``state`` into ``own``, a module's ``flax_state()``: its entries
    are views of the module's own tensors in the flax layout, so the copy
    lands in the module. Names and shapes must match."""
    missing, extra = sorted(set(own) - set(state)), sorted(set(state) - set(own))
    if missing or extra:
        raise KeyError(f"{what} state: missing {missing}, unexpected {extra}")
    with torch.no_grad():
        for key, dst in own.items():
            src = torch.as_tensor(state[key], dtype=dst.dtype)
            if src.shape != dst.shape:
                raise ValueError(f"{key}: shape {tuple(src.shape)} != {tuple(dst.shape)}")
            dst.copy_(src)


class FlaxBatchNorm(nn.Module):
    """Batch normalisation over every axis but the channel (axis 1), with
    flax's defaults: epsilon 1e-5, momentum 0.99, biased running variance.
    A bf16 input takes flax's reduced-precision path, and so does a train
    step under a sync axis (:meth:`_forward_flax`).

    ``axis_name`` (set by :meth:`UNet3D.with_bn_sync`) is a mesh axis over
    which a train step averages the batch mean and mean of squares (sync
    BatchNorm, flax's ``axis_name``): normalisation and the running
    statistics then use the global batch, and are the same on every rank."""

    MOMENTUM = 0.99
    EPS = 1e-5

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.axis_name: Optional[str] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype != torch.float32 or (self.training and self.axis_name is not None):
            return self._forward_flax(x)
        if not self.training:
            return F.batch_norm(x, self.mean, self.var, self.scale, self.bias,
                                training=False, eps=self.EPS)
        # with momentum 1 the two scratch buffers come back as the batch's
        # mean and its unbiased variance
        batch_mean, unbiased = torch.zeros_like(self.mean), torch.zeros_like(self.var)
        out = F.batch_norm(x, batch_mean, unbiased, self.scale, self.bias, training=True,
                           momentum=1.0, eps=self.EPS)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            self.mean.mul_(self.MOMENTUM).add_(batch_mean, alpha=1 - self.MOMENTUM)
            self.var.mul_(self.MOMENTUM).add_(unbiased * ((n - 1) / n), alpha=1 - self.MOMENTUM)
        return out

    def _forward_flax(self, x: torch.Tensor) -> torch.Tensor:
        """flax's BatchNorm step by step: the batch mean and E[x²] of x
        widened to f32 (averaged over the ranks of ``axis_name`` where it is
        set, equal shards), the variance E[x²] − E[x]² clipped at 0;
        ``(x − mean)·(rsqrt(var + ε)·scale) + bias`` in f32; the result
        rounded to x's dtype. The running statistics move in f32."""
        xf = x.float()
        shape = (1, -1) + (1,) * (x.ndim - 2)
        if self.training:
            axes = [0] + list(range(2, x.ndim))
            mean, mean_sq = xf.mean(dim=axes), (xf * xf).mean(dim=axes)
            if self.axis_name is not None:
                from scenenet_tpu_torch.parallel.mesh import pmean

                mean, mean_sq = pmean(torch.stack([mean, mean_sq]), self.axis_name).unbind(0)
            var = torch.clamp(mean_sq - mean * mean, min=0.0)
            with torch.no_grad():
                self.mean.mul_(self.MOMENTUM).add_(mean, alpha=1 - self.MOMENTUM)
                self.var.mul_(self.MOMENTUM).add_(var, alpha=1 - self.MOMENTUM)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.EPS) * self.scale.float()
        y = (xf - mean.view(shape)) * mul.view(shape) + self.bias.float().view(shape)
        return y.to(x.dtype)


class _ConvBlock(nn.Module):
    """conv → BN → relu, twice; the convs are 3³, SAME, without bias."""

    def __init__(self, in_features: int, features: int, mid_features: Optional[int],
                 backend: str, dtype: torch.dtype = torch.float32):
        super().__init__()
        mid = mid_features or features
        self.backend = backend
        self.dtype = dtype
        self.conv0 = nn.Parameter(torch.zeros((mid, in_features, 3, 3, 3)))
        self.bn0 = FlaxBatchNorm(mid)
        self.conv1 = nn.Parameter(torch.zeros((features, mid, 3, 3, 3)))
        self.bn1 = FlaxBatchNorm(features)
        # channel tensor parallelism (parallel/gspmd.py): the gather over the
        # model axis after each conv's BN + relu, where the convs hold a slice
        # of their output channels
        self.gathers = None

    def _conv(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        w = w.to(self.dtype)
        if self.backend == "cuda":
            return fused_conv3d_mc(x, w)
        return conv3d_mc_same_plain(x, w)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self._out(0, torch.relu(self.bn0(self._conv(x, self.conv0))))
        return self._out(1, torch.relu(self.bn1(self._conv(x, self.conv1))))

    def _out(self, i: int, x: torch.Tensor) -> torch.Tensor:
        return x if self.gathers is None else self.gathers[i](x)


def _upsample_nearest(x: torch.Tensor) -> torch.Tensor:
    """Every voxel repeated twice along each spatial axis."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def _pad_to(x: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Zero-pad x's spatial axes to target's: ``diff // 2`` low, the rest high."""
    pads = []
    for axis in (4, 3, 2):  # F.pad takes the last axis first
        diff = target.shape[axis] - x.shape[axis]
        pads += [diff // 2, diff - diff // 2]
    return F.pad(x, pads) if any(pads) else x


class UNet3D(nn.Module):
    """Build with :meth:`create` to draw the weights from a seed."""

    is_stateful = True  # BatchNorm running statistics ride along in checkpoints

    def __init__(self, n_classes: int = 1, backend: str = "torch",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if backend not in _BACKENDS:
            raise ValueError(f"backend must be one of {_BACKENDS}, got {backend!r}")
        if dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {_DTYPES}, got {dtype}")
        self.n_classes = n_classes
        self.backend = backend
        self.dtype = dtype
        self.down0 = _ConvBlock(1, 32, None, backend, dtype)
        self.down1 = _ConvBlock(32, 64, None, backend, dtype)
        self.down2 = _ConvBlock(64, 128, None, backend, dtype)
        self.down3 = _ConvBlock(128, 256, None, backend, dtype)
        self.down4 = _ConvBlock(256, 256, None, backend, dtype)  # 512/2 bottleneck
        self.up0 = _ConvBlock(512, 128, 256, backend, dtype)
        self.up1 = _ConvBlock(256, 64, 128, backend, dtype)
        self.up2 = _ConvBlock(128, 32, 64, backend, dtype)
        self.up3 = _ConvBlock(64, 32, 32, backend, dtype)
        self.out = nn.Conv3d(32, n_classes, 1)

    @classmethod
    def create(cls, n_classes: int = 1, seed: int = 0, backend: str = "torch",
               dtype: torch.dtype = torch.float32) -> "UNet3D":
        """A model with flax's initial values: lecun-normal conv kernels drawn
        from an explicit generator seeded with ``seed``, zero biases, BN
        scale 1 and bias 0, running mean 0 and variance 1. The initial
        values do not depend on ``dtype``, as in flax."""
        model = cls(n_classes=n_classes, backend=backend, dtype=dtype)
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for name in BLOCKS:
                block = getattr(model, name)
                lecun_normal_(block.conv0, gen)
                lecun_normal_(block.conv1, gen)
            lecun_normal_(model.out.weight, gen)
            model.out.bias.zero_()
        return model

    def forward(self, x, stage: str = "all"):
        """x (B, 1, Z, X, Y) → sigmoid probabilities (B, n_classes, Z, X, Y),
        f32. ``train()`` normalises by the batch and moves the running
        statistics; ``eval()`` uses them.

        ``stage`` picks a part of the graph, for the pipeline
        (:func:`~scenenet_tpu_torch.parallel.pp.make_unet_pipeline_inference_fn`):
        ``"encode"`` runs the down path and returns the skip tuple (x1..x5);
        ``"decode"`` takes that tuple and runs the up path and the head;
        ``"all"`` is the whole forward. The parameters are the same in
        every part."""
        if stage not in ("all", "encode", "decode"):
            raise ValueError(f"stage must be 'all', 'encode' or 'decode', got {stage!r}")
        if stage == "decode":
            x1, x2, x3, x4, u = x
        else:
            pool = F.max_pool3d
            x1 = self.down0(x.to(self.dtype))
            x2 = self.down1(pool(x1, 2))
            x3 = self.down2(pool(x2, 2))
            x4 = self.down3(pool(x3, 2))
            u = self.down4(pool(x4, 2))
            if stage == "encode":
                return x1, x2, x3, x4, u
        for block, skip in ((self.up0, x4), (self.up1, x3), (self.up2, x2), (self.up3, x1)):
            u = block(torch.cat([skip, _pad_to(_upsample_nearest(u), skip)], dim=1))
        return torch.sigmoid(self._head(u).float())

    def _head(self, u: torch.Tensor) -> torch.Tensor:
        """The 1×1×1 output conv as one matrix product over the channels,
        in f32 from the operands in the model's dtype, the product rounded
        to that dtype before the bias is added (as flax's bf16 conv and its
        bias add). As a cuDNN conv its weight gradient alone took a fifth of
        a train step at 64³ (``PERF.md``)."""
        dt = self.dtype
        w = self.out.weight.flatten(1).to(dt).float()  # (n_classes, 32)
        out = torch.matmul(w, u.flatten(2).float()).view(u.shape[0], -1, *u.shape[2:])
        return out.to(dt) + self.out.bias.to(dt).view(1, -1, 1, 1, 1)

    def with_bn_sync(self, axis_name: Optional[str]) -> "UNet3D":
        """Set the mesh axis over which every BatchNorm averages its batch
        statistics in a train step (sync BatchNorm; None turns it off), in
        place, and return the model: under data-parallel training the
        normalisation and the running statistics are those of the global
        batch, as in a single-device fit. A JAX ``with_bn_sync`` returns a
        view; a torch module owns its parameters, so a view would share
        them anyway."""
        for m in self.modules():
            if isinstance(m, FlaxBatchNorm):
                m.axis_name = axis_name
        return self

    # ---- the flax layout, for checkpoints and the JAX package's variables ----

    def flax_state(self) -> Dict[str, torch.Tensor]:
        """Every parameter and running statistic under the JAX package's
        names ('.'-joined) and in its layouts."""
        state = {}
        for name in BLOCKS:
            block = getattr(self, name)
            for i, (conv, bn) in enumerate(((block.conv0, block.bn0), (block.conv1, block.bn1))):
                state[f"params.{name}.Conv_{i}.kernel"] = conv3d_kernel_to_flax(conv.detach())
                state[f"params.{name}.BatchNorm_{i}.scale"] = bn.scale.detach()
                state[f"params.{name}.BatchNorm_{i}.bias"] = bn.bias.detach()
                state[f"batch_stats.{name}.BatchNorm_{i}.mean"] = bn.mean
                state[f"batch_stats.{name}.BatchNorm_{i}.var"] = bn.var
        state["params.out.kernel"] = conv3d_kernel_to_flax(self.out.weight.detach())
        state["params.out.bias"] = self.out.bias.detach()
        return state

    def load_flax_state(self, state: Mapping[str, torch.Tensor]) -> None:
        """Take :meth:`flax_state`'s layout (the JAX variables through
        ``params_from_jax``, or a checkpoint of either package)."""
        load_flax_views(self.flax_state(), state, "UNet3D")

    # ---- the GENEO-loss hooks: a black box has none of either ----------------

    def cvx_coefficients(self) -> Dict:
        return {}

    def geneo_params_flat(self) -> Dict:
        return {}
