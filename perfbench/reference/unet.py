"""The 3D U-Net baseline in plain PyTorch: [conv 3³ → BatchNorm → relu]×2
blocks on the channel ladder of the configuration, 2× max-pool down,
nearest 2× up with pad-and-concat skips, a 1×1×1 head and a sigmoid.

BatchNorm follows flax's defaults, which the port's model follows: the
batch's mean and biased variance, ε 1e-5, running statistics moved by 0.01
a train step. ``precision="tf32"`` rounds every conv's and the head's
operands to TF32 and lets cuDNN and the matrix products compute in TF32:
the control.
"""

from __future__ import annotations

import contextlib
from collections import OrderedDict
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference import full_f32, tf32_st
from perfbench.reference.scenenet import Adam, confusion, geneo_tversky

BLOCKS = ("down0", "down1", "down2", "down3", "down4", "up0", "up1", "up2", "up3")


def block_widths(config: dict) -> Dict[str, Tuple[int, int, int]]:
    """(in, mid, out) channels of each block: the ladder down, the
    bottleneck halved, the decoder mirroring it over concatenated skips."""
    c = config["channels"]  # e.g. [32, 64, 128, 256, 256]
    widths = {"down0": (config["in_channels"], c[0], c[0])}
    for i in range(1, len(c)):
        widths[f"down{i}"] = (c[i - 1], c[i], c[i])
    ups = [f"up{i}" for i in range(len(c) - 1)]
    inner = c[-1]
    for i, name in enumerate(ups):
        skip = c[len(c) - 2 - i]
        out = c[len(c) - 3 - i] if len(c) - 3 - i >= 0 else c[0]
        widths[name] = (skip + inner, (skip + inner) // 2, out)
        inner = out
    return widths


def param_shapes(config: dict) -> "OrderedDict[str, Tuple[int, ...]]":
    """Every trained tensor, by the program's parameter names."""
    shapes = OrderedDict()
    for name, (cin, mid, cout) in block_widths(config).items():
        shapes[f"{name}.conv0"] = (mid, cin, 3, 3, 3)
        shapes[f"{name}.bn0.scale"] = (mid,)
        shapes[f"{name}.bn0.bias"] = (mid,)
        shapes[f"{name}.conv1"] = (cout, mid, 3, 3, 3)
        shapes[f"{name}.bn1.scale"] = (cout,)
        shapes[f"{name}.bn1.bias"] = (cout,)
    shapes["out.weight"] = (config["n_classes"], config["channels"][0], 1, 1, 1)
    shapes["out.bias"] = (config["n_classes"],)
    return shapes


def buffer_shapes(config: dict) -> "OrderedDict[str, Tuple[int, ...]]":
    """The running statistics, by the program's buffer names."""
    shapes = OrderedDict()
    for name, (_, mid, cout) in block_widths(config).items():
        for i, c in ((0, mid), (1, cout)):
            shapes[f"{name}.bn{i}.mean"] = (c,)
            shapes[f"{name}.bn{i}.var"] = (c,)
    return shapes


def conv_layers(config: dict, grid: int) -> List[Tuple[int, int, int]]:
    """(C_in, C_out, edge) of every 3³ conv in forward order: the model's
    arithmetic, for the FLOP counts."""
    out, depth = [], len(config["channels"])
    for name, (cin, mid, cout) in block_widths(config).items():
        level = int(name[-1]) if name.startswith("down") else depth - 2 - int(name[-1])
        edge = grid >> level
        out += [(cin, mid, edge), (mid, cout, edge)]
    return out


class UNet:
    def __init__(self, config: dict, params: Dict[str, torch.Tensor],
                 buffers: Dict[str, torch.Tensor], precision: str = "f32"):
        self.config = config
        self.round = tf32_st if precision == "tf32" else (lambda v: v)
        self.params = params
        self.buffers = buffers
        bn = config["batchnorm"]
        self.momentum, self.eps = float(bn["momentum"]), float(bn["eps"])

    def _bn(self, x: torch.Tensor, name: str) -> torch.Tensor:
        dims = (0, 2, 3, 4)
        mean = x.mean(dim=dims)
        var = x.var(dim=dims, unbiased=False)
        with torch.no_grad():
            m, v = self.buffers[f"{name}.mean"], self.buffers[f"{name}.var"]
            m.mul_(self.momentum).add_(mean.detach(), alpha=1 - self.momentum)
            v.mul_(self.momentum).add_(var.detach(), alpha=1 - self.momentum)
        shape = (1, -1, 1, 1, 1)
        xhat = (x - mean.view(shape)) * torch.rsqrt(var.view(shape) + self.eps)
        return xhat * self.params[f"{name}.scale"].view(shape) + \
            self.params[f"{name}.bias"].view(shape)

    def _block(self, x: torch.Tensor, name: str) -> torch.Tensor:
        for i in (0, 1):
            x = F.conv3d(self.round(x), self.round(self.params[f"{name}.conv{i}"]),
                         padding=1)
            x = torch.relu(self._bn(x, f"{name}.bn{i}"))
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Train-mode forward: (B, 1, Z, X, Y) → sigmoid probabilities."""
        depth = len(self.config["channels"])
        skips = [self._block(x, "down0")]
        for i in range(1, depth):
            skips.append(self._block(F.max_pool3d(skips[-1], 2), f"down{i}"))
        u = skips.pop()
        for i in range(depth - 1):
            skip = skips.pop()
            up = F.interpolate(u, scale_factor=2, mode="nearest")
            pads = []
            for axis in (4, 3, 2):
                diff = skip.shape[axis] - up.shape[axis]
                pads += [diff // 2, diff - diff // 2]
            u = self._block(torch.cat([skip, F.pad(up, pads)], dim=1), f"up{i}")
        w = self.round(self.params["out.weight"].flatten(1))
        head = torch.matmul(w, self.round(u).flatten(2)).view(u.shape[0], -1, *u.shape[2:])
        return torch.sigmoid(head + self.params["out.bias"].view(1, -1, 1, 1, 1))


def train(config: dict, params: Dict[str, torch.Tensor], batches, device,
          precision: str = "f32") -> dict:
    """Adam steps of the UNet from ``params`` (fresh running statistics) on
    ``batches`` of (x, y) grids: each step's loss, the first step's
    gradients, the parameters and running statistics after the last step,
    and the summed confusion counts."""
    params = {n: v.detach().clone().to(device).requires_grad_(True) for n, v in params.items()}
    buffers = {n: (torch.ones if n.endswith(".var") else torch.zeros)(s, device=device)
               for n, s in buffer_shapes(config).items()}
    net = UNet(config, params, buffers, precision)
    names = list(params)
    opt = Adam(params, names, config)
    losses, first, counts = [], None, torch.zeros(4, dtype=torch.int64, device=device)
    mode = full_f32() if precision == "f32" else contextlib.nullcontext()
    before = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    if precision == "tf32":
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with mode:
            for x, y in batches:
                pred = net.forward(x)
                loss = geneo_tversky(pred, y, config)
                grads = dict(zip(names, torch.autograd.grad(loss, [params[n] for n in names])))
                if first is None:
                    first = {n: g.detach().clone() for n, g in grads.items()}
                counts += confusion(pred.detach(), y, config["tau"])
                losses.append(float(loss.detach()))
                del pred, loss
                opt.step(grads)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before
    state = {n: v.detach().clone() for n, v in params.items()}
    state.update((n, v.clone()) for n, v in buffers.items())
    return {"losses": losses, "grads": first, "params": state, "counts": counts}
