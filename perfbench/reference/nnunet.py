"""nnU-Net's ``3d_fullres`` network (``PlainConvUNet``) in plain PyTorch,
written from the published description (Isensee et al., Nat. Methods 18:203,
2021; nnunetv2's plans and ``dynamic_network_architectures``): its forward,
the deep-supervision targets and weighted loss, the gradients by autograd,
Adam, and the training grids at the grid sizes the program bins by the
divide recipe.

- Stages of ``features`` channels; two 3³ convs a stage, each with a bias
  and followed by ``F.instance_norm`` (affine, ε 1e-5, each sample's own
  statistics) and ``F.leaky_relu(0.01)``; the first conv of every stage
  but the first at stride 2, pad 1.
- Decoder levels from the deepest up: ``F.conv_transpose3d`` (kernel 2,
  stride 2, bias), ``cat((up, skip), 1)``, two convs as above, and a 1×1×1
  head with a bias.
- Deep supervision: the outputs highest resolution first; output k against
  ``F.interpolate(y, size, mode="nearest-exact")``; the terms weighted
  1, ½, ¼, … with the last 0, over their sum (at 128³: 1, ½, ¼, ⅛, 0 over
  1.875, the configuration's ``deep_supervision``), a weight-0 term not
  computed (its head gets no gradient).

Departures from nnU-Net, each also under the configuration's ``assumed``:
the heads end in a sigmoid (nnU-Net's give logits); the criterion is
``geneo_tversky`` (``reference/scenenet.py``) in place of
``DC_and_BCE_loss``; Adam in place of SGD with Nesterov momentum and the
poly schedule; f32 with TF32 off in place of fp16 autocast; the input is
binary occupancy from LiDAR crops. The training grids follow the divide
recipe (``voxel.ids_divide``, ``voxel.counts``, the column-min occupancy),
the program's at 128³ and 65,536 padded points, where ``voxel.training_grids``
follows the multiply recipe of smaller grids.

``precision="tf32"`` rounds every conv's, transposed conv's and head's
operands to TF32 and lets cuDNN and the products compute in TF32: the
control. Nothing here imports the program.
"""

from __future__ import annotations

import contextlib
from collections import OrderedDict
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference import full_f32, tf32_st
from perfbench.reference.scenenet import Adam, confusion, geneo_tversky
from perfbench.reference.voxel import counts, ids_divide


def _stage_convs(config: dict) -> List[List[Tuple[int, int, int]]]:
    """(C_in, C_out, stride) of each stage's convs, encoder stages first,
    then the decoder levels from the deepest up."""
    f, n = config["features"], config["convs_per_stage"]
    chans = [config["in_channels"]] + list(f)
    enc = [[(chans[s] if i == 0 else f[s], f[s], config["strides"][s] if i == 0 else 1)
            for i in range(n)] for s in range(len(f))]
    deep = list(reversed(f))
    dec = [[(2 * deep[k + 1] if i == 0 else deep[k + 1], deep[k + 1], 1) for i in range(n)]
           for k in range(len(deep) - 1)]
    return enc + dec


def param_shapes(config: dict) -> "OrderedDict[str, Tuple[int, ...]]":
    """Every trained tensor, by the program's parameter names (decoder
    level 0 the deepest)."""
    shapes = OrderedDict()
    f = config["features"]
    stages = _stage_convs(config)
    deep = list(reversed(f))
    for s in range(len(f)):
        for i, (cin, cout, _) in enumerate(stages[s]):
            _conv(shapes, f"encoder.{s}.{i}", cin, cout)
    for k in range(len(f) - 1):
        shapes[f"up.{k}.weight"] = (deep[k], deep[k + 1], 2, 2, 2)
        shapes[f"up.{k}.bias"] = (deep[k + 1],)
        for i, (cin, cout, _) in enumerate(stages[len(f) + k]):
            _conv(shapes, f"decoder.{k}.{i}", cin, cout)
        shapes[f"heads.{k}.weight"] = (config["n_classes"], deep[k + 1], 1, 1, 1)
        shapes[f"heads.{k}.bias"] = (config["n_classes"],)
    return shapes


def _conv(shapes: dict, name: str, cin: int, cout: int) -> None:
    shapes[f"{name}.weight"] = (cout, cin, 3, 3, 3)
    shapes[f"{name}.bias"] = (cout,)
    shapes[f"{name}.norm_weight"] = (cout,)
    shapes[f"{name}.norm_bias"] = (cout,)


def conv_layers(config: dict, grid: int) -> List[Tuple[int, int, int, int]]:
    """(C_in, C_out, output edge, stride) of every 3³ conv in forward order:
    the network's arithmetic, for the work counts."""
    out, edge = [], grid
    n_enc = len(config["features"])
    for s, convs in enumerate(_stage_convs(config)):
        if s < n_enc:
            edge = edge // config["strides"][s]
        else:
            edge = edge * 2
        out += [(cin, cout, edge, stride) for cin, cout, stride in convs]
    return out


def transposed_layers(config: dict, grid: int) -> List[Tuple[int, int, int]]:
    """(C_in, C_out, input edge) of every transposed conv, deepest first."""
    deep = list(reversed(config["features"]))
    edge = grid >> (len(deep) - 1)
    return [(deep[k], deep[k + 1], edge << k) for k in range(len(deep) - 1)]


def ds_weights(n: int) -> List[float]:
    """The loss weights of ``n`` outputs (``nnUNetTrainer._build_loss``):
    1/2^k, the last set to 0, over their sum."""
    w = [1.0 / 2 ** k for k in range(n)]
    if n > 1:
        w[-1] = 0.0
    return [v / sum(w) for v in w]


def head_layers(config: dict, grid: int) -> List[Tuple[int, int, float]]:
    """(C_in, edge, loss weight) of every head, highest resolution first."""
    f = config["features"]
    w = ds_weights(len(f) - 1)
    return [(f[k], grid >> k, w[k]) for k in range(len(f) - 1)]


def training_grids(points: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
                   keep_labels, grid: Tuple[int, int, int]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x, y) (B, 1, Z, X, Y) f32 {0, 1} by the divide recipe: occupancy (a
    voxel's count above the least count of its y column) and tower presence
    (some valid point with a label of ``keep_labels`` in the voxel)."""
    n_x, n_y, n_z = grid
    size = n_x * n_y * n_z
    b = points.shape[0]
    tower = torch.zeros_like(mask)
    for k in keep_labels:
        tower |= labels == k
    flat = ids_divide(points, mask, grid)
    cols = counts(flat, mask, size).reshape(b, -1, n_y)
    x = (cols > cols.amin(dim=1, keepdim=True)).to(torch.float32)
    y = (counts(flat, mask & tower, size) > 0).to(torch.float32)
    return x.reshape(b, 1, n_z, n_x, n_y), y.reshape(b, 1, n_z, n_x, n_y)


class NNUNet:
    def __init__(self, config: dict, params: Dict[str, torch.Tensor], precision: str = "f32"):
        self.config, self.params = config, params
        self.round = tf32_st if precision == "tf32" else (lambda v: v)
        self.eps = float(config["norm"]["eps"])
        self.slope = float(config["nonlin"]["negative_slope"])

    def _block(self, x: torch.Tensor, name: str, convs) -> torch.Tensor:
        p, r = self.params, self.round
        for i, (_, _, stride) in enumerate(convs):
            x = F.conv3d(r(x), r(p[f"{name}.{i}.weight"]), p[f"{name}.{i}.bias"],
                         stride=stride, padding=1)
            x = F.instance_norm(x, weight=p[f"{name}.{i}.norm_weight"],
                                bias=p[f"{name}.{i}.norm_bias"], eps=self.eps)
            x = F.leaky_relu(x, self.slope)
        return x

    def _head(self, u: torch.Tensor, k: int) -> torch.Tensor:
        w = self.round(self.params[f"heads.{k}.weight"].flatten(1))
        out = torch.matmul(w, self.round(u).flatten(2)).view(u.shape[0], -1, *u.shape[2:])
        return torch.sigmoid(out + self.params[f"heads.{k}.bias"].view(1, -1, 1, 1, 1))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Train-mode forward with deep supervision: (B, 1, Z, X, Y) → every
        level's sigmoid probabilities, highest resolution first."""
        stages = _stage_convs(self.config)
        n = len(self.config["features"])
        skips = []
        for s in range(n):
            x = self._block(x, f"encoder.{s}", stages[s])
            skips.append(x)
        u, outs = skips.pop(), []
        for k in range(n - 1):
            up = F.conv_transpose3d(self.round(u), self.round(self.params[f"up.{k}.weight"]),
                                    self.params[f"up.{k}.bias"], stride=2)
            u = self._block(torch.cat([up, skips.pop()], dim=1), f"decoder.{k}", stages[n + k])
            outs.append(self._head(u, k))
        return outs[::-1]


def ds_targets(y: torch.Tensor, outputs: List[torch.Tensor]) -> List[torch.Tensor]:
    """The target of each output: ``y`` resized to its size, nearest-exact."""
    return [y if o.shape[2:] == y.shape[2:] else
            F.interpolate(y, size=tuple(o.shape[2:]), mode="nearest-exact") for o in outputs]


def ds_loss(outputs: List[torch.Tensor], y: torch.Tensor, config: dict) -> torch.Tensor:
    """The criterion over the outputs by :func:`ds_weights`; a weight-0 term
    is left out."""
    loss = None
    for w, o, t in zip(ds_weights(len(outputs)), outputs, ds_targets(y, outputs)):
        if w == 0:
            continue
        term = w * geneo_tversky(o, t, config)
        loss = term if loss is None else loss + term
    return loss


def train(config: dict, params: Dict[str, torch.Tensor], batches, device,
          precision: str = "f32") -> dict:
    """Adam steps from ``params`` on ``batches`` of (x, y) grids: each step's
    loss, the first step's gradients (of the leaves that have one: the
    weight-0 head has none), the parameters after the last step, and the
    summed confusion counts of the full-resolution output."""
    params = {n: v.detach().clone().to(device).requires_grad_(True) for n, v in params.items()}
    net = NNUNet(config, params, precision)
    names = list(params)
    opt, losses, first = None, [], None
    found = torch.zeros(4, dtype=torch.int64, device=device)
    mode = full_f32() if precision == "f32" else contextlib.nullcontext()
    before = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    if precision == "tf32":
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with mode:
            for x, y in batches:
                outputs = net.forward(x)
                loss = ds_loss(outputs, y, config)
                grads = torch.autograd.grad(loss, [params[n] for n in names], allow_unused=True)
                grads = {n: g for n, g in zip(names, grads) if g is not None}
                if first is None:
                    first = {n: g.detach().clone() for n, g in grads.items()}
                    opt = Adam(params, list(grads), config)
                found += confusion(outputs[0].detach(), y, config["tau"])
                losses.append(float(loss.detach()))
                del outputs, loss
                opt.step(grads)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before
    return {"losses": losses, "grads": first,
            "params": {n: v.detach().clone() for n, v in params.items()}, "counts": found}
