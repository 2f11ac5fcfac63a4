"""LiDAR-like crops and tiles made from a seed, on the device.

A torch copy of ``chip_smoke.py``'s ``synthetic_crop`` (ground, three
tower-like columns, a wire and clutter, rounded to 1 cm as real scans are,
so that points land on voxel edges), made for many crops at once in a few
large calls. The same seed on the same device gives the same crops.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

TOWER, GROUND, WIRE, CLUTTER = 15, 2, 14, 1  # TS40K class ids
CHUNK = 64  # crops made a call: keeps the temporaries near 1 GB at 131072 points


def sub_seed(seed: int, stream: int) -> int:
    """An independent 63-bit seed for one use (``stream``) of the run's seed."""
    state = np.random.SeedSequence([int(seed) % 2**64, stream]).generate_state(2, np.uint64)
    return int(state[0]) & (2**63 - 1)


def crop_sizes(seed: int, count: int, lo: int, hi: int, distinct: bool = False) -> np.ndarray:
    """``count`` point counts in [lo, hi], uniform; ``distinct`` draws them
    without repeats, so that a count names its crop."""
    rng = np.random.default_rng(sub_seed(seed, 1))
    if distinct:
        return rng.choice(np.arange(lo, hi + 1), count, replace=False).astype(np.int64)
    return rng.integers(lo, hi + 1, count).astype(np.int64)


def _chunk(sizes: torch.Tensor, n_pad: int, gen: torch.Generator
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Crops of ``sizes`` (T,) points padded to ``n_pad``: points (T, n_pad, 3)
    f32 with each crop's minimum at 0, labels (T, n_pad) int32, mask (T,
    n_pad) bool. The layout of ``synthetic_crop``: 50% ground, 20% towers in
    three columns, 10% wire, the rest clutter, in that order."""
    dev = sizes.device
    t = sizes.shape[0]
    n = sizes[:, None]
    j = torch.arange(n_pad, device=dev)[None, :]
    n_ground = (n * 5) // 10
    n_tower = (n * 2) // 10
    n_wire = n // 10
    u = torch.rand((t, n_pad, 3), generator=gen, device=dev)
    g = torch.randn((t, n_pad, 2), generator=gen, device=dev)
    span = 40.0 + 40.0 * torch.rand((t, 1), generator=gen, device=dev)
    centers = (0.2 + 0.6 * torch.rand((t, 3, 2), generator=gen, device=dev)) * span[:, :, None]
    # np.array_split of the tower points into three columns
    base, extra = n_tower // 3, n_tower % 3
    cut1 = base + (extra > 0).long()
    cut2 = cut1 + base + (extra > 1).long()
    k = j - n_ground
    column = (k >= cut1).long() + (k >= cut2).long()
    cx = torch.gather(centers[..., 0], 1, column.clamp(0, 2))
    cy = torch.gather(centers[..., 1], 1, column.clamp(0, 2))
    ground = torch.stack([u[..., 0] * span, u[..., 1] * span, g[..., 0] * 0.15], -1)
    tower = torch.stack([cx + g[..., 0], cy + g[..., 1],
                         u[..., 2] * (35.0 + 5.0 * column.float())], -1)
    wire = torch.stack([u[..., 0] * span, 0.5 * span + 0.1 * u[..., 0] * span,
                        25.0 - 4.0 * torch.sin(math.pi * u[..., 0])], -1)
    clutter = torch.stack([u[..., 0] * span, u[..., 1] * span, u[..., 2] * 12.0], -1)
    is_ground = j < n_ground
    is_tower = (j >= n_ground) & (j < n_ground + n_tower)
    is_wire = (j >= n_ground + n_tower) & (j < n_ground + n_tower + n_wire)
    mask = j < n
    pts = torch.where(is_ground[..., None], ground,
                      torch.where(is_tower[..., None], tower,
                                  torch.where(is_wire[..., None], wire, clutter)))
    pts = torch.round(pts * 100.0) / 100.0
    low = torch.where(mask[..., None], pts, torch.inf).amin(dim=1, keepdim=True)
    pts = torch.where(mask[..., None], pts - low, 0.0)
    labels = torch.where(is_ground, GROUND, torch.where(
        is_tower, TOWER, torch.where(is_wire, WIRE, CLUTTER)))
    labels = torch.where(mask, labels, 0).to(torch.int32)
    return pts.contiguous(), labels.contiguous(), mask


def crops(seed: int, sizes: np.ndarray, n_pad: int, device: torch.device
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Every crop of ``sizes`` on ``device``, made ``CHUNK`` at a time from
    one generator seeded from ``seed``."""
    gen = torch.Generator(device).manual_seed(sub_seed(seed, 2))
    size_t = torch.as_tensor(sizes, dtype=torch.int64, device=device)
    parts = [_chunk(size_t[i:i + CHUNK], n_pad, gen) for i in range(0, len(sizes), CHUNK)]
    return tuple(torch.cat(p) for p in zip(*parts))
