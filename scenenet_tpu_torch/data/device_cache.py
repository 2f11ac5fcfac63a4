"""Device-resident dataset caches: serve training batches from device memory.

PyTorch twin of :mod:`scenenet_tpu.data.device_cache`. For a dataset that
fits the card (TS40K: ~2k crops × 65536 padded points ≈ 2.2 GB, or ≈ 1.0 GB
of uint8 training grids at 64³), the load is paid once and every epoch is
device work:

- batches are row gathers (``index_select``) out of the resident tensors;
- :class:`DevicePointCache` keeps the raw padded points, so voxelization
  runs inside the train step and point-space augmentation (a z-rotation
  about each sample's xy centroid and random xy flips, label-preserving
  for z-aligned towers) gives fresh geometry every epoch;
- :class:`DeviceGridCache` keeps the voxelized training grids, so
  voxelization is paid once and a per-sample D4 symmetry of the xy plane
  (:func:`d4_transform_grids`) is the augmentation.

Randomness comes from an explicit ``torch.Generator`` on the cache's
device; JAX's PRNG bits are not reproduced. ``permute_rows`` is a plain
row gather: the uint8→int32 bitcast of the JAX package exists only for the
TPU's slow narrow gathers.

``Trainer.fit_cached`` and ``fit_grid_cached`` read the caches' tensors
straight from their step; a point-cache batch is assembled by
:func:`gather_augment` on both that path and :meth:`DevicePointCache.epoch`.
``epoch`` and :class:`CacheLoader` are the JAX package's API for feeding
``Trainer.fit`` from the cache; the tests hold a fit fed so against the
cached fit.
"""

from __future__ import annotations

import math
from typing import Iterator, Optional, Tuple

import torch


def rotate_z_batch(points: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate each sample's xyz about its own xy-centroid by its angle.

    points (B, N, 3), angles (B,) → (B, N, 3). Padded rows rotate too; they
    are masked out of the bounds and the binning."""
    c, s = torch.cos(angles), torch.sin(angles)
    center = points[..., :2].mean(dim=1, keepdim=True)
    xy = points[..., :2] - center
    x = xy[..., 0] * c[:, None] - xy[..., 1] * s[:, None]
    y = xy[..., 0] * s[:, None] + xy[..., 1] * c[:, None]
    return torch.cat([torch.stack([x, y], dim=-1) + center, points[..., 2:]], dim=-1)


def augment_points(points: torch.Tensor, angles: torch.Tensor,
                   flips: torch.Tensor) -> torch.Tensor:
    """The point-space augmentation of one batch from its draws: rotate by
    ``angles`` (B,) (:func:`rotate_z_batch`), then mirror x and y about the
    rotated centroid where ``flips`` (B, 2) bool is set."""
    pts = rotate_z_batch(points, angles)
    center = pts[..., :2].mean(dim=1, keepdim=True)
    sign = torch.where(flips, -1.0, 1.0)[:, None, :]
    return torch.cat([(pts[..., :2] - center) * sign + center, pts[..., 2:]], dim=-1)


def draw_point_augmentation(n: int, batch_size: int, generator: torch.Generator,
                            device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``n`` batches' draws for :func:`augment_points`: angles (n, B)
    uniform in [0, 2π) and flips (n, B, 2) bool."""
    angles = torch.rand((n, batch_size), generator=generator, device=device) * (2 * math.pi)
    flips = torch.randint(0, 2, (n, batch_size, 2), generator=generator,
                          device=device).bool()
    return angles, flips


def draw_d4(n: int, batch_size: int, generator: torch.Generator, device) -> torch.Tensor:
    """``n`` batches' D4 elements: (n, 3, B) bool (transpose, flip x, flip y)."""
    return torch.randint(0, 2, (n, 3, batch_size), generator=generator,
                         device=device).bool()


def gather_augment(points: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
                   rows: torch.Tensor, angles: Optional[torch.Tensor] = None,
                   flips: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One batch from the resident tensors: the samples ``rows`` (B,), with
    the z-rotation and xy flips :func:`augment_points` takes when
    ``angles`` (B,) and ``flips`` (B, 2) are given. The one assembly of a
    point-cache batch, for :meth:`DevicePointCache.epoch` and for the cached
    fit's step."""
    pts, lab, m = (a.index_select(0, rows) for a in (points, labels, mask))
    if angles is not None:
        pts = augment_points(pts, angles, flips)
    return pts, lab, m


def build_cache_batch(points: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
                      start: int, batch_size: int, augment: bool,
                      generator: Optional[torch.Generator] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One batch from the resident tensors: rows ``start`` ... ``start +
    batch_size``, with the z-rotation and xy flips drawn from ``generator``
    when ``augment``."""
    rows = torch.arange(start, min(start + batch_size, points.shape[0]), device=points.device)
    draws = (None, None)
    if augment:
        angles, flips = draw_point_augmentation(1, rows.shape[0], generator, points.device)
        draws = (angles[0], flips[0])
    return gather_augment(points, labels, mask, rows, *draws)


def permute_rows(a: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Rows of ``a`` in ``order``: a permutation or a subset (a chunk)."""
    return a.index_select(0, order)


def d4_transform_grids(grid: torch.Tensor, transpose: torch.Tensor,
                       flip_x: torch.Tensor, flip_y: torch.Tensor) -> torch.Tensor:
    """Apply a per-sample D4 (square-symmetry) element to the (X, Y) axes.

    grid (B, C, Z, X, Y) with X == Y; transpose / flip_x / flip_y (B,) bool.
    The 8 combinations are every axis-aligned rotation and mirror of the xy
    plane, all label-preserving for z-aligned towers."""
    if grid.shape[-1] != grid.shape[-2]:
        raise ValueError(f"D4 needs a square xy plane, got {tuple(grid.shape)}")
    t = transpose[:, None, None, None, None]
    fx = flip_x[:, None, None, None, None]
    fy = flip_y[:, None, None, None, None]
    g = torch.where(t, grid.transpose(-1, -2), grid)
    g = torch.where(fx, g.flip(-2), g)
    return torch.where(fy, g.flip(-1), g)


class DevicePointCache:
    """The whole dataset's (points, labels, mask) resident on one device.

    Feed with any dataset yielding ``(points, labels, mask[, flat_idx])``
    fixed-size samples (``TS40K`` + ``PointPadding``): points (n, N, 3)
    f32, labels (n, N) int32, mask (n, N) bool. ``device`` defaults to the
    card."""

    def __init__(self, dataset, device: "torch.device | str | None" = None,
                 load_batch: int = 64):
        import numpy as np

        device = torch.device("cuda" if device is None else device)
        parts = ([], [], [])
        buf = ([], [], [])

        def flush():
            if not buf[0]:
                return
            for part, rows, dtype in zip(parts, buf, (np.float32, np.int32, bool)):
                part.append(torch.from_numpy(np.stack(rows).astype(dtype)).to(device))
                rows.clear()

        for i in range(len(dataset)):
            sample = dataset[i]
            for rows, v in zip(buf, sample[:3]):
                rows.append(np.asarray(v))
            if len(buf[0]) >= load_batch:
                flush()
        flush()
        self.points, self.labels, self.mask = (torch.cat(p) for p in parts)

    def __len__(self) -> int:
        return int(self.points.shape[0])

    @property
    def device(self) -> torch.device:
        return self.points.device

    def epoch(self, batch_size: int, generator: Optional[torch.Generator] = None,
              shuffle: bool = True, augment: bool = False, drop_last: bool = True
              ) -> Iterator[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
        """Yield (points, labels, mask) batches for one epoch, gathered and
        augmented on the device. ``generator`` drives the shuffle and the
        augmentation and is required when either is on. The ragged tail
        (``drop_last=False``) is augmented too."""
        n = len(self)
        if (shuffle or augment) and generator is None:
            raise ValueError("epoch(shuffle/augment) needs a torch.Generator")
        if shuffle:
            # one bulk gather an epoch, then contiguous slices
            order = torch.randperm(n, generator=generator, device=self.device)
            src = tuple(permute_rows(a, order) for a in (self.points, self.labels, self.mask))
        else:
            src = (self.points, self.labels, self.mask)
        n_batches = n // batch_size if drop_last else -(-n // batch_size)
        for b in range(n_batches):
            yield build_cache_batch(*src, b * batch_size, batch_size, augment, generator)


class DeviceGridCache:
    """The (x, y) training grids of the whole dataset resident on the device,
    voxelized once from a :class:`DevicePointCache` by ``batch_prep``
    (``load_batch`` samples at a time).

    Grids of the binarized pipeline are stored as uint8 {0, 1}, 8× less
    memory than two f32 grids (2k crops × 2 × 64³ ≈ 1.0 GB), and cast to f32
    per batch inside the step. The narrowing must be lossless: a
    non-binarized ``batch_prep`` (density or fraction grids) raises, and
    ``store_dtype=torch.float32`` keeps such grids exactly.
    """

    def __init__(self, cache: DevicePointCache, batch_prep, load_batch: int = 64,
                 store_dtype: torch.dtype = torch.uint8):
        n = len(cache)
        narrowing = not store_dtype.is_floating_point
        xs, ys, exact = [], [], []
        with torch.no_grad():
            for start in range(0, n, load_batch):
                end = min(start + load_batch, n)
                x, y = batch_prep(cache.points[start:end], cache.labels[start:end],
                                  cache.mask[start:end])
                xs.append(x.to(store_dtype))
                ys.append(y.to(store_dtype))
                if narrowing:
                    exact.append(torch.equal(xs[-1].to(x.dtype), x)
                                 and torch.equal(ys[-1].to(y.dtype), y))
        if narrowing and not all(exact):
            raise ValueError(
                f"batch_prep produces grids that do not survive {store_dtype} storage "
                f"(non-binarized density/fraction pipeline?); use store_dtype=torch.float32")
        self.x = torch.cat(xs)
        self.y = torch.cat(ys)

    def __len__(self) -> int:
        return int(self.x.shape[0])

    @property
    def device(self) -> torch.device:
        return self.x.device


class CacheLoader:
    """Re-iterable epoch view over a :class:`DevicePointCache`, usable as the
    ``train_loader`` of :meth:`Trainer.fit`: each ``__iter__`` is a fresh
    shuffled (and augmented) epoch of device tensors."""

    def __init__(self, cache: DevicePointCache, batch_size: int,
                 generator: Optional[torch.Generator] = None, shuffle: bool = True,
                 augment: bool = False, drop_last: bool = True):
        self.cache = cache
        self.batch_size = batch_size
        self.generator = (generator if generator is not None
                          else torch.Generator(cache.device).manual_seed(0))
        self.shuffle = shuffle
        self.augment = augment
        self.drop_last = drop_last

    def __len__(self) -> int:
        n = len(self.cache)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self):
        return self.cache.epoch(self.batch_size, generator=self.generator,
                                shuffle=self.shuffle, augment=self.augment,
                                drop_last=self.drop_last)
