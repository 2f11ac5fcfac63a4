#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``scenenet_tpu_torch``) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

It builds the hand-written kernels from ``scenenet_tpu_torch/csrc`` with
nvcc, holds each against its plain PyTorch version on the card and times
both, with one PyTorch library call beside those that have one (the
multi-channel conv at every shape its plan treats differently, twice for
bit-equal outputs; the f32 stencil and its kernel gradient through both
of their kernels; at batch 1 the occupancy kernel and the kernel gradient,
the tensor-core stencil at batch 1 and 64, the training grids and the ids
counts (beside the sorted-ids counts) at batch 16, the raw-points counts
and the bin ids at batch 1 and 16 and the sorted-ids counts at 128³ also
inside a CUDA graph, whose replay times the device where a
loop of calls would time the host). Then it
drives the port's main paths through their entry points, at the serving
defaults (64³ grid, 131072 points, SceneNet (9,5,5)) and the width of
experiments/defaults.yaml (batch 16, 64³, 65536 points, geneo_tversky):

- it serves a few requests through the HTTP server at batch 1 and
  compares every reply with the same request through a CPU pipeline: each
  request is one replay of the bucket's CUDA graph, whose kernels are
  counted from a ``torch.profiler`` trace; it holds every bucket's replay
  against the eager ``run_batch`` bit for bit at f32, ``mxu`` and for the
  quantile ensemble, and prints a dispatch's host launch calls, device
  items and idle share and a batch-1 request's time at the client, graph
  against eager;
- it runs the batched pipeline at batch 64 with ``inference="mxu"`` and
  the fused τ-mask (occupancy kernel → tensor-core stencil) against the
  f32 stencil route;
- it serves 16 concurrent requests through a server built as
  ``serve --inference mxu --max-batch 8`` builds it, then through
  ``--max-batch auto``, and one request through ``--model quantile``;
- it checks B10, the halo conv of the spatially sharded path, at a 128³
  volume of batch 4 cut into 4 z-slabs of 32 planes with their halos: K2
  and K4 with the slab's own halo planes against their plain versions
  (both kernels of each), the slabs' outputs against the SAME conv, and
  ``halo_stencil_conv``'s backward against autograd, timed beside the
  SAME form;
- it trains for two epochs through the train CLI with the defaults, which
  pick the grid cache: every step after the warm-up one CUDA graph
  replay; the wrappers' launch counts are checked, and the kernels that
  the replays ran are counted from a ``torch.profiler`` trace; then one epoch through the point cache with augmentation and
  one through the streaming loader; holds a cached fit whose step replays
  from the graph against the same batches through ``train_step``; times
  the train step by route (streaming, point cache, grid cache, 16 steps
  an epoch); then checks three train steps of the kernel backend against
  the plain one;
- it writes LAS tiles with towers, turns them into crops by ``python -m
  scenenet_tpu_torch.cli.build_samples ts40k`` and trains on them through
  ``cli.train`` at the defaults' width by the native loader (K3, K4),
  host voxelization (``device_voxelization=false``: K2, K4) and the UNet
  (K3, K10), each printing its loader route; then a synthetic
  SemanticKITTI sequence through ``build_samples semantic_kitti`` and
  ``cli.train --set dataset=semantic_kitti`` at (64, 64, 256); and it times
  the native loader against the Python one alone (samples/s) and under the
  streamed train step;
- it trains through ``cli.train --host-indices`` at the same width (bins
  from the host in float64, counted by the ids kernel), and at a 128³
  grid (batch 4, 131072 points) with and without ``--host-indices`` (both
  through the sorted-ids kernel), and serves one request at ``--grid 128``;
- it takes three train steps on a tower-fraction target and makes density
  grids (the counts kernel), and asks for the bin ids alone (the ids
  kernel);
- it trains the rest of the training surface through the train CLI, each
  through ``device_cache: auto`` (the grid cache, every step after the
  warm-up a graph replay) and traced: ``model=quantile`` (three members,
  K2 and K4 three times a step), ``precision=bf16`` and
  ``accumulate_grad_batches=2`` (two captured steps); holds each one's
  replayed steps against the same batches through ``train_step``,
  bit-identical; and times the quantile and the bf16 step by cached route;
- it trains UNet3D at its full ladder (32-64-128-256-256, 18 3x3x3 convs)
  through ``cli.train --set model=unet`` at the defaults' width (batch 16,
  64³), every conv and its input gradient in the multi-channel conv
  kernel, checks three steps of that backend against the plain one, times
  the step on both, trains it with ``precision=bf16`` (every conv in the
  conv kernel's bf16 form, held against the plain bf16 version at every
  layer shape and at ragged shapes, timed per layer beside cuDNN bf16 and,
  in CUDA graphs, over the 18 forward convs beside the earlier bf16 form (a
  bench copy built beside the library), the f32 form and cuDNN bf16, over
  the 17 dx convs of a step beside cuDNN bf16's input gradient, and on the
  1->32 layer alone) and times that step beside the f32 one, and trains
  ``model=cnn`` with a (3,3,3) kernel;
- it holds K10 at nnU-Net's 17 stride-1 convs at batch 2 (forward, dx and
  dw against the f32 library calls, ``[K10 nnunet]``), times both library
  routes of its strided and transposed convs, and trains the network through
  ``cli.train --set model=nnunet`` at 128³, batch 2 (K10, the library
  wrappers and K8 counted a step; the best checkpoint restored);
- it trains ``experiments/admm.yaml``'s keys (``constrained=admm
  admm_rho=5.0 optimizer=lbfgs learning_rate=0.8 criterion=focal_tversky``,
  by ``--set``) through the train CLI at the defaults' width on the native
  streaming loader, every step eager (K3 a step, K2 and K4 an evaluation
  of the loss: the step's own and each linesearch trial), and times the
  ADMM + L-BFGS step with its evaluations and host syncs;
- it trains the defaults with ``optimizer=lbfgs`` through the grid cache
  (eager steps: the linesearch reads values on the host) and times that
  step beside the Adam graph replay;
- it sends a real SIGTERM to a ``cli.train`` process of the defaults
  (grid cache, ``epoch_chunks=4``) mid-training, relaunches it, which
  resumes from the snapshot, and holds its ``last.npz`` against an
  unkilled run's bit for bit; preempts and resumes a point-cache fit in
  process (its graph captured on the restored buffers), bit-identical, and
  times the snapshot's write and the resume;
- it runs the tuners through the train CLI: ``auto_lr_find``,
  ``model_backend=autotune`` (``cuda`` against ``cuda_mxu``, both timed)
  and ``auto_scale_batch_size``, and the CLI's batch probe at 128³ until
  the card truly runs out of memory (the rest of the card held, so that it
  does so below the 2³¹ voxels the kernels take); the autotune times graph
  replays on the grid cache, and both candidates are also timed eagerly;
- it runs ``cli.visualize`` over the synthetic test split at 64³ with the
  defaults' fit (K2 once a sample; the PLYs, the tower proposals and each
  stage's milliseconds), ``cli.inspect`` on that checkpoint and on
  reference-layout ``.ckpt`` files (one of the (9, 6, 6) default), the
  ONNX and ``torch.export`` exports run on the card against K2's forward,
  a sweep of two literal draws through ``run_sweep`` on the grid cache,
  a streamed fit that writes the first validation sample's PLYs
  (``log_pointclouds_every``), and, in a process of its own, a native
  library that cannot be built, which leaves ``available()`` False with its
  reason;
- ``[mesh]`` (A12's data and space axes): it launches gloo ranks that share
  the card, every rank on cuda:0 (NCCL refuses two ranks on one GPU), and
  holds each leg's 3 SGD steps against the same fit on one rank: data 2 at
  64³ batch 16 through the grid cache; data 2 × space 2 and the hybrid mesh
  dcn 2 × (data 1 × space 2) at 128³ batch 4, streamed, z slabs through the
  halo exchange and B10 (counts exact, K2's and K4's halo forms launched on
  every rank); the UNet at its full ladder with sync BatchNorm (K10, the
  running statistics); L-BFGS (equal trial counts); 2 steps, a snapshot and
  a fresh launch's last step, bit-identical to an unkilled fit; then a
  1-rank NCCL group's all-reduce on the card, eager and inside a CUDA
  graph capture, and ``cli.train --set mesh_data=2 --dist-backend gloo``
  under ``python -m torch.distributed.run --nproc-per-node 2``. Its step
  times say that the ranks compute on the card; they do not measure
  scaling;
- the model axis (A12b): K10 and its bf16 form at a channel-TP rank's
  shapes (C_out/2, C_out/4 and the dx at C_in/m) against their plain
  versions, timed beside F.conv3d; ``serve --mesh-ensemble 2`` (4 quantile
  members in 2 groups on cuda:0) against the unsharded pipeline through K1
  + K2 and K5, a dispatch still one CUDA graph; and in ``[mesh]``, each
  against its one-rank twin: ep (data 2 × model 2, the quantile ensemble's
  members, 64³ batch 16 through the grid cache, counts exact, K2 and K4 on
  every rank), tp (data 2 × model 2, the UNet's channels at its full
  ladder, 64³ batch 4) and tp_bf16 (data 1 × model 2, bf16: K10's bf16
  form), counts within 0.05% of the voxels; pp (data 2 × stage 2, the
  CNN's convs as two stages, 4 microbatches a rank) and unet_pp (stage 2,
  the UNet's encoder and decoder, eval mode); and ``cli.train --set
  model=quantile criterion=quantile_geneo mesh_ensemble=3`` under
  ``torch.distributed.run --nproc-per-node 3``.

It prints one line per phase, the card's name and power limit, a JSON line
of kernel results (each kernel's ``launches``: what the main paths ran,
the wrappers' counts plus what each main path's own graphs replayed,
read from its ``_Pipeline.kernel_launches`` or its cached fits'
``CachedEpochs.replay_launches`` right after its run and checked against
that run's ``torch.profiler`` trace where one is taken; the timing loops'
replays and the tuners' are left out) and, last,
``{"ok": true, "device": {...}}``. Any failure
raises and exits non-zero; without a CUDA device it exits non-zero at
once. ``--profile`` adds ``torch.profiler`` passes over the batched
serving, the train epoch of each route (idle share, device items and host
launch calls a step) and the train step at both widths (device busy share,
device items per dispatch or step; for the UNet step also the conv
kernel's and the weight gradient's share of the device time).
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from http.server import ThreadingHTTPServer
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
GRID = (64, 64, 64)
MAX_POINTS = 131072       # serving default
TRAIN_POINTS = 65536      # experiments/defaults.yaml max_points
TRAIN_BATCH = 16          # experiments/defaults.yaml batch_size
BIG_GRID = (128, 128, 128)  # the large-grid configuration: batch 4, 131072 points
BIG_BATCH = 4
KITTI_GRID, KITTI_POINTS = (64, 64, 256), 32768  # a non-cubic grid of 2048 rows of 512 bins
HUGE_GRID = (256, 256, 256)  # one channel of counts is 64 MB, more than the L2
DENSE_POINTS = 4 * 1024 * 1024  # a dense cloud for it: a point to every fourth bin
TAU = 0.65
PROB_TOL = 1e-5  # f32 conv: the kernel sums its 225 taps in another order than cuDNN
DK_REL_TOL = 1e-4  # dk: f32 sums of 4.2 M products per tap in another order
# tensor-core stencil vs its plain version: the same exact bf16 x bf16 products,
# summed in f32 in another order
MXU_TOL = 1e-5
# tensor-core stencil (split) vs the f32 stencil: what hi + lo/512 leaves of the
# kernel (2^-17 relative a tap) over up to 225 taps
MXU_F32_TOL = 1e-4
# float-weight bin counts: the same bf16-rounded weights, summed in f32 by atomics in
# another order than index_add_ (relative, and absolute near 0)
WEIGHTED_TOL = 1e-5
# device grids against the float64 host oracle: one f32 division a voxel
ORACLE_TOL = 1e-6
# published peaks of one H100 SXM: device memory, f32 outside the tensor cores,
# dense bf16 and dense TF32 in them
HBM_BPS, F32_FLOPS, BF16_FLOPS = 3.35e12, 67e12, 989e12
TF32_FLOPS = 495e12
TOWER, GROUND, WIRE, CLUTTER = 15, 2, 14, 1  # TS40K class ids

# experiments/defaults.yaml as train-CLI overrides: the card machine may
# lack PyYAML, so the smoke passes the defaults by --set, not --config
DEFAULTS_SET = [
    "project=scenenet_ts40k", "output_dir=experiments/outputs", "seed=0",
    "dataset=ts40k", "data_path=''", "batch_size=16", "voxel_grid_size=(64, 64, 64)",
    "voxel_size=None", "num_workers=8", "val_split=0.1", "test_split=0.3",
    "model=scenenet", "cylinder_geneo=1", "arrow_geneo=1", "neg_sphere_geneo=1",
    "kernel_size=(9, 5, 5)", "model_backend=auto",
    "optimizer=adam", "learning_rate=0.001", "max_epochs=20",
    "early_stop_metric=train_FBetaScore", "early_stop_patience=25",
    "accumulate_grad_batches=1", "tau=0.65",
    "criterion=geneo_tversky", "weight_alpha=1", "weight_epsilon=0.1", "mse_weight=1",
    "convex_weight=5", "tversky_alpha=2", "tversky_beta=1", "tversky_smooth=1.0e-6",
    "focal_gamma=4",
    "mesh_data=1", "mesh_space=1", "mesh_dcn_data=1", "mesh_ensemble=1", "mesh_channel=1",
    "device_voxelization=True", "device_cache=auto", "augment=False", "max_points=65536",
    "precision=f32", "fast_dev_run=False", "auto_lr_find=False",
    "auto_scale_batch_size=False",
]
N_FIT, N_TEST, TRAIN_EPOCHS = 56, 16, 2
# experiments/admm.yaml's keys, by --set; and the epochs of the preempted run: enough
# that a SIGTERM after 10 logged epochs lands mid-training
ADMM_SET = ["constrained=admm", "admm_rho=5.0", "optimizer=lbfgs", "learning_rate=0.8",
            "criterion=focal_tversky"]
PREEMPT_EPOCHS = 200
PROBE_FREE_GB = 12  # the card's memory left to the out-of-memory probe at 128^3
VIZ_SAMPLES = 4  # cli.visualize --n over the synthetic test split
# two draws of experiments/sweep.yaml's parameters, written out: the card machine
# may lack PyYAML, and run_sweep takes the draws themselves
SWEEP_DRAWS = [
    {"learning_rate": 0.005, "optimizer": "adam", "convex_weight": 3.0, "tversky_alpha": 1.5,
     "focal_gamma": 2, "cylinder_geneo": 1, "arrow_geneo": 1, "neg_sphere_geneo": 1},
    {"learning_rate": 0.01, "optimizer": "rmsprop", "convex_weight": 7.5,
     "tversky_alpha": 3.0, "focal_gamma": 4, "cylinder_geneo": 2, "arrow_geneo": 1,
     "neg_sphere_geneo": 1},
]
# the ETL phase: 5 LAS tiles of 8 towers -> 40 radius-15 crops (--test-split 0.1:
# 36 fit, 33 of them train = 2 steps of 16, 3 validation; 4 test). 800 points a
# tower: the reference's DBSCAN (eps 10, 300 points) runs in Python, in time
# about linear in a tower's points times its neighbours
ETL_TILES, ETL_TOWERS, ETL_TOWER_POINTS, ETL_TEST_SPLIT = 5, 8, 800, 0.1
# SemanticKITTI: 10 scans of 8 poles -> 80 pole crops, of which the train split
# (the first 20%) is 16: 4 for validation and 3 steps of 4 an epoch at the
# reference's (64, 64, 256) grid; the test split (the last 60%) is 48
KITTI_SCANS, KITTI_POLES, KITTI_BATCH = 10, 8, 4
# multi-channel conv vs F.conv3d (cuDNN f32, TF32 off): f32 sums of 27*C_in products
# in another order, on outputs of magnitude ~1. 2e-5 + 1e-5 relative up to 160 input
# channels (the JAX package's own test bound and range); past that the absolute
# part grows with the square root of the sum's length (x 1.8 at 512 channels)
MC_ATOL, MC_RTOL, MC_ATOL_CHANNELS = 2e-5, 1e-5, 160
MC_DW_REL_TOL = 1e-4  # the library's dw in two formulations: sums over 4.2 M voxels
# K10's bf16 form vs its plain version: the same exact products summed in f32 in
# another order and rounded once, so neighbouring bf16 values at most: one bf16
# unit of the result, at most 2^-7 of it
BF16_UNIT = 2.0 ** -7
# cuDNN's bf16 dw against the plain version's (f32 sums rounded once), of max|dw|
MC_BF16_DW_REL_TOL = 1e-2
# the shapes the multi-channel conv's plan treats differently, beside the UNet's layers
# at the train batch: (batch, C_in, C_out, (Z, X, Y))
MC_EXTRA = [(1, 256, 256, (4, 4, 4)),   # batch 1 in the four-sample tile, the K split at its cap
            (1, 128, 256, (8, 8, 8)),   # batch 1 at 8^3
            (2, 100, 64, (8, 8, 8)),    # a K split whose C_in is no multiple of the K step
            (3, 40, 30, (6, 10, 7)),    # C_out no multiple of 8, Y no multiple of 4
            (2, 16, 24, (5, 9, 7))]
# K10's bf16 form at ragged shapes: Y odd, below 8 and no multiple of 8 (the halo rows
# by plain loads, not cp.async), C_in no multiple of its 16-channel chunk, batches 1-5,
# and C_in 1-4 on the FMA kernel's bf16 form: (batch, C_in, C_out, (Z, X, Y))
MC_BF16_RAGGED = [(2, 32, 32, (6, 6, 7)), (3, 32, 64, (5, 5, 5)), (1, 24, 32, (9, 9, 12)),
                  (4, 100, 40, (6, 7, 6)), (5, 17, 72, (4, 4, 4)), (2, 64, 32, (8, 8, 2)),
                  (1, 1, 32, (9, 9, 9)), (2, 2, 32, (7, 5, 3)), (3, 3, 40, (6, 6, 8)),
                  (4, 4, 64, (5, 4, 9))]
# K10 at the shapes of channel TP over m = 2, 4, 8: a rank's forward conv at C_out/m ("fwd")
# and the dx of a column-parallel conv, whose input has the rank's C_out/m channels ("dx");
# (what, C_in, C_out, cubic extent at a 64^3 grid); at m = 8 the dx of a 32-wide layer has
# 4 input channels: the FMA kernel
TP_K10_SHAPES = [("fwd", 1, 16, 64), ("fwd", 32, 16, 64), ("fwd", 32, 8, 64),
                 ("fwd", 256, 128, 8), ("dx", 16, 32, 64), ("dx", 8, 32, 64),
                 ("dx", 4, 32, 64), ("dx", 128, 256, 8)]
# UNet3D's 18 3x3x3 convs in forward order: (C_in, C_out, cubic extent at a 64^3 grid)
UNET_CONVS = [(1, 32, 64), (32, 32, 64), (32, 64, 32), (64, 64, 32), (64, 128, 16),
              (128, 128, 16), (128, 256, 8), (256, 256, 8), (256, 256, 4), (256, 256, 4),
              (512, 256, 8), (256, 128, 8), (256, 128, 16), (128, 64, 16), (128, 64, 32),
              (64, 32, 32), (64, 32, 64), (32, 32, 64)]
UNET_TRAIN_LAUNCHES, UNET_EVAL_LAUNCHES = 35, 18  # 18 forward + 17 dx (none at C_in = 1)
# nnU-Net's 3d_fullres network at 128^3 (models/nnunet3d.py) at its batch of 2: the 17
# stride-1 3x3x3 convs that K10 takes, in forward order (C_in, C_out, cubic extent); the
# five stride-2 convs (C_in, C_out, input extent) and five transposed convs (C_in, C_out,
# input extent) that library calls take
NNUNET_BATCH = 2
NNUNET_CONVS = [(1, 32, 128), (32, 32, 128), (64, 64, 64), (128, 128, 32), (256, 256, 16),
                (320, 320, 8), (320, 320, 4), (640, 320, 8), (320, 320, 8), (512, 256, 16),
                (256, 256, 16), (256, 128, 32), (128, 128, 32), (128, 64, 64), (64, 64, 64),
                (64, 32, 128), (32, 32, 128)]
NNUNET_STRIDED = [(32, 64, 128), (64, 128, 64), (128, 256, 32), (256, 320, 16), (320, 320, 8)]
NNUNET_TRANSPOSED = [(320, 320, 4), (320, 256, 8), (256, 128, 16), (128, 64, 32), (64, 32, 64)]
# UNet train steps, kernel backend vs plain: the convs round differently, and Adam
# turns a gradient entry near 0 into a step of +-lr = 1e-3 in either; the running
# statistics are held to 3e-3 absolute plus 3e-3 relative
UNET_LOSS_RTOL, UNET_STATS_TOL = 1e-3, 3e-3
BIG_FIT, BIG_TEST = 18, 4  # the 128³ runs' smaller directory: 4 train steps an epoch
HALO_SLABS, HALO_Z = 4, 32  # B10: a 128³ volume's z in 4 slabs of 32 planes (+8 halo)
ROUTE_SAMPLES = 256  # the train step by route: 16 steps an epoch at batch 16
# the runtime calls by which the host starts work on the card, as the profiler names them
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                     "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemsetAsync",
                     "cudaMemcpyAsync")
# a kernel that each wrapper on the train CLI's path launches once a call, as
# the profiler names it: a CUDA graph's replay runs these without calling a
# wrapper, so what the cached steps ran is read from the trace. K3's expand
# pass is K1's too; K1 is on no train path.
RUN_MARKS = {"points_binary": re.compile(r"\bexpand_kernel\b"),
             "stencil_conv": re.compile(r"\bstencil(_fast)?_kernel\b"),
             "stencil_dk": re.compile(r"\breduce_taps_kernel\b")}
# the same for the serving path, whose buckets replay CUDA graphs: K1 (its
# expand pass), K2, K5, and K8 (its slab count) at the large grid
SERVE_MARKS = {"points_occupancy": re.compile(r"\bexpand_kernel\b"),
               "stencil_conv": re.compile(r"\bstencil(_fast)?_kernel\b"),
               "stencil_mma": re.compile(r"\bstencil_mma_kernel\b"),
               "sorted_bin_counts": re.compile(r"\bslab_count_kernel\b")}


class tee_stdout:
    """What a with-block prints, printed and kept (``text``)."""

    def __enter__(self):
        self.buf, self.out = io.StringIO(), sys.stdout
        sys.stdout = self
        return self

    def write(self, text: str) -> int:
        self.buf.write(text)
        return self.out.write(text)

    def flush(self) -> None:
        self.out.flush()

    def __exit__(self, *exc):
        sys.stdout = self.out

    @property
    def text(self) -> str:
        return self.buf.getvalue()


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def synthetic_crop(rng: np.random.Generator, n: int):
    """A LiDAR-like crop: ground, three tower-like columns, a wire and
    clutter, rounded to 1 cm like real scans (points land on voxel edges).
    Returns (xyz (n, 3) float64, TS40K labels (n,))."""
    span = rng.uniform(40.0, 80.0)
    n_ground, n_tower, n_wire = int(n * 0.5), int(n * 0.2), int(n * 0.1)
    n_rest = n - n_ground - n_tower - n_wire
    ground = np.column_stack([rng.uniform(0, span, (n_ground, 2)),
                              rng.normal(0.0, 0.15, n_ground)])
    towers = []
    for i, share in enumerate(np.array_split(np.arange(n_tower), 3)):
        cx, cy = rng.uniform(0.2 * span, 0.8 * span, 2)
        towers.append(np.column_stack([rng.normal(cx, 1.0, len(share)),
                                       rng.normal(cy, 1.0, len(share)),
                                       rng.uniform(0, 35.0 + 5 * i, len(share))]))
    t = rng.uniform(0, 1, n_wire)
    wire = np.column_stack([t * span, 0.5 * span + 0.1 * t * span,
                            25.0 - 4.0 * np.sin(np.pi * t)])
    clutter = rng.uniform([0, 0, 0], [span, span, 12.0], (n_rest, 3))
    labels = np.repeat([GROUND, TOWER, WIRE, CLUTTER], [n_ground, n_tower, n_wire, n_rest])
    return np.round(np.concatenate([ground, *towers, wire, clutter]), 2), labels


def synthetic_cloud(rng: np.random.Generator, n: int) -> np.ndarray:
    xyz, _ = synthetic_crop(rng, n)
    return (xyz - xyz.min(0)).astype(np.float32)


def padded_batch(rng, b, n_pad=MAX_POINTS, lo=40000, hi=70000):
    """(B, n_pad, 3) f32 centred points, (B, n_pad) mask, (B, n_pad) labels."""
    pts = np.zeros((b, n_pad, 3), np.float32)
    mask = np.zeros((b, n_pad), bool)
    labels = np.zeros((b, n_pad), np.int32)
    for i in range(b):
        n = min(int(rng.integers(lo, hi)), n_pad)
        xyz, lab = synthetic_crop(rng, n)
        pts[i, :n] = (xyz - xyz.min(0)).astype(np.float32)
        labels[i, :n] = lab
        mask[i, :n] = True
    return pts, mask, labels


def full_column_case():
    """Every voxel of y column 0 holds ≥ 2 points: there the occupancy rule
    (count > column min) differs from count > 0."""
    pts = [[ix + 0.5, 0.5, iz + 0.5] for iz in range(8) for ix in range(8) for _ in range(2)]
    pts += [[0.5, 0.5, 0.5], [7.9, 7.9, 7.9]]
    pts = np.asarray(pts, np.float32)[None]
    return pts, np.ones(pts.shape[:2], bool)


def mixed_full_column_case():
    """Full columns in part of a batch: sample 0 fills y columns 0 and 3 (one
    voxel of column 3 holds three more points), sample 1 is
    ``full_column_case``, sample 2 has no full column."""
    col0, _ = full_column_case()
    col3 = [[ix + 0.5, 3.5, iz + 0.5] for iz in range(8) for ix in range(8)]
    clouds = [np.concatenate([col0[0], np.asarray(col3 + [[1.5, 3.5, 1.5]] * 3, np.float32)]),
              col0[0], np.random.default_rng(6).uniform(0, 8, (200, 3)).astype(np.float32)]
    pts = np.zeros((3, max(len(c) for c in clouds), 3), np.float32)
    mask = np.zeros(pts.shape[:2], bool)
    for i, c in enumerate(clouds):
        pts[i, :len(c)], mask[i, :len(c)] = c, True
    return pts, mask


def indexed_batch(pad, rng: np.random.Generator, b: int, lo=40000, hi=65000):
    """b synthetic crops in world coordinates through ``pad``, a
    PointPadding with compute_indices=True, as the loader of the host-exact
    route makes them: stacked [points, labels, mask, flat_idx], and the
    float64 crops (none longer than the pad, so none is subsampled)."""
    crops = []
    for _ in range(b):
        xyz, lab = synthetic_crop(rng, min(int(rng.integers(lo, hi)), pad.max_points))
        crops.append((xyz + rng.uniform(0, 1000, 3).round(2), lab))
    return [np.stack(col) for col in zip(*(pad(c) for c in crops))], crops


def write_dataset(root: Path, seed: int = 7, n_fit: int = N_FIT, n_test: int = N_TEST) -> None:
    """Seeded synthetic TS40K directory: fit/ and test/ of sample_i.npy,
    (N, 4) float64 xyz + label, 40k–70k points each, 1 cm."""
    rng = np.random.default_rng(seed)
    for split, n in (("fit", n_fit), ("test", n_test)):
        (root / split).mkdir(parents=True)
        for i in range(n):
            xyz, lab = synthetic_crop(rng, int(rng.integers(40000, 70000)))
            xyz = xyz + rng.uniform(0, 1000, 3).round(2)  # world coordinates
            np.save(root / split / f"sample_{i}.npy",
                    np.concatenate([xyz, lab[:, None]], axis=1))


def write_las_tiles(las_dir: Path, write_las, seed: int = 11) -> int:
    """Seeded synthetic LAS tiles for the ETL: each a 40 m wide strip of
    ground, clutter and a wire with ETL_TOWERS towers 40 m apart (TS40K
    classes, 1 cm), dense enough that a radius-15 crop around a tower holds
    40k-60k points, as TS40K's crops do. Returns the points written."""
    rng = np.random.default_rng(seed)
    las_dir.mkdir(parents=True)
    length, width, total = 40.0 * ETL_TOWERS, 40.0, 0
    for t in range(ETL_TILES):
        n_ground, n_clutter, n_wire = 700_000, 120_000, 20_000
        ground = np.column_stack([rng.uniform(0, length, n_ground),
                                  rng.uniform(0, width, n_ground),
                                  rng.normal(0.0, 0.15, n_ground)])
        clutter = rng.uniform([0, 0, 0], [length, width, 12.0], (n_clutter, 3))
        s = rng.uniform(0, 1, n_wire)
        wire = np.column_stack([s * length, np.full(n_wire, width / 2 + 2.0),
                                25.0 - 4.0 * np.sin(np.pi * ((s * ETL_TOWERS) % 1.0))])
        towers = [np.column_stack([rng.normal(20.0 + 40.0 * i, 1.0, ETL_TOWER_POINTS),
                                   rng.normal(width / 2, 1.0, ETL_TOWER_POINTS),
                                   rng.uniform(0, 25.0, ETL_TOWER_POINTS)])
                  for i in range(ETL_TOWERS)]
        xyz = np.concatenate([ground, clutter, wire, *towers])
        cls = np.repeat([GROUND, CLUTTER, WIRE, TOWER],
                        [n_ground, n_clutter, n_wire, ETL_TOWERS * ETL_TOWER_POINTS])
        origin = np.array([5.4e5 + 1000.0 * t, 4.6e6, 150.0])  # world coordinates
        write_las(str(las_dir / f"tile_{t:02d}.las"), np.round(xyz + origin, 2),
                  cls.astype(np.uint8))
        total += len(xyz)
    return total


def write_kitti_sequence(root: Path, seed: int = 12) -> None:
    """A seeded synthetic SemanticKITTI sequence: KITTI_SCANS velodyne scans
    of about 120k points (ground, buildings, vegetation; KITTI's labels
    40, 50, 70) with KITTI_POLES poles (label 80) each, as .bin (x, y, z,
    remission f32) and .label (instance id << 16 | label) files."""
    rng = np.random.default_rng(seed)
    vel = root / "sequences" / "00" / "velodyne"
    lab = root / "sequences" / "00" / "labels"
    vel.mkdir(parents=True)
    lab.mkdir(parents=True)
    for i in range(KITTI_SCANS):
        n = 120_000
        r = 40.0 * np.sqrt(rng.uniform(0.02, 1.0, n))  # denser near the sensor
        phi = rng.uniform(0, 2 * np.pi, n)
        xyz = np.column_stack([r * np.cos(phi), r * np.sin(phi), rng.normal(-1.7, 0.05, n)])
        labels = rng.choice([40, 50, 70], n, p=[0.6, 0.25, 0.15]).astype(np.uint32)
        up = labels != 40
        xyz[up, 2] = rng.uniform(-1.7, 6.0, int(up.sum()))
        poles = []
        for j in range(KITTI_POLES):
            a = 2 * np.pi * (j + rng.uniform(0, 0.5)) / KITTI_POLES
            c = 6.0 + 4.0 * j
            poles.append(np.column_stack([rng.normal(c * np.cos(a), 0.1, 400),
                                          rng.normal(c * np.sin(a), 0.1, 400),
                                          rng.uniform(-1.7, 5.0, 400)]))
        xyz = np.concatenate([xyz, *poles]).astype(np.float32)
        labels = np.concatenate([labels, np.full(400 * KITTI_POLES, 80, np.uint32)])
        scan = np.concatenate([xyz, rng.uniform(0, 1, (len(xyz), 1)).astype(np.float32)], 1)
        scan.tofile(vel / f"{i:06d}.bin")
        (labels | (np.uint32(i + 1) << 16)).tofile(lab / f"{i:06d}.label")


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 200) -> float:
    """Device ms per call of ``fn`` captured once in a CUDA graph and
    replayed: what the card spends, without the host's launch time."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, iters)


def paired_ms(kernel_fn, plain_fn, iters: int, rounds: int = 4, library_fn=None,
              warmup: int = 3):
    """Median ms per call of the kernel, of its plain version and, where
    given, of the one library call that computes the same function, timed
    in alternating order (plain, library, kernel, kernel, library, plain,
    ...), with each side's min and max."""
    sides = [("plain", plain_fn), ("library", library_fn), ("kernel", kernel_fn)]
    sides = [(k, fn) for k, fn in sides if fn is not None]
    acc = {k: [] for k, _ in sides}
    for r in range(rounds):
        for k, fn in (sides if r % 2 == 0 else sides[::-1]):
            acc[k].append(cuda_ms(fn, iters, warmup))
    out = {"ms": float(np.median(acc["kernel"])), "plain_ms": float(np.median(acc["plain"])),
           "range": (min(acc["kernel"]), max(acc["kernel"])),
           "plain_range": (min(acc["plain"]), max(acc["plain"])), "library_ms": None}
    if library_fn is not None:
        out["library_ms"] = float(np.median(acc["library"]))
        out["library_range"] = (min(acc["library"]), max(acc["library"]))
    return out


def fmt_times(t: dict) -> str:
    parts = []
    for k, v in t.items():
        text = (f"{k} kernel {v['ms']:.4f} [{v['range'][0]:.4f}-{v['range'][1]:.4f}] vs plain "
                f"{v['plain_ms']:.4f} [{v['plain_range'][0]:.4f}-{v['plain_range'][1]:.4f}]")
        if v["library_ms"] is not None:
            text += (f" vs library {v['library_ms']:.4f} [{v['library_range'][0]:.4f}-"
                     f"{v['library_range'][1]:.4f}]")
        parts.append(text)
    return " | ".join(parts)


def fmt_graph(t: dict) -> str:
    """``{name: (median, min, max)}`` as "name median [min-max], ..."."""
    return ", ".join(f"{k} {m:.4f} [{lo:.4f}-{hi:.4f}]" for k, (m, lo, hi) in t.items())


def bound_ms(bytes_moved: float, flops: float = 0.0, peak_flops: float = F32_FLOPS):
    """The least time the card could take: the larger of the bytes (each
    input read once, each output written once) over the memory rate and
    the operations over the peak rate of their type. Returns (ms, which)."""
    t_bytes, t_ops = bytes_moved / HBM_BPS * 1e3, flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def dw_bound_ms(b: int, cin: int, cout: int, edge: int):
    """K10 dw's bound at batch ``b`` on ``edge``^3 grids: each f32 product as
    one TF32 and two bf16 products (the kernel's split), or the bytes of x
    and g read and the weights written. Returns (ms, which)."""
    vox = b * edge ** 3
    moved, flops = 4.0 * (vox * (cin + cout) + 27 * cin * cout), 2.0 * 27 * cin * cout * vox
    return bound_ms(moved, flops * (1 + 2 * TF32_FLOPS / BF16_FLOPS), TF32_FLOPS)


def nnunet_k10_phase(dev, smi: str = "") -> dict:
    """The ``[K10 nnunet]`` phase: K10 forward, dx and dw through
    ``fused_conv3d_mc`` at each distinct shape of nnU-Net's 17 stride-1 convs
    at batch 2, against the f32 library calls (``F.conv3d`` and its input
    gradient in cuDNN with TF32 off, the weight gradient with cuDNN off), the
    launches against the plans; then device ms in CUDA graphs of K10's three
    passes and cuDNN's forward summed over the 17 layers, and of both library
    routes of the stride-2 convs' dx and dw and of the transposed convs'
    forward + backward. The network's input takes no gradient, so the first
    layer runs no dx. Returns the worst errors (max|d| over max|want|) and
    the sums; raises on a failed check."""
    import torch
    import torch.nn.functional as F

    from scenenet_tpu_torch.models.nnunet3d import NNUNet3D, _ConvNorm
    from scenenet_tpu_torch.ops import cuda_conv_mc
    from scenenet_tpu_torch.ops.conv3d import cudnn_off, tf32_off

    b = NNUNET_BATCH
    layers = [m for m in NNUNet3D.create().modules() if isinstance(m, _ConvNorm)]
    check([(m.weight.shape[1], m.weight.shape[0]) for m in layers if m.stride == 1]
          == [c[:2] for c in NNUNET_CONVS]
          and [(m.weight.shape[1], m.weight.shape[0]) for m in layers if m.stride == 2]
          == [c[:2] for c in NNUNET_STRIDED], "NNUNet3D's 3^3 convs differ from NNUNET_CONVS")

    def case(seed, cin, cout, n, out_n=None):
        """x ~ U(0, 1), weights of variance 1/(27 C_in) (outputs of magnitude
        ~1) and an output gradient ~ N(0, 1)."""
        gen = torch.Generator(dev).manual_seed(seed)
        x = torch.rand((b, cin, n, n, n), device=dev, generator=gen)
        w = torch.randn((cout, cin, 3, 3, 3), device=dev, generator=gen) / math.sqrt(27 * cin)
        m = out_n or n
        g = torch.randn((b, cout, m, m, m), device=dev, generator=gen)
        return x, w, g

    worst = {"forward": 0.0, "dx": 0.0, "dw": 0.0}
    parts, times = [], {}
    for cin, cout, n in dict.fromkeys(NNUNET_CONVS):
        x, w, g = case(cin + cout + n, cin, cout, n)
        needs_dx = (cin, cout, n) != NNUNET_CONVS[0]
        xa, wa = x.clone().requires_grad_(needs_dx), w.clone().requires_grad_()
        mc0, dw0 = cuda_conv_mc.MC_LAUNCHES.count, cuda_conv_mc.MC_DW_LAUNCHES.count
        y = cuda_conv_mc.fused_conv3d_mc(xa, wa)
        y.backward(g)
        tile, splits = cuda_conv_mc.conv3d_mc_dw_plan(b, cin, cout, n, n, n)
        check(cuda_conv_mc.MC_LAUNCHES.count == mc0 + 1 + needs_dx
              and cuda_conv_mc.MC_DW_LAUNCHES.count == dw0 + 1 + (splits > 1),
              f"K10 nnunet {cin}->{cout} {n}^3: launches off the plans")
        with tf32_off():
            want_y = F.conv3d(x, w, padding=1)
            want_dx = torch.nn.grad.conv3d_input(x.shape, w, g, padding=1) if needs_dx else None
        want_dw = cuda_conv_mc.conv3d_mc_weight_grad_plain(x, g)
        torch.cuda.synchronize()
        label = f"{cin}->{cout} {n}^3"
        for what, got, want, summed in (("forward", y.detach(), want_y, cin),
                                        ("dx", xa.grad, want_dx, cout)):
            if want is None:
                continue
            atol = MC_ATOL * max(1.0, math.sqrt(summed / MC_ATOL_CHANNELS))
            check(bool(torch.isfinite(got).all())
                  and bool(((got - want).abs() <= atol + MC_RTOL * want.abs()).all()),
                  f"K10 nnunet {what} {label}: max|d| {float((got - want).abs().max()):.3g} "
                  f"outside {atol:.3g} + {MC_RTOL} relative")
            worst[what] = max(worst[what], float((got - want).abs().max() / want.abs().max()))
        rel = float((wa.grad - want_dw).abs().max() / want_dw.abs().max())
        check(rel <= MC_DW_REL_TOL, f"K10 nnunet dw {label}: {rel:.3g} of max|dw|")
        worst["dw"] = max(worst["dw"], rel)
        parts.append(f"{label} [dw tile {tile}, K/{splits}] dw {rel:.3g}")
        del xa, wa, y, want_y, want_dx, want_dw
        wt = w.flip((2, 3, 4)).transpose(0, 1)
        with torch.no_grad():
            times[cin, cout, n] = {
                "forward": graph_ms(lambda: cuda_conv_mc.conv3d_mc_same(x, w), 10),
                "dx": graph_ms(lambda: cuda_conv_mc.conv3d_mc_same(g, wt), 10) if needs_dx
                else 0.0,
                "dw": graph_ms(lambda: cuda_conv_mc.conv3d_mc_weight_grad(x, g), 10)}
            with tf32_off():
                times[cin, cout, n]["cudnn_forward"] = graph_ms(
                    lambda: F.conv3d(x, w, padding=1), 10)
        del x, w, g, wt
        torch.cuda.empty_cache()
    sums = {k: sum(times[c][k] for c in NNUNET_CONVS)
            for k in ("forward", "dx", "dw", "cudnn_forward")}
    print(f"[K10 nnunet] B={b}, nnU-Net's 17 stride-1 convs at 128^3, max|d| / max|want| vs "
          f"the f32 library calls (cuDNN, TF32 off; dw cuDNN off), limits {MC_ATOL} (x sqrt "
          f"past {MC_ATOL_CHANNELS} channels) + {MC_RTOL} relative, dw {MC_DW_REL_TOL} of "
          f"max|dw|; worst forward {worst['forward']:.3g}, dx {worst['dx']:.3g}, dw "
          f"{worst['dw']:.3g} | " + ", ".join(parts)
          + f" | ({smi}) device ms in a CUDA graph, forward / dx / dw / cuDNN f32 forward: "
          + " | ".join(f"{c}->{o} {n}^3 {t['forward']:.4f} / {t['dx']:.4f} / {t['dw']:.4f} / "
                       f"{t['cudnn_forward']:.4f}" for (c, o, n), t in times.items())
          + f" | the 17 convs: forward {sums['forward']:.4f}, dx {sums['dx']:.4f}, dw "
          f"{sums['dw']:.4f}, cuDNN forward {sums['cudnn_forward']:.4f}", flush=True)

    # the library routes: cuDNN in full f32 (TF32 off) against PyTorch's own kernels
    routes = {"cudnn": tf32_off, "native": cudnn_off}
    lib = {}
    for cin, cout, n in NNUNET_STRIDED:
        x, w, g = case(cin + cout + n + 1, cin, cout, n, n // 2)
        for name, switch in routes.items():
            with switch():
                lib["strided_dx", name, n] = graph_ms(lambda: torch.nn.grad.conv3d_input(
                    x.shape, w, g, stride=2, padding=1), 5)
                lib["strided_dw", name, n] = graph_ms(lambda: torch.nn.grad.conv3d_weight(
                    x, w.shape, g, stride=2, padding=1), 5)
        del x, w, g
        torch.cuda.empty_cache()
    for cin, cout, n in NNUNET_TRANSPOSED:
        gen = torch.Generator(dev).manual_seed(cin + cout + n + 2)
        x = torch.rand((b, cin, n, n, n), device=dev, generator=gen)
        w = torch.randn((cin, cout, 2, 2, 2), device=dev, generator=gen) / math.sqrt(8 * cin)
        bias = torch.zeros(cout, device=dev)
        g = torch.randn((b, cout, 2 * n, 2 * n, 2 * n), device=dev, generator=gen)
        for name, switch in routes.items():
            with switch():
                lib["transposed", name, n] = graph_ms(
                    lambda: (F.conv_transpose3d(x, w, bias, stride=2),
                             torch.ops.aten.convolution_backward(
                                 g, x, w, [cout], [2, 2, 2], [0, 0, 0], [1, 1, 1], True,
                                 [0, 0, 0], 1, [True, True, True])), 5)
        del x, w, bias, g
        torch.cuda.empty_cache()
    lib_sums = {(what, name): sum(v for (w_, n_, _), v in lib.items() if (w_, n_) == (what, name))
                for what in ("strided_dx", "strided_dw", "transposed") for name in routes}
    print(f"[timing] nnU-Net's library convs B={b} ({smi}), device ms in a CUDA graph, cuDNN "
          "f32 (TF32 off) / PyTorch's own (cuDNN off): "
          + " | ".join(f"{what} at {n}^3 {lib[what, 'cudnn', n]:.4f} / {lib[what, 'native', n]:.4f}"
                       for what in ("strided_dx", "strided_dw", "transposed")
                       for n in sorted({k[2] for k in lib if k[0] == what}, reverse=True))
          + " | the five layers: " + ", ".join(
              f"{what} {lib_sums[what, 'cudnn']:.4f} / {lib_sums[what, 'native']:.4f}"
              for what in ("strided_dx", "strided_dw", "transposed")), flush=True)
    return {"worst": worst, "k10_ms": sums, "library_ms": lib_sums}


def post(url: str, points: np.ndarray, tau: float):
    buf = io.BytesIO()
    np.savez(buf, points=points, tau=np.float32(tau))
    req = urllib.request.Request(url, data=buf.getvalue(), method="POST")
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as r:
        status, body, server_ms = r.status, r.read(), float(r.headers["X-Latency-Ms"])
    return status, np.load(io.BytesIO(body)), (time.perf_counter() - t0) * 1e3, server_ms


def post_concurrently(url: str, clouds, tau: float):
    """One client thread per cloud, all started together; the replies in order."""
    out = [None] * len(clouds)

    def client(i):
        try:
            out[i] = post(url, clouds[i], tau)
        except Exception as exc:  # re-raised below, in the main thread
            out[i] = exc

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(len(clouds))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    check(not any(t.is_alive() for t in threads), "a client never got its reply")
    for r in out:
        if isinstance(r, Exception):
            raise r
    return out, time.perf_counter() - t0


class running:
    """Serve (server, pipeline) from a thread for the length of a with-block."""

    def __init__(self, server, pipeline):
        self.server, self.pipeline = server, pipeline
        self.thread = threading.Thread(target=server.serve_forever, daemon=True)

    def __enter__(self):
        self.thread.start()
        return f"http://127.0.0.1:{self.server.server_address[1]}"

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=30)
        self.pipeline.close()
        check(not self.thread.is_alive(), "the server thread did not end")


def healthz(url: str) -> dict:
    with urllib.request.urlopen(f"{url}/healthz", timeout=60) as r:
        return json.loads(r.read())


# ---- the [mesh] phase's rank legs ----------------------------------------------------
# Each runs on every rank of a gloo launch (scenenet_tpu_torch.parallel.launch.run_ranks,
# a fresh interpreter a rank, every rank on cuda:0 of the one card: NCCL refuses two ranks
# on one GPU) and returns to main(), which holds it against its single-rank twin on the
# card. SGD at lr 1e-2, as the CPU mesh tests: Adam turns a gradient entry near 0 into a
# step of +-lr whichever way rounding tips it.
MESH_STEPS = 3
MESH_LR = 1e-2
MESH_CRITERION = dict(weight_alpha=1, weight_epsilon=0.1, mse_weight=1, convex_weight=5,
                      tversky_alpha=2, tversky_beta=1, tversky_smooth=1e-6, focal_gamma=4)
MESH_COUNTERS = ("stencil_conv", "stencil_dk", "points_binary", "conv3d_mc", "conv3d_mc_bf16")
# the model axis's legs: the quantile ensemble of 4 members (ep, ep_serve), the pipeline's
# microbatches a rank, and the count allowance of a UNet or CNN leg against its twin: a
# probability within the sums' rounding of tau may flip (JAX's tp_gspmd allowance)
EP_QUANTILES = (0.1, 0.3, 0.5, 0.9)
PP_MICROBATCHES = 4
COUNT_ALLOWANCE = 5e-4


def mesh_grids(n: int, grid, seed: int):
    """(x, y) occupancy grids (n, 1, Z, X, Y) as uint8, made from a seed."""
    rng = np.random.default_rng(seed)
    return ((rng.random((n, 1) + tuple(grid)) > 0.9).astype(np.uint8),
            (rng.random((n, 1) + tuple(grid)) > 0.97).astype(np.uint8))


def mesh_batches(n_batches: int, batch: int, grid, seed: int):
    x, y = mesh_grids(n_batches * batch, grid, seed)
    return [(x[i * batch:(i + 1) * batch].astype(np.float32),
             y[i * batch:(i + 1) * batch].astype(np.float32)) for i in range(n_batches)]


class MeshGridCache:
    """A grid cache's tensors (uint8 x and y on the card), as ``DeviceGridCache``
    holds them: 3 batches of the train batch at 64³."""

    def __init__(self, dev):
        import torch

        x, y = mesh_grids(MESH_STEPS * TRAIN_BATCH, GRID, 34)
        self.x, self.y = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
        self.device = self.x.device

    def __len__(self):
        return int(self.x.shape[0])


class MeshLog:
    """A logger that keeps every epoch's scores."""

    def __init__(self):
        self.scores = []

    def log_metrics(self, scores, step):
        self.scores.append(dict(scores))

    def log_params(self, params, step):
        pass


def mesh_counters():
    from scenenet_tpu_torch.ops import cuda_conv, cuda_conv_mc, cuda_hist

    return {"stencil_conv": cuda_conv.LAUNCHES, "stencil_dk": cuda_conv.DK_LAUNCHES,
            "points_binary": cuda_hist.BINARY_LAUNCHES, "conv3d_mc": cuda_conv_mc.MC_LAUNCHES,
            "conv3d_mc_bf16": cuda_conv_mc.MC_BF16_LAUNCHES}


def flax_form_twin(model, dev):
    """A one-rank twin's UNet with its BatchNorms in flax's form, E[x²] − E[x]²,
    the form a sharded BatchNorm takes (through a mesh of one rank, over
    which the statistics' mean is the identity)."""
    from scenenet_tpu_torch.parallel import make_mesh

    make_mesh((1, 1), axis_names=("data", "model"), device=dev)  # made active
    return model.with_bn_sync("data")


def mesh_fit(kind: str, dev, tmp: str, mesh=None, tag: str = "", **cfg) -> dict:
    """One leg's fit on ``dev``: over ``mesh``, or with ``mesh=None`` its
    single-rank twin. Returns the counts, losses, parameters (or running
    statistics), the linesearch's trials, the launches of each kernel and
    the ms a step."""
    import torch

    from scenenet_tpu_torch.losses import resolve_criterion
    from scenenet_tpu_torch.models.scenenet import SceneNet
    from scenenet_tpu_torch.models.unet3d import UNet3D
    from scenenet_tpu_torch.train import TrainConfig, Trainer
    from scenenet_tpu_torch.train import preempt as pre
    from scenenet_tpu_torch.train.checkpoint import _module_state

    tag = tag or kind
    config = TrainConfig(max_epochs=1, optimizer="sgd", learning_rate=MESH_LR,
                         early_stop_metric=None, log_gradients=False,
                         checkpoint_dir=os.path.join(tmp, f"ckpt_{tag}"),
                         run_dir=os.path.join(tmp, f"run_{tag}"))
    for k, v in cfg.items():
        setattr(config, k, v)
    log = MeshLog()
    crit = resolve_criterion("geneo_tversky")(**MESH_CRITERION)
    if kind == "unet":
        model = UNet3D.create(seed=0, backend="cuda").to(dev)
        batches = mesh_batches(MESH_STEPS, 4, GRID, 31)
    elif kind in ("tp", "tp_bf16"):
        # channel TP (or its twin): the UNet at its full ladder, streamed
        dtype = torch.bfloat16 if kind == "tp_bf16" else torch.float32
        model = UNet3D.create(seed=0, backend="cuda", dtype=dtype).to(dev)
        config.precision = "bf16" if kind == "tp_bf16" else "f32"
        if mesh is None:
            flax_form_twin(model, dev)
        batches = mesh_batches(MESH_STEPS, 4, GRID, 35)
    elif kind == "ep":
        from scenenet_tpu_torch.models.scenenet import QuantileSceneNet

        model = QuantileSceneNet.create(kernel_size=(9, 5, 5), quantiles=EP_QUANTILES, seed=0,
                                        backend="cuda").to(dev)
        crit = resolve_criterion("quantile_geneo")(
            quantiles=EP_QUANTILES, **{k: MESH_CRITERION[k] for k in (
                "weight_alpha", "weight_epsilon", "mse_weight", "convex_weight")})
    else:
        model = SceneNet.create(kernel_size=(9, 5, 5), seed=0, backend="cuda").to(dev)
        batches = (mesh_batches(MESH_STEPS, BIG_BATCH, BIG_GRID, 32) if kind == "big"
                   else mesh_batches(MESH_STEPS, TRAIN_BATCH, GRID, 33))
    trainer = Trainer(model, crit, config, logger=log, mesh=mesh)
    counters = mesh_counters()
    for c in counters.values():
        c.reset()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    trials = []
    if kind in ("grids", "ep"):
        trainer.fit_grid_cached(MeshGridCache(dev), TRAIN_BATCH, augment=True,
                                generator=torch.Generator(dev).manual_seed(5))
    elif kind == "lbfgs":
        from scenenet_tpu_torch.train.metrics import init_metric_state

        trainer.setup_optimizer()
        trainer._replicate()
        with (mesh.active() if mesh is not None else contextlib.nullcontext()):
            for batch in batches:
                trainer.train_step(init_metric_state(dev), *trainer.shard(batch))
                trials.append(trainer.optimizer.trials)
    elif kind == "killed":
        class PreemptAfter:
            def __iter__(self):
                for i, b in enumerate(batches):
                    if i == MESH_STEPS - 2:  # latched during the step of batch i
                        pre.request_preemption()
                    yield b

        trainer.fit(PreemptAfter())
    elif kind == "resumed":
        trainer.fit(batches, resume_from=os.path.join(config.checkpoint_dir, pre.SNAPSHOT_NAME))
    else:
        trainer.fit(batches)
    torch.cuda.synchronize(dev)
    steps = max(trainer.step, len(trials), 1)
    # a fit's epoch time is its steps up to the counts' read (a sync), before the
    # epoch's checkpoints (the UNet's are 52 MB a file); L-BFGS here steps alone
    train_s = (log.scores[-1]["epoch_time_s"] if log.scores
               else time.perf_counter() - t0)
    out = {"counts": list(trainer.train_counts), "scores": log.scores,
           "ms": train_s * 1e3 / steps, "trials": trials,
           "launches": {k: c.count for k, c in counters.items()},
           "preempted": trainer.preempted, "step": trainer.step}
    state = _module_state(model)
    out["params"] = {k: v.detach().float().cpu().numpy().copy() for k, v in state.items()
                     if not k.startswith("batch_stats")}
    out["stats"] = {k: v.detach().cpu().numpy().copy() for k, v in state.items()
                    if k.startswith("batch_stats")}
    return out


def mesh_pp(dev, mesh=None) -> dict:
    """The CnnBaseline (3 channels, (3,3,3)) at 64³, batch 16, 3 SGD steps:
    over ``mesh`` (data × stage) through ``make_pipeline_train_step``,
    ``PP_MICROBATCHES`` microbatches a rank, its stage convs on K10's FMA
    kernel; with ``mesh=None`` the unpipelined model, its twin."""
    import torch

    from scenenet_tpu_torch.losses import resolve_criterion
    from scenenet_tpu_torch.models.cnn_baseline import CnnBaseline
    from scenenet_tpu_torch.parallel.pp import (
        cnn_pipeline_params, cnn_unstack_params, make_pipeline_train_step,
    )
    from scenenet_tpu_torch.train.metrics import init_metric_state, metric_counts, update_metrics

    crit = resolve_criterion("geneo_tversky")(**MESH_CRITERION)
    model = CnnBaseline.create(conv_num=3, kernel_size=(3, 3, 3), seed=0,
                               backend="cuda").to(dev)
    batches = mesh_batches(MESH_STEPS, TRAIN_BATCH, GRID, 36)
    counters = mesh_counters()
    for c in counters.values():
        c.reset()
    mstate, losses = init_metric_state(dev), []
    if mesh is not None:
        stacked = {k: torch.nn.Parameter(v) for k, v in cnn_pipeline_params(model).items()}
        opt = torch.optim.SGD(stacked.values(), lr=MESH_LR)
        step = make_pipeline_train_step(model, crit, opt, mesh, stacked,
                                        n_microbatches=PP_MICROBATCHES)
    else:
        opt = torch.optim.SGD(model.parameters(), lr=MESH_LR)

        def step(m, x, y):
            x, y = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
            opt.zero_grad(set_to_none=True)
            pred = model(x)
            loss = crit(pred, y, {}, {}, None)
            loss.backward()
            opt.step()
            return update_metrics(m, pred.detach(), y, 0.65), loss.detach()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for x, y in batches:
        mstate, loss = step(mstate, x, y)
        losses.append(float(loss))
    torch.cuda.synchronize(dev)
    ms = (time.perf_counter() - t0) * 1e3 / MESH_STEPS
    params = (cnn_unstack_params({k: v.detach() for k, v in stacked.items()})
              if mesh is not None else model.flax_state())
    return {"losses": losses, "counts": [metric_counts(mstate)], "ms": ms,
            "params": {k: v.detach().cpu().numpy().copy() for k, v in params.items()},
            "launches": {k: c.count for k, c in counters.items()}}


def mesh_unet_pp(dev, mesh=None) -> dict:
    """The UNet at its full ladder, eval mode, 64³ batch 4: through
    ``make_unet_pipeline_inference_fn`` over ``mesh`` (stage 2, 2
    microbatches), or with ``mesh=None`` ``UNet3D.forward``, its twin."""
    import torch

    from scenenet_tpu_torch.models.unet3d import UNet3D
    from scenenet_tpu_torch.parallel.pp import make_unet_pipeline_inference_fn

    model = UNet3D.create(seed=0, backend="cuda").to(dev).eval()
    x = mesh_batches(1, 4, GRID, 37)[0][0]
    counters = mesh_counters()
    for c in counters.values():
        c.reset()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    if mesh is not None:
        pred = make_unet_pipeline_inference_fn(model, mesh, n_microbatches=2)(x)
    else:
        with torch.no_grad():
            pred = model(torch.from_numpy(x).to(dev))
    torch.cuda.synchronize(dev)
    return {"pred": pred.cpu().numpy(), "ms": (time.perf_counter() - t0) * 1e3,
            "launches": {k: c.count for k, c in counters.items()}}


def mesh_ranks_2(tmp: str) -> dict:
    """2 ranks, mesh data 2: the grid-cache fit at the defaults' width (64³,
    batch 16), the UNet at its full ladder (64³, batch 4), L-BFGS, and the
    first half of preempt/resume (an unkilled fit, and one stopped after 2
    steps with its snapshot); then the bf16 UNet's channels over data 1 ×
    model 2 and the UNet pipeline over stage 2 (64³, batch 4)."""
    from scenenet_tpu_torch.parallel import launch, make_mesh

    dev = launch.init_from_env("gloo", "cuda")
    mesh = make_mesh((2, 1), device=dev)
    out = {"coords": mesh.coords, "device": str(dev)}
    # an untimed fit first: the process's first steps load the kernels and cuDNN's
    # plans and open the groups' connections
    mesh_fit("grids", dev, tmp, mesh, tag="warm_up")
    out["dp"] = mesh_fit("grids", dev, tmp, mesh, tag="dp")
    out["unet_dp"] = mesh_fit("unet", dev, tmp, mesh)
    out["lbfgs_dp"] = mesh_fit("lbfgs", dev, tmp, mesh, optimizer="lbfgs", learning_rate=0.1)
    out["unkilled"] = mesh_fit("plain", dev, tmp, mesh, tag="unkilled")
    out["killed"] = mesh_fit("killed", dev, tmp, mesh, tag="preempt")
    # the model axis on 2 ranks: channel TP of the bf16 UNet over (data 1, model 2), and
    # the UNet pipeline over (data 1, stage 2)
    tp = make_mesh((1, 2), axis_names=("data", "model"), device=dev)
    out["tp_bf16"] = mesh_fit("tp_bf16", dev, tmp, tp, tag="tp_bf16")
    stage = make_mesh((1, 2), axis_names=("data", "stage"), device=dev)
    out["unet_pp"] = mesh_unet_pp(dev, stage)
    return out


def mesh_ranks_resume(tmp: str) -> dict:
    """2 ranks in a fresh launch: the last step, resumed from the snapshot."""
    from scenenet_tpu_torch.parallel import launch, make_mesh

    dev = launch.init_from_env("gloo", "cuda")
    mesh = make_mesh((2, 1), device=dev)
    return {"resumed": mesh_fit("resumed", dev, tmp, mesh, tag="preempt")}


def mesh_ranks_4(tmp: str) -> dict:
    """4 ranks at 128³, batch 4, streamed: data 2 × space 2 (z slabs of 64
    through the halo exchange and B10), and the hybrid mesh dcn 2 × (data 1
    × space 2); then the model axis at 64³: the quantile ensemble (4
    members, batch 16, the grid cache) and the UNet's channels (batch 4,
    streamed) over data 2 × model 2, and the CNN's pipeline (batch 16) over
    data 2 × stage 2."""
    from scenenet_tpu_torch.parallel import launch, make_hybrid_mesh, make_mesh

    dev = launch.init_from_env("gloo", "cuda")
    out = {}
    mesh = make_mesh((2, 2), device=dev)
    out["coords"] = mesh.coords
    mesh_fit("big", dev, tmp, mesh, tag="warm_up")  # untimed, as in mesh_ranks_2
    out["dp_sp"] = mesh_fit("big", dev, tmp, mesh, tag="dp_sp")
    hybrid = make_hybrid_mesh((2, 1), (1, 2), device=dev)
    out["hybrid_shape"] = hybrid.shape
    out["hybrid"] = mesh_fit("big", dev, tmp, hybrid, tag="hybrid")
    # the model axis on 4 ranks: the ensemble's members and the UNet's channels over
    # (data 2, model 2), the CNN's two convs over (data 2, stage 2)
    model = make_mesh((2, 2), axis_names=("data", "model"), device=dev)
    out["model_coords"] = model.coords
    out["ep"] = mesh_fit("ep", dev, tmp, model, tag="ep")
    out["tp"] = mesh_fit("tp", dev, tmp, model, tag="tp")
    out["pp"] = mesh_pp(dev, make_mesh((2, 2), axis_names=("data", "stage"), device=dev))
    return out


def mesh_nccl_rank() -> dict:
    """1 rank under NCCL: the collective layer on device tensors, eagerly
    and inside a CUDA graph capture (the all-reduce that a cached step under
    NCCL holds in its graph), and the shift's zero fill."""
    import torch
    import torch.distributed as dist

    from scenenet_tpu_torch.parallel import launch, make_mesh
    from scenenet_tpu_torch.parallel.mesh import all_reduce, shift

    dev = launch.init_from_env("nccl", "cuda")
    mesh = make_mesh((1, 1), device=dev)
    x = torch.arange(4096, dtype=torch.float32, device=dev)
    want = x.clone()
    eager = all_reduce(x, dist.group.WORLD)
    halo = shift(x.view(1, 1, 4, 32, 32), "space", +1, mesh)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        for _ in range(3):
            all_reduce(x, dist.group.WORLD)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = all_reduce(x, dist.group.WORLD)
    x.mul_(3.0)
    graph.replay()
    torch.cuda.synchronize(dev)
    return {"backend": dist.get_backend(), "eager": bool(torch.equal(eager, want)),
            "replay": bool(torch.equal(out, want * 3.0)),
            "shift_zero": bool(torch.count_nonzero(halo) == 0)}


def mesh_phase(dev, tmp: Path, smi: str) -> dict:
    """The [mesh] phase: the legs on gloo ranks that share the card (every rank
    on cuda:0, the collectives staged through the host by gloo: NCCL refuses two
    ranks on one GPU), each 3 steps against its single-rank twin on the card; the
    1-rank NCCL check; and ``cli.train`` under ``torch.distributed.run``. Any
    difference raises. Returns the halo forms' launches on the z-sharded fits,
    every rank's, and the model axis legs' launches by kernel, every rank's.
    The times show that the ranks compute on the card, not how a mesh
    scales."""
    from scenenet_tpu_torch.parallel import launch as rank_launch

    t_mesh = time.perf_counter()
    mesh_dir, twin_dir = str(tmp / "mesh"), str(tmp / "mesh_twins")
    r2 = rank_launch.run_ranks("chip_smoke:mesh_ranks_2", 2, {"tmp": mesh_dir},
                               timeout=500, path=str(ROOT))
    r4 = rank_launch.run_ranks("chip_smoke:mesh_ranks_4", 4, {"tmp": mesh_dir},
                               timeout=600, path=str(ROOT))
    r_resume = rank_launch.run_ranks("chip_smoke:mesh_ranks_resume", 2, {"tmp": mesh_dir},
                                     timeout=300, path=str(ROOT))
    twins = {"dp": mesh_fit("grids", dev, twin_dir, tag="dp"),
             "unet_dp": mesh_fit("unet", dev, twin_dir),
             "lbfgs_dp": mesh_fit("lbfgs", dev, twin_dir, optimizer="lbfgs",
                                  learning_rate=0.1),
             "big": mesh_fit("big", dev, twin_dir)}
    twins["dp_sp"] = twins["hybrid"] = twins["big"]

    def mesh_losses(res):
        return [sc["train_loss"] for sc in res["scores"]]

    def rel(a, b):
        return float(np.max(np.abs(np.asarray(a) - np.asarray(b))
                            / np.maximum(np.abs(np.asarray(b)), 1e-30)))

    def max_abs(got, want):
        return max((float(np.max(np.abs(got[k] - v))) for k, v in want.items()),
                   default=0.0)

    MESH_LOSS_RTOL, MESH_PARAM_ATOL = 1e-5, 1e-6
    # the UNet: K10's plan tiles a batch of 2 a rank otherwise than a batch of 4, so
    # its f32 sums run in another order; 3 SGD steps on statistics of ~1e0
    MESH_UNET_RTOL, MESH_UNET_ATOL = 1e-4, 1e-5
    legs_desc = {"dp": "data 2, SceneNet (9,5,5) 64^3 B=16, grid cache",
                 "dp_sp": "data 2 x space 2, SceneNet 128^3 B=4, streamed, z slabs of 64",
                 "hybrid": "dcn 2 x (data 1 x space 2), SceneNet 128^3 B=4, streamed",
                 "unet_dp": "data 2, UNet3D full ladder 64^3 B=4, streamed, sync BatchNorm"}
    mesh_halo = {"stencil_conv": 0, "stencil_dk": 0}
    for leg, desc in legs_desc.items():
        ranks = [r[leg] for r in (r4 if leg in ("dp_sp", "hybrid") else r2)]
        want = twins[leg]
        got = ranks[0]
        loss_err = rel(mesh_losses(got), mesh_losses(want))
        same_ranks = all(all(np.array_equal(r["params"][k], got["params"][k])
                             for k in got["params"]) and r["counts"] == got["counts"]
                         for r in ranks)
        if leg == "unet_dp":
            stats_err = max(float(np.max(np.abs(got["stats"][k] - v)
                                         - MESH_UNET_RTOL * np.abs(v)))
                            for k, v in want["stats"].items())
            # the counts may differ where a probability sits within the sums'
            # rounding of tau: the sync BatchNorm takes E[x^2] - E[x]^2 (flax's form),
            # the single-rank one F.batch_norm's variance
            equal = (loss_err <= MESH_UNET_RTOL and stats_err <= MESH_UNET_ATOL and same_ranks
                     and all(r["launches"]["conv3d_mc"] > 0 for r in ranks))
            detail = (f"running statistics max(|d| - {MESH_UNET_RTOL:g}|ref|) "
                      f"{stats_err:.3g} (bound {MESH_UNET_ATOL:g})")
        else:
            param_err = max_abs(got["params"], want["params"])
            equal = (got["counts"] == want["counts"] and loss_err <= MESH_LOSS_RTOL
                     and param_err <= MESH_PARAM_ATOL and same_ranks)
            detail = f"params max|d| {param_err:.3g} (bound {MESH_PARAM_ATOL:g})"
        if leg in ("dp_sp", "hybrid"):
            # Z is sharded: every K2 and K4 launch of these fits is B10's halo form
            halo_ok = all(r["launches"]["stencil_conv"] > 0
                          and r["launches"]["stencil_dk"] > 0 for r in ranks)
            equal = equal and halo_ok
            for r in ranks:
                for k in mesh_halo:
                    mesh_halo[k] += r["launches"][k]
        print(f"[mesh] {leg}: {desc}, {MESH_STEPS} SGD steps | loss {mesh_losses(got)} "
              f"vs twin {mesh_losses(want)} (rel {loss_err:.3g}) | counts {got['counts']} "
              f"vs twin {want['counts']} | {detail} | ranks agree {same_ranks} | "
              f"equal={equal} | step ms by rank "
              + ", ".join(f"{r['ms']:.1f}" for r in ranks)
              + f" vs twin {want['ms']:.1f} (ranks share the card over gloo) | launches "
              + " ; ".join(str(r["launches"]) for r in ranks) + f" | {smi}", flush=True)
        check(equal, f"[mesh] {leg} differs from its twin")
    mesh_legs = model_axis_legs(dev, twin_dir, r2, r4, smi, rel, max_abs, mesh_losses)
    lb = [r["lbfgs_dp"] for r in r2]
    lb_equal = all(r["trials"] == twins["lbfgs_dp"]["trials"] for r in lb) and all(
        np.array_equal(r["params"][k], lb[0]["params"][k]) for r in lb for k in r["params"])
    print(f"[mesh] lbfgs_dp: data 2, SceneNet 64^3 B=16, L-BFGS lr 0.1 | trials by rank "
          f"{[r['trials'] for r in lb]} vs twin {twins['lbfgs_dp']['trials']} | params max|d| "
          f"vs twin {max_abs(lb[0]['params'], twins['lbfgs_dp']['params']):.3g} | "
          f"equal={lb_equal} | step ms by rank "
          + ", ".join(f"{r['ms']:.1f}" for r in lb)
          + f" vs twin {twins['lbfgs_dp']['ms']:.1f} | {smi}", flush=True)
    check(lb_equal, "[mesh] lbfgs_dp: the ranks' linesearch trials differ")
    killed = [r["killed"] for r in r2]
    resumed = [r["resumed"] for r in r_resume]
    pre_equal = (all(k["preempted"] and k["step"] == MESH_STEPS - 1 for k in killed)
                 and all(r["step"] == MESH_STEPS for r in resumed)
                 and all(np.array_equal(r["params"][k], r2[0]["unkilled"]["params"][k])
                         for r in resumed for k in r["params"]))
    print(f"[mesh] preempt_resume: data 2, SceneNet 64^3 B=16 streamed: "
          f"{MESH_STEPS - 1} steps, snapshot, a fresh launch, 1 step | bit-identical to the "
          f"unkilled fit: equal={pre_equal} | loss {mesh_losses(r2[0]['unkilled'])} | {smi}",
          flush=True)
    check(pre_equal, "[mesh] preempt_resume is not bit-identical")
    nccl = rank_launch.run_ranks("chip_smoke:mesh_nccl_rank", 1, timeout=180,
                                 path=str(ROOT),
                                 env={"TORCH_NCCL_ASYNC_ERROR_HANDLING": "0"})[0]
    print(f"[mesh] 1-rank {nccl['backend']} group: all_reduce on the card eager "
          f"{nccl['eager']}, captured in a CUDA graph and replayed {nccl['replay']}; "
          f"shift zero-fills {nccl['shift_zero']} | multi-card NCCL not measured (one "
          f"card) | {smi}", flush=True)
    check(nccl["backend"] == "nccl" and nccl["eager"] and nccl["replay"]
          and nccl["shift_zero"], f"[mesh] the NCCL collective check failed: {nccl}")
    # the two cli.train launches run together (5 processes on the card over gloo)
    ep_cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "3",
              "--master-addr", "localhost", "--master-port", str(rank_launch.free_port()),
              "-m", "scenenet_tpu_torch.cli.train", "--dist-backend", "gloo",
              "--set", *DEFAULTS_SET, "--set", f"data_path={tmp / 'ts40k'}", "model=quantile",
              "criterion=quantile_geneo", "mesh_ensemble=3", "max_epochs=1", "num_workers=4",
              f"output_dir={tmp / 'mesh_cli_ep'}"]
    cli_cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
               "--master-addr", "localhost", "--master-port", str(rank_launch.free_port()),
               "-m", "scenenet_tpu_torch.cli.train", "--dist-backend", "gloo",
               "--set", *DEFAULTS_SET, "--set", f"data_path={tmp / 'ts40k'}", "mesh_data=2",
               "max_epochs=1", "num_workers=4", f"output_dir={tmp / 'mesh_cli'}"]
    t0 = time.perf_counter()
    ep_log = [open(tmp / f"mesh_cli_ep.{k}", "w+") for k in ("out", "err")]
    ep_proc = subprocess.Popen(ep_cmd, cwd=str(ROOT), stdout=ep_log[0], stderr=ep_log[1],
                               text=True, env=dict(os.environ, OMP_NUM_THREADS="2"))
    try:
        proc = subprocess.run(cli_cmd, cwd=str(ROOT), capture_output=True, text=True,
                              timeout=400, env=dict(os.environ, OMP_NUM_THREADS="2"))
        cli_s = time.perf_counter() - t0
        ep_proc.wait(timeout=400)
        ep_cli_s = time.perf_counter() - t0
    finally:
        if ep_proc.poll() is None:
            ep_proc.kill()
            ep_proc.wait()
        ep_out, ep_err = [(f.seek(0), f.read(), f.close())[1] for f in ep_log]
    mesh_line = [ln for ln in proc.stdout.splitlines() if ln.startswith("[mesh]")]
    check(proc.returncode == 0 and any("[mesh] training over {'data': 2, 'space': 1}" in ln
                                       for ln in mesh_line),
          f"[mesh] torch.distributed.run cli.train: rc {proc.returncode}\n"
          f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    print(f"[mesh] python -m torch.distributed.run --nproc-per-node 2 -m "
          f"scenenet_tpu_torch.cli.train --dist-backend gloo --set <defaults> mesh_data=2 "
          f"max_epochs=1: rc 0 in {cli_s:.1f} s (beside ep_cli) | {mesh_line[0]} | {smi}",
          flush=True)
    ep_line = [ln for ln in ep_out.splitlines() if ln.startswith("[mesh]")]
    check(ep_proc.returncode == 0 and any("[mesh] training over {'data': 1, 'model': 3}" in ln
                                          for ln in ep_line)
          and ep_out.count("test_loss") == 3,
          f"[mesh] ep_cli: rc {ep_proc.returncode}\n{ep_out[-3000:]}{ep_err[-3000:]}")
    routes = sorted({ln for ln in ep_out.splitlines() if ln.startswith("[device_cache")})
    print(f"[mesh] ep_cli: python -m torch.distributed.run --nproc-per-node 3 -m "
          f"scenenet_tpu_torch.cli.train --dist-backend gloo --set <defaults> model=quantile "
          f"criterion=quantile_geneo mesh_ensemble=3 max_epochs=1: rc 0 in {ep_cli_s:.1f} s "
          f"(beside the mesh_data=2 launch) | {ep_line[0]} | {routes} | {smi}", flush=True)
    print(f"[mesh] phase {time.perf_counter() - t_mesh:.1f} s | {smi}", flush=True)
    return {"halo": mesh_halo, "legs": mesh_legs}


def model_axis_legs(dev, twin_dir, r2, r4, smi, rel, max_abs, mesh_losses) -> dict:
    """The [mesh] phase's model axis legs against their twins on one rank:
    ep, tp, tp_bf16, pp and unet_pp. Any difference raises. Returns the legs'
    launches by kernel, summed over every rank."""
    twins = {"ep": mesh_fit("ep", dev, twin_dir, tag="ep"),
             "tp": mesh_fit("tp", dev, twin_dir, tag="tp"),
             "tp_bf16": mesh_fit("tp_bf16", dev, twin_dir, tag="tp_bf16"),
             "pp": mesh_pp(dev), "unet_pp": mesh_unet_pp(dev)}
    launches = {k: 0 for k in MESH_COUNTERS}

    def counted(ranks):
        for r in ranks:
            for k in launches:
                launches[k] += r["launches"][k]

    def agree(ranks):
        return all(all(np.array_equal(r["params"][k], ranks[0]["params"][k])
                       for k in ranks[0]["params"]) for r in ranks)

    def counts_close(got, want, voxels):
        return len(got) == len(want) and all(
            max(abs(i - j) for i, j in zip(a, b)) <= COUNT_ALLOWANCE * voxels
            for a, b in zip(got, want))

    def line(leg, desc, detail, equal, ranks, want):
        print(f"[mesh] {leg}: {desc} | {detail} | equal={equal} | step ms by rank "
              + ", ".join(f"{r['ms']:.1f}" for r in ranks)
              + f" vs twin {want['ms']:.1f} (ranks share the card over gloo) | launches "
              + " ; ".join(str(r["launches"]) for r in ranks) + f" | {smi}", flush=True)
        check(equal, f"[mesh] {leg} differs from its twin")

    # ep: the ensemble's members over model, every count exact
    ranks, want = [r["ep"] for r in r4], twins["ep"]
    got = ranks[0]
    loss_err = rel(mesh_losses(got), mesh_losses(want))
    param_err = max_abs(got["params"], want["params"])
    equal = (got["counts"] == want["counts"] and loss_err <= 1e-5 and param_err <= 1e-6
             and agree(ranks) and all(r["launches"]["stencil_conv"] > 0
                                      and r["launches"]["stencil_dk"] > 0 for r in ranks))
    counted(ranks)
    line("ep", f"data 2 x model 2, QuantileSceneNet (9,5,5) x {len(EP_QUANTILES)} members "
         f"{EP_QUANTILES}, quantile_geneo, 64^3 B=16, grid cache, {MESH_STEPS} SGD steps",
         f"loss {mesh_losses(got)} vs twin {mesh_losses(want)} (rel {loss_err:.3g}) | counts "
         f"{got['counts']} vs twin {want['counts']} | params max|d| {param_err:.3g} (bound 1e-6)",
         equal, ranks, want)

    # tp and tp_bf16: the UNet's channels over model, held as unet_dp is
    voxels = MESH_STEPS * 4 * GRID[0] * GRID[1] * GRID[2]
    for leg, ranks, rtol, atol, stats_rtol, counter, desc in (
            ("tp", [r["tp"] for r in r4], 1e-4, 1e-5, 1e-4, "conv3d_mc",
             "data 2 x model 2, UNet3D full ladder f32, 64^3 B=4, streamed, C_out/2 a rank"),
            ("tp_bf16", [r["tp_bf16"] for r in r2], 5e-3, 2e-3, 2e-2, "conv3d_mc_bf16",
             "data 1 x model 2, UNet3D full ladder precision=bf16, 64^3 B=4, streamed")):
        want, got = twins[leg], ranks[0]
        loss_err = rel(mesh_losses(got), mesh_losses(want))
        stats_err = max(float(np.max(np.abs(got["stats"][k] - v) - stats_rtol * np.abs(v)))
                        for k, v in want["stats"].items())
        param_err = max_abs(got["params"], want["params"])
        equal = (loss_err <= rtol and stats_err <= atol and agree(ranks)
                 and counts_close(got["counts"], want["counts"], voxels)
                 and all(r["launches"][counter] > 0 for r in ranks))
        counted(ranks)
        line(leg, desc, f"loss {mesh_losses(got)} vs twin {mesh_losses(want)} (rel "
             f"{loss_err:.3g}, bound {rtol:g}) | counts {got['counts']} vs twin "
             f"{want['counts']} (within {COUNT_ALLOWANCE:.2%} of the voxels) | running "
             f"statistics max(|d| - {stats_rtol:g}|ref|) {stats_err:.3g} (bound {atol:g}) | "
             f"params max|d| {param_err:.3g} | the twin's BatchNorm in flax's form",
             equal, ranks, want)

    # pp: the CNN's two convs as two stages, against the unpipelined model
    ranks, want = [r["pp"] for r in r4], twins["pp"]
    got = ranks[0]
    loss_err = rel(got["losses"], want["losses"])
    param_err = max_abs(got["params"], want["params"])
    equal = (loss_err <= 1e-5 and param_err <= 1e-5 and agree(ranks)
             and counts_close(got["counts"], want["counts"],
                              MESH_STEPS * TRAIN_BATCH * GRID[0] * GRID[1] * GRID[2])
             and all(r["launches"]["conv3d_mc"] > 0 for r in ranks))
    counted(ranks)
    line("pp", f"data 2 x stage 2, CnnBaseline(conv_num=3, (3,3,3)) 64^3 B=16, "
         f"{PP_MICROBATCHES} microbatches a rank, {MESH_STEPS} SGD steps",
         f"loss {got['losses']} vs twin {want['losses']} (rel {loss_err:.3g}, bound 1e-5) | "
         f"counts {got['counts']} vs twin {want['counts']} | params max|d| {param_err:.3g} "
         f"(bound 1e-5)", equal, ranks, want)

    # unet_pp: the encoder on stage 0, the decoder on stage 1, eval mode
    ranks, want = [r["unet_pp"] for r in r2], twins["unet_pp"]
    err = max(float(np.max(np.abs(r["pred"] - want["pred"]))) for r in ranks)
    equal = err <= 1e-5 and all(r["launches"]["conv3d_mc"] > 0 for r in ranks)
    counted(ranks)
    line("unet_pp", "stage 2, make_unet_pipeline_inference_fn, UNet3D full ladder eval, 64^3 "
         "B=4, 2 microbatches", f"prediction max|d| vs UNet3D.forward {err:.3g} (bound 1e-5)",
         equal, ranks, want)
    return launches


def main(argv=None) -> int:
    import argparse

    import torch
    import torch.nn.functional as F

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="also profile the batched serving and the train step with "
                             "torch.profiler")
    opts = parser.parse_args(argv)
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device; nothing was run", file=sys.stderr)
        return 1
    if not (ROOT / "scenenet_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from the root of a checkout of the repo", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from scenenet_tpu_torch.cli import train as train_cli
    from scenenet_tpu_torch.cli.serve import _Pipeline, build_server, make_handler
    from scenenet_tpu_torch import native
    from scenenet_tpu_torch.data import (
        NativePointCloudLoader, PointCloudLoader, PointPadding, Subset, TS40K,
    )
    from scenenet_tpu_torch.data.device_cache import DeviceGridCache, DevicePointCache
    from scenenet_tpu_torch.losses import resolve_criterion
    from scenenet_tpu_torch.models.scenenet import QuantileSceneNet, SceneNet
    from scenenet_tpu_torch.models.nnunet3d import NNUNet3D
    from scenenet_tpu_torch.models.unet3d import BLOCKS, UNet3D
    from scenenet_tpu_torch.ops import _build, cuda_conv, cuda_conv_mc, cuda_hist, library_conv
    from scenenet_tpu_torch.ops.conv3d import conv3d_same, cudnn_off, same_pads
    from scenenet_tpu_torch.ops import voxel_np
    from scenenet_tpu_torch.ops.voxelize import (
        batch_flat_ids, voxelize_batch, voxelize_batch_from_indices, voxelize_batch_hist,
        voxelize_batch_occupancy,
    )
    from scenenet_tpu_torch.train import (
        TrainConfig, Trainer, make_device_voxelize_prep, metrics,
    )
    from scenenet_tpu_torch.train.checkpoint import restore_checkpoint
    from scenenet_tpu_torch.train.step_graph import WARMUP as GRAPH_WARMUP
    from scenenet_tpu_torch.utils.config import load_config

    counters = {"points_occupancy": cuda_hist.LAUNCHES,
                "stencil_conv": cuda_conv.LAUNCHES,
                "points_binary": cuda_hist.BINARY_LAUNCHES,
                "stencil_dk": cuda_conv.DK_LAUNCHES,
                "stencil_mma": cuda_conv.MXU_LAUNCHES,
                "points_bin_counts": cuda_hist.BIN_COUNTS_LAUNCHES,
                "bin_counts": cuda_hist.FLAT_COUNTS_LAUNCHES,
                "sorted_bin_counts": cuda_hist.SORTED_COUNTS_LAUNCHES,
                "flat_ids": cuda_hist.FLAT_IDS_LAUNCHES,
                "conv3d_mc": cuda_conv_mc.MC_LAUNCHES,
                "conv3d_mc_bf16": cuda_conv_mc.MC_BF16_LAUNCHES,
                "conv3d_mc_dw": cuda_conv_mc.MC_DW_LAUNCHES,
                # nnU-Net's library calls (its train leg); every graph's replay_launches()
                # names them too
                "conv3d_strided": library_conv.STRIDED_LAUNCHES,
                "conv_transpose3d_k2": library_conv.TRANSPOSED_LAUNCHES,
                "instance_norm_lrelu": library_conv.NORM_LAUNCHES}

    def reset_counts():
        for c in counters.values():
            c.reset()

    def read_counts():
        return {k: c.count for k, c in counters.items()}

    def ran(fits):
        """The launches a run of cached fits ran: the wrappers' counts since
        the last reset plus what the fits' graph replays ran, which no
        wrapper counts."""
        out = read_counts()
        for t in fits:
            for k, v in t.cached_epochs.replay_launches().items():
                out[k] += v
        return out

    def ran_as_traced(launched, runs, what, keys=None):
        """``launched`` (what a run ran, by the counts) against ``runs``
        (what its trace ran), on ``keys`` or every kernel of the trace."""
        keys = runs if keys is None else keys
        check({k: launched[k] for k in keys} == {k: runs[k] for k in keys},
              f"{what}: the counts say {launched}, the trace ran {runs}")

    def profiled(fn, calls=None):
        """fn under torch.profiler: wall seconds, device busy µs, the count of
        device items, the six largest of them as text, and the device µs by
        kernel name and (inclusive of its kernels) by host operator. ``calls``,
        where given, gets the count of every host event by name."""
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        on_dev = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_us = sum(e.self_device_time_total for e in on_dev)
        check(busy_us > 0, "the profiler recorded no device time")
        if calls is not None:
            calls.update((e.key, e.count) for e in prof.key_averages()
                         if e.device_type != torch.autograd.DeviceType.CUDA)
        top = sorted(on_dev, key=lambda e: -e.self_device_time_total)[:6]
        by_name = {e.key: e.device_time_total for e in prof.key_averages()
                   if e.device_type != torch.autograd.DeviceType.CUDA}
        by_name.update((e.key, e.self_device_time_total) for e in on_dev)
        return wall, busy_us, sum(e.count for e in on_dev), ", ".join(
            f"{e.key[:40]} {e.self_device_time_total / 1e3:.3f} ms x{e.count}"
            for e in top), by_name

    def kernel_runs(prof, marks=RUN_MARKS):
        """The device runs in ``prof``'s trace of each kernel of ``marks``."""
        runs = dict.fromkeys(marks, 0)
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                for k, mark in marks.items():
                    if mark.search(e.key):
                        runs[k] += e.count
        return runs

    # ---- 1. device --------------------------------------------------------
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[device] {name} | {smi} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| devices {torch.cuda.device_count()}", flush=True)

    # ---- 2. build ---------------------------------------------------------
    # the kernel library, and beside it (its own nvcc processes, started
    # together) the bench copy of K10's earlier bf16 form that the bf16
    # timings hold the current form against
    t0 = time.perf_counter()
    spec = importlib.util.spec_from_file_location(
        "conv_mc_bf16_times", ROOT / "scenenet_tpu_torch/csrc/bench/conv_mc_bf16_times.py")
    bf16_bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bf16_bench)
    widened = ("conv3d_mc_bf16_widened",)
    bench_build = threading.Thread(target=bf16_bench.load_bench, args=(widened,), daemon=True)
    bench_build.start()
    # the native host library (g++) builds beside them
    native_build = threading.Thread(target=native.available, daemon=True)
    native_build.start()
    _build.load()
    bench_build.join()
    native_build.join()
    bf16_bench.load_bench(widened)  # raises here if the bench build failed
    # the native loader is the route measured here, not a quiet fallback
    check(native.available(), "the native host library did not build")
    log = _build.library_path().with_suffix(".log").read_text()
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    spills = sum(int(s) for s in re.findall(r"(\d+) bytes spill stores", log))
    print(f"[build] {time.perf_counter() - t0:.2f} s (nvcc {_build.build_seconds:.2f} s, "
          f"one process per source) -> {_build.library_path().name}; max registers "
          f"{max(regs, default=-1)}, spill stores {spills} B; native host library "
          f"{native.library_path().relative_to(ROOT)}", flush=True)

    rng = np.random.default_rng(0)

    # ---- 3. K1 occupancy kernel vs plain ------------------------------------
    pts8, mask8, _ = padded_batch(rng, 8)
    col_pts, col_mask = full_column_case()
    ng_pts, ng_mask, _ = padded_batch(rng, 4)
    mix_pts, mix_mask = mixed_full_column_case()
    k1_cases = [("B8_N131072_64^3", pts8, mask8, GRID),
                ("full_column_8^3", col_pts, col_mask, (8, 8, 8)),
                ("B3_mixed_full_columns_8^3", mix_pts, mix_mask, (8, 8, 8)),
                ("B4_grid48x40x56", ng_pts, ng_mask, (48, 40, 56))]
    k1_err, occ64, occ_ng = 0.0, None, None
    parts = []
    for label, p, m, g in k1_cases:
        pt, mt = torch.from_numpy(p).to(dev), torch.from_numpy(m).to(dev)
        got = cuda_hist.points_occupancy(pt, mt, g)
        want = cuda_hist.points_occupancy_plain(pt, mt, g)
        torch.cuda.synchronize()
        diff = int((got != want).sum())
        k1_err = max(k1_err, float((got - want).abs().max()))
        check(diff == 0, f"K1 {label}: {diff} voxels differ from the plain version")
        check(torch.equal(got, cuda_hist.points_occupancy(pt, mt, g)), f"K1 {label}: two runs differ")
        if label.startswith("full_column"):
            occ = got.reshape(8, 8, 8).cpu().numpy()
            check(occ[:, :, 0].sum() == 1 and occ[0, 0, 0] == 1 and occ[7, 7, 7] == 1,
                  "K1 full-column case: column-min rule broken")
        if "mixed" in label:
            occ = got.reshape(3, 8, 8, 8).cpu().numpy()
            check(occ[0, :, :, 0].sum() == occ[0, :, :, 3].sum() == occ[1, :, :, 0].sum() == 1,
                  "K1 mixed full-column case: column-min rule broken")
        if g == GRID:
            occ64 = got
        if g == (48, 40, 56):
            occ_ng = got.reshape(len(p), 1, g[2], g[0], g[1])
        parts.append(f"{label}: {int(got.sum())} occupied, 0 differ")
    print(f"[K1 occupancy] exact on all {len(k1_cases)} inputs | " + " | ".join(parts),
          flush=True)

    # ---- 4. K2 stencil kernel vs plain --------------------------------------
    x = occ64.reshape(8, 1, GRID[2], GRID[0], GRID[1])
    k2_err, parts = 0.0, []
    for ks in ((9, 5, 5), (9, 6, 6)):
        with torch.no_grad():
            kern = SceneNet.create(kernel_size=ks, seed=0).combined_kernel().to(dev)
            got = cuda_conv.geneo_stencil_conv(x, kern)
            want = cuda_conv.geneo_stencil_conv_plain(x, kern)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        flips = (got >= TAU) != (want >= TAU)
        bad_flips = int((flips & ((want - TAU).abs() > PROB_TOL)).sum())
        check(torch.isfinite(got).all().item(), f"K2 {ks}: non-finite output")
        check(err <= PROB_TOL, f"K2 {ks}: max|dprob| {err:.3g} > {PROB_TOL}")
        check(bad_flips == 0, f"K2 {ks}: {bad_flips} tau-mask flips outside the 1e-5 band")
        k2_err = max(k2_err, err)
        parts.append(f"k{ks}: max|dprob| {err:.3g}, tau flips {int(flips.sum())} "
                     f"(outside band {bad_flips})")
    # the unrolled kernel ((9,5,5)) against the generic one on the same input, and
    # each against itself
    kern = SceneNet.create(kernel_size=(9, 5, 5), seed=0).combined_kernel().detach().to(dev)
    x32 = torch.cat([x, x.flip(2), x.flip(3), x.flip(4)])
    check(cuda_conv.stencil_route((9, 5, 5)) == "fast"
          and cuda_conv.stencil_route((9, 6, 6)) == "generic",
          "the stencil's routes are not what the smoke expects")
    want = cuda_conv.geneo_stencil_conv_plain(x32, kern)
    routes = {r: cuda_conv._launch_stencil(x32, kern, True, r) for r in ("fast", "generic")}
    torch.cuda.synchronize()
    check(torch.equal(routes["fast"], cuda_conv.geneo_stencil_conv(x32, kern)),
          "K2: a (9,5,5) launch did not take the unrolled kernel")
    for r, got in routes.items():
        err = float((got - want).abs().max())
        check(err <= PROB_TOL, f"K2 {r} route: max|dprob| {err:.3g} > {PROB_TOL}")
        check(torch.equal(got, cuda_conv._launch_stencil(x32, kern, True, r)),
              f"K2 {r} route: two runs differ")
        k2_err = max(k2_err, err)
    route_err = float((routes["fast"] - routes["generic"]).abs().max())
    check(route_err <= PROB_TOL, f"K2: the two routes differ by {route_err:.3g}")
    parts.append(f"B=32 k(9, 5, 5): unrolled vs generic kernel max|d| {route_err:.3g}, each "
                 "bit-identical run to run")
    print("[K2 stencil] " + " | ".join(parts), flush=True)
    del x32, routes, want

    # ---- 5. K3 two-channel kernel vs plain ----------------------------------
    tp, tm, tl = padded_batch(np.random.default_rng(16), TRAIN_BATCH, n_pad=TRAIN_POINTS)
    tower16 = (tl == TOWER) & tm
    col_tower = np.zeros(col_mask.shape, bool)
    col_tower[0, ::3] = True
    ng_tower = np.random.default_rng(5).random(ng_mask.shape) < 0.05
    k3_cases = [("B16_N65536_64^3", tp, tm, tower16, GRID),
                ("full_column_8^3", col_pts, col_mask, col_tower, (8, 8, 8)),
                ("B4_grid48x40x56", ng_pts, ng_mask, ng_tower & ng_mask, (48, 40, 56))]
    k3_err, occ16, parts = 0.0, None, []
    for label, p, m, w, g in k3_cases:
        args = [torch.from_numpy(a).to(dev) for a in (p, m, w)]
        got = cuda_hist.points_binary(*args, g)
        want = cuda_hist.points_binary_plain(*args, g)
        torch.cuda.synchronize()
        for ch, a, b in zip("xy", got, want):
            diff = int((a != b).sum())
            k3_err = max(k3_err, float((a - b).abs().max()))
            check(diff == 0, f"K3 {label} channel {ch}: {diff} voxels differ from plain")
        check(torch.equal(got[0], cuda_hist.points_occupancy(args[0], args[1], g)),
              f"K3 {label}: occupancy channel differs from K1")
        check(int(got[1].sum()) > 0, f"K3 {label}: no tower voxel")
        if g == GRID:
            occ16 = got[0]
        parts.append(f"{label}: {int(got[0].sum())} occupied, {int(got[1].sum())} tower, "
                     "0 differ")
    print(f"[K3 points_binary] exact on both channels of all {len(k3_cases)} inputs | "
          + " | ".join(parts), flush=True)

    # ---- 6. K4 kernel gradient vs plain -------------------------------------
    x16 = occ16.reshape(TRAIN_BATCH, 1, GRID[2], GRID[0], GRID[1])
    g16 = torch.from_numpy(np.random.default_rng(6).normal(
        0, 1, tuple(x16.shape)).astype(np.float32)).to(dev)
    k4_err, parts = 0.0, []
    for ks in ((9, 5, 5), (9, 6, 6)):
        got = cuda_conv.stencil_dk(x16, g16, ks)
        again = cuda_conv.stencil_dk(x16, g16, ks)
        want = cuda_conv.stencil_dk_plain(x16, g16, ks)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        check(bool(torch.isfinite(got).all()), f"K4 {ks}: non-finite dk")
        check(err <= DK_REL_TOL * scale, f"K4 {ks}: max|ddk| {err:.3g} > 1e-4 x {scale:.3g}")
        check(torch.equal(got, again), f"K4 {ks}: two runs differ")
        k4_err = max(k4_err, err)
        parts.append(f"k{ks}: max|ddk| {err:.3g} (max|dk| {scale:.3g}), two runs "
                     "bit-identical")
    # the unrolled kernel ((9,5,5)) against the generic one on the same input, each
    # against itself, at B=16 and at a ragged B=2 volume; other sizes, generic
    check(cuda_conv.stencil_route((9, 5, 5)) == "fast"
          and cuda_conv.stencil_route((9, 6, 6)) == "generic",
          "the kernel gradient's routes are not what the smoke expects")
    ragged = (torch.rand((2, 1, 13, 37, 70), device=dev,
                         generator=torch.Generator(dev).manual_seed(7)) > 0.8).float()
    g_ragged = torch.randn(tuple(ragged.shape), device=dev,
                           generator=torch.Generator(dev).manual_seed(8))
    for label, xk, gk in (("B=16 64^3", x16, g16), ("B=2 13x37x70", ragged, g_ragged)):
        want = cuda_conv.stencil_dk_plain(xk, gk, (9, 5, 5))
        scale = float(want.abs().max())
        routes = {r: cuda_conv._launch_dk(xk, gk, (9, 5, 5), r) for r in ("fast", "generic")}
        check(torch.equal(routes["fast"], cuda_conv.stencil_dk(xk, gk, (9, 5, 5))),
              "K4: a (9,5,5) launch did not take the unrolled kernel")
        for r, got in routes.items():
            err = float((got - want).abs().max())
            check(err <= DK_REL_TOL * scale, f"K4 {r} route {label}: max|ddk| {err:.3g}")
            check(torch.equal(got, cuda_conv._launch_dk(xk, gk, (9, 5, 5), r)),
                  f"K4 {r} route {label}: two runs differ")
            k4_err = max(k4_err, err)
        parts.append(f"{label} k(9, 5, 5): unrolled vs generic kernel max|d| "
                     f"{float((routes['fast'] - routes['generic']).abs().max()):.3g} "
                     f"(max|dk| {scale:.3g}), each bit-identical run to run")
    for ks in ((1, 1, 1), (16, 3, 3)):
        got = cuda_conv.stencil_dk(ragged, g_ragged, ks)
        want = cuda_conv.stencil_dk_plain(ragged, g_ragged, ks)
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        check(err <= DK_REL_TOL * scale and torch.equal(got, cuda_conv.stencil_dk(
            ragged, g_ragged, ks)), f"K4 {ks}: max|ddk| {err:.3g} of {scale:.3g}, or runs differ")
        k4_err = max(k4_err, err)
        parts.append(f"B=2 13x37x70 k{ks}: max|ddk| {err:.3g} (max|dk| {scale:.3g}), bit-identical")
    del ragged, g_ragged
    print("[K4 stencil_dk] B=16 64^3 | " + " | ".join(parts), flush=True)

    # ---- 7. fused_geneo_conv gradients vs autograd of the plain conv -------
    w16 = torch.from_numpy(np.random.default_rng(8).normal(
        0, 1, tuple(x16.shape)).astype(np.float32)).to(dev)
    parts = []
    for ks in ((9, 5, 5), (9, 6, 6)):
        k0 = SceneNet.create(kernel_size=ks, seed=0).combined_kernel().detach().to(dev)
        xa, ka = x16.clone().requires_grad_(), k0.clone().requires_grad_()
        (cuda_conv.fused_geneo_conv(xa, ka) * w16).sum().backward()
        xb, kb = x16.clone().requires_grad_(), k0.clone().requires_grad_()
        (torch.relu(torch.tanh(conv3d_same(xb, kb[None, None]))) * w16).sum().backward()
        torch.cuda.synchronize()
        dk_err = float((ka.grad - kb.grad).abs().max())
        dk_scale = float(kb.grad.abs().max())
        dx_err = float((xa.grad - xb.grad).abs().max())
        check(dk_err <= DK_REL_TOL * dk_scale, f"fused {ks}: dk off by {dk_err:.3g}")
        check(dx_err <= 1e-5, f"fused {ks}: dx off by {dx_err:.3g}")
        parts.append(f"k{ks}: max|ddk| {dk_err:.3g} (max|dk| {dk_scale:.3g}), "
                     f"max|ddx| {dx_err:.3g}")
    print("[fused_geneo_conv] grads vs autograd of relu(tanh(conv3d)), TF32 off, "
          "B=16 64^3 | " + " | ".join(parts), flush=True)

    # ---- 7b. K5 tensor-core stencil vs plain, and vs K2 -------------------------
    x_big = (torch.rand((1, 1, 40, 144, 200), device=dev,
                        generator=torch.Generator(dev).manual_seed(3)) > 0.7).float()
    k5_err, k5_f32_err, parts = 0.0, 0.0, []
    for label, xk, sizes in (("B8_64^3", x, ((9, 5, 5), (9, 6, 6))),
                             ("B4_56x48x40", occ_ng, ((9, 5, 5), (9, 6, 6))),
                             ("B1_40x144x200", x_big, ((9, 5, 5),))):
        for ks in sizes:
            with torch.no_grad():
                kern = SceneNet.create(kernel_size=ks, seed=0).combined_kernel().to(dev)
            worst = 0.0
            for split in (True, False):
                for act in (True, False):
                    got = cuda_conv.geneo_stencil_conv_mxu(xk, kern, activation=act, split=split)
                    again = cuda_conv.geneo_stencil_conv_mxu(xk, kern, activation=act,
                                                             split=split)
                    want = cuda_conv.geneo_stencil_conv_mxu_plain(xk, kern, activation=act,
                                                                  split=split)
                    torch.cuda.synchronize()
                    check(torch.equal(got, again), f"K5 {label} {ks}: two runs differ")
                    err = float((got - want).abs().max())
                    tol = MXU_TOL * max(1.0, float(want.abs().max()))
                    check(bool(torch.isfinite(got).all()), f"K5 {label} {ks}: non-finite")
                    check(err <= tol, f"K5 {label} {ks} split={split} activation={act}: "
                                      f"max|d| {err:.3g} > {tol:.3g}")
                    worst = max(worst, err)
                    if split and act:
                        k5_err = max(k5_err, err)
                        probs, plain = got, want
            mask = cuda_conv.geneo_stencil_conv_mxu(xk, kern, tau=TAU)
            check(torch.equal(mask, (probs >= TAU).float()),
                  f"K5 {label} {ks}: fused mask differs from its own probabilities")
            flips = mask != (plain >= TAU).float()
            bad = int((flips & ((plain - TAU).abs() > MXU_TOL)).sum())
            check(bad == 0, f"K5 {label} {ks}: {bad} tau-mask flips outside the 1e-5 band")
            f32 = cuda_conv.geneo_stencil_conv(xk, kern)
            torch.cuda.synchronize()
            f32_err = float((probs - f32).abs().max())
            check(f32_err <= MXU_F32_TOL, f"K5 {label} {ks}: {f32_err:.3g} from the f32 "
                                          f"stencil, > {MXU_F32_TOL}")
            k5_f32_err = max(k5_f32_err, f32_err)
            f32_flips = int((mask != (f32 >= TAU).float()).sum())
            parts.append(f"{label} k{ks}: max|d| vs plain {worst:.3g} (split/single, with/"
                         f"without head), fused tau flips vs plain {int(flips.sum())} "
                         f"(outside band {bad}); vs K2 f32 max|dprob| {f32_err:.3g}, tau "
                         f"flips {f32_flips} of {int(mask.sum())} set")
    print("[K5 stencil_mma] bit-identical run to run | " + " | ".join(parts), flush=True)
    del x_big

    # ---- 7c. fused_geneo_conv_mxu: K5 forward, the shared f32 backward -----------
    # The gradients are held against the plain backward of the kernel's own
    # output. Against fused_geneo_conv they are only printed: where the conv is
    # within the forward's rounding of 0, relu's gate opens in one and not in
    # the other, and that voxel's whole cotangent differs.
    parts = []
    for ks in ((9, 5, 5), (9, 6, 6)):
        k0 = SceneNet.create(kernel_size=ks, seed=0).combined_kernel().detach().to(dev)
        xa, ka = x16.clone().requires_grad_(), k0.clone().requires_grad_()
        out_a = cuda_conv.fused_geneo_conv_mxu(xa, ka)
        (out_a * w16).sum().backward()
        xb, kb = x16.clone().requires_grad_(), k0.clone().requires_grad_()
        out_b = cuda_conv.fused_geneo_conv(xb, kb)
        (out_b * w16).sum().backward()
        out_a, out_b = out_a.detach(), out_b.detach()
        act = w16 * torch.where(out_a > 0, 1.0 - out_a * out_a, torch.zeros_like(out_a))
        dk_ref = cuda_conv.stencil_dk_plain(x16, act, ks)
        dx_ref = cuda_conv._conv_transpose_same(act, k0)
        torch.cuda.synchronize()
        fwd_err = float((out_a - out_b).abs().max())
        dk_err = float((ka.grad - dk_ref).abs().max())
        dk_scale = float(dk_ref.abs().max())
        dx_err = float((xa.grad - dx_ref).abs().max())
        gates = int(((out_a > 0) != (out_b > 0)).sum())
        check(fwd_err <= MXU_F32_TOL, f"fused mxu {ks}: forward off by {fwd_err:.3g}")
        check(dk_err <= DK_REL_TOL * dk_scale, f"fused mxu {ks}: dk off by {dk_err:.3g}")
        check(dx_err <= 1e-5, f"fused mxu {ks}: dx off by {dx_err:.3g}")
        parts.append(
            f"k{ks}: max|dout| vs K2 {fwd_err:.3g}; vs the plain backward of its own output "
            f"max|ddk| {dk_err:.3g} (max|dk| {dk_scale:.3g}), max|ddx| {dx_err:.3g}; vs "
            f"fused_geneo_conv max|ddk| {float((ka.grad - kb.grad).abs().max()):.3g}, max|ddx| "
            f"{float((xa.grad - xb.grad).abs().max()):.3g}, relu gates that differ {gates}")
    print("[fused_geneo_conv_mxu] tensor-core forward, shared f32 backward, B=16 64^3 | "
          + " | ".join(parts), flush=True)

    def on_card(*arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]

    def exact(label, got, want):
        """Every grid of ``got`` equal to ``want``'s; the largest difference (0)."""
        worst = 0.0
        for ch, (a, b) in enumerate(zip(got, want)):
            if b is None:
                check(a is None, f"{label}: channel {ch} should be None")
                continue
            diff = int((a != b).sum())
            check(a.dtype == b.dtype and diff == 0,
                  f"{label} channel {ch}: {diff} entries differ from the plain version")
            worst = max(worst, float((a.double() - b.double()).abs().max()))
        return worst

    # ---- 7d. K6 counts and K9 ids vs plain: exact -----------------------------
    t1p, t1m, t1l = padded_batch(np.random.default_rng(21), 1)
    hist_cases = [("B1_N131072_64^3", t1p, t1m, (t1l == TOWER) & t1m, GRID),
                  ("B16_N65536_64^3", tp, tm, tower16, GRID),
                  ("full_column_8^3", col_pts, col_mask, col_tower, (8, 8, 8))]
    k6_err, k9_err, parts = 0.0, 0.0, []
    for label, p, m, w, g in hist_cases:
        args = on_card(p, m, w)
        size = g[0] * g[1] * g[2]
        for ch in (1, 2):
            got = cuda_hist.points_bin_counts(*args, g, channels=ch)
            want = cuda_hist.points_bin_counts_plain(*args, g, ch)
            torch.cuda.synchronize()
            k6_err = max(k6_err, exact(f"K6 {label} channels={ch}", got, want))
        check(float(got[0].sum()) == m.sum() and float(got[1].sum()) == w.sum(),
              f"K6 {label}: the counts do not add up to the points")
        occ, pres = cuda_hist.points_binary(*args, g)
        cols = got[0].reshape(len(p), -1, g[1])
        check(torch.equal((cols > cols.amin(1, keepdim=True)).float().reshape(len(p), -1), occ)
              and torch.equal((got[1] > 0).float(), pres),
              f"K6 {label}: binarized counts differ from K3")
        if label.startswith("full_column"):
            c = got[0].reshape(8, 8, 8)
            check(float(c[:, :, 0].min()) == 2 and float(c[0, 0, 0]) == 3,
                  "K6 full-column case: wrong counts")
        ids = cuda_hist.flat_ids(args[0], args[1], g)
        want_ids = cuda_hist.flat_ids_plain(args[0], args[1], g)
        torch.cuda.synchronize()
        k9_err = max(k9_err, exact(f"K9 {label}", [ids], [want_ids]))
        check(bool((ids[~args[1]] == cuda_hist.invalid_id(size)).all()),
              f"K9 {label}: a masked point without the sentinel id")
        from_ids = cuda_hist.bin_counts(ids, args[1], size, args[2])
        check(torch.equal(from_ids[0], got[0]) and torch.equal(from_ids[1], got[1]),
              f"K7 over K9's ids differs from K6 on {label}")
        parts.append(f"{label}: {int((got[0] > 0).sum())} voxels hold {int(got[0].sum())} "
                     f"points, {int(got[1].sum())} tower, 0 differ")
    print(f"[K6 points_bin_counts, K9 flat_ids] exact (1 and 2 channels; ids) on all "
          f"{len(hist_cases)} inputs; K6 binarized = K3; K7 over K9's ids = K6 | "
          + " | ".join(parts), flush=True)

    # ---- 7e. K7 counts from host-exact ids vs plain, and vs the host oracle --
    pad64 = PointPadding(max_points=TRAIN_POINTS, vxg_size=GRID, compute_indices=True)
    (ip, il, im, iflat), crops64 = indexed_batch(pad64, np.random.default_rng(31), TRAIN_BATCH)
    check(bool((~im).any()) and int(np.abs(iflat[~im]).max()) == 0 and int(iflat.max()) > 0,
          "the host-exact batch should carry padded points with flat_idx 0")
    d_ip, d_il, d_im, d_iflat = on_card(ip, il, im, iflat)
    d_itow = (d_il == TOWER) & d_im
    col_ids = cuda_hist.flat_ids_plain(*on_card(col_pts, col_mask), (8, 8, 8))
    k7_cases = [("B16_N65536_64^3_host_ids", d_iflat, d_im, d_itow, 64 ** 3),
                ("full_column_8^3", col_ids, *on_card(col_mask, col_tower), 512)]
    k7_err, parts = 0.0, []
    for label, f, m, w, size in k7_cases:
        for weights in (None, w):
            got = cuda_hist.bin_counts(f, m, size, weights)
            want = cuda_hist.bin_counts_plain(f, m, size, weights)
            # the route past 2**24 points a sample: 64-bit counters, a finishing pass
            counter = cuda_hist._launch_bin_counts(f, m, size, weights, "counter")
            torch.cuda.synchronize()
            k7_err = max(k7_err, exact(f"K7 {label}", got, want),
                         exact(f"K7 counter route {label}", counter, want))
        check(float(got[0].sum()) == float(m.sum()), f"K7 {label}: a padded point was counted")
        parts.append(f"{label}: {int(got[0].sum())} points, {int(got[1].sum())} tower, 0 differ")
    fw = torch.from_numpy(np.random.default_rng(32).normal(1.0, 0.5, iflat.shape)
                          .astype(np.float32)).to(dev)
    got = cuda_hist.bin_counts(d_iflat, d_im, 64 ** 3, fw, indicator=False)
    want = cuda_hist.bin_counts_plain(d_iflat, d_im, 64 ** 3, fw, indicator=False)
    torch.cuda.synchronize()
    fw_err = float((got[1] - want[1]).abs().max())
    check(torch.equal(got[0], want[0]) and bool(
        ((got[1] - want[1]).abs() <= WEIGHTED_TOL * (1 + want[1].abs())).all()),
        f"K7 float weights: max|d| {fw_err:.3g} outside {WEIGHTED_TOL} (rel + abs)")
    hist, reg = voxelize_batch_from_indices(d_iflat, d_il == TOWER, d_im, GRID)
    dev_hist, dev_reg = voxelize_batch(d_ip, d_il, d_im, (TOWER,), GRID)
    torch.cuda.synchronize()
    o_err, moved = 0.0, 0
    for i, (xyz, lab) in enumerate(crops64):
        want_h = torch.from_numpy(voxel_np.hist_on_voxel_np(xyz, GRID)).to(dev)
        want_r = torch.from_numpy(voxel_np.reg_on_voxel_np(xyz, lab, TOWER, GRID)).to(dev)
        o_err = max(o_err, float((hist[i] - want_h).abs().max()),
                    float((reg[i] - want_r).abs().max()))
        moved += int(((dev_hist[i] - want_h).abs() > ORACLE_TOL).sum())
    check(o_err <= ORACLE_TOL, f"voxelize_batch_from_indices is {o_err:.3g} from the host oracle")
    check(moved <= 0.01 * hist.numel(), f"voxelize_batch: {moved} voxels off the host oracle")
    print(f"[K7 bin_counts] exact (1 and 2 channels, padded ids of 0 never counted; "
          f"route {cuda_hist.bin_counts_route(TRAIN_POINTS)} at N={TRAIN_POINTS}, the counter "
          f"route too) | "
          + " | ".join(parts) + f" | float weights (bf16, f32 atomics): max|d| {fw_err:.3g} "
          f"of sums up to {float(want[1].abs().max()):.3g}, counts exact | "
          f"voxelize_batch_from_indices vs hist_on_voxel_np/reg_on_voxel_np on {TRAIN_BATCH} "
          f"crops: max|d| {o_err:.3g} (limit {ORACLE_TOL}); voxelize_batch (f32 bins on the "
          f"card, K6): {moved} of {hist.numel()} density voxels differ from the oracle",
          flush=True)
    del hist, reg, dev_hist, dev_reg, want_h, want_r

    # ---- 7f. K8 counts from sorted ids vs plain, at the large grids; vs K7 ------
    def host_ids(grid, n_pad, b, seed, lo=40000, hi=70000):
        pad = PointPadding(max_points=n_pad, vxg_size=grid, compute_indices=True)
        (_, lab, m, flat), _ = indexed_batch(pad, np.random.default_rng(seed), b, lo, hi)
        f, m, lab = on_card(flat, m, lab)
        return f, m, (lab == TOWER) & m

    big_ids = host_ids(BIG_GRID, MAX_POINTS, BIG_BATCH, 41)
    huge_ids = host_ids(HUGE_GRID, MAX_POINTS, 1, 43)
    k8_cases = [("B4_N131072_128^3", *big_ids, 128 ** 3),
                ("B4_N32768_64x64x256", *host_ids(KITTI_GRID, KITTI_POINTS, 4, 42, 20000, 32000),
                 64 * 64 * 256),
                ("B1_N131072_256^3", *huge_ids, 256 ** 3),
                ("B16_N65536_64^3", d_iflat, d_im, d_itow, 64 ** 3),
                ("full_column_8^3", col_ids, *on_card(col_mask, col_tower), 512)]
    k8_err, parts = 0.0, []
    for label, f, m, w, size in k8_cases:
        for ch in (1, 2):
            got = cuda_hist.sorted_bin_counts(f, m, w if ch == 2 else None, size, channels=ch)
            want = cuda_hist.sorted_bin_counts_plain(f, m, w if ch == 2 else None, size, ch)
            torch.cuda.synchronize()
            k8_err = max(k8_err, exact(f"K8 {label} channels={ch}", got, want))
        other = cuda_hist.bin_counts(f, m, size, w)
        check(torch.equal(other[0], got[0]) and torch.equal(other[1], got[1]),
              f"K8 differs from K7 on {label}")
        parts.append(f"{label}: {int((got[0] > 0).sum())} voxels hold {int(got[0].sum())} "
                     f"points, {int(got[1].sum())} tower, 0 differ, = K7")
        del got, want, other
    # a dense cloud at 256^3 (uniform ids, one point in four bins): what K8 is for
    gen = torch.Generator(dev).manual_seed(44)
    dense_ids = (torch.randint(0, 256 ** 3, (1, DENSE_POINTS), device=dev, generator=gen,
                               dtype=torch.int32),
                 torch.ones((1, DENSE_POINTS), dtype=torch.bool, device=dev),
                 torch.rand((1, DENSE_POINTS), device=dev, generator=gen) < 0.2)
    got = cuda_hist.sorted_bin_counts(*dense_ids, 256 ** 3)
    k8_err = max(k8_err, exact("K8 dense 256^3", got,
                               cuda_hist.sorted_bin_counts_plain(*dense_ids, 256 ** 3)))
    other = cuda_hist.bin_counts(dense_ids[0], dense_ids[1], 256 ** 3, dense_ids[2])
    check(torch.equal(other[0], got[0]) and torch.equal(other[1], got[1]),
          "K8 differs from K7 on the dense 256^3 input")
    parts.append(f"B1_N{DENSE_POINTS}_256^3 uniform ids: {int((got[0] > 0).sum())} voxels hold "
                 f"{int(got[0].sum())} points, 0 differ, = K7")
    del got, other
    print(f"[K8 sorted_bin_counts] exact (1 and 2 channels) on all {len(k8_cases)} inputs, "
          "and equal to K7 on each | " + " | ".join(parts), flush=True)
    torch.cuda.empty_cache()

    # ---- 7g. B10 halo_stencil_conv: K2 and K4 VALID in z, a 128^3 volume in 4 slabs --
    # the spatially sharded shape (BASELINE config 5): batch 4, 128^3, cut in z into
    # 4 slabs of 32 planes, each with its neighbours' 8 halo planes (zeros past the ends)
    hp, hm, _ = padded_batch(np.random.default_rng(128), BIG_BATCH)
    vol = voxelize_batch_occupancy(*on_card(hp, hm), BIG_GRID)[:, None]
    hk = SceneNet.create(kernel_size=(9, 5, 5), seed=0).combined_kernel().detach().to(dev)
    halo_pad = F.pad(vol, (0, 0, 0, 0, 4, 4))
    slabs = [halo_pad[:, :, i * HALO_Z:(i + 1) * HALO_Z + 8].contiguous()
             for i in range(HALO_SLABS)]
    g_slab = torch.from_numpy(np.random.default_rng(9).normal(
        0, 1, (BIG_BATCH, 1, HALO_Z, 128, 128)).astype(np.float32)).to(dev)
    halo_conv_err = halo_dk_err = 0.0
    outs = []
    with torch.no_grad():
        for i, sl in enumerate(slabs):
            got = cuda_conv.geneo_stencil_conv(sl, hk, z_prepadded=True)
            check(tuple(got.shape) == (BIG_BATCH, 1, HALO_Z, 128, 128), f"halo slab {i}: shape")
            check(torch.equal(got, cuda_conv.geneo_stencil_conv(sl, hk, z_prepadded=True)),
                  f"halo K2 slab {i}: two runs differ")
            want = cuda_conv.geneo_stencil_conv_plain(sl, hk, z_prepadded=True)
            generic = cuda_conv._launch_stencil(sl, hk, True, "generic", z_prepadded=True)
            for label, a in (("unrolled", got), ("generic", generic)):
                err = float((a - want).abs().max())
                check(err <= PROB_TOL, f"halo K2 {label} slab {i}: max|dprob| {err:.3g}")
                halo_conv_err = max(halo_conv_err, err)
            dk = cuda_conv.stencil_dk(sl, g_slab, (9, 5, 5), z_prepadded=True)
            check(torch.equal(dk, cuda_conv.stencil_dk(sl, g_slab, (9, 5, 5), z_prepadded=True)),
                  f"halo K4 slab {i}: two runs differ")
            want = cuda_conv.stencil_dk_plain(sl, g_slab, (9, 5, 5), z_prepadded=True)
            scale = float(want.abs().max())
            for label, a in (("unrolled", dk),
                             ("generic", cuda_conv._launch_dk(sl, g_slab, (9, 5, 5), "generic",
                                                              z_prepadded=True))):
                err = float((a - want).abs().max())
                check(err <= DK_REL_TOL * scale, f"halo K4 {label} slab {i}: max|ddk| {err:.3g} "
                                                 f"of {scale:.3g}")
                halo_dk_err = max(halo_dk_err, err)
            outs.append(got)
        same = cuda_conv.geneo_stencil_conv(vol, hk)
    concat = torch.cat(outs, dim=2)
    concat_err = float((concat - same).abs().max())
    check(concat_err <= 1e-6, f"halo slabs' concatenation differs from the SAME conv by "
                              f"{concat_err:.3g}")
    concat_bits = torch.equal(concat, same)
    # the backward through the entry point, on an interior slab, against autograd of
    # the plain VALID-z conv (cuDNN f32, TF32 off)
    xa, ka = slabs[1].clone().requires_grad_(), hk.clone().requires_grad_()
    cuda_conv.halo_stencil_conv(xa, ka, True).backward(g_slab)
    xb, kb = slabs[1].clone().requires_grad_(), hk.clone().requires_grad_()
    torch.relu(torch.tanh(F.conv3d(F.pad(xb, (2, 2, 2, 2, 0, 0)), kb[None, None]))).backward(
        g_slab)
    halo_dx_err = float((xa.grad - xb.grad).abs().max())
    halo_bwd_dk = float((ka.grad - kb.grad).abs().max())
    check(halo_dx_err <= PROB_TOL, f"halo backward: max|ddx| {halo_dx_err:.3g}")
    check(halo_bwd_dk <= DK_REL_TOL * float(kb.grad.abs().max()),
          f"halo backward: max|ddk| {halo_bwd_dk:.3g}")
    halo_dk_err = max(halo_dk_err, halo_bwd_dk)
    del xa, ka, xb, kb, outs, concat, same
    # the entry point as the spatial path calls it, every slab forward and backward:
    # its launches (two K2, forward and dx, and one K4 a slab)
    reset_counts()
    for sl in slabs:
        xa, ka = sl.clone().requires_grad_(), hk.clone().requires_grad_()
        cuda_conv.halo_stencil_conv(xa, ka, True).backward(g_slab)
    torch.cuda.synchronize()
    halo_counts = read_counts()
    check(halo_counts["stencil_conv"] == 2 * HALO_SLABS
          and halo_counts["stencil_dk"] == HALO_SLABS, f"halo entry point launched {halo_counts}")
    del xa, ka
    sl, interior = slabs[1], vol[:, :, HALO_Z:2 * HALO_Z].contiguous()
    sl_pad = F.pad(sl, (2, 2, 2, 2, 0, 0))
    with torch.no_grad():
        halo_times = {
            "stencil_conv_halo": paired_ms(
                lambda: cuda_conv.geneo_stencil_conv(sl, hk, z_prepadded=True),
                lambda: cuda_conv.geneo_stencil_conv_plain(sl, hk, z_prepadded=True), 5,
                library_fn=lambda: torch.relu(torch.tanh(F.conv3d(sl_pad, hk[None, None])))),
            "stencil_dk_halo": paired_ms(
                lambda: cuda_conv.stencil_dk(sl, g_slab, (9, 5, 5), z_prepadded=True),
                lambda: cuda_conv.stencil_dk_plain(sl, g_slab, (9, 5, 5), z_prepadded=True), 5,
                library_fn=lambda: torch.nn.grad.conv3d_weight(sl_pad, (1, 1, 9, 5, 5), g_slab))}
        halo_graph = {
            "K2 halo": lambda: cuda_conv.geneo_stencil_conv(sl, hk, z_prepadded=True),
            "K2 SAME": lambda: cuda_conv.geneo_stencil_conv(interior, hk),
            "K4 halo": lambda: cuda_conv.stencil_dk(sl, g_slab, (9, 5, 5), z_prepadded=True),
            "K4 SAME": lambda: cuda_conv.stencil_dk(interior, g_slab, (9, 5, 5))}
        halo_graph = {k: float(np.median([graph_ms(fn) for _ in range(3)]))
                      for k, fn in halo_graph.items()}
    slab_vox = BIG_BATCH * HALO_Z * 128 * 128
    halo_bounds = {  # x with its halo in, the output (or g in and 225 floats out)
        "stencil_conv_halo": bound_ms(4.0 * BIG_BATCH * (HALO_Z + 8) * 128 * 128
                                      + 4.0 * slab_vox, 2.0 * 225 * slab_vox),
        "stencil_dk_halo": bound_ms(4.0 * BIG_BATCH * (HALO_Z + 8) * 128 * 128
                                    + 4.0 * slab_vox + 4.0 * 225, 2.0 * 225 * slab_vox)}
    print(f"[B10 halo_stencil_conv] B={BIG_BATCH} 128^3 in {HALO_SLABS} z-slabs of {HALO_Z} + 8 "
          f"halo planes, k(9,5,5): K2 prepadded vs plain max|dprob| {halo_conv_err:.3g} (unrolled "
          f"and generic kernel), K4 prepadded max|ddk| {halo_dk_err:.3g}, each bit-identical run "
          f"to run | slabs' concatenation vs SAME K2 max|d| {concat_err:.3g} (bit-identical: "
          f"{concat_bits}) | backward through halo_stencil_conv vs autograd of the plain conv: "
          f"max|ddx| {halo_dx_err:.3g}, max|ddk| {halo_bwd_dk:.3g} | entry point, {HALO_SLABS} "
          f"slabs forward and backward, launches {halo_counts}", flush=True)
    print(f"[timing] B10 one slab B={BIG_BATCH} {HALO_Z}+8 x 128 x 128 ({smi}): median of 4 "
          "alternating rounds [min-max] ms; library = F.conv3d / conv3d_weight on the "
          "xy-padded slab (cuDNN f32, TF32 off): " + fmt_times(halo_times)
          + " | device ms a call inside a CUDA graph, the halo form beside the SAME form on "
          "the slab's 32 planes: " + ", ".join(f"{k} {v:.4f}" for k, v in halo_graph.items())
          + " | bounds " + ", ".join(f"{k} {v[0]:.4f} ms by {v[1]}"
                                     for k, v in halo_bounds.items()), flush=True)
    del vol, halo_pad, slabs, g_slab, sl, interior, sl_pad
    torch.cuda.empty_cache()

    # ---- 8. kernel timing ---------------------------------------------------
    times = {}
    kern = SceneNet.create(kernel_size=(9, 5, 5), seed=0).combined_kernel().detach().to(dev)
    for b in (1, 64):
        p, m, _ = padded_batch(np.random.default_rng(b), b)
        pt, mt = torch.from_numpy(p).to(dev), torch.from_numpy(m).to(dev)
        iters = 20 if b == 1 else 5
        xb = cuda_hist.points_occupancy(pt, mt, GRID).reshape(b, 1, GRID[2], GRID[0], GRID[1])
        xb_pad = F.pad(xb, same_pads(kern.shape))
        w5 = kern[None, None]

        def conv_library():  # one cuDNN call (f32, TF32 off) and the head
            return torch.relu(torch.tanh(F.conv3d(xb_pad, w5)))

        with torch.no_grad():
            times[b] = {
                "occupancy": paired_ms(lambda: cuda_hist.points_occupancy(pt, mt, GRID),
                                       lambda: cuda_hist.points_occupancy_plain(pt, mt, GRID),
                                       iters),
                "stencil (9,5,5)": paired_ms(lambda: cuda_conv.geneo_stencil_conv(xb, kern),
                                             lambda: cuda_conv.geneo_stencil_conv_plain(xb, kern),
                                             iters, library_fn=conv_library),
                "stencil_mma (9,5,5)": paired_ms(
                    lambda: cuda_conv.geneo_stencil_conv_mxu(xb, kern),
                    lambda: cuda_conv.geneo_stencil_conv_mxu_plain(xb, kern),
                    iters, library_fn=conv_library)}
        del pt, mt, xb, xb_pad
        torch.cuda.empty_cache()
    for b, t in times.items():
        print(f"[timing] B={b} 64^3 N={MAX_POINTS} ({smi}), median of 4 alternating rounds "
              "[min-max] ms; library = F.conv3d on the padded grid, tanh, relu (cuDNN f32, "
              "TF32 off): " + fmt_times(t) + " | stencil's bound (f32 FMA pipe) "
              f"{bound_ms(8.0 * b * 64 ** 3, 2.0 * 225 * b * 64 ** 3)[0]:.4f} ms, through its "
              f"{cuda_conv.stencil_route((9, 5, 5))} kernel", flush=True)
    train_times = {}
    for b in (1, TRAIN_BATCH):
        p, m, lab = padded_batch(np.random.default_rng(100 + b), b, n_pad=TRAIN_POINTS)
        args = [torch.from_numpy(a).to(dev) for a in (p, m, (lab == TOWER) & m)]
        xb = cuda_hist.points_binary(*args, GRID)[0].reshape(b, 1, GRID[2], GRID[0], GRID[1])
        gb = torch.from_numpy(np.random.default_rng(b).normal(
            0, 1, tuple(xb.shape)).astype(np.float32)).to(dev)
        iters = 20 if b == 1 else 5
        xb_pad = F.pad(xb, same_pads((9, 5, 5)))
        train_times[b] = {
            "points_binary": paired_ms(lambda: cuda_hist.points_binary(*args, GRID),
                                       lambda: cuda_hist.points_binary_plain(*args, GRID),
                                       iters),
            "stencil_dk (9,5,5)": paired_ms(
                lambda: cuda_conv.stencil_dk(xb, gb, (9, 5, 5)),
                lambda: cuda_conv.stencil_dk_plain(xb, gb, (9, 5, 5)), iters,
                library_fn=lambda: torch.nn.grad.conv3d_weight(xb_pad, (1, 1, 9, 5, 5), gb))}
        del args, xb, gb, xb_pad
        torch.cuda.empty_cache()
    for b, t in train_times.items():
        print(f"[timing] B={b} 64^3 N={TRAIN_POINTS} ({smi}), median of 4 alternating "
              "rounds [min-max] ms; library = torch.nn.grad.conv3d_weight on the padded "
              "grid (cuDNN f32, TF32 off): " + fmt_times(t), flush=True)
    # at small batch the loops above time the host's launch rate: the device
    # time of a call, captured in a CUDA graph and replayed, median of 3
    p1, m1, l1 = padded_batch(np.random.default_rng(1), 1)
    p1, m1, w1 = on_card(p1, m1, (l1 == TOWER) & m1)
    x1 = cuda_hist.points_occupancy(p1, m1, GRID).reshape(1, 1, GRID[2], GRID[0], GRID[1])
    g1 = torch.from_numpy(np.random.default_rng(1).normal(
        0, 1, tuple(x1.shape)).astype(np.float32)).to(dev)
    p16, m16, l16 = padded_batch(np.random.default_rng(100 + TRAIN_BATCH), TRAIN_BATCH,
                                 n_pad=TRAIN_POINTS)
    k3_args = on_card(p16, m16, (l16 == TOWER) & m16)
    p64, m64, _ = padded_batch(np.random.default_rng(64), 64)
    x64 = cuda_hist.points_occupancy(*on_card(p64, m64), GRID).reshape(64, 1, GRID[2], GRID[0],
                                                                     GRID[1])
    big_f, big_m, big_w = big_ids
    graph_fns = {
        "points_occupancy B=1": lambda: cuda_hist.points_occupancy(p1, m1, GRID),
        "stencil_dk (9,5,5) B=1": lambda: cuda_conv.stencil_dk(x1, g1, (9, 5, 5)),
        "stencil_mma (9,5,5) B=1": lambda: cuda_conv.geneo_stencil_conv_mxu(x1, kern),
        "stencil_mma (9,5,5) B=64": lambda: cuda_conv.geneo_stencil_conv_mxu(x64, kern),
        f"points_binary B={TRAIN_BATCH}": lambda: cuda_hist.points_binary(*k3_args, GRID),
        f"bin_counts B={TRAIN_BATCH} 2ch": lambda: cuda_hist.bin_counts(
            d_iflat, d_im, 64 ** 3, d_itow),
        f"sorted_bin_counts B={TRAIN_BATCH} 2ch (beside K7)": lambda: cuda_hist.sorted_bin_counts(
            d_iflat, d_im, d_itow, 64 ** 3),
        f"sorted_bin_counts B={BIG_BATCH} 128^3": lambda: cuda_hist.sorted_bin_counts(
            big_f, big_m, big_w, 128 ** 3),
        "points_bin_counts B=1 2ch": lambda: cuda_hist.points_bin_counts(p1, m1, w1, GRID),
        f"points_bin_counts B={TRAIN_BATCH} 2ch": lambda: cuda_hist.points_bin_counts(
            *k3_args, GRID),
        "flat_ids B=1": lambda: cuda_hist.flat_ids(p1, m1, GRID),
        f"flat_ids B={TRAIN_BATCH}": lambda: cuda_hist.flat_ids(k3_args[0], k3_args[1], GRID)}
    with torch.no_grad():
        graph_times = {k: float(np.median([graph_ms(fn) for _ in range(3)]))
                       for k, fn in graph_fns.items()}
    print(f"[timing] 64^3, K8 at 128^3 ({smi}), device ms a call inside a CUDA graph: "
          + ", ".join(f"{k} {v:.4f}" for k, v in graph_times.items()), flush=True)
    del p1, m1, w1, x1, g1, k3_args, graph_fns, p64, m64, x64

    def bincount_library(f, m, w, size):
        """One torch.bincount per channel over b·size + flat (points that do not
        count go to one bin past the end); the ids are made outside the timing."""
        b = f.shape[0]
        offs = torch.arange(b, device=dev)[:, None] * size
        keep = m & (f >= 0) & (f < size)
        ids = [torch.where(k, f.long() + offs, b * size).reshape(-1) for k in (keep, keep & w)]
        return lambda: [torch.bincount(i, minlength=b * size + 1) for i in ids]

    tower16_d = on_card(tower16)[0]
    tp_d, tm_d = on_card(tp, tm)
    hist_times = {
        "points_bin_counts": paired_ms(
            lambda: cuda_hist.points_bin_counts(tp_d, tm_d, tower16_d, GRID),
            lambda: cuda_hist.points_bin_counts_plain(tp_d, tm_d, tower16_d, GRID), 5),
        "flat_ids": paired_ms(lambda: cuda_hist.flat_ids(tp_d, tm_d, GRID),
                              lambda: cuda_hist.flat_ids_plain(tp_d, tm_d, GRID), 5),
        "bin_counts": paired_ms(
            lambda: cuda_hist.bin_counts(d_iflat, d_im, 64 ** 3, d_itow),
            lambda: cuda_hist.bin_counts_plain(d_iflat, d_im, 64 ** 3, d_itow), 5,
            library_fn=bincount_library(d_iflat, d_im, d_itow, 64 ** 3)),
    }
    print(f"[timing] B={TRAIN_BATCH} 64^3 N={TRAIN_POINTS}, two channels ({smi}), median of "
          "4 alternating rounds [min-max] ms; library = one torch.bincount a channel: "
          + fmt_times(hist_times), flush=True)
    big_times = {
        "sorted_bin_counts": paired_ms(
            lambda: cuda_hist.sorted_bin_counts(big_f, big_m, big_w, 128 ** 3),
            lambda: cuda_hist.sorted_bin_counts_plain(big_f, big_m, big_w, 128 ** 3), 5,
            library_fn=bincount_library(big_f, big_m, big_w, 128 ** 3)),
        "bin_counts at 128^3": paired_ms(
            lambda: cuda_hist.bin_counts(big_f, big_m, 128 ** 3, big_w),
            lambda: cuda_hist.bin_counts_plain(big_f, big_m, 128 ** 3, big_w), 5)}

    # the two id kernels in turns, at three sizes: "plain" is K7 here
    versus = {f"sorted_bin_counts vs bin_counts {label}": paired_ms(
        lambda: cuda_hist.sorted_bin_counts(f, m, w, size),
        lambda: cuda_hist.bin_counts(f, m, size, w), 5)
        for label, f, m, w, size in (("B4 N131072 128^3", big_f, big_m, big_w, 128 ** 3),
                                     ("B16 N65536 64^3", d_iflat, d_im, d_itow, 64 ** 3),
                                     ("B1 N131072 256^3", *huge_ids, 256 ** 3),
                                     (f"B1 N{DENSE_POINTS} 256^3 uniform ids", *dense_ids,
                                      256 ** 3))}
    slower = [k for k, v in versus.items() if "128^3" in k or "256^3" in k
              if v["ms"] > v["plain_ms"]]
    print(f"[timing] B={BIG_BATCH} 128^3 N={MAX_POINTS}, two channels ({smi}), median of 4 "
          "alternating rounds [min-max] ms; library = one torch.bincount a channel: "
          + fmt_times(big_times) + " | K8 ('kernel') against K7 ('plain') in turns: "
          + fmt_times(versus) + f" | K8 slower than K7 at: {slower or 'none'}", flush=True)
    del tp_d, tm_d, tower16_d, big_ids, huge_ids, dense_ids, big_f, big_m, big_w
    torch.cuda.empty_cache()

    # ---- 8b. K10 multi-channel conv vs plain: every UNet layer shape -----------
    def mc_case(seed, b, cin, cout, shape, last=False):
        """x ~ U(0, 1) and weights of variance 1/(27 C_in): outputs of magnitude ~1."""
        gen = torch.Generator(dev).manual_seed(seed)
        xs = (b, *shape, cin) if last else (b, cin, *shape)
        xm = torch.rand(xs, device=dev, generator=gen)
        wm = torch.randn((cout, cin, 3, 3, 3), device=dev, generator=gen) / math.sqrt(27 * cin)
        return xm, wm

    def mc_check(label, xm, wm, last=False):
        """The kernel against cuDNN f32 and against itself: the largest
        difference; two runs on the same inputs must give the same bits."""
        got = cuda_conv_mc.conv3d_mc_same(xm, wm, channels_last=last)
        again = cuda_conv_mc.conv3d_mc_same(xm, wm, channels_last=last)
        want = cuda_conv_mc.conv3d_mc_same_plain(xm, wm, channels_last=last)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        atol = MC_ATOL * max(1.0, math.sqrt(wm.shape[1] / MC_ATOL_CHANNELS))
        check(bool(torch.isfinite(got).all()) and got.shape == want.shape,
              f"K10 {label}: non-finite or misshapen output")
        check(bool(((got - want).abs() <= atol + MC_RTOL * want.abs()).all()),
              f"K10 {label}: max|d| {err:.3g} outside {atol:.3g} + {MC_RTOL} relative")
        check(torch.equal(got, again), f"K10 {label}: two runs on the same inputs differ")
        return err

    def mc_plan(b, cin, cout, shape, last=False):
        tile, k_splits = cuda_conv_mc.conv3d_mc_plan(b, cin, cout, *shape, channels_last=last)
        if tile == cuda_conv_mc.FMA_TILE:
            return "FMA kernel"
        (tb, *vox), bn = cuda_conv_mc.TC_TILES[tile]
        return (f"{tb}x" if tb > 1 else "") + "x".join(map(str, vox)) + f"x{bn}ch" \
            + (f" K/{k_splits}" if k_splits > 1 else "")

    mc_shapes = list(dict.fromkeys(UNET_CONVS))  # the 16 distinct layer shapes
    net_shapes = []
    for blk in (getattr(UNet3D(), n) for n in BLOCKS):
        net_shapes += [tuple(blk.conv0.shape[1::-1]), tuple(blk.conv1.shape[1::-1])]
    check(net_shapes == [c[:2] for c in UNET_CONVS], f"UNet3D's convs are {net_shapes}")
    k10_err, parts = 0.0, []
    for cin, cout, n in mc_shapes:
        xm, wm = mc_case(cin + cout + n, TRAIN_BATCH, cin, cout, (n, n, n))
        err = mc_check(f"{cin}->{cout} {n}^3", xm, wm)
        k10_err = max(k10_err, err)
        parts.append(f"{cin}->{cout} {n}^3 {err:.3g}")
        del xm, wm
    extra_parts, seen_tiles, seen_splits = [], set(), set()
    for b, cin, cout, shape in MC_EXTRA:
        err = mc_check(f"B={b} {cin}->{cout} {shape}", *mc_case(b + cin, b, cin, cout, shape))
        k10_err = max(k10_err, err)
        extra_parts.append(f"B={b} {cin}->{cout} {shape} [{mc_plan(b, cin, cout, shape)}] "
                           f"{err:.3g}")
    for b, cin, cout, shape in MC_EXTRA + [(TRAIN_BATCH, c, o, (n, n, n)) for c, o, n in mc_shapes]:
        tile, k_splits = cuda_conv_mc.conv3d_mc_plan(b, cin, cout, *shape)
        seen_tiles.add(tile)
        seen_splits.add(k_splits)
        check(k_splits <= cuda_conv_mc.conv3d_mc_split_cap(tile, cin), "K10: a plan past its cap")
    check(seen_tiles == {cuda_conv_mc.FMA_TILE, *cuda_conv_mc.TC_TILES}
          and cuda_conv_mc.MAX_K_SPLITS in seen_splits and 1 in seen_splits,
          f"K10: the checks reach tiles {seen_tiles} and K splits {seen_splits} only")
    xl, wl = mc_case(2, 2, 24, 16, (10, 10, 10), last=True)
    last = mc_check("channels-last 24->16 10^3", xl, wl, last=True)
    k10_err = max(k10_err, last)
    # fused_conv3d_mc: dx (the kernel on the flipped, swapped weights) and dw (the
    # library call) against autograd through the plain version
    grad_parts = []
    for cin, cout, n in ((64, 32, 32), (256, 128, 8)):
        xm, wm = mc_case(3, 4, cin, cout, (n, n, n))
        gm = torch.randn((4, cout, n, n, n), device=dev,
                         generator=torch.Generator(dev).manual_seed(4))
        xa, wa = xm.clone().requires_grad_(), wm.clone().requires_grad_()
        before = cuda_conv_mc.MC_LAUNCHES.count
        (cuda_conv_mc.fused_conv3d_mc(xa, wa) * gm).sum().backward()
        check(cuda_conv_mc.MC_LAUNCHES.count == before + 2, "fused_conv3d_mc: forward + dx")
        xb, wb = xm.clone().requires_grad_(), wm.clone().requires_grad_()
        (cuda_conv_mc.conv3d_mc_same_plain(xb, wb) * gm).sum().backward()
        wc = wm.clone().requires_grad_()
        before = cuda_conv_mc.MC_LAUNCHES.count
        (cuda_conv_mc.fused_conv3d_mc(xm, wc) * gm).sum().backward()
        check(cuda_conv_mc.MC_LAUNCHES.count == before + 1,
              "fused_conv3d_mc launched dx for an input that needs no gradient")
        torch.cuda.synchronize()
        dx_err = float((xa.grad - xb.grad).abs().max())
        dw_err, dw_scale = float((wa.grad - wb.grad).abs().max()), float(wb.grad.abs().max())
        dx_atol = MC_ATOL * max(1.0, math.sqrt(cout / MC_ATOL_CHANNELS))
        check(bool(((xa.grad - xb.grad).abs() <= dx_atol + MC_RTOL * xb.grad.abs()).all()),
              f"fused_conv3d_mc {cin}->{cout}: dx off by {dx_err:.3g}")
        check(dw_err <= MC_DW_REL_TOL * dw_scale,
              f"fused_conv3d_mc {cin}->{cout}: dw off by {dw_err:.3g} of {dw_scale:.3g}")
        grad_parts.append(f"{cin}->{cout} {n}^3: max|ddx| {dx_err:.3g}, max|ddw| {dw_err:.3g} "
                          f"(max|dw| {dw_scale:.3g})")
        del xm, wm, gm, xa, wa, xb, wb, wc
    print(f"[K10 conv3d_mc] B={TRAIN_BATCH}, max|d| vs F.conv3d (cuDNN f32, TF32 off), limit "
          f"{MC_ATOL} (x sqrt(C_in/{MC_ATOL_CHANNELS}) past {MC_ATOL_CHANNELS} channels) + "
          f"{MC_RTOL} relative; every case run twice, bit-identical | " + ", ".join(parts)
          + " | the other shapes the plan separates [tile, K split]: " + ", ".join(extra_parts)
          + f" | channels-last 24->16 10^3 [FMA kernel] {last:.3g} | "
          "fused_conv3d_mc grads vs autograd of the plain version: " + "; ".join(grad_parts),
          flush=True)
    torch.cuda.empty_cache()

    # K10 times at the batch the path runs; library = plain = one F.conv3d (timed apart)
    mc_times, mc_bounds, mc_x3_bounds, mc_fma_bounds = {}, {}, {}, {}
    with torch.no_grad():
        for cin, cout, n in mc_shapes:
            xm, wm = mc_case(cin + cout + n, TRAIN_BATCH, cin, cout, (n, n, n))
            mc_times[cin, cout, n] = paired_ms(
                lambda: cuda_conv_mc.conv3d_mc_same(xm, wm),
                lambda: cuda_conv_mc.conv3d_mc_same_plain(xm, wm), iters=3,
                library_fn=lambda: F.conv3d(xm, wm, padding=1), warmup=1)
            vox = TRAIN_BATCH * n ** 3
            moved, flops = 4.0 * (vox * (cin + cout) + 27 * cin * cout), 2.0 * 27 * cin * cout * vox
            # the cheapest arithmetic found that holds the f32 tolerance: for each f32
            # product one TF32 product and two bf16 ones (the cross terms), which
            # take the tensor cores as long as two TF32 products
            mc_bounds[cin, cout, n] = bound_ms(
                moved, flops * (1 + 2 * TF32_FLOPS / BF16_FLOPS), TF32_FLOPS)
            mc_x3_bounds[cin, cout, n] = bound_ms(moved, 3 * flops, TF32_FLOPS)  # as 3xTF32
            mc_fma_bounds[cin, cout, n] = bound_ms(moved, flops, F32_FLOPS)  # the f32 FMA pipe
            del xm, wm
            torch.cuda.empty_cache()
    mc_sums = {k: sum(mc_times[c][k] for c in UNET_CONVS) for k in ("ms", "plain_ms", "library_ms")}
    mc_bound_sum = sum(mc_bounds[c][0] for c in UNET_CONVS)
    mc_fma_bound_sum = sum(mc_fma_bounds[c][0] for c in UNET_CONVS)
    mc_x3_bound_sum = sum(mc_x3_bounds[c][0] for c in UNET_CONVS)
    worst = max(mc_times, key=lambda c: mc_times[c]["ms"] / mc_times[c]["library_ms"])
    worst_ratio = mc_times[worst]["ms"] / mc_times[worst]["library_ms"]
    check(mc_sums["ms"] < mc_sums["library_ms"],
          f"K10: the 18 convs take {mc_sums['ms']:.4f} ms, cuDNN f32 {mc_sums['library_ms']:.4f}")
    check(worst_ratio <= 1.1, f"K10 {worst}: {worst_ratio:.2f}x cuDNN's time")
    for c, t in mc_times.items():
        check(t["ms"] >= mc_bounds[c][0], f"K10 {c}: {t['ms']:.4f} ms is under its bound")
    print(f"[timing] K10 conv3d_mc B={TRAIN_BATCH} ({smi}), median of 4 alternating rounds, ms "
          "kernel / plain / library (one F.conv3d, cuDNN f32, TF32 off) / bound (one TF32 and "
          "two bf16 products an f32 product at 495 and 989 TFLOP/s, or the bytes) [the plan's "
          "tile, K split]: "
          + " | ".join(f"{c}->{o} {n}^3 {t['ms']:.4f} / {t['plain_ms']:.4f} / "
                       f"{t['library_ms']:.4f} / {mc_bounds[c, o, n][0]:.4f} "
                       f"({mc_bounds[c, o, n][1]}) [{mc_plan(TRAIN_BATCH, c, o, (n, n, n))}]"
                       for (c, o, n), t in mc_times.items())
          + f" | the UNet's 18 forward convs: kernel {mc_sums['ms']:.4f}, plain "
          f"{mc_sums['plain_ms']:.4f}, cuDNN {mc_sums['library_ms']:.4f}, bound "
          f"{mc_bound_sum:.4f} ({mc_bound_sum / mc_sums['ms']:.1%} of it reached), the bound "
          f"as 3xTF32 {mc_x3_bound_sum:.4f}, the f32 FMA pipe's bound {mc_fma_bound_sum:.4f}; "
          f"slowest against cuDNN {worst[0]}->{worst[1]} "
          f"{worst[2]}^3 at {worst_ratio:.2f}x", flush=True)

    # ---- 8b'. K10's weight gradient vs the f32 library call: every UNet layer ----
    # the kernel (csrc/conv3d_mc_dw.cu; no TPU kernel) against the f32 library call the
    # port took before it (torch.nn.grad.conv3d_weight, cuDNN off: the yardstick only)
    # and against its arithmetic in torch (split_inputs on both operands, three f32
    # library calls), at the train batch; twice, bit-identical; then each layer's time
    # in a CUDA graph beside the library's and cuDNN's f32 dw (the slower library path)
    k10dw_err = k10dw_rel = k10dw_twin_rel = 0.0
    dw_parts, dw_times, dw_bounds = [], {}, {}
    for cin, cout, n in mc_shapes:
        xm, _ = mc_case(cin + cout + n + 1, TRAIN_BATCH, cin, cout, (n, n, n))
        gm = torch.randn((TRAIN_BATCH, cout, n, n, n), device=dev,
                         generator=torch.Generator(dev).manual_seed(cin + cout))
        before = cuda_conv_mc.MC_DW_LAUNCHES.count
        got = cuda_conv_mc.conv3d_mc_weight_grad(xm, gm)
        again = cuda_conv_mc.conv3d_mc_weight_grad(xm, gm)
        tile, splits = cuda_conv_mc.conv3d_mc_dw_plan(TRAIN_BATCH, cin, cout, n, n, n)
        check(cuda_conv_mc.MC_DW_LAUNCHES.count == before + 2 * (1 + (splits > 1)),
              f"K10 dw {cin}->{cout} {n}^3: launches off the plan")
        want = cuda_conv_mc.conv3d_mc_weight_grad_plain(xm, gm)
        twin = cuda_conv_mc.conv3d_mc_weight_grad_tc_plain(xm, gm)
        torch.cuda.synchronize()
        scale, err = float(want.abs().max()), float((got - want).abs().max())
        rel, twin_rel = err / scale, float((twin - want).abs().max()) / scale
        check(rel <= MC_DW_REL_TOL, f"K10 dw {cin}->{cout} {n}^3: {rel:.3g} of max|dw|")
        check(torch.equal(got, again), f"K10 dw {cin}->{cout} {n}^3: two runs differ")
        k10dw_err = max(k10dw_err, err)
        k10dw_rel, k10dw_twin_rel = max(k10dw_rel, rel), max(k10dw_twin_rel, twin_rel)
        dw_parts.append(f"{cin}->{cout} {n}^3 [tile {tile}, K/{splits}] {rel:.3g}")
        dw_bounds[cin, cout, n] = dw_bound_ms(TRAIN_BATCH, cin, cout, n)
        dw_times[cin, cout, n] = {
            "ms": graph_ms(lambda: cuda_conv_mc.conv3d_mc_weight_grad(xm, gm), 20),
            "library_ms": graph_ms(lambda: cuda_conv_mc.conv3d_mc_weight_grad_plain(xm, gm), 3),
            "cudnn_ms": graph_ms(lambda: torch.nn.grad.conv3d_weight(
                xm, (cout, cin, 3, 3, 3), gm, padding=1), 3)}
        del xm, gm, got, again, want, twin
        torch.cuda.empty_cache()
    dw_sums = {k: sum(dw_times[c][k] for c in UNET_CONVS)
               for k in ("ms", "library_ms", "cudnn_ms")}
    dw_bound_sum = sum(dw_bounds[c][0] for c in UNET_CONVS)
    for c, t in dw_times.items():
        check(t["ms"] >= dw_bounds[c][0], f"K10 dw {c}: {t['ms']:.4f} ms is under its bound")
    check(dw_sums["ms"] < dw_sums["library_ms"],
          f"K10 dw: the 18 convs take {dw_sums['ms']:.4f} ms, the library "
          f"{dw_sums['library_ms']:.4f}")
    print(f"[K10 dw] B={TRAIN_BATCH}, max|d| / max|dw| vs the f32 library call (cuDNN off), "
          f"limit {MC_DW_REL_TOL}; every case twice, bit-identical; worst: the kernel "
          f"{k10dw_rel:.3g} (max|d| {k10dw_err:.3g}), the plain twin {k10dw_twin_rel:.3g} | "
          + ", ".join(dw_parts)
          + f" | ({smi}) device ms in a CUDA graph, kernel / library (f32, cuDNN off) / cuDNN "
          "f32 / bound (one TF32 and two bf16 products an f32 product, or the bytes): "
          + " | ".join(f"{c}->{o} {n}^3 {t['ms']:.4f} / {t['library_ms']:.4f} / "
                       f"{t['cudnn_ms']:.4f} / {dw_bounds[c, o, n][0]:.4f} "
                       f"({dw_bounds[c, o, n][1]})" for (c, o, n), t in dw_times.items())
          + f" | the UNet's 18 convs: kernel {dw_sums['ms']:.4f}, library "
          f"{dw_sums['library_ms']:.4f}, cuDNN {dw_sums['cudnn_ms']:.4f}, bound "
          f"{dw_bound_sum:.4f} ({dw_bound_sum / dw_sums['ms']:.1%} of it reached)", flush=True)

    # ---- 8b''. K10 at nnU-Net's stride-1 convs (batch 2, 128^3) and its library routes ----
    nnunet_k10_phase(dev, smi)
    torch.cuda.empty_cache()

    # ---- 8c. K10's bf16 form vs plain: every UNet layer shape, in a CUDA graph ----
    def bf16_case(seed, b, cin, cout, shape):
        xm, wm = mc_case(seed, b, cin, cout, shape)
        return xm.to(torch.bfloat16), wm.to(torch.bfloat16)

    def bf16_check(label, xm, wm):
        """K10's bf16 form against its plain version (the bf16 values widened,
        F.conv3d in f32, rounded once) and against itself: within one bf16
        unit of the result plus the f32 form's tolerance, and the same bits
        on a second run. The largest difference."""
        before = cuda_conv_mc.MC_BF16_LAUNCHES.count
        got = cuda_conv_mc.conv3d_mc_same(xm, wm)
        again = cuda_conv_mc.conv3d_mc_same(xm, wm)
        want = cuda_conv_mc.conv3d_mc_same_plain(xm, wm)
        torch.cuda.synchronize()
        check(cuda_conv_mc.MC_BF16_LAUNCHES.count == before + 2,
              f"K10 bf16 {label}: not launched through its own form")
        check(got.dtype == torch.bfloat16 and got.shape == want.shape
              and bool(torch.isfinite(got).all()), f"K10 bf16 {label}: dtype, shape or value")
        d = (got.float() - want.float()).abs()
        atol = MC_ATOL * max(1.0, math.sqrt(wm.shape[1] / MC_ATOL_CHANNELS))
        check(bool((d <= atol + BF16_UNIT * want.float().abs()).all()),
              f"K10 bf16 {label}: max|d| {float(d.max()):.3g} past one bf16 unit")
        check(torch.equal(got, again), f"K10 bf16 {label}: two runs on the same inputs differ")
        return float(d.max()), float((d > 0).float().mean())

    k10b_err, parts = 0.0, []
    for cin, cout, n in mc_shapes:
        err, frac = bf16_check(f"{cin}->{cout} {n}^3",
                               *bf16_case(cin + cout + n, TRAIN_BATCH, cin, cout, (n, n, n)))
        k10b_err = max(k10b_err, err)
        parts.append(f"{cin}->{cout} {n}^3 {err:.3g} ({frac:.2e} of outputs differ)")
    extra_parts = []
    for b, cin, cout, shape in MC_EXTRA + MC_BF16_RAGGED + [(2, 3, 5, (7, 6, 5)),
                                                            (1, 1, 1, (1, 1, 1))]:
        err, _ = bf16_check(f"B={b} {cin}->{cout} {shape}",
                            *bf16_case(b + cin, b, cin, cout, shape))
        k10b_err = max(k10b_err, err)
        extra_parts.append(f"B={b} {cin}->{cout} {shape} {err:.3g}")
    grad_parts = []
    for cin, cout, n in ((64, 32, 32), (256, 128, 8)):
        xm, wm = bf16_case(3, 4, cin, cout, (n, n, n))
        gm = torch.randn((4, cout, n, n, n), device=dev,
                         generator=torch.Generator(dev).manual_seed(4)).to(torch.bfloat16)
        xa, wa = xm.clone().requires_grad_(), wm.clone().requires_grad_()
        before = cuda_conv_mc.MC_BF16_LAUNCHES.count
        cuda_conv_mc.fused_conv3d_mc(xa, wa).backward(gm)
        check(cuda_conv_mc.MC_BF16_LAUNCHES.count == before + 2, "bf16 fused: forward + dx")
        want_dx = cuda_conv_mc.conv3d_mc_same_plain(gm, wm.flip((2, 3, 4)).transpose(0, 1))
        want_dw = cuda_conv_mc.conv3d_mc_weight_grad_plain(xm, gm)
        torch.cuda.synchronize()
        dx = (xa.grad.float() - want_dx.float()).abs()
        dx_atol = MC_ATOL * max(1.0, math.sqrt(cout / MC_ATOL_CHANNELS))
        check(bool((dx <= dx_atol + BF16_UNIT * want_dx.float().abs()).all()),
              f"bf16 fused {cin}->{cout}: dx off by {float(dx.max()):.3g}")
        dw_err = float((wa.grad.float() - want_dw.float()).abs().max())
        dw_scale = float(want_dw.float().abs().max())
        check(dw_err <= MC_BF16_DW_REL_TOL * dw_scale,
              f"bf16 fused {cin}->{cout}: dw off by {dw_err:.3g} of {dw_scale:.3g}")
        grad_parts.append(f"{cin}->{cout} {n}^3: max|ddx| {float(dx.max()):.3g}, max|ddw| "
                          f"{dw_err:.3g} (max|dw| {dw_scale:.3g})")
        del xm, wm, gm, xa, wa
    print(f"[K10 conv3d_mc bf16] B={TRAIN_BATCH}, max|d| vs the plain version (bf16 widened, "
          f"F.conv3d f32, rounded once), limit one bf16 unit + {MC_ATOL} (x sqrt(C_in/"
          f"{MC_ATOL_CHANNELS})); every case run twice, bit-identical | " + ", ".join(parts)
          + " | other shapes: " + ", ".join(extra_parts)
          + " | fused_conv3d_mc bf16 grads (dx by the form, dw cuDNN bf16) vs the plain "
          "versions: " + "; ".join(grad_parts), flush=True)
    torch.cuda.empty_cache()

    # per layer: kernel / plain / library (one cuDNN bf16 F.conv3d)
    mc16_times, mc16_bounds = {}, {}
    with torch.no_grad():
        for cin, cout, n in mc_shapes:
            xm, wm = bf16_case(cin + cout + n, TRAIN_BATCH, cin, cout, (n, n, n))
            mc16_times[cin, cout, n] = paired_ms(
                lambda: cuda_conv_mc.conv3d_mc_same(xm, wm),
                lambda: cuda_conv_mc.conv3d_mc_same_plain(xm, wm), iters=3,
                library_fn=lambda: F.conv3d(xm, wm, padding=1), warmup=1)
            vox = TRAIN_BATCH * n ** 3
            # bf16 x and w in, bf16 out; a multiply and an add a tap, channel pair
            # and voxel at the bf16 tensor cores' peak
            mc16_bounds[cin, cout, n] = bound_ms(2.0 * (vox * (cin + cout) + 27 * cin * cout),
                                                 2.0 * 27 * cin * cout * vox, BF16_FLOPS)
            del xm, wm
            torch.cuda.empty_cache()
        # the 18 forward convs one after the other in one CUDA graph: the bf16
        # form, the earlier bf16 form (bench copy: bf16 widened into the f32 tile,
        # one TF32 mma a tap and 8 channels), the f32 form and cuDNN bf16, in turns;
        # then the 17 dx convs of a bf16 train step (every conv but the first: the
        # form on the cotangent with the flipped, transposed weights) against cuDNN
        # bf16's input gradient; then the 1->32 layer alone
        layer16, layer32, grads16 = {}, {}, {}
        for cin, cout, n in mc_shapes:
            layer16[cin, cout, n] = bf16_case(cin + cout + n, TRAIN_BATCH, cin, cout, (n, n, n))
            layer32[cin, cout, n] = tuple(v.float() for v in layer16[cin, cout, n])
            gen = torch.Generator(dev).manual_seed(cin * cout)
            grads16[cin, cout, n] = torch.randn((TRAIN_BATCH, cout, n, n, n), device=dev,
                                                generator=gen).to(torch.bfloat16)
        dx_convs = UNET_CONVS[1:]

        def dx_form(c):
            w = layer16[c][1]
            return cuda_conv_mc.conv3d_mc_same(grads16[c], w.flip((2, 3, 4)).transpose(0, 1))

        def dx_cudnn(c):
            x, w = layer16[c]
            return torch.nn.grad.conv3d_input(x.shape, w, grads16[c], padding=1)

        def in_turns(fns, rounds=3, iters=5):
            acc = {k: [] for k in fns}
            for r in range(rounds):
                for k in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
                    acc[k].append(graph_ms(fns[k], iters=iters))
            return {k: (float(np.median(v)), min(v), max(v)) for k, v in acc.items()}

        graph_fwd = in_turns({
            "bf16 form": lambda: [cuda_conv_mc.conv3d_mc_same(*layer16[c]) for c in UNET_CONVS],
            "earlier bf16 form": lambda: [bf16_bench.widened_conv(*layer16[c])
                                          for c in UNET_CONVS],
            "f32 form": lambda: [cuda_conv_mc.conv3d_mc_same(*layer32[c]) for c in UNET_CONVS],
            "cuDNN bf16": lambda: [F.conv3d(*layer16[c], padding=1) for c in UNET_CONVS]})
        graph_dx = in_turns({
            "bf16 form": lambda: [dx_form(c) for c in dx_convs],
            "earlier bf16 form": lambda: [bf16_bench.widened_conv(
                grads16[c], layer16[c][1].flip((2, 3, 4)).transpose(0, 1)) for c in dx_convs],
            "cuDNN bf16": lambda: [dx_cudnn(c) for c in dx_convs]})
        first = UNET_CONVS[0]
        graph_first = in_turns({
            "bf16 FMA form": lambda: cuda_conv_mc.conv3d_mc_same(*layer16[first]),
            "earlier bf16 form": lambda: bf16_bench.widened_conv(*layer16[first]),
            "f32 FMA kernel": lambda: cuda_conv_mc.conv3d_mc_same(*layer32[first]),
            "cuDNN bf16": lambda: F.conv3d(*layer16[first], padding=1)}, rounds=5, iters=20)
        for c in dx_convs[:3]:  # the dx timed is the dx the step computes
            want = cuda_conv_mc.conv3d_mc_same_plain(
                grads16[c], layer16[c][1].flip((2, 3, 4)).transpose(0, 1))
            d = (dx_form(c).float() - want.float()).abs()
            check(bool((d <= MC_ATOL * max(1.0, math.sqrt(c[1] / MC_ATOL_CHANNELS))
                        + BF16_UNIT * want.float().abs()).all()),
                  f"K10 bf16 dx {c}: max|d| {float(d.max()):.3g} past one bf16 unit")
        del layer16, layer32, grads16
        torch.cuda.empty_cache()
    # the library's dw at bf16 as fused_conv3d_mc calls it (cuDNN), with cuDNN off,
    # and the f32 model's dw (K10's dw kernel); the bf16 ones' distance from the plain
    # version (f32 sums, rounded once)
    dw16 = {}
    for cin, cout, n in ((1, 32, 64), (32, 32, 64), (128, 64, 32), (512, 256, 8)):
        xm, _ = bf16_case(5, TRAIN_BATCH, cin, cout, (n, n, n))
        gm = torch.randn((TRAIN_BATCH, cout, n, n, n), device=dev).to(torch.bfloat16)
        shape = (cout, cin, 3, 3, 3)

        def dw_off():
            with cudnn_off():
                return torch.nn.grad.conv3d_weight(xm, shape, gm, padding=1)

        ref = cuda_conv_mc.conv3d_mc_weight_grad_plain(xm, gm).float()
        scale = float(ref.abs().max())
        errs = [float((fn().float() - ref).abs().max()) / scale
                for fn in (lambda: cuda_conv_mc.conv3d_mc_weight_grad(xm, gm), dw_off)]
        xf, gf = xm.float(), gm.float()
        dw16[cin, cout, n] = (cuda_ms(lambda: cuda_conv_mc.conv3d_mc_weight_grad(xm, gm), 3, 1),
                              cuda_ms(dw_off, 3, 1),
                              cuda_ms(lambda: cuda_conv_mc.conv3d_mc_weight_grad(xf, gf), 3, 1),
                              *errs)
        del xm, gm, xf, gf, ref
        torch.cuda.empty_cache()
    mc16_sums = {k: sum(mc16_times[c][k] for c in UNET_CONVS)
                 for k in ("ms", "plain_ms", "library_ms")}
    mc16_bound_sum = sum(mc16_bounds[c][0] for c in UNET_CONVS)
    for c, t in mc16_times.items():
        check(t["ms"] >= mc16_bounds[c][0], f"K10 bf16 {c}: {t['ms']:.4f} ms is under its bound")
    print(f"[timing] K10 conv3d_mc bf16 form B={TRAIN_BATCH} ({smi}), median of 4 alternating "
          "rounds, ms kernel / plain / library (one F.conv3d in bf16, cuDNN) / bound (bf16 "
          "bytes, or the products at the bf16 peak of 989 TFLOP/s): "
          + " | ".join(f"{c}->{o} {n}^3 {t['ms']:.4f} / {t['plain_ms']:.4f} / "
                       f"{t['library_ms']:.4f} / {mc16_bounds[c, o, n][0]:.4f}"
                       for (c, o, n), t in mc16_times.items())
          + f" | the UNet's 18 forward convs: bf16 form {mc16_sums['ms']:.4f}, plain "
          f"{mc16_sums['plain_ms']:.4f}, cuDNN bf16 {mc16_sums['library_ms']:.4f}, bound "
          f"{mc16_bound_sum:.4f} ({mc16_bound_sum / mc16_sums['ms']:.1%} of it) | in one "
          "CUDA graph, median [min-max] of 3 alternating rounds: the 18 forward convs "
          + fmt_graph(graph_fwd) + f" ({mc16_bound_sum / graph_fwd['bf16 form'][0]:.1%} of "
          "the bound); the 17 dx convs of a bf16 step " + fmt_graph(graph_dx)
          + "; the 1->32 layer (5 rounds) " + fmt_graph(graph_first)
          + " | the library's dw, ms bf16 cuDNN (as fused_conv3d_mc "
          "calls it) / bf16 cuDNN off / f32 (the f32 model's: K10's dw kernel), and the two bf16 "
          "ones' max|d| / max|dw| from the plain version: "
          + ", ".join(f"{c}->{o} {n}^3 {a:.4f} / {b:.4f} / {f:.4f}, {e1:.2e} / {e2:.2e}"
                      for (c, o, n), (a, b, f, e1, e2) in dw16.items()), flush=True)

    # ---- 9. main path: serve ------------------------------------------------
    # the counts from 0 before the pipeline is built: its warm-up runs and its
    # capture are what the wrappers launch; the requests replay bucket 1's
    # graph, whose kernels are counted from a torch.profiler trace
    from torch.profiler import ProfilerActivity, profile

    reset_counts()
    gpu = _Pipeline(None)  # serving defaults: 64³, 131072 points, (9,5,5), card
    check(gpu.device.type == "cuda" and gpu.backend == "cuda", "pipeline not on the card")
    check(sorted(gpu._graphs) == [1] and gpu._graphs[1].graph.captured,
          "the serving pipeline did not capture its bucket")
    cpu = _Pipeline(None, device="cpu")
    srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(gpu))
    requests = [synthetic_cloud(np.random.default_rng(100 + i), n)
                for i, n in enumerate((41000, 52000, 63000, 69000, 131072 + 5000))]

    def check_reply(out, pts, ref, tol, what, grid=(64, 64, 64)):
        """Shapes, range, and agreement with a reference (voxel_pred,
        point_probs); returns the largest difference."""
        n = min(len(pts), MAX_POINTS)
        probs, vox, msk = out["point_probs"], out["voxel_pred"], out["mask"]
        check(probs.shape == (n,) and vox.shape[-3:] == grid and msk.shape == (n,),
              f"{what}: reply shapes {probs.shape} {vox.shape} {msk.shape}")
        for a in (probs, vox):
            check(bool(np.isfinite(a).all()) and a.min() >= 0 and a.max() <= 1,
                  f"{what}: reply not finite in [0, 1]")
        ref_vox, ref_probs = ref
        err = max(float(np.abs(probs - ref_probs).max()), float(np.abs(vox - ref_vox).max()))
        flips = (msk != (ref_probs >= TAU)) & (np.abs(ref_probs - TAU) > tol)
        check(err <= tol, f"{what}: reply differs from the CPU pipeline by {err:.3g}")
        check(not flips.any(), f"{what}: {int(flips.sum())} mask flips outside the band")
        return err

    refs = [cpu.predict(pts) for pts in requests]
    with running(srv, gpu) as url:
        lat, worst = [], 0.0
        built = gpu.kernel_launches()
        with profile(activities=[ProfilerActivity.CUDA]) as serve_prof:
            replies = [post(f"{url}/predict", pts, TAU) for pts in requests]
            torch.cuda.synchronize()
        serve_counts = read_counts()
        serve_ran = {**serve_counts, **gpu.kernel_launches()}
        serve_runs = kernel_runs(serve_prof, SERVE_MARKS)
        health = healthz(url)
    for (status, out, wall_ms, server_ms), pts, ref in zip(replies, requests, refs):
        check(status == 200, f"/predict returned {status}")
        worst = max(worst, check_reply(out, pts, ref, PROB_TOL, "serve"))
        lat.append((wall_ms, server_ms))
    n_req = len(requests)
    check(gpu.graph_replays() == {1: n_req}, f"replays {gpu.graph_replays()}")
    # launched: the first request's eager run, the warm-up runs and the capture
    check(serve_counts["points_occupancy"] == serve_counts["stencil_conv"] == GRAPH_WARMUP + 2
          and serve_counts["stencil_mma"] == serve_counts["sorted_bin_counts"] == 0,
          f"serve: the wrappers launched {serve_counts}")
    check(serve_runs["points_occupancy"] == serve_runs["stencil_conv"] == n_req
          and serve_runs["stencil_mma"] == 0, f"serve: the replays ran {serve_runs}")
    ran_as_traced({k: serve_ran[k] - built[k] for k in built}, serve_runs, "serve")
    served = {k: serve_counts[k] + n_req * gpu._graphs[1].launches[k]
              for k in ("points_occupancy", "sorted_bin_counts", "stencil_conv", "stencil_mma")}
    check(health["kernel_launches"] == served, f"/healthz counts {health['kernel_launches']}")
    print(f"[serve] {n_req} requests match the CPU pipeline (max|d| {worst:.3g}), each one "
          f"replay of bucket 1's CUDA graph | latency ms wall/server: "
          + ", ".join(f"{w:.2f}/{s:.2f}" for w, s in lat)
          + f" | launched (warm-up and capture) {serve_counts} | run by the replays "
          f"{serve_runs} | healthz {health['kernel_launches']}, device {health['device']}",
          flush=True)
    del gpu, cpu
    torch.cuda.empty_cache()

    # ---- 9a. the served dispatch: a bucket's CUDA graph against eager run_batch --
    # bit for bit at every bucket of --max-batch 8, for f32, mxu and the quantile
    # ensemble; then per dispatch at bucket 8 and per batch-1 request at the client
    graph_lines, dispatch_prof, graph_counts = [], {}, {}
    rng_g = np.random.default_rng(90)
    for kind, kw in (("f32", {}), ("mxu", {"inference": "mxu"}),
                     ("quantile", {"model": "quantile"})):
        reset_counts()
        pipe = _Pipeline(None, max_batch=8, batch_window_ms=0.0, **kw)
        graph_counts[kind] = read_counts()
        check(sorted(pipe._graphs) == [1, 2, 4, 8], f"{kind}: buckets {sorted(pipe._graphs)}")
        for b in (1, 2, 4, 8):
            hp_, hm_, _ = padded_batch(rng_g, b)
            pt_, mt_ = torch.from_numpy(hp_).to(dev), torch.from_numpy(hm_).to(dev)
            with torch.inference_mode():
                eager = pipe._run(pt_, mt_)
            got, again = pipe.run_batch(pt_, mt_), pipe.run_batch(pt_, mt_)
            check(all(torch.equal(g, e) and torch.equal(a, e)
                      for g, a, e in zip(got, again, eager)),
                  f"{kind} bucket {b}: the graph's replay differs from eager run_batch")
        check(pipe.graph_replays() == {1: 2, 2: 2, 4: 2, 8: 2}, f"{kind}: replays")
        if kind == "f32":
            # one dispatch at bucket 8: the graph's replay and the eager pipeline
            hp_, hm_, _ = padded_batch(rng_g, 8)
            pt_, mt_ = torch.from_numpy(hp_).to(dev), torch.from_numpy(hm_).to(dev)
            n_disp = 20
            for route in ("graph", "eager", "eager", "graph"):
                graphs, pipe._graphs = pipe._graphs, ({} if route == "eager" else pipe._graphs)
                calls = {}
                wall, busy_us, n_items, _, _ = profiled(
                    lambda: [pipe.run_batch(pt_, mt_) for _ in range(n_disp)], calls)
                pipe._graphs = graphs
                host = sum(v for k, v in calls.items() if k in HOST_LAUNCH_CALLS)
                dispatch_prof.setdefault(route, []).append(
                    (host / n_disp, n_items / n_disp, 1 - busy_us / 1e6 / wall,
                     wall * 1e3 / n_disp))
        pipe.close()
        graph_lines.append(f"{kind}: buckets 1/2/4/8 bit-identical to eager, twice; launched "
                           f"at build {graph_counts[kind]}")
        del pipe
        torch.cuda.empty_cache()
    # batch-1 requests at the client, through the HTTP server: graph and eager in turns
    server, one = build_server(["--port", "0"])
    client_ms = {"graph": [], "eager": []}
    with running(server, one) as url:
        graphs = one._graphs
        for r in range(4):
            for route in (("graph", "eager") if r % 2 == 0 else ("eager", "graph")):
                one._graphs = graphs if route == "graph" else {}
                for pts in requests[:4]:
                    client_ms[route].append(post(f"{url}/predict", pts, TAU)[2])
        one._graphs = graphs
    del one
    torch.cuda.empty_cache()
    disp = {k: tuple(float(np.median([r[i] for r in v])) for i in range(4))
            for k, v in dispatch_prof.items()}
    print(f"[serve graph] {' | '.join(graph_lines)} | per dispatch at bucket 8 ({smi}), "
          f"median of 2 profiled runs of 20: " + ", ".join(
              f"{k}: {h:.1f} host launch calls, {d:.1f} device items, idle share {i:.4f}, "
              f"{w:.3f} ms wall" for k, (h, d, i, w) in disp.items())
          + f" | batch-1 request at the client, median of 16 in alternating rounds [min-max] "
          f"ms: " + ", ".join(f"{k} {np.median(v):.3f} [{min(v):.3f}-{max(v):.3f}]"
                              for k, v in client_ms.items()), flush=True)

    # ---- 9b. main path: the batched pipeline, inference="mxu", fused tau-mask ----
    HEAD_B = 64
    hp, hm, _ = padded_batch(np.random.default_rng(64), HEAD_B)
    hpt, hmt = torch.from_numpy(hp).to(dev), torch.from_numpy(hm).to(dev)
    net = SceneNet.create(kernel_size=(9, 5, 5), seed=0, backend="cuda").to(dev).eval()

    def route(inference):
        with torch.inference_mode():
            xg = voxelize_batch_occupancy(hpt, hmt, GRID)[:, None]
            return net(xg, inference=inference, tau=TAU)

    reset_counts()
    mask_mxu = route("mxu")
    torch.cuda.synchronize()
    headline_counts = read_counts()
    check((headline_counts["points_occupancy"], headline_counts["stencil_mma"],
           headline_counts["stencil_conv"]) == (1, 1, 0),
          f"headline pipeline launched {headline_counts}")
    mask_f32 = route(True)
    with torch.inference_mode():
        probs_f32 = net(voxelize_batch_occupancy(hpt, hmt, GRID)[:, None], inference=True)
    check(tuple(mask_mxu.shape) == (HEAD_B, 1, 64, 64, 64)
          and bool(((mask_mxu == 0) | (mask_mxu == 1)).all()), "headline mask not {0,1}")
    flips = mask_mxu != mask_f32
    bad = int((flips & ((probs_f32 - TAU).abs() > MXU_F32_TOL)).sum())
    check(bad == 0, f"headline: {bad} mask flips outside the {MXU_F32_TOL} band of tau")
    check(0 < int(mask_mxu.sum()) < mask_mxu.numel(), "headline mask is trivial")
    head_t = paired_ms(lambda: route("mxu"), lambda: route(True), iters=5)
    print(f"[headline] B={HEAD_B} N={MAX_POINTS} 64^3 (9,5,5): points -> K1 occupancy -> "
          f"SceneNet(backend='cuda')(x, inference='mxu', tau={TAU}) | launches per call "
          f"{headline_counts} | mask: {int(mask_mxu.sum())} set of {mask_mxu.numel()}, "
          f"{int(flips.sum())} differ from the f32 route (outside the {MXU_F32_TOL} band: "
          f"{bad}) | ({smi}) median of 4 alternating rounds [min-max]: mxu route "
          f"{head_t['ms']:.4f} ms [{head_t['range'][0]:.4f}-{head_t['range'][1]:.4f}] = "
          f"{HEAD_B / head_t['ms'] * 1e3:.0f} grids/s; f32 route (inference=True, then >= tau) "
          f"{head_t['plain_ms']:.4f} ms [{head_t['plain_range'][0]:.4f}-"
          f"{head_t['plain_range'][1]:.4f}] = {HEAD_B / head_t['plain_ms'] * 1e3:.0f} grids/s",
          flush=True)
    del hpt, hmt, mask_mxu, mask_f32, probs_f32, flips
    torch.cuda.empty_cache()

    # ---- 9c. main path: batched serving, --inference mxu --max-batch 8 ----------
    clouds = [synthetic_cloud(np.random.default_rng(200 + i), 40000 + 1900 * i)
              for i in range(16)]
    cpu_mxu = _Pipeline(None, inference="mxu", device="cpu")
    refs = [cpu_mxu.predict(c) for c in clouds]
    del cpu_mxu
    reset_counts()
    server, batched = build_server(["--inference", "mxu", "--max-batch", "8", "--port", "0"])
    check(batched.device.type == "cuda" and batched._batcher.max_batch == 8
          and sorted(batched._graphs) == [1, 2, 4, 8],
          "batched server not on the card at max batch 8 with a graph a bucket")
    with running(server, batched) as url:
        before = batched.kernel_launches()
        with profile(activities=[ProfilerActivity.CUDA]) as batched_prof:
            replies, wall = post_concurrently(f"{url}/predict", clouds, TAU)
            torch.cuda.synchronize()
        health = healthz(url)
        batched_counts = read_counts()  # the warm-up runs and the four captures
        batched_ran = {**batched_counts, **batched.kernel_launches()}
        worst = max(check_reply(out, c, ref, MXU_TOL, "batched serve")
                    for (_, out, _, _), c, ref in zip(replies, clouds, refs))
        stats = health["batching"]
        check(stats["requests"] == 16 and stats["failed_dispatches"] == 0, f"batching {stats}")
        check(stats["dispatches"] < stats["requests"] and stats["max_batch_seen"] > 1,
              f"requests did not coalesce: {stats}")
        replays = batched.graph_replays()
        check(sum(replays.values()) == stats["dispatches"],
              f"{stats['dispatches']} dispatches but graph replays {replays}")
        served = {k: health["kernel_launches"][k] - before[k] for k in before}
        check(served["stencil_mma"] == served["points_occupancy"] == stats["dispatches"]
              and served["stencil_conv"] == 0,
              f"batched serving ran {served} in {stats['dispatches']} dispatches")
        ran_as_traced(served, kernel_runs(batched_prof, SERVE_MARKS), "batched serving")
        check(batched_counts["stencil_mma"] >= 4 and batched_counts["stencil_conv"] == 0,
              f"batched serving launched {batched_counts}")
        line = (f"[serve batched] --inference mxu --max-batch 8: 16 concurrent requests match "
                f"the CPU pipeline with inference='mxu' (max|d| {worst:.3g}) in "
                f"{wall * 1e3:.1f} ms | batching {stats} | graph replays by bucket {replays} "
                f"| launched (warm-up and capture) {batched_counts} | run by the replays "
                f"{served} | server ms: " + ", ".join(f"{r[3]:.1f}" for r in replies))
        if opts.profile:
            before = healthz(url)["batching"]["dispatches"]
            prof_wall, busy_us, n_items, largest, _ = profiled(
                lambda: post_concurrently(f"{url}/predict", clouds, TAU))
            n_disp = healthz(url)["batching"]["dispatches"] - before
            line += (f" | [profile] 16 requests in {n_disp} dispatches, {prof_wall * 1e3:.1f} ms "
                     f"wall, device busy {busy_us / 1e3:.3f} ms = idle share "
                     f"{1 - busy_us / 1e6 / prof_wall:.4f}, {n_items} device items = "
                     f"{n_items / n_disp:.1f} per dispatch; largest: " + largest)
    print(line, flush=True)
    del batched
    torch.cuda.empty_cache()

    # ---- 9d. --max-batch auto, and --model quantile -----------------------------
    reset_counts()
    server, auto = build_server(["--inference", "mxu", "--max-batch", "auto", "--port", "0"])
    with running(server, auto) as url:
        before = auto.kernel_launches()
        with profile(activities=[ProfilerActivity.CUDA]) as auto_prof:
            replies, wall = post_concurrently(f"{url}/predict", clouds, TAU)
            torch.cuda.synchronize()
        worst = max(check_reply(out, c, ref, MXU_TOL, "adaptive serve")
                    for (_, out, _, _), c, ref in zip(replies, clouds, refs))
        stats = healthz(url)["batching"]
        check(stats["requests"] == 16 and stats["failed_dispatches"] == 0
              and stats["mode"] == "adaptive" and stats["max_batch"] == 32, f"batching {stats}")
        auto_counts = read_counts()
        auto_ran = {**auto_counts, **auto.kernel_launches()}
        ran_as_traced({k: auto_ran[k] - before[k] for k in before},
                      kernel_runs(auto_prof, SERVE_MARKS), "adaptive serving")
        replays = auto.graph_replays()
        check(sorted(replays) == [1, 2, 4, 8, 16, 32] and sum(replays.values())
              == stats["dispatches"] + stats.get("direct_requests", 0),
              f"adaptive: {stats} but graph replays {replays}")
    print(f"[serve auto] --inference mxu --max-batch auto: 16 concurrent requests match the "
          f"CPU pipeline (max|d| {worst:.3g}) in {wall * 1e3:.1f} ms | batching {stats} | graph "
          f"replays by bucket {replays} | launched (warm-up and capture) {auto_counts}",
          flush=True)
    del auto
    torch.cuda.empty_cache()

    reset_counts()
    server, quant = build_server(["--model", "quantile", "--port", "0"])
    cpu_q = _Pipeline(None, model="quantile", device="cpu")
    with running(server, quant) as url:
        before = quant.kernel_launches()
        with profile(activities=[ProfilerActivity.CUDA]) as quant_prof:
            status, out, wall_ms, _ = post(f"{url}/predict", clouds[0], TAU)
            torch.cuda.synchronize()
        info = healthz(url)
    quant_counts = read_counts()
    quant_ran = {**quant_counts, **quant.kernel_launches()}
    ran_as_traced({k: quant_ran[k] - before[k] for k in before},
                  kernel_runs(quant_prof, SERVE_MARKS), "quantile serving")
    check(quant.graph_replays() == {1: 1}
          and quant_counts["stencil_conv"] == 3 * (GRAPH_WARMUP + 2),
          f"quantile: replays {quant.graph_replays()}, launched {quant_counts}")
    n = len(clouds[0])
    ref_vox, ref_probs = cpu_q.predict(clouds[0])
    check(status == 200 and info["model"] == "quantile" and info["quantiles"] == [0.1, 0.5, 0.9],
          f"quantile server: {status} {info}")
    check(out["point_quantiles"].shape == (3, n) and out["uncertainty"].shape == (n,)
          and out["voxel_pred"].shape == (3, 64, 64, 64) and out["point_probs"].shape == (n,),
          "quantile reply shapes")
    q_err = max(float(np.abs(out["point_quantiles"] - ref_probs).max()),
                float(np.abs(out["voxel_pred"] - ref_vox).max()))
    check(q_err <= PROB_TOL, f"quantile reply differs from the CPU pipeline by {q_err:.3g}")
    check(bool((out["uncertainty"] >= 0).all())
          and np.array_equal(out["point_probs"], out["point_quantiles"][1]),
          "quantile reply: uncertainty or median member wrong")
    print(f"[serve quantile] --model quantile: point_quantiles {out['point_quantiles'].shape}, "
          f"uncertainty max {float(out['uncertainty'].max()):.4f}, matches the CPU pipeline "
          f"(max|d| {q_err:.3g}), {wall_ms:.1f} ms, one replay of bucket 1's graph | launched "
          f"(warm-up and capture) {quant_counts}", flush=True)
    del quant, cpu_q
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="snt_chip_smoke_") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        write_dataset(tmp / "ts40k")
        data_s = time.perf_counter() - t0

        # ---- 10. main path: the train CLI with the defaults, the grid cache ------
        # device_cache auto picks the grid cache, as the JAX CLI does: K3 builds it
        # (64 samples a launch), then every step is one CUDA graph replay of the
        # gather, the cast, kernel synthesis, K2, the loss, K4, Adam and the counts
        out_dir = tmp / "out"
        ckpt_dir = out_dir / "ckpt"
        argv = ["--set", *DEFAULTS_SET, "--set", f"data_path={tmp / 'ts40k'}",
                f"max_epochs={TRAIN_EPOCHS}", "num_workers=4",
                f"output_dir={out_dir}", f"checkpoint_dir={ckpt_dir}"]
        n_train = N_FIT - int(N_FIT * 0.1)
        n_val = N_FIT - n_train
        steps = TRAIN_EPOCHS * (n_train // TRAIN_BATCH)
        eval_batches = TRAIN_EPOCHS * -(-n_val // TRAIN_BATCH) + -(-N_TEST // TRAIN_BATCH)
        cached_fits = []  # the Trainer of every cached fit the CLI runs
        run_cached = Trainer._run_cached_epochs

        def spy(self, *a, **kw):
            cached_fits.append(self)
            return run_cached(self, *a, **kw)

        Trainer._run_cached_epochs = spy
        from torch.profiler import ProfilerActivity, profile

        reset_counts()
        t0 = time.perf_counter()
        # traced, to read what the graph's replays ran on the card
        with profile(activities=[ProfilerActivity.CUDA]) as train_prof, \
                tee_stdout() as said:
            scores = train_cli.main(argv)
            torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        train_counts = read_counts()
        train_runs = kernel_runs(train_prof)
        fit_launches = cached_fits[0].cached_epochs.kernel_launches()
        check("[device_cache auto] -> 'grids'" in said.text,
              "the defaults did not pick the grid cache")
        check(len(cached_fits) == 1 and cached_fits[0].cached_epochs.runner.captured
              and cached_fits[0].cached_epochs.runner.replays == steps - GRAPH_WARMUP,
              f"the defaults' fit did not replay a captured step {steps - GRAPH_WARMUP} times")
        grid_graph = cached_fits[0].cached_epochs.runner
        losses = {k: v for k, v in scores.items() if k.endswith("loss")}
        check(set(losses) == {"train_loss", "val_loss", "test_loss"}, f"losses {losses}")
        check(all(math.isfinite(v) for v in losses.values()), f"non-finite loss {losses}")
        check(all(f"test_{m}" in scores for m in metrics.METRIC_NAMES), "test scores missing")
        check((ckpt_dir / "last.npz").exists(), "no last.npz")
        topk = sorted(f.name for f in ckpt_dir.glob("train_loss_step*.npz"))
        check(len(topk) >= 1, "no top-k checkpoint")
        trained = restore_checkpoint(str(ckpt_dir / "last.npz"),
                                     SceneNet.create(kernel_size=(9, 5, 5), seed=0))
        init = SceneNet.create(kernel_size=(9, 5, 5), seed=0)
        moved = {n for (n, a), b in zip(trained.state_dict().items(),
                                        init.state_dict().values()) if not torch.equal(a, b)}
        frozen = {n for n, p in init.named_parameters() if not p.requires_grad}
        # a scalar whose gradient underflows at this draw (an arrow cone
        # much thinner than a voxel) may stay put; frozen ones must
        check(not moved & frozen and len(moved) >= init.num_trainable_params() // 2,
              f"moved {sorted(moved)}, frozen {sorted(frozen)}")
        # run on the card: K3 once a 64-sample load of the cache and once an evaluation
        # batch; K2 once a step and an evaluation batch; K4 once a step. Launched by the
        # wrappers: the same, but of the steps only the eager ones and the capture's
        builds = -(-n_train // 64)
        launched = GRAPH_WARMUP + 1
        check(train_runs == {"points_binary": builds + eval_batches,
                             "stencil_conv": steps + eval_batches, "stencil_dk": steps},
              f"grid-cache training ran {train_runs} on the card: {builds} cache loads, "
              f"{steps} steps, {eval_batches} evaluation batches")
        check(train_counts["points_binary"] == builds + eval_batches
              and train_counts["stencil_conv"] == launched + eval_batches
              and train_counts["stencil_dk"] == launched,
              f"grid-cache training launched {train_counts}: {builds} cache loads, "
              f"{launched} steps launched, {eval_batches} evaluation batches")
        # the wrappers' counts plus what the replays ran: the launches that ran
        ran_as_traced(fit_launches, train_runs, "the grid fit's kernel_launches")
        print(f"[train] cli.train with the defaults (B={TRAIN_BATCH}, 64^3, {TRAIN_POINTS} "
              f"points, (9,5,5), geneo_tversky, device_cache auto -> 'grids'), {N_FIT}+{N_TEST} "
              f"synthetic crops (written in {data_s:.1f} s), {TRAIN_EPOCHS} epochs = {steps} "
              f"steps in {train_s:.1f} s (traced): {GRAPH_WARMUP} warm-up steps, then one "
              f"captured step replayed {grid_graph.replays} times | run on the card "
              f"{train_runs} | losses "
              + ", ".join(f"{k} {v:.6f}" for k, v in sorted(losses.items()))
              + f" | test_F1Score {scores['test_F1Score']:.4f} | {len(moved)} of "
              f"{init.num_trainable_params()} trainable parameters moved | checkpoints "
              f"last.npz + {topk} | launches {train_counts}", flush=True)

        # ---- 10b. the other routes: the point cache with augmentation, streaming ---
        route_runs = {}
        for tag, extra in (("points", ["device_cache=points", "augment=True"]),
                           ("streaming", ["device_cache=False"])):
            cached_fits.clear()
            reset_counts()
            t0 = time.perf_counter()
            with tee_stdout() as said:
                run_scores = train_cli.main(["--set", *DEFAULTS_SET, "--set",
                                             f"data_path={tmp / 'ts40k'}", "max_epochs=1",
                                             "num_workers=4", f"output_dir={tmp / tag}",
                                             f"checkpoint_dir={tmp / tag / 'ckpt'}", *extra])
                torch.cuda.synchronize()
            check("[loader] -> NativePointCloudLoader" in said.text,
                  f"{tag}: the train loader is not the native one")
            run_counts = read_counts()
            run_ran = ran(cached_fits)
            run_steps = n_train // TRAIN_BATCH
            check(all(math.isfinite(v) for k, v in run_scores.items() if k.endswith("loss")),
                  f"{tag}: losses {run_scores}")
            check(run_counts["stencil_dk"] == run_steps
                  and run_counts["points_binary"] >= run_steps,
                  f"{tag}: launches {run_counts}")
            check((tag == "points") == (len(cached_fits) == 1), f"{tag}: route")
            route_runs[tag] = (time.perf_counter() - t0, run_scores["train_loss"], run_counts,
                               run_ran)
        Trainer._run_cached_epochs = run_cached
        print("[train routes] cli.train 1 epoch: " + " | ".join(
            f"{tag}: {s:.1f} s, train_loss {loss:.6f}, launches {c}"
            for tag, (s, loss, c, _) in route_runs.items()), flush=True)

        # ---- 10c. a cached step replayed from the graph vs the same step streamed -
        ds = TS40K(str(tmp / "ts40k"), "fit", transform=PointPadding(max_points=TRAIN_POINTS,
                                                                            compute_indices=False))
        crit = resolve_criterion("geneo_tversky")(**load_config(
            None, train_cli.parse_overrides(DEFAULTS_SET)).criterion_params())
        prep = make_device_voxelize_prep(GRID, (TOWER,), use_indices=False)
        point_cache = DevicePointCache(ds, dev)
        grid_cache = DeviceGridCache(point_cache, prep)
        # 3 batches an epoch: fit_grid_cached (the warm-up steps, then the captured
        # step replayed) against the same batches in the same order through
        # train_step with the cached route's capturable optimizer: losses, counts
        # and parameters bit-identical
        three = DeviceGridCache.__new__(DeviceGridCache)
        three.x, three.y = grid_cache.x[:3 * TRAIN_BATCH], grid_cache.y[:3 * TRAIN_BATCH]

        def graph_twin(tag, make_model, criterion, epochs, **cfg):
            pair = {}
            for side in ("graph", "eager"):
                pair[side] = Trainer(make_model(), criterion, TrainConfig(
                    run_dir=str(tmp / f"twin_{tag}_{side}"), max_epochs=epochs,
                    checkpoint_dir=str(tmp / f"twin_ckpt_{tag}_{side}"),
                    early_stop_metric=None, **cfg))
            pair["graph"].fit_grid_cached(three, TRAIN_BATCH, augment=False,
                                          generator=torch.Generator(dev).manual_seed(3))
            eager = pair["eager"]
            eager.setup_optimizer(capturable=True)
            gen = torch.Generator(dev).manual_seed(3)
            losses, counts = [], []
            for _ in range(epochs):
                order = torch.randperm(3 * TRAIN_BATCH, generator=gen, device=dev)
                ms, loss_sum = metrics.init_metric_state(dev), torch.zeros((), device=dev)
                for b in range(3):
                    rows = order[b * TRAIN_BATCH:(b + 1) * TRAIN_BATCH]
                    ms, loss = eager.train_step(ms, three.x[rows].float(),
                                                three.y[rows].float())
                    loss_sum += loss
                losses.append(float(loss_sum) / 3)
                counts.append(metrics.metric_counts(ms))
            got = [json.loads(line)["train_loss"]
                   for line in open(tmp / f"twin_{tag}_graph" / "metrics.jsonl")]
            cached = pair["graph"].cached_epochs
            replays = [g.replays for g in (cached.runner, cached.accumulate_runner)
                       if g is not None]
            check(sum(replays) == 3 * epochs - GRAPH_WARMUP * len(replays),
                  f"graph vs eager, {tag}: replays {replays}")
            same = (got == losses and pair["graph"].train_counts == counts
                    and all(torch.equal(a, c) for a, c in zip(
                        pair["graph"].model.parameters(), eager.model.parameters())))
            check(same, f"graph vs eager, {tag}: losses {got} vs {losses}, counts "
                        f"{pair['graph'].train_counts} vs {counts}")
            return (f"{tag}: {3 * epochs} steps, replays {replays}, losses {got}, counts "
                    f"{counts}, bit-identical")

        def scenenet():
            return SceneNet.create(kernel_size=(9, 5, 5), seed=0, backend="cuda").to(dev)

        print(f"[train graph vs eager] fit_grid_cached, 3 steps an epoch ({GRAPH_WARMUP} eager "
              "warm-up steps, then the captured step replayed) vs the same batches through "
              "train_step: " + graph_twin("defaults", scenenet, crit, 2), flush=True)

        # ---- 10e. quantile training, bf16 and accumulation through the train CLI ----
        # each through device_cache auto -> 'grids', traced: a quantile step runs K2
        # and K4 once a member (Q = 3), bf16 the same kernels on the widened kernel
        Q = 3
        Trainer._run_cached_epochs = spy
        option_runs = {}
        for tag, extra, q, epochs in (
                ("quantile", ["model=quantile", "criterion=quantile_geneo"], Q, TRAIN_EPOCHS),
                ("bf16", ["precision=bf16"], 1, TRAIN_EPOCHS),
                ("accumulate", ["accumulate_grad_batches=2"], 1, 2 * TRAIN_EPOCHS)):
            cached_fits.clear()
            reset_counts()
            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CUDA]) as opt_prof, \
                    tee_stdout() as said:
                opt_scores = train_cli.main(["--set", *DEFAULTS_SET, "--set",
                                             f"data_path={tmp / 'ts40k'}",
                                             f"max_epochs={epochs}", "num_workers=4",
                                             f"output_dir={tmp / tag}",
                                             f"checkpoint_dir={tmp / tag / 'ckpt'}", *extra])
                torch.cuda.synchronize()
            opt_s = time.perf_counter() - t0
            opt_counts, opt_runs = read_counts(), kernel_runs(opt_prof)
            opt_ran = cached_fits[0].cached_epochs.kernel_launches()
            ran_as_traced(opt_ran, opt_runs, f"{tag}: kernel_launches")
            opt_steps = epochs * (n_train // TRAIN_BATCH)
            opt_eval = epochs * -(-n_val // TRAIN_BATCH) + -(-N_TEST // TRAIN_BATCH)
            check("[device_cache auto] -> 'grids'" in said.text, f"{tag}: not the grid cache")
            check(all(math.isfinite(v) for k, v in opt_scores.items() if k.endswith("loss")),
                  f"{tag}: losses {opt_scores}")
            cached = cached_fits[0].cached_epochs
            graphs = [cached.runner] + ([cached.accumulate_runner]
                                        if cached.accumulate_runner is not None else [])
            check(all(g.captured for g in graphs)
                  and sum(g.replays for g in graphs) == opt_steps - GRAPH_WARMUP * len(graphs),
                  f"{tag}: {len(graphs)} graphs replayed "
                  f"{[g.replays for g in graphs]} times in {opt_steps} steps")
            # run on the card, read from the trace: K2 once a member a step and an
            # evaluation batch, K4 once a member a step, K3 once a cache load and an
            # evaluation batch; launched by the wrappers: the eager steps' and each
            # capture's only
            check(opt_runs == {"points_binary": builds + opt_eval,
                               "stencil_conv": q * (opt_steps + opt_eval),
                               "stencil_dk": q * opt_steps},
                  f"{tag}: ran {opt_runs} on the card in {opt_steps} steps and {opt_eval} "
                  "evaluation batches")
            launched = (GRAPH_WARMUP + 1) * len(graphs)
            check(opt_counts["stencil_conv"] == q * (launched + opt_eval)
                  and opt_counts["stencil_dk"] == q * launched,
                  f"{tag}: launched {opt_counts}")
            option_runs[tag] = (opt_s, opt_steps, opt_scores["train_loss"],
                                opt_scores["test_loss"], opt_runs, opt_counts,
                                [g.replays for g in graphs], opt_ran)
        Trainer._run_cached_epochs = run_cached
        print("[train options] cli.train with the defaults and, each through device_cache "
              "auto -> 'grids': " + " | ".join(
                  f"{tag} ({s:.1f} s, {n} steps, graphs replayed {r}): train_loss "
                  f"{tl:.6f}, test_loss {te:.6f}, run on the card {ru}, launched {c}"
                  for tag, (s, n, tl, te, ru, c, r, _) in option_runs.items())
              + " (model=quantile criterion=quantile_geneo, 3 members: K2 and K4 three "
              "times a step; precision=bf16; accumulate_grad_batches=2: two graphs)",
              flush=True)

        # the same options' cached steps replayed from their graphs against eager steps
        qcrit = resolve_criterion("quantile_geneo")(quantiles=(0.1, 0.5, 0.9), **load_config(
            None, train_cli.parse_overrides(DEFAULTS_SET)).criterion_params())
        twin_parts = [
            graph_twin("quantile", lambda: QuantileSceneNet.create(
                kernel_size=(9, 5, 5), seed=0, backend="cuda").to(dev), qcrit, 2),
            graph_twin("accumulate 2", scenenet, crit, 4, accumulate_grad_batches=2),
            graph_twin("bf16", scenenet, crit, 2, precision="bf16"),
        ]
        print(f"[train options graph vs eager] fit_grid_cached, 3 steps an epoch "
              f"({GRAPH_WARMUP} eager warm-up steps a graph, then replays) vs the same "
              "batches through train_step: " + " | ".join(twin_parts), flush=True)
        del three

        # ---- 10d. the train step by route: streaming, point cache, grid cache -----
        # at least 16 steps an epoch: the 51 training crops repeated to 256 samples
        reps = torch.arange(ROUTE_SAMPLES, device=dev) % len(point_cache)
        point_cache.points, point_cache.labels, point_cache.mask = (
            a.index_select(0, reps) for a in (point_cache.points, point_cache.labels,
                                              point_cache.mask))
        grid_cache.x, grid_cache.y = (a.index_select(0, reps) for a in (grid_cache.x,
                                                                         grid_cache.y))
        route_steps = ROUTE_SAMPLES // TRAIN_BATCH
        route_trainers = {}
        # the defaults' model by every route; the quantile ensemble (3 members) and
        # precision bf16 by the two cached routes
        for tag in ("streaming", "points", "grids", "points quantile", "grids quantile",
                    "points bf16", "grids bf16"):
            route, _, option = tag.partition(" ")
            if option == "quantile":
                net, c = QuantileSceneNet.create(kernel_size=(9, 5, 5), seed=0,
                                                 backend="cuda").to(dev), qcrit
            else:
                net, c = SceneNet.create(kernel_size=(9, 5, 5), seed=0, backend="cuda").to(dev), crit
            t = Trainer(net, c, TrainConfig(run_dir=str(tmp / f"route_{tag}"),
                                            checkpoint_dir=str(tmp / f"route_c_{tag}"),
                                            max_epochs=1, early_stop_metric=None,
                                            precision="bf16" if option == "bf16" else "f32"),
                        batch_prep=prep if route != "grids" else None)
            if route == "points":  # the configuration auto sends to the point cache
                t.fit_cached(point_cache, TRAIN_BATCH, augment=True,
                             generator=torch.Generator(dev).manual_seed(0))
            elif route == "grids":  # the defaults
                t.fit_grid_cached(grid_cache, TRAIN_BATCH, augment=False,
                                  generator=torch.Generator(dev).manual_seed(0))
            else:
                t.setup_optimizer()
            route_trainers[tag] = t
        stream_ds = Subset(ds, [i % n_train for i in range(ROUTE_SAMPLES)])
        stream_loader = PointCloudLoader(stream_ds, TRAIN_BATCH, shuffle=True, num_workers=4,
                                         seed=0, drop_last=True)

        # the native loader over the same samples: the C++ loader's batches, K3 in the step
        native_loader = NativePointCloudLoader(stream_ds, TRAIN_BATCH, shuffle=True,
                                               max_points=TRAIN_POINTS, threads=4, seed=0,
                                               drop_last=True)

        def streamed_epoch(loader=stream_loader):
            t = route_trainers["streaming"]
            ms = metrics.init_metric_state(dev)
            for batch in loader:
                ms, _ = t.train_step(ms, *t.to_device(batch))
            metrics.metric_counts(ms)

        # host samples a second of each loader alone, in turns (4 workers / threads)
        loader_sps = {"python": [], "native": []}
        for r in range(4):
            for tag, ld in ((("python", stream_loader), ("native", native_loader)) if r % 2 == 0
                            else (("native", native_loader), ("python", stream_loader))):
                t0 = time.perf_counter()
                n_seen = sum(len(b[0]) for b in ld)
                loader_sps[tag].append(n_seen / (time.perf_counter() - t0))
        print(f"[timing] host loader alone, {ROUTE_SAMPLES} samples of 40k-70k points padded to "
              f"{TRAIN_POINTS}, batch {TRAIN_BATCH}, 4 workers/threads, "
              f"{os.cpu_count()} host cores: samples/s median of 4 alternating epochs [min-max]: "
              + ", ".join(f"{k} {np.median(v):.1f} [{min(v):.1f}-{max(v):.1f}]"
                          for k, v in loader_sps.items())
              + " (python: PointCloudLoader + PointPadding(compute_indices=False); native: "
              "NativePointCloudLoader)", flush=True)

        epoch_fns = {"streaming": streamed_epoch,
                     "streaming native": lambda: streamed_epoch(native_loader)}
        epoch_fns.update((tag, t.cached_epochs.run_epoch) for tag, t in route_trainers.items()
                         if tag != "streaming")
        epoch_fns["streaming"]()  # the loaders' first epochs
        epoch_fns["streaming native"]()
        route_ms = {k: [] for k in epoch_fns}
        for r in range(4):
            for tag, fn in (epoch_fns.items() if r % 2 == 0 else list(epoch_fns.items())[::-1]):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                route_ms[tag].append((time.perf_counter() - t0) * 1e3 / route_steps)
        route_step_ms = {k: float(np.median(v)) for k, v in route_ms.items()}
        print(f"[timing] train step by cache route, defaults width (B={TRAIN_BATCH}, 64^3, "
              f"{TRAIN_POINTS} points, (9,5,5), geneo_tversky, adam), epochs of {route_steps} "
              f"steps ({ROUTE_SAMPLES} samples), {smi}: ms a step, median of 4 epochs in "
              f"alternating order [min-max]: " + ", ".join(
                  f"{k} {route_step_ms[k]:.3f} [{min(v):.3f}-{max(v):.3f}]"
                  for k, v in route_ms.items())
              + " (streaming: the Python loader, 4 workers; streaming native: the native "
              "loader, 4 threads; both K3 in the step; points: augment=True, K3 in the "
              "step; grids: augment=False, the defaults; quantile: model=quantile, 3 members, "
              "quantile_geneo; bf16: precision=bf16)", flush=True)
        if opts.profile:
            for tag, fn in epoch_fns.items():
                calls = {}
                wall, busy_us, n_items, largest, _ = profiled(fn, calls)
                host = sum(v for k, v in calls.items() if k in HOST_LAUNCH_CALLS)
                print(f"[profile] train epoch by route, {tag} ({smi}): {route_steps} steps in "
                      f"{wall * 1e3:.1f} ms wall, device busy {busy_us / 1e3:.3f} ms = idle "
                      f"share {1 - busy_us / 1e6 / wall:.4f}, {n_items / route_steps:.1f} device "
                      f"items a step, {host / route_steps:.1f} host launch calls a step "
                      f"({', '.join(f'{k} {v}' for k, v in calls.items() if v)}); largest: "
                      f"{largest}", flush=True)
        del route_trainers, epoch_fns, point_cache, grid_cache
        torch.cuda.empty_cache()

        # ---- 11. train parity: cuda backend vs plain backend ---------------
        loader = PointCloudLoader(ds, TRAIN_BATCH, shuffle=True, num_workers=4, seed=0,
                                  drop_last=True)
        batches = list(loader)[:3]
        trainers = {}
        for backend in ("cuda", "torch"):
            net = SceneNet.create(kernel_size=(9, 5, 5), seed=0, backend=backend).to(dev)
            trainers[backend] = Trainer(net, crit, TrainConfig(
                run_dir=str(tmp / f"parity_{backend}"),
                checkpoint_dir=str(tmp / f"parity_ckpt_{backend}")), batch_prep=prep)
            trainers[backend].setup_optimizer()
        parts, max_dloss, band_total = [], 0.0, 0
        reset_counts()
        for i, b in enumerate(batches):
            dbatch = trainers["cuda"].to_device(b)
            x, _ = prep(*dbatch)
            with torch.no_grad():
                p_plain = trainers["torch"].model(x)
            band = int(((p_plain - TAU).abs() <= PROB_TOL).sum())
            res = {k: t.train_step(metrics.init_metric_state(dev), *dbatch)
                   for k, t in trainers.items()}
            lc, lt = float(res["cuda"][1]), float(res["torch"][1])
            cc, ct = (metrics.metric_counts(res[k][0]) for k in ("cuda", "torch"))
            check(abs(lc - lt) <= 1e-4 * abs(lt), f"step {i}: loss {lc} vs {lt}")
            dcount = sum(abs(a - c) for a, c in zip(cc, ct))
            check(dcount <= 2 * band, f"step {i}: counts {cc} vs {ct}, {band} voxels in "
                                      "the 1e-5 band of tau")
            max_dloss = max(max_dloss, abs(lc - lt) / abs(lt))
            band_total += band
            parts.append(f"step {i}: loss {lc:.7f} / {lt:.7f}, counts {cc} / {ct}")
        parity_counts = read_counts()
        check(parity_counts["stencil_conv"] == parity_counts["stencil_dk"] == len(batches),
              f"parity: the cuda backend's kernels launched {parity_counts}")
        pmax = 0.0
        for (n, a), c in zip(trainers["cuda"].model.named_parameters(),
                             trainers["torch"].model.parameters()):
            d = float((a - c).detach().abs())
            check(d <= 1e-5, f"parameter {n} differs by {d:.3g} after 3 steps")
            pmax = max(pmax, d)
        print(f"[train parity] 3 steps, cuda vs torch backend (cuDNN, TF32 off): max "
              f"rel|dloss| {max_dloss:.3g}, max|dparam| {pmax:.3g}, voxels within 1e-5 "
              f"of tau {band_total} | launches {parity_counts} | " + " | ".join(parts), flush=True)

        # ---- 12. train step timing -----------------------------------------
        dbatch = trainers["cuda"].to_device(batches[0])
        ms = {k: metrics.init_metric_state(dev) for k in trainers}
        step_t = paired_ms(lambda: trainers["cuda"].train_step(ms["cuda"], *dbatch),
                           lambda: trainers["torch"].train_step(ms["torch"], *dbatch),
                           iters=5)
        print(f"[timing] train step B={TRAIN_BATCH} 64^3 N={TRAIN_POINTS} (9,5,5) "
              f"geneo_tversky adam ({smi}), median of 4 alternating rounds [min-max] "
              f"ms/step: " + fmt_times({"backend cuda vs torch": step_t}), flush=True)
        del trainers, dbatch

        # ---- 13. main path: host-exact training, cli.train --host-indices ------
        def train_run(tag, extra, host_indices):
            """One epoch through the train CLI; the scores, the seconds and the
            launch counts of that run alone."""
            run_argv = ((["--host-indices"] if host_indices else [])
                        + ["--set", *DEFAULTS_SET, "--set", "max_epochs=1", "device_cache=False",
                           "num_workers=4", f"output_dir={tmp / tag}",
                           f"checkpoint_dir={tmp / tag / 'ckpt'}", *extra])
            reset_counts()
            t0 = time.perf_counter()
            run_scores = train_cli.main(run_argv)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            run_counts = read_counts()
            run_losses = {k: v for k, v in run_scores.items() if k.endswith("loss")}
            check(set(run_losses) == {"train_loss", "val_loss", "test_loss"}
                  and all(math.isfinite(v) for v in run_losses.values()),
                  f"{tag}: losses {run_losses}")
            check((tmp / tag / "ckpt" / "last.npz").exists(), f"{tag}: no last.npz")
            return run_scores, run_losses, seconds, run_counts

        def only(counts, used, steps, tag):
            """The histogram kernel ``used`` ran every step and the other
            histogram kernels of a train step never; K2 and K4 ran."""
            check(counts[used] >= steps, f"{tag}: {used} launched {counts[used]} times in "
                                         f"{steps} steps")
            for k in ("points_binary", "points_bin_counts", "bin_counts", "sorted_bin_counts",
                      "points_occupancy", "flat_ids"):
                check(k == used or counts[k] == 0, f"{tag}: {k} launched {counts[k]} times")
            check(counts["stencil_dk"] == steps and counts["stencil_conv"] >= steps,
                  f"{tag}: stencil kernels launched {counts}")

        host_steps = n_train // TRAIN_BATCH
        _, host_losses, host_s, host_counts = train_run(
            "host_exact", [f"data_path={tmp / 'ts40k'}"], host_indices=True)
        only(host_counts, "bin_counts", host_steps, "host-exact training")
        print(f"[train host-exact] cli.train --host-indices, defaults width (B={TRAIN_BATCH}, "
              f"64^3, {TRAIN_POINTS} points): float64 bin indices from the loader, counted by "
              f"K7; 1 epoch = {host_steps} steps in {host_s:.1f} s | losses "
              + ", ".join(f"{k} {v:.6f}" for k, v in sorted(host_losses.items()))
              + f" | launches {host_counts}", flush=True)

        # ---- 13b. the host data layer: LAS tiles -> cli.build_samples -> cli.train -----
        # the ETL as its users run it, then the train CLI on its crops at the defaults'
        # width through the three routes of the reference's CLI; then SemanticKITTI
        from scenenet_tpu_torch.data.las import write_las

        t0 = time.perf_counter()
        n_las = write_las_tiles(tmp / "las", write_las)
        las_s = time.perf_counter() - t0
        etl_cmd = [sys.executable, "-m", "scenenet_tpu_torch.cli.build_samples", "ts40k",
                   "--las-dir", str(tmp / "las"), "--out", str(tmp / "etl"),
                   "--test-split", str(ETL_TEST_SPLIT)]
        t0 = time.perf_counter()
        etl = subprocess.run(etl_cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
        etl_s = time.perf_counter() - t0
        check(etl.returncode == 0, f"build_samples ts40k failed:\n{etl.stderr[-3000:]}")
        n_crops = ETL_TILES * ETL_TOWERS
        etl_fit = sorted((tmp / "etl" / "fit").glob("sample_*.npy"))
        etl_test = sorted((tmp / "etl" / "test").glob("sample_*.npy"))
        check(f"wrote {n_crops} ts40k samples" in etl.stdout
              and len(etl_fit) + len(etl_test) == n_crops,
              f"build_samples: {etl.stdout.strip()} ({len(etl_fit)} fit, {len(etl_test)} test)")
        crop_sizes = [len(np.load(f, mmap_mode="r")) for f in etl_fit]
        towers_in = [int((np.load(f)[:, 3] == TOWER).sum()) for f in etl_fit[:4]]
        check(min(towers_in) >= ETL_TOWER_POINTS // 2, f"crops hold {towers_in} tower points")
        print(f"[etl] {ETL_TILES} LAS tiles of {ETL_TOWERS} towers ({n_las} points, written in "
              f"{las_s:.1f} s) -> python -m scenenet_tpu_torch.cli.build_samples ts40k "
              f"--test-split {ETL_TEST_SPLIT}: {len(etl_fit)} fit + {len(etl_test)} test crops "
              f"of {min(crop_sizes)}-{max(crop_sizes)} points in {etl_s:.2f} s = "
              f"{etl_s / ETL_TILES:.3f} s a tile (the interpreter's start included) | "
              f"{etl.stdout.strip()}", flush=True)

        etl_train = len(etl_fit) - int(len(etl_fit) * 0.1)
        etl_steps = etl_train // TRAIN_BATCH
        etl_evals = -(-(len(etl_fit) - etl_train) // TRAIN_BATCH) + -(-len(etl_test)
                                                                        // TRAIN_BATCH)
        etl_runs = {}
        for tag, extra, line in (
                ("etl_native", [], "[loader] -> NativePointCloudLoader"),
                ("etl_host_grids", ["device_voxelization=False"],
                 "[loader] -> VoxelLoader (device_voxelization=false"),
                ("etl_unet", ["model=unet", "device_cache=auto"],
                 "[loader] -> NativePointCloudLoader")):
            with tee_stdout() as said:
                _, losses_e, secs_e, counts_e = train_run(
                    tag, [f"data_path={tmp / 'etl'}", *extra], False)
            check(line in said.text, f"{tag}: the route line {line!r} was not printed")
            if tag == "etl_native":  # raw points from the C++ loader, K3, K2 and K4
                only(counts_e, "points_binary", etl_steps, tag)
            elif tag == "etl_host_grids":  # host grids: no voxelization on the card
                check(counts_e["stencil_dk"] == etl_steps
                      and counts_e["stencil_conv"] == etl_steps + etl_evals
                      and all(counts_e[k] == 0 for k in (
                          "points_occupancy", "points_binary", "bin_counts",
                          "sorted_bin_counts", "points_bin_counts", "flat_ids")),
                      f"{tag}: launches {counts_e}")
            else:  # the UNet streams through the native loader: K3 and K10
                check(counts_e["conv3d_mc"] == UNET_TRAIN_LAUNCHES * etl_steps
                      + UNET_EVAL_LAUNCHES * etl_evals
                      and counts_e["points_binary"] == etl_steps + etl_evals
                      and counts_e["stencil_conv"] == counts_e["stencil_dk"] == 0,
                      f"{tag}: launches {counts_e}")
            etl_runs[tag] = counts_e
            print(f"[train etl] cli.train on the ETL's crops, defaults width (B={TRAIN_BATCH}, "
                  f"64^3, {TRAIN_POINTS} points), {tag} ({' '.join(extra) or 'device_cache=False'}"
                  f"): {line}...; 1 epoch = {etl_steps} steps + {etl_evals} evaluation batches "
                  f"in {secs_e:.1f} s | losses "
                  + ", ".join(f"{k} {v:.6f}" for k, v in sorted(losses_e.items()))
                  + f" | launches {counts_e}", flush=True)

        write_kitti_sequence(tmp / "kitti")
        t0 = time.perf_counter()
        kt = subprocess.run([sys.executable, "-m", "scenenet_tpu_torch.cli.build_samples",
                             "semantic_kitti", "--dataset", str(tmp / "kitti"), "--out",
                             str(tmp / "kitti_crops")], cwd=ROOT, capture_output=True,
                            text=True, timeout=600)
        kitti_etl_s = time.perf_counter() - t0
        check(kt.returncode == 0, f"build_samples semantic_kitti failed:\n{kt.stderr[-3000:]}")
        n_poles = len(list((tmp / "kitti_crops" / "samples").glob("*.npy")))
        check(n_poles == KITTI_SCANS * KITTI_POLES, f"{n_poles} pole crops: {kt.stdout}")
        kitti_fit = n_poles // 5  # SemanticKITTICrops' train split: the first 20%
        kitti_val = int(kitti_fit * 0.25)
        kitti_steps = (kitti_fit - kitti_val) // KITTI_BATCH
        kitti_evals = (-(-kitti_val // KITTI_BATCH)
                       + -(-(n_poles - int(0.4 * n_poles)) // KITTI_BATCH))
        with tee_stdout() as said:
            _, kitti_losses, kitti_s, kitti_counts = train_run(
                "kitti", [f"data_path={tmp / 'kitti_crops'}", "dataset=semantic_kitti",
                          f"voxel_grid_size={KITTI_GRID}", f"max_points={KITTI_POINTS}",
                          f"batch_size={KITTI_BATCH}", "keep_labels=(80,)", "val_split=0.25"],
                False)
        check("[loader] -> NativePointCloudLoader" in said.text, "kitti: not the native loader")
        only(kitti_counts, "points_binary", kitti_steps, "kitti")
        check(kitti_counts["points_binary"] == kitti_steps + kitti_evals,
              f"kitti: launches {kitti_counts}")
        print(f"[train kitti] a synthetic SemanticKITTI sequence ({KITTI_SCANS} scans of "
              f"~120k points, {KITTI_POLES} poles each) -> python -m "
              f"scenenet_tpu_torch.cli.build_samples semantic_kitti: {n_poles} pole crops in "
              f"{kitti_etl_s:.2f} s -> cli.train --set dataset=semantic_kitti voxel_grid_size="
              f"{KITTI_GRID} keep_labels=(80,) batch_size={KITTI_BATCH} max_points="
              f"{KITTI_POINTS}: 1 epoch = {kitti_steps} steps + {kitti_evals} evaluation "
              f"batches in {kitti_s:.1f} s through the native loader | losses "
              + ", ".join(f"{k} {v:.6f}" for k, v in sorted(kitti_losses.items()))
              + f" | launches {kitti_counts}", flush=True)

        # ---- 14. main path: the 128^3 grid, both train routes and one request --
        write_dataset(tmp / "ts40k_big", seed=9, n_fit=BIG_FIT, n_test=BIG_TEST)
        big_steps = (BIG_FIT - int(BIG_FIT * 0.1)) // BIG_BATCH
        big_set = [f"data_path={tmp / 'ts40k_big'}", f"voxel_grid_size={BIG_GRID}",
                   f"batch_size={BIG_BATCH}", f"max_points={MAX_POINTS}"]
        big_counts, parts = {}, []
        for tag, host_indices in (("big_host", True), ("big_device", False)):
            _, big_losses, big_s, big_counts[tag] = train_run(tag, big_set, host_indices)
            only(big_counts[tag], "sorted_bin_counts", big_steps, tag)
            parts.append(f"{'--host-indices' if host_indices else 'bins on the card'}: "
                         f"{big_steps} steps in {big_s:.1f} s, losses "
                         + ", ".join(f"{k} {v:.6f}" for k, v in sorted(big_losses.items()))
                         + f", launches {big_counts[tag]}")
        print(f"[train 128^3] cli.train, voxel_grid_size {BIG_GRID}, B={BIG_BATCH}, "
              f"{MAX_POINTS} points, both through K8 | " + " | ".join(parts), flush=True)

        def route_step_ms(data, grid, n_pad, batch_size):
            """ms a train step from host-exact indices ('kernel') and from
            bins computed on the card ('plain'), in turns, on one batch."""
            pad = PointPadding(max_points=n_pad, vxg_size=grid, compute_indices=True)
            one = next(iter(PointCloudLoader(TS40K(str(tmp / data), "fit", transform=pad),
                                             batch_size, num_workers=4, drop_last=True)))
            pair = {}
            for use_indices in (True, False):
                model = SceneNet.create(kernel_size=(9, 5, 5), seed=0, backend="cuda").to(dev)
                pair[use_indices] = Trainer(model, crit, TrainConfig(
                    run_dir=str(tmp / f"route_{data}_{use_indices}"),
                    checkpoint_dir=str(tmp / f"route_ckpt_{data}_{use_indices}")),
                    batch_prep=make_device_voxelize_prep(grid, (TOWER,),
                                                         use_indices=use_indices))
                pair[use_indices].setup_optimizer()
            dbatch = pair[True].to_device(one)
            state = metrics.init_metric_state(dev)
            step_t = paired_ms(lambda: pair[True].train_step(state, *dbatch),
                               lambda: pair[False].train_step(state, *dbatch), iters=5)
            if opts.profile:
                n_prof = 5
                wall, busy_us, n_items, largest, _ = profiled(lambda: [
                    pair[False].train_step(state, *dbatch) for _ in range(n_prof)])
                print(f"[profile] train step, bins on the card, B={batch_size} grid {grid} "
                      f"N={n_pad} ({smi}): {n_prof} steps in {wall * 1e3:.1f} ms wall, device "
                      f"busy {busy_us / 1e3:.3f} ms = idle share {1 - busy_us / 1e6 / wall:.4f}, "
                      f"{n_items / n_prof:.1f} device items a step; largest: {largest}",
                      flush=True)
            return step_t

        route_t = {
            f"B={BIG_BATCH} 128^3 N={MAX_POINTS}: host indices (K8) vs bins on the card (K8)":
                route_step_ms("ts40k_big", BIG_GRID, MAX_POINTS, BIG_BATCH),
            f"B={TRAIN_BATCH} 64^3 N={TRAIN_POINTS}: host indices (K7) vs bins on the card (K3)":
                route_step_ms("ts40k", GRID, TRAIN_POINTS, TRAIN_BATCH)}
        print(f"[timing] train step by route, (9,5,5) geneo_tversky adam, backend cuda ({smi}), "
              "median of 4 alternating rounds [min-max] ms/step; 'kernel' = from host-exact "
              "indices, 'plain' = bins on the card: " + fmt_times(route_t), flush=True)

        reset_counts()
        server, big = build_server(["--grid", "128", "--port", "0"])
        cpu_big = _Pipeline(None, grid=BIG_GRID, device="cpu")
        with running(server, big) as url:
            big_built = big.kernel_launches()
            with profile(activities=[ProfilerActivity.CUDA]) as big_prof:
                status, out, wall_ms, server_ms = post(f"{url}/predict", clouds[0], TAU)
                torch.cuda.synchronize()
            big_serve_counts = read_counts()
            big_ran = {**big_serve_counts, **big.kernel_launches()}
        big_runs = kernel_runs(big_prof, SERVE_MARKS)
        check(status == 200, f"/predict at --grid 128 returned {status}")
        err = check_reply(out, clouds[0], cpu_big.predict(clouds[0]), PROB_TOL,
                          "serve --grid 128", grid=BIG_GRID)
        ran_as_traced({k: big_ran[k] - big_built[k] for k in big_built}, big_runs,
                      "the 128^3 request")
        check(big.graph_replays() == {1: 1} and big_runs["sorted_bin_counts"] >= 1
              and big_runs["stencil_conv"] == 1 and big_runs["points_occupancy"] == 0,
              f"the 128^3 request: replays {big.graph_replays()}, ran {big_runs}")
        check(big_serve_counts["sorted_bin_counts"] >= 1 and big_serve_counts["stencil_conv"] >= 1
              and big_serve_counts["points_occupancy"] == 0,
              f"the 128^3 server launched {big_serve_counts}")
        print(f"[serve 128^3] --grid 128: the reply matches the CPU pipeline (max|d| {err:.3g}), "
              f"{wall_ms:.1f}/{server_ms:.1f} ms wall/server, one replay of bucket 1's graph "
              f"(ran {big_runs}) | launched (warm-up and capture) {big_serve_counts}",
              flush=True)
        del big, cpu_big
        torch.cuda.empty_cache()

        # ---- 15. main path: the counts kernel under the Trainer, and the ids ---
        frac_prep = make_device_voxelize_prep(GRID, (TOWER,), binarize=(True, False),
                                              use_indices=False)
        net = SceneNet.create(kernel_size=(9, 5, 5), seed=0, backend="cuda").to(dev)
        frac = Trainer(net, crit, TrainConfig(run_dir=str(tmp / "frac"),
                                              checkpoint_dir=str(tmp / "frac_ckpt")),
                       batch_prep=frac_prep)
        frac.setup_optimizer()
        reset_counts()
        frac_losses = []
        for b in batches:
            _, loss = frac.train_step(metrics.init_metric_state(dev), *frac.to_device(b))
            frac_losses.append(float(loss))
        pts_b, lab_b, mask_b, _ = frac.to_device(batches[0])
        density = voxelize_batch_hist(pts_b, mask_b, GRID)
        ids = cuda_hist.flat_ids(pts_b, mask_b, GRID)
        torch.cuda.synchronize()
        counts_path = read_counts()
        check(all(math.isfinite(v) for v in frac_losses), f"tower-fraction losses {frac_losses}")
        check(counts_path["points_bin_counts"] == len(batches) + 1 and counts_path["flat_ids"] == 1
              and counts_path["points_binary"] == 0 and counts_path["stencil_dk"] == len(batches),
              f"the counts path launched {counts_path}")
        x_frac, y_frac = frac_prep(pts_b, lab_b, mask_b)
        x_bin, y_bin = prep(pts_b, lab_b, mask_b)
        check(torch.equal(x_frac, x_bin) and torch.equal((y_frac > 0).float(), y_bin)
              and 0 < float(y_frac[y_frac > 0].min()) < 1,
              "the tower-fraction prep disagrees with the binarized prep")
        check(torch.equal((density > 0).float()[:, None], x_bin) and float(density.max()) == 1,
              "voxelize_batch_hist > 0 is not the occupancy")
        same = ids.long()[mask_b] == batch_flat_ids(pts_b, mask_b, GRID)[mask_b]
        check(float(same.float().mean()) > 0.99, "flat_ids far from batch_flat_ids")
        print(f"[counts path] 3 train steps on a tower-fraction target (binarize=(True, False), "
              f"K6): losses " + ", ".join(f"{v:.6f}" for v in frac_losses)
              + f"; voxelize_batch_hist > 0 = the occupancy; flat_ids (K9, multiply recipe) "
              f"agrees with batch_flat_ids (divide) on {int(same.sum())} of {same.numel()} "
              f"points | launches {counts_path}", flush=True)
        del frac, density, ids

        # ---- 16. main path: UNet3D through the train CLI, every conv in K10 ------
        unet_steps = n_train // TRAIN_BATCH
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        unet_scores, unet_losses, unet_s, unet_counts = train_run(
            "unet", [f"data_path={tmp / 'ts40k'}", "model=unet", "device_cache=auto"], False)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        # 3 steps, one validation batch and one test batch
        check(unet_counts["conv3d_mc"] == UNET_TRAIN_LAUNCHES * unet_steps
              + UNET_EVAL_LAUNCHES * 2,
              f"unet: K10 launched {unet_counts['conv3d_mc']} times in {unet_steps} steps and "
              "2 evaluation batches")
        check(unet_counts["points_binary"] == unet_steps + 2
              and unet_counts["stencil_conv"] == unet_counts["stencil_dk"] == 0,
              f"unet: launches {unet_counts}")
        # the 18 convs' dw a step: the kernel, and its reduction where the plan splits
        dw_step = sum(1 + (cuda_conv_mc.conv3d_mc_dw_plan(TRAIN_BATCH, c, o, n, n, n)[1] > 1)
                      for c, o, n in UNET_CONVS)
        check(unet_counts["conv3d_mc_dw"] == dw_step * unet_steps,
              f"unet: K10's dw launched {unet_counts['conv3d_mc_dw']} times in {unet_steps} "
              f"steps, {dw_step} a step planned")
        check(all(f"test_{m}" in unet_scores for m in metrics.METRIC_NAMES), "unet test scores")
        best_ckpt = sorted((tmp / "unet" / "ckpt").glob("train_FBetaScore_step*.npz"))
        check(len(best_ckpt) >= 1, "unet: no best checkpoint")
        unet = restore_checkpoint(str(best_ckpt[0]), UNet3D.create(seed=1, backend="cuda")).to(dev)
        fresh = UNet3D.create(seed=0)
        check(float((unet.down0.bn0.mean.cpu() - fresh.down0.bn0.mean).abs().max()) > 0
              and not torch.equal(unet.up3.conv1.cpu(), fresh.up3.conv1),
              "unet: the checkpoint holds the initial weights or statistics")
        with torch.no_grad():
            probs = unet.eval()(prep(*(torch.as_tensor(a).to(dev) for a in batches[0]))[0])
        check(bool(torch.isfinite(probs).all()) and 0 <= float(probs.min())
              and float(probs.max()) <= 1 and tuple(probs.shape) == (TRAIN_BATCH, 1, 64, 64, 64),
              "unet: restored model's prediction")
        print(f"[train unet] cli.train model=unet, defaults width (B={TRAIN_BATCH}, 64^3, "
              f"{TRAIN_POINTS} points, ladder 32-64-128-256-256, geneo_tversky, adam), 1 epoch = "
              f"{unet_steps} steps + 1 validation + 1 test batch in {unet_s:.1f} s | losses "
              + ", ".join(f"{k} {v:.6f}" for k, v in sorted(unet_losses.items()))
              + f" | test_F1Score {unet_scores['test_F1Score']:.4f} | best checkpoint "
              f"{best_ckpt[0].name} restored, probabilities in [{float(probs.min()):.4f}, "
              f"{float(probs.max()):.4f}] | peak device memory {peak_gb:.2f} GB | launches "
              f"{unet_counts}", flush=True)
        del unet, probs

        # ---- 16a. main path: nnU-Net's 3d_fullres network through the train CLI at 128^3,
        # batch 2: its 17 stride-1 convs in K10 (forward, dx, dw), the strided and transposed
        # convs and the norm through their library wrappers, K8 in the prep
        nn_steps = n_train // NNUNET_BATCH
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        nn_scores, nn_losses, nn_s, nn_counts = train_run(
            "nnunet", [f"data_path={tmp / 'ts40k'}", "model=nnunet",
                       "voxel_grid_size=(128, 128, 128)", f"batch_size={NNUNET_BATCH}"], False)
        nn_peak_gb = torch.cuda.max_memory_allocated() / 1e9
        # a train step: each conv's forward, the dx of all but the first, the dw; an
        # evaluation batch the forward alone (5 strided convs a forward)
        nn_eval = nn_counts["conv3d_strided"] // len(NNUNET_STRIDED) - nn_steps
        nn_dw = sum(1 + (cuda_conv_mc.conv3d_mc_dw_plan(NNUNET_BATCH, c, o, n, n, n)[1] > 1)
                    for c, o, n in NNUNET_CONVS)
        check(nn_eval >= 2 and nn_counts["conv3d_strided"] == nn_counts["conv_transpose3d_k2"]
              == len(NNUNET_STRIDED) * (nn_steps + nn_eval)
              and nn_counts["instance_norm_lrelu"] == 22 * (nn_steps + nn_eval)
              and nn_counts["conv3d_mc"] == (2 * len(NNUNET_CONVS) - 1) * nn_steps
              + len(NNUNET_CONVS) * nn_eval
              and nn_counts["conv3d_mc_dw"] == nn_dw * nn_steps
              and nn_counts["sorted_bin_counts"] >= nn_steps,
              f"nnunet: launches {nn_counts} in {nn_steps} steps")
        nn_ckpt = sorted((tmp / "nnunet" / "ckpt").glob("train_FBetaScore_step*.npz"))
        check(len(nn_ckpt) >= 1, "nnunet: no best checkpoint")
        nnunet = restore_checkpoint(str(nn_ckpt[0]),
                                    NNUNet3D.create(seed=1, backend="cuda")).to(dev).eval()
        nn_init = NNUNet3D.create(seed=0).state_dict()
        check(any(not torch.equal(v.cpu(), nn_init[k]) for k, v in nnunet.state_dict().items()),
              "nnunet: the checkpoint holds the initial weights")
        x_nn = (torch.rand((1, 1, 128, 128, 128), device=dev,
                           generator=torch.Generator(dev).manual_seed(23)) < 0.05).float()
        with torch.no_grad():
            probs = nnunet(x_nn)
        check(bool(torch.isfinite(probs).all()) and 0 <= float(probs.min())
              and float(probs.max()) <= 1 and tuple(probs.shape) == (1, 1, 128, 128, 128),
              "nnunet: restored model's prediction")
        print(f"[train nnunet] cli.train model=nnunet voxel_grid_size=(128, 128, 128) "
              f"batch_size={NNUNET_BATCH} (32-64-128-256-320-320, five heads, geneo_tversky "
              f"under deep supervision, adam), 1 epoch = {nn_steps} steps + {nn_eval} "
              f"evaluation batches in {nn_s:.1f} s | losses "
              + ", ".join(f"{k} {v:.6f}" for k, v in sorted(nn_losses.items()))
              + f" | best checkpoint {nn_ckpt[0].name} restored, probabilities in "
              f"[{float(probs.min()):.4f}, {float(probs.max()):.4f}] | peak device memory "
              f"{nn_peak_gb:.2f} GB | launches {nn_counts}", flush=True)
        del nnunet, probs, x_nn

        # ---- 16b. main path: the bf16 UNet through the train CLI, every conv in K10's
        # bf16 form (the 1 -> 32 layer too), dw by cuDNN in bf16
        unet16_scores, unet16_losses, unet16_s, unet16_counts = train_run(
            "unet_bf16", [f"data_path={tmp / 'ts40k'}", "model=unet", "precision=bf16",
                          "device_cache=auto"], False)
        check(unet16_counts["conv3d_mc_bf16"] == UNET_TRAIN_LAUNCHES * unet_steps
              + UNET_EVAL_LAUNCHES * 2 and unet16_counts["conv3d_mc"] == 0,
              f"unet bf16: K10 launched {unet16_counts} in {unet_steps} steps and 2 "
              "evaluation batches")
        check(all(math.isfinite(v) for v in unet16_losses.values()),
              f"unet bf16: losses {unet16_losses}")
        print(f"[train unet bf16] cli.train model=unet precision=bf16, defaults width (B="
              f"{TRAIN_BATCH}, 64^3): 1 epoch = {unet_steps} steps + 1 validation + 1 test "
              f"batch in {unet16_s:.1f} s | losses "
              + ", ".join(f"{k} {v:.6f}" for k, v in sorted(unet16_losses.items()))
              + f" (f32: " + ", ".join(f"{k} {v:.6f}" for k, v in sorted(unet_losses.items()))
              + f") | launches {unet16_counts}", flush=True)

        # ---- 17. UNet train parity and step time: K10 backend vs plain backend ---
        unets = {}
        for backend in ("cuda", "torch"):
            unets[backend] = Trainer(UNet3D.create(seed=0, backend=backend).to(dev), crit,
                                     TrainConfig(run_dir=str(tmp / f"unet_{backend}"),
                                                 checkpoint_dir=str(tmp / f"unet_ckpt_{backend}")),
                                     batch_prep=prep)
            unets[backend].setup_optimizer()
        parts, max_dloss = [], 0.0
        reset_counts()
        for i, b in enumerate(batches):
            dbatch = unets["cuda"].to_device(b)
            res = {k: t.train_step(metrics.init_metric_state(dev), *dbatch)
                   for k, t in unets.items()}
            lc, lt = float(res["cuda"][1]), float(res["torch"][1])
            check(math.isfinite(lc) and abs(lc - lt) <= UNET_LOSS_RTOL * abs(lt),
                  f"unet step {i}: loss {lc} vs {lt}")
            max_dloss = max(max_dloss, abs(lc - lt) / abs(lt))
            parts.append(f"step {i}: loss {lc:.7f} / {lt:.7f}")
        unet_parity_counts = read_counts()
        check(unet_parity_counts["conv3d_mc"] == UNET_TRAIN_LAUNCHES * len(batches),
              f"unet parity: K10 launched {unet_parity_counts['conv3d_mc']} times")
        stats_err, stats_at = max(
            (float(((a - c).abs() / (1 + c.abs())).max()), n) for (n, a), c in zip(
                unets["cuda"].model.named_buffers(), unets["torch"].model.buffers()))
        check(stats_err <= UNET_STATS_TOL, f"unet: running statistics differ by {stats_err:.3g}")
        print(f"[train unet parity] 3 steps, backend cuda (K10) vs torch (cuDNN, TF32 off) from "
              f"the same weights: max rel|dloss| {max_dloss:.3g} (limit {UNET_LOSS_RTOL}), "
              f"max|d running statistics|/(1 + |s|) {stats_err:.3g} (at {stats_at}; limit {UNET_STATS_TOL}) | "
              + " | ".join(parts), flush=True)
        dbatch = unets["cuda"].to_device(batches[0])
        ms = {k: metrics.init_metric_state(dev) for k in unets}
        unet_step_t = paired_ms(lambda: unets["cuda"].train_step(ms["cuda"], *dbatch),
                                lambda: unets["torch"].train_step(ms["torch"], *dbatch),
                                iters=2, warmup=1)
        print(f"[timing] UNet3D train step B={TRAIN_BATCH} 64^3 N={TRAIN_POINTS} geneo_tversky "
              f"adam ({smi}), median of 4 alternating rounds [min-max] ms/step: "
              + fmt_times({"backend cuda (K10 forward, dx and dw) vs torch": unet_step_t}),
              flush=True)
        # the bf16 UNet (K10's bf16 form, cuDNN's bf16 dw) beside the f32 one: 3 steps
        # from the same weights within the JAX package's bf16 budget (loss rtol 5e-2),
        # then the step times in turns
        unet16 = Trainer(UNet3D.create(seed=0, backend="cuda", dtype=torch.bfloat16).to(dev),
                         crit, TrainConfig(run_dir=str(tmp / "unet_bf16_step"),
                                           checkpoint_dir=str(tmp / "unet_bf16_step_ckpt"),
                                           precision="bf16"), batch_prep=prep)
        unet16.setup_optimizer()
        unet32 = Trainer(UNet3D.create(seed=0, backend="cuda").to(dev), crit,
                         TrainConfig(run_dir=str(tmp / "unet_f32_step"),
                                     checkpoint_dir=str(tmp / "unet_f32_step_ckpt")),
                         batch_prep=prep)
        unet32.setup_optimizer()
        bf16_parts = []
        for i, b in enumerate(batches):
            db = unet16.to_device(b)
            l16 = float(unet16.train_step(metrics.init_metric_state(dev), *db)[1])
            l32 = float(unet32.train_step(metrics.init_metric_state(dev), *db)[1])
            check(math.isfinite(l16) and abs(l16 - l32) <= 5e-2 * abs(l32),
                  f"unet bf16 step {i}: loss {l16} vs f32 {l32}")
            bf16_parts.append(f"step {i}: loss bf16 {l16:.6f} / f32 {l32:.6f}")
        ms16 = metrics.init_metric_state(dev)
        unet16_step_t = paired_ms(lambda: unet16.train_step(ms16, *dbatch),
                                  lambda: unets["cuda"].train_step(ms["cuda"], *dbatch),
                                  iters=2, warmup=1)
        print(f"[timing] UNet3D train step bf16 (K10's bf16 form, dw cuDNN bf16) vs f32 "
              f"(K10 f32) B={TRAIN_BATCH} 64^3 ({smi}), median of 4 alternating rounds "
              f"[min-max] ms/step: bf16 {unet16_step_t['ms']:.4f} [{unet16_step_t['range'][0]:.4f}-"
              f"{unet16_step_t['range'][1]:.4f}] vs f32 {unet16_step_t['plain_ms']:.4f} "
              f"[{unet16_step_t['plain_range'][0]:.4f}-{unet16_step_t['plain_range'][1]:.4f}] | "
              + " | ".join(bf16_parts), flush=True)
        if opts.profile:
            n_prof = 3
            wall, busy_us, n_items, largest, by_name = profiled(lambda: [
                unet16.train_step(ms16, *dbatch) for _ in range(n_prof)])
            # K10's bf16 form: its tensor-core kernel, weight packing and K-split
            # reduction, and the FMA kernel's bf16 form (the 1->32 layer)
            k10_us = sum(v for k, v in by_name.items() if "conv3d_mc_" in k)
            k10_tc_us = sum(v for k, v in by_name.items() if "conv3d_mc_tc_bf16_kernel" in k)
            dw_us = by_name.get("aten::convolution_backward", 0.0)
            print(f"[profile] UNet3D train step bf16, backend cuda, B={TRAIN_BATCH} 64^3 ({smi}): "
                  f"{n_prof} steps in {wall * 1e3:.1f} ms wall, device busy {busy_us / 1e3:.3f} "
                  f"ms = idle share {1 - busy_us / 1e6 / wall:.4f}, {n_items / n_prof:.1f} "
                  f"device items a step; K10's bf16 form {k10_us / busy_us:.4f} of the device "
                  f"time ({k10_us / 1e3 / n_prof:.3f} ms a step; its tensor-core kernel "
                  f"{k10_tc_us / busy_us:.4f}), the weight gradients "
                  f"(aten::convolution_backward) {dw_us / busy_us:.4f}; largest: {largest}",
                  flush=True)
        del unet16, unet32
        if opts.profile:
            n_prof = 3
            wall, busy_us, n_items, largest, by_name = profiled(lambda: [
                unets["cuda"].train_step(ms["cuda"], *dbatch) for _ in range(n_prof)])
            k10_us = sum(v for k, v in by_name.items() if "conv3d_mc_" in k)
            dw_us = by_name.get("aten::convolution_backward", 0.0)
            print(f"[profile] UNet3D train step, backend cuda, B={TRAIN_BATCH} 64^3 ({smi}): "
                  f"{n_prof} steps in {wall * 1e3:.1f} ms wall, device busy {busy_us / 1e3:.3f} "
                  f"ms = idle share {1 - busy_us / 1e6 / wall:.4f}, {n_items / n_prof:.1f} "
                  f"device items a step; K10 {k10_us / busy_us:.4f} of the device time, the "
                  f"library's weight gradients (aten::convolution_backward) "
                  f"{dw_us / busy_us:.4f}; largest: {largest}", flush=True)
        del unets, dbatch, batches
        torch.cuda.empty_cache()

        # ---- 18. main path: CnnBaseline with a (3,3,3) kernel through K10 --------
        _, cnn_losses, cnn_s, cnn_counts = train_run(
            "cnn", [f"data_path={tmp / 'ts40k'}", "model=cnn", "kernel_size=(3, 3, 3)"], False)
        # two convs forward, dx of the second alone; two convs an evaluation batch
        check(cnn_counts["conv3d_mc"] == 3 * unet_steps + 2 * 2,
              f"cnn: K10 launched {cnn_counts['conv3d_mc']} times")
        print(f"[train cnn] cli.train model=cnn kernel_size=(3,3,3): 1 epoch = {unet_steps} "
              f"steps in {cnn_s:.1f} s | losses "
              + ", ".join(f"{k} {v:.6f}" for k, v in sorted(cnn_losses.items()))
              + f" | launches {cnn_counts}", flush=True)

        # ---- 19. A7: experiments/admm.yaml's keys through the train CLI ----------
        # ADMM with L-BFGS on the streaming loader (the native one), every step eager:
        # K3 a step, K2 and K4 an evaluation (the step's own and each linesearch trial)
        from scenenet_tpu_torch.train import loop as loop_mod
        from scenenet_tpu_torch.train.admm import ADMMConfig, ADMMTrainer
        from scenenet_tpu_torch.train.lbfgs import LBFGS
        from scenenet_tpu_torch.train.preempt import request_preemption
        from scenenet_tpu_torch.train.tune import autotune_backend, find_max_batch_size

        admm_runs = []
        admm_fit = ADMMTrainer.fit

        def admm_spy(self, *a, **kw):
            admm_runs.append(self)
            return admm_fit(self, *a, **kw)

        ADMMTrainer.fit = admm_spy
        reset_counts()
        t0 = time.perf_counter()
        with tee_stdout() as said:
            admm_scores = train_cli.main([
                "--set", *DEFAULTS_SET, "--set", f"data_path={tmp / 'ts40k'}", *ADMM_SET,
                f"max_epochs={TRAIN_EPOCHS}", "num_workers=4", f"output_dir={tmp / 'admm'}",
                f"checkpoint_dir={tmp / 'admm' / 'ckpt'}"])
            torch.cuda.synchronize()
        admm_s = time.perf_counter() - t0
        ADMMTrainer.fit = admm_fit
        admm_counts = read_counts()
        check("[admm] augmented-Lagrangian training (rho=5.0, optimizer=lbfgs)" in said.text
              and "[loader] -> NativePointCloudLoader" in said.text, "admm: not the ADMM route")
        check(len(admm_runs) == 1 and isinstance(admm_runs[0].optimizer, LBFGS),
              "admm: the CLI did not train an ADMMTrainer with L-BFGS")
        admm = admm_runs[0]
        admm_steps = TRAIN_EPOCHS * (n_train // TRAIN_BATCH)
        admm_evals = admm_steps + admm.optimizer.evaluations
        admm_evb = TRAIN_EPOCHS * -(-n_val // TRAIN_BATCH) + -(-N_TEST // TRAIN_BATCH)
        check(admm.step == admm_steps, f"admm: {admm.step} steps, {admm_steps} expected")
        check(admm_counts["points_binary"] == admm_steps + admm_evb
              and admm_counts["stencil_conv"] == admm_evals + admm_evb
              and admm_counts["stencil_dk"] == admm_evals,
              f"admm launched {admm_counts}: {admm_steps} steps, {admm_evals} evaluations, "
              f"{admm_evb} evaluation batches")
        violations = [h["max_violation"] for h in admm.history]
        check(len(violations) == TRAIN_EPOCHS and all(math.isfinite(v) for v in violations)
              and all(math.isfinite(v) for k, v in admm_scores.items() if k.endswith("loss")),
              f"admm: history {admm.history}, scores {admm_scores}")
        # the step's time on the same width: 3 batches of the crops on the card, 2 epochs
        # after a warm epoch, the dual update and the epoch's checkpoints included
        fcrit = resolve_criterion("focal_tversky")(**load_config(None, train_cli.parse_overrides(
            DEFAULTS_SET + ADMM_SET)).criterion_params())
        raw = [tuple(torch.from_numpy(np.stack(col)).to(dev) for col in
                     zip(*(ds[i][:3] for i in range(b * TRAIN_BATCH, (b + 1) * TRAIN_BATCH))))
               for b in range(3)]
        timed_admm = None
        for epochs in (1, 2):
            timed_admm = ADMMTrainer(
                SceneNet.create(kernel_size=(9, 5, 5), seed=0, backend="cuda").to(dev), fcrit,
                ADMMConfig(max_epochs=epochs, admm_rho=5.0, optimizer="lbfgs",
                           learning_rate=0.8, run_dir=str(tmp / f"admm_t{epochs}"),
                           checkpoint_dir=str(tmp / f"admm_tc{epochs}"),
                           early_stop_metric=None, log_gradients=False), batch_prep=prep)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            timed_admm.fit(raw)
            torch.cuda.synchronize()
            admm_step_ms = (time.perf_counter() - t0) / (3 * epochs) * 1e3
        opt = timed_admm.optimizer
        print(f"[admm] cli.train --set constrained=admm admm_rho=5.0 optimizer=lbfgs "
              f"learning_rate=0.8 criterion=focal_tversky (B={TRAIN_BATCH}, 64^3, "
              f"{TRAIN_POINTS} points, (9,5,5)): {TRAIN_EPOCHS} epochs = {admm_steps} steps in "
              f"{admm_s:.1f} s | launches {admm_counts} (K3 a step, K2 and K4 an evaluation) | "
              f"evaluations a step {admm_evals / admm_steps:.2f}, host syncs a step "
              f"{admm.optimizer.host_syncs / admm_steps:.2f} | admm_max_violation by epoch "
              f"{violations}, admm_mu_norm {admm_scores['admm_mu_norm']:.6f} | losses "
              + ", ".join(f"{k} {v:.6f}" for k, v in sorted(admm_scores.items())
                          if k.endswith("loss"))
              + f" | [timing] ADMM + L-BFGS step {admm_step_ms:.3f} ms (6 steps on 3 batches: "
              f"{(6 + opt.evaluations) / 6:.2f} evaluations, {opt.host_syncs / 6:.2f} host "
              f"syncs a step)", flush=True)

        # ---- 20. A7: the defaults with optimizer=lbfgs through the grid cache -----
        cached_fits.clear()
        Trainer._run_cached_epochs = spy
        reset_counts()
        with tee_stdout() as said:
            lb_scores = train_cli.main([
                "--set", *DEFAULTS_SET, "--set", f"data_path={tmp / 'ts40k'}", "optimizer=lbfgs",
                f"max_epochs={TRAIN_EPOCHS}", "num_workers=4", f"output_dir={tmp / 'lbfgs'}",
                f"checkpoint_dir={tmp / 'lbfgs' / 'ckpt'}"])
            torch.cuda.synchronize()
        Trainer._run_cached_epochs = run_cached
        lb_counts = read_counts()
        check("[device_cache auto] -> 'grids'" in said.text
              and "[lbfgs] the linesearch reads its values on the host" in said.text,
              "lbfgs: not the grid cache with eager steps")
        lb = cached_fits[0]
        check(not lb.cached_epochs.runner.captured and lb.cached_epochs.runner.replays == 0
              and lb.step == steps, f"lbfgs: {lb.step} steps, a graph captured")
        lb_evals = steps + lb.optimizer.evaluations
        check(lb_counts["stencil_dk"] == lb_evals
              and lb_counts["stencil_conv"] == lb_evals + eval_batches
              and all(math.isfinite(v) for k, v in lb_scores.items() if k.endswith("loss")),
              f"lbfgs launched {lb_counts} in {steps} steps ({lb_evals} evaluations), "
              f"scores {lb_scores}")
        # the step by time, beside the Adam graph replay, each a fit over the same
        # grid cache (the crops repeated to 256 samples: epochs of 16 steps), its
        # epochs timed in alternating order after a warm fit of 2 epochs
        lb_grids = DeviceGridCache(DevicePointCache(ds, dev), prep)
        reps = torch.arange(ROUTE_SAMPLES, device=dev) % len(lb_grids)
        lb_grids.x, lb_grids.y = (a.index_select(0, reps) for a in (lb_grids.x, lb_grids.y))
        timing_fits = {}
        for opt_name in ("lbfgs", "adam"):
            t = Trainer(SceneNet.create(kernel_size=(9, 5, 5), seed=0, backend="cuda").to(dev),
                        crit, TrainConfig(run_dir=str(tmp / f"lbt_{opt_name}"), max_epochs=2,
                                          checkpoint_dir=str(tmp / f"lbt_c_{opt_name}"),
                                          early_stop_metric=None, optimizer=opt_name))
            t.fit_grid_cached(lb_grids, TRAIN_BATCH, augment=False,
                              generator=torch.Generator(dev).manual_seed(0))
            timing_fits[opt_name] = t
        lb_t = timing_fits["lbfgs"]
        ev0, sy0 = lb_t.optimizer.evaluations, lb_t.optimizer.host_syncs
        lb_ms, adam_ms = [], []
        for _ in range(2):
            for t, out in ((lb_t, lb_ms), (timing_fits["adam"], adam_ms)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                t.cached_epochs.run_epoch()
                torch.cuda.synchronize()
                out.append((time.perf_counter() - t0) / t.cached_epochs.n_batches * 1e3)
        check(timing_fits["adam"].cached_epochs.runner.captured
              and not lb_t.cached_epochs.runner.captured, "lbfgs timing: the graphs")
        lb_timed = 2 * lb_t.cached_epochs.n_batches
        lb_evals_step = 1 + (lb_t.optimizer.evaluations - ev0) / lb_timed
        lb_syncs_step = (lb_t.optimizer.host_syncs - sy0) / lb_timed
        del timing_fits, lb_t, lb_grids
        print(f"[lbfgs] cli.train with the defaults and optimizer=lbfgs (device_cache auto -> "
              f"'grids', every step eager): {steps} steps | launches {lb_counts} | evaluations "
              f"a step {lb_evals / steps:.2f} | losses "
              + ", ".join(f"{k} {v:.6f}" for k, v in sorted(lb_scores.items())
                          if k.endswith("loss"))
              + f" | [timing] L-BFGS step on the grid cache {min(lb_ms):.3f} ms "
              f"({', '.join(f'{v:.3f}' for v in lb_ms)}; "
              f"{lb_evals_step:.2f} evaluations, {lb_syncs_step:.2f} host syncs a step) against the "
              f"Adam graph replay {min(adam_ms):.3f} ms ({', '.join(f'{v:.3f}' for v in adam_ms)})",
              flush=True)

        # ---- 21. A7: preemption, a real SIGTERM and the relaunch that resumes -----
        env = dict(os.environ)
        env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")

        def launch(out):
            return subprocess.Popen(
                [sys.executable, "-m", "scenenet_tpu_torch.cli.train", "--set", *DEFAULTS_SET,
                 "--set", f"data_path={tmp / 'ts40k'}", "epoch_chunks=4",
                 f"max_epochs={PREEMPT_EPOCHS}", "early_stop_metric=None", "num_workers=4",
                 f"output_dir={out}", f"checkpoint_dir={out / 'ckpt'}"],
                env=env, cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)

        procs = []
        try:
            t0 = time.perf_counter()
            procs.append(launch(tmp / "pre_straight"))
            straight_out, _ = procs[-1].communicate(timeout=400)
            straight_s = time.perf_counter() - t0
            check(procs[-1].returncode == 0, f"preempt: the straight run failed\n"
                                             f"{straight_out[-3000:]}")
            procs.append(launch(tmp / "pre_killed"))
            killed = procs[-1]
            metrics_file = tmp / "pre_killed" / "scenenet_ts40k" / "metrics.jsonl"
            deadline = time.time() + 300
            while time.time() < deadline and killed.poll() is None:
                if metrics_file.exists() and sum(1 for _ in open(metrics_file)) >= 10:
                    break
                time.sleep(0.02)
            check(killed.poll() is None, "preempt: the run ended before the SIGTERM")
            logged = sum(1 for _ in open(metrics_file))
            killed.send_signal(__import__("signal").SIGTERM)
            killed_out, _ = killed.communicate(timeout=300)
            snap = tmp / "pre_killed" / "ckpt" / "preempt.npz"
            check(killed.returncode == 0 and "[preempt] SIGTERM: snapshot flushed" in killed_out
                  and snap.exists(), f"preempt: rc {killed.returncode}\n{killed_out[-3000:]}")
            snap_bytes = snap.stat().st_size + snap.with_suffix(".json").stat().st_size
            cursor = json.loads(snap.with_suffix(".json").read_text())["cursor"]
            t0 = time.perf_counter()
            procs.append(launch(tmp / "pre_killed"))
            relaunch_out, _ = procs[-1].communicate(timeout=400)
            relaunch_s = time.perf_counter() - t0
            check(procs[-1].returncode == 0 and "[preempt] resuming from snapshot" in relaunch_out
                  and not snap.exists(), f"preempt: the relaunch\n{relaunch_out[-3000:]}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        with np.load(tmp / "pre_straight" / "ckpt" / "last.npz") as a, \
                np.load(tmp / "pre_killed" / "ckpt" / "last.npz") as b:
            check(sorted(a.files) == sorted(b.files)
                  and all(np.array_equal(a[k], b[k]) for k in a.files),
                  "preempt: the resumed last.npz differs from the unkilled run's")
        # in process: the point cache with augmentation at the same width, preempted
        # after the first chunk of epoch 0 and resumed (its graph captured on the
        # restored buffers), with the snapshot's write and the resume timed
        pc = DevicePointCache(ds, dev)
        timings = {"write": [], "resume": []}
        originals = {}

        def timed(kind, fn):
            def wrapper(*a, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                torch.cuda.synchronize()
                timings[kind].append((time.perf_counter() - t0) * 1e3)
                return out
            return wrapper

        for owner, attr, kind in ((loop_mod, "save_train_snapshot", "write"),
                                  (loop_mod, "load_train_snapshot_if_compatible", "resume"),
                                  (Trainer, "load_train_state", "resume"),
                                  (loop_mod.CachedEpochs, "load", "resume")):
            originals[(owner, attr)] = getattr(owner, attr)
            setattr(owner, attr, timed(kind, getattr(owner, attr)))
        reset_counts()
        try:
            pre_fits = {}
            pc_prof = profile(activities=[ProfilerActivity.CUDA])
            pc_prof.start()
            for tag in ("straight", "killed", "resumed"):
                t = Trainer(SceneNet.create(kernel_size=(9, 5, 5), seed=0, backend="cuda").to(dev),
                            crit, TrainConfig(run_dir=str(tmp / f"pc_{tag}"), max_epochs=2,
                                              checkpoint_dir=str(tmp / f"pc_c_{tag}"),
                                              early_stop_metric=None, epoch_chunks=3),
                            batch_prep=prep)
                if tag == "killed":
                    request_preemption()
                t.fit_cached(pc, TRAIN_BATCH, augment=True,
                             generator=torch.Generator(dev).manual_seed(11),
                             resume_from=(str(tmp / "pc_c_killed" / "preempt.npz")
                                          if tag == "resumed" else None))
                torch.cuda.synchronize()
                pre_fits[tag] = t
        finally:
            pc_prof.stop()
            for (owner, attr), fn in originals.items():
                setattr(owner, attr, fn)
        pc_counts, pc_ran = read_counts(), ran(pre_fits.values())
        # K2 and K4 only: K1 and K3 share their expand pass's name
        ran_as_traced(pc_ran, kernel_runs(pc_prof), "preempt", ("stencil_conv", "stencil_dk"))
        resumed = pre_fits["resumed"]
        check(pre_fits["killed"].preempted and resumed.cached_epochs.runner.captured
              and all(torch.equal(a, b) for a, b in zip(pre_fits["straight"].model.parameters(),
                                                        resumed.model.parameters()))
              and pre_fits["straight"].train_counts[-1] == resumed.train_counts[-1],
              "preempt: the point-cache fit did not resume bit-identically")
        pc_snap = tmp / "pc_c_killed" / "preempt.npz"
        print(f"[preempt] cli.train with the defaults (grid cache, epoch_chunks=4, "
              f"max_epochs={PREEMPT_EPOCHS}): SIGTERM after {logged} epochs logged -> snapshot "
              f"flushed at {cursor} ({snap_bytes} bytes with its sidecar); the relaunch resumed "
              f"({relaunch_s:.1f} s, the straight run {straight_s:.1f} s) and its last.npz equals "
              f"the unkilled run's bit for bit | in process, the point cache with augmentation "
              f"(3 chunks an epoch, 2 epochs): preempted at chunk 1, resumed through a graph "
              f"captured on the restored buffers, parameters and counts bit-identical | snapshot "
              f"write {min(timings['write']):.3f} ms, resume {sum(timings['resume']):.3f} ms, "
              f"{pc_snap.stat().st_size if pc_snap.exists() else 0} bytes | launches "
              f"{pc_counts}", flush=True)

        # ---- 22. A7: the tuners through the train CLI --------------------------------
        tune_runs = {}
        home = os.environ.get("HOME")
        os.environ["HOME"] = str(tmp / "home")  # the autotune cache lives in the run's tree
        try:
            Trainer._run_cached_epochs = spy
            for tag, extra in (("lr", ["auto_lr_find=True"]),
                               ("autotune", ["model_backend=autotune"]),
                               ("scale", ["auto_scale_batch_size=True"])):
                cached_fits.clear()
                reset_counts()
                t0 = time.perf_counter()
                with tee_stdout() as said:
                    tune_scores = train_cli.main([
                        "--set", *DEFAULTS_SET, "--set", f"data_path={tmp / 'ts40k'}",
                        "max_epochs=1", "num_workers=4", f"output_dir={tmp / tag}",
                        f"checkpoint_dir={tmp / tag / 'ckpt'}", *extra])
                    torch.cuda.synchronize()
                check(all(math.isfinite(v) for k, v in tune_scores.items() if k.endswith("loss")),
                      f"{tag}: scores {tune_scores}")
                # the fit's replays; the tuners' own timing replays are left out
                tune_runs[tag] = (time.perf_counter() - t0, said.text, ran(cached_fits))
        finally:
            Trainer._run_cached_epochs = run_cached
            if home is None:
                os.environ.pop("HOME")
            else:
                os.environ["HOME"] = home
        lr_line = re.search(r"\[auto_lr_find\] suggested learning_rate=(\S+)", tune_runs["lr"][1])
        at_line = re.search(r"\[autotune\] backend -> (\S+) at .*\((.*)\)", tune_runs["autotune"][1])
        sc_line = re.search(r"largest batch whose step runs: (\d+)", tune_runs["scale"][1])
        check(lr_line is not None and at_line is not None and sc_line is not None,
              "tune: a tuner's line is missing")
        at_times = dict((k, float(v.split()[0])) for k, v in
                        (kv.split(": ") for kv in at_line.group(2).split(", ")))
        check(set(at_times) == {"cuda", "cuda_mxu"} and tune_runs["autotune"][2]["stencil_mma"] > 0,
              f"autotune: {at_times}, launches {tune_runs['autotune'][2]}")
        # the CLI's probe at 128^3 until the card truly runs out of memory
        big_cfg = load_config(None, train_cli.parse_overrides(
            DEFAULTS_SET + ["voxel_grid_size=(128, 128, 128)"]))
        probe_net = SceneNet.create(kernel_size=(9, 5, 5), seed=0, backend="cuda").to(dev)
        probe = train_cli.make_batch_probe(
            big_cfg, probe_net, crit, make_device_voxelize_prep(BIG_GRID, (TOWER,),
                                                                use_indices=False), dev)
        probed, ooms = [], []

        def recording_probe(b):
            probed.append(b)
            try:
                probe(b)
            except Exception as e:
                ooms.append(type(e).__name__)
                raise

        # the card's memory held but for PROBE_FREE_GB, so that the probe runs out below
        # B=1024, where a 128^3 batch reaches 2^31 voxels and the kernels refuse it
        torch.cuda.empty_cache()
        ballast = torch.empty(max(torch.cuda.mem_get_info(dev)[0] - (PROBE_FREE_GB << 30), 0),
                              dtype=torch.uint8, device=dev)
        reset_counts()
        t0 = time.perf_counter()
        try:
            found_big = find_max_batch_size(recording_probe, start=TRAIN_BATCH,
                                            max_batch=1 << 14)
        finally:
            del ballast
            torch.cuda.empty_cache()
        probe_s = time.perf_counter() - t0
        probe_counts = read_counts()
        check(ooms == ["OutOfMemoryError"] and found_big == probed[-2],
              f"probe at 128^3: {probed}, errors {ooms}")
        probe(TRAIN_BATCH)  # the card trains on after the out-of-memory
        torch.cuda.synchronize()
        del probe_net
        torch.cuda.empty_cache()
        print(f"[tune] cli.train --set auto_lr_find=True: suggested learning_rate "
              f"{lr_line.group(1)} | model_backend=autotune -> {at_line.group(1)} ({at_line.group(2)}) "
              f"| auto_scale_batch_size=True at 64^3: {sc_line.group(1)} (probes up to the "
              f"{n_train} training crops) | the CLI's probe at 128^3 with {PROBE_FREE_GB} GB of "
              f"the card free: batches {probed}, found "
              f"{found_big}, {ooms[0]} at {probed[-1]}, {probe_s:.1f} s, launches "
              f"{probe_counts} | launches " + ", ".join(
                  f"{tag} {c}" for tag, (_, _, c) in tune_runs.items()), flush=True)

        # C6: the CLI's autotune above timed graph replays (the grid cache); the same
        # two candidates timed eagerly, as the streamed route and L-BFGS train
        check("; graph replays)" in tune_runs["autotune"][1], "autotune did not time replays")
        _, eager_times = autotune_backend(
            lambda b: SceneNet.create(kernel_size=(9, 5, 5), seed=0, backend=b).to(dev), crit,
            TRAIN_BATCH, GRID, optimizer="adam", cache_path=str(tmp / "eager.json"))
        print(f"[tune] C6, model_backend=autotune at (B={TRAIN_BATCH}, 64^3, adam; {smi}): "
              f"graph replays {at_times} -> {at_line.group(1)} | eager steps "
              + ", ".join(f"{k}: {v:.2f} ms" for k, v in eager_times.items())
              + f" -> {min(eager_times, key=eager_times.get)}", flush=True)

        # ---- 23. A10 + A11: visualize, inspect, the exports, a sweep, the PLYs -------
        from scenenet_tpu_torch.cli import inspect as inspect_cli
        from scenenet_tpu_torch.cli import visualize as visualize_cli
        from scenenet_tpu_torch.compat import export_torch_state_dict
        from scenenet_tpu_torch.utils.export import export_forward, load_exported
        from scenenet_tpu_torch.utils.onnx_export import export_scenenet_onnx, load_onnx

        # cli.visualize over the synthetic test split at 64^3 with the defaults' fit of
        # phase 10: host grids, the forward on the card (K2 once a sample)
        phase_ckpt = str(ckpt_dir / "last.npz")
        data_set = ["--set", *DEFAULTS_SET, "--set", f"data_path={tmp / 'ts40k'}"]
        viz_out = tmp / "viz"
        reset_counts()
        t0 = time.perf_counter()
        with tee_stdout() as said:
            viz_summary = visualize_cli.main([*data_set, "--checkpoint", phase_ckpt,
                                              "--out", str(viz_out), "--n", str(VIZ_SAMPLES)])
        viz_s = time.perf_counter() - t0
        viz_counts = read_counts()
        stages = np.array([[float(v) for v in m.groups()] for m in re.finditer(
            r"ms: forward (\S+), ply (\S+), proposals (\S+)\)", said.text)])
        viz_files = sorted(p.name for p in viz_out.iterdir())
        check(len(viz_summary) == VIZ_SAMPLES and stages.shape == (VIZ_SAMPLES, 3)
              and len(viz_files) == 4 * VIZ_SAMPLES + 1,
              f"visualize: {len(viz_summary)} samples, files {viz_files}")
        check(viz_counts["stencil_conv"] == VIZ_SAMPLES
              and sum(viz_counts.values()) == VIZ_SAMPLES,
              f"visualize launched {viz_counts}: K2 once a sample")
        # sample 0's forward: K2 against its plain version, on the same grid
        viz_cfg = load_config(None, train_cli.parse_overrides(
            DEFAULTS_SET + [f"data_path={tmp / 'ts40k'}", "device_voxelization=False"]))
        vx = torch.from_numpy(np.asarray(train_cli.build_datasets(viz_cfg)[2][0][0],
                                         np.float32))[None].to(dev)
        viz_net = restore_checkpoint(phase_ckpt, SceneNet.create(
            kernel_size=(9, 5, 5), seed=0, backend="cuda")).to(dev).eval()
        with torch.no_grad():
            viz_k2 = viz_net(vx)
            viz_net.backend = "torch"
            viz_err = float((viz_k2 - viz_net(vx)).abs().max())
        check(viz_err <= PROB_TOL, f"visualize: K2 vs plain max|d| {viz_err:.3g}")
        med = np.median(stages, axis=0)
        # the PLYs' and DBSCAN's work grows with the voxels the model marks: read it
        # beside the positive shares, predicted and true, and a thousand voxels at a time
        pred_vox = np.array([e["pred_voxels"] for e in viz_summary], np.float64)
        gt_vox = np.array([e["gt_voxels"] for e in viz_summary], np.float64)
        per_k = np.median(stages[:, 1:] / (pred_vox[:, None] / 1e3), axis=0)
        print(f"[visualize] cli.visualize --n {VIZ_SAMPLES} at 64^3 ((9,5,5), the defaults' "
              f"fit, backend cuda; {smi}): {len(viz_files)} files ({', '.join(viz_files[:4])}, "
              f"... summary.json) in {viz_s:.2f} s | proposals "
              + "; ".join(f"sample {e['sample']}: {e['pred_voxels']} pred voxels, "
                          f"{e['gt_voxels']} gt, {e['proposals']}" for e in viz_summary)
              + f" | median ms a sample: forward {med[0]:.3f} (host grid to the card, K2, "
              f"back), PLYs {med[1]:.3f}, proposals {med[2]:.3f} | positive share of the "
              f"{vx.numel()} voxels: predicted {pred_vox.min() / vx.numel():.4f}-"
              f"{pred_vox.max() / vx.numel():.4f}, true {gt_vox.min() / vx.numel():.4f}-"
              f"{gt_vox.max() / vx.numel():.4f} | median ms a 1k predicted voxels: PLYs "
              f"{per_k[0]:.3f}, proposals {per_k[1]:.3f} | K2 vs plain on sample 0 "
              f"max|d| {viz_err:.3g} | launches {viz_counts}", flush=True)

        # cli.inspect on that checkpoint, and on reference-layout .ckpt files written by
        # export_torch_state_dict: the fit's, and a (9,6,6) one without kernel_size
        ref_ckpt, even_ckpt = tmp / "fit.ckpt", tmp / "even.ckpt"
        export_torch_state_dict(trained, str(ref_ckpt))
        even_net = SceneNet.create(kernel_size=(9, 6, 6), seed=3)
        export_torch_state_dict(even_net, str(even_ckpt))
        blob = torch.load(str(even_ckpt), weights_only=False)
        del blob["hyper_parameters"]["kernel_size"]  # the reference's default, (9, 6, 6)
        torch.save(blob, str(even_ckpt))
        inspect_parts = []
        for tag, args, want in (
                ("npz", ["--checkpoint", phase_ckpt, *data_set], trained),
                ("ckpt", ["--reference-ckpt", str(ref_ckpt)], trained),
                ("ckpt (9,6,6)", ["--reference-ckpt", str(even_ckpt)], even_net)):
            out = tmp / f"inspect_{len(inspect_parts)}"
            t0 = time.perf_counter()
            with tee_stdout():
                table = inspect_cli.main([*args, "--out", str(out)])
            ms = (time.perf_counter() - t0) * 1e3
            want_table = want.parameters_in_dict()
            plys = sorted(p.name for p in out.glob("*.ply"))
            # the .ckpt holds the effective λs, re-summed on import: within 1e-6
            worst = max(abs(table[k] - v) for k, v in want_table.items())
            check(table.keys() == want_table.keys() and worst <= 1e-6
                  and all(table[k] == v for k, v in want_table.items() if "." in k)
                  and plys == sorted([f"kernel_{n}.ply" for n, _ in want.observers]
                                     + ["kernel_combined.ply"]),
                  f"inspect {tag}: max|d| {worst:.3g}, files {plys}")
            inspect_parts.append(f"{tag}: {len(table)} parameters equal to the checkpoint's "
                                 f"(max|d| {worst:.3g}), {len(plys)} kernel PLYs, {ms:.1f} ms")
        print("[inspect] cli.inspect, kernels synthesized on the card | "
              + " | ".join(inspect_parts), flush=True)

        # the exports of the fit, run on the card against K2's forward of the model
        ex_net = restore_checkpoint(phase_ckpt, SceneNet.create(
            kernel_size=(9, 5, 5), seed=0, backend="cuda")).to(dev)
        ex_x = (torch.rand(2, 1, *GRID, device=dev,
                           generator=torch.Generator(dev).manual_seed(5)) > 0.95).float()
        with torch.no_grad():
            ex_want = ex_net(ex_x)
        t0 = time.perf_counter()
        onnx_blob = export_scenenet_onnx(ex_net, GRID, str(tmp / "fit.onnx"))
        onnx_ms = (time.perf_counter() - t0) * 1e3
        onnx_run = load_onnx(str(tmp / "fit.onnx"))
        onnx_err = float((onnx_run(ex_x) - ex_want).abs().max())
        t0 = time.perf_counter()
        export_forward(ex_net, (2, 1, *GRID), str(tmp / "fit.pt2"))
        pt2_ms = (time.perf_counter() - t0) * 1e3
        with torch.no_grad():
            pt2_out = load_exported(str(tmp / "fit.pt2"))(ex_x)
        pt2_err = float((pt2_out - ex_want).abs().max())
        check(pt2_out.device == ex_want.device and onnx_err <= PROB_TOL and pt2_err <= PROB_TOL,
              f"exports vs K2: onnx {onnx_err:.3g}, torch.export {pt2_err:.3g}")
        print(f"[export] the defaults' fit: ONNX {len(onnx_blob)} bytes written in "
              f"{onnx_ms:.1f} ms, parsed back and run by load_onnx on the card (F.conv3d): "
              f"max|d| {onnx_err:.3g} vs K2's forward | torch.export program "
              f"{(tmp / 'fit.pt2').stat().st_size} bytes in {pt2_ms:.1f} ms (the torch-backend "
              f"forward), loaded and run on the card: max|d| {pt2_err:.3g} vs K2 (B=2, 64^3)",
              flush=True)

        # a sweep of two literal draws through run_sweep, the defaults' width, 1 epoch
        # each, through the grid cache (the draws' keys left out of the overrides)
        drawn = {k for d in SWEEP_DRAWS for k in d}
        sweep_over = train_cli.parse_overrides(
            [kv for kv in DEFAULTS_SET if kv.split("=")[0] not in drawn]
            + [f"data_path={tmp / 'ts40k'}", "max_epochs=1", "num_workers=4",
               f"output_dir={tmp / 'sweep'}"])
        cached_fits.clear()
        Trainer._run_cached_epochs = spy
        reset_counts()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as sweep_prof, tee_stdout() as said:
            best = train_cli.run_sweep(SWEEP_DRAWS, None, sweep_over, device="cuda")
            torch.cuda.synchronize()
        sweep_s = time.perf_counter() - t0
        Trainer._run_cached_epochs = run_cached
        sweep_counts = ran(cached_fits)
        ran_as_traced(sweep_counts, kernel_runs(sweep_prof), "sweep",
                      ("stencil_conv", "stencil_dk"))
        scores_seen = re.findall(r"\[sweep (\d)\] val_FBetaScore=(\S+)", said.text)
        check(len(scores_seen) == 2 and said.text.count("[device_cache auto] -> 'grids'") == 2
              and best["best_draw"] in SWEEP_DRAWS and sweep_counts["stencil_dk"] > 0,
              f"sweep: {scores_seen}, best {best}, launches {sweep_counts}")
        print(f"[sweep] run_sweep over 2 literal draws, 1 epoch each through the grid cache: "
              + ", ".join(f"draw {i} val_FBetaScore {v}" for i, v in scores_seen)
              + f" | best {best['best_score']:.4f} with {best['best_draw']} | {sweep_s:.1f} s "
              f"| launches {sweep_counts}", flush=True)

        # log_pointclouds_every (a TrainConfig field: neither package's config file
        # carries it) on the streamed fit, through the CLI's builders and the native
        # loader at the defaults' width: the first validation sample's PLYs
        pc_cfg = load_config(None, train_cli.parse_overrides(
            DEFAULTS_SET + [f"data_path={tmp / 'ts40k'}"]))
        pc_train, pc_val, _ = train_cli.build_datasets(pc_cfg)
        clouds_trainer = Trainer(
            train_cli.build_model(pc_cfg, dev), train_cli.build_criterion(pc_cfg),
            TrainConfig(max_epochs=1, log_pointclouds_every=1, early_stop_metric=None,
                        run_dir=str(tmp / "clouds"), checkpoint_dir=str(tmp / "clouds_ckpt")),
            batch_prep=make_device_voxelize_prep(GRID, (TOWER,), use_indices=False))
        reset_counts()
        t0 = time.perf_counter()
        clouds_trainer.fit(
            NativePointCloudLoader(pc_train, TRAIN_BATCH, shuffle=True, seed=0,
                                   max_points=TRAIN_POINTS, threads=4, drop_last=True),
            PointCloudLoader(pc_val, TRAIN_BATCH, num_workers=4))
        torch.cuda.synchronize()
        clouds_s = time.perf_counter() - t0
        clouds_counts = read_counts()
        cloud_dir = tmp / "clouds" / "pointclouds"
        clouds = sorted(p.name for p in cloud_dir.glob("*.ply")) if cloud_dir.is_dir() else []
        check(clouds == ["epoch0_gt.ply", "epoch0_input.ply", "epoch0_pred.ply"]
              and clouds_counts["points_binary"] > 0, f"pointclouds: {clouds}")
        print(f"[pointclouds] Trainer.fit with log_pointclouds_every=1, 1 epoch streamed "
              f"(native loader, the defaults' width) in {clouds_s:.1f} s: {clouds} ("
              + ", ".join(f"{(cloud_dir / c).stat().st_size} B" for c in clouds)
              + f") | launches {clouds_counts}", flush=True)

        # C5: a native source that does not compile, and sources that are absent,
        # leave available() False with its reason (a process of its own, so that
        # this one's library is not disturbed)
        native_code = (
            "import sys\nfrom pathlib import Path\nsys.path.insert(0, sys.argv[1])\n"
            "from scenenet_tpu_torch import native\n"
            "tmp = Path(sys.argv[2])\nbad = tmp / 'voxel_native.cpp'\n"
            "bad.write_text('this is not C++\\n')\n"
            "native.BUILD_DIR = tmp / 'out'\n"
            "for src in (bad, tmp / 'absent.cpp'):\n"
            "    native.SOURCES, native._lib, native._failed = (src,), None, {}\n"
            "    assert native.available() is False\n")
        proc = subprocess.run([sys.executable, "-c", native_code, str(ROOT), str(tmp)],
                              capture_output=True, text=True, timeout=120)
        reasons = [ln for ln in proc.stdout.splitlines() if ln.startswith("[native]")]
        check(proc.returncode == 0 and len(reasons) == 2 and "build failed" in reasons[0]
              and "sources missing" in reasons[1], f"native fallback: {proc.stdout}{proc.stderr}")
        print("[native] C5: available() is False with its reason | "
              + " | ".join(r[:140] for r in reasons), flush=True)

        # ---- 24. A12b: K10 at the shapes of channel TP, and ensemble-parallel serving --
        # a rank's conv at C_out/m and its dx at C_in/m (the dx of a column-parallel conv
        # has only the rank's C_out/m input channels), at the TP leg's batch a rank (2);
        # C_out <= 32 runs on the 32-wide tile, half or a quarter of it empty
        tp_k10, tp_k10_err, tp_k10_parts = {}, {"f32": 0.0, "bf16": 0.0}, []
        for form in ("f32", "bf16"):
            for what, cin, cout, n in TP_K10_SHAPES:
                xm, wm = mc_case(cin + cout + n, 2, cin, cout, (n, n, n))
                if form == "bf16":
                    xm, wm = xm.to(torch.bfloat16), wm.to(torch.bfloat16)
                got = cuda_conv_mc.conv3d_mc_same(xm, wm)
                want = cuda_conv_mc.conv3d_mc_same_plain(xm, wm)
                torch.cuda.synchronize()
                d = (got.float() - want.float()).abs()
                atol = MC_ATOL * max(1.0, math.sqrt(cin / MC_ATOL_CHANNELS))
                rtol = BF16_UNIT if form == "bf16" else MC_RTOL
                check(bool((d <= atol + rtol * want.float().abs()).all()),
                      f"K10 {form} {what} {cin}->{cout} {n}^3: max|d| {float(d.max()):.3g}")
                tp_k10_err[form] = max(tp_k10_err[form], float(d.max()))
                with torch.no_grad():
                    tp_k10[form, what, cin, cout, n] = paired_ms(
                        lambda: cuda_conv_mc.conv3d_mc_same(xm, wm),
                        lambda: cuda_conv_mc.conv3d_mc_same_plain(xm, wm), iters=5,
                        library_fn=lambda: F.conv3d(xm, wm, padding=1), warmup=1)
                tp_k10_parts.append(
                    f"{form} {what} {cin}->{cout} {n}^3 [{mc_plan(2, cin, cout, (n, n, n))}] "
                    f"max|d| {float(d.max()):.3g}, ms kernel / plain / library "
                    f"{tp_k10[form, what, cin, cout, n]['ms']:.4f} / "
                    f"{tp_k10[form, what, cin, cout, n]['plain_ms']:.4f} / "
                    f"{tp_k10[form, what, cin, cout, n]['library_ms']:.4f}")
                del xm, wm, got, want
        torch.cuda.empty_cache()
        print(f"[K10 channel TP] B=2 (the tp leg's batch a rank), against the plain version "
              f"(f32: {MC_ATOL} + {MC_RTOL} relative; bf16: one bf16 unit), median of 4 "
              f"alternating rounds ({smi}), library = one F.conv3d (cuDNN, TF32 off) | "
              + " | ".join(tp_k10_parts), flush=True)

        # serve --mesh-ensemble 2: the members in 2 groups, both on cuda:0 here (one card),
        # against the unsharded pipeline, through K1 + K2, then --inference mxu (K5)
        ep_serve_counts = {}
        qkw = dict(model="quantile", quantiles=EP_QUANTILES)
        clouds = [synthetic_cloud(np.random.default_rng(140), MAX_POINTS)]
        for inference in (True, "mxu"):
            ref = _Pipeline(None, inference=inference, **qkw)
            reset_counts()
            ep_pipe = _Pipeline(None, inference=inference, mesh_ensemble=2,
                                devices=[dev, dev], **qkw)
            check([m for _, m in ep_pipe._groups] == [[0, 1], [2, 3]]
                  and sorted(ep_pipe._graphs) == [1] and ep_pipe._graphs[1].graph.captured,
                  f"ep_serve: groups {ep_pipe._groups}, graphs {sorted(ep_pipe._graphs)}")
            worst_ep = 0.0
            for pts in clouds:
                (pv, pp_), (rv, rp) = ep_pipe.predict(pts), ref.predict(pts)
                check(pv.shape == (len(EP_QUANTILES),) + GRID and pp_.shape[0] == 4,
                      f"ep_serve: shapes {pv.shape} {pp_.shape}")
                worst_ep = max(worst_ep, float(np.abs(pv - rv).max()),
                               float(np.abs(pp_ - rp).max()))
            check(worst_ep <= PROB_TOL, f"ep_serve {inference}: max|d| {worst_ep:.3g}")
            launched = ep_pipe.kernel_launches()  # before the timing loop's dispatches
            ep_serve_counts[inference] = launched
            hp_, hm_, _ = padded_batch(np.random.default_rng(141), 1)
            pt_, mt_ = torch.from_numpy(hp_).to(dev), torch.from_numpy(hm_).to(dev)
            calls = {}
            n_disp = 20
            wall, busy_us, n_items, _, _ = profiled(
                lambda: [ep_pipe.run_batch(pt_, mt_) for _ in range(n_disp)], calls)
            host = sum(v for k, v in calls.items() if k in HOST_LAUNCH_CALLS)
            kernel = "stencil_mma" if inference == "mxu" else "stencil_conv"
            check(launched["points_occupancy"] > 0 and launched[kernel] > 0,
                  f"ep_serve {inference}: launches {launched}")
            print(f"[mesh] ep_serve: _Pipeline(model=quantile, {len(EP_QUANTILES)} quantiles, "
                  f"mesh_ensemble=2, devices=[cuda:0, cuda:0], inference={inference}) at 64^3, "
                  f"{MAX_POINTS} points: a request against the unsharded pipeline "
                  f"max|d| {worst_ep:.3g} (bound {PROB_TOL:g}) | a dispatch is one CUDA graph "
                  f"a bucket (replays {ep_pipe.graph_replays()}): {host / n_disp:.1f} host "
                  f"launch calls, {n_items / n_disp:.1f} device items, "
                  f"{wall * 1e3 / n_disp:.3f} ms wall a dispatch at bucket 1 | launches "
                  f"{launched} | {smi}", flush=True)
            ep_pipe.close()
            del ep_pipe, ref
            torch.cuda.empty_cache()

        # ---- 25. A12 + A12b: the [mesh] phase over gloo ranks ---------------------------
        mesh_out = mesh_phase(dev, tmp, smi)

    # each main path's launches; where it replays graphs, with what its replays ran
    main_runs = [serve_ran, *graph_counts.values(), auto_ran, quant_ran,
                 *etl_runs.values(), kitti_counts, headline_counts, batched_ran, fit_launches,
                 *(r[3] for r in route_runs.values()),
                 *(r[7] for r in option_runs.values()), host_counts,
                 *big_counts.values(), big_ran, counts_path, unet_counts, nn_counts,
                 unet16_counts, cnn_counts, admm_counts, lb_counts, pc_ran,
                 *(c for _, _, c in tune_runs.values()), probe_counts, viz_counts,
                 sweep_counts, clouds_counts]
    total = {k: sum(run[k] for run in main_runs) for k in counters}
    # bounds at the shapes the times below were taken at: 64^3, kernel (9,5,5);
    # K1, K2, K5 at batch 64 (the batched pipeline), K3, K4 at the train batch
    vox = GRID[0] * GRID[1] * GRID[2]
    taps = 9 * 5 * 5

    def grid_bytes(b):  # one f32 grid
        return 4.0 * b * vox

    def conv_flops(b):  # a multiply and an add per tap and voxel
        return 2.0 * taps * b * vox

    bounds = {
        # points f32 x 3 and the bool mask in, one f32 grid out
        "points_occupancy": bound_ms(64 * MAX_POINTS * 13.0 + grid_bytes(64)),
        "stencil_conv": bound_ms(2 * grid_bytes(64), conv_flops(64), F32_FLOPS),
        # points, mask and tower flags in, two f32 grids out
        "points_binary": bound_ms(TRAIN_BATCH * TRAIN_POINTS * 14.0
                                  + 2 * grid_bytes(TRAIN_BATCH)),
        # x and g in, 225 floats out
        "stencil_dk": bound_ms(2 * grid_bytes(TRAIN_BATCH) + 4.0 * taps,
                               conv_flops(TRAIN_BATCH), F32_FLOPS),
        # the hi and the lo sum, both on the bf16 tensor cores
        "stencil_mma": bound_ms(2 * grid_bytes(64), 2 * conv_flops(64), BF16_FLOPS),
        # points, mask and tower flags in, two f32 count grids out
        "points_bin_counts": bound_ms(TRAIN_BATCH * TRAIN_POINTS * 14.0
                                      + 2 * grid_bytes(TRAIN_BATCH)),
        # int32 ids, mask and flags in, two f32 count grids out
        "bin_counts": bound_ms(TRAIN_BATCH * TRAIN_POINTS * 6.0 + 2 * grid_bytes(TRAIN_BATCH)),
        "sorted_bin_counts": bound_ms(BIG_BATCH * MAX_POINTS * 6.0
                                      + 2 * 4.0 * BIG_BATCH * 128 ** 3),
        # points and mask in, int32 ids out
        "flat_ids": bound_ms(TRAIN_BATCH * TRAIN_POINTS * 17.0),
    }
    # K10: the UNet's 18 forward convs at the train batch, one after the other
    # (x and w in, the result out, 2*27*C_in*C_out TF32 and twice as many bf16
    # operations a voxel; the sum of the 18 bounds)
    mc_sum = mc_sums
    bounds["conv3d_mc"] = (mc_bound_sum,
                           "operations" if sum(mc_bounds[c][0] for c in UNET_CONVS
                                               if mc_bounds[c][1] == "operations")
                           >= sum(mc_bounds[c][0] for c in UNET_CONVS
                                  if mc_bounds[c][1] == "bytes") else "bytes")

    # K10's bf16 form: the same 18 convs, bf16 bytes, the products at the bf16 peak
    bounds["conv3d_mc_bf16"] = (mc16_bound_sum, "operations" if sum(
        mc16_bounds[c][0] for c in UNET_CONVS if mc16_bounds[c][1] == "operations")
        >= sum(mc16_bounds[c][0] for c in UNET_CONVS if mc16_bounds[c][1] == "bytes")
        else "bytes")

    bounds.update(halo_bounds)
    # B10's halo forms: their own entry point's run and their caller's, the [mesh]
    # phase's z-sharded fits (every rank)
    total["stencil_conv_halo"] = halo_counts["stencil_conv"] + mesh_out["halo"]["stencil_conv"]
    total["stencil_dk_halo"] = halo_counts["stencil_dk"] + mesh_out["halo"]["stencil_dk"]
    # the model axis legs' launches on every rank (ep: K2, K4; tp, pp, unet_pp: K10 and its
    # bf16 form) and ensemble-parallel serving's (K1, K2, K5)
    for k, v in mesh_out["legs"].items():
        total[k] += v
    for launched in ep_serve_counts.values():
        for k in ("points_occupancy", "stencil_conv", "stencil_mma"):
            total[k] += launched[k]

    def entry(name, source, replaces, err, t, shape):
        b_ms, by = bounds[name]
        return {"name": name, "route": "cuda", "source": f"scenenet_tpu_torch/csrc/{source}",
                "replaces": f"scenenet_tpu/ops/{replaces}", "launches": total[name],
                "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": b_ms, "bound_by": by, "library_ms": t["library_ms"],
                "shape": shape}

    big = f"B=64 N={MAX_POINTS} 64^3 k(9,5,5)"
    small = f"B={TRAIN_BATCH} N={TRAIN_POINTS} 64^3 k(9,5,5)"
    kernels = [
        entry("points_occupancy", "points_occupancy.cu", "pallas_hist.py:297", k1_err,
              times[64]["occupancy"], big),
        entry("stencil_conv", "stencil_conv.cu", "pallas_conv.py:103", k2_err,
              times[64]["stencil (9,5,5)"], big),
        entry("points_binary", "points_occupancy.cu", "pallas_hist.py:356", k3_err,
              train_times[TRAIN_BATCH]["points_binary"], small),
        entry("stencil_dk", "stencil_dk.cu", "pallas_conv.py:729", k4_err,
              train_times[TRAIN_BATCH]["stencil_dk (9,5,5)"], small),
        entry("stencil_mma", "stencil_mma.cu", "pallas_conv.py:448", k5_err,
              times[64]["stencil_mma (9,5,5)"], big),
        entry("points_bin_counts", "points_occupancy.cu", "pallas_hist.py:228", k6_err,
              hist_times["points_bin_counts"], f"B={TRAIN_BATCH} N={TRAIN_POINTS} 64^3 2ch"),
        entry("bin_counts", "bin_counts.cu", "pallas_hist.py:417", k7_err,
              hist_times["bin_counts"], f"B={TRAIN_BATCH} N={TRAIN_POINTS} 64^3 2ch"),
        entry("sorted_bin_counts", "bin_counts.cu", "pallas_hist.py:540", k8_err,
              big_times["sorted_bin_counts"], f"B={BIG_BATCH} N={MAX_POINTS} 128^3 2ch"),
        entry("flat_ids", "points_occupancy.cu", "pallas_hist.py:647", k9_err,
              hist_times["flat_ids"], f"B={TRAIN_BATCH} N={TRAIN_POINTS} 64^3"),
        entry("conv3d_mc", "conv3d_mc.cu", "pallas_conv_mc.py:100", k10_err, mc_sum,
              f"B={TRAIN_BATCH} 64^3, the sum over UNet3D's 18 forward convs"),
        entry("conv3d_mc_bf16", "conv3d_mc.cu", "pallas_conv_mc.py:100", k10b_err, mc16_sums,
              f"B={TRAIN_BATCH} 64^3 bf16, the sum over UNet3D's 18 forward convs"),
        {"name": "conv3d_mc_dw", "route": "cuda",
         "source": "scenenet_tpu_torch/csrc/conv3d_mc_dw.cu",
         "replaces": "no TPU kernel: XLA's weight gradient of scenenet_tpu/ops/"
                     "pallas_conv_mc.py:100 (no custom gradient)",
         "launches": total["conv3d_mc_dw"], "max_abs_err": k10dw_err, "ms": dw_sums["ms"],
         "plain_ms": None, "bound_ms": dw_bound_sum, "bound_by": "operations",
         "library_ms": dw_sums["library_ms"],
         "shape": f"B={TRAIN_BATCH} 64^3, the sum over UNet3D's 18 convs' dw"},
        entry("stencil_conv_halo", "stencil_conv.cu", "pallas_conv.py:918", halo_conv_err,
              halo_times["stencil_conv_halo"],
              f"B={BIG_BATCH} z-slab {HALO_Z}+8 x128x128 k(9,5,5), z_prepadded"),
        entry("stencil_dk_halo", "stencil_dk.cu", "pallas_conv.py:918", halo_dk_err,
              halo_times["stencil_dk_halo"],
              f"B={BIG_BATCH} z-slab {HALO_Z}+8 x128x128 k(9,5,5), z_prepadded"),
    ]
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} was launched no time on the main paths")
        check(k["ms"] >= k["bound_ms"], f"{k['name']}: {k['ms']:.4f} ms is under its bound")
    print("[bounds] " + " | ".join(
        f"{k['name']} {k['shape']}: {k['ms']:.4f} ms, bound {k['bound_ms']:.4f} ms by "
        f"{k['bound_by']} ({k['bound_ms'] / k['ms']:.1%} of it)" for k in kernels), flush=True)
    print(f"[total] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
