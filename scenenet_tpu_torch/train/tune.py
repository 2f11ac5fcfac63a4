"""Trainer tuning: the learning-rate range test, batch-size probing and the
measured backend choice.

PyTorch twin of :mod:`scenenet_tpu.train.tune`:

- :func:`lr_range_test`: ramp the learning rate geometrically over a
  window, keep the smoothed loss, suggest the rate of steepest descent
  (Lightning's tuner, which the reference declares and never calls). The
  rate is a 0-d tensor on the model's device that the optimizer reads, so
  one step serves every probe, as ``inject_hyperparams`` gives the JAX
  package one compile;
- :func:`find_max_batch_size`: power-of-two probing of the largest batch
  whose step runs, out-of-memory driven;
- :func:`measure_train_step_ms` and :func:`autotune_backend`: time one
  real train step a candidate backend on the card at the run's shapes and
  take the fastest (``model_backend: autotune``), cached by card, shapes,
  optimizer, candidates and route. Where the run trains by CUDA graph
  replays (the device caches, any optimizer but L-BFGS), a candidate is
  timed by replays of its captured step, as the JAX package times its
  jitted step: one dispatch a step.
"""

from __future__ import annotations

import copy
import gc
import json
import os
import tempfile
import time
from typing import Callable, Iterable, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from scenenet_tpu_torch.train.lbfgs import LBFGS
from scenenet_tpu_torch.train.loop import trains_by_replay
from scenenet_tpu_torch.train.state import resolve_optimizer
from scenenet_tpu_torch.train.step_graph import WARMUP, StepGraph


def _loss_fn(model: nn.Module, criterion: Callable):
    """The criterion on the model's f32 prediction, with the GENEO
    penalties read from the live parameters (as the JAX tuners' loss)."""
    def loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        pred = model(x)
        cvx = model.cvx_coefficients() if hasattr(model, "cvx_coefficients") else {}
        geneo = model.geneo_params_flat() if hasattr(model, "geneo_params_flat") else {}
        return criterion(pred, y, cvx, geneo, getattr(model, "last_lambda", None))

    return loss


def lr_range_test(model: nn.Module, criterion: Callable, batches: Iterable[Tuple],
                  min_lr: float = 1e-5, max_lr: float = 1.0, steps: int = 30,
                  optimizer: str = "adam", batch_prep: Optional[Callable] = None,
                  smooth_beta: float = 0.8) -> Tuple[float, List[Tuple[float, float]]]:
    """Suggest a learning rate: a geometric ramp from ``min_lr`` to
    ``max_lr`` over ``steps`` optimizer steps, ``batches`` cycled, the loss
    smoothed by ``smooth_beta``; the suggestion is the rate at the
    steepest negative slope of the smoothed loss. Returns
    ``(suggested_lr, [(lr, smoothed_loss), ...])``. The ramp stops at a
    non-finite loss or one past 4× the first. ``model`` is untouched: the
    test trains a copy, every parameter of it, as the JAX package's
    ``optax`` chain without a mask does. ``optimizer`` is adam, sgd or
    rmsprop (L-BFGS raises, as in the JAX package).
    """
    if optimizer not in ("adam", "sgd", "rmsprop"):
        raise NotImplementedError(f"lr_range_test: optimizer {optimizer!r}")
    batch_list = list(batches)
    if not batch_list:
        raise ValueError("lr_range_test needs at least one batch")
    probe = copy.deepcopy(model)
    for p in probe.parameters():
        p.requires_grad_(True)
    dev = next(probe.parameters()).device
    lr_t = torch.tensor(min_lr, dtype=torch.float32, device=dev)
    opt = resolve_optimizer(optimizer, probe.parameters(), lr_t,
                            capturable=dev.type == "cuda")
    loss_fn = _loss_fn(probe, criterion)
    ratio = (max_lr / min_lr) ** (1.0 / max(steps - 1, 1))
    lrs = [min_lr * ratio ** i for i in range(steps)]

    history: List[Tuple[float, float]] = []
    smoothed = None
    probe.train()
    for i, lr in enumerate(lrs):
        batch = tuple(torch.as_tensor(b).to(dev) for b in batch_list[i % len(batch_list)])
        x, y = batch_prep(*batch) if batch_prep else batch
        lr_t.fill_(lr)
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(x, y)
        loss.backward()
        opt.step()
        loss = float(loss.detach())
        if not np.isfinite(loss):
            break  # diverged: the useful range ends here
        smoothed = loss if smoothed is None else \
            smooth_beta * smoothed + (1 - smooth_beta) * loss
        history.append((lr, smoothed))
        if len(history) > 5 and smoothed > 4 * history[0][1]:
            break  # early divergence, as Lightning's tuner stops
    if len(history) < 3:
        return min_lr, history
    losses = np.array([h[1] for h in history])
    return float(history[int(np.argmin(np.gradient(losses)))][0]), history


def _is_oom(e: BaseException) -> bool:
    """Out-of-memory shaped: torch's ``OutOfMemoryError``, a host
    ``MemoryError``, or an allocation failure in any wording ("CUDA out of
    memory", XLA's RESOURCE_EXHAUSTED)."""
    if isinstance(e, (MemoryError, torch.OutOfMemoryError)):
        return True
    msg = str(e).lower()
    return any(s in msg for s in ("resource_exhausted", "resource exhausted", "out of memory",
                                  "failed to allocate", "allocation failure", "hbm"))


def _free_cache() -> None:
    """Give the caching allocator's blocks back after an out-of-memory."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def find_max_batch_size(probe: Callable[[int], None], start: int = 2,
                        max_batch: int = 4096) -> int:
    """The largest power-of-two multiple of ``start`` up to ``max_batch``
    for which ``probe(batch)`` (one real step at that batch) runs. Doubles
    until an out-of-memory error (:func:`_is_oom`) or ``max_batch``; the
    card's cache is freed after one. Raises if even ``start`` runs out;
    any other error is raised (a shape fault must not pass for the memory
    ceiling)."""
    good = None
    b = start
    oom = False
    while b <= max_batch:
        try:
            probe(b)
        except Exception as e:
            if not _is_oom(e):
                raise
            oom = True
            break
        good = b
        b *= 2
    if oom:
        _free_cache()  # after the except block: its traceback held the probe's tensors
    if good is None:
        raise RuntimeError(f"even batch={start} failed the probe with OOM")
    return good


def measure_train_step_ms(model: nn.Module, criterion: Callable, x: torch.Tensor,
                          y: torch.Tensor, optimizer: str = "sgd", iters: int = 6,
                          graph: bool = False) -> float:
    """Milliseconds of one train step (the forward, the loss, the backward
    and the update, L-BFGS's linesearch included) of a copy of ``model``
    on (x, y). Eager: a warm step, then ``iters`` steps in a chain closed by
    reading the last loss on the host, so every step has run when the
    clock stops. ``graph`` (a card, any optimizer but L-BFGS) times the
    step as the graph-replay routes run it: the warm-up steps and the
    capture of a :class:`StepGraph`, then ``iters`` replays closed by one
    host read."""
    probe = copy.deepcopy(model)
    dev = next(probe.parameters()).device
    graph = graph and trains_by_replay(dev, optimizer)
    opt = resolve_optimizer(optimizer, probe.parameters(), 1e-3, capturable=graph)
    loss_fn = _loss_fn(probe, criterion)
    probe.train()
    last = torch.zeros((), device=dev)

    def step() -> None:
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(x, y)
        loss.backward()
        loss = loss.detach()
        if isinstance(opt, LBFGS):
            def closure():
                opt.zero_grad(set_to_none=True)
                value = loss_fn(x, y)
                value.backward()
                return value.detach()

            opt.step(closure, loss)
        else:
            opt.step()
        last.copy_(loss)

    runner = StepGraph(step, dev, eager=not graph)
    for _ in range(WARMUP + 1 if graph else 1):  # warm: the kernels, the state, the capture
        runner()
    float(last)
    t0 = time.perf_counter()
    for _ in range(iters):
        runner()
    float(last)
    return (time.perf_counter() - t0) / iters * 1e3


def autotune_cache_key(device_kind: str, batch_size: int, grid_zxy: Tuple[int, int, int],
                       optimizer: str, candidates: Tuple[str, ...], extra: str,
                       graph: bool) -> str:
    """The autotune cache's key: a replayed timing is never reused for an
    eager run, nor the other way round."""
    return json.dumps({"device": device_kind, "batch": int(batch_size),
                       "grid": [int(g) for g in grid_zxy], "optimizer": optimizer,
                       "candidates": list(candidates), "extra": extra,
                       "route": "graph" if graph else "eager"}, sort_keys=True)


def autotune_backend(make_model: Callable[[str], nn.Module], criterion: Callable,
                     batch_size: int, grid_zxy: Tuple[int, int, int],
                     candidates: Tuple[str, ...] = ("cuda", "cuda_mxu"),
                     optimizer: str = "sgd", iters: int = 6,
                     cache_path: Optional[str] = None, cache_key_extra: str = "",
                     refresh: bool = False, graph: bool = False) -> Tuple[str, dict]:
    """Measured backend choice (``model_backend: autotune``): one real
    train step a candidate (``make_model(backend)``, on the device it
    trains on) at the run's exact (batch, grid), the fastest wins; timed
    by graph replays where ``graph`` says the run trains so (see
    :func:`measure_train_step_ms`). A candidate that runs out of memory is
    skipped (time inf); every other error is raised. Results are cached in
    a JSON file, by default ``~/.cache/scenenet_tpu_torch/autotune.json``,
    keyed by the card's name, the shapes, the optimizer, the candidates and
    the route the timing took (``graph`` or ``eager``), and written by
    atomic replace. Returns ``(winner, {backend: ms})``, the cached times
    on a hit."""
    first = make_model(candidates[0])
    dev = next(first.parameters()).device
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    graph = graph and trains_by_replay(dev, optimizer)
    key = autotune_cache_key(kind, batch_size, grid_zxy, optimizer, candidates,
                             cache_key_extra, graph)
    if cache_path is None:
        cache_path = os.path.expanduser("~/.cache/scenenet_tpu_torch/autotune.json")
    cache = {}
    if os.path.exists(cache_path):
        try:
            with open(cache_path) as f:
                cache = json.load(f)
        except (OSError, ValueError):
            cache = {}
    if not refresh and key in cache:
        entry = cache[key]
        return entry["winner"], entry["times_ms"]

    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.random((batch_size, 1, *grid_zxy)) > 0.9)
                         .astype(np.float32)).to(dev)
    y = torch.from_numpy((rng.random((batch_size, 1, *grid_zxy)) > 0.97)
                         .astype(np.float32)).to(dev)
    times = {}
    for cand in candidates:
        model = first if cand == candidates[0] else make_model(cand)
        oom = False
        try:
            times[cand] = measure_train_step_ms(model, criterion, x, y, optimizer=optimizer,
                                                iters=iters, graph=graph)
        except Exception as e:  # one infeasible candidate must not end the run
            if not _is_oom(e):
                raise
            oom = True
        if oom:
            _free_cache()
            print(f"[autotune] candidate {cand!r} OOMs at this shape; skipped")
            times[cand] = float("inf")
        del model
    if not any(np.isfinite(v) for v in times.values()):
        raise RuntimeError(f"every autotune candidate {candidates} OOM'd at batch "
                           f"{batch_size} grid {tuple(grid_zxy)}")
    winner = min(times, key=times.get)

    cache[key] = {"winner": winner, "times_ms": times}
    os.makedirs(os.path.dirname(cache_path), exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(cache_path))
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(cache, f, indent=1)
        os.replace(tmp, cache_path)
    except OSError:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return winner, times
