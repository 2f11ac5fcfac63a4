"""One train step replayed from a CUDA graph.

The JAX package runs a device-resident epoch as ``lax.scan`` chunks, one
dispatch each. The port's counterpart is one train step captured once as
a ``torch.cuda.CUDAGraph`` and replayed once a batch: a replay is one host
call for the ~380 launches of a SceneNet step (gather, cast, augmentation,
voxelization, kernel synthesis, the conv, the loss, the backward, Adam
and the confusion counts).

The step is a function of no arguments. It reads its inputs from static
device buffers (the epoch's permutation and augmentation draws, drawn
before the replays, and a cursor that it advances itself) and writes its
results into static buffers, so it holds no RNG call and no host sync.
"""

from __future__ import annotations

import gc
from typing import Callable, Dict, Optional

import torch

from scenenet_tpu_torch.ops._build import launch_counts

WARMUP = 3  # eager steps before the capture, as PyTorch's whole-network example takes


class StepGraph:
    """Runs ``step`` once a call.

    On the CPU (the caller put the model and the cache there) every call
    runs ``step`` eagerly. On a card the first ``WARMUP`` calls run it
    eagerly on a side stream: real steps of the epoch, which also make the
    optimizer's state and every lazily built kernel before the capture, as
    PyTorch requires. The next call captures ``step`` into a CUDA graph
    (the capture executes nothing) and replays it; every later call
    replays it. A failed capture raises; nothing falls back to eager steps.

    The kernel wrappers count the launches they make: those of the eager
    steps, and once each the launches the capture records (and runs none
    of). A replay runs the recorded launches without calling a wrapper,
    so it adds to no wrapper's count: ``launches`` keeps what the capture
    recorded, by ``counts()`` (every wrapper's count by default), and
    :meth:`replay_launches` what the replays ran beyond the wrappers'
    counts.

    ``eager`` runs every call eagerly on a card too: for a step whose
    launches depend on values it reads on the host (L-BFGS's linesearch),
    which a graph cannot hold.
    """

    def __init__(self, step: Callable[[], None], device: torch.device, eager: bool = False,
                 counts: Callable[[], Dict[str, int]] = launch_counts):
        self.step = step
        self.device = torch.device(device)
        self.eager = eager
        self.eager_calls = 0
        self.replays = 0
        self._counts = counts
        self.launches = dict.fromkeys(counts(), 0)  # recorded by the capture
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self._side: Optional[torch.cuda.Stream] = None

    @property
    def captured(self) -> bool:
        return self.graph is not None

    def __call__(self) -> None:
        if self.device.type != "cuda" or self.eager:
            self.step()
            self.eager_calls += 1
            return
        if self.graph is None and self.eager_calls < WARMUP:
            self._warm()
            return
        if self.graph is None:
            before = self._counts()
            graph = torch.cuda.CUDAGraph()
            # no collection inside the capture: a dead graph in a reference cycle,
            # freed there, resets its executable on the capturing stream, and that
            # ends the capture ("operation not permitted when stream is capturing")
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(graph):
                    self.step()
            finally:
                if collecting:
                    gc.enable()
            self.graph = graph
            self.launches = {k: v - before.get(k, 0) for k, v in self._counts().items()}
        self.graph.replay()
        self.replays += 1

    @property
    def later_calls(self) -> int:
        """The calls after the first ``WARMUP + 1`` (the warm-ups, then the
        capture and its first replay): on a card, the replays that no
        capture counted."""
        return max(self.eager_calls + self.replays - WARMUP - 1, 0)

    def replay_launches(self) -> Dict[str, int]:
        """The launches the replays ran that no wrapper counted, by kernel:
        the capture counted its recorded launches once and ran none, its
        first replay ran them, and so did every later call. The wrappers'
        counts plus these are the launches that ran."""
        return {k: v * self.later_calls for k, v in self.launches.items()}

    def _warm(self) -> None:
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        current = torch.cuda.current_stream(self.device)
        self._side.wait_stream(current)
        with torch.cuda.stream(self._side):
            self.step()
        current.wait_stream(self._side)
        self.eager_calls += 1
