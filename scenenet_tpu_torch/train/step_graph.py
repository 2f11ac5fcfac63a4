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

from typing import Callable, Optional

import torch

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
    steps, and once each the launches the capture records. A replay runs
    the recorded launches without calling a wrapper, so it adds to no
    count; what a replay runs on the card is read with ``torch.profiler``.

    ``eager`` runs every call eagerly on a card too: for a step whose
    launches depend on values it reads on the host (L-BFGS's linesearch),
    which a graph cannot hold.
    """

    def __init__(self, step: Callable[[], None], device: torch.device, eager: bool = False):
        self.step = step
        self.device = torch.device(device)
        self.eager = eager
        self.eager_calls = 0
        self.replays = 0
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
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                self.step()
            self.graph = graph
        self.graph.replay()
        self.replays += 1

    def _warm(self) -> None:
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        current = torch.cuda.current_stream(self.device)
        self._side.wait_stream(current)
        with torch.cuda.stream(self._side):
            self.step()
        current.wait_stream(self._side)
        self.eager_calls += 1
