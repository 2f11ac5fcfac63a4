"""Starting ranks: the process group from the environment, and a runner
that launches a function on N local ranks with a hard timeout.

``torch.distributed.run`` sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``;
:func:`init_from_env` reads them and gives ``init_process_group`` its
address, world size and rank itself. :func:`run_ranks` sets the same
variables for N fresh interpreters on this host, each running
``python -m scenenet_tpu_torch.parallel.launch``: it is how the tests and
the card's smoke run a multi-rank leg. A rank that fails, or a launch that
outlives its timeout, kills every rank and raises: a send that nobody
receives would otherwise hang the group.
"""

from __future__ import annotations

import argparse
import datetime
import importlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


def free_port() -> int:
    """A port free on localhost now (bound to port 0 and released)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launched() -> bool:
    """Whether this process is a rank of a launch (``WORLD_SIZE`` is set)."""
    return "WORLD_SIZE" in os.environ


def rank_device(device: str = "cuda") -> torch.device:
    """The device of this rank: ``cuda:{LOCAL_RANK % device_count}``, or the
    CPU. With fewer cards than ranks, ranks share a card (gloo only)."""
    if device == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but torch finds no CUDA device; pass --device cpu")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)) % torch.cuda.device_count())


def check_backend(backend: str, device: torch.device, local_world: int) -> None:
    """Refuse what the backend cannot do, before any collective."""
    if backend not in BACKENDS:
        raise ValueError(f"dist backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("the nccl backend needs a CUDA device; use --dist-backend gloo "
                             "on the CPU")
        if local_world > torch.cuda.device_count():
            raise ValueError(f"{local_world} ranks on this node but {torch.cuda.device_count()} "
                             "CUDA device(s): NCCL refuses two ranks on one GPU ('Duplicate "
                             "GPU detected'); use --dist-backend gloo to share a card")


def init_from_env(backend: Optional[str] = None, device: str = "cuda",
                  timeout_s: float = 300.0) -> torch.device:
    """Initialise the process group of this rank from the launch's
    environment and return the rank's device. ``backend`` defaults to
    nccl on ``cuda`` and gloo on ``cpu``."""
    dev = rank_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    world = int(os.environ["WORLD_SIZE"])
    check_backend(backend, dev, int(os.environ.get("LOCAL_WORLD_SIZE", world)))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    addr = os.environ.get("MASTER_ADDR", "localhost")
    # under torch.distributed.run the agent may host the store on MASTER_PORT
    # already, which env:// joins; elsewhere the address is given explicitly
    init = ("env://" if "TORCHELASTIC_RUN_ID" in os.environ
            else f"tcp://{addr}:{os.environ['MASTER_PORT']}")
    dist.init_process_group(
        backend, init_method=init, world_size=world, rank=int(os.environ["RANK"]),
        timeout=datetime.timedelta(seconds=timeout_s),
        **({"device_id": dev} if backend == "nccl" else {}))
    return dev


def run_ranks(target: str, world_size: int, kwargs: Optional[Dict[str, Any]] = None,
              timeout: float = 120.0, path: Optional[str] = None,
              env: Optional[Dict[str, str]] = None) -> List[Any]:
    """Run ``target`` (``"module:function"``) on ``world_size`` local ranks
    and return each rank's result, in rank order.

    Each rank is a fresh interpreter (no ``jax`` reaches it from the
    caller) that initialises the process group from the environment and
    calls ``function(**kwargs)``; what it returns comes back through
    ``torch.save``. ``path`` goes in front of the ranks' ``sys.path``
    (where ``module`` lives). A rank exiting non-zero, or the launch
    outliving ``timeout`` seconds, kills every rank and raises with the
    ranks' last output."""
    port = free_port()
    # the package's own checkout first, wherever the caller runs from
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    out_dir = tempfile.mkdtemp(prefix="snt_ranks_")
    with open(os.path.join(out_dir, "kwargs.json"), "w") as f:
        json.dump(kwargs or {}, f)
    procs = []
    logs = []
    try:
        for rank in range(world_size):
            renv = dict(os.environ)
            renv.update(env or {})
            renv.update(RANK=str(rank), WORLD_SIZE=str(world_size), LOCAL_RANK=str(rank),
                        LOCAL_WORLD_SIZE=str(world_size), MASTER_ADDR="localhost",
                        MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                        PYTHONPATH=os.pathsep.join(
                            p for p in (root, renv.get("PYTHONPATH")) if p))
            log = open(os.path.join(out_dir, f"rank{rank}.log"), "w+")
            logs.append(log)
            cmd = [sys.executable, "-m", "scenenet_tpu_torch.parallel.launch", target, out_dir]
            if path:
                cmd += ["--path", path]
            procs.append(subprocess.Popen(cmd, env=renv, stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        failed = None
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited with {procs[bad[0]].returncode}"
                break
            if time.monotonic() > deadline:
                failed = f"timed out after {timeout:.0f} s"
                break
            time.sleep(0.05)
        if failed is None:
            bad = [r for r, p in enumerate(procs) if p.returncode != 0]
            if bad:
                failed = f"rank {bad[0]} exited with {procs[bad[0]].returncode}"
        if failed is not None:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
            tails = []
            for r, log in enumerate(logs):
                log.seek(0)
                tails.append(f"--- rank {r} ---\n" + log.read()[-3000:])
            raise RuntimeError(f"{target} on {world_size} ranks: {failed}\n" + "\n".join(tails))
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
                for r in range(world_size)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
        for name in os.listdir(out_dir):
            os.remove(os.path.join(out_dir, name))
        os.rmdir(out_dir)


def _main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="one rank of run_ranks")
    parser.add_argument("target")
    parser.add_argument("out_dir")
    parser.add_argument("--path", default=None)
    args = parser.parse_args(argv)
    if args.path:
        sys.path.insert(0, args.path)
    torch.set_num_threads(1)
    with open(os.path.join(args.out_dir, "kwargs.json")) as f:
        kwargs = json.load(f)
    module, name = args.target.split(":")
    fn = getattr(importlib.import_module(module), name)
    rank = int(os.environ["RANK"])
    try:
        result = fn(**kwargs)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    torch.save(result, os.path.join(args.out_dir, f"rank{rank}.pt"))
    return 0


if __name__ == "__main__":
    sys.exit(_main())
