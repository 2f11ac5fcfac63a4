"""Each rank's part of a global batch.

Counterpart of :mod:`scenenet_tpu.parallel.data`. In the JAX package each
process loads its rows of the global batch and
``jax.make_array_from_process_local_data`` assembles the global array.
Here a rank is a process and keeps only its own part: the rows of its
``data`` coordinate, loaded by the rank (the ranks that share a ``data``
coordinate load the same rows), and, with a space axis, its z slab of them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from scenenet_tpu_torch.parallel.mesh import Mesh, Placement


def global_batch_from_local(local_batch: Tuple, mesh: Mesh, batch_axis: str = "data",
                            space_axis: Optional[str] = None) -> Tuple[torch.Tensor, ...]:
    """This rank's tensors of a batch whose rows it loaded itself (the
    global batch is ``local_batch`` times the ``batch_axis`` size): on the
    rank's device, each (B, C, Z, X, Y) tensor cut to the rank's z slab
    where ``space_axis`` is given."""
    slab = Placement(mesh, None, space_axis)
    return tuple(slab(torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a))
                 .to(mesh.device) for a in local_batch)


def local_batch_size(global_batch_size: int, mesh: Optional[Mesh] = None,
                     batch_axis: str = "data") -> int:
    """The rows of a global batch that one rank loads: the batch over the
    ``batch_axis`` shards of ``mesh``, else over the process group's ranks
    (the JAX package's process count)."""
    if mesh is not None:
        n = mesh.shape[batch_axis]
    else:
        n = dist.get_world_size() if dist.is_initialized() else 1
    if global_batch_size % n:
        raise ValueError(f"global batch {global_batch_size} not divisible by {n} processes")
    return global_batch_size // n
