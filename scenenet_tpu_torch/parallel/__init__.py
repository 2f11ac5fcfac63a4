"""Mesh parallelism on ``torch.distributed``: the ``data`` and ``space`` axes.

Counterpart of :mod:`scenenet_tpu.parallel` for data parallelism
(:mod:`~scenenet_tpu_torch.parallel.dp`), the z-sharded SceneNet with halo
exchange (:mod:`~scenenet_tpu_torch.parallel.spatial`), the meshes and
their collectives (:mod:`~scenenet_tpu_torch.parallel.mesh`), each rank's
part of a batch (:mod:`~scenenet_tpu_torch.parallel.data`) and the rank
launcher (:mod:`~scenenet_tpu_torch.parallel.launch`). The ``model`` axis
(ensemble members, channel tensor parallelism, the pipeline) is not ported
yet: ROADMAP A12b.
"""

from scenenet_tpu_torch.parallel.data import global_batch_from_local, local_batch_size
from scenenet_tpu_torch.parallel.dp import (
    cast_half, linesearch_value_fn, make_distributed, make_dp_inference_fn,
    make_local_train_step, make_sharded_eval_step, make_sharded_train_step,
    psum_confusion_delta, shard_batch,
)
from scenenet_tpu_torch.parallel.mesh import (
    Mesh, batch_sharding, ensure_replicated, make_hybrid_mesh, make_mesh, pmean, psum,
    replicated_sharding, shift,
)
from scenenet_tpu_torch.parallel.spatial import halo_conv3d, spatial_scenenet_forward

__all__ = [
    "Mesh", "batch_sharding", "cast_half", "ensure_replicated", "global_batch_from_local",
    "halo_conv3d", "linesearch_value_fn", "local_batch_size", "make_distributed",
    "make_dp_inference_fn", "make_hybrid_mesh", "make_local_train_step", "make_mesh",
    "make_sharded_eval_step", "make_sharded_train_step", "pmean", "psum",
    "psum_confusion_delta", "replicated_sharding", "shard_batch", "shift",
    "spatial_scenenet_forward",
]
