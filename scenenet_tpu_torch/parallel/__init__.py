"""Mesh parallelism on ``torch.distributed``: the ``data``, ``space``,
``model`` and ``stage`` axes.

Counterpart of :mod:`scenenet_tpu.parallel`: data parallelism
(:mod:`~scenenet_tpu_torch.parallel.dp`), the z-sharded SceneNet with halo
exchange (:mod:`~scenenet_tpu_torch.parallel.spatial`), the quantile
ensemble's members over ``model`` (:mod:`~scenenet_tpu_torch.parallel.ep`),
channel tensor parallelism for the UNet and the CNN over ``model``
(:mod:`~scenenet_tpu_torch.parallel.gspmd`), the GPipe pipeline over
``stage`` (:mod:`~scenenet_tpu_torch.parallel.pp`), the meshes and their
collectives (:mod:`~scenenet_tpu_torch.parallel.mesh`), each rank's part of
a batch (:mod:`~scenenet_tpu_torch.parallel.data`) and the rank launcher
(:mod:`~scenenet_tpu_torch.parallel.launch`).
"""

from scenenet_tpu_torch.parallel.data import global_batch_from_local, local_batch_size
from scenenet_tpu_torch.parallel.dp import (
    cast_half, linesearch_value_fn, make_distributed, make_dp_inference_fn,
    make_local_train_step, make_sharded_eval_step, make_sharded_train_step,
    psum_confusion_delta, shard_batch,
)
from scenenet_tpu_torch.parallel.ep import (
    make_ensemble_eval_step, make_ensemble_inference_fn, make_ensemble_train_step,
)
from scenenet_tpu_torch.parallel.gspmd import (
    channel_shardings, channel_specs, make_gspmd_eval_step, make_gspmd_train_step,
)
from scenenet_tpu_torch.parallel.mesh import (
    Mesh, all_gather, batch_sharding, ensure_replicated, make_hybrid_mesh, make_mesh, pmean,
    psum, replicated_sharding, shift,
)
from scenenet_tpu_torch.parallel.pp import (
    cnn_pipeline_params, cnn_unstack_params, make_pipeline_inference_fn,
    make_pipeline_train_step, make_stage_params, pipeline_apply,
)
from scenenet_tpu_torch.parallel.spatial import halo_conv3d, spatial_scenenet_forward

__all__ = [
    "Mesh", "all_gather", "batch_sharding", "cast_half", "channel_shardings", "channel_specs",
    "cnn_pipeline_params", "cnn_unstack_params", "ensure_replicated",
    "global_batch_from_local", "halo_conv3d", "linesearch_value_fn", "local_batch_size",
    "make_distributed", "make_dp_inference_fn", "make_ensemble_eval_step",
    "make_ensemble_inference_fn", "make_ensemble_train_step", "make_gspmd_eval_step",
    "make_gspmd_train_step", "make_hybrid_mesh", "make_local_train_step", "make_mesh",
    "make_pipeline_inference_fn", "make_pipeline_train_step", "make_sharded_eval_step",
    "make_sharded_train_step", "make_stage_params", "pipeline_apply", "pmean", "psum",
    "psum_confusion_delta", "replicated_sharding", "shard_batch", "shift",
    "spatial_scenenet_forward",
]
