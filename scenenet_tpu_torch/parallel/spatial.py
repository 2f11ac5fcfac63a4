"""The spatially sharded SceneNet: a SAME 3D conv on z slabs with halo
exchange.

Counterpart of :mod:`scenenet_tpu.parallel.spatial`. For grids too large
for one device (128³ and up, ``BASELINE.json`` config 5) the grid's Z axis
is split over the mesh's ``space`` axis. A SAME stencil then needs
``(k_z − 1)//2`` planes from the slab below and ``k_z//2`` from the slab
above, exchanged by :func:`~scenenet_tpu_torch.parallel.mesh.shift`; the
slabs at the grid's ends receive zeros, which is SAME's zero padding.
The conv of the extended slab is VALID in z and SAME in x and y, and on
the kernel backend it is B10, the halo form of K2 (forward) and K4 (the
kernel's gradient): :func:`~scenenet_tpu_torch.ops.cuda_conv.halo_stencil_conv`.

``overlap=True`` splits the output by halo dependence, as the JAX package
does: the interior planes read only local planes, so their conv is
launched while the halo transfers are in flight, and the two thin
boundary convs follow once they have arrived. The total conv work is the
same; the default is the serial path (permute, concatenate, one conv),
which the JAX package measured as the faster at config-5 scale.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from scenenet_tpu_torch.ops.conv3d import same_pads
from scenenet_tpu_torch.ops.cuda_conv import geneo_stencil_conv, halo_stencil_conv
from scenenet_tpu_torch.parallel.mesh import Mesh, PendingShift, _resolve, shift


def _valid_z_conv(x_ext: torch.Tensor, kernels: torch.Tensor, backend: str,
                  activation: bool, scratch_dtype: str) -> torch.Tensor:
    """VALID-z / SAME-x/y conv of a z-extended block: the piece the serial
    and the overlapped paths share.

    ``backend="cuda"`` with one channel in and out runs B10:
    :func:`halo_stencil_conv` (differentiable), or for ``scratch_dtype="bf16"``
    (the JAX package's inference route, whose bf16 tap scratch is a TPU
    piece) the forward-only halo form of the f32 stencil, which is exact on
    {0,1} occupancy as the bf16 scratch is. Every other backend takes the
    plain conv, in f32 from the input's values, as the JAX conv's
    ``preferred_element_type``."""
    if backend == "cuda" and kernels.shape[:2] == (1, 1):
        kernel = kernels[0, 0].float()
        if scratch_dtype == "bf16":
            return geneo_stencil_conv(x_ext.detach().float(), kernel.detach(),
                                      activation=activation, z_prepadded=True)
        return halo_stencil_conv(x_ext.float(), kernel, activation)
    pads = same_pads(kernels.shape[2:])[:4] + (0, 0)  # z VALID: the halos are in x_ext
    conv = F.conv3d(F.pad(x_ext.float(), pads), kernels.float())
    return torch.relu(torch.tanh(conv)) if activation else conv


def halo_conv3d(x_local: torch.Tensor, kernels: torch.Tensor, axis_name: str = "space",
                backend: str = "torch", activation: bool = False,
                scratch_dtype: str = "f32", overlap: bool = False,
                mesh: Optional[Mesh] = None) -> torch.Tensor:
    """SAME 3D conv of this rank's z slab (B, C, Z_local, X, Y) of a grid
    split over ``axis_name``: the output keeps the slab's extent, and the
    slabs' outputs concatenated over the axis are the unsharded SAME conv.

    ``overlap=True`` launches the interior conv, which needs no halo,
    before it waits on the transfers, and falls back to the serial path
    where the slab is too thin to have an interior (Z_local ≤ k_z − 1).
    """
    mesh = _resolve(mesh)
    k_z = kernels.shape[2]
    lo = (k_z - 1) // 2  # planes from the slab below
    hi = k_z // 2        # planes from the slab above
    z_local = x_local.shape[2]

    def conv(x_ext):
        return _valid_z_conv(x_ext, kernels, backend, activation, scratch_dtype)

    if lo + hi == 0:
        return conv(x_local)

    def top(x):  # my top `lo` planes: the next slab's lower halo
        return x[:, :, z_local - lo:]

    def bottom(x):  # my bottom `hi` planes: the previous slab's upper halo
        return x[:, :, :hi]

    if not overlap or z_local <= lo + hi:
        parts = []
        if lo > 0:
            parts.append(shift(top(x_local), axis_name, +1, mesh))
        parts.append(x_local)
        if hi > 0:
            parts.append(shift(bottom(x_local), axis_name, -1, mesh))
        return conv(torch.cat(parts, dim=2))

    # post both exchanges, launch the interior, then wait on the halos
    pend_below = (PendingShift(top(x_local), axis_name, +1, mesh)
                  if lo > 0 and mesh.shape[axis_name] > 1 else None)
    pend_above = (PendingShift(bottom(x_local), axis_name, -1, mesh)
                  if hi > 0 and mesh.shape[axis_name] > 1 else None)
    interior = conv(x_local)
    pieces = []
    if lo > 0:
        below = shift(top(x_local), axis_name, +1, mesh, pending=pend_below)
        pieces.append(conv(torch.cat([below, x_local[:, :, :lo + hi]], dim=2)))
    pieces.append(interior)
    if hi > 0:
        above = shift(bottom(x_local), axis_name, -1, mesh, pending=pend_above)
        pieces.append(conv(torch.cat([x_local[:, :, z_local - (lo + hi):], above], dim=2)))
    return torch.cat(pieces, dim=2)


def spatial_scenenet_forward(model, x_local: torch.Tensor, axis_name: str = "space",
                             inference: "bool | str" = False, overlap: bool = False,
                             mesh: Optional[Mesh] = None) -> torch.Tensor:
    """SceneNet's forward on this rank's z slab. The kernel synthesis and
    the convex combination are small and replicated (every rank computes
    them from its own, equal parameters); only the conv touches the slab.
    ``model.backend`` picks the local conv (``cuda``: B10; otherwise the
    plain conv); ``inference`` (any true value, ``"mxu"`` included, as in
    the JAX package) takes the forward-only halo form."""
    combined = model.combined_kernel(x_local.dtype)
    return halo_conv3d(x_local, combined[None, None], axis_name,
                       backend=getattr(model, "backend", "torch"), activation=True,
                       scratch_dtype="bf16" if inference else "f32", overlap=overlap,
                       mesh=mesh)
