"""Port parity: voxelization in torch vs the JAX package.

The occupancy kernel's plain version must equal the TPU kernel (Pallas in
interpret mode) and JAX's CPU route exactly; the gather ids and the
voxel→point gather must equal JAX's exactly.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from scenenet_tpu.ops import voxelize as jv
from scenenet_tpu.ops.pallas_hist import pallas_points_occupancy
from scenenet_tpu_torch.ops import cuda_hist
from scenenet_tpu_torch.ops import voxelize as tv


def _clouds(seed, b=3, n=9000, span=30.0):
    """Padded clouds on a 1 cm lattice (points land on voxel edges), with
    ragged valid lengths."""
    rng = np.random.default_rng(seed)
    pts = np.round(rng.uniform(0, span, (b, n, 3)), 2).astype(np.float32)
    lengths = np.array([n, 7000, 4500][:b])
    mask = np.arange(n)[None, :] < lengths[:, None]
    return pts, mask


def _full_column():
    """Every voxel of y column 0 holds ≥ 2 points (one holds 3): the rule
    ``count > column min`` differs there from ``count > 0``."""
    pts = [[ix + 0.5, 0.5, iz + 0.5] for iz in range(8) for ix in range(8) for _ in range(2)]
    pts += [[0.5, 0.5, 0.5], [7.9, 7.9, 7.9]]
    pts = np.asarray(pts, np.float32)[None]
    return pts, np.ones(pts.shape[:2], bool)


def _port_occ(pts, mask, grid):
    return cuda_hist.points_occupancy(torch.from_numpy(pts), torch.from_numpy(mask),
                                      grid).numpy()


@pytest.mark.parametrize("grid,seed", [((16, 16, 16), 0), ((32, 32, 32), 1)])
def test_occupancy_plain_equals_pallas_kernel(grid, seed):
    pts, mask = _clouds(seed)
    want = np.asarray(pallas_points_occupancy(jnp.asarray(pts), jnp.asarray(mask), grid,
                                              interpret=True))
    got = _port_occ(pts, mask, grid)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_occupancy_full_column_equals_pallas_kernel():
    pts, mask = _full_column()
    want = np.asarray(pallas_points_occupancy(jnp.asarray(pts), jnp.asarray(mask),
                                              (8, 8, 8), interpret=True))
    got = _port_occ(pts, mask, (8, 8, 8))
    np.testing.assert_array_equal(got, want)
    col0 = got.reshape(8, 8, 8)[:, :, 0]
    assert col0.sum() == 1 and col0[0, 0] == 1


@pytest.mark.parametrize("grid", [(12, 10, 14), (16, 16, 16)])
def test_voxelize_batch_occupancy_equals_jax(grid):
    """(12, 10, 14) is a grid the TPU kernel refuses (512 % n_y != 0); JAX's
    CPU route and the port both take it."""
    pts, mask = _clouds(2)
    want = np.asarray(jv.voxelize_batch_occupancy(jnp.asarray(pts), jnp.asarray(mask),
                                                  grid))
    got = tv.voxelize_batch_occupancy(torch.from_numpy(pts), torch.from_numpy(mask),
                                      grid).numpy()
    assert got.shape == want.shape == (3, grid[2], grid[0], grid[1])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("grid", [(16, 16, 16), (12, 10, 14)])
def test_batch_flat_ids_equal_jax(grid):
    pts, mask = _clouds(3)
    want = np.asarray(jv.batch_flat_ids(jnp.asarray(pts), jnp.asarray(mask), grid))
    got = tv.batch_flat_ids(torch.from_numpy(pts), torch.from_numpy(mask), grid).numpy()
    np.testing.assert_array_equal(got, want)
    lo_j, hi_j = jv.grid_bounds(jnp.asarray(pts[0]), jnp.asarray(mask[0]))
    lo_t, hi_t = tv.grid_bounds(torch.from_numpy(pts[0]), torch.from_numpy(mask[0]))
    np.testing.assert_array_equal(lo_t.numpy(), np.asarray(lo_j))
    np.testing.assert_array_equal(hi_t.numpy(), np.asarray(hi_j))


def test_zero_extent_cloud_bins_like_jax():
    """All points equal: the divide recipe's 0/0 must land in bin 0 as it
    does under XLA's conversion."""
    pts = np.zeros((1, 16, 3), np.float32)
    mask = np.ones((1, 16), bool)
    want = np.asarray(jv.batch_flat_ids(jnp.asarray(pts), jnp.asarray(mask), (8, 8, 8)))
    got = tv.batch_flat_ids(torch.from_numpy(pts), torch.from_numpy(mask), (8, 8, 8))
    np.testing.assert_array_equal(got.numpy(), want)
    occ = _port_occ(pts, mask, (8, 8, 8))
    assert occ.sum() == 1 and occ[0, 0] == 1


def test_gather_point_values_and_labels_equal_jax():
    rng = np.random.default_rng(4)
    grid = (12, 10, 14)
    pts, mask = _clouds(5, b=2, n=3000)
    pred = rng.random((2, grid[2], grid[0], grid[1])).astype(np.float32)
    flat = tv.batch_flat_ids(torch.from_numpy(pts), torch.from_numpy(mask), grid)
    got = tv.gather_point_values(torch.from_numpy(pred), flat, torch.from_numpy(mask))
    want = jv.gather_point_values(jnp.asarray(pred), jnp.asarray(flat.numpy(), jnp.int32),
                                  jnp.asarray(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tv.prob_to_label(got, 0.5).numpy(),
                                  np.asarray(jv.prob_to_label(want, 0.5)))


def test_occupancy_rejects_bad_inputs():
    pts = torch.zeros((1, 10, 3))
    with pytest.raises(ValueError):
        cuda_hist.points_occupancy(pts[0], torch.ones(10, dtype=torch.bool), (8, 8, 8))
    with pytest.raises(TypeError):
        cuda_hist.points_occupancy(pts.double(), torch.ones((1, 10), dtype=torch.bool),
                                   (8, 8, 8))
