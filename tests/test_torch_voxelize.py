"""Port parity: voxelization in torch vs the JAX package.

The occupancy and two-channel kernels' plain versions must equal the TPU
kernels (Pallas in interpret mode) exactly on any input, and JAX's CPU
route where both bin recipes agree; the gather ids and the voxel→point
gather must equal JAX's exactly. The counts-grid API (``voxelize_batch``,
``voxelize_batch_hist``, ``voxelize_batch_from_indices``, the
single-sample forms) is held against the JAX functions on the CPU: counts
exact, the normalized density and the tower fraction within 1e-6 (one f32
division each); the numpy host oracle's copy equals the JAX package's
exactly.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from scenenet_tpu.ops import voxel_np as jnp_oracle
from scenenet_tpu.ops import voxelize as jv
from scenenet_tpu.ops.pallas_hist import pallas_points_binary, pallas_points_occupancy
from scenenet_tpu_torch.ops import cuda_hist
from scenenet_tpu_torch.ops import voxel_np as vnp
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


def _tower_inputs(grid_seed=1, b=3, n=9000):
    """The inputs of the JAX package's two-channel kernel test."""
    rng = np.random.default_rng(grid_seed)
    pts = rng.uniform(0, 30, (b, n, 3)).astype(np.float32)
    mask = np.arange(n)[None, :] < np.array([9000, 7000, 4500])[:b, None]
    tower = (rng.random((b, n)) < 0.03) & mask
    return pts, mask, tower


@pytest.mark.parametrize("grid", [(64, 64, 64), (16, 16, 16)])
@pytest.mark.parametrize("rounded", [False, True])
def test_binary_plain_equals_pallas_kernel(grid, rounded):
    """Both channels exact, also on a 1 cm lattice where points sit on
    voxel edges: the plain version bins by the kernel's multiply recipe."""
    pts, mask, tower = _tower_inputs()
    if rounded:
        pts = np.round(pts, 2).astype(np.float32)
    want_x, want_y = pallas_points_binary(jnp.asarray(pts), jnp.asarray(mask),
                                          jnp.asarray(tower), grid, interpret=True)
    got_x, got_y = cuda_hist.points_binary(torch.from_numpy(pts), torch.from_numpy(mask),
                                           torch.from_numpy(tower), grid)
    np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))
    np.testing.assert_array_equal(got_y.numpy(), np.asarray(want_y))
    assert 0 < got_y.sum() < got_x.sum()
    # channel x is exactly the occupancy kernel's
    np.testing.assert_array_equal(got_x.numpy(), _port_occ(pts, mask, grid))


@pytest.mark.parametrize("grid", [(12, 10, 14), (16, 16, 16)])
def test_voxelize_batch_binary_equals_jax(grid):
    """JAX's CPU route divides, the port multiplies: on uniform random f32
    coordinates the two recipes give the same bins (checked first), and
    then the grids are equal."""
    rng = np.random.default_rng(7)
    pts = rng.uniform(0, 30, (3, 4000, 3)).astype(np.float32)
    mask = np.arange(4000)[None, :] < np.array([4000, 3100, 2500])[:, None]
    labels = rng.choice([1, 2, 15, 16], size=(3, 4000), p=[0.5, 0.3, 0.1, 0.1]).astype(np.int32)
    tp, tm = torch.from_numpy(pts), torch.from_numpy(mask)
    mul = cuda_hist.flat_ids_mul(tp, tm, grid)
    div = tv.batch_flat_ids(tp, tm, grid)
    assert torch.equal(mul[tm], div[tm])
    for keep in ((15,), (15, 16)):
        want_x, want_y = jv.voxelize_batch_binary(jnp.asarray(pts), jnp.asarray(labels),
                                                  jnp.asarray(mask), keep, grid)
        got_x, got_y = tv.voxelize_batch_binary(tp, torch.from_numpy(labels), tm, keep, grid)
        assert got_x.shape == want_x.shape == (3, grid[2], grid[0], grid[1])
        np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))
        np.testing.assert_array_equal(got_y.numpy(), np.asarray(want_y))


def test_binary_rejects_bad_tower():
    pts = torch.zeros((1, 10, 3))
    mask = torch.ones((1, 10), dtype=torch.bool)
    for tower in (torch.ones((1, 9), dtype=torch.bool), torch.ones((1, 10))):
        with pytest.raises(ValueError):
            cuda_hist.points_binary(pts, mask, tower, (8, 8, 8))


# ---- the counts-grid API -----------------------------------------------------

def _labelled(seed, b=3, n=4000):
    """Uniform random f32 clouds with labels: the multiply and the divide
    recipe give the same bins there (asserted by the tests that need it)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 30, (b, n, 3)).astype(np.float32)
    mask = np.arange(n)[None, :] < np.array([n, n * 3 // 4, n * 5 // 8])[:b, None]
    labels = rng.choice([1, 2, 15, 16], size=(b, n), p=[0.5, 0.3, 0.1, 0.1]).astype(np.int32)
    return pts, mask, labels


def _recipes_agree(pts, mask, grid):
    tp, tm = torch.from_numpy(pts), torch.from_numpy(mask)
    return torch.equal(cuda_hist.flat_ids_mul(tp, tm, grid)[tm],
                       tv.batch_flat_ids(tp, tm, grid)[tm])


def _close(got, want):
    """hist and reg: one f32 division each, in both packages."""
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("keep", [(15,), (15, 16)])
@pytest.mark.parametrize("grid", [(16, 16, 16), (12, 10, 14)])
def test_voxelize_batch_equals_jax(grid, keep):
    pts, mask, labels = _labelled(11)
    assert _recipes_agree(pts, mask, grid)
    want_h, want_r = jv.voxelize_batch(jnp.asarray(pts), jnp.asarray(labels),
                                       jnp.asarray(mask), keep, grid)
    got_h, got_r = tv.voxelize_batch(torch.from_numpy(pts), torch.from_numpy(labels),
                                     torch.from_numpy(mask), keep, grid)
    assert got_h.shape == got_r.shape == (3, grid[2], grid[0], grid[1])
    assert got_h.dtype == got_r.dtype == torch.float32
    _close(got_h, want_h)
    _close(got_r, want_r)
    assert 0 < float(got_r.max()) <= 1 and float(got_h.max()) == 1
    # binarized, the pair is voxelize_batch_binary's
    x, y = tv.voxelize_batch_binary(torch.from_numpy(pts), torch.from_numpy(labels),
                                    torch.from_numpy(mask), keep, grid)
    assert torch.equal((got_h > 0).float(), x) and torch.equal((got_r > 0).float(), y)


@pytest.mark.parametrize("grid", [(16, 16, 16), (12, 10, 14)])
def test_counts_equal_jax_counts(grid):
    """The raw counts behind hist and reg, exactly, against the JAX CPU
    route's two-channel counts."""
    pts, mask, labels = _labelled(12)
    assert _recipes_agree(pts, mask, grid)
    tower = (labels == 15) & mask
    size = grid[0] * grid[1] * grid[2]
    flat = jv.batch_flat_ids(jnp.asarray(pts), jnp.asarray(mask), grid)
    want_c, want_t = jv._mxu_bin_counts2(flat, jnp.asarray(mask), jnp.asarray(tower), size)
    got_c, got_t = cuda_hist.points_bin_counts(torch.from_numpy(pts), torch.from_numpy(mask),
                                               torch.from_numpy(tower), grid)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))


@pytest.mark.parametrize("method", ["mxu", "scatter"])
@pytest.mark.parametrize("grid", [(16, 16, 16), (12, 10, 14)])
def test_voxelize_batch_hist_equals_jax(grid, method):
    pts, mask, _ = _labelled(13)
    assert _recipes_agree(pts, mask, grid)
    want = jv.voxelize_batch_hist(jnp.asarray(pts), jnp.asarray(mask), grid, method=method)
    got = tv.voxelize_batch_hist(torch.from_numpy(pts), torch.from_numpy(mask), grid,
                                 method=method)
    _close(got, want)
    occ = tv.voxelize_batch_occupancy(torch.from_numpy(pts), torch.from_numpy(mask), grid)
    assert torch.equal((got > 0).float(), occ)


def _host_indices(pts64, grid, n_pad):
    """Host-exact flat ids of each sample (the JAX package's oracle), padded
    with zeros."""
    flat = np.zeros((len(pts64), n_pad), np.int32)
    for i, p in enumerate(pts64):
        spec = jnp_oracle.compute_grid_spec(p, grid)
        flat[i, : len(p)] = jnp_oracle._flat_zxy(jnp_oracle.voxel_indices_np(p, spec), spec)
    return flat


@pytest.mark.parametrize("grid", [(16, 16, 16), (12, 10, 14)])
def test_voxelize_batch_from_indices_equals_jax_and_the_oracle(grid):
    """Host-exact indices of 1 cm clouds (points on voxel edges): equal to
    the JAX function, and to the float64 oracle's hist_on_voxel /
    reg_on_voxel within 1e-6."""
    rng = np.random.default_rng(14)
    lengths, n_pad = (3000, 2200, 1500), 3000
    clouds = [np.round(rng.uniform(0, 30, (n, 3)), 2) + 500.0 for n in lengths]
    labels = np.zeros((3, n_pad), np.int32)
    mask = np.zeros((3, n_pad), bool)
    for i, n in enumerate(lengths):
        labels[i, :n] = rng.choice([2, 15], n, p=[0.8, 0.2])
        mask[i, :n] = True
    flat = _host_indices(clouds, grid, n_pad)
    is_tower = labels == 15  # set on no padded point here; masked anyway
    want_h, want_r = jv.voxelize_batch_from_indices(jnp.asarray(flat), jnp.asarray(is_tower),
                                                    jnp.asarray(mask), grid)
    got_h, got_r = tv.voxelize_batch_from_indices(torch.from_numpy(flat),
                                                  torch.from_numpy(is_tower),
                                                  torch.from_numpy(mask), grid)
    _close(got_h, want_h)
    _close(got_r, want_r)
    for i, (p, n) in enumerate(zip(clouds, lengths)):
        np.testing.assert_allclose(got_h[i].numpy(), vnp.hist_on_voxel_np(p, grid),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(got_r[i].numpy(),
                                   vnp.reg_on_voxel_np(p, labels[i, :n], 15, grid),
                                   rtol=0, atol=1e-6)
        one_h, one_r = tv.voxelize_from_indices(torch.from_numpy(flat[i]),
                                                torch.from_numpy(is_tower[i]),
                                                torch.from_numpy(mask[i]), grid)
        jone_h, jone_r = jv.voxelize_from_indices(jnp.asarray(flat[i]), jnp.asarray(is_tower[i]),
                                                  jnp.asarray(mask[i]), grid)
        _close(one_h, jone_h)
        _close(one_r, jone_r)
        assert torch.equal(one_h, got_h[i]) and torch.equal(one_r, got_r[i])


@pytest.mark.parametrize("method", ["scatter", "sort"])
@pytest.mark.parametrize("bounds", [False, True])
def test_single_sample_forms_equal_jax(method, bounds):
    """voxelize_fused / _hist / _reg on a 1 cm cloud: they bin by the divide
    recipe in both packages, so edge points need no care; with and without
    given bounds. ``method`` picks an XLA formulation there, nothing here."""
    grid = (12, 10, 14)
    rng = np.random.default_rng(15)
    pts = np.round(rng.uniform(0, 30, (3500, 3)), 2).astype(np.float32)
    labels = rng.choice([1, 15, 16], 3500).astype(np.int32)
    mask = np.arange(3500) < 3000
    lo = np.array([-1.0, -2.0, 0.0], np.float32) if bounds else None
    hi = np.array([31.0, 33.0, 30.5], np.float32) if bounds else None
    jb = dict(lo=None if lo is None else jnp.asarray(lo), hi=None if hi is None else jnp.asarray(hi))
    tb = dict(lo=None if lo is None else torch.from_numpy(lo),
              hi=None if hi is None else torch.from_numpy(hi))
    jp, jl, jm = jnp.asarray(pts), jnp.asarray(labels), jnp.asarray(mask)
    tp, tl, tm = torch.from_numpy(pts), torch.from_numpy(labels), torch.from_numpy(mask)
    want_h, want_r = jv.voxelize_fused(jp, jl, jm, (15, 16), grid, method=method, **jb)
    got_h, got_r = tv.voxelize_fused(tp, tl, tm, (15, 16), grid, method=method, **tb)
    assert got_h.shape == (14, 12, 10)
    _close(got_h, want_h)
    _close(got_r, want_r)
    _close(tv.voxelize_hist(tp, tm, grid, method=method, **tb),
           jv.voxelize_hist(jp, jm, grid, method=method, **jb))
    _close(tv.voxelize_reg(tp, tl, tm, (15,), grid, method=method, **tb),
           jv.voxelize_reg(jp, jl, jm, (15,), grid, method=method, **jb))


def test_normalize_per_column_equals_jax_and_the_oracle():
    rng = np.random.default_rng(16)
    grid = rng.integers(0, 9, (6, 5, 7)).astype(np.float32)
    grid[:, :, 2] = 3.0  # a constant column scales by 1 and maps to 0
    got = tv.normalize_per_column(torch.from_numpy(grid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jv.normalize_per_column(
        jnp.asarray(grid))))
    np.testing.assert_allclose(got.numpy(), vnp.normalize_per_column_np(grid), atol=1e-6)
    assert float(got[:, :, 2].abs().max()) == 0 and float(got.max()) == 1


@pytest.mark.parametrize("with_geometry", [False, True])
def test_vxg_to_xyz_equals_jax(with_geometry):
    vxg = np.random.default_rng(17).random((3, 4, 5)).astype(np.float32)
    origin = np.array([1.0, -2.0, 0.5], np.float32) if with_geometry else None
    size = np.array([0.5, 0.25, 2.0], np.float32) if with_geometry else None
    want = jv.vxg_to_xyz(jnp.asarray(vxg), None if origin is None else jnp.asarray(origin),
                         None if size is None else jnp.asarray(size))
    got = tv.vxg_to_xyz(torch.from_numpy(vxg),
                        None if origin is None else torch.from_numpy(origin),
                        None if size is None else torch.from_numpy(size))
    assert got.shape == (60, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(got.numpy(), vnp.vxg_to_xyz_np(vxg, origin, size), atol=1e-6)


# ---- the host oracle's copy ----------------------------------------------------

@pytest.mark.parametrize("vxg_size,vox_size", [((16, 16, 16), None), ((12, 10, 14), None),
                                               (None, (2.0, 2.0, 4.0)),
                                               ((64, 64, 64), (1.5, 3.0, 2.5))])
def test_voxel_np_copy_equals_the_jax_package(vxg_size, vox_size):
    """Every function of the numpy oracle, exactly, with bin counts and with
    voxel sizes (where the grid's shape depends on the sample)."""
    rng = np.random.default_rng(18)
    xyz = np.round(rng.uniform([0, 0, 0], [30, 25, 40], (5000, 3)), 2) + 1000.0
    labels = rng.choice([1, 2, 15], 5000)
    spec, jspec = (m.compute_grid_spec(xyz, vxg_size, vox_size) for m in (vnp, jnp_oracle))
    assert spec.shape == jspec.shape and spec.grid_shape_zxy == jspec.grid_shape_zxy
    if vox_size is not None:
        assert spec.shape != (64, 64, 64)
    np.testing.assert_array_equal(spec.xyzmin, jspec.xyzmin)
    np.testing.assert_array_equal(spec.xyzmax, jspec.xyzmax)
    np.testing.assert_array_equal(spec.voxel_size, jspec.voxel_size)
    np.testing.assert_array_equal(spec.segments(1), jspec.segments(1))
    idx = vnp.voxel_indices_np(xyz, spec)
    np.testing.assert_array_equal(idx, jnp_oracle.voxel_indices_np(xyz, jspec))
    np.testing.assert_array_equal(vnp._flat_zxy(idx, spec), jnp_oracle._flat_zxy(idx, jspec))
    kw = dict(vxg_size=vxg_size, vox_size=vox_size)
    np.testing.assert_array_equal(vnp.hist_on_voxel_np(xyz, **kw),
                                  jnp_oracle.hist_on_voxel_np(xyz, **kw))
    np.testing.assert_array_equal(vnp.reg_on_voxel_np(xyz, labels, [15], **kw),
                                  jnp_oracle.reg_on_voxel_np(xyz, labels, [15], **kw))
    np.testing.assert_array_equal(vnp.centroid_hist_on_voxel_np(xyz, **kw),
                                  jnp_oracle.centroid_hist_on_voxel_np(xyz, **kw))
    np.testing.assert_array_equal(vnp.centroid_reg_on_voxel_np(xyz, labels, 15, **kw),
                                  jnp_oracle.centroid_reg_on_voxel_np(xyz, labels, 15, **kw))
    np.testing.assert_array_equal(vnp.classes_on_voxel_np(xyz, labels, spec=spec),
                                  jnp_oracle.classes_on_voxel_np(xyz, labels, spec=jspec))
    grid = vnp.hist_on_voxel_np(xyz, spec=spec)
    np.testing.assert_array_equal(vnp.prob_to_label_np(grid, 0.3),
                                  jnp_oracle.prob_to_label_np(grid, 0.3))
    np.testing.assert_array_equal(vnp.vxg_to_xyz_np(grid, spec.xyzmin, spec.voxel_size),
                                  jnp_oracle.vxg_to_xyz_np(grid, jspec.xyzmin, jspec.voxel_size))
    with pytest.raises(ValueError):
        vnp.compute_grid_spec(xyz, None, None)


# ---- the routing predicate and the large-grid repair ---------------------------

@pytest.mark.parametrize("grid,n,want", [
    ((64, 64, 64), 131072, False), ((64, 64, 64), 10 ** 7, False),
    ((64, 64, 256), 32768, False), ((64, 64, 128), 196608, True),
    ((128, 128, 128), 47683, False), ((128, 128, 128), 47684, True),
    ((128, 128, 128), 131072, True), ((256, 256, 256), 1, True), ((100, 100, 210), 8, True)])
def test_sorted_route_predicate_is_the_jax_package_s(grid, n, want):
    size = grid[0] * grid[1] * grid[2]
    n_hi = -(-size // 512)
    assert tv._use_sorted_hist(n_hi, n, size) == jv._use_sorted_hist(n_hi, n, size) == want
    assert tv._sorted_route(n, grid) == want


def _edge_cloud(grid=(128, 128, 128), span=30.0):
    """Two corner points that pin the cube bounds to [0, span]³, and points
    a 1e-4 voxel above bin edges, on which the multiply and the divide
    recipe disagree (kept: only those)."""
    k = np.arange(1, grid[0], dtype=np.float64)
    cands = []
    for axis in range(3):
        base = ((k + 1e-4) * (span / grid[axis])).astype(np.float32)
        for ulps in range(-4, 5):
            v = base.copy()
            for _ in range(abs(ulps)):
                v = np.nextafter(v, np.float32(np.inf if ulps > 0 else -np.inf))
            p = np.full((len(v), 3), span / 2, np.float32)
            p[:, axis] = v
            cands.append(p)
    corners = np.array([[0, 0, 0], [span, span, span]], np.float32)
    pts = np.concatenate([corners] + cands)[None]
    mask = np.ones(pts.shape[:2], bool)
    tp, tm = torch.from_numpy(pts), torch.from_numpy(mask)
    differ = (cuda_hist.flat_ids_mul(tp, tm, grid) != tv.batch_flat_ids(tp, tm, grid))[0].numpy()
    differ[:2] = True  # keep the corners
    return pts[:, differ]


@pytest.mark.parametrize("entry", ["occupancy", "binary", "batch", "hist"])
def test_large_grid_follows_the_divide_recipe_like_jax(entry):
    """At a grid size where the sorted route holds (128³ with 49152 padded
    points), the JAX package takes its ids from batch_flat_ids (divide) on
    every backend. Points on which the recipes disagree must land where it
    puts them; the same points at a small N, below the route, land by the
    multiply recipe (which shows that the cloud tells the two apart)."""
    grid, n_pad = (128, 128, 128), 49152
    cloud = _edge_cloud(grid)
    n = cloud.shape[1]
    assert n > 20  # the corners and a good many disagreeing points
    pts = np.zeros((1, n_pad, 3), np.float32)
    mask = np.zeros((1, n_pad), bool)
    labels = np.zeros((1, n_pad), np.int32)
    pts[0, :n], mask[0, :n], labels[0, 2:n:2] = cloud[0], True, 15
    assert tv._sorted_route(n_pad, grid) and not tv._sorted_route(n, grid)
    jp, jm, jl = jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(labels)
    tp, tm, tl = torch.from_numpy(pts), torch.from_numpy(mask), torch.from_numpy(labels)
    small = (tp[:, :n], tm[:, :n], tl[:, :n])
    if entry == "occupancy":
        want = [jv.voxelize_batch_occupancy(jp, jm, grid)]
        got = [tv.voxelize_batch_occupancy(tp, tm, grid)]
        low = [tv.voxelize_batch_occupancy(small[0], small[1], grid)]
    elif entry == "binary":
        want = jv.voxelize_batch_binary(jp, jl, jm, (15,), grid)
        got = tv.voxelize_batch_binary(tp, tl, tm, (15,), grid)
        low = tv.voxelize_batch_binary(small[0], small[2], small[1], (15,), grid)
    else:
        # the JAX CPU route of these two builds a one-hot product over all
        # 128³ bins for minutes: hold them to its ids and a bincount
        flat = np.asarray(jv.batch_flat_ids(jp, jm, grid))[0, :n]
        counts = np.bincount(flat, minlength=128 ** 3).astype(np.float32)
        towers = np.bincount(flat[labels[0, :n] == 15], minlength=128 ** 3).astype(np.float32)
        counts, towers = (a.reshape(1, 128, 128, 128) for a in (counts, towers))
        hist = np.stack([np.asarray(jv.normalize_per_column(jnp.asarray(counts[0])))])
        reg = np.where(counts > 0, towers / np.maximum(counts, 1), 0)
        if entry == "batch":
            want = [hist, reg]
            got = tv.voxelize_batch(tp, tl, tm, (15,), grid)
            low = tv.voxelize_batch(small[0], small[2], small[1], (15,), grid)
        else:
            want = [hist]
            got = [tv.voxelize_batch_hist(tp, tm, grid)]
            low = [tv.voxelize_batch_hist(small[0], small[1], grid)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert any(not torch.equal(g, l) for g, l in zip(got, low))
