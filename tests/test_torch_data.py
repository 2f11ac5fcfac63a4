"""Port parity: the host data layer in the port vs the JAX package.

DBSCAN, the point-cloud geometry of ``data/pcd.py``, the LAS reader and
writer, the transforms, the TS40K dataset, its ETL and the build CLI, the
loaders and the disk cache, each held against the JAX package's function on
the same seeded inputs; then three-step fits through ``cli.train`` on
written crops against the JAX ``Trainer`` fed by the JAX CLI's datasets and
loaders, on each of the three training routes.

Tolerances: everything on the host is exact (the same numpy arithmetic in
the same order), the seeded augmentations included: both packages draw
from a ``numpy.random.default_rng`` of the same seed. The fits: losses and
parameters rtol 1e-5 (atol 1e-6 for parameters that end near 0), as the
trainer parity tests hold them.
"""

import json
import os
import shutil

import numpy as np
import pytest

import jax


import scenenet_tpu.data.pcd as jpcd
import scenenet_tpu.data.transforms as jtr
from scenenet_tpu.cli import train as jcli
from scenenet_tpu.cli.build_samples import main as jax_build_main
from scenenet_tpu.data import TS40K as JaxTS40K
from scenenet_tpu.data.cache import CachedDataset as JaxCachedDataset
from scenenet_tpu.data.las import read_las_xyz_class as jax_read_las
from scenenet_tpu.data.las import write_las as jax_write_las
from scenenet_tpu.data.loader import NativePointCloudLoader as JaxNativeLoader
from scenenet_tpu.data.loader import VoxelLoader as JaxVoxelLoader
from scenenet_tpu.data.loader import random_split as jax_random_split
from scenenet_tpu.data.ts40k import build_data_samples as jax_build_data_samples
from scenenet_tpu.ops.dbscan import dbscan as jax_dbscan
from scenenet_tpu.ops.dbscan import extract_clusters as jax_extract_clusters
from scenenet_tpu.train import TrainConfig as JaxTrainConfig
from scenenet_tpu.train import Trainer as JaxTrainer
from scenenet_tpu.train import make_device_voxelize_prep as jax_prep
from scenenet_tpu.utils.config import ExperimentConfig as JaxExperimentConfig
import scenenet_tpu_torch.data.pcd as pcd
import scenenet_tpu_torch.data.transforms as tr
from scenenet_tpu_torch.cli import train as tcli
from scenenet_tpu_torch.cli.build_samples import main as build_main
from scenenet_tpu_torch.data import (
    TS40K, CachedDataset, Compose, PointPadding, ToFullDense, Voxelization, VoxelLoader,
    build_data_samples,
)
from scenenet_tpu_torch.data.las import read_las_xyz_class, write_las
from scenenet_tpu_torch.data.loader import NativePointCloudLoader, Subset, random_split
from scenenet_tpu_torch.models import SceneNet
from scenenet_tpu_torch.ops.dbscan import dbscan, extract_clusters
from scenenet_tpu_torch.train import restore_checkpoint
from scenenet_tpu_torch.utils.config import ExperimentConfig

GRID = (16, 16, 16)
KS = (9, 5, 5)
MAX_POINTS = 4096
SEED = 55  # the trainer tests' seed: every first gradient well away from 0


def _make_scene(rng, n_towers=2, n_ground=4000):
    """Flat ground and vertical tower-like clusters (class 15)."""
    parts = [np.column_stack([rng.uniform(0, 100, n_ground), rng.uniform(0, 100, n_ground),
                              rng.normal(0, 0.2, n_ground)])]
    classes = [np.full(n_ground, 2.0)]
    for t in range(n_towers):
        parts.append(np.column_stack([rng.normal(25 + 50 * t, 0.8, 400),
                                      rng.normal(50, 0.8, 400), rng.uniform(0, 25, 400)]))
        classes.append(np.full(400, 15.0))
    return np.concatenate(parts), np.concatenate(classes)


def _assert_same(got, want):
    """Equal nested results: arrays bit for bit, with dtype and shape."""
    if isinstance(want, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
        return
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _assert_same(got[k], want[k])
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.fixture
def small_towers(monkeypatch):
    """The synthetic towers are small: both packages' tower extraction at
    eps 3 and 50 points (the test of the JAX package does the same)."""
    for mod in (pcd, jpcd):
        orig = mod.extract_towers
        monkeypatch.setattr(mod, "extract_towers",
                            lambda x, eps=10, min_points=300, orig=orig: orig(x, eps=3,
                                                                              min_points=50))


# ---- DBSCAN -------------------------------------------------------------------

@pytest.mark.parametrize("case", ["two_clusters", "sklearn_mix", "all_noise", "one_point",
                                  "empty", "2d"])
def test_dbscan_labels_equal_jax(case):
    rng = np.random.default_rng(1)
    pts, eps, min_points = {
        "two_clusters": (np.concatenate([rng.normal(0, 0.3, (100, 3)),
                                         rng.normal(10, 0.3, (120, 3)), [[100.0] * 3]]), 1.5, 5),
        "sklearn_mix": (np.concatenate([rng.normal(0, 0.5, (200, 3)),
                                        rng.normal(5, 0.5, (150, 3)),
                                        rng.uniform(-20, 20, (30, 3))]), 1.0, 8),
        "all_noise": (rng.uniform(-100, 100, (50, 3)), 0.5, 3),
        "one_point": (np.zeros((1, 3)), 1.0, 1),
        "empty": (np.zeros((0, 3)), 1.0, 1),
        "2d": (rng.normal(0, 1, (300, 2)), 0.4, 6),
    }[case]
    got = dbscan(pts, eps, min_points)
    _assert_same(got, jax_dbscan(pts, eps, min_points))
    if case == "two_clusters":
        assert got[-1] == -1 and len(set(got[:100])) == 1 and got[0] != got[150]
    _assert_same(extract_clusters(pts, eps, min_points),
                 jax_extract_clusters(pts, eps, min_points))


# ---- point-cloud geometry -----------------------------------------------------

def test_label_taxonomy_equals_jax():
    assert pcd.DICT_NEW_LABELS == jpcd.DICT_NEW_LABELS
    assert pcd.POWER_LINE_SUPPORT_TOWER == jpcd.POWER_LINE_SUPPORT_TOWER == 15
    labels = np.arange(22).repeat(3)
    _assert_same(pcd.remap_labels(labels), jpcd.remap_labels(labels))


@pytest.mark.parametrize("fn", ["select_object", "crop_tower_samples", "crop_tower_radius",
                                "crop_two_towers", "crop_ground_samples", "crop_at_locations",
                                "normalize_xyz", "xyz_centroid", "euclidean_distance"])
def test_pcd_functions_equal_jax(fn):
    rng = np.random.default_rng(3)
    xyz, cls = _make_scene(rng)
    towers = jpcd.extract_towers(xyz[cls == 15], eps=3, min_points=50)
    args = {
        "select_object": (xyz, cls, [15]),
        "crop_tower_samples": (xyz, cls),
        "crop_tower_radius": (xyz, cls, towers[0]),
        "crop_two_towers": (xyz, cls, towers[0], towers[1]),
        "crop_ground_samples": (xyz[cls == 2], cls[cls == 2] + rng.integers(0, 2, 4000)),
        "crop_at_locations": (xyz, np.array([[25.0, 50.0, 0.0], [75.0, 50.0, 0.0]]), 10.0,
                              cls),
        "normalize_xyz": (xyz.reshape(2, -1, 3),),
        "xyz_centroid": (xyz,),
        "euclidean_distance": (xyz[:10], xyz[10:20], 1),
    }[fn]
    kw = {"crop_tower_samples": dict(radius=15, eps=3, min_points=50)}.get(fn, {})
    got, want = getattr(pcd, fn)(*args, **kw), getattr(jpcd, fn)(*args, **kw)
    _assert_same(got, want)
    if fn == "crop_tower_samples":
        assert len(got) == 2 and all((s[:, 3] == 15).sum() > 100 for s in got)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("fn,frac", [("downsampling", 0.5), ("downsampling", 0.8),
                                     ("downsampling_relative_height", 0.8)])
def test_downsampling_equal_jax(small_cloud, fn, frac, seed):
    xyz, classes = small_cloud[:, :3], small_cloud[:, 3]
    got = getattr(pcd, fn)(xyz, classes, frac, seed=seed)
    _assert_same(got, getattr(jpcd, fn)(xyz, classes, frac, seed=seed))
    assert 0 < len(got[0]) < len(xyz)


# ---- LAS ----------------------------------------------------------------------

def test_las_bytes_and_arrays_equal_jax(tmp_path, small_cloud):
    rng = np.random.default_rng(4)
    xyz = small_cloud[:, :3] + np.array([5.4e5, 4.6e6, 150.0])
    cls = rng.integers(0, 32, len(xyz)).astype(np.uint8)
    write_las(str(tmp_path / "port.las"), xyz, cls)
    jax_write_las(str(tmp_path / "jax.las"), xyz, cls)
    assert (tmp_path / "port.las").read_bytes() == (tmp_path / "jax.las").read_bytes()
    got = read_las_xyz_class(str(tmp_path / "port.las"))
    _assert_same(got, jax_read_las(str(tmp_path / "port.las")))
    np.testing.assert_allclose(got[0], xyz, rtol=0, atol=1e-3)  # millimetre scale
    _assert_same(got[1], cls)


def test_las_rejects_what_the_jax_reader_rejects(tmp_path):
    bad = tmp_path / "bad.las"
    bad.write_bytes(b"NOTLAS" + bytes(400))
    with pytest.raises(ValueError, match="not a LAS file"):
        read_las_xyz_class(str(bad))
    with pytest.raises(ValueError, match="not a LAS file"):
        jax_read_las(str(bad))


# ---- transforms ---------------------------------------------------------------

@pytest.mark.parametrize("use_native", [False, True])
@pytest.mark.parametrize("vxg,vox", [((16, 16, 16), None), ((12, 10, 14), None),
                                     (None, (2.0, 2.0, 3.0))])
def test_voxelization_and_full_dense_equal_jax(small_cloud, use_native, vxg, vox):
    sample = (small_cloud[:, :3], small_cloud[:, 3])
    got = Voxelization([15], vox_size=vox, vxg_size=vxg, use_native=use_native)(sample)
    want = jtr.Voxelization([15], vox_size=vox, vxg_size=vxg, use_native=False)(sample)
    _assert_same(got, want)
    assert got[0].dtype == np.float32 and got[0].shape[0] == 1
    dense = Compose([Voxelization([15], vox_size=vox, vxg_size=vxg, use_native=use_native),
                     ToFullDense((True, True))])(sample)
    _assert_same(dense, jtr.Compose([jtr.Voxelization([15], vox_size=vox, vxg_size=vxg,
                                                      use_native=False),
                                     jtr.ToFullDense((True, True))])(sample))
    assert set(np.unique(dense[0])) <= {0.0, 1.0} and dense[1].max() == 1.0
    half = ToFullDense((True, False))(got)
    _assert_same(half, jtr.ToFullDense((True, False))(want))


def test_voxelization_default_uses_native_where_available():
    from scenenet_tpu_torch import native

    assert Voxelization([15]).use_native is native.available()
    with pytest.raises(ValueError, match="must be provided"):
        Voxelization([15], vox_size=None, vxg_size=None)


def test_xyz_transforms_and_pad_equal_jax(small_cloud):
    sample = (small_cloud[:, :3], small_cloud[:, 3])
    got = tr.XYZVoxelization((15,), vxg_size=(16, 16, 16))(sample)
    want = jtr.XYZVoxelization((15,), vxg_size=(16, 16, 16))(sample)
    _assert_same(got, want)
    assert got[0].shape == (1, 3, 16, 16, 16)
    _assert_same(tr.XYZToFullDense()(got), jtr.XYZToFullDense()(want))
    assert tr.xyz_Voxelization is tr.XYZVoxelization
    assert tr.xyz_ToFullDense is tr.XYZToFullDense
    pad = ((1, 2), (0, 1), (3, 0))
    grids = Voxelization([15], vxg_size=(8, 8, 8), use_native=False)(sample)
    _assert_same(tr.AddPad(pad)(grids), jtr.AddPad(pad)(grids))
    assert tr.AddPad(pad)(grids)[0].shape == (1, 11, 9, 11)


@pytest.mark.parametrize("name,kw", [("RandomRotateZ", dict(seed=1)),
                                     ("RandomRotateZ", dict(seed=2, max_angle=0.3)),
                                     ("RandomFlip", dict(seed=0, p=0.5)),
                                     ("RandomFlip", dict(seed=3, p=1.0)),
                                     ("Jitter", dict(sigma=0.01, clip=0.03, seed=0)),
                                     ("Jitter", dict(sigma=0.2, clip=0.05, seed=9))])
def test_seeded_augmentations_equal_jax(small_cloud, name, kw):
    """Each transform holds its own default_rng: five calls in a row draw
    the same numbers in both packages."""
    port, ref = getattr(tr, name)(**kw), getattr(jtr, name)(**kw)
    sample = (small_cloud[:, :3], small_cloud[:, 3])
    for _ in range(5):
        got, want = port(sample), ref(sample)
        _assert_same(got, want)
        sample = got
    assert not np.array_equal(sample[0], small_cloud[:, :3])


@pytest.mark.parametrize("compute_indices", [True, False])
@pytest.mark.parametrize("use_native", [None, False, True])
@pytest.mark.parametrize("n", [3000, 6000])
def test_point_padding_equal_jax(small_cloud, compute_indices, use_native, n):
    """Both index forms, every route of the index, a cloud that fits and one
    that is subsampled: all four arrays exact against the JAX numpy route."""
    rng = np.random.default_rng(n)
    xyz = np.concatenate([small_cloud[:, :3], rng.uniform(0, 30, (n - 3000, 3))])[:n]
    labels = np.concatenate([small_cloud[:, 3], np.full(n - 3000, 2.0)])[:n]
    kw = dict(max_points=MAX_POINTS, vxg_size=(16, 16, 16), compute_indices=compute_indices)
    got = PointPadding(use_native=use_native, **kw)((xyz, labels))
    _assert_same(got, jtr.PointPadding(use_native=False, **kw)((xyz, labels)))
    assert got[2].sum() == min(n, MAX_POINTS)
    assert got[3].any() == compute_indices


def test_point_padding_defaults_equal_jax():
    """The JAX fields and defaults: the native route where available and the
    host-exact index."""
    port, ref = PointPadding(), jtr.PointPadding()
    for field in ("max_points", "vxg_size", "vox_size", "use_native", "compute_indices"):
        assert getattr(port, field) == getattr(ref, field), field
    assert port.compute_indices is True and port.use_native is None


# ---- the TS40K dataset, the loaders, the cache ---------------------------------

@pytest.fixture(scope="module")
def crops(tmp_path_factory):
    """A TS40K-style directory of (N, 4) crops, two of them longer than
    MAX_POINTS, one corrupted file in fit/."""
    root = tmp_path_factory.mktemp("ts40k_data")
    rng = np.random.default_rng(0)
    for split, n in [("fit", 8), ("test", 2)]:
        (root / split).mkdir()
        for i in range(n):
            m = 6000 if i in (2, 5) else int(rng.integers(2000, 4000))
            xyz = rng.uniform([5e5, 4.6e6, 100], [5e5 + 30, 4.6e6 + 30, 160], (m, 3))
            labels = rng.choice([1, 2, 15], size=m, p=[0.5, 0.35, 0.15])
            crop = np.concatenate([xyz, labels[:, None]], axis=1)
            np.save(root / split / f"sample_{i}.npy",
                    crop.astype(np.float32 if i % 3 == 1 else np.float64))
    return str(root)


def _host_grids():
    return Compose([Voxelization([15], vxg_size=(8, 8, 8)), ToFullDense()])


def _jax_host_grids():
    return jtr.Compose([jtr.Voxelization([15], vxg_size=(8, 8, 8), use_native=False),
                        jtr.ToFullDense()])


@pytest.mark.parametrize("split", ["fit", "test"])
def test_ts40k_items_equal_jax(crops, split):
    port = TS40K(crops, split=split, transform=_host_grids())
    ref = JaxTS40K(crops, split=split, transform=_jax_host_grids())
    assert list(port.npy_files) == list(ref.npy_files) and len(port) == len(ref)
    for i in range(len(port)):
        _assert_same(port[i], ref[i])
    raw, jraw = TS40K(crops, split=split), JaxTS40K(crops, split=split)
    _assert_same(raw[0], jraw[0])
    assert str(raw) == str(jraw)
    raw.set_transform(_host_grids())
    assert raw[0][0].shape == (1, 8, 8, 8)


def test_ts40k_corrupted_fallback(crops, tmp_path):
    shutil.copytree(os.path.join(crops, "fit"), tmp_path / "fit")
    (tmp_path / "fit" / "sample_bad.npy").write_bytes(b"not-a-npy")
    ds = TS40K(str(tmp_path), split="fit", transform=_host_grids())
    x, y = ds[list(ds.npy_files).index("sample_bad.npy")]
    assert x.shape == y.shape == (1, 8, 8, 8)


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("shuffle", [True, False])
def test_voxel_loader_batches_equal_jax(crops, shuffle, drop_last):
    port = VoxelLoader(TS40K(crops, "fit", transform=_host_grids()), batch_size=3,
                       shuffle=shuffle, drop_last=drop_last, num_workers=2, seed=4)
    ref = JaxVoxelLoader(JaxTS40K(crops, "fit", transform=_jax_host_grids()), batch_size=3,
                         shuffle=shuffle, drop_last=drop_last, num_workers=2, seed=4)
    assert len(port) == len(ref) == (2 if drop_last else 3)
    for _ in range(2):  # two epochs: the shuffle is random.Random(seed + epoch)
        got, want = list(port), list(ref)
        _assert_same(got, want)
    assert got[0][0].shape == (3, 1, 8, 8, 8)


def test_random_split_and_subset_equal_jax():
    for n, frac, seed in [(100, 0.1, 0), (7, 0.25, 3), (1, 0.5, 1)]:
        assert random_split(n, frac, seed) == jax_random_split(n, frac, seed)
    sub = Subset(list(range(10, 20)), [3, 1])
    assert len(sub) == 2 and sub[0] == 13 and sub[1] == 11


def test_native_loader_epochs_equal_jax(crops):
    """Two shuffled epochs of native batches, over a Subset, ragged tail
    kept: the port's library against the JAX package's, bit for bit (the
    subsampled crops included)."""
    port = NativePointCloudLoader(Subset(TS40K(crops, "fit"), [0, 2, 3, 5, 6]), batch_size=2,
                                  max_points=MAX_POINTS, shuffle=True, seed=1, threads=2)
    from scenenet_tpu.data.loader import Subset as JaxSubset

    ref = JaxNativeLoader(JaxSubset(JaxTS40K(crops, "fit"), [0, 2, 3, 5, 6]), batch_size=2,
                          max_points=MAX_POINTS, shuffle=True, seed=1, threads=2)
    for _ in range(2):
        got, want = list(port), list(ref)
        _assert_same(got, want)
    assert [b[0].shape[0] for b in got] == [2, 2, 1]
    assert got[0][2].dtype == bool and not got[0][3].any()


def test_cached_dataset_equals_jax_and_persists(tmp_path, crops):
    calls = {"n": 0}

    class DS:
        def __len__(self):
            return 3

        def __getitem__(self, i):
            calls["n"] += 1
            return TS40K(crops, "fit", transform=_host_grids())[i]

    port = CachedDataset(DS(), str(tmp_path / "port"))
    ref = JaxCachedDataset(TS40K(crops, "fit", transform=_host_grids()), str(tmp_path / "jax"))
    first, again = port[0], port[0]
    assert calls["n"] == 1
    _assert_same(first, again)
    _assert_same(first, ref[0])
    port.warm()
    assert calls["n"] == 3 and len(os.listdir(tmp_path / "port")) == 3
    assert all(os.path.basename(port._path(i)) == os.path.basename(ref._path(i))
               for i in range(3))


# ---- the ETL and the build CLI -------------------------------------------------

def _write_tiles(las_dir, n_tiles=2, seed=5):
    rng = np.random.default_rng(seed)
    las_dir.mkdir(exist_ok=True)
    for t in range(n_tiles):
        xyz, cls = _make_scene(rng, n_towers=2 + t)
        write_las(str(las_dir / f"tile_{t}.las"), xyz + [1000.0 * t, 0, 0],
                  cls.astype(np.uint8))
    # a tile without towers is read and skipped
    xyz, cls = _make_scene(rng, n_towers=0)
    write_las(str(las_dir / "ground.las"), xyz, cls.astype(np.uint8))


def _tree(root):
    """{relative path: bytes} of every file under root."""
    out = {}
    for dp, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dp, f)
            out[os.path.relpath(path, root)] = open(path, "rb").read()
    return out


@pytest.mark.parametrize("tower_radius", [True, False])
@pytest.mark.parametrize("split", [{"fit": 0.5, "test": 0.5}, {"fit": 0.6, "test": 0.4}, 0])
def test_build_data_samples_files_equal_jax(tmp_path, small_towers, tower_radius, split):
    _write_tiles(tmp_path / "las")
    n = build_data_samples([str(tmp_path / "las")], str(tmp_path / "port"),
                           tower_radius=tower_radius, data_split=split, seed=3)
    n_ref = jax_build_data_samples([str(tmp_path / "las")], str(tmp_path / "jax"),
                                   tower_radius=tower_radius, data_split=split, seed=3)
    assert n == n_ref == 5  # one crop a tower (2 + 3), or one a tower and its nearest
    got, want = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert got == want
    assert sum(k.endswith(".npy") for k in got) == n
    assert json.loads(got["read_files.json"]) == sorted(
        str(tmp_path / "las" / f) for f in os.listdir(tmp_path / "las"))
    # resumable: a second run reads the progress file and crops nothing again (the
    # split is applied again to what fit/ holds, in both packages alike)
    for build, out in ((build_data_samples, "port"), (jax_build_data_samples, "jax")):
        assert build([str(tmp_path / "las")], str(tmp_path / out),
                     tower_radius=tower_radius, data_split=split, seed=3) == n
    again = _tree(tmp_path / "port")
    assert again == _tree(tmp_path / "jax") and again.keys() != {} and sum(
        k.endswith(".npy") for k in again) == n


def test_build_data_samples_resume_does_not_overwrite(tmp_path, small_cloud):
    """A resumed ETL continues from the largest index of every split folder."""
    fit, test = tmp_path / "out" / "fit", tmp_path / "out" / "test"
    fit.mkdir(parents=True)
    test.mkdir()
    np.save(fit / "sample_7.npy", small_cloud)
    np.save(test / "sample_9.npy", small_cloud)
    assert build_data_samples([], str(tmp_path / "out"), data_split=0) == 10


def test_build_samples_cli_ts40k_equals_jax(tmp_path, small_towers, capsys):
    _write_tiles(tmp_path / "las")
    argv = ["ts40k", "--las-dir", str(tmp_path / "las"), "--test-split", "0.4", "--seed", "2"]
    n = build_main(argv + ["--out", str(tmp_path / "port")])
    assert n == jax_build_main(argv + ["--out", str(tmp_path / "jax")]) == 5
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
    assert "wrote 5 ts40k samples" in capsys.readouterr().out
    two = build_main(["ts40k", "--las-dir", str(tmp_path / "las"), "--two-towers",
                      "--out", str(tmp_path / "two")])
    assert two == 5


@pytest.mark.parametrize("argv", [["ts40k", "--las-dir", "x", "--test-split", "1.5"],
                                  ["ts40k", "--las-dir", "x", "--test-split", "-0.1"],
                                  ["nope"], []])
def test_build_samples_cli_rejects_bad_arguments(tmp_path, argv):
    with pytest.raises(SystemExit):
        build_main(argv + (["--out", str(tmp_path)] if argv[:1] == ["ts40k"] else []))


# ---- cli.train's three routes against the JAX Trainer --------------------------

def _route_cfg(root, out, **kw):
    base = dict(data_path=root, output_dir=str(out), batch_size=2, voxel_grid_size=GRID,
                kernel_size=KS, max_points=MAX_POINTS, max_epochs=1, num_workers=2,
                early_stop_metric=None, val_split=0.0, device_cache=False, seed=SEED,
                test_checkpoint="last", checkpoint_top_k=1)
    base.update(kw)
    return base


def _jax_fit(cfg_kw, tmp_path, route):
    """The JAX Trainer over the datasets and the train loader that the JAX
    CLI builds for ``route``: final parameters and the epoch's loss."""
    cfg = JaxExperimentConfig(**cfg_kw)
    train_ds, _, _ = jcli.build_datasets(cfg)
    if route == "native":
        loader = JaxNativeLoader(train_ds, cfg.batch_size, shuffle=True, seed=cfg.seed,
                                 max_points=cfg.max_points, threads=cfg.num_workers,
                                 drop_last=True)
    else:
        loader = JaxVoxelLoader(train_ds, cfg.batch_size, shuffle=True,
                                num_workers=cfg.num_workers, seed=cfg.seed, drop_last=True)
    prep = (jax_prep(GRID, (15,), use_indices=route == "host_indices")
            if cfg.device_voxelization else None)
    jnet, jparams = jcli.build_model(cfg)
    trainer = JaxTrainer(jnet, jcli.build_criterion(cfg),
                         JaxTrainConfig(run_dir=str(tmp_path / "jrun"),
                                        checkpoint_dir=str(tmp_path / "jckpt"),
                                        early_stop_metric=None, max_epochs=1),
                         batch_prep=prep)
    params, best = trainer.fit(jparams, loader, None)
    flat = {".".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    return flat, best["train_loss"]


@pytest.mark.parametrize("route", ["native", "host_indices", "host_grids"])
def test_cli_train_route_matches_jax_trainer(crops, tmp_path, capsys, route):
    """Three steps (6 train crops, batch 2) through ``cli.train`` against
    the JAX Trainer on the JAX CLI's batches of the same route: the native
    loader (bins on the device from the raw points), the Python loader with
    host-exact indices (``--host-indices``), and host voxelization
    (``device_voxelization: false``, no batch prep)."""
    # 8 fit crops: 6 train (two of them subsampled by the padding), 2 validation
    kw = _route_cfg(crops, tmp_path / "out", val_split=0.25,
                    **({"device_voxelization": False} if route == "host_grids" else {}))
    scores = tcli.run(ExperimentConfig(**kw), device="cpu",
                      host_indices=route == "host_indices")
    out = capsys.readouterr().out
    line = {"native": "[loader] -> NativePointCloudLoader",
            "host_indices": "[loader] -> VoxelLoader + PointPadding (--host-indices",
            "host_grids": "[loader] -> VoxelLoader (device_voxelization=false"}[route]
    assert line in out
    want_params, want_loss = _jax_fit(kw, tmp_path, route)
    np.testing.assert_allclose(scores["train_loss"], want_loss, rtol=1e-5)
    net = restore_checkpoint(str(tmp_path / "out" / "scenenet_ts40k" / "checkpoints"
                                 / "last.npz"), SceneNet.create(kernel_size=KS, seed=SEED))
    assert set(dict(net.named_parameters())) <= set(want_params)
    for name, p in net.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_params[name], rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    assert np.isfinite(scores["test_loss"])


def test_cli_train_loader_rule(monkeypatch, capsys):
    """The native loader where device voxelization and the library allow it;
    the Python loader without the library or under --host-indices; host
    grids without device voxelization."""
    from scenenet_tpu_torch import native

    cfg = ExperimentConfig(num_workers=3)
    assert tcli.resolve_loader(cfg) is True
    assert tcli.resolve_loader(cfg, host_indices=True) is False
    assert tcli.resolve_loader(ExperimentConfig(device_voxelization=False)) is False
    monkeypatch.setattr(native, "available", lambda: False)
    assert tcli.resolve_loader(cfg) is False
    out = capsys.readouterr().out.splitlines()
    assert out == [
        "[loader] -> NativePointCloudLoader (threads=3; bins on the device, use_indices=False)",
        "[loader] -> VoxelLoader + PointPadding (--host-indices: host-exact bin indices, "
        "use_indices=True)",
        "[loader] -> VoxelLoader (device_voxelization=false: host grids, no batch prep)",
        "[loader] -> VoxelLoader + PointPadding (native library unavailable: host-exact bin "
        "indices, use_indices=True)"]


def test_cli_build_datasets_equal_jax(crops):
    """build_datasets: the same splits and samples as the JAX CLI's, for
    both transforms."""
    for kw in (dict(device_voxelization=True), dict(device_voxelization=False)):
        cfg = dict(data_path=crops, voxel_grid_size=GRID, max_points=MAX_POINTS,
                   val_split=0.25, seed=3, **kw)
        got = tcli.build_datasets(ExperimentConfig(**cfg))
        want = jcli.build_datasets(JaxExperimentConfig(**cfg))
        for g, w in zip(got, want):
            assert len(g) == len(w)
        assert got[0].indices == want[0].indices and got[1].indices == want[1].indices
        _assert_same(got[0][0], want[0][0])
        _assert_same(got[2][1], want[2][1])
    with pytest.raises(NotImplementedError, match="nope"):
        tcli.build_datasets(ExperimentConfig(data_path=crops, dataset="nope"))


def test_cli_explicit_cache_needs_device_voxelization(crops, tmp_path):
    cfg = ExperimentConfig(**_route_cfg(crops, tmp_path, device_voxelization=False,
                                        device_cache="grids"))
    with pytest.raises(ValueError, match="device_voxelization"):
        tcli.run(cfg, device="cpu")

