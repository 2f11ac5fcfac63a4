"""Port parity: the port's native (C++) host kernels vs the JAX package.

The port builds its own copies of ``voxel_native.cpp`` and
``batch_loader.cpp`` into ``build/native/``; these tests hold that library
bit for bit against the numpy oracles of both packages and against the JAX
package's own native library, and check how it is built: keyed on the
sources' hash, published atomically, and absent (``available()`` False)
where no compiler exists.

Tolerances: none but one. Voxelization, bin indices, LAS decoding (against
the numpy reader) and the batch loader are exact; the JAX library's LAS
decode, built with -march=native, is one double rounding away; DBSCAN's
labels are the same partition as the numpy version's (cluster numbers may
follow another visiting order, as in the JAX package's own test), and equal
to the JAX library's labels.
"""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from scenenet_tpu import native as jax_native
from scenenet_tpu.data.las import write_las as jax_write_las
from scenenet_tpu.data.loader import NativePointCloudLoader as JaxNativeLoader
from scenenet_tpu.data.ts40k import TS40K as JaxTS40K
from scenenet_tpu.ops import voxel_np as jax_vnp
from scenenet_tpu_torch import native
from scenenet_tpu_torch.data.las import read_las_xyz_class, write_las
from scenenet_tpu_torch.data.loader import NativePointCloudLoader, Subset
from scenenet_tpu_torch.data.transforms import PointPadding, Voxelization
from scenenet_tpu_torch.data.ts40k import TS40K
from scenenet_tpu_torch.ops import voxel_np as vnp
from scenenet_tpu_torch.ops.dbscan import dbscan

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _native_libraries():
    """Both libraries must load where these tests run: g++ builds the
    port's (the tests of the JAX package use its library too)."""
    assert native.available(), "the port's native library did not build"
    assert jax_native.available(), "the JAX package's native library did not load"


def _flat(idx, shape):
    n_x, n_y, _ = shape
    return (idx[:, 2] * n_x + idx[:, 0]) * n_y + idx[:, 1]


# ---- voxelization ---------------------------------------------------------------

@pytest.mark.parametrize("vxg", [(64, 64, 64), (16, 16, 16), (12, 10, 14), (64, 64, 256)])
def test_voxelize_bit_exact_vs_both_oracles_and_jax_library(sample_clouds, vxg):
    for cloud in sample_clouds[:3]:
        xyz, labels = cloud[:, :3], cloud[:, 3]
        counts, reg, spec, idx = native.voxelize_native(xyz, labels, (15,), vxg,
                                                        want_indices=True)
        oracle = vnp.compute_grid_spec(xyz, vxg)
        np.testing.assert_array_equal(vnp.normalize_per_column_np(counts),
                                      vnp.hist_on_voxel_np(xyz, spec=oracle))
        np.testing.assert_array_equal(reg, vnp.reg_on_voxel_np(xyz, labels, 15, spec=oracle))
        np.testing.assert_array_equal(idx, _flat(vnp.voxel_indices_np(xyz, oracle), vxg))
        joracle = jax_vnp.compute_grid_spec(xyz, vxg)
        np.testing.assert_array_equal(idx, _flat(jax_vnp.voxel_indices_np(xyz, joracle), vxg))
        want = jax_native.voxelize_native(xyz, labels, (15,), vxg, want_indices=True)
        for got, ref in zip((counts, reg, idx), (want[0], want[1], want[3])):
            assert got.dtype == ref.dtype and got.shape == ref.shape
            np.testing.assert_array_equal(got, ref)
        assert spec["shape"] == want[2]["shape"] == tuple(vxg)
        np.testing.assert_array_equal(spec["xyzmin"], want[2]["xyzmin"])
        np.testing.assert_array_equal(spec["xyzmax"], want[2]["xyzmax"])


@pytest.mark.parametrize("vox", [(0.5, 0.5, 0.2), (2.0, 2.0, 3.0), (1.0, 3.0, 0.7)])
def test_voxelize_vox_size_mode(small_cloud, vox):
    xyz, labels = small_cloud[:, :3], small_cloud[:, 3]
    counts, reg, spec, idx = native.voxelize_native(xyz, labels, (15,), None, vox_size=vox,
                                                    want_indices=True)
    oracle = vnp.compute_grid_spec(xyz, None, vox)
    assert tuple(spec["shape"]) == oracle.shape
    np.testing.assert_array_equal(vnp.normalize_per_column_np(counts),
                                  vnp.hist_on_voxel_np(xyz, spec=oracle))
    np.testing.assert_array_equal(idx, _flat(vnp.voxel_indices_np(xyz, oracle), oracle.shape))
    want = jax_native.voxelize_native(xyz, labels, (15,), None, vox_size=vox,
                                      want_indices=True)
    np.testing.assert_array_equal(counts, want[0])
    np.testing.assert_array_equal(reg, want[1])


@pytest.mark.parametrize("keep", [(2, 15), (1,), (1, 2, 15)])
def test_voxelize_keep_labels(small_cloud, keep):
    xyz, labels = small_cloud[:, :3], small_cloud[:, 3]
    _, reg, _ = native.voxelize_native(xyz, labels, keep, (16, 16, 16))
    np.testing.assert_array_equal(reg, vnp.reg_on_voxel_np(xyz, labels, list(keep),
                                                           (16, 16, 16)))
    np.testing.assert_array_equal(reg, jax_native.voxelize_native(xyz, labels, keep,
                                                                  (16, 16, 16))[1])


def test_voxelize_without_labels_and_empty(small_cloud):
    counts, reg, _ = native.voxelize_native(small_cloud[:, :3], None, (15,), (8, 8, 8))
    assert counts.sum() == len(small_cloud) and not reg.any()
    with pytest.raises(RuntimeError, match="snt_voxelize failed"):
        native.voxelize_native(np.zeros((0, 3)), None)


# ---- DBSCAN and LAS ----------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dbscan_native_partition_and_jax_library(seed):
    rng = np.random.default_rng(seed)
    pts = np.concatenate([rng.normal(0, 0.4, (300, 3)), rng.normal(6, 0.4, (200, 3)),
                          rng.uniform(-30, 30, (40, 3))])
    ours = native.dbscan_native(pts, eps=1.0, min_points=8)
    ref = dbscan(pts, eps=1.0, min_points=8)
    np.testing.assert_array_equal(ours == -1, ref == -1)
    for c in set(ref) - {-1}:
        assert len(set(ours[ref == c]) - {-1}) == 1
    np.testing.assert_array_equal(ours, jax_native.dbscan_native(pts, eps=1.0, min_points=8))


def test_read_las_native_equals_python_and_jax(tmp_path, small_cloud):
    xyz = small_cloud[:, :3] + np.array([5.4e5, 4.6e6, 150.0])
    cls = small_cloud[:, 3].astype(np.uint8)
    write_las(str(tmp_path / "a.las"), xyz, cls)
    jax_write_las(str(tmp_path / "b.las"), xyz, cls)
    got = native.read_las_native(str(tmp_path / "a.las"))
    for g, w in zip(got, read_las_xyz_class(str(tmp_path / "a.las"))):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    # the JAX package's library is built with -march=native, which lets the
    # compiler fuse int * scale + offset into one FMA: one rounding apart at
    # most (2.9e-14 m on 4.6e6 m here)
    jax_xyz, jax_cls = jax_native.read_las_native(str(tmp_path / "b.las"))
    np.testing.assert_allclose(got[0], jax_xyz, rtol=2 ** -52, atol=0)
    np.testing.assert_array_equal(got[1], jax_cls)
    with pytest.raises(ValueError, match="snt_read_las failed"):
        native.read_las_native(str(tmp_path / "missing.las"))


# ---- the transforms' native routes --------------------------------------------------

@pytest.mark.parametrize("vxg", [(16, 16, 16), (64, 64, 64)])
def test_transforms_native_route_equals_numpy_route(small_cloud, vxg):
    sample = (small_cloud[:, :3], small_cloud[:, 3])
    for a, b in zip(Voxelization([15], vxg_size=vxg, use_native=True)(sample),
                    Voxelization([15], vxg_size=vxg, use_native=False)(sample)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(PointPadding(max_points=4096, vxg_size=vxg, use_native=True)(sample),
                    PointPadding(max_points=4096, vxg_size=vxg, use_native=False)(sample)):
        np.testing.assert_array_equal(a, b)


# ---- the batch loader -------------------------------------------------------------

def _crops(tmp_path, sizes=(3000, 4000, 5000, 70000, 2000)):
    rng = np.random.default_rng(0)
    root = tmp_path / "fit"
    root.mkdir(parents=True, exist_ok=True)
    paths = []
    for i, m in enumerate(sizes):
        xyz = rng.uniform([5e5, 4.6e6, 100], [5e5 + 30, 4.6e6 + 30, 160], (m, 3))
        crop = np.concatenate([xyz, rng.choice([1, 2, 15], m)[:, None]], 1)
        p = root / f"sample_{i}.npy"
        # both dtypes of the crops: f64 (the ETL's) and f32
        np.save(p, crop.astype(np.float64 if i % 2 == 0 else np.float32))
        paths.append(str(p))
    return paths


@pytest.mark.parametrize("threads", [0, 1, 3])
def test_load_batch_equals_jax_library_and_point_padding(tmp_path, threads):
    paths = _crops(tmp_path)
    got = native.load_batch_native(paths, 8192, threads)
    want = jax_native.load_batch_native(paths, 8192, threads)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    pts, labels, mask = got
    pad = PointPadding(max_points=8192, compute_indices=False)
    for i, p in enumerate(paths):
        if i == 3:  # 70000 points: subsampled by the loader's own draw
            assert mask[i].all() and pts[i].min() >= 0
            assert set(np.unique(labels[i])) <= {1, 2, 15}
            continue
        c = np.load(p)
        p0, l0, m0, _ = pad((c[:, :3], c[:, 3]))
        np.testing.assert_array_equal(pts[i], p0)
        np.testing.assert_array_equal(labels[i], l0)
        np.testing.assert_array_equal(mask[i], m0)


def test_native_loader_batches_equal_jax_loader(tmp_path):
    _crops(tmp_path)
    port = NativePointCloudLoader(Subset(TS40K(str(tmp_path), "fit"), [4, 0, 3, 1]),
                                  batch_size=2, max_points=8192, shuffle=True,
                                  drop_last=True, seed=5)
    from scenenet_tpu.data.loader import Subset as JaxSubset

    ref = JaxNativeLoader(JaxSubset(JaxTS40K(str(tmp_path), "fit"), [4, 0, 3, 1]),
                          batch_size=2, max_points=8192, shuffle=True, drop_last=True, seed=5)
    assert len(port) == len(ref) == 2
    for _ in range(2):
        for gb, wb in zip(port, ref):
            assert gb[0].shape == (2, 8192, 3) and gb[3].shape == (2, 8192)
            for g, w in zip(gb, wb):
                np.testing.assert_array_equal(g, w)


def test_load_batch_failure_raises(tmp_path):
    with pytest.raises(ValueError, match="missing.npy"):
        native.load_batch_native([str(tmp_path / "missing.npy")], 64)


# ---- how the library is built -------------------------------------------------------

def test_library_lives_in_build_native_keyed_by_sources():
    path = native.library_path()
    assert path.parent == native.BUILD_DIR and path.exists()
    assert native.BUILD_DIR.parts[-2:] == ("build", "native")
    assert all(src.parent.name == "native" and src.parent.parent.name == "scenenet_tpu_torch"
               for src in native.SOURCES)
    # the JAX package's sources are not the port's files
    for src in native.SOURCES:
        assert os.path.join("scenenet_tpu", "native") not in str(src)


def test_build_is_keyed_and_atomic(tmp_path, monkeypatch):
    """Two builders at once into an empty directory: one library, named by
    the hash; an edited source gets another name."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    cxx = native._compiler()
    out, errors = [], []

    def build():
        try:
            out.append(native.build(cxx))
        except Exception as exc:  # surfaced below
            errors.append(exc)

    threads = [threading.Thread(target=build) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors and not any(t.is_alive() for t in threads)
    assert len(set(out)) == 1 and out[0].exists()
    assert [p.name for p in (tmp_path / "native").iterdir()] == [out[0].name]
    edited = tmp_path / "voxel_native.cpp"
    edited.write_text(native.SOURCES[0].read_text() + "\n// edited\n")
    monkeypatch.setattr(native, "SOURCES", (edited, native.SOURCES[1]))
    assert native.library_path() != out[0]


def test_no_compiler_means_unavailable(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "none")
    monkeypatch.setattr(native, "_compiler", lambda: None)
    monkeypatch.setattr(native, "_lib", None)
    assert native.available() is False
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native.load_batch_native(["x.npy"], 4)
    # the transforms then take their numpy routes
    assert Voxelization([15]).use_native is False


def test_failed_build_raises(tmp_path, monkeypatch):
    broken = tmp_path / "voxel_native.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(native, "SOURCES", (broken,))
    with pytest.raises(RuntimeError, match="failed"):
        native.build(native._compiler())
    assert not list((tmp_path / "out").iterdir())


@pytest.mark.parametrize("case", ["broken", "missing"])
def test_unbuildable_library_is_unavailable_with_a_reason(case, tmp_path, monkeypatch, capsys):
    """A source that does not compile, or sources that are absent (an
    install without them), make ``available()`` False with the reason
    printed once, as the JAX package's ``load_native`` returns None; the
    transforms then take their numpy routes and a direct call raises."""
    src = tmp_path / "voxel_native.cpp"
    if case == "broken":
        src.write_text("this is not C++\n")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(native, "SOURCES", (src,))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_failed", {})
    assert native.available() is False
    want = "build failed" if case == "broken" else "sources missing"
    out = capsys.readouterr().out
    assert out.count("[native] library unavailable") == 1 and want in out, out
    assert native.available() is False  # remembered: neither rebuilt nor printed again
    assert capsys.readouterr().out == ""
    assert Voxelization([15]).use_native is False
    with pytest.raises(RuntimeError, match=want):
        native.dbscan_native(np.zeros((4, 3)), 1.0, 2)


def test_cli_trains_through_the_python_loader_without_the_library(tmp_path, monkeypatch,
                                                                   capsys):
    """With the library unbuildable, ``cli.train`` streams through the
    Python loader, as the JAX CLI does without its library."""
    from scenenet_tpu_torch.cli import train as tcli

    broken = tmp_path / "voxel_native.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(native, "SOURCES", (broken,))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_failed", {})
    rng = np.random.default_rng(5)
    for split, n in (("fit", 6), ("test", 2)):
        os.makedirs(tmp_path / "data" / split)
        for i in range(n):
            xyz = rng.uniform(0, 8, (300, 3))
            lab = np.where(rng.random(300) < 0.2, 15.0, 2.0)
            np.save(tmp_path / "data" / split / f"sample_{i}.npy",
                    np.column_stack([xyz, lab]).astype(np.float32))
    scores = tcli.main(["--device", "cpu", "--set", f"data_path={tmp_path / 'data'}",
                        "batch_size=2", "voxel_grid_size=(8, 8, 8)", "max_points=512",
                        "max_epochs=1", "num_workers=1", "device_cache=false",
                        "kernel_size=(3, 3, 3)", f"output_dir={tmp_path / 'out_runs'}"])
    out = capsys.readouterr().out
    assert "[native] library unavailable (build failed" in out
    assert "[loader] -> VoxelLoader + PointPadding (native library unavailable" in out
    assert np.isfinite(scores["train_loss"]) and np.isfinite(scores["test_loss"])


def test_port_never_loads_the_jax_library():
    """A fresh interpreter that builds and uses the port's native library
    maps its own ``build/native`` library and never the JAX package's
    ``scenenet_tpu/native/libsnt_native.so``."""
    code = (
        "import sys\n"
        "from scenenet_tpu_torch import native\n"
        "from scenenet_tpu_torch.data import NativePointCloudLoader, Voxelization\n"
        "assert native.available()\n"
        "maps = open('/proc/self/maps').read()\n"
        "assert str(native.library_path()) in maps\n"
        "assert 'scenenet_tpu/native/libsnt_native.so' not in maps\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'scenenet_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    jax_lib = os.path.join(ROOT, "scenenet_tpu", "native", "libsnt_native.so")
    before = os.stat(jax_lib).st_mtime_ns if os.path.exists(jax_lib) else None
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
    after = os.stat(jax_lib).st_mtime_ns if os.path.exists(jax_lib) else None
    assert before == after  # not rebuilt
