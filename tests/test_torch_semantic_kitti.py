"""Port parity: the SemanticKITTI pipeline in the port vs the JAX package.

On a synthetic sequence fixture (velodyne ``.bin`` scans and ``.label``
files with a pole cluster a scan): the readers, the %-splits of the raw
scans and of the crops, the pole-crop ETL and its CLI, the crops dataset,
training on the crops through ``cli.train --set dataset=semantic_kitti``,
and the reference's KITTI grid (64, 64, 256) through voxelize → conv →
confusion counts.

Tolerances: the host data is exact. At (64, 64, 256): the density grid, the
binarized grids and the confusion counts exact, the probabilities within
1e-5 (f32 conv sums of 225 taps in another order).
"""

import os

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from scenenet_tpu.cli.build_samples import main as jax_build_main
from scenenet_tpu.data import Compose as JaxCompose
from scenenet_tpu.data import ToFullDense as JaxToFullDense
from scenenet_tpu.data import Voxelization as JaxVoxelization
from scenenet_tpu.data import semantic_kitti as jsk
from scenenet_tpu.models import SceneNet as JaxSceneNet
from scenenet_tpu.ops.voxelize import voxelize_batch as jax_voxelize_batch
from scenenet_tpu.train.metrics import init_metric_state as jax_init_metrics
from scenenet_tpu.train.metrics import metric_counts as jax_metric_counts
from scenenet_tpu.train.metrics import update_metrics as jax_update_metrics
from scenenet_tpu_torch.cli import train as tcli
from scenenet_tpu_torch.cli.build_samples import main as build_main
from scenenet_tpu_torch.data import Compose, ToFullDense, Voxelization
from scenenet_tpu_torch.data import semantic_kitti as sk
from scenenet_tpu_torch.models import SceneNet
from scenenet_tpu_torch.ops.voxelize import voxelize_batch
from scenenet_tpu_torch.train import metrics as tmetrics
from scenenet_tpu_torch.utils.config import ExperimentConfig

POLE = sk.POLE_LABEL
KITTI_GRID = (64, 64, 256)  # reference semKITTI.py:453-454


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti")
    rng = np.random.default_rng(0)
    for seq in (0, 1):
        vel = root / "sequences" / f"{seq:02d}" / "velodyne"
        lab = root / "sequences" / f"{seq:02d}" / "labels"
        vel.mkdir(parents=True)
        lab.mkdir(parents=True)
        for scan_i in range(5):
            xyz = rng.uniform(-20, 20, (3000, 3)).astype(np.float32)
            labels = rng.choice([40, 70, 80], size=3000, p=[0.6, 0.3, 0.1]).astype(np.uint32)
            pole = np.column_stack([rng.normal(5, 0.2, 60), rng.normal(5, 0.2, 60),
                                    rng.uniform(0, 6, 60)]).astype(np.float32)
            xyz = np.concatenate([xyz, pole])
            labels = np.concatenate([labels, np.full(60, POLE, np.uint32)])
            # an instance id in the high 16 bits, which the reader masks off
            packed = labels | (np.uint32(7) << 16)
            scan = np.concatenate([xyz, np.zeros((len(xyz), 1), np.float32)], axis=1)
            scan.tofile(vel / f"{scan_i:06d}.bin")
            packed.tofile(lab / f"{scan_i:06d}.label")
    return str(root)


@pytest.fixture(scope="module")
def crops_root(kitti_root, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("kitti_crops"))
    sk.build_pole_radius_samples(kitti_root, out)
    return out


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_readers_equal_jax(kitti_root):
    for seq in ("00", "01"):
        scan = os.path.join(kitti_root, "sequences", seq, "velodyne", "000003.bin")
        label = os.path.join(kitti_root, "sequences", seq, "labels", "000003.label")
        _same(sk.read_velodyne_scan(scan), jsk.read_velodyne_scan(scan))
        _same(sk.read_kitti_label(label), jsk.read_kitti_label(label))
        assert set(np.unique(sk.read_kitti_label(label))) <= {40, 70, 80}


@pytest.mark.parametrize("split", ["samples", "train", "val", "test"])
def test_scan_splits_and_items_equal_jax(kitti_root, split):
    port, ref = sk.SemanticKITTI(kitti_root, split=split), jsk.SemanticKITTI(kitti_root,
                                                                            split=split)
    assert list(port.scan_names) == list(ref.scan_names)
    assert list(port.label_names) == list(ref.label_names)
    for i in range(len(port)):
        for a, b in zip(port[i], ref[i]):
            _same(a, b)
    assert len(sk.SemanticKITTI(kitti_root, sequences=[1])) == 5


def test_scan_splits_partition(kitti_root):
    sizes = {s: len(sk.SemanticKITTI(kitti_root, split=s))
             for s in ("samples", "train", "val", "test")}
    assert sizes["samples"] == 10 and sizes["train"] + sizes["val"] + sizes["test"] == 10


def test_scans_with_voxelization_equal_jax(kitti_root):
    t = Compose([Voxelization([POLE], vxg_size=(16, 16, 16)), ToFullDense((True, True))])
    jt = JaxCompose([JaxVoxelization([POLE], vxg_size=(16, 16, 16), use_native=False),
                     JaxToFullDense((True, True))])
    port = sk.SemanticKITTI(kitti_root, transform=t)
    ref = jsk.SemanticKITTI(kitti_root, transform=jt)
    for i in (0, 7):
        for a, b in zip(port[i], ref[i]):
            _same(a, b)
    assert port[0][1].sum() > 0  # the pole shows up in the target


def test_crop_pole_samples_equal_jax(kitti_root):
    scan = sk.SemanticKITTI(kitti_root)
    xyz, labels = (np.squeeze(a) for a in scan[2])
    got = sk.crop_pole_samples(xyz, labels)
    want = jsk.crop_pole_samples(xyz, labels)
    assert len(got) == len(want) >= 1
    for a, b in zip(got, want):
        _same(a, b)


@pytest.mark.parametrize("min_pole_points", [5, 40])
def test_build_pole_radius_samples_files_equal_jax(kitti_root, tmp_path, min_pole_points):
    n = sk.build_pole_radius_samples(kitti_root, str(tmp_path / "port"), min_pole_points)
    assert n == jsk.build_pole_radius_samples(kitti_root, str(tmp_path / "jax"),
                                              min_pole_points)
    assert n >= 5
    names = sorted(os.listdir(tmp_path / "port" / "samples"))
    assert names == sorted(os.listdir(tmp_path / "jax" / "samples")) and len(names) == n
    for name in names:
        assert ((tmp_path / "port" / "samples" / name).read_bytes()
                == (tmp_path / "jax" / "samples" / name).read_bytes())


@pytest.mark.parametrize("command", ["semantic_kitti", "kitti"])
def test_build_samples_cli_equals_jax(kitti_root, tmp_path, command, capsys):
    n = build_main([command, "--dataset", kitti_root, "--out", str(tmp_path / "port")])
    assert n == jax_build_main(["kitti", "--dataset", kitti_root, "--out",
                                str(tmp_path / "jax")])
    assert f"wrote {n} kitti pole crops" in capsys.readouterr().out
    assert sorted(os.listdir(tmp_path / "port" / "samples")) == sorted(
        os.listdir(tmp_path / "jax" / "samples"))


@pytest.mark.parametrize("split", ["samples", "train", "val", "test"])
def test_crops_dataset_equal_jax(crops_root, split):
    port, ref = sk.SemanticKITTICrops(crops_root, split), jsk.SemanticKITTICrops(crops_root,
                                                                                split)
    assert list(port.npy_files) == list(ref.npy_files) and str(port) == str(ref)
    for i in range(len(port)):
        for a, b in zip(port[i], ref[i]):
            _same(a, b)
        for a, b in zip(port.get_item_no_transform(i), ref.get_item_no_transform(i)):
            _same(a, b)
    for a, b in zip(port.get_item_from_path(0), ref.get_item_from_path(0)):
        _same(a, b)
    other = sk.SemanticKITTICrops(crops_root, split, seed=1)
    assert sorted(other.npy_files) != sorted(port.npy_files) or split == "samples"


def test_crops_dummy_sample_on_failure(crops_root, tmp_path):
    (tmp_path / "samples").mkdir()
    (tmp_path / "samples" / "broken.npy").write_bytes(b"not-a-npy")
    port, ref = sk.SemanticKITTICrops(str(tmp_path)), jsk.SemanticKITTICrops(str(tmp_path))
    for a, b in zip(port[0], ref[0]):
        _same(a, b)
    assert port[0][0].shape == (1, 100, 3)


def test_cli_trains_on_kitti_crops(crops_root, tmp_path, capsys):
    """``dataset: semantic_kitti`` through the train CLI at the pole label,
    streamed through the native loader, and through the default route."""
    base = dict(data_path=crops_root, dataset="semantic_kitti", output_dir=str(tmp_path),
                batch_size=1, voxel_grid_size=(16, 16, 32), kernel_size=(9, 5, 5),
                max_points=4096, max_epochs=1, num_workers=1, early_stop_metric=None,
                val_split=0.0, keep_labels=(POLE,), test_checkpoint="last")
    streamed = tcli.run(ExperimentConfig(**base, device_cache=False), device="cpu")
    assert np.isfinite(streamed["train_loss"]) and np.isfinite(streamed["test_loss"])
    out = capsys.readouterr().out
    assert "[loader] -> NativePointCloudLoader" in out
    cached = tcli.run(ExperimentConfig(**dict(base, output_dir=str(tmp_path / "c"))),
                      device="cpu")
    assert np.isfinite(cached["train_loss"])
    assert "[device_cache auto] -> 'grids'" in capsys.readouterr().out


def test_kitti_grid_voxelize_conv_metrics_equal_jax(crops_root):
    """The reference's KITTI grid (64, 64, 256) with the (9,5,5) kernels:
    the port's voxelize → SceneNet → confusion counts against the JAX
    package's on the same padded crops."""
    ds = sk.SemanticKITTICrops(crops_root, split="samples")
    b, max_points = 2, 4096
    pts = np.zeros((b, max_points, 3), np.float32)
    labels = np.zeros((b, max_points), np.int32)
    mask = np.zeros((b, max_points), bool)
    for i in range(b):
        xyz, lab = (np.asarray(a) for a in ds[i])
        xyz, lab = xyz.reshape(-1, 3), lab.reshape(-1)
        n = min(len(xyz), max_points)
        pts[i, :n] = xyz[:n] - xyz[:n].min(0)
        labels[i, :n] = lab[:n]
        mask[i, :n] = True
    hist, reg = voxelize_batch(*(torch.from_numpy(a) for a in (pts, labels, mask)), (POLE,),
                               KITTI_GRID)
    jhist, jreg = jax_voxelize_batch(*(jnp.asarray(a) for a in (pts, labels, mask)), (POLE,),
                                     KITTI_GRID)
    assert tuple(hist.shape) == (b, 256, 64, 64)
    x = (hist > 0).float()[:, None]
    y = (reg > 0).float()[:, None]
    np.testing.assert_array_equal(x.numpy(), np.asarray(jhist > 0)[:, None])
    np.testing.assert_array_equal(y.numpy(), np.asarray(jreg > 0)[:, None])
    np.testing.assert_array_equal(hist.numpy(), np.asarray(jhist))
    assert float(x.sum()) > 0 and float(y.sum()) > 0

    geneos = {"cy": 1, "cone": 1, "neg": 1}
    jnet, jparams = JaxSceneNet.create(geneos, kernel_size=(9, 5, 5), seed=0)
    want = np.asarray(jnet.apply(jparams, jnp.asarray(x.numpy())))
    for backend in ("torch", "cuda"):  # the plain conv, and the kernel's plain version
        net = SceneNet.create(geneos, kernel_size=(9, 5, 5), seed=0, backend=backend)
        with torch.no_grad():
            pred = net(x)
        np.testing.assert_allclose(pred.numpy(), want, rtol=0, atol=1e-5)
        counts = tmetrics.metric_counts(tmetrics.update_metrics(
            tmetrics.init_metric_state(), pred, y, 0.65))
        jcounts = jax_metric_counts(jax_update_metrics(jax_init_metrics(), jnp.asarray(want),
                                                       jnp.asarray(y.numpy()), 0.65))
        assert counts == jcounts
        assert sum(counts) == b * np.prod(KITTI_GRID)
