"""The nnU-Net cell's per-layer readers: the work they count against values
worked by hand at the published configuration; their shares at or under
100% for the kernel times on record (``PERF.md`` §5); nothing read
from a trace without their kernels, span or calls (the parent's, or another
cell's). And the cell's small run on the CPU: correct, and not correct under
each fault and under the TF32 control."""

import math
import time
from unittest import mock

import pytest
import torch

from perfbench import harness, peaks, spec
from perfbench.reference.nnunet import conv_layers
from perfbench.trace import Trace

CELL = "nnunet.train.stream128"
CONFIG = spec.load_config("perfbench/configs/nnunet3d_fullres_128.json")
LAYERS = conv_layers(CONFIG, 128)
# (C_in, C_out, output edge, stride) of the 22 3^3 convs, written out
CONVS = [(1, 32, 128, 1), (32, 32, 128, 1), (32, 64, 64, 2), (64, 64, 64, 1), (64, 128, 32, 2),
         (128, 128, 32, 1), (128, 256, 16, 2), (256, 256, 16, 1), (256, 320, 8, 2),
         (320, 320, 8, 1), (320, 320, 4, 2), (320, 320, 4, 1), (640, 320, 8, 1),
         (320, 320, 8, 1), (512, 256, 16, 1), (256, 256, 16, 1), (256, 128, 32, 1),
         (128, 128, 32, 1), (128, 64, 64, 1), (64, 64, 64, 1), (64, 32, 128, 1), (32, 32, 128, 1)]
NAMES = ("mfu.nnunet", "roofline.conv_mc.nnunet", "roofline.conv_mc_dw.nnunet",
         "roofline.instance_norm.nnunet", "library_conv_ms.nnunet", "loss_ms.nnunet")
# device ms a step on record (``PERF.md`` §5: a traced run of the cell on an H100 at 700 W,
# each the reader's bound over its share)
K10_MS, DW_MS, NORM_MS = 41.65, 25.32, 27.50


def metric(name):
    return spec.load_metric(name)


def test_the_layers_by_hand():
    assert LAYERS == CONVS


def test_step_flops_by_hand():
    # batch 2: the stride-1 convs' forward 1770.07 GFLOP (442.5 GMAC a sample), the
    # strided 106.71, the transposed 31.62 (988,020,736 voxel-channel pairs x 8 taps x 2 x 2);
    # each taken three times, but the first conv's input gradient (7.25 GFLOP); the five
    # heads' forward (89,292,800 voxel-channels x 2 x 2) and the gradients of the four of
    # weight not 0 (89,128,960 x 2 x 2 each)
    convs = 3 * (1770066542592 + 106706239488) - 7247757312
    transposed = 3 * 31616663552
    heads = 89292800 * 4 + 2 * 89128960 * 4
    assert metric("mfu.nnunet").step_flops(CONFIG, 2) == convs + transposed + heads \
        == 5718990782464.0


def test_k10_work_by_hand():
    work = metric("roofline.conv_mc.nnunet").work(2, LAYERS)
    assert len(work) == 17 + 16  # every stride-1 conv's forward, all but the first's dx
    # 1->32 at 128^3: x (1 channel) and y (32) of 2 grids of 2,097,152 voxels, 864 weights
    assert work[0] == ((2 * 2097152 * 33 + 864) * 4, 2.0 * 27 * 2 * 2097152 * 32)
    assert work[1] == work[2] == ((2 * 2097152 * 64 + 27648) * 4, 231928233984.0)
    assert sum(f for _, f in work) == 3532885327872.0
    # bytes bound the 1->32 layer and the 320->320 layer at 4^3 (its 11 MB of weights)
    bound_by_bytes = [b / peaks.HBM_BYTES_PER_S > f / peaks.FLOPS["f32"] for b, f in work]
    assert [i for i, v in enumerate(bound_by_bytes) if v] == [0, 11, 12]
    total = sum(peaks.bound_s(b, f, "f32") for b, f in work)
    assert total * 1e3 == pytest.approx(7.29171, rel=1e-5)
    assert total / (K10_MS * 1e-3) * 100 == pytest.approx(17.51, abs=0.01)


def test_dw_work_by_hand():
    work = metric("roofline.conv_mc_dw.nnunet").work(2, LAYERS)
    assert len(work) == 17 and work[0] == ((2 * 2097152 * 33 + 864) * 4, 7247757312.0)
    assert sum(f for _, f in work) == 1770066542592.0  # the stride-1 forward's FLOPs
    total = sum(peaks.bound_s(b, f, "f32") for b, f in work)
    assert total * 1e3 == pytest.approx(3.72849, rel=1e-5)
    assert total / (DW_MS * 1e-3) * 100 == pytest.approx(14.73, abs=0.01)


def test_norm_work_by_hand():
    work = metric("roofline.instance_norm.nnunet").work(2, LAYERS)
    # 357,212,160 normalised elements a sample, 20 bytes each (8 forward, 12 backward)
    assert len(work) == 22 and sum(b for b, _ in work) == 20 * 2 * 357212160
    total = sum(peaks.bound_s(b, f, "f32") for b, f in work)
    assert total * 1e3 == pytest.approx(14288486400 / 3.35e12 * 1e3)
    assert total / (NORM_MS * 1e-3) * 100 == pytest.approx(15.51, abs=0.01)


@pytest.mark.parametrize("name, matched", [
    ("void cudnn::bn_fw_tr_1C11_kernel_NCHW<float, float, int, 512, true, 1, true>(cudnnTensor"
     "Struct, float const*)", True),
    ("void cudnn::bn_bw_1C11_singleread<float, 512, true, 1, 2, 0>(cudnn::bn_bw_1C11_args<float>)",
     True),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::(anonymous namespace)::leaky_"
     "relu_backward_kernel(at::TensorIteratorBase&, c10::Scalar const&)", True),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>, "
     "std::array<char*, 3ul> >(int)", False),
    ("void convolveNd_dgrad_float_engine<float, 3, 512, 6, 5, 3, 3, 3, false>(int)", False),
])
def test_norm_kernel_pattern(name, matched):
    assert bool(metric("roofline.instance_norm.nnunet").KERNELS.search(name)) is matched


def _event(cat, name, ts, dur, tid=1, corr=None):
    e = {"cat": cat, "name": name, "ts": ts, "dur": dur, "ph": "X", "pid": 1, "tid": tid,
         "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


class _Ctx:
    def __init__(self, trace, counters):
        self.trace, self.counters = trace, counters
        self.config, self.traffic = CONFIG, spec.load_traffic(CELL)


LAUNCHES = {"conv3d_mc": 33, "conv3d_mc_dw": 27, "conv3d_strided": 5,
            "conv_transpose3d_k2": 5, "instance_norm_lrelu": 22}


def _step_trace():
    """One step: a K10 launch, a strided conv's forward (the loop's thread) and
    backward (autograd's, tid 2), a head's product outside them, a norm kernel."""
    host = [_event("user_annotation", "snt/train/step", 0, 1000),
            _event("user_annotation", "snt/train/forward", 10, 300),
            _event("user_annotation", "snt/train/loss", 320, 50),
            _event("cpu_op", "_FusedConv3dMc", 20, 30),
            _event("cuda_runtime", "cudaLaunchKernel", 25, 2, corr=1),
            _event("cpu_op", "_StridedConv3d", 60, 30),
            _event("cuda_runtime", "cudaLaunchKernel", 70, 2, corr=2),
            _event("cpu_op", "aten::matmul", 100, 20),
            _event("cuda_runtime", "cudaLaunchKernel", 105, 2, corr=3),
            _event("cuda_runtime", "cudaLaunchKernel", 330, 2, corr=4),
            _event("cpu_op", "_StridedConv3dBackward", 500, 40, tid=2),
            _event("cuda_runtime", "cudaLaunchKernel", 510, 2, tid=2, corr=5),
            _event("cuda_runtime", "cudaLaunchKernel", 600, 2, tid=2, corr=6)]
    device = [_event("kernel", "void (anonymous namespace)::conv3d_mc_tc_kernel<Tile>(float)",
                     30, 100, tid=7, corr=1),
              _event("kernel", "sm80_xmma_fprop_implicit_gemm_f32f32", 140, 40, tid=7, corr=2),
              _event("kernel", "sm80_xmma_gemm_f32f32_f32f32", 190, 10, tid=7, corr=3),
              _event("kernel", "reduce_kernel", 340, 8, tid=7, corr=4),
              _event("kernel", "void convolveNd_dgrad_float_engine<float>(int)", 520, 60, tid=7,
                     corr=5),
              _event("kernel", "void cudnn::bn_bw_1C11_kernel_new<float>(float)", 610, 30,
                     tid=7, corr=6)]
    return Trace(host + device, 1000e-6)


def test_library_conv_rule_takes_the_wrappers_launches_only():
    ctx = _Ctx(_step_trace(), {"steps": 1, "launches": {"conv3d_strided": 1,
                                                        "conv_transpose3d_k2": 0}})
    # the strided forward's 40 us and its backward's 60 us; not K10's, the head's or the norm's
    assert metric("library_conv_ms.nnunet").read(ctx) == pytest.approx(0.1)
    # the forward ops must number the wrappers' calls
    ctx.counters["launches"]["conv_transpose3d_k2"] = 1
    assert metric("library_conv_ms.nnunet").read(ctx) is None


def test_loss_reads_its_span():
    ctx = _Ctx(_step_trace(), {"steps": 1, "launches": LAUNCHES})
    assert metric("loss_ms.nnunet").read(ctx) == pytest.approx(0.008)


@pytest.mark.parametrize("name", NAMES)
def test_nothing_is_read_without_the_networks_calls_or_span(name):
    # another cell's window: no launches counted by the route, no loss span (the parent)
    trace = _step_trace()
    trace.host = [e for e in trace.host if e["name"] != "snt/train/loss"]
    assert metric(name).read(_Ctx(trace, {"steps": 1})) is None


def test_mfu_of_the_recorded_window():
    # 8 traced steps in a window of 1.0687 s on an H100 (``PERF.md`` §5): 8.65% of 495 TFLOP/s
    ctx = _Ctx(_step_trace(), {"steps": 8, "launches": LAUNCHES})
    ctx.trace.window_s = 1.0687
    assert metric("mfu.nnunet").read(ctx) == pytest.approx(8.649, abs=1e-3)


SMALL = {"config": {"voxel_grid_size": [16, 16, 16], "features": [4, 8, 16], "strides": [1, 2, 2]},
         "traffic": {"crops": 16, "batch_size": 2, "loader_threads": 2, "trace_steps": 2,
                     "points": {"min": 2000, "max": 4096, "pad": 4096}}}
SEED = 2**31 + 12345


@pytest.fixture
def sorted_route():
    """The program's 128^3 route at the small grid: the divide recipe's ids and the
    sorted counts (below the sorted sizes the program bins by the multiply recipe)."""
    from scenenet_tpu_torch.ops import voxelize

    with mock.patch.object(voxelize, "_sorted_route", lambda n, grid: True):
        yield


@pytest.mark.parametrize("faults", [(), ("half_batch",), ("frozen_step",)])
def test_small_run_is_correct_and_every_fault_is_not(faults, sorted_route):
    result = harness.run(CELL, SEED, 0.3, False, time.perf_counter(), device="cpu",
                         faults=faults, overrides=SMALL)
    assert result["correct"] is (not faults), result["checks"]
    assert result["metrics"]["train_samples_per_s"]["value"] > 0
    assert math.isfinite(result["metrics"]["setup_s"]["value"])


def test_control_is_not_correct(sorted_route):
    cell = spec.Cell(CELL)
    for part, values in SMALL.items():
        getattr(cell, part).update(values)
    route = spec.load_route(cell.traffic["route"]).Route(cell, SEED, torch.device("cpu"))
    try:
        route.setup()
        route.release()
        assert all(c.ok for c in route.check())
        control = route.control()
    finally:
        route.close()
    assert not all(c.ok for c in control), [(c.name, c.value, c.limit) for c in control]
