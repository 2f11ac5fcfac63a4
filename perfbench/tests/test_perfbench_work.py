"""The operations and bytes the roofline and MFU readers count, against
values worked by hand, and every share at or under 100% for the kernel
times on record (``PERF.md`` §6's table)."""


import pytest

from perfbench import peaks, spec
from perfbench.reference.unet import conv_layers

SCENENET = spec.load_config("perfbench/configs/scenenet_v2_955.json")
UNET = spec.load_config("perfbench/configs/unet3d_ladder.json")
# the UNet's 3^3 convs as (C_in, C_out, edge), written out as chip_smoke.py lists them
UNET_CONVS = [(1, 32, 64), (32, 32, 64), (32, 64, 32), (64, 64, 32), (64, 128, 16),
              (128, 128, 16), (128, 256, 8), (256, 256, 8), (256, 256, 4), (256, 256, 4),
              (512, 256, 8), (256, 128, 8), (256, 128, 16), (128, 64, 16), (128, 64, 32),
              (64, 32, 32), (64, 32, 64), (32, 32, 64)]


def test_k1_work_by_hand():
    # B=64 tiles of 131072 points: points 12 B and mask 1 B a point, a 64^3 f32 grid out
    b, f = spec.load_metric("roofline.cuda_hist.infer").work(64, 131072, 64 ** 3)
    assert (b, f) == (64 * 131072 * 13 + 64 * 262144 * 4, 0.0) == (176160768, 0.0)
    assert peaks.bound_s(b, f, "f32") * 1e3 == pytest.approx(0.052585, rel=1e-4)


def test_k2_k4_work_by_hand():
    fwd, dk = spec.load_metric("roofline.cuda_conv.train").work(16, 64 ** 3, 225)
    assert fwd == dk == (33555332, 1887436800.0)  # x and out of 16 64^3 f32 grids + 225 taps
    # bytes bound both: 33.6 MB at 3.35 TB/s = 0.0100 ms; 1.89 GFLOP at 495 T = 0.0038 ms
    bound = sum(peaks.bound_s(b, f, "f32") for b, f in (fwd, dk))
    assert bound * 1e3 == pytest.approx(0.020033, rel=1e-4)


def test_k5_work_by_hand():
    b, f = spec.load_metric("roofline.cuda_conv.infer").work(64, 64 ** 3, 225)
    assert (b, f) == (134218628, 7549747200.0)
    assert peaks.bound_s(b, f, "f32") * 1e3 == pytest.approx(0.040065, rel=1e-4)


def test_k10_work_by_hand():
    layers = conv_layers(UNET, 64)
    assert layers == UNET_CONVS
    work = spec.load_metric("roofline.conv_mc.train").work(16, layers)
    assert len(work) == 35  # 18 forward, 17 input gradients (none for the data)
    assert work[0] == ((16 * 262144 * 33 + 27 * 32) * 4, 2.0 * 27 * 16 * 262144 * 32)
    forward = sum(2.0 * 27 * 16 * e ** 3 * ci * co for ci, co, e in UNET_CONVS)
    assert sum(f for _, f in work) == forward * 2 - work[0][1]
    assert forward == 1753957269504.0  # 1.75 TFLOP: 3.54 ms at 495 TFLOP/s


def test_step_flops_by_hand():
    step = spec.load_metric("mfu.train").step_flops
    assert step(SCENENET, 16) == 2 * 2.0 * 225 * 16 * 262144 == 3774873600.0
    forward = sum(2.0 * 27 * 16 * e ** 3 * ci * co for ci, co, e in UNET_CONVS)
    head = 2.0 * 16 * 262144 * 32
    assert step(UNET, 16) == pytest.approx(3 * forward - 2.0 * 27 * 16 * 262144 * 32 + 3 * head)


# (metric, its work, the kernel's time in ms from PERF.md's table: the fastest on record)
RECORDED = [
    ("roofline.cuda_hist.infer", lambda m: [m.work(64, 131072, 64 ** 3)], 0.1429),
    ("roofline.cuda_conv.infer", lambda m: [m.work(64, 64 ** 3, 225)], 0.1367),
    ("roofline.cuda_conv.train", lambda m: m.work(16, 64 ** 3, 225), 0.0323 + 0.0719),
    ("roofline.conv_mc.train", lambda m: m.work(16, UNET_CONVS), 20.3130 + 7.5173),
]


@pytest.mark.parametrize("name,work,ms", RECORDED, ids=[r[0] for r in RECORDED])
def test_recorded_kernel_times_stay_under_their_roofline(name, work, ms):
    bound = sum(peaks.bound_s(b, f, "f32") for b, f in work(spec.load_metric(name)))
    share = bound / (ms * 1e-3) * 100
    assert 0 < share <= 100


def test_mfu_of_recorded_steps_under_100():
    step = spec.load_metric("mfu.train").step_flops
    # the fastest steps on record: SceneNet 2.0 ms (grid cache), UNet 193 ms
    for cfg, ms in ((SCENENET, 2.0), (UNET, 193.0)):
        assert 0 < step(cfg, 16) / (ms * 1e-3) / peaks.FLOPS["f32"] * 100 <= 100


class _Trace:
    def __init__(self, seconds):
        self.seconds, self.window_s = seconds, 1.0

    def kernel_seconds(self, pattern):
        return self.seconds


class _Ctx:
    def __init__(self, cell, trace, counters):
        c = spec.Cell(cell)
        self.config, self.traffic, self.trace, self.counters = c.config, c.traffic, trace, counters


@pytest.mark.parametrize("name,cell,key", [
    ("roofline.cuda_hist.infer", "scenenet.infer.b64", "dispatches"),
    ("roofline.cuda_conv.infer", "scenenet.infer.b64", "dispatches"),
    ("roofline.cuda_conv.train", "scenenet.train.grid64", "steps"),
    ("roofline.conv_mc.train", "unet3d.train.stream64", "steps")])
def test_a_kernel_at_its_bound_reads_100_and_silence_reads_nothing(name, cell, key):
    m = spec.load_metric(name)
    ctx = _Ctx(cell, _Trace(1.0), {key: 10})
    at_one = m.read(ctx)
    ctx.trace = _Trace(at_one / 100 * 1.0)  # the kernels take exactly the bound
    assert m.read(ctx) == pytest.approx(100.0)
    ctx.trace = _Trace(0.0)
    assert m.read(ctx) is None  # no kernel of its layer ran: no number, never 0
