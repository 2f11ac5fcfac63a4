"""The work that ``roofline.conv_mc_dw.train`` counts (K10's weight
gradient), against values worked by hand; its share at or under 100% for
the kernel time on record (``PERF.md`` §6); its kernel pattern against the
names of K10's kernels and of the dw's."""

import pytest

from perfbench import peaks, spec
from perfbench.reference.unet import conv_layers

UNET = spec.load_config("perfbench/configs/unet3d_ladder.json")
# the UNet's 3^3 convs as (C_in, C_out, edge), written out
UNET_CONVS = [(1, 32, 64), (32, 32, 64), (32, 64, 32), (64, 64, 32), (64, 128, 16),
              (128, 128, 16), (128, 256, 8), (256, 256, 8), (256, 256, 4), (256, 256, 4),
              (512, 256, 8), (256, 128, 8), (256, 128, 16), (128, 64, 16), (128, 64, 32),
              (64, 32, 32), (64, 32, 64), (32, 32, 64)]
METRIC = spec.load_metric("roofline.conv_mc_dw.train")


def test_dw_work_by_hand():
    layers = conv_layers(UNET, 64)
    assert layers == UNET_CONVS
    work = METRIC.work(16, layers)
    assert len(work) == 18  # every conv's weights train, the first's too
    # 1->32 at 64^3: x (1 channel) and g (32) of 16 grids of 262144 voxels read, 864
    # weights written; 7.25 GFLOP
    assert work[0] == (553651584, 7247757312.0)
    # 32->32 at 64^3: 64 channels of 16 grids, 27648 weights; 231.9 GFLOP
    assert work[1] == ((16 * 262144 * 64 + 27648) * 4, 231928233984.0)
    assert sum(f for _, f in work) == 1753957269504.0  # 3.54 ms at 495 TFLOP/s
    # bound by bytes only at the first layer: 0.1653 ms at 3.35 TB/s (0.0146 ms of FLOPs)
    assert peaks.bound_s(*work[0], "f32") * 1e3 == pytest.approx(0.165269, rel=1e-4)
    bytes_bound = [b / peaks.HBM_BYTES_PER_S > f / peaks.FLOPS["f32"] for b, f in work]
    assert bytes_bound == [True] + [False] * 17
    # the other 17 layers' 1746.7 GFLOP at 495 TFLOP/s (3.5287 ms) and the first's bytes
    total = sum(peaks.bound_s(b, f, "f32") for b, f in work)
    assert total * 1e3 == pytest.approx(3.52870 + 0.16527, rel=1e-4)


def test_recorded_dw_time_stays_under_its_roofline():
    # the 18 convs' dw in a CUDA graph, the fastest on record (PERF.md §6, row 10d):
    # 25.1525 ms, 14.7% of the bound at TF32's rate alone
    bound = sum(peaks.bound_s(b, f, "f32") for b, f in METRIC.work(16, UNET_CONVS))
    assert bound / 25.1525e-3 * 100 == pytest.approx(14.69, abs=0.01)


@pytest.mark.parametrize("name,matched", [
    ("void (anonymous namespace)::conv3d_mc_dw_kernel<(anonymous namespace)::DwTile<1, 4, 4, "
     "16> >(float const*, float const*, float*, int, int, int, int, int, int, int, int, int, "
     "int, int, int, int, int)", True),
    ("(anonymous namespace)::conv3d_mc_dw_reduce_kernel(float const*, float*, long long, int)",
     True),
    ("void (anonymous namespace)::conv3d_mc_tc_kernel<(anonymous namespace)::Tile<1, 4, 8, 16, "
     "32> >(float const*, float4 const*, float*, int, int, int, int, int, int, int, int, int, "
     "int, int, int)", False),
    ("void (anonymous namespace)::conv3d_mc_reduce_kernel<float>(float const*, float*, long "
     "long, int)", False),
    ("(anonymous namespace)::conv3d_mc_split_kernel(float const*, float4*, int, int, long long, "
     "long long, long long, long long, long long, int, int, long long)", False),
    ("void (anonymous namespace)::conv3d_mc_kernel<32, 4, 8, 16, 19, 190, float>(float const*, "
     "float const*, float*, int, int, int, int, int, int, long long, long long, long long, long "
     "long, long long, long long, int, int, int, int, int)", False),
    ("void at::native::(anonymous namespace)::vol2col_kernel<float>(long, float const*, int, "
     "int, int, int, int, int, int, int, int, int, int, int, int, int, int, int, int, int, "
     "float*)", False),
])
def test_dw_pattern_matches_the_dw_kernels_alone(name, matched):
    """The dw's pattern finds its two kernels and no kernel of K10's forward
    and dx; ``roofline.conv_mc.train``'s pattern finds neither dw kernel."""
    assert bool(METRIC.KERNELS.search(name)) == matched
    if matched:
        assert not spec.load_metric("roofline.conv_mc.train").KERNELS.search(name)


class _Trace:
    def __init__(self, seconds):
        self.seconds, self.window_s = seconds, 1.0

    def kernel_seconds(self, pattern):
        return self.seconds


class _Ctx:
    def __init__(self, trace, counters):
        c = spec.Cell("unet3d.train.stream64")
        self.config, self.traffic, self.trace, self.counters = c.config, c.traffic, trace, counters


def test_dw_kernels_at_their_bound_read_100_and_silence_reads_nothing():
    ctx = _Ctx(_Trace(1.0), {"steps": 10})
    at_one = METRIC.read(ctx)
    ctx.trace = _Trace(at_one / 100 * 1.0)  # the kernels take exactly the bound
    assert METRIC.read(ctx) == pytest.approx(100.0)
    ctx.trace = _Trace(0.0)
    assert METRIC.read(ctx) is None  # the parent's library dw: no number, never 0
    ctx = _Ctx(_Trace(1.0), {})
    assert METRIC.read(ctx) is None
