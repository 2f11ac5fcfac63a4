"""Port parity: the multi-channel 3³ conv in torch vs the JAX package.

The CUDA kernel cannot run here; its plain version (``F.conv3d``, TF32
off) is held against the Pallas kernel in interpret mode, at that
kernel's own test shapes and tolerance (atol 2e-5, rtol 1e-5: f32 sums of
27·C_in products in another order), and the autograd Function's dx and dw
against ``jax.grad`` of XLA's conv. What surrounds the kernel in Python
(the weight layouts it is launched with, for the forward and for dx) is
checked by summing the kernel's products in numpy-like torch code.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F
from jax import lax

from scenenet_tpu.ops.pallas_conv_mc import conv3d_mc_same as pallas_conv3d_mc
from scenenet_tpu_torch.ops import cuda_conv_mc
from scenenet_tpu_torch.ops.cuda_conv_mc import (
    conv3d_mc_same, conv3d_mc_same_plain, conv3d_mc_weight_grad, fused_conv3d_mc,
)

TOL = dict(atol=2e-5, rtol=1e-5)  # tests/test_pallas_conv_mc.py's own


def _xla(x, w):
    return lax.conv_general_dilated(
        x, w, (1, 1, 1), "SAME", dimension_numbers=("NCDHW", "OIDHW", "NCDHW"),
        preferred_element_type=jnp.float32)


def _case(cin, cout, shape, b=2, seed=None):
    rng = np.random.default_rng(sum(shape) + cin if seed is None else seed)
    x = rng.random((b, cin, *shape)).astype(np.float32)
    w = (rng.standard_normal((cout, cin, 3, 3, 3)) * 0.1).astype(np.float32)
    return x, w


@pytest.mark.parametrize("cin,cout,shape", [
    (4, 8, (6, 6, 6)),        # tiny channels
    (32, 32, (12, 12, 12)),   # shallow UNet regime
    (160, 128, (8, 8, 8)),    # deep regime
    (16, 24, (5, 9, 7)),      # non-cubic + odd extents
])
def test_plain_matches_pallas_interpret(cin, cout, shape):
    x, w = _case(cin, cout, shape)
    want = pallas_conv3d_mc(jnp.asarray(x), jnp.asarray(w), interpret=True, n_tile=256)
    got = conv3d_mc_same(torch.from_numpy(x), torch.from_numpy(w))
    assert got.shape == (2, cout, *shape) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(_xla(jnp.asarray(x), jnp.asarray(w))),
                               **TOL)


def test_channels_last_matches_pallas_interpret():
    rng = np.random.default_rng(0)
    x = rng.random((2, 10, 10, 10, 24)).astype(np.float32)
    w = (rng.standard_normal((16, 24, 3, 3, 3)) * 0.1).astype(np.float32)
    want = pallas_conv3d_mc(jnp.asarray(x), jnp.asarray(w), interpret=True, n_tile=256,
                            channels_last=True)
    got = conv3d_mc_same(torch.from_numpy(x), torch.from_numpy(w), channels_last=True)
    assert got.shape == (2, 10, 10, 10, 16) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    first = conv3d_mc_same(torch.from_numpy(x).permute(0, 4, 1, 2, 3).contiguous(),
                           torch.from_numpy(w))
    np.testing.assert_allclose(got.permute(0, 4, 1, 2, 3).numpy(), first.numpy(), **TOL)


def test_plain_matches_pallas_streamed_variant():
    """A volume past the TPU kernel's resident budget (its streamed body,
    ``_mc_kernel``): one function here serves both sizes."""
    x, w = _case(4, 16, (32, 32, 32), b=1)
    flat_bytes = 4 * 34 * 34 * 40 * 128  # the padded rows at 128 lanes, at least
    out_bytes = 4 * 43 * 1024 * 16       # 43 tiles of 1024 rows cover 32·34·40
    assert flat_bytes + out_bytes > 24 * 1024 * 1024  # the resident variant's limit
    want = pallas_conv3d_mc(jnp.asarray(x), jnp.asarray(w), interpret=True)
    got = conv3d_mc_same(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("cin,cout,shape", [(1, 32, (8, 8, 8)), (16, 24, (5, 9, 7)),
                                            (64, 32, (6, 6, 6))])
def test_fused_grads_match_jax_grad_of_xla_conv(cin, cout, shape):
    """Value, dx and dw of Σ(conv·g): dx is the conv of g with the flipped,
    channel-swapped weights, dw the library's weight gradient. Bounds:
    2e-5 + 1e-5 relative on dx (27·C_out products), 1e-4 of the largest
    entry on dw (sums over every voxel of the batch)."""
    x, w = _case(cin, cout, shape)
    g = np.random.default_rng(1).standard_normal((2, cout, *shape)).astype(np.float32)
    want_x, want_w = jax.grad(lambda a, b: jnp.sum(_xla(a, b) * g), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    tx, tw = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    out = fused_conv3d_mc(tx, tw)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(_xla(jnp.asarray(x), jnp.asarray(w))), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_x), **TOL)
    want_w = np.asarray(want_w)
    assert np.abs(tw.grad.numpy() - want_w).max() <= 1e-4 * np.abs(want_w).max()
    np.testing.assert_array_equal(
        conv3d_mc_weight_grad(torch.from_numpy(x), torch.from_numpy(g)).numpy(),
        tw.grad.numpy())


def test_fused_skips_dx_when_x_needs_no_grad(monkeypatch):
    """The first conv of a model (x is data): backward makes dw only."""
    calls = []
    real = cuda_conv_mc.conv3d_mc_same
    monkeypatch.setattr(cuda_conv_mc, "conv3d_mc_same",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    x, w = _case(1, 4, (4, 4, 4))
    tw = torch.from_numpy(w).requires_grad_()
    fused_conv3d_mc(torch.from_numpy(x), tw).sum().backward()
    assert len(calls) == 1 and tw.grad is not None
    tx = torch.from_numpy(x).requires_grad_()
    fused_conv3d_mc(tx, tw).sum().backward()
    assert len(calls) == 3 and tx.grad is not None  # forward and dx


def _sum_like_the_kernel(x, wt):
    """What the kernel computes from its launch arguments: for every input
    channel and tap, the zero-padded x shifted by the tap times the
    (C_in, 27, C_out) weights' row."""
    b, cin, z, xx, yy = x.shape
    xp = F.pad(x, (1, 1, 1, 1, 1, 1))
    out = torch.zeros((b, wt.shape[2], z, xx, yy), dtype=torch.float64)
    for tap in range(27):
        dz, dx, dy = tap // 9, (tap // 3) % 3, tap % 3
        shifted = xp[:, :, dz:dz + z, dx:dx + xx, dy:dy + yy].double()
        out += torch.einsum("bczxy,co->bozxy", shifted, wt[:, tap].double())
    return out.float()


def test_launch_layouts_forward_and_dx():
    """``_transposed`` gives the kernel (C_in, 27, C_out) rows; for dx the
    weights go in flipped on the three spatial axes with the channel axes
    swapped. Summed as the kernel sums them, both reproduce autograd."""
    x, w = _case(5, 7, (4, 6, 5))
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    wt = cuda_conv_mc._transposed(tw)
    assert wt.shape == (5, 27, 7) and wt.is_contiguous()
    np.testing.assert_allclose(_sum_like_the_kernel(tx, wt).numpy(),
                               conv3d_mc_same_plain(tx, tw).numpy(), **TOL)
    g = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 7, 4, 6, 5))
                         .astype(np.float32))
    xa = tx.clone().requires_grad_()
    (F.conv3d(xa, tw, padding=1) * g).sum().backward()
    wt_dx = cuda_conv_mc._transposed(tw.flip((2, 3, 4)).transpose(0, 1))
    assert wt_dx.shape == (7, 27, 5)
    np.testing.assert_allclose(_sum_like_the_kernel(g, wt_dx).numpy(), xa.grad.numpy(), **TOL)


@pytest.mark.parametrize("bad,exc", [
    (lambda x, w: conv3d_mc_same(x, torch.zeros((8, 4, 3, 3, 5))), ValueError),
    (lambda x, w: conv3d_mc_same(x, torch.zeros((8, 4, 1, 1, 1))), ValueError),
    (lambda x, w: conv3d_mc_same(x, torch.zeros((8, 5, 3, 3, 3))), ValueError),
    (lambda x, w: conv3d_mc_same(x[0], w), ValueError),
    (lambda x, w: conv3d_mc_same(x, w, channels_last=True), ValueError),
    (lambda x, w: conv3d_mc_same(x.double(), w), TypeError),
    (lambda x, w: conv3d_mc_same(x, w.half()), TypeError),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad, exc):
    """Kernels other than 3×3×3 raise a ValueError, as the JAX function
    asserts; so do mismatched channels, ranks and types."""
    x, w = _case(4, 8, (6, 6, 6))
    with pytest.raises(exc):
        bad(torch.from_numpy(x), torch.from_numpy(w))


def test_launch_counter_counts_only_launches():
    """On the CPU the wrapper runs the plain version and counts nothing."""
    x, w = _case(4, 8, (6, 6, 6))
    before = cuda_conv_mc.MC_LAUNCHES.count
    conv3d_mc_same(torch.from_numpy(x), torch.from_numpy(w))
    fused_conv3d_mc(torch.from_numpy(x), torch.from_numpy(w).requires_grad_()).sum().backward()
    assert cuda_conv_mc.MC_LAUNCHES.count == before


# ---- the tensor-core route: its plan and its arithmetic, on the CPU -----------------

# UNet3D's 18 3×3×3 convs in forward order: (C_in, C_out, cubic extent at a 64³ grid)
UNET_CONVS = [(1, 32, 64), (32, 32, 64), (32, 64, 32), (64, 64, 32), (64, 128, 16),
              (128, 128, 16), (128, 256, 8), (256, 256, 8), (256, 256, 4), (256, 256, 4),
              (512, 256, 8), (256, 128, 8), (256, 128, 16), (128, 64, 16), (128, 64, 32),
              (64, 32, 32), (64, 32, 64), (32, 32, 64)]


def _fma_blocks(b, c_out, n):
    """Blocks of the FMA kernel at a cubic volume (its tiles: csrc/conv3d_mc.cu)."""
    co_t = 32 if c_out <= 32 else 64
    if c_out <= 32:
        tz, tx, ty = (8, 16, 4) if n <= 4 else (8, 8, 8) if n <= 8 else (4, 8, 16)
    else:
        tz, tx, ty = (8, 8, 4) if n <= 4 else (4, 8, 8) if n <= 8 else (4, 4, 16)
    return b * -(-n // tz) * -(-n // tx) * -(-n // ty) * -(-c_out // co_t)


@pytest.mark.parametrize("batch", [16, 1])
@pytest.mark.parametrize("layer", range(len(UNET_CONVS)))
def test_plan_fills_the_card_or_splits_to_its_cap(layer, batch):
    """Every UNet layer, at the train batch and at batch 1: two blocks an SM
    (264), or C_in split as far as it goes; never more splits than K steps;
    the same arguments give the same plan."""
    cin, cout, n = UNET_CONVS[layer]
    tile, k_splits = cuda_conv_mc.conv3d_mc_plan(batch, cin, cout, n, n, n)
    assert (tile, k_splits) == cuda_conv_mc.conv3d_mc_plan(batch, cin, cout, n, n, n)
    cap = cuda_conv_mc.conv3d_mc_split_cap(tile, cin)
    assert 1 <= k_splits <= cap <= max(1, -(-cin // cuda_conv_mc.K_STEP))
    if tile == cuda_conv_mc.FMA_TILE:
        assert cin <= cuda_conv_mc.FMA_MAX_C_IN and k_splits == 1
        blocks = _fma_blocks(batch, cout, n)
    else:
        blocks = cuda_conv_mc.conv3d_mc_blocks(tile, k_splits, batch, cout, n, n, n)
        (tb, tz, tx, ty), bn = cuda_conv_mc.TC_TILES[tile]
        assert bn == (32 if cout <= 32 else 64)
        if n == 4:  # no tile half outside the volume: the batch is folded in
            assert (tb, tz, tx, ty) == (4, 4, 4, 4)
        assert tz <= max(n, 4) and tx <= max(n, 8) and ty <= max(n, 8)
    assert blocks >= cuda_conv_mc.TARGET_BLOCKS or k_splits == cap


@pytest.mark.parametrize("args,want", [
    ((2, 16, 24, 5, 9, 7), (1, 2)),            # y ≤ 8, 32-channel tile; 2 chunks, both split
    ((16, 256, 128, 8, 8, 8), (2, 5)),         # 64 blocks → 5 splits of 32 chunks
    ((1, 256, 256, 4, 4, 4), (3, 32)),         # batch 1 at 4³: the cap
    ((2, 3, 3, 64, 64, 64), ("fma", 1)),       # the CNN baseline's layers
    ((2, 4, 8, 6, 6, 6), ("fma", 1)),
    ((2, 5, 8, 6, 6, 6), (1, 1)),              # one ragged chunk cannot be split
    ((3, 100, 64, 8, 8, 8), (2, 13)),          # C_in no multiple of 8: 13 chunks
])
def test_plan_at_the_shapes_it_separates(args, want):
    assert cuda_conv_mc.conv3d_mc_plan(*args) == want
    assert cuda_conv_mc.conv3d_mc_plan(*args, channels_last=True) == ("fma", 1)


def _tf32_round_numpy(v):
    """Round to 10 mantissa bits, ties away from zero, in float64."""
    v = np.asarray(v, np.float64)
    m, e = np.frexp(v)                      # v = m * 2^e, 0.5 <= |m| < 1
    scaled = m * 2048.0                     # 11 significant bits before the point
    r = np.sign(scaled) * np.floor(np.abs(scaled) + 0.5)
    return np.ldexp(r / 2048.0, e).astype(np.float32)


@pytest.mark.parametrize("seed,scale", [(0, 1.0), (1, 1e-3), (2, 300.0), (3, 1e-20)])
def test_weight_split_keeps_20_bits(seed, scale):
    """hi has its 13 low mantissa bits clear and is the nearest such value
    (ties away from zero, as cvt.rna.tf32.f32); lo is a bf16 value; hi + lo
    reproduces w to 2⁻²⁰ relative (w − hi is at most 2⁻¹¹ of w and bf16
    keeps it to 2⁻⁹: half of that again wherever w is not at the bottom of
    its binade)."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal(4096) * scale).astype(np.float32)
    w[:4] = [1.0, -1.0, 1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)]  # exact values and ties
    hi, lo = cuda_conv_mc.split_weights(torch.from_numpy(w))
    assert int((hi.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert int((lo.view(torch.int32) & 0xFFFF).abs().max()) == 0
    np.testing.assert_array_equal(hi.numpy(), _tf32_round_numpy(w))
    assert hi[2].item() == 1.0 + 2.0 ** -10 and hi[3].item() == -(1.0 + 2.0 ** -10)
    err = np.abs((hi.double() + lo.double()).numpy() - w.astype(np.float64))
    assert (err <= 2.0 ** -20 * np.abs(w)).all()
    assert (np.abs(w - hi.numpy()) <= 2.0 ** -11 * np.abs(w)).all()


@pytest.mark.parametrize("seed,scale", [(0, 1.0), (1, 1e-3), (2, 300.0)])
def test_input_split_keeps_19_bits(seed, scale):
    """The inputs' split is a mask: hi never past x in magnitude, lo of x's
    sign, a bf16 value; hi + lo reproduces x to 2⁻¹⁹ relative; {0, 1}
    occupancy is all in hi."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(4096) * scale).astype(np.float32)
    x[:3] = [1.0, 0.0, 1.0 + 2.0 ** -11]
    hi, lo = cuda_conv_mc.split_inputs(torch.from_numpy(x))
    assert int((hi.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert int((lo.view(torch.int32) & 0xFFFF).abs().max()) == 0
    assert (np.abs(hi.numpy()) <= np.abs(x)).all() and (lo.numpy() * x >= 0).all()
    assert hi[:3].tolist() == [1.0, 0.0, 1.0] and lo[:3].tolist() == [0.0, 0.0, 2.0 ** -11]
    err = np.abs((hi.double() + lo.double()).numpy() - x.astype(np.float64))
    assert (err <= 2.0 ** -19 * np.abs(x)).all()


@pytest.mark.parametrize("cin,cout,shape", [
    (4, 8, (6, 6, 6)), (32, 32, (12, 12, 12)), (160, 128, (8, 8, 8)), (16, 24, (5, 9, 7)),
])
def test_tensor_core_emulation_matches_pallas_interpret(cin, cout, shape):
    """The tensor-core kernel's arithmetic (operands split into a TF32 hi
    and a bf16 lo, three products, f32 sums) against the Pallas kernel in
    interpret mode, at that kernel's own tolerance."""
    x, w = _case(cin, cout, shape)
    want = pallas_conv3d_mc(jnp.asarray(x), jnp.asarray(w), interpret=True, n_tile=256)
    got = cuda_conv_mc.conv3d_mc_same_tc_plain(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    one = F.conv3d(cuda_conv_mc.tf32_round(torch.from_numpy(x)),
                   cuda_conv_mc.tf32_round(torch.from_numpy(w)), padding=1)
    # the check is live: TF32 alone is far outside that tolerance
    assert float((one - torch.from_numpy(np.asarray(want))).abs().max()) > 1e-4


@pytest.mark.parametrize("cin", [512, 256])
def test_tensor_core_emulation_holds_the_scaled_bound_at_many_channels(cin):
    """At 512 input channels (13824 products a sum) against the plain f32
    conv, on outputs of magnitude ~1: 2e-5·sqrt(C_in/160) + 1e-5 relative."""
    rng = np.random.default_rng(cin)
    x = torch.from_numpy(rng.random((2, cin, 4, 4, 4)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((32, cin, 3, 3, 3)) / np.sqrt(27 * cin))
                         .astype(np.float32))
    want = conv3d_mc_same_plain(x, w)
    got = cuda_conv_mc.conv3d_mc_same_tc_plain(x, w)
    assert 0.2 < float(want.abs().mean()) < 2.0
    torch.testing.assert_close(got, want, rtol=1e-5, atol=2e-5 * (cin / 160) ** 0.5)
    exact = F.conv3d(x.double(), w.double(), padding=1)
    assert float((got.double() - exact).abs().max()) <= 2 * float(
        (want.double() - exact).abs().max()) + 1e-6


# ---- K10's bf16 form: its plain version and its plan, on the CPU --------------------

def _bf16_case(cin, cout, shape, b=2, seed=0):
    x, w = _case(cin, cout, shape, b, seed)
    return (torch.from_numpy(x).to(torch.bfloat16),
            torch.from_numpy(w * np.float32(np.sqrt(0.01 * 27 * cin) ** -1)).to(torch.bfloat16))


@pytest.mark.parametrize("cin,cout,shape", [(4, 8, (6, 6, 6)), (32, 32, (12, 12, 12)),
                                            (160, 128, (8, 8, 8)), (1, 32, (9, 7, 5))])
def test_bf16_plain_matches_xla_bf16_conv(cin, cout, shape):
    """The bf16 form's plain version (the bf16 values widened, an f32 conv,
    rounded once) against XLA's bf16 conv, the conv of the JAX package's
    bf16 UNet: both sum exact products in f32 and round once, so they part
    only where the two f32 sums round to neighbouring bf16 values — at most
    a bf16 unit of the largest output, and at few places."""
    x, w = _bf16_case(cin, cout, shape)
    got = conv3d_mc_same(x, w)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, conv3d_mc_same_plain(x.float(), w.float()).to(torch.bfloat16))
    want = lax.conv_general_dilated(
        jnp.asarray(x.float().numpy(), jnp.bfloat16), jnp.asarray(w.float().numpy(), jnp.bfloat16),
        (1, 1, 1), "SAME", dimension_numbers=("NCDHW", "OIDHW", "NCDHW"))
    want = np.asarray(want.astype(jnp.float32))
    diff = np.abs(got.float().numpy() - want)
    assert diff.max() <= 2.0 ** -7 * np.abs(want).max() and (diff > 0).mean() <= 1e-2


def test_bf16_plan_takes_the_tensor_cores_at_every_layer():
    """The bf16 form takes the tensor cores at every layer past
    ``FMA_MAX_C_IN`` input channels, with the f32 plan's tiles and a K split
    over chunks of 16 channels; C_in ≤ 4 (the UNet's 1→32 layer) takes the
    FMA kernel's bf16 form, as the f32 plan does."""
    for b, cin, cout, n in ((16, 1, 32, 64), (2, 3, 3, 64), (2, 4, 8, 6)):
        assert cuda_conv_mc.conv3d_mc_plan(b, cin, cout, n, n, n, bf16=True) == ("fma", 1)
    for b, cin, cout, n in UNET_CONVS_AT:
        tile, k = cuda_conv_mc.conv3d_mc_plan(b, cin, cout, n, n, n, bf16=True)
        assert tile in cuda_conv_mc.TC_TILES and (cin > cuda_conv_mc.FMA_MAX_C_IN)
        assert tile == cuda_conv_mc.conv3d_mc_plan(b, cin, cout, n, n, n)[0]
        assert 1 <= k <= cuda_conv_mc.conv3d_mc_split_cap(tile, cin, bf16=True) \
            <= -(-cin // cuda_conv_mc.K_STEP_BF16)
    # 64 blocks unsplit: the f32 plan splits to 264 blocks and more, the bf16
    # one within 132
    assert cuda_conv_mc.conv3d_mc_plan(16, 256, 128, 8, 8, 8) == (2, 5)
    assert cuda_conv_mc.conv3d_mc_plan(16, 256, 128, 8, 8, 8, bf16=True) == (2, 2)
    # where the split reaches its cap, the f32 plan splits in chunks of 8
    # channels, the bf16 one in chunks of 16
    assert cuda_conv_mc.conv3d_mc_plan(1, 256, 256, 4, 4, 4, bf16=True) == (3, 16)
    assert cuda_conv_mc.conv3d_mc_plan(3, 100, 64, 8, 8, 8, bf16=True) == (2, 7)


UNET_CONVS_AT = [(b, c, o, n) for b in (16, 1) for c, o, n in
                 [(32, 32, 64), (32, 64, 32), (64, 64, 32), (64, 128, 16), (128, 128, 16),
                  (128, 256, 8), (256, 256, 8), (256, 256, 4), (512, 256, 8), (256, 128, 8),
                  (256, 128, 16), (128, 64, 16), (128, 64, 32), (64, 32, 32), (64, 32, 64)]]


@pytest.mark.parametrize("batch", [16, 1])
@pytest.mark.parametrize("layer", range(len(UNET_CONVS)))
def test_bf16_plan_splits_within_one_wave(layer, batch):
    """The bf16 plan at every UNet layer, forward and dx: the most K splits
    that keep the launch within one block an SM (132), up to the cap of its
    16-channel chunks, and none where the tiles alone fill that; the FMA
    kernel at C_in ≤ 4."""
    for cin, cout, n in (UNET_CONVS[layer], UNET_CONVS[layer][1::-1] + (UNET_CONVS[layer][2],)):
        tile, k_splits = cuda_conv_mc.conv3d_mc_plan(batch, cin, cout, n, n, n, bf16=True)
        cap = cuda_conv_mc.conv3d_mc_split_cap(tile, cin, bf16=True)
        assert 1 <= k_splits <= cap <= max(1, -(-cin // cuda_conv_mc.K_STEP_BF16))
        if cin <= cuda_conv_mc.FMA_MAX_C_IN:
            assert (tile, k_splits) == (cuda_conv_mc.FMA_TILE, 1)
            continue

        def blocks(k):
            return cuda_conv_mc.conv3d_mc_blocks(tile, k, batch, cout, n, n, n)

        assert k_splits == 1 or blocks(k_splits) <= cuda_conv_mc.BF16_TARGET_BLOCKS
        assert k_splits == cap or blocks(k_splits + 1) > cuda_conv_mc.BF16_TARGET_BLOCKS


@pytest.mark.parametrize("args,want", [
    ((2, 16, 24, 5, 9, 7), (1, 1)),            # one chunk of 16: nothing to split
    ((16, 256, 128, 8, 8, 8), (2, 2)),         # 64 blocks → 2 splits: 128 blocks
    ((1, 256, 256, 4, 4, 4), (3, 16)),         # batch 1 at 4³: the cap, 16 chunks
    ((3, 100, 64, 8, 8, 8), (2, 7)),           # C_in no multiple of 16: 7 chunks
    ((2, 24, 64, 8, 8, 8), (2, 2)),            # 24 channels: a chunk of 16 and one of 8
    ((2, 4, 8, 6, 6, 6), ("fma", 1)),          # the FMA kernel's bf16 form
])
def test_bf16_plan_at_the_shapes_it_separates(args, want):
    assert cuda_conv_mc.conv3d_mc_plan(*args, bf16=True) == want


def _b_fragment_numpy(w16, bn, cot, c, tap, n8):
    """The m16n8k16 B fragment of n8 tile ``n8`` of output-channel tile
    ``cot``, input-channel chunk ``c`` and tap ``tap``, as the PTX ISA lays
    it out (.bf16, col-major B, 16 × 8): lane g·4 + t holds in b0 the
    elements (k = 2t, n = g) in its low half and (2t + 1, g) in its high
    half, in b1 the same of k = 2t + 8, 2t + 9. w16: the weights' raw bits
    (C_out, C_in, 27) as uint16, zero past C_out and C_in."""
    c_out, c_in = w16.shape[:2]
    out = np.zeros((32, 2), np.uint32)
    for lane in range(32):
        g, t = divmod(lane, 4)
        co = cot * bn + 8 * n8 + g
        for reg in range(2):
            for half in range(2):
                ci = 16 * c + 2 * t + 8 * reg + half
                v = int(w16[co, ci, tap]) if co < c_out and ci < c_in else 0
                out[lane, reg] |= np.uint32(v << (16 * half))
    return out


@pytest.mark.parametrize("cout,cin,bn,strided", [(40, 24, 32, False), (64, 100, 64, False),
                                                 (8, 5, 32, True), (70, 33, 64, True)])
def test_bf16_fragments_follow_the_mma_layout(cout, cin, bn, strided):
    """``pack_bf16_fragments`` (the order the bf16 form's packing kernel
    writes, two n8 tiles a 16-byte word) against the B fragment re-derived
    from the PTX layout, at every entry: ragged C_in and C_out, both channel
    widths, and the flipped, transposed weights of the input gradient."""
    rng = np.random.default_rng(cout + cin)
    w = torch.from_numpy(rng.standard_normal((cin, cout, 3, 3, 3) if strided
                                             else (cout, cin, 3, 3, 3)).astype(np.float32))
    w = w.to(torch.bfloat16)
    if strided:
        w = w.flip((2, 3, 4)).transpose(0, 1)
        assert not w.is_contiguous()
    w16 = w.contiguous().view(torch.int16).numpy().view(np.uint16).reshape(cout, cin, 27)
    frags = cuda_conv_mc.pack_bf16_fragments(w, bn).numpy().view(np.uint32)
    co_t, nc = -(-cout // bn), -(-cin // 16)
    assert frags.shape == (co_t, nc, 27, bn // 16, 32, 4)
    for cot in range(co_t):
        for c in range(nc):
            for tap in range(27):
                for jj in range(bn // 16):
                    for h in range(2):
                        want = _b_fragment_numpy(w16, bn, cot, c, tap, 2 * jj + h)
                        np.testing.assert_array_equal(
                            frags[cot, c, tap, jj, :, 2 * h:2 * h + 2], want)


def test_bf16_fused_grads_are_the_plain_versions():
    """On the CPU the bf16 autograd Function runs the plain versions: dx as
    autograd through the widened conv gives it, dw the widened library call
    rounded once; the launch counters stay put."""
    x, w = _bf16_case(16, 8, (6, 5, 4))
    g = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 8, 6, 5, 4))
                         .astype(np.float32)).to(torch.bfloat16)
    before = (cuda_conv_mc.MC_LAUNCHES.count, cuda_conv_mc.MC_BF16_LAUNCHES.count)
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    fused_conv3d_mc(xa, wa).backward(g)
    assert (cuda_conv_mc.MC_LAUNCHES.count, cuda_conv_mc.MC_BF16_LAUNCHES.count) == before
    want_dx = conv3d_mc_same_plain(g, w.flip((2, 3, 4)).transpose(0, 1))
    assert xa.grad.dtype == wa.grad.dtype == torch.bfloat16
    assert torch.equal(xa.grad, want_dx)
    assert torch.equal(wa.grad, cuda_conv_mc.conv3d_mc_weight_grad_plain(x, g))
    want_dw = torch.nn.grad.conv3d_weight(x.float(), w.shape, g.float(), padding=1)
    torch.testing.assert_close(wa.grad.float(), want_dw, rtol=2.0 ** -8, atol=1e-5)


def test_bf16_wrapper_refusals():
    x, w = _bf16_case(8, 8, (4, 4, 4))
    with pytest.raises(TypeError, match="both"):
        conv3d_mc_same(x, w.float())
    with pytest.raises(ValueError, match="channels first"):
        conv3d_mc_same(x.permute(0, 2, 3, 4, 1).contiguous(), w, channels_last=True)


# ---- K10's weight gradient: the kernel's arithmetic and its plan, on the CPU --------

def _dw_case(b, cin, cout, shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.random((b, cin, *shape)).astype(np.float32),
            rng.standard_normal((b, cout, *shape)).astype(np.float32))


def _dw_err(got, want):
    return float(np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max())


# B = 1 and 3, a 12x10x14 volume, C no multiple of 8, C_in = 1
DW_RAGGED = [(1, 16, 24, (5, 9, 7)), (3, 1, 32, (12, 10, 14)), (1, 40, 30, (6, 10, 7)),
             (3, 100, 70, (12, 10, 14)), (3, 13, 9, (12, 10, 14)), (1, 1, 1, (1, 1, 1))]


@pytest.mark.parametrize("b,cin,cout,shape", [
    *((2, c, o, (n // 16 + 2,) * 3) for c, o, n in UNET_CONVS), *DW_RAGGED])
def test_weight_grad_tc_plain_matches_library_and_xla(b, cin, cout, shape):
    """The dw kernel's arithmetic (both operands split into a TF32 hi and a
    bf16 lo, three products, f32 sums) at the UNet's 18 layers on small
    extents and at ragged shapes: within 1e-4 of max|dw| of the f32 library
    call and of ``jax.grad`` of XLA's conv, the JAX package's weight
    gradient. TF32 alone is not (the check is live)."""
    x, g = _dw_case(b, cin, cout, shape, b + cin + cout)
    tx, tg = torch.from_numpy(x), torch.from_numpy(g)
    got = cuda_conv_mc.conv3d_mc_weight_grad_tc_plain(tx, tg)
    assert got.shape == (cout, cin, 3, 3, 3) and got.dtype == torch.float32
    library = torch.nn.grad.conv3d_weight(tx, (cout, cin, 3, 3, 3), tg, padding=1)
    w = jnp.zeros((cout, cin, 3, 3, 3), jnp.float32)
    xla = jax.grad(lambda w: jnp.sum(_xla(jnp.asarray(x), w) * g))(w)
    exact = torch.nn.grad.conv3d_weight(tx.double(), (cout, cin, 3, 3, 3), tg.double(),
                                        padding=1).numpy()
    for want in (library.numpy(), np.asarray(xla), exact):
        assert _dw_err(got.numpy(), want) <= 1e-4
    tf32 = cuda_conv_mc.conv3d_mc_weight_grad_plain(cuda_conv_mc.tf32_round(tx),
                                                    cuda_conv_mc.tf32_round(tg))
    if b * np.prod(shape) >= 64:  # enough products a sum for TF32's rounding to show
        assert _dw_err(tf32.numpy(), exact) > 1e-4


def _dw_coverage(tile, splits, b, z, x, y):
    """How often the kernel's walk visits each voxel of the batch under a
    plan: split k takes stages [k·n // splits, (k + 1)·n // splits), stage s
    is the tile (sample, z, x, y) with y fastest; every split takes a stage
    at least."""
    tb, tz, tx, ty = cuda_conv_mc.DW_TILES[tile][0]
    n = cuda_conv_mc.conv3d_mc_dw_stages(tile, b, z, x, y)
    bounds = [k * n // splits for k in range(splits + 1)]
    assert all(lo < hi for lo, hi in zip(bounds, bounds[1:])) and bounds[-1] == n
    ny, nx, nz = -(-y // ty), -(-x // tx), -(-z // tz)
    seen = np.zeros((-(-b // tb) * tb, nz * tz, nx * tx, ny * ty), np.int32)
    for lo, hi in zip(bounds, bounds[1:]):
        for s in range(lo, hi):
            y0, x0 = s % ny * ty, s // ny % nx * tx
            z0, b0 = s // (ny * nx) % nz * tz, s // (ny * nx * nz) * tb
            seen[b0:b0 + tb, z0:z0 + tz, x0:x0 + tx, y0:y0 + ty] += 1
    assert (seen == 1).all()  # the padding past the volume too: no tile twice
    return seen[:b, :z, :x, :y]


def _check_dw_plan(b, cin, cout, z, x, y):
    tile, splits = cuda_conv_mc.conv3d_mc_dw_plan(b, cin, cout, z, x, y)
    assert (tile, splits) == cuda_conv_mc.conv3d_mc_dw_plan(b, cin, cout, z, x, y)
    assert tile in cuda_conv_mc.DW_TILES  # every f32 shape takes the kernel
    stages = cuda_conv_mc.conv3d_mc_dw_stages(tile, b, z, x, y)
    assert 1 <= splits <= stages
    blocks = cuda_conv_mc.conv3d_mc_dw_blocks(tile, splits, cin, cout)
    # one wave of one block an SM, or as many channel tiles as there are
    assert blocks <= cuda_conv_mc.DW_TARGET_BLOCKS or splits == 1
    if splits < stages:  # a further split would pass the wave
        assert cuda_conv_mc.conv3d_mc_dw_blocks(tile, splits + 1, cin, cout) > \
            cuda_conv_mc.DW_TARGET_BLOCKS
    assert _dw_coverage(tile, splits, b, z, x, y).sum() == b * z * x * y
    return tile, splits


@pytest.mark.parametrize("batch", [16, 1])
@pytest.mark.parametrize("layer", range(len(UNET_CONVS)))
def test_dw_plan_covers_the_voxels_once_at_the_unet_layers(layer, batch):
    """At each UNet layer: the 4x4x16 tile at 16³ and past, 4x8x8 at 8³,
    two samples of 4³ at 4³, 8 input channels a block at the 1->32 layer
    and 16 elsewhere; one wave of 132 blocks where the channel tiles leave
    room for a K split; every voxel in exactly one stage of one split."""
    cin, cout, n = UNET_CONVS[layer]
    tile, splits = _check_dw_plan(batch, cin, cout, n, n, n)
    voxels, ci_block = cuda_conv_mc.DW_TILES[tile]
    assert voxels == {64: (1, 4, 4, 16), 32: (1, 4, 4, 16), 16: (1, 4, 4, 16),
                      8: (1, 4, 8, 8), 4: (2, 4, 4, 4)}[n]
    assert ci_block == (8 if cin == 1 else 16)
    channel_blocks = -(-cout // cuda_conv_mc.DW_CO) * -(-cin // ci_block)
    if batch == 16:
        assert splits == max(1, cuda_conv_mc.DW_TARGET_BLOCKS // channel_blocks)


@pytest.mark.parametrize("args,want", [
    ((16, 1, 32, 64, 64, 64), (3, 132)),    # 1->32: 8 input channels, split 132 ways
    ((16, 32, 32, 64, 64, 64), (0, 66)),
    ((16, 512, 256, 8, 8, 8), (1, 1)),      # 256 channel tile pairs: no split
    ((16, 256, 256, 4, 4, 4), (2, 1)),
    ((1, 256, 256, 4, 4, 4), (2, 1)),       # one stage: nothing to split
    ((2, 3, 3, 17, 5, 3), (4, 10)),         # the split stops at the stages
    ((3, 100, 70, 12, 10, 14), (0, 6)),
    ((2, 8, 16, 4, 4, 4), (5, 1)),          # 8 channels, the four-sample tile
    ((2, 9, 16, 4, 4, 4), (2, 1)),          # 9: 16 a block
])
def test_dw_plan_at_the_shapes_it_separates(args, want):
    assert cuda_conv_mc.conv3d_mc_dw_plan(*args) == want


# the shapes of channel tensor parallelism (parallel/gspmd.py), as tests/test_torch_cuda.py
# lists them: a rank's conv at C_out/m ("fwd") and the dx of a column-parallel conv ("dx")
TP_SHARD_SHAPES = [("fwd", 1, 16, 16), ("fwd", 32, 16, 16), ("fwd", 32, 8, 16),
                   ("fwd", 64, 16, 8), ("fwd", 256, 128, 4), ("dx", 16, 32, 16),
                   ("dx", 8, 32, 16), ("dx", 4, 32, 16), ("dx", 128, 256, 4)]


@pytest.mark.parametrize("what,cin,cout,n", TP_SHARD_SHAPES)
def test_dw_plan_at_channel_parallel_shapes(what, cin, cout, n):
    _check_dw_plan(2, cin, cout, n, n, n)


def test_dw_plan_over_drawn_shapes():
    from hypothesis import given, settings
    from hypothesis import strategies as st

    extent = st.integers(1, 40)

    @settings(max_examples=60, deadline=None, derandomize=True)
    @given(b=st.integers(1, 5), cin=st.integers(1, 600), cout=st.integers(1, 300),
           shape=st.tuples(extent, extent, extent))
    def run(b, cin, cout, shape):
        _check_dw_plan(b, cin, cout, *shape)

    run()


def test_weight_grad_on_the_cpu_is_the_library_call_and_counts_nothing():
    """A CPU tensor takes the plain version (the f32 library call); no
    launch counter moves; mismatched shapes and dtypes raise."""
    x, g = (torch.from_numpy(a) for a in _dw_case(2, 5, 7, (4, 6, 5), 3))
    before = cuda_conv_mc.MC_DW_LAUNCHES.count
    got = conv3d_mc_weight_grad(x, g)
    assert cuda_conv_mc.MC_DW_LAUNCHES.count == before
    assert torch.equal(got, torch.nn.grad.conv3d_weight(x, (7, 5, 3, 3, 3), g, padding=1))
    with pytest.raises(ValueError, match="one batch"):
        conv3d_mc_weight_grad(x, g[:1])
    with pytest.raises(ValueError, match="one batch"):
        conv3d_mc_weight_grad(x[0], g[0])
    with pytest.raises(TypeError, match="both"):
        conv3d_mc_weight_grad(x, g.double())
