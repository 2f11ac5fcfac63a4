"""Port parity: the stencil conv (f32 and tensor-core forms), its kernel
gradient and their autograd compositions vs the TPU kernels.

On a CPU tensor each wrapper runs its plain version; it must agree with
the Pallas kernel in interpret mode. Both are f32 sums of the same
products in different orders: atol 1e-5 on conv outputs, and the JAX
package's own bounds (rtol 1e-4, atol 1e-3) on kernel gradients, which sum
~10⁴ products of magnitude ~1 per tap. The tensor-core form multiplies
the same bf16 values as the banded-y TPU kernel (every product exact in
f32) and sums them in f32 in another order: 1e-5 on probabilities,
1e-5·max|ref| on raw conv values.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from scenenet_tpu.ops.conv3d import conv3d_same as jax_conv3d_same
from scenenet_tpu.ops.pallas_conv import banded_y_weights
from scenenet_tpu.ops.pallas_conv import fused_geneo_conv as jax_fused
from scenenet_tpu.ops.pallas_conv import geneo_stencil_conv_mxu as pallas_mxu
from scenenet_tpu.ops.pallas_conv import geneo_stencil_conv as pallas_stencil
from scenenet_tpu.ops.pallas_conv import stencil_dk as pallas_dk
from scenenet_tpu_torch.ops import cuda_conv
from scenenet_tpu_torch.ops.conv3d import conv3d_same, same_pads
from scenenet_tpu_torch.ops.cuda_conv import (
    fused_geneo_conv, fused_geneo_conv_mxu, geneo_stencil_conv, geneo_stencil_conv_mxu,
    split_kernel_bf16, stencil_dk,
)

ATOL = 1e-5


def _inputs(seed, ks, shape=(2, 16, 16, 16)):
    rng = np.random.default_rng(seed)
    x = (rng.random(shape) > 0.7).astype(np.float32)[:, None]  # {0,1} occupancy
    k = rng.normal(0, 0.3, ks).astype(np.float32)
    return x, k


@pytest.mark.parametrize("activation", [True, False])
@pytest.mark.parametrize("ks", [(9, 5, 5), (9, 6, 6), (3, 3, 3)])
def test_plain_matches_pallas_stencil(ks, activation):
    x, k = _inputs(sum(ks), ks)
    want = np.asarray(pallas_stencil(jnp.asarray(x), jnp.asarray(k),
                                     activation=activation, interpret=True))
    got = geneo_stencil_conv(torch.from_numpy(x), torch.from_numpy(k),
                             activation=activation).numpy()
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("shape,ks,route", [
    ((2, 16, 32, 64), (9, 5, 5), "fast"),      # two tiles of 8×16×32 along z, x and y
    ((3, 13, 18, 40), (9, 5, 5), "fast"),      # ragged tiles; Y a multiple of 4
    ((2, 9, 17, 35), (9, 5, 5), "fast"),       # Y no multiple of 4: the 4-byte staging
    ((2, 16, 32, 32), (9, 6, 6), "generic"),   # an even kernel: the generic kernel only
    ((2, 16, 32, 32), (5, 5, 9), "generic"),
])
def test_plain_matches_pallas_at_the_shapes_the_dispatch_separates(shape, ks, route):
    """The f32 stencil has two kernels on the card; ``stencil_route`` picks
    one from the kernel size alone. On both sides of the rule, and at the
    volume shapes the unrolled kernel treats differently, the plain
    version equals the Pallas kernel (interpret mode) within 1e-5."""
    assert cuda_conv.stencil_route(ks) == route
    x, k = _inputs(sum(ks) + sum(shape), ks, shape)
    want = np.asarray(pallas_stencil(jnp.asarray(x), jnp.asarray(k), interpret=True))
    got = geneo_stencil_conv(torch.from_numpy(x), torch.from_numpy(k)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("ks,route", [
    ((9, 5, 5), "fast"), (torch.Size((9, 5, 5)), "fast"), ([9, 5, 5], "fast"),
    ((9, 6, 6), "generic"), ((5, 5, 9), "generic"), ((5, 9, 5), "generic"),
    ((3, 3, 3), "generic"), ((9, 9, 9), "generic"), ((4, 7, 2), "generic"),
    ((1, 1, 1), "generic"), ((16, 3, 3), "generic"), ((9, 5, 6), "generic"),
])
def test_stencil_route(ks, route):
    """One rule routes the stencil and its kernel gradient alike."""
    assert cuda_conv.stencil_route(ks) == route


@pytest.mark.parametrize("b,z,x,y,want", [
    (16, 64, 64, 64, 2),    # the train batch: 1024 blocks of two tiles
    (64, 64, 64, 64, 4),    # 1024 blocks of four tiles (the most)
    (8, 64, 64, 64, 1),     # 1024 blocks: two tiles a block would leave SMs idle
    (1, 64, 64, 64, 1),     # 128 blocks
    (4, 128, 128, 128, 4),  # 128³ at the large-grid batch
    (2, 13, 37, 70, 1),
    (1, 4, 4, 4, 1),
])
def test_stencil_dk_plan(b, z, x, y, want):
    """Each block of the unrolled kernel gradient walks 1, 2 or 4 g tiles
    along z: the most that keeps DK_FAST_BLOCKS_PER_SM blocks on every SM,
    never more tiles than the volume has."""
    zg = cuda_conv.stencil_dk_plan(b, z, x, y)
    assert zg == want
    tz, tx, ty = cuda_conv.DK_FAST_TILE
    tiles_z = -(-z // tz)
    blocks = b * -(-tiles_z // zg) * -(-x // tx) * -(-y // ty)
    assert zg == 1 or blocks >= cuda_conv.SMS * cuda_conv.DK_FAST_BLOCKS_PER_SM
    assert zg <= max(1, min(cuda_conv.DK_MAX_Z_TILES, tiles_z))


@pytest.mark.parametrize("b,z,x,y,ks,want", [
    (64, 64, 64, 64, (9, 5, 5), 16),   # the batch-64 pipeline: 2048 blocks of the tall tile
    (16, 64, 64, 64, (9, 5, 5), 16),   # the train batch: 512 blocks
    (8, 64, 64, 64, (9, 5, 5), 8),     # --max-batch 8: 256 tall blocks would be under 264
    (1, 64, 64, 64, (9, 5, 5), 8),     # a request: 64 short blocks, not 32 tall ones
    (1, 40, 144, 200, (9, 5, 5), 8),
    (4, 128, 128, 128, (9, 5, 5), 16),  # the large grid
    (64, 64, 64, 64, (16, 6, 14), 8),  # the tall tile's shared memory would not fit
])
def test_stencil_mma_plan(b, z, x, y, ks, want):
    """The tensor-core stencil's z tile: the tall one where it still gives
    every SM's block a tile for each of its MMA_GROUPS groups and fits a
    block's shared memory."""
    tz = cuda_conv.stencil_mma_plan(b, z, x, y, ks)
    assert tz == want
    tall_tiles = b * -(-z // 16) * -(-x // cuda_conv.MMA_TILE_X) * -(-y // cuda_conv.MMA_TILE_Y)
    if tz == cuda_conv.MMA_TALL_Z:
        assert tall_tiles >= cuda_conv.SMS * cuda_conv.MMA_GROUPS
        assert cuda_conv.stencil_mma_smem(ks, tz) <= cuda_conv.MAX_BLOCK_SHARED


@pytest.mark.parametrize("ks,tall,short", [
    ((9, 5, 5), 89600, 64000),      # 25 fragment blocks; 24 and 16 halo planes of 20 x 40
    ((1, 1, 1), 74240, 37376),      # the staged f32 outputs outgrow the halo tile
    ((9, 6, 6), 143616, 105984),    # 9 inputs a y quad: two 8-input chunks, a pitch of 56
    ((16, 16, 16), 443392, 387840),  # over the limit at either tile: the wrapper raises
])
def test_stencil_mma_smem(ks, tall, short):
    """A block's shared memory: the B fragments (k_x x chunks x pair steps,
    512 bytes each) and, for each of the two groups of warps, the larger of
    its bf16 halo tile and its staged f32 output tile (16 x 36 a plane)."""
    assert cuda_conv.stencil_mma_smem(ks, 16) == tall
    assert cuda_conv.stencil_mma_smem(ks, 8) == short
    k_z, k_x, k_y = ks
    frags = k_x * ((k_y + 10) // 8) * ((k_z + 2) // 2) * 512
    assert tall - frags >= 2 * 16 * 16 * 36 * 4 and short - frags >= 2 * 8 * 16 * 36 * 4


def test_mma_wrapper_raises_before_launching_an_oversize_kernel():
    """The shared-memory check needs no card: it raises before any launch."""
    x = torch.zeros((1, 1, 8, 8, 8)).to("meta")
    with pytest.raises(ValueError, match="shared memory"):
        cuda_conv._launch_mma(x, torch.zeros((16, 16, 16)).to("meta"), True, True, None, 8)


@pytest.mark.parametrize("shape,ks,route", [
    ((2, 1, 16, 16, 64), (9, 5, 5), "fast"),   # two y tiles, Y a multiple of 4
    ((1, 1, 13, 18, 40), (9, 5, 5), "fast"),   # ragged z, x and y tiles
    ((2, 1, 9, 17, 35), (9, 5, 5), "fast"),    # Y no multiple of 4: 4-byte staging
    ((2, 1, 16, 16, 16), (1, 1, 1), "generic"),
    ((1, 1, 16, 12, 20), (16, 3, 3), "generic"),
])
def test_stencil_dk_plain_matches_pallas_at_the_shapes_the_route_separates(shape, ks, route):
    """The kernel gradient has two kernels on the card; ``stencil_route``
    picks one from the kernel size alone. On both sides of the rule, and at
    the volume shapes the unrolled kernel treats differently, the plain
    version agrees with the Pallas kernel (interpret mode) within the JAX
    package's own bounds."""
    assert cuda_conv.stencil_route(ks) == route
    rng = np.random.default_rng(sum(shape) + sum(ks))
    x = (rng.random(shape) > 0.7).astype(np.float32)
    g = rng.normal(0, 1, shape).astype(np.float32)
    want = np.asarray(pallas_dk(jnp.asarray(x), jnp.asarray(g), ks, interpret=True))
    got = stencil_dk(torch.from_numpy(x), torch.from_numpy(g), ks).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("ks", [(9, 6, 6), (4, 7, 2)])
def test_conv3d_same_matches_jax(ks):
    """Even kernels take torch's asymmetric pads (low (k-1)//2, high k//2)."""
    x, k = _inputs(1, ks, shape=(1, 10, 12, 9))
    want = np.asarray(jax_conv3d_same(jnp.asarray(x), jnp.asarray(k)[None, None]))
    got = conv3d_same(torch.from_numpy(x), torch.from_numpy(k)[None, None]).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert same_pads((9, 6, 4)) == (1, 2, 2, 3, 4, 4)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.zeros((1, 1, 8, 8, 8))
    with pytest.raises(NotImplementedError, match="B10"):
        geneo_stencil_conv(x, torch.zeros((3, 3, 3)), z_prepadded=True)
    with pytest.raises(ValueError):
        geneo_stencil_conv(torch.zeros((1, 2, 8, 8, 8)), torch.zeros((3, 3, 3)))
    with pytest.raises(TypeError):
        geneo_stencil_conv(x.double(), torch.zeros((3, 3, 3), dtype=torch.float64))


@pytest.mark.parametrize("ks,shape", [((9, 5, 5), (2, 1, 16, 16, 16)),
                                      ((9, 5, 5), (2, 1, 7, 16, 16)),
                                      ((9, 6, 6), (2, 1, 16, 16, 16))])
def test_stencil_dk_plain_matches_pallas(ks, shape):
    """Z=7 is shorter than the kernel; (9,6,6) takes the asymmetric pads."""
    rng = np.random.default_rng(5)
    x = rng.random(shape).astype(np.float32)
    g = rng.random(shape).astype(np.float32)
    want = np.asarray(pallas_dk(jnp.asarray(x), jnp.asarray(g), ks, interpret=True))
    got = stencil_dk(torch.from_numpy(x), torch.from_numpy(g), ks).numpy()
    assert got.shape == ks and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("ks", [(9, 5, 5), (9, 6, 6), (3, 3, 3)])
def test_fused_geneo_conv_grads_match_jax(ks):
    """gx and gk of the autograd Function against jax.grad of the JAX
    package's custom VJP (its XLA formulations, as its own test runs it)."""
    rng = np.random.default_rng(3)
    x = rng.random((2, 1, 16, 16, 16)).astype(np.float32)
    k = (rng.random(ks) * 0.2 - 0.1).astype(np.float32)
    gx_want, gk_want = jax.grad(lambda a, b: jnp.sum(jax_fused(a, b, True) ** 2),
                                argnums=(0, 1))(jnp.asarray(x), jnp.asarray(k))
    xt = torch.from_numpy(x).requires_grad_()
    kt = torch.from_numpy(k).requires_grad_()
    out = fused_geneo_conv(xt, kt)
    (out ** 2).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(jax_fused(jnp.asarray(x), jnp.asarray(k), True)),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_want), atol=1e-5)
    np.testing.assert_allclose(kt.grad.numpy(), np.asarray(gk_want), atol=1e-3, rtol=1e-4)


def test_fused_geneo_conv_skips_dx_for_data():
    """x is data in the train step: no dx is computed for it."""
    calls = []
    x = torch.from_numpy((np.random.default_rng(0).random((1, 1, 8, 8, 8)) > 0.7)
                         .astype(np.float32))
    k = torch.full((3, 3, 3), 0.05, requires_grad=True)
    orig = cuda_conv.geneo_stencil_conv
    try:
        cuda_conv.geneo_stencil_conv = lambda *a, **kw: calls.append(kw) or orig(*a, **kw)
        fused_geneo_conv(x, k).sum().backward()
    finally:
        cuda_conv.geneo_stencil_conv = orig
    assert x.grad is None and k.grad is not None
    assert calls == [{"activation": True}]  # the forward only


def test_dk_and_mxu_forms_raise():
    x = torch.zeros((1, 1, 8, 8, 8))
    with pytest.raises(NotImplementedError, match="B10"):
        stencil_dk(x, x, (3, 3, 3), z_prepadded=True)
    with pytest.raises(ValueError):
        stencil_dk(x, torch.zeros((1, 1, 8, 8, 7)), (3, 3, 3))
    # the tensor-core form checks its arguments as the f32 stencil does
    with pytest.raises(ValueError):
        geneo_stencil_conv_mxu(torch.zeros((1, 2, 8, 8, 8)), torch.zeros((3, 3, 3)))
    with pytest.raises(ValueError):
        geneo_stencil_conv_mxu(x, torch.zeros((3, 3)))
    with pytest.raises(TypeError):
        geneo_stencil_conv_mxu(x, torch.zeros((3, 3, 3), dtype=torch.float64))
    with pytest.raises(TypeError):
        cuda_conv.fused_geneo_conv_mxu(x.double(), torch.zeros((3, 3, 3)))


# ---- the tensor-core form (TPU kernel: geneo_stencil_conv_mxu) ---------------

def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("shape,ks,activation", [
    ((2, 16, 16, 16), (9, 5, 5), True), ((2, 16, 16, 16), (9, 5, 5), False),
    ((2, 16, 16, 16), (3, 3, 3), True), ((2, 16, 16, 16), (3, 3, 3), False),
    ((2, 16, 16, 16), (9, 6, 6), True), ((2, 16, 16, 16), (9, 6, 6), False),
    ((1, 20, 16, 16), (9, 5, 5), True), ((1, 20, 16, 16), (9, 5, 5), False),
    ((1, 64, 96, 96), (3, 3, 3), True),     # past the TPU's resident cap: its
    ((1, 40, 144, 200), (9, 5, 5), False),  # streamed variant, x/y unaligned
])
def test_mxu_plain_matches_pallas_mxu(shape, ks, activation):
    """split=True against the banded-y Pallas kernel (interpret mode) and,
    at the JAX tests' bound, against the f32 conv."""
    x, k = _inputs(sum(ks) + shape[1], ks, shape=shape)
    want = np.asarray(pallas_mxu(jnp.asarray(x), jnp.asarray(k), activation=activation,
                                 split=True, interpret=True))
    got = geneo_stencil_conv_mxu(_t(x), _t(k), activation=activation, split=True).numpy()
    assert got.shape == want.shape == x.shape and got.dtype == np.float32
    bound = ATOL if activation else ATOL * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=bound)
    f32 = geneo_stencil_conv(_t(x), _t(k), activation=activation).numpy()
    np.testing.assert_allclose(got, f32, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("ks", [(9, 5, 5), (9, 6, 6)])
def test_mxu_plain_single_bf16(ks):
    """split=False drops the residual sum: the JAX test's bound against
    f32, and the Pallas kernel's own numbers."""
    rng = np.random.default_rng(33)
    x = (rng.random((1, 1, 16, 16, 16)) > 0.6).astype(np.float32)
    k = rng.standard_normal(ks).astype(np.float32)
    got = geneo_stencil_conv_mxu(_t(x), _t(k), activation=False, split=False).numpy()
    ref = conv3d_same(_t(x), _t(k)[None, None]).numpy()
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got, ref, atol=1.5e-2 * scale, rtol=2e-2)
    assert np.abs(got - ref).max() > 1e-4  # it is the single-bf16 form
    want = np.asarray(pallas_mxu(jnp.asarray(x), jnp.asarray(k), activation=False,
                                 split=False, interpret=True))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL * float(np.abs(want).max()))


def test_mxu_plain_rounds_general_floats_to_bf16():
    """Non-occupancy inputs round to bf16 at the input, as in the TPU
    kernel: bounded like the JAX package's bf16 forward, equal to Pallas."""
    rng = np.random.default_rng(22)
    x = rng.random((1, 1, 16, 16, 16)).astype(np.float32)
    k = rng.standard_normal((3, 3, 3)).astype(np.float32)
    got = geneo_stencil_conv_mxu(_t(x), _t(k), activation=False).numpy()
    ref = conv3d_same(_t(x), _t(k)[None, None]).numpy()
    np.testing.assert_allclose(got, ref, atol=5e-2, rtol=2e-2)
    assert np.abs(got - ref).max() > 1e-4  # the input was rounded
    want = np.asarray(pallas_mxu(jnp.asarray(x), jnp.asarray(k), activation=False,
                                 interpret=True))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL * float(np.abs(want).max()))


@pytest.mark.parametrize("shape,ks,split", [
    ((2, 16, 16, 16), (9, 5, 5), True), ((2, 16, 16, 16), (9, 5, 5), False),
    ((1, 20, 16, 16), (9, 6, 6), True)])
def test_mxu_fused_tau_mask(shape, ks, split):
    """The fused mask is (probs >= f32(τ)) of the same function's
    probabilities, exactly; against the Pallas mask it may differ only
    where the Pallas probability lies within 1e-5 of τ."""
    rng = np.random.default_rng(36)
    x = (rng.random(shape) > 0.6).astype(np.float32)[:, None]
    k = (rng.standard_normal(ks) * 0.1).astype(np.float32)
    probs = geneo_stencil_conv_mxu(_t(x), _t(k), split=split).numpy()
    got = geneo_stencil_conv_mxu(_t(x), _t(k), split=split, tau=0.65).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, (probs >= np.float32(0.65)).astype(np.float32))
    assert 0 < got.sum() < got.size
    jprobs = np.asarray(pallas_mxu(jnp.asarray(x), jnp.asarray(k), split=split,
                                   interpret=True))
    jmask = np.asarray(pallas_mxu(jnp.asarray(x), jnp.asarray(k), split=split, tau=0.65,
                                  interpret=True))
    differ = got != jmask
    assert not (differ & (np.abs(jprobs - 0.65) > ATOL)).any()
    # without the head the threshold applies to the raw conv value
    raw = geneo_stencil_conv_mxu(_t(x), _t(k), activation=False, split=split).numpy()
    np.testing.assert_array_equal(
        geneo_stencil_conv_mxu(_t(x), _t(k), activation=False, split=split, tau=0.65).numpy(),
        (raw >= np.float32(0.65)).astype(np.float32))


@pytest.mark.parametrize("ks", [(9, 5, 5), (9, 6, 6), (3, 3, 3)])
def test_split_kernel_bf16_equals_banded_weights(ks):
    """hi and lo are, bit for bit, the values the JAX package places on its
    bands: column y of by[q][dz, dx] holds k[dz, dx, :] at rows y..y+k_y-1."""
    k = np.random.default_rng(0).standard_normal(ks).astype(np.float32)
    by = banded_y_weights(jnp.asarray(k), 16, 128, True)
    hi, lo = split_kernel_bf16(_t(k))
    assert hi.dtype == lo.dtype == torch.bfloat16 and tuple(hi.shape) == ks
    for q, got in enumerate((hi, lo)):
        band = np.asarray(by[q].astype(jnp.float32))       # (k_z, k_x, 128, 16)
        for y in (0, 7):
            want = band[:, :, y:y + ks[2], y]              # back to (k_z, k_x, k_y)
            np.testing.assert_array_equal(got.float().numpy(), want)
    assert float(lo.float().abs().max()) > 0
    # hi + lo/2⁹ recovers k to about 16 mantissa bits
    np.testing.assert_allclose(hi.float().numpy() + lo.float().numpy() / 512.0, k,
                               rtol=2 ** -15, atol=0)


def test_fused_geneo_conv_mxu_forward_and_grads():
    """Forward: the plain tensor-core form. dk and dx: the exact f32
    backward, against autograd of the plain f32 conv at the JAX tests'
    bounds (value rtol 1e-4; gradients rtol 2e-3, atol 2e-3)."""
    rng = np.random.default_rng(41)
    x = (rng.random((2, 1, 16, 16, 16)) > 0.6).astype(np.float32)
    k = rng.standard_normal((9, 5, 5)).astype(np.float32)
    xt, kt = _t(x).requires_grad_(), _t(k).requires_grad_()
    out = fused_geneo_conv_mxu(xt, kt)
    assert torch.equal(out.detach(), cuda_conv.geneo_stencil_conv_mxu_plain(_t(x), _t(k)))
    (out ** 2).sum().backward()
    xr, kr = _t(x).requires_grad_(), _t(k).requires_grad_()
    ref = torch.relu(torch.tanh(conv3d_same(xr, kr[None, None])))
    (ref ** 2).sum().backward()
    np.testing.assert_allclose(float((out.detach() ** 2).sum()),
                               float((ref.detach() ** 2).sum()), rtol=1e-4)
    np.testing.assert_allclose(kt.grad.numpy(), kr.grad.numpy(), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(xt.grad.numpy(), xr.grad.numpy(), rtol=2e-3, atol=2e-3)


def test_fused_geneo_conv_mxu_matches_jax_vjp():
    """Value and dk against jax.grad of the JAX package's custom VJP over
    the Pallas kernel in interpret mode."""
    from scenenet_tpu.ops.pallas_conv import fused_geneo_conv_mxu as jax_fused_mxu

    rng = np.random.default_rng(42)
    x = (rng.random((2, 1, 16, 16, 16)) > 0.6).astype(np.float32)
    k = (rng.standard_normal((9, 5, 5)) * 0.2).astype(np.float32)
    v_want, g_want = jax.value_and_grad(
        lambda kk: jnp.sum(jax_fused_mxu(jnp.asarray(x), kk, True) ** 2))(jnp.asarray(k))
    kt = _t(k).requires_grad_()
    v = (fused_geneo_conv_mxu(_t(x), kt) ** 2).sum()
    v.backward()
    np.testing.assert_allclose(float(v.detach()), float(v_want), rtol=1e-4)
    np.testing.assert_allclose(kt.grad.numpy(), np.asarray(g_want), rtol=2e-3, atol=2e-3)
