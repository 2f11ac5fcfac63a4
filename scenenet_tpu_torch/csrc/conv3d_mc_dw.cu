// Weight gradient of the multi-channel 3x3x3 SAME conv3d (stride 1, zero pad
// 1, f32 in and out): dw[co, ci, dz, dx, dy] = sum over b, z, x, y of
// g[b, co, z, x, y] * x[b, ci, z - 1 + dz, x - 1 + dx, y - 1 + dy], with taps
// outside the volume reading 0. For Hopper (sm_90a), on the tensor cores.
//
// Replaces no TPU kernel. The JAX package's conv3d_mc_same
// (scenenet_tpu/ops/pallas_conv_mc.py) carries no custom gradient, so XLA
// computes its weight gradient. The port took it from PyTorch
// (torch.nn.grad.conv3d_weight with cuDNN off, cuDNN's f32 3D weight gradient
// being slower still): a vol2col column matrix of 27 * C_in x S floats a
// sample (906 MB at 32->32 on 64^3), then a full-f32 SIMT GEMM on it. In the
// UNet's train step (batch 16, 64^3) that was about 94 ms of a 195.5 ms busy
// step: vol2col 20.1% and the f32 GEMMs about 28% of the device time.
//
// Bound on the H100: operations. The UNet's 18 convs make 1.754 TFLOP of dw a
// step: 3.54 ms at TF32's 495 TFLOP/s, 7.09 ms at the rate of the split
// products below (one TF32 and two bf16 products an f32 product). Only the
// 1->32 first layer is bound by its bytes: 16.8 MB of x and 537 MB of g,
// 0.165 ms at 3.35 TB/s, against 0.029 ms of split products.
//
// The arithmetic is K10's (conv3d_mc.cu): each f32 operand is hi + lo with hi
// its TF32 part (the leading 10 mantissa bits, by a mask) and lo = v - hi, and
// the product is hi*hi on the TF32 m16n8k8 mma plus lo*hi + hi*lo in one bf16
// m16n8k16 mma: its K slots hold (lo_g, g) against (x, lo_x) for 8 voxels.
// The lo*lo term (2^-20 of a product) is dropped. A single-pass TF32 product
// would be a lower precision, not a faster f32.
//
// Design (conv3d_mc_dw_kernel). As a GEMM: M = C_out, N = 27 * C_in, K = the
// B * Z * X * Y voxels, walked as stages of one tile of 256 voxels (128 in
// the two-sample tile).
//  - A block owns 32 output channels x 16 input channels x 27 taps, and a
//    run of stages (the K split, chosen by the caller from the shape, so that
//    the 64^3 layers, where M * N is small, still fill the 132 SMs). Its 12
//    warps are (dz, one m16 tile of output channels, one n8 tile of input
//    channels); a warp takes the 9 taps (dx, dy) of its dz: 36 accumulators.
//    Up to 8 input channels (the 1->32 layer, the CNN's 3) a block takes 8,
//    one n8 tile, and the two warps of a pair take the even and the odd K
//    steps, their sums joined in a fixed order at the end: the 1->32 layer
//    runs as 8->32, 0.85 ms against 1.61 padded to 16 channels (the
//    library's 1.55; my chip runs on the H100).
//  - mma.sync, not wgmma: the 27 taps are reads of one staged x tile at
//    offsets one element apart, which mma.sync's register fragments take as
//    plain shared loads. wgmma would want one shifted copy of the tile per
//    tap offset in y.
//  - A stage's two tiles, g's (32 channels x the tile's voxels) and x's halo
//    (the block's input channels, one voxel of halo a side, zeros outside the
//    volume), are each one tensor copy (TMA, cp.async.bulk.tensor), issued by
//    one thread a stage ahead and awaited on an mbarrier. Per-thread cp.async
//    copies (4 and 16 bytes) were tried first: no warp computes while the
//    copies are issued, and that added the copies' whole time to the mma
//    loop's (32->32 at 64^3: 3.91 ms against 2.60 without staging; the
//    tensor copies: 3.21). A box's rows start on 16-byte words (the copy
//    faults on x at y0 - 1), so x's box starts at y0 - 4. Shapes the maps
//    cannot describe (Y % 4 != 0, a base off 16 bytes) take 4-byte cp.async.
//  - x is split once a stage, when it is staged, into (TF32 hi, bf16 x |
//    bf16 lo) slots: each value is split once for its 27 taps, and one 8-byte
//    load gives a fragment register pair. A warp splits its g fragment in
//    registers once a K step and keeps it for its 9 taps.
//  - Channel strides are 4 mod 16 slots (x) and 4 mod 32 words (g): a
//    fragment load's 8 channels x 4 voxels fall in different banks at every
//    tap offset. What bounds the loop now: those loads, 40 wavefronts of
//    shared memory a warp's K step against 18 mma (the mma alone take 36
//    cycles of an SM's four sub-cores). A warp over both m16 tiles would halve
//    them, and takes registers 12 warps do not have.
//  - The tensor cores add to their accumulator with truncation, and a K
//    split block sums up to 16 M products. So a stage's products are summed
//    in the tensor core from zero and added to the f32 running sum, rounded
//    to nearest, once a stage (K10's rule).
//  - The K split's partial sums are added in a fixed order by a second
//    kernel (conv3d_mc_dw_reduce_kernel). No atomics: two runs give the same
//    bits.

#include <cstdint>

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "conv3d_mc_common.cuh"

namespace {

using snt::cp_async4;
using snt::cp_async_commit;
using snt::cp_async_wait;
using snt::kTf32Mask;
using snt::mma_bf16;
using snt::mma_tf32;
using snt::pack_bf16;

constexpr int kDwThreads = 384;  // 12 warps: (dz, m16 tile, n8 tile or half of the K steps)
constexpr int kDwCo = 32;        // output channels of a block: two m16 tiles

// a stage's voxels: TB samples x TZ x TX x TY, y fastest. The halo tile
// copied is rows (sample, channel, z, x) of W = TY + 8 voxels along y from
// y0 - 4: a tensor copy's box starts and ends on 16-byte words along its
// rows (y0 is a multiple of 4). Split, a channel's rows (sample, z, x) hold
// HYS = TY + 4 slots from y0 - 1 (the last two unused): element (row, hy) is
// slot row * HYS + hy.
// CI: input channels of a block, two n8 tiles (16) or one (8: C_in <= 8, the
// two warps of a pair then taking the even and the odd K steps).
template <int TB_, int TZ_, int TX_, int TY_, int CI_>
struct DwTile {
  static constexpr int TB = TB_, TZ = TZ_, TX = TX_, TY = TY_, CI = CI_;
  static constexpr int VT1 = TZ * TX * TY;  // voxels of one sample's tile
  static constexpr int VT = TB * VT1;
  static constexpr int HZ = TZ + 2, HX = TX + 2, HYS = TY + 4, W = TY + 8;
  static constexpr int RC = HZ * HX * HYS;   // slots of one sample's halo rows of a channel
  static constexpr int HV = TB * RC;         // slots of one channel's halo tile
  static constexpr int CS = (HV - 4 + 15) / 16 * 16 + 4;  // split x channel stride, 4 mod 16
  static constexpr int GS = VT + 4;                       // g channel stride, 4 mod 32
  static constexpr int XRAW = CI * TB * HZ * HX * W;  // the copied x tile: [tb][ci][z][x][W]
  static constexpr int GRAW = kDwCo * VT;    // floats of the copied g tile: [tb][co][voxel]
  // the copied tiles (x, g), x split (a TF32 word and a bf16 pair a slot), g
  // laid out by channel; each part's offset a multiple of 128 bytes
  static constexpr int XRAW_B = XRAW * 4, GRAW_B = GRAW * 4;
  static constexpr int XS_OFF = (XRAW_B + GRAW_B + 127) / 128 * 128;
  static constexpr int GP_OFF = XS_OFF + (CI * CS * 8 + 127) / 128 * 128;
  static constexpr int BAR_OFF = GP_OFF + (kDwCo * GS * 4 + 127) / 128 * 128;
  static constexpr size_t SMEM = BAR_OFF + 16 + 128;  // and room to align the base to 128
  static_assert(VT % 32 == 0 && TY % 4 == 0, "a K step is two runs of 4 voxels along y");
  static_assert(CI == 16 || CI == 8, "one or two n8 tiles of input channels");
  static_assert(CI == 16 || CI * CS * 8 >= 6 * 36 * 32 * 4, "room for a half's sums");
  static_assert(CS % 16 == 4 && CS >= HV && GS % 32 == 4, "channel strides");
  static_assert(XRAW_B % 128 == 0, "the g tile's copy lands on 128 bytes");
  static_assert(SMEM <= 232448, "shared memory of a block");
};

// tile voxel v -> its slot in the halo tile at tap (0, 0, 0)
template <class T>
__device__ inline int halo_pos(int v) {
  const int lb = v / T::VT1, lz = v / (T::TY * T::TX) % T::TZ, lx = v / T::TY % T::TX;
  return lb * T::RC + (lz * T::HX + lx) * T::HYS + v % T::TY;
}

__device__ inline unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ inline void mbar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ inline void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ inline void mbar_wait(unsigned bar, unsigned phase) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(phase) : "memory");
  }
}

// the tensor copy of one box of a 5-dimensional map, completing on `bar`
__device__ inline void tma_load5(unsigned dst, const CUtensorMap* map, int c0, int c1, int c2,
                                 int c3, int c4, unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n" ::"r"(dst),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(c4), "r"(bar)
      : "memory");
}

// TMA: the two tiles go in by the tensor copy (Y % 4 == 0 and x, g 16-byte
// aligned: the maps' strides and bases are whole 16-byte words); else by
// cp.async, 4 bytes an element, zero-filled outside.
template <class T, bool TMA>
__global__ void __launch_bounds__(kDwThreads, 1)
conv3d_mc_dw_kernel(const __grid_constant__ CUtensorMap x_map,
                    const __grid_constant__ CUtensorMap g_map, const float* __restrict__ x,
                    const float* __restrict__ g, float* __restrict__ dst, int B, int C_in,
                    int C_out, int Z, int X, int Y, int tiles_z, int tiles_x, int tiles_y,
                    int n_stages, int co_tiles, int ci_tiles, int splits) {
  // the tensor copies land on 128 bytes; offsetting the array itself (not a
  // rounded address) keeps its loads shared-memory loads
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* base = smem_raw + (-smem_addr(smem_raw) & 127u);
  float* xraw = reinterpret_cast<float*>(base);
  float* graw = reinterpret_cast<float*>(base + T::XRAW_B);
  uint2* xsplit = reinterpret_cast<uint2*>(base + T::XS_OFF);
  float* gpad = reinterpret_cast<float*>(base + T::GP_OFF);
  const unsigned bar = smem_addr(base + T::BAR_OFF);

  // block -> (K split, input-channel tile, output-channel tile); the channel
  // tiles of one K split are neighbours and share its x and g in L2
  int bid = blockIdx.x;
  const int cot = bid % co_tiles;
  bid /= co_tiles;
  const int cit = bid % ci_tiles;
  const int ks = bid / ci_tiles;
  const int s_begin = (int)((long long)ks * n_stages / splits);
  const int s_end = (int)((long long)(ks + 1) * n_stages / splits);
  const int co0 = cot * kDwCo, ci0 = cit * T::CI;
  const int tid = threadIdx.x;

  // stage s: x's halo tile and g's tile into xraw and graw
  auto fetch = [&](int s) {
    const int y0 = (s % tiles_y) * T::TY;
    s /= tiles_y;
    const int x0 = (s % tiles_x) * T::TX;
    s /= tiles_x;
    const int z0 = (s % tiles_z) * T::TZ;
    const int b0 = (s / tiles_z) * T::TB;
    if constexpr (TMA) {
      if (tid == 0) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_expect(bar, (unsigned)(T::XRAW_B + T::GRAW_B));
        tma_load5(smem_addr(xraw), &x_map, y0 - 4, x0 - 1, z0 - 1, ci0, b0, bar);
        tma_load5(smem_addr(graw), &g_map, y0, x0, z0, co0, b0, bar);
      }
    } else {
      const long long V = (long long)Z * X * Y;
      for (int i = tid; i < T::XRAW; i += kDwThreads) {
        const int hy = i % T::W, hx = i / T::W % T::HX, hz = i / (T::W * T::HX) % T::HZ;
        const int ch = i / (T::W * T::HX * T::HZ) % T::CI;
        const int b = b0 + i / (T::W * T::HX * T::HZ * T::CI);
        const int gz = z0 - 1 + hz, gx = x0 - 1 + hx, gy = y0 - 4 + hy;
        const bool ok = b < B && ci0 + ch < C_in && gz >= 0 && gz < Z && gx >= 0 && gx < X &&
                        gy >= 0 && gy < Y;
        cp_async4(xraw + i,
                  ok ? x + ((long long)b * C_in + ci0 + ch) * V + ((long long)gz * X + gx) * Y + gy
                     : x,
                  ok);
      }
      for (int i = tid; i < T::GRAW; i += kDwThreads) {
        const int gy = y0 + i % T::TY, gx = x0 + i / T::TY % T::TX;
        const int gz = z0 + i / (T::TY * T::TX) % T::TZ;
        const int co = i / T::VT1 % kDwCo, b = b0 + i / (T::VT1 * kDwCo);
        const bool ok = b < B && co0 + co < C_out && gz < Z && gx < X && gy < Y;
        cp_async4(graw + i,
                  ok ? g + ((long long)b * C_out + co0 + co) * V + ((long long)gz * X + gx) * Y + gy
                     : g,
                  ok);
      }
      cp_async_commit();
    }
  };

  if constexpr (TMA) {
    if (tid == 0) mbar_init(bar);
    __syncthreads();
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int dz = warp >> 2, mi = (warp >> 1) & 1, nj = warp & 1;

  // acc: the running sum, added to in f32 registers once a stage; part: one
  // stage's mma, summed in the tensor core from zero. Entry [dx * 3 + dy].
  float acc[9][4], part[9][4];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[k][e] = 0.0f;
  }

  // the warp's x fragments: channel 8 nj + gq of the block (gq where CI = 8),
  // halo rows of dz; its g fragment rows: output channels 16 mi + gq and + 8;
  // its K steps: every one, or (CI = 8) those of parity nj
  constexpr int KSTEP = T::CI == 16 ? 1 : 2;
  const int k0 = T::CI == 16 ? 0 : nj;
  const uint2* xs = xsplit + ((T::CI == 16 ? 8 * nj : 0) + gq) * T::CS + dz * T::HX * T::HYS;
  const float* ga = gpad + (16 * mi + gq) * T::GS + t;

  if (s_begin < s_end) fetch(s_begin);
  for (int s = s_begin; s < s_end; ++s) {
    if constexpr (TMA) {
      mbar_wait(bar, (unsigned)((s - s_begin) & 1));
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // x(s) and g(s) landed; every warp is done with stage s - 1
    // x split once a value (hi by the mask, bf16 x | bf16 lo for the cross
    // terms) into slots by channel, a thread one slot hy of every RSTEP-th row
    // (sample, channel, z, x) as copied; g laid out by channel
    constexpr int RSTEP = kDwThreads / T::HYS;
    if (tid < RSTEP * T::HYS) {
      const int hy = tid % T::HYS;
#pragma unroll 4
      for (int row = tid / T::HYS; row < T::CI * T::TB * T::HZ * T::HX; row += RSTEP) {
        const int ch = row / (T::HZ * T::HX) % T::CI;
        const int slot = ch * T::CS + (row / (T::HZ * T::HX * T::CI) * T::HZ * T::HX +
                                       row % (T::HZ * T::HX)) * T::HYS + hy;
        const float v = xraw[row * T::W + 3 + hy];
        const unsigned h = __float_as_uint(v) & kTf32Mask;
        xsplit[slot] = make_uint2(h, pack_bf16(v, v - __uint_as_float(h)));
      }
    }
    for (int i = tid; i < T::GRAW / 4; i += kDwThreads) {
      const int co = 4 * i / T::VT1 % kDwCo;
      const int v = 4 * i / (T::VT1 * kDwCo) * T::VT1 + 4 * i % T::VT1;
      reinterpret_cast<float4*>(gpad + co * T::GS + v)[0] =
          reinterpret_cast<const float4*>(graw)[i];
    }
    __syncthreads();  // the split tiles are ready; xraw and graw are free
    if (s + 1 < s_end) fetch(s + 1);

#pragma unroll
    for (int k = 0; k < 9; ++k) {
#pragma unroll
      for (int e = 0; e < 4; ++e) part[k][e] = 0.0f;
    }
#pragma unroll 2
    for (int kk = k0; kk < T::VT / 8; kk += KSTEP) {
      // A (16 output channels x 8 voxels): registers 0..3 hold (row gq, voxel
      // t), (gq + 8, t), (gq, t + 4), (gq + 8, t + 4); the bf16 form's K slots
      // 2t, 2t + 1 (and 2t + 8, 2t + 9) are (lo_g, g) of the same voxel
      const float av[4] = {ga[8 * kk], ga[8 * T::GS + 8 * kk], ga[8 * kk + 4],
                           ga[8 * T::GS + 8 * kk + 4]};
      unsigned ahi[4], apr[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ahi[e] = __float_as_uint(av[e]) & kTf32Mask;
        apr[e] = pack_bf16(av[e] - __uint_as_float(ahi[e]), av[e]);
      }
      // B (8 voxels x 8 input channels): voxels t and t + 4 of channel gq,
      // shifted by the tap; one 8-byte load gives a voxel's TF32 word and pair
      const int h0 = halo_pos<T>(8 * kk + t), h1 = halo_pos<T>(8 * kk + t + 4);
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          const int o = dx * T::HYS + dy;
          const uint2 b0 = xs[h0 + o], b1 = xs[h1 + o];
          mma_bf16(part[dx * 3 + dy], apr, b0.y, b1.y);
          mma_tf32(part[dx * 3 + dy], ahi, b0.x, b1.x);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 9; ++k) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[k][e] += part[k][e];
    }
  }

  // C layout: registers 0, 1 are (row gq, columns 2t, 2t + 1), registers 2, 3
  // the same columns of row gq + 8; rows are output channels, columns input
  // channels. K split ks writes slab ks of the scratch.
  if constexpr (T::CI == 8) {
    // the odd K steps' sums join the even ones' in shared memory, in that order
    float* half = reinterpret_cast<float*>(xsplit);
    __syncthreads();  // every warp is done with the split tile
    if (nj == 1) {
#pragma unroll
      for (int k = 0; k < 9; ++k) {
#pragma unroll
        for (int e = 0; e < 4; ++e) half[((warp >> 1) * 36 + k * 4 + e) * 32 + lane] = acc[k][e];
      }
    }
    __syncthreads();
    if (nj == 1) return;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[k][e] += half[((warp >> 1) * 36 + k * 4 + e) * 32 + lane];
    }
  }
  float* out = dst + (long long)ks * C_out * C_in * 27;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int co = co0 + 16 * mi + gq + 8 * (e >> 1);
    const int ci = ci0 + (T::CI == 16 ? 8 * nj : 0) + 2 * t + (e & 1);
    if (co >= C_out || ci >= C_in) continue;
    float* o = out + ((long long)co * C_in + ci) * 27 + dz * 9;
#pragma unroll
    for (int k = 0; k < 9; ++k) o[k] = acc[k][e];
  }
}

// out[i] = partial[0][i] + partial[1][i] + ... in that order
__global__ void conv3d_mc_dw_reduce_kernel(const float* __restrict__ partial,
                                           float* __restrict__ out, long long n, int splits) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    float s = partial[i];
#pragma unroll 8
    for (int k = 1; k < splits; ++k) s += partial[(long long)k * n + i];
    out[i] = s;
  }
}

struct DwArgs {
  const float* x;
  const float* g;
  float* out;
  float* partial;
  int B, C_in, C_out, Z, X, Y, splits, vec;
  cudaStream_t s;
};

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime: no link to libcuda
PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// a 5-dimensional map of the f32 tensor (B, C, Z, X, Y) at `data`, boxes of
// (box_y, box_x, box_z, box_c, box_b) elements, zeros outside
bool encode5(CUtensorMap* map, const float* data, int B, int C, int Z, int X, int Y, int box_y,
             int box_x, int box_z, int box_c, int box_b) {
  const PFN_cuTensorMapEncodeTiled_v12000 fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[5] = {(cuuint64_t)Y, (cuuint64_t)X, (cuuint64_t)Z, (cuuint64_t)C,
                              (cuuint64_t)B};
  const cuuint64_t strides[4] = {(cuuint64_t)Y * 4, (cuuint64_t)X * Y * 4,
                                 (cuuint64_t)Z * X * Y * 4, (cuuint64_t)C * Z * X * Y * 4};
  const cuuint32_t box[5] = {(cuuint32_t)box_y, (cuuint32_t)box_x, (cuuint32_t)box_z,
                             (cuuint32_t)box_c, (cuuint32_t)box_b};
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 5, const_cast<float*>(data), dims, strides,
            box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <class T, bool TMA>
int launch_dw_form(const DwArgs& a, const CUtensorMap& x_map, const CUtensorMap& g_map,
                   long long tiles_z, long long tiles_x, long long tiles_y, long long n_stages,
                   long long co_tiles, long long ci_tiles, long long blocks) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(conv3d_mc_dw_kernel<T, TMA>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)T::SMEM);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  conv3d_mc_dw_kernel<T, TMA><<<(unsigned)blocks, kDwThreads, T::SMEM, a.s>>>(
      x_map, g_map, a.x, a.g, a.splits > 1 ? a.partial : a.out, a.B, a.C_in, a.C_out, a.Z,
      a.X, a.Y, (int)tiles_z, (int)tiles_x, (int)tiles_y, (int)n_stages, (int)co_tiles,
      (int)ci_tiles, a.splits);
  return (int)cudaGetLastError();
}

template <class T>
int launch_dw(const DwArgs& a) {
  const long long tiles_z = (a.Z + T::TZ - 1) / T::TZ, tiles_x = (a.X + T::TX - 1) / T::TX,
                  tiles_y = (a.Y + T::TY - 1) / T::TY, tiles_b = (a.B + T::TB - 1) / T::TB;
  const long long n_stages = tiles_b * tiles_z * tiles_x * tiles_y;
  const long long co_tiles = (a.C_out + kDwCo - 1) / kDwCo,
                  ci_tiles = (a.C_in + T::CI - 1) / T::CI;
  const long long blocks = co_tiles * ci_tiles * a.splits;
  if (n_stages > 2147483647LL || blocks > 2147483647LL || a.splits < 1 ||
      a.splits > n_stages || (a.splits > 1 && a.partial == nullptr))
    return (int)cudaErrorInvalidValue;
  CUtensorMap x_map{}, g_map{};
  int e;
  if (a.vec && encode5(&x_map, a.x, a.B, a.C_in, a.Z, a.X, a.Y, T::W, T::HX, T::HZ, T::CI,
                       T::TB) &&
      encode5(&g_map, a.g, a.B, a.C_out, a.Z, a.X, a.Y, T::TY, T::TX, T::TZ, kDwCo, T::TB)) {
    e = launch_dw_form<T, true>(a, x_map, g_map, tiles_z, tiles_x, tiles_y, n_stages, co_tiles,
                                ci_tiles, blocks);
  } else {
    e = launch_dw_form<T, false>(a, x_map, g_map, tiles_z, tiles_x, tiles_y, n_stages,
                                 co_tiles, ci_tiles, blocks);
  }
  if (e != cudaSuccess || a.splits == 1) return e;
  const long long n = (long long)a.C_out * a.C_in * 27;
  const int rblocks = (int)((n + 255) / 256 < 2048 ? (n + 255) / 256 : 2048);
  conv3d_mc_dw_reduce_kernel<<<rblocks, 256, 0, a.s>>>(a.partial, a.out, n, a.splits);
  return (int)cudaGetLastError();
}

}  // namespace

// The weight gradient. x (B, C_in, Z, X, Y) and g (B, C_out, Z, X, Y), f32,
// contiguous; out (C_out, C_in, 3, 3, 3), f32, contiguous. tile: 0 = 4x4x16
// voxels a stage, 1 = 4x8x8, 2 = 2 samples x 4x4x4, each with 16 input
// channels a block; 3, 4, 5 the same with 8. splits: the K split, at
// most the tile's stages; partial: scratch of splits * C_out * C_in * 27
// floats when splits > 1, else unused. vec: the caller's promise that Y % 4
// == 0 and x and g are 16-byte aligned (the tiles then go in by the tensor
// copy). Launches the kernel and, for splits > 1, the reduction on `stream`;
// returns cudaGetLastError().
extern "C" int snt_conv3d_mc_dw(const float* x, const float* g, float* out, float* partial,
                                int B, int C_in, int C_out, int Z, int X, int Y, int tile,
                                int splits, int vec, void* stream) {
  if (B <= 0 || C_in <= 0 || C_out <= 0 || Z <= 0 || X <= 0 || Y <= 0 || tile < 0 || tile > 5)
    return (int)cudaErrorInvalidValue;
  const DwArgs a{x, g, out, partial, B, C_in, C_out, Z, X, Y, splits, vec,
                 static_cast<cudaStream_t>(stream)};
  switch (tile) {
    case 0:
      return launch_dw<DwTile<1, 4, 4, 16, 16>>(a);
    case 1:
      return launch_dw<DwTile<1, 4, 8, 8, 16>>(a);
    case 2:
      return launch_dw<DwTile<2, 4, 4, 4, 16>>(a);
    case 3:
      return launch_dw<DwTile<1, 4, 4, 16, 8>>(a);
    case 4:
      return launch_dw<DwTile<1, 4, 8, 8, 8>>(a);
    default:
      return launch_dw<DwTile<2, 4, 4, 4, 8>>(a);
  }
}
