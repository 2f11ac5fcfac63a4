// Multi-channel 3x3x3 SAME conv3d, stride 1, no bias, f32 in, f32 out, for
// Hopper (sm_90a): a tensor-core kernel (a three-product split of every f32
// product, f32 sums) for every layer with more than 4 input channels, and an
// f32 FMA kernel for the rest; and a bf16 form of both (bf16 in and out, f32
// sums).
//
// Replaces: scenenet_tpu/ops/pallas_conv_mc.py, conv3d_mc_same
// (_mc_kernel_vmem, whole sample resident, and _mc_kernel, streamed tiles).
//
// out[b,co,z,x,y] = sum_{ci,dz,dx,dy} x[b,ci,z-1+dz,x-1+dx,y-1+dy] * w[co,ci,dz,dx,dy]
// with taps outside the volume reading 0.
//
// Bound on the H100: operations. A 32->32 layer at 64^3 does 27*32 = 864
// multiply-adds for every output float, so device memory is far from the
// limit (only the 1->32 first layer is bound by its output bytes). On the
// f32 FMA pipe (67 TFLOP/s) that was the ceiling of the first version of
// this kernel. The tensor cores run TF32 at 495 TFLOP/s and bf16 at 989, but
// TF32 alone keeps 10 mantissa bits. So each f32 operand is split into
// hi = its TF32 part and lo = v - hi, and the product is taken as
// hi*hi + (lo*hi + hi*lo), dropping lo*lo (2^-21 of the product). hi*hi is
// one TF32 mma. The two cross terms are 2^-11 of it, so bf16's 8 bits are
// enough for them (2^-20 of the product), and both go into ONE bf16
// m16n8k16 mma: its 16 K slots hold (lo, v) of the step's 8 channels
// against (w, w_lo). Two mma for 8 channels of one tap
// where 3xTF32 takes three; the cheapest arithmetic found that holds the f32
// tolerance is one TF32 and two bf16 products an f32 product.
//
// Design of the tensor-core kernel (conv3d_mc_tc_kernel). The sum is an
// implicit GEMM that never builds the patch matrix: M = the voxels of a tile,
// N = output channels, K = 27 taps x C_in, walked as chunks of 8 input
// channels x 27 taps, so that one m16n8k8 step is one tap of 8 channels.
//  - mma.sync (m16n8k8 TF32, m16n8k16 bf16) by inline PTX, not wgmma: the A operand is
//    gathered from a halo tile at a different offset for every tap, which
//    mma.sync's register fragments take as plain shared loads, while wgmma
//    wants A as a dense, swizzled tile in shared memory (one copy per tap) or
//    in registers in its own layout. wgmma is the later step.
//  - A block of 8 warps owns a tile of 256 or 512 voxels x 32 or 64 output
//    channels; a warp owns 64 voxels x 32 channels (4 x 4 mma tiles, 64
//    accumulators). Four tile shapes: 4x8x16 and 8x8x8 voxels for up to 32
//    output channels, 4x8x8 for more, and 4 samples x 4x4x4 where the volume
//    is 4^3, so no tile is half outside the volume there (the batch is folded
//    into the voxel axis of the GEMM).
//  - Where tiles alone give fewer than two blocks an SM, C_in is split across
//    k_splits blocks (the plan is made by the caller); each writes its
//    partial sums to scratch and a second kernel adds them in a fixed order.
//    No atomics: the same input gives the same bits on every run.
//  - Weights are split and laid out once a call by a small kernel
//    (conv3d_mc_split_kernel), already in the register layout of the two
//    mma's B fragments: a lane reads its TF32 pair and its two bf16 pairs of
//    one tap and 8 channels as one 16-byte shared load. The inputs are split
//    in registers as they are loaded: hi = the leading 10 mantissa bits (a
//    mask, where cvt.rna.tf32 runs at a quarter of the ALU's rate: measured
//    12% of the kernel's time), lo = v - hi (exact), and one cvt packs
//    (bf16 lo, bf16 v) for the cross terms' A fragment.
//  - A ring of two stages in dynamic shared memory, filled by cp.async while
//    the tensor cores run: a stage is the 9 taps of one dz of a chunk's
//    weights; the chunk's halo tile (8 channels, zero-filled at the volume
//    edge through cp.async's zero-size form: no padded copy of the volume
//    exists) is double-buffered beside it. The halo's decomposition into
//    global offsets is done once a block, into a table in shared memory.
//    The copies are 4 bytes each, for any Y and alignment; a tile row padded
//    to a 16-byte boundary and copied 16 bytes at a time was tried and moved
//    the 18-conv sum by 1%: the ring already hides the staging.
//  - The channel stride of the halo tile is 8 mod 32 floats, so the four
//    channels x eight voxels of an A-fragment load fall in 32 different
//    banks.
//  - The tensor cores add to their accumulator with truncation. Summed in
//    the tensor core over a 512-channel layer (5184 mma as 3xTF32), that bias
//    alone is 8.5e-5 on outputs of magnitude 1 (measured), past the
//    tolerance. So a stage's 18 mma are summed in the tensor core from zero
//    (a sum that small loses nothing f32 would see) and added to the running
//    sum in f32 registers by the FMA pipe, with round-to-nearest: 64 additions
//    for 288 mma. That is 128 accumulator registers a thread, so one block of
//    256 threads an SM, with up to 255 registers each.
//  - What bounds it now: mma.sync's own rate and its latency at 8 warps an
//    SM. Measured at 32->32, 64^3, batch 16: the loop with the hi*hi product
//    alone 1.75 ms, each further TF32 m16n8k8 a K step 8 clocks of a sub-core
//    (about 240 TFLOP/s for the card, half the wgmma peak): 3.3 ms as 3xTF32,
//    2.8 ms with the cross terms in one bf16 mma.
//
// The bf16 form (conv3d_mc_tc_bf16_kernel, entry snt_conv3d_mc_tc_bf16) takes
// bf16 x and w and writes bf16, for the bf16 UNet. A bf16 product is exact in
// f32, so it needs no split: one m16n8k16 bf16 mma takes 16 input channels of
// one tap, half the instructions of a TF32 m16n8k8 for the same K and half
// the shared bytes of an f32 tile. Bound: operations (a 32->32 layer at 64^3
// does 864 multiply-adds an output, 0.23 ms of the bf16 peak against 0.07 ms
// of bytes). Its design:
//  - The A fragment's register holds two neighbouring K slots, so the tile in
//    shared memory interleaves channel pairs: word (pair p, voxel v) holds
//    channels 2p and 2p + 1 of voxel v. The fragment loads are then the f32
//    form's: four conflict-free 32-bit loads an m16 tile and tap.
//  - A warp owns 64 voxels x 32 channels (BN = 32) or 32 voxels x 64
//    channels (BN = 64, where each A fragment feeds 8 mma): 64 accumulators
//    a lane either way, the f32 form's tiles and block of 8 warps.
//  - x is NCDHW, so the two channels of a pair lie V elements apart in
//    memory. The staging takes two steps. A chunk's 16 channels are copied
//    planar by cp.async into a raw ring of two buffers, a chunk ahead of the
//    mma: each halo row as its TY middle elements in 16-byte copies (8-byte
//    where TY = 4) from the tile's own, aligned y0, plus one 4-byte copy for
//    each edge pair (y0 - 2, y0 - 1) and (y0 + TY, y0 + TY + 1), zero-filled
//    outside the volume by the copy's zero-size form. Where Y is no multiple
//    of the copy (or x is not 16-byte aligned) the same words are filled by
//    plain loads. At the chunk's start every thread pairs raw rows into the
//    tile, a halo row of one pair at a time: 16-byte loads of the two
//    channels' words, __byte_perm, 8-byte stores, all in shared memory and
//    conflict-free (the raw row stride is an odd number of 16-byte words).
//    Pairing the channels at the fragment load instead (two 16-bit loads a
//    register) was timed against it (csrc/bench/conv3d_mc_bf16_fragpair.cu).
//  - The weights are packed once a call (conv3d_mc_pack_bf16_kernel) as
//    bf16 pairs in the B fragments' order, two n8 tiles in one 16-byte word,
//    and a chunk's 27 taps are staged by cp.async with its raw rows.
//  - A stage is a chunk: one wait, three barriers and one pairing for 27
//    taps x 16 channels, where stages of 9 taps waited and synchronised three
//    times as often. The accumulation rule of the f32 form: a stage's
//    products are summed in the tensor core from zero and added to the f32
//    registers once a stage; K splits are reduced in a fixed order, the sum
//    rounded to bf16 once. Same bits on every run.
//
// The FMA kernel (conv3d_mc_kernel) is the first version of this port. It
// stays for C_in <= 4 in both forms (the UNet's 1->32 layer is bound by its
// output bytes and has K = 27; padding it to 8 or 16 channels would waste
// most of the tensor cores' work) and for the channels-last layout, whose
// loads are gathers. Its bf16 form loads bf16 x and weights, sums in f32 and
// rounds each output to bf16 once: half the bytes in and out. The route is
// chosen by the caller from the shape alone.
//
// FMA kernel: a block of 256 threads owns a TZ x TX x TY tile of output
// voxels and CO_T output channels. It walks C_in in steps of 4 channels: each
// step stages the input tile with its one-voxel halo and the 4*27*CO_T
// weights of the step in shared memory. A thread keeps 4 consecutive y
// outputs x 16 output channels in registers; for each (ci, dz, dx) it loads
// the 6 inputs that its 4 outputs' three dy taps touch and, per dy, its 16
// weights as four 128-bit loads that a whole warp shares, then does 192
// FMAs. The weights come transposed to (C_in, 27, C_out). The layouts
// (channels first or last) are element strides.

#include <cstdint>

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

__device__ inline float widen(float v) { return v; }
__device__ inline float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ inline void store_out(float* o, float v) { *o = v; }
__device__ inline void store_out(__nv_bfloat16* o, float v) { *o = __float2bfloat16_rn(v); }

// four consecutive outputs in one store: 16 bytes of f32, 8 of bf16
__device__ inline void store4(float* o, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(o) = make_float4(a, b, c, d);
}
__device__ inline void store4(__nv_bfloat16* o, float a, float b, float c, float d) {
  *reinterpret_cast<uint2*>(o) = make_uint2(pack_bf16(a, b), pack_bf16(c, d));
}

constexpr int kThreads = 256;
constexpr int kCi = 4;   // input channels staged per step
constexpr int kVy = 4;   // consecutive y outputs per thread
constexpr int kCo = 16;  // output channels per thread

// E: float, or __nv_bfloat16 for the bf16 form (x, wt and out bf16, f32 sums)
template <int CO_T, int TZ, int TX, int TY, int SY, int SP, class E>
__global__ void __launch_bounds__(kThreads, 2)
conv3d_mc_kernel(const E* __restrict__ x, const E* __restrict__ wt,
                 E* __restrict__ out, int C_in, int C_out, int Z, int X, int Y,
                 long long x_sb, long long x_sc, long long x_sv, long long o_sb,
                 long long o_sc, long long o_sv, int tiles_z, int tiles_x, int tiles_y,
                 int co_tiles, int vec_out) {
  constexpr int NVG = TZ * TX * TY / kVy;  // voxel groups (threads) per channel group
  static_assert((CO_T / kCo) * NVG == kThreads, "tile does not match the block");
  static_assert(NVG % 32 == 0, "a warp must share its output channels");
  static_assert(TY % kVy == 0 && SY >= TY + 2 && SP >= (TX + 2) * SY, "strides");
  constexpr int HZ = TZ + 2, HX = TX + 2, HY = TY + 2;
  constexpr int XS = HZ * SP;    // floats of the x tile per input channel
  constexpr int WS = 27 * CO_T;  // floats of the weight slab per input channel
  __shared__ float xs[kCi * XS];
  __shared__ __align__(16) float ws[kCi * WS];

  // block -> (sample, spatial tile, channel tile); channel tiles of one
  // spatial tile are neighbours, so they find the input in L2
  int bid = blockIdx.x;
  const int cot = bid % co_tiles;
  bid /= co_tiles;
  const int y0 = (bid % tiles_y) * TY;
  bid /= tiles_y;
  const int x0 = (bid % tiles_x) * TX;
  bid /= tiles_x;
  const int z0 = (bid % tiles_z) * TZ;
  const int b = bid / tiles_z;
  const int co0 = cot * CO_T;

  const int tid = threadIdx.x;
  const int g = tid % NVG;
  const int cg = tid / NVG;  // this thread's group of 16 output channels
  constexpr int GY = TY / kVy;
  const int ly = (g % GY) * kVy;
  const int row = g / GY;
  const int lx = row % TX;
  const int lz = row / TX;

  float acc[kVy][kCo];
#pragma unroll
  for (int v = 0; v < kVy; ++v) {
#pragma unroll
    for (int c = 0; c < kCo; ++c) acc[v][c] = 0.0f;
  }

  const E* xb = x + (long long)b * x_sb;
  for (int c0 = 0; c0 < C_in; c0 += kCi) {
    const int nci = min(kCi, C_in - c0);
    for (int i = tid; i < nci * HZ * HX * HY; i += kThreads) {
      const int hy = i % HY;
      int t = i / HY;
      const int hx = t % HX;
      t /= HX;
      const int hz = t % HZ;
      const int ci = t / HZ;
      const int gz = z0 - 1 + hz, gx = x0 - 1 + hx, gy = y0 - 1 + hy;
      float v = 0.0f;
      if (gz >= 0 && gz < Z && gx >= 0 && gx < X && gy >= 0 && gy < Y)
        v = widen(xb[(long long)(c0 + ci) * x_sc + (((long long)gz * X + gx) * Y + gy) * x_sv]);
      xs[ci * XS + hz * SP + hx * SY + hy] = v;
    }
    // wt is (C_in, 27, C_out): the step's slab is nci * 27 rows of C_out
    const E* wrow = wt + (long long)c0 * 27 * C_out + co0;
    for (int i = tid; i < nci * WS; i += kThreads) {
      const int co = i % CO_T;
      const int t = i / CO_T;  // ci * 27 + tap
      ws[i] = (co0 + co < C_out) ? widen(wrow[(long long)t * C_out + co]) : 0.0f;
    }
    __syncthreads();

#pragma unroll 1
    for (int ci = 0; ci < nci; ++ci) {
      const float* xp = xs + ci * XS + lz * SP + lx * SY + ly;
      const float* wp = ws + ci * WS + cg * kCo;
#pragma unroll
      for (int dz = 0; dz < 3; ++dz) {
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          float xv[kVy + 2];
#pragma unroll
          for (int j = 0; j < kVy + 2; ++j) xv[j] = xp[dz * SP + dx * SY + j];
#pragma unroll
          for (int dy = 0; dy < 3; ++dy) {
            const float4* w4 =
                reinterpret_cast<const float4*>(wp + ((dz * 3 + dx) * 3 + dy) * CO_T);
            float wv[kCo];
#pragma unroll
            for (int q = 0; q < kCo / 4; ++q) {
              const float4 f = w4[q];
              wv[4 * q + 0] = f.x;
              wv[4 * q + 1] = f.y;
              wv[4 * q + 2] = f.z;
              wv[4 * q + 3] = f.w;
            }
#pragma unroll
            for (int v = 0; v < kVy; ++v) {
#pragma unroll
              for (int c = 0; c < kCo; ++c) acc[v][c] = fmaf(xv[v + dy], wv[c], acc[v][c]);
            }
          }
        }
      }
    }
    __syncthreads();
  }

  const int oz = z0 + lz, ox = x0 + lx, oy = y0 + ly;
  if (oz >= Z || ox >= X || oy >= Y) return;
  const long long v0 = ((long long)oz * X + ox) * Y + oy;
  E* ob = out + (long long)b * o_sb + v0 * o_sv;
#pragma unroll
  for (int c = 0; c < kCo; ++c) {
    const int co = co0 + cg * kCo + c;
    if (co >= C_out) continue;
    E* p = ob + (long long)co * o_sc;
    if (vec_out && oy + kVy <= Y) {
      store4(p, acc[0][c], acc[1][c], acc[2][c], acc[3][c]);
    } else {
#pragma unroll
      for (int v = 0; v < kVy; ++v) {
        if (oy + v < Y) store_out(p + (long long)v * o_sv, acc[v][c]);
      }
    }
  }
}

template <class E>
struct Args {
  const E* x;
  const E* wt;
  E* out;
  int B, C_in, C_out, Z, X, Y;
  long long x_sb, x_sc, x_sv, o_sb, o_sc, o_sv;
  int vec_out;
  cudaStream_t s;
};

template <int CO_T, int TZ, int TX, int TY, int SY, int SP, class E>
int launch(const Args<E>& a) {
  const long long tiles_z = (a.Z + TZ - 1) / TZ, tiles_x = (a.X + TX - 1) / TX,
                  tiles_y = (a.Y + TY - 1) / TY, co_tiles = (a.C_out + CO_T - 1) / CO_T;
  const long long blocks = (long long)a.B * tiles_z * tiles_x * tiles_y * co_tiles;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  conv3d_mc_kernel<CO_T, TZ, TX, TY, SY, SP, E><<<(unsigned)blocks, kThreads, 0, a.s>>>(
      a.x, a.wt, a.out, a.C_in, a.C_out, a.Z, a.X, a.Y, a.x_sb, a.x_sc, a.x_sv, a.o_sb,
      a.o_sc, a.o_sv, (int)tiles_z, (int)tiles_x, (int)tiles_y, (int)co_tiles, a.vec_out);
  return (int)cudaGetLastError();
}


// ---- the tensor-core kernel ---------------------------------------------------

constexpr int kTcThreads = 256;
constexpr int kKc = 8;  // input channels per chunk: the K of one mma

template <int TB_, int TZ_, int TX_, int TY_, int BN_>
struct Tile {
  static constexpr int TB = TB_, TZ = TZ_, TX = TX_, TY = TY_, BN = BN_;
  static constexpr int HZ = TZ + 2, HX = TX + 2, HY = TY + 2;
  static constexpr int HV1 = HZ * HX * HY;  // halo voxels of one sample
  static constexpr int HV = TB * HV1;
  static constexpr int CS = (HV - 8 + 31) / 32 * 32 + 8;  // channel stride, 8 mod 32
  static constexpr int VOX = TB * TZ * TX * TY;
  static constexpr int NTB = BN / 8;   // n8 tiles of the block
  static constexpr int WN = BN / 32;   // warps across the channels
  static constexpr int WM = 8 / WN;    // warps across the voxels
  static constexpr int MT = 4, NT = 4; // mma tiles of a warp: 64 voxels x 32 channels
  static constexpr int XBUF = kKc * CS;       // floats of one halo buffer
  static constexpr int WSTAGE = 9 * BN * 4;   // float4 of one weight stage
  static constexpr size_t SMEM = sizeof(float) * 2 * XBUF + sizeof(float4) * 2 * WSTAGE +
                                 sizeof(int) * HV;
  static_assert(WM * MT * 16 == VOX, "the warps must cover the tile");
  static_assert(CS % 32 == 8 && CS >= HV, "channel stride");
};

__device__ inline void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ inline unsigned tf32_rna(float v) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// Weights (any strides) -> B fragments, split. Entry
// (((cot * nc + c) * 27 + tap) * (BN / 8) + j) * 32 + lane holds, for the lane's
// g = lane / 4 and t = lane % 4, output channel co = cot * BN + 8 j + g and
// input channels ci = 8 c + t and ci + 4 of w[co, ci, tap] (zero past C_in or
// C_out): (hi[ci], hi[ci + 4]) as TF32, the B fragment of the hi*hi mma, then
// (bf16 w[ci] | bf16 lo[ci]) and the same of ci + 4, the B fragment of the
// bf16 mma that takes both cross terms; hi = tf32(w) rounded, lo = w - hi.
__global__ void conv3d_mc_split_kernel(const float* __restrict__ w, float4* __restrict__ frag,
                                       int C_in, int C_out, long long s_co, long long s_ci,
                                       long long s_dz, long long s_dx, long long s_dy, int bn,
                                       int nc, long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int lane = (int)(i & 31);
  long long r = i >> 5;
  const int ntb = bn / 8;
  const int j = (int)(r % ntb);
  r /= ntb;
  const int tap = (int)(r % 27);
  r /= 27;
  const int c = (int)(r % nc);
  const int cot = (int)(r / nc);
  const int g = lane >> 2, t = lane & 3;
  const int co = cot * bn + 8 * j + g;
  const int ci = kKc * c + t;
  const long long off = (long long)co * s_co + (tap / 9) * s_dz + ((tap / 3) % 3) * s_dx +
                        (tap % 3) * s_dy;
  const float v0 = (co < C_out && ci < C_in) ? w[off + ci * s_ci] : 0.0f;
  const float v1 = (co < C_out && ci + 4 < C_in) ? w[off + (ci + 4) * s_ci] : 0.0f;
  const unsigned h0 = tf32_rna(v0), h1 = tf32_rna(v1);
  const float l0 = __fsub_rn(v0, __uint_as_float(h0)), l1 = __fsub_rn(v1, __uint_as_float(h1));
  frag[i] = make_float4(__uint_as_float(h0), __uint_as_float(h1),
                        __uint_as_float(pack_bf16(v0, l0)), __uint_as_float(pack_bf16(v1, l1)));
}

// out[i] = partial[0][i] + partial[1][i] + ... in that order (O: float, or
// __nv_bfloat16 for the bf16 form, rounded once).
template <class O>
__global__ void conv3d_mc_reduce_kernel(const float* __restrict__ partial,
                                        O* __restrict__ out, long long n, int k_splits) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    float s = partial[i];
    for (int k = 1; k < k_splits; ++k) s += partial[(long long)k * n + i];
    store_out(out + i, s);
  }
}

template <class T>
__global__ void __launch_bounds__(kTcThreads, 1)
conv3d_mc_tc_kernel(const float* __restrict__ x, const float4* __restrict__ wfrag,
                    float* __restrict__ dst, int B, int C_in, int C_out, int Z, int X, int Y,
                    int tiles_z, int tiles_x, int tiles_y, int co_tiles, int k_splits, int nc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* xbuf = reinterpret_cast<float*>(smem_raw);
  float4* wbuf = reinterpret_cast<float4*>(xbuf + 2 * T::XBUF);
  int* gtab = reinterpret_cast<int*>(wbuf + 2 * T::WSTAGE);

  // block -> (sample tile, spatial tile, K split, channel tile); the channel
  // tiles and K splits of one spatial tile are neighbours and share its
  // input in L2
  int bid = blockIdx.x;
  const int cot = bid % co_tiles;
  bid /= co_tiles;
  const int ks = bid % k_splits;
  bid /= k_splits;
  const int y0 = (bid % tiles_y) * T::TY;
  bid /= tiles_y;
  const int x0 = (bid % tiles_x) * T::TX;
  bid /= tiles_x;
  const int z0 = (bid % tiles_z) * T::TZ;
  const int b0 = (bid / tiles_z) * T::TB;
  const int c_begin = (int)((long long)ks * nc / k_splits);
  const int c_end = (int)((long long)(ks + 1) * nc / k_splits);
  const int V = Z * X * Y;
  const int tid = threadIdx.x;
  dst += (long long)ks * B * C_out * V;  // K split ks writes slab ks of the scratch

  // the halo's global offsets, once: element p of the tile -> offset in x
  // relative to sample b0, channel 0; -1 outside the volume or the batch
  for (int p = tid; p < T::HV; p += kTcThreads) {
    const int lb = p / T::HV1;
    const int r = p - lb * T::HV1;
    const int hz = r / (T::HX * T::HY);
    const int hx = (r / T::HY) % T::HX;
    const int hy = r % T::HY;
    const int gz = z0 - 1 + hz, gx = x0 - 1 + hx, gy = y0 - 1 + hy;
    const bool ok = b0 + lb < B && gz >= 0 && gz < Z && gx >= 0 && gx < X && gy >= 0 && gy < Y;
    gtab[p] = ok ? lb * C_in * V + (gz * X + gx) * Y + gy : -1;
  }
  __syncthreads();
  const float* xb = x + (long long)b0 * C_in * V;

  // stage s of this block: chunk c_begin + s / 3, taps of dz = s % 3
  auto prefetch = [&](int s) {
    const int c = c_begin + s / 3, dz = s % 3;
    const float4* src = wfrag + ((long long)(cot * nc + c) * 27 + dz * 9) * (T::BN * 4);
    float4* wd = wbuf + (s & 1) * T::WSTAGE;
    for (int i = tid; i < T::WSTAGE; i += kTcThreads) cp_async16(wd + i, src + i);
    if (dz == 0) {
      float* xd = xbuf + ((s / 3) & 1) * T::XBUF;
      for (int p = tid; p < T::HV; p += kTcThreads) {
        const int g = gtab[p];
#pragma unroll
        for (int ch = 0; ch < kKc; ++ch) {
          const int ci = kKc * c + ch;
          const bool ok = g >= 0 && ci < C_in;
          cp_async4(xd + ch * T::CS + p, ok ? xb + (long long)ci * V + g : x, ok);
        }
      }
    }
    cp_async_commit();
  };

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % T::WM, wn = warp / T::WM;

  // tile offsets of the lane's voxels: rows g and g + 8 of each of its m16 tiles
  int voff[T::MT][2];
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int slot = (wm * T::MT + mt) * 16 + g + 8 * h;
      const int ly = slot % T::TY;
      const int lx = (slot / T::TY) % T::TX;
      const int lz = (slot / (T::TY * T::TX)) % T::TZ;
      const int lb = slot / (T::TY * T::TX * T::TZ);
      voff[mt][h] = lb * T::HV1 + (lz * T::HX + lx) * T::HY + ly;
    }
  }

  // acc: the running sum of the hi*hi products, added to in f32 registers;
  // small: the lo*hi + hi*lo terms, 2^-11 of the others, summed in the
  // tensor core (its truncation of a sum that small is far below f32's ulp)
  // acc: the running sum, added to in f32 registers once a stage; part: one
  // stage's 27 mma, summed in the tensor core from zero
  float acc[T::MT][T::NT][4], part[T::MT][T::NT][4];
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt) {
#pragma unroll
    for (int j = 0; j < T::NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.0f;
    }
  }

  const int nst = (c_end - c_begin) * 3;
  prefetch(0);
  for (int s = 0; s < nst; ++s) {
    if (s + 1 < nst) {
      prefetch(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const float* xa = xbuf + ((s / 3) & 1) * T::XBUF + t * T::CS + (s % 3) * (T::HX * T::HY);
    const float4* ws = wbuf + (s & 1) * T::WSTAGE + (wn * T::NT) * 32 + lane;
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt) {
#pragma unroll
      for (int j = 0; j < T::NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mt][j][e] = 0.0f;
      }
    }
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int toff = (tap / 3) * T::HY + (tap % 3);
      float4 bf[T::NT];
#pragma unroll
      for (int j = 0; j < T::NT; ++j) bf[j] = ws[(tap * T::NTB + j) * 32];
#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt) {
        const float av[4] = {xa[voff[mt][0] + toff], xa[voff[mt][1] + toff],
                             xa[4 * T::CS + voff[mt][0] + toff],
                             xa[4 * T::CS + voff[mt][1] + toff]};
        // hi: the 10 leading mantissa bits, by a mask; lo = v - hi, exact. The
        // cross terms' A fragment: K slots 2t, 2t + 1 and 2t + 8, 2t + 9 of the
        // bf16 mma hold (lo | v) of channels t and t + 4, against (w | w_lo)
        unsigned ahi[4], across[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ahi[e] = __float_as_uint(av[e]) & kTf32Mask;
          across[e] = pack_bf16(av[e] - __uint_as_float(ahi[e]), av[e]);
        }
#pragma unroll
        for (int j = 0; j < T::NT; ++j) {
          mma_bf16(part[mt][j], across, __float_as_uint(bf[j].z), __float_as_uint(bf[j].w));
          mma_tf32(part[mt][j], ahi, __float_as_uint(bf[j].x), __float_as_uint(bf[j].y));
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt) {
#pragma unroll
      for (int j = 0; j < T::NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] += part[mt][j][e];
      }
    }
    __syncthreads();
  }

  // C layout: registers 0, 1 are (row g, columns 2t, 2t + 1), registers 2, 3
  // the same columns of row g + 8; rows are voxels, columns output channels
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int slot = (wm * T::MT + mt) * 16 + g + 8 * h;
      const int oy = y0 + slot % T::TY;
      const int ox = x0 + (slot / T::TY) % T::TX;
      const int oz = z0 + (slot / (T::TY * T::TX)) % T::TZ;
      const int ob = b0 + slot / (T::TY * T::TX * T::TZ);
      if (ob >= B || oz >= Z || ox >= X || oy >= Y) continue;
      float* o = dst + (long long)ob * C_out * V + ((long long)oz * X + ox) * Y + oy;
#pragma unroll
      for (int j = 0; j < T::NT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int co = cot * T::BN + (wn * T::NT + j) * 8 + 2 * t + e;
          if (co < C_out) o[(long long)co * V] = acc[mt][j][2 * h + e];
        }
      }
    }
  }
}

struct TcArgs {
  const float* x;
  const float4* wfrag;
  float* out;
  float* partial;
  int B, C_in, C_out, Z, X, Y, k_splits;
  cudaStream_t s;
};

template <class T>
int launch_tc(const TcArgs& a) {
  const long long V = (long long)a.Z * a.X * a.Y;
  const long long tiles_z = (a.Z + T::TZ - 1) / T::TZ, tiles_x = (a.X + T::TX - 1) / T::TX,
                  tiles_y = (a.Y + T::TY - 1) / T::TY, tiles_b = (a.B + T::TB - 1) / T::TB,
                  co_tiles = (a.C_out + T::BN - 1) / T::BN;
  const int nc = (a.C_in + kKc - 1) / kKc;
  const long long blocks = tiles_b * tiles_z * tiles_x * tiles_y * co_tiles * a.k_splits;
  // the halo table holds 32-bit offsets within the samples of one tile
  if (blocks > 2147483647LL || a.k_splits < 1 || a.k_splits > nc ||
      (long long)T::TB * a.C_in * V > 2147483647LL || (a.k_splits > 1 && a.partial == nullptr))
    return (int)cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(conv3d_mc_tc_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)T::SMEM);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  float* dst = a.k_splits > 1 ? a.partial : a.out;
  conv3d_mc_tc_kernel<T><<<(unsigned)blocks, kTcThreads, T::SMEM, a.s>>>(
      a.x, a.wfrag, dst, a.B, a.C_in, a.C_out, a.Z, a.X, a.Y, (int)tiles_z, (int)tiles_x,
      (int)tiles_y, (int)co_tiles, a.k_splits, nc);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.k_splits == 1) return (int)e;
  const long long n = (long long)a.B * a.C_out * V;
  const int rblocks = (int)((n + 255) / 256 < 2048 ? (n + 255) / 256 : 2048);
  conv3d_mc_reduce_kernel<float><<<rblocks, 256, 0, a.s>>>(a.partial, a.out, n, a.k_splits);
  return (int)cudaGetLastError();
}


// ---- the bf16 form of the tensor-core kernel ------------------------------------

constexpr int kKb = 16;  // input channels per bf16 chunk: the K of one bf16 mma

template <int TB_, int TZ_, int TX_, int TY_, int BN_>
struct TileB {
  static constexpr int TB = TB_, TZ = TZ_, TX = TX_, TY = TY_, BN = BN_;
  static constexpr int HZ = TZ + 2, HX = TX + 2, HY = TY + 2;
  static constexpr int HV1 = HZ * HX * HY;  // halo voxels of one sample
  static constexpr int HV = TB * HV1;
  static constexpr int CS = (HV - 8 + 31) / 32 * 32 + 8;  // pair stride in words, 8 mod 32
  static constexpr int VOX = TB * TZ * TX * TY;
  static constexpr int NTB = BN / 8;   // n8 tiles of the block
  // a warp: 64 voxels x 32 channels (BN = 32) or 32 voxels x 64 channels (BN =
  // 64, each A fragment feeding 8 mma), 64 accumulators a lane either way
  static constexpr int NT = BN == 64 ? 8 : 4;
  static constexpr int MT = 16 / NT;
  static constexpr int WN = BN / (8 * NT);  // warps across the channels
  static constexpr int WM = 8 / WN;    // warps across the voxels
  static constexpr int ROWS = TB * HZ * HX;        // halo rows (runs along y) of the tile
  static constexpr int U = TY >= 8 ? 4 : 2;        // words of one middle copy: 16 or 8 bytes
  static constexpr int MID = TY / 2;               // middle words of a row: y0 .. y0 + TY - 1
  static constexpr int NW = MID + 2;               // words of a row with its two edge words
  static constexpr int XT = kKb / 2 * CS;          // words of the paired tile
  static constexpr int WSTAGE = 27 * (BN / 16) * 32;  // uint4 of one chunk's weights
  // row stride of a raw buffer in words: whole middle copies, and an odd number
  // of them where shared memory allows, so that the pairing's vector loads of
  // neighbouring rows fall in different banks
  static constexpr int RW0 = (NW + U - 1) / U * U;
  static constexpr int RW1 = (RW0 / U) % 2 ? RW0 : RW0 + U;
  static constexpr size_t smem(int rw) {
    return sizeof(uint4) * 2 * WSTAGE + sizeof(unsigned) * (2 * kKb * ROWS * rw + XT) +
           sizeof(int) * ROWS;
  }
  static constexpr int RW = smem(RW1) <= 232448 ? RW1 : RW0;
  static constexpr int RAW = kKb * ROWS * RW;      // words of one raw buffer
  static constexpr size_t SMEM = smem(RW);
  static_assert(WM * MT * 16 == VOX, "the warps must cover the tile");
  static_assert(CS % 32 == 8 && CS >= HV, "pair stride");
  static_assert(MID % U == 0 && MID % 2 == 0, "a row's middle is whole copies");
  static_assert(SMEM <= 232448, "shared memory of a block");
};

// cp.async of N bytes (4, 8 or 16), the destination zero-filled where !ok
template <int N>
__device__ inline void cp_async_zfill(void* dst, const void* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int bytes = ok ? N : 0;
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(bytes) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src), "n"(N),
                 "r"(bytes) : "memory");
  }
}

// Word w of a raw row (w = 0 .. NW - 1) holds y0 - 2 + 2w in its low half and
// y0 - 1 + 2w in its high half. It is stored at word raw_pos(w) of the row:
// the middle words 1 .. MID first (whole, aligned copies), then the edges.
template <class T>
__device__ inline int raw_pos(int w) {
  return w == 0 ? T::MID : (w == T::NW - 1 ? T::MID + 1 : w - 1);
}

// bf16 weights (any strides, raw 16-bit words) -> B fragments of the bf16 mma.
// Entry (((cot * nc + c) * 27 + tap) * (BN / 16) + jj) * 32 + lane holds, for
// the lane's g = lane / 4 and t = lane % 4, the B fragments (b0, b1) of n8
// tiles 2 jj and 2 jj + 1: output channel co = cot * BN + 8 j + g, b0 the
// input channels ci = 16 c + 2 t and ci + 1 of w[co, ci, tap] (low half, high
// half), b1 those of ci + 8; zero past C_in or C_out.
__global__ void conv3d_mc_pack_bf16_kernel(const unsigned short* __restrict__ w,
                                           uint4* __restrict__ frag, int C_in, int C_out,
                                           long long s_co, long long s_ci, long long s_dz,
                                           long long s_dx, long long s_dy, int bn, int nc,
                                           long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int lane = (int)(i & 31);
  long long r = i >> 5;
  const int njj = bn / 16;
  const int jj = (int)(r % njj);
  r /= njj;
  const int tap = (int)(r % 27);
  r /= 27;
  const int c = (int)(r % nc);
  const int cot = (int)(r / nc);
  const int g = lane >> 2, t = lane & 3;
  const long long toff = (tap / 9) * s_dz + ((tap / 3) % 3) * s_dx + (tap % 3) * s_dy;
  unsigned q[4];
#pragma unroll
  for (int h = 0; h < 4; ++h) {  // b0, b1 of n8 tile 2 jj, then of 2 jj + 1
    const int co = cot * bn + 8 * (2 * jj + h / 2) + g;
    const int ci = kKb * c + 2 * t + 8 * (h % 2);
    unsigned lo = 0, hi = 0;
    if (co < C_out) {
      const unsigned short* p = w + co * s_co + toff;
      if (ci < C_in) lo = p[ci * s_ci];
      if (ci + 1 < C_in) hi = p[(ci + 1) * s_ci];
    }
    q[h] = lo | hi << 16;
  }
  frag[i] = make_uint4(q[0], q[1], q[2], q[3]);
}

// x: bf16 as raw 16-bit words. aligned: Y is a multiple of the middle copy's
// 2 U elements and x is 16-byte aligned, so the halo rows go by cp.async; else
// by plain loads. With k_splits > 1 the kernel writes f32 partial sums to
// `dst`, else the bf16 output.
template <class T>
__global__ void __launch_bounds__(kTcThreads, 1)
conv3d_mc_tc_bf16_kernel(const unsigned short* __restrict__ x, const uint4* __restrict__ wfrag,
                         void* __restrict__ dst_raw, int B, int C_in, int C_out, int Z, int X,
                         int Y, int tiles_z, int tiles_x, int tiles_y, int co_tiles,
                         int k_splits, int nc, int aligned) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint4* wbuf = reinterpret_cast<uint4*>(smem_raw);
  unsigned* raw = reinterpret_cast<unsigned*>(wbuf + 2 * T::WSTAGE);
  unsigned* tile = raw + 2 * T::RAW;
  int* rtab = reinterpret_cast<int*>(tile + T::XT);

  // block -> (sample tile, spatial tile, K split, channel tile), as the f32 form
  int bid = blockIdx.x;
  const int cot = bid % co_tiles;
  bid /= co_tiles;
  const int ks = bid % k_splits;
  bid /= k_splits;
  const int y0 = (bid % tiles_y) * T::TY;
  bid /= tiles_y;
  const int x0 = (bid % tiles_x) * T::TX;
  bid /= tiles_x;
  const int z0 = (bid % tiles_z) * T::TZ;
  const int b0 = (bid / tiles_z) * T::TB;
  const int c_begin = (int)((long long)ks * nc / k_splits);
  const int c_end = (int)((long long)(ks + 1) * nc / k_splits);
  const int V = Z * X * Y;
  const int tid = threadIdx.x;
  float* const partial = static_cast<float*>(dst_raw) + (long long)ks * B * C_out * V;
  __nv_bfloat16* const out = static_cast<__nv_bfloat16*>(dst_raw);

  // each halo row's offset in x relative to sample b0, channel 0, y = 0; -1
  // outside the volume or the batch
  for (int r = tid; r < T::ROWS; r += kTcThreads) {
    const int lb = r / (T::HZ * T::HX);
    const int gz = z0 - 1 + (r / T::HX) % T::HZ, gx = x0 - 1 + r % T::HX;
    const bool ok = b0 + lb < B && gz >= 0 && gz < Z && gx >= 0 && gx < X;
    rtab[r] = ok ? lb * C_in * V + (gz * X + gx) * Y : -1;
  }
  __syncthreads();
  const unsigned short* xb = x + (long long)b0 * C_in * V;

  // chunk c's 16 channels, planar, into raw buffer c & 1: a thread a halo row
  // of one channel at a time
  auto fill_x = [&](int c) {
    unsigned* rd = raw + (c & 1) * T::RAW;
    const unsigned short* xc = xb + (long long)kKb * c * V;
    const int nch = min(kKb, C_in - kKb * c);  // channels of the chunk that x has
    for (int q = tid; q < kKb * T::ROWS; q += kTcThreads) {
      const int ch = q / T::ROWS, row = q - ch * T::ROWS;
      const int base = rtab[row];
      const bool row_ok = base >= 0 && ch < nch;
      const unsigned short* src = xc + (long long)ch * V + (row_ok ? base : 0);
      unsigned* d = rd + q * T::RW;
      if (aligned) {
#pragma unroll
        for (int k = 0; k < T::MID / T::U; ++k) {
          const int y = y0 + 2 * T::U * k;
          const bool ok = row_ok && y < Y;
          cp_async_zfill<4 * T::U>(d + T::U * k, ok ? src + y : x, ok);
        }
        const bool lo = row_ok && y0 > 0, hi = row_ok && y0 + T::TY < Y;
        cp_async_zfill<4>(d + T::MID, lo ? src + y0 - 2 : x, lo);
        cp_async_zfill<4>(d + T::MID + 1, hi ? src + y0 + T::TY : x, hi);
      } else {
        // the buffer is read by no thread before the barrier that precedes its
        // pairing: plain stores may go in
#pragma unroll
        for (int w = 0; w < T::NW; ++w) {
          const int gy = y0 - 2 + 2 * w;
          unsigned v = 0;
          if (row_ok && gy >= 0 && gy < Y) v = src[gy];
          if (row_ok && gy + 1 >= 0 && gy + 1 < Y) v |= (unsigned)src[gy + 1] << 16;
          d[raw_pos<T>(w)] = v;
        }
      }
    }
  };

  // raw buffer c & 1 -> the paired tile: word (pair p, voxel) = channel 2p of
  // the voxel in the low half, 2p + 1 in the high half. A thread a halo row of
  // one pair: its two channels' raw words by vector loads, the HY paired words
  // out as HY / 2 8-byte stores (raw word w gives voxels 2w - 1 and 2w)
  auto pair_x = [&](int c) {
    const unsigned* rs = raw + (c & 1) * T::RAW;
    for (int q = tid; q < kKb / 2 * T::ROWS; q += kTcThreads) {
      const int p = q / T::ROWS, row = q - p * T::ROWS;
      const unsigned* pa = rs + (2 * p * T::ROWS + row) * T::RW;
      const unsigned* pb = pa + T::ROWS * T::RW;
      unsigned a[T::NW], b[T::NW];  // raw words w = 0 .. NW - 1
#pragma unroll
      for (int k = 0; k < T::MID; k += T::U) {
        if constexpr (T::U == 4) {
          const uint4 va = *reinterpret_cast<const uint4*>(pa + k);
          const uint4 vb = *reinterpret_cast<const uint4*>(pb + k);
          a[k + 1] = va.x, a[k + 2] = va.y, a[k + 3] = va.z, a[k + 4] = va.w;
          b[k + 1] = vb.x, b[k + 2] = vb.y, b[k + 3] = vb.z, b[k + 4] = vb.w;
        } else {
          const uint2 va = *reinterpret_cast<const uint2*>(pa + k);
          const uint2 vb = *reinterpret_cast<const uint2*>(pb + k);
          a[k + 1] = va.x, a[k + 2] = va.y;
          b[k + 1] = vb.x, b[k + 2] = vb.y;
        }
      }
      const uint2 ea = *reinterpret_cast<const uint2*>(pa + T::MID);
      const uint2 eb = *reinterpret_cast<const uint2*>(pb + T::MID);
      a[0] = ea.x, a[T::NW - 1] = ea.y;
      b[0] = eb.x, b[T::NW - 1] = eb.y;
      const int lb = row / (T::HZ * T::HX);
      unsigned* td = tile + p * T::CS + lb * T::HV1 + (row - lb * T::HZ * T::HX) * T::HY;
#pragma unroll
      for (int k = 0; k <= T::MID; ++k) {  // voxels 2k (high halves of word k), 2k + 1
        *reinterpret_cast<uint2*>(td + 2 * k) =
            make_uint2(__byte_perm(a[k], b[k], 0x7632), __byte_perm(a[k + 1], b[k + 1], 0x5410));
      }
    }
  };

  // chunk c's weights (27 taps) into weight buffer c & 1
  auto fill_w = [&](int c) {
    const uint4* src = wfrag + (long long)(cot * nc + c) * T::WSTAGE;
    uint4* wd = wbuf + (c & 1) * T::WSTAGE;
    for (int i = tid; i < T::WSTAGE; i += kTcThreads) cp_async16(wd + i, src + i);
  };

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % T::WM, wn = warp / T::WM;

  // tile offsets of the lane's voxels: rows g and g + 8 of each of its m16 tiles
  int voff[T::MT][2];
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int slot = (wm * T::MT + mt) * 16 + g + 8 * h;
      const int ly = slot % T::TY;
      const int lx = (slot / T::TY) % T::TX;
      const int lz = (slot / (T::TY * T::TX)) % T::TZ;
      const int lb = slot / (T::TY * T::TX * T::TZ);
      voff[mt][h] = lb * T::HV1 + (lz * T::HX + lx) * T::HY + ly;
    }
  }

  // acc: the running sum, added to in f32 registers once a stage; part: one
  // stage's mma (a chunk: 27 taps x 16 channels), summed in the tensor core
  // from zero
  float acc[T::MT][T::NT][4], part[T::MT][T::NT][4];
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt) {
#pragma unroll
    for (int j = 0; j < T::NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.0f;
    }
  }

  // a stage is a chunk: its weights and raw tile are copied a stage ahead (one
  // cp.async group a stage), paired at its start
  fill_w(c_begin);
  fill_x(c_begin);
  cp_async_commit();
  for (int c = c_begin; c < c_end; ++c) {
    if (c + 1 < c_end) {
      fill_w(c + 1);
      fill_x(c + 1);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    pair_x(c);
    __syncthreads();

#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt) {
#pragma unroll
      for (int j = 0; j < T::NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mt][j][e] = 0.0f;
      }
    }
#pragma unroll 1
    for (int dz = 0; dz < 3; ++dz) {
      const unsigned* xa = tile + t * T::CS + dz * (T::HX * T::HY);
      const uint4* ws = wbuf + (c & 1) * T::WSTAGE + dz * 9 * (T::NTB / 2) * 32 +
                        (wn * T::NT / 2) * 32 + lane;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int toff = (tap / 3) * T::HY + (tap % 3);
        uint4 bq[T::NT / 2];
#pragma unroll
        for (int jj = 0; jj < T::NT / 2; ++jj) bq[jj] = ws[(tap * (T::NTB / 2) + jj) * 32];
#pragma unroll
        for (int mt = 0; mt < T::MT; ++mt) {
          // K slots 2t, 2t + 1 (pair t) and 2t + 8, 2t + 9 (pair t + 4) of rows
          // g and g + 8
          const unsigned a[4] = {xa[voff[mt][0] + toff], xa[voff[mt][1] + toff],
                                 xa[4 * T::CS + voff[mt][0] + toff],
                                 xa[4 * T::CS + voff[mt][1] + toff]};
#pragma unroll
          for (int jj = 0; jj < T::NT / 2; ++jj) {
            mma_bf16(part[mt][2 * jj], a, bq[jj].x, bq[jj].y);
            mma_bf16(part[mt][2 * jj + 1], a, bq[jj].z, bq[jj].w);
          }
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt) {
#pragma unroll
      for (int j = 0; j < T::NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] += part[mt][j][e];
      }
    }
    __syncthreads();
  }

  // C layout as the f32 form's: registers 0, 1 are (row g, columns 2t, 2t + 1),
  // registers 2, 3 the same columns of row g + 8
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int slot = (wm * T::MT + mt) * 16 + g + 8 * h;
      const int oy = y0 + slot % T::TY;
      const int ox = x0 + (slot / T::TY) % T::TX;
      const int oz = z0 + (slot / (T::TY * T::TX)) % T::TZ;
      const int ob = b0 + slot / (T::TY * T::TX * T::TZ);
      if (ob >= B || oz >= Z || ox >= X || oy >= Y) continue;
      const long long ooff = (long long)ob * C_out * V + ((long long)oz * X + ox) * Y + oy;
#pragma unroll
      for (int j = 0; j < T::NT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int co = cot * T::BN + (wn * T::NT + j) * 8 + 2 * t + e;
          if (co >= C_out) continue;
          if (k_splits > 1) {
            partial[ooff + (long long)co * V] = acc[mt][j][2 * h + e];
          } else {
            store_out(out + ooff + (long long)co * V, acc[mt][j][2 * h + e]);
          }
        }
      }
    }
  }
}

struct TcBf16Args {
  const unsigned short* x;
  const uint4* wfrag;
  __nv_bfloat16* out;
  float* partial;
  int B, C_in, C_out, Z, X, Y, k_splits;
  cudaStream_t s;
};

template <class T>
int launch_tc_bf16(const TcBf16Args& a) {
  const long long V = (long long)a.Z * a.X * a.Y;
  const long long tiles_z = (a.Z + T::TZ - 1) / T::TZ, tiles_x = (a.X + T::TX - 1) / T::TX,
                  tiles_y = (a.Y + T::TY - 1) / T::TY, tiles_b = (a.B + T::TB - 1) / T::TB,
                  co_tiles = (a.C_out + T::BN - 1) / T::BN;
  const int nc = (a.C_in + kKb - 1) / kKb;
  const long long blocks = tiles_b * tiles_z * tiles_x * tiles_y * co_tiles * a.k_splits;
  // the row table holds 32-bit offsets within the samples of one tile
  if (blocks > 2147483647LL || a.k_splits < 1 || a.k_splits > nc ||
      (long long)T::TB * a.C_in * V > 2147483647LL || (a.k_splits > 1 && a.partial == nullptr))
    return (int)cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(conv3d_mc_tc_bf16_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)T::SMEM);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int aligned = a.Y % (2 * T::U) == 0 && reinterpret_cast<uintptr_t>(a.x) % 16 == 0;
  void* dst = a.k_splits > 1 ? static_cast<void*>(a.partial) : static_cast<void*>(a.out);
  conv3d_mc_tc_bf16_kernel<T><<<(unsigned)blocks, kTcThreads, T::SMEM, a.s>>>(
      a.x, a.wfrag, dst, a.B, a.C_in, a.C_out, a.Z, a.X, a.Y, (int)tiles_z, (int)tiles_x,
      (int)tiles_y, (int)co_tiles, a.k_splits, nc, aligned);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.k_splits == 1) return (int)e;
  const long long n = (long long)a.B * a.C_out * V;
  const int rblocks = (int)((n + 255) / 256 < 2048 ? (n + 255) / 256 : 2048);
  conv3d_mc_reduce_kernel<__nv_bfloat16><<<rblocks, 256, 0, a.s>>>(a.partial, a.out, n,
                                                                    a.k_splits);
  return (int)cudaGetLastError();
}

// the bf16 form's tiles, by the id the C entries take
using BfTile0 = TileB<1, 4, 8, 16, 32>;
using BfTile1 = TileB<1, 8, 8, 8, 32>;
using BfTile2 = TileB<1, 4, 8, 8, 64>;
using BfTile3 = TileB<4, 4, 4, 4, 64>;

int launch_pack_bf16(const unsigned short* w, uint4* frag, int C_in, int C_out, long long s_co,
              long long s_ci, long long s_dz, long long s_dx, long long s_dy, int bn,
              cudaStream_t s) {
  const int nc = (C_in + kKb - 1) / kKb;
  const long long co_tiles = (C_out + bn - 1) / bn;
  const long long total = co_tiles * nc * 27 * (bn / 16) * 32;
  conv3d_mc_pack_bf16_kernel<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      w, frag, C_in, C_out, s_co, s_ci, s_dz, s_dx, s_dy, bn, nc, total);
  return (int)cudaGetLastError();
}

template <class E>
int conv3d_mc_fma(const Args<E>& a) {
  if (a.B <= 0 || a.C_in <= 0 || a.C_out <= 0 || a.Z <= 0 || a.X <= 0 || a.Y <= 0)
    return (int)cudaErrorInvalidValue;
  // template arguments: CO_T, TZ, TX, TY, then the x tile's padded strides
  if (a.C_out <= 32) {
    if (a.Y <= 4) return launch<32, 8, 16, 4, 6, 109, E>(a);
    if (a.Y <= 8) return launch<32, 8, 8, 8, 10, 101, E>(a);
    return launch<32, 4, 8, 16, 19, 190, E>(a);
  }
  if (a.Y <= 4) return launch<64, 8, 8, 4, 7, 72, E>(a);
  if (a.Y <= 8) return launch<64, 4, 8, 8, 10, 101, E>(a);
  return launch<64, 4, 4, 16, 19, 144, E>(a);
}

}  // namespace

// The FMA route. x: B samples of C_in channels over Z*X*Y voxels, element (b, c, v) at
// b*x_sb + c*x_sc + v*x_sv (v = (z*X + x)*Y + y), so channels first is
// (C*V, V, 1) and channels last (V*C, 1, C); out likewise with the o_
// strides. wt: the weights transposed to (C_in, 27, C_out), contiguous.
// vec_out: the caller's promise that out is channels first with Y % 4 == 0
// and a 16-byte aligned base, so four y outputs go out as one store.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int snt_conv3d_mc(const float* x, const float* wt, float* out, int B, int C_in,
                             int C_out, int Z, int X, int Y, long long x_sb, long long x_sc,
                             long long x_sv, long long o_sb, long long o_sc, long long o_sv,
                             int vec_out, void* stream) {
  return conv3d_mc_fma<float>({x, wt, out, B, C_in, C_out, Z, X, Y, x_sb, x_sc, x_sv, o_sb,
                               o_sc, o_sv, vec_out, static_cast<cudaStream_t>(stream)});
}

// The bf16 form of the FMA route: x, wt and out bf16 (their raw 16-bit words),
// everything else as snt_conv3d_mc; vec_out promises an 8-byte aligned out.
extern "C" int snt_conv3d_mc_bf16(const void* x, const void* wt, void* out, int B, int C_in,
                                  int C_out, int Z, int X, int Y, long long x_sb,
                                  long long x_sc, long long x_sv, long long o_sb,
                                  long long o_sc, long long o_sv, int vec_out, void* stream) {
  return conv3d_mc_fma<__nv_bfloat16>(
      {static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(wt),
       static_cast<__nv_bfloat16*>(out), B, C_in, C_out, Z, X, Y, x_sb, x_sc, x_sv, o_sb, o_sc,
       o_sv, vec_out, static_cast<cudaStream_t>(stream)});
}

// The tensor-core route. w: (C_out, C_in, 3, 3, 3) weights with element
// strides s_co, s_ci, s_dz, s_dx, s_dy (any view: the flipped, swapped weights
// of the input gradient need no copy). frag: scratch for the split weight
// fragments, co_tiles * ceil(C_in / 8) * 27 * BN * 16 floats, where BN is the
// tile's channel width (32 for tiles 0 and 1, 64 for 2 and 3). x and out are
// channels first and contiguous. partial: scratch of k_splits * out's size
// when k_splits > 1, else unused. tile: 0 = 4x8x16 voxels x 32 channels,
// 1 = 8x8x8 x 32, 2 = 4x8x8 x 64, 3 = 4 samples x 4x4x4 x 64. Launches the
// split, the conv and, for k_splits > 1, the reduction on `stream`; returns
// cudaGetLastError().
extern "C" int snt_conv3d_mc_tc(const float* x, const float* w, float* frag, float* out,
                                float* partial, int B, int C_in, int C_out, int Z, int X, int Y,
                                long long s_co, long long s_ci, long long s_dz, long long s_dx,
                                long long s_dy, int tile, int k_splits, void* stream) {
  if (B <= 0 || C_in <= 0 || C_out <= 0 || Z <= 0 || X <= 0 || Y <= 0 || tile < 0 || tile > 3 ||
      (long long)Z * X * Y > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bn = tile < 2 ? 32 : 64;
  const int nc = (C_in + kKc - 1) / kKc;
  const long long co_tiles = (C_out + bn - 1) / bn;
  const long long total = co_tiles * nc * 27 * (bn / 8) * 32;
  conv3d_mc_split_kernel<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      w, reinterpret_cast<float4*>(frag), C_in, C_out, s_co, s_ci, s_dz, s_dx, s_dy, bn, nc,
      total);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const TcArgs a{x, reinterpret_cast<const float4*>(frag), out, partial, B, C_in, C_out,
                 Z, X, Y, k_splits, s};
  switch (tile) {
    case 0:
      return launch_tc<Tile<1, 4, 8, 16, 32>>(a);
    case 1:
      return launch_tc<Tile<1, 8, 8, 8, 32>>(a);
    case 2:
      return launch_tc<Tile<1, 4, 8, 8, 64>>(a);
    default:
      return launch_tc<Tile<4, 4, 4, 4, 64>>(a);
  }
}

// The bf16 form of the tensor-core route: x, w and out are bf16 (their raw
// 16-bit words), w with any strides as in snt_conv3d_mc_tc. frag: scratch for
// the packed weight fragments, co_tiles * ceil(C_in / 16) * 27 * BN * 32
// bytes (16-byte aligned). x and out channels first and contiguous; partial:
// f32 scratch of k_splits * out's size when k_splits > 1, else unused; tile as
// snt_conv3d_mc_tc. The sums are f32 and each output is rounded to bf16 once.
// Launches the packing, the conv and, for k_splits > 1, the reduction on
// `stream`; returns cudaGetLastError().
extern "C" int snt_conv3d_mc_tc_bf16(const void* x, const void* w, void* frag, void* out,
                                     float* partial, int B, int C_in, int C_out, int Z, int X,
                                     int Y, long long s_co, long long s_ci, long long s_dz,
                                     long long s_dx, long long s_dy, int tile, int k_splits,
                                     void* stream) {
  if (B <= 0 || C_in <= 0 || C_out <= 0 || Z <= 0 || X <= 0 || Y <= 0 || tile < 0 || tile > 3 ||
      (long long)Z * X * Y > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int e = launch_pack_bf16(static_cast<const unsigned short*>(w), static_cast<uint4*>(frag),
                                 C_in, C_out, s_co, s_ci, s_dz, s_dx, s_dy, tile < 2 ? 32 : 64,
                                 s);
  if (e != 0) return e;
  const TcBf16Args a{static_cast<const unsigned short*>(x), static_cast<const uint4*>(frag),
                     static_cast<__nv_bfloat16*>(out), partial, B, C_in, C_out, Z, X, Y,
                     k_splits, s};
  switch (tile) {
    case 0:
      return launch_tc_bf16<BfTile0>(a);
    case 1:
      return launch_tc_bf16<BfTile1>(a);
    case 2:
      return launch_tc_bf16<BfTile2>(a);
    default:
      return launch_tc_bf16<BfTile3>(a);
  }
}

// The bf16 weight packing alone (as snt_conv3d_mc_tc_bf16 launches it first),
// for bn = 32 or 64 output channels a tile; returns cudaGetLastError().
extern "C" int snt_conv3d_mc_pack_bf16(const void* w, void* frag, int C_in, int C_out,
                                       long long s_co, long long s_ci, long long s_dz,
                                       long long s_dx, long long s_dy, int bn, void* stream) {
  if (C_in <= 0 || C_out <= 0 || (bn != 32 && bn != 64)) return (int)cudaErrorInvalidValue;
  return launch_pack_bf16(static_cast<const unsigned short*>(w), static_cast<uint4*>(frag), C_in,
                          C_out, s_co, s_ci, s_dz, s_dx, s_dy, bn,
                          static_cast<cudaStream_t>(stream));
}
