// Bench copy, not part of the kernel library: the earlier bf16 form of the
// multi-channel conv, kept to time the current form against it in one run
// (chip_smoke.py, csrc/bench/conv_mc_bf16_times.py). It widens bf16 x into
// the f32 form's tile by plain loads and shared stores as it stages it (no
// cp.async), and runs one TF32 m16n8k8 mma a tap and 8 channels; every bf16
// layer takes it, the 1 -> 32 one padded to 8 channels. Its entry points
// carry the prefix snt_widened_; snt_widened_conv3d_mc_tc_bf16 takes the
// arguments of the earlier snt_conv3d_mc_tc_bf16 (frag: the widened
// fragments, co_tiles * ceil(C_in / 8) * 27 * BN * 16 floats).
//
// Multi-channel 3x3x3 SAME conv3d, stride 1, no bias, f32 in, f32 out, for
// Hopper (sm_90a): a tensor-core kernel (a three-product split of every f32
// product, f32 sums) for every layer with more than 4 input channels, and an
// f32 FMA kernel for the rest.
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
// The bf16 form (a template flag of the same kernel, entry snt_conv3d_mc_tc_bf16)
// takes bf16 x and w and writes bf16, for the bf16 UNet. A bf16 value has 8
// significant bits, so it is exact in TF32 and the split's lo terms are zero:
// the form runs the hi*hi mma alone, sums in f32 as the f32 form does and
// rounds each output to bf16 once (after the K-split reduction where there
// is one). The weights are widened by the split kernel; the inputs are
// widened as they are staged, by plain loads and shared stores (cp.async
// copies 4 bytes at least, and the tile keeps its f32 layout), so that
// staging is not overlapped with the tensor cores as the f32 form's is. Every
// layer takes it, the UNet's 1 -> 32 layer included (zero-filled to 8
// channels: the FMA kernel has no bf16 form).
//
// The FMA kernel (conv3d_mc_kernel) is the first version of this port. It
// stays for C_in <= 4 (the UNet's 1->32 layer is bound by its output bytes
// and has K = 27; padding it to 8 channels would waste seven eighths of the
// tensor cores' work) and for the channels-last layout, whose loads are
// gathers. The route is chosen by the caller from the shape alone.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCi = 4;   // input channels staged per step
constexpr int kVy = 4;   // consecutive y outputs per thread
constexpr int kCo = 16;  // output channels per thread

template <int CO_T, int TZ, int TX, int TY, int SY, int SP>
__global__ void __launch_bounds__(kThreads, 2)
conv3d_mc_kernel(const float* __restrict__ x, const float* __restrict__ wt,
                 float* __restrict__ out, int C_in, int C_out, int Z, int X, int Y,
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

  const float* xb = x + (long long)b * x_sb;
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
        v = xb[(long long)(c0 + ci) * x_sc + (((long long)gz * X + gx) * Y + gy) * x_sv];
      xs[ci * XS + hz * SP + hx * SY + hy] = v;
    }
    // wt is (C_in, 27, C_out): the step's slab is nci * 27 rows of C_out
    const float* wrow = wt + (long long)c0 * 27 * C_out + co0;
    for (int i = tid; i < nci * WS; i += kThreads) {
      const int co = i % CO_T;
      const int t = i / CO_T;  // ci * 27 + tap
      ws[i] = (co0 + co < C_out) ? wrow[(long long)t * C_out + co] : 0.0f;
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
  float* ob = out + (long long)b * o_sb + v0 * o_sv;
#pragma unroll
  for (int c = 0; c < kCo; ++c) {
    const int co = co0 + cg * kCo + c;
    if (co >= C_out) continue;
    float* p = ob + (long long)co * o_sc;
    if (vec_out && oy + kVy <= Y) {
      *reinterpret_cast<float4*>(p) = make_float4(acc[0][c], acc[1][c], acc[2][c], acc[3][c]);
    } else {
#pragma unroll
      for (int v = 0; v < kVy; ++v) {
        if (oy + v < Y) p[(long long)v * o_sv] = acc[v][c];
      }
    }
  }
}

struct Args {
  const float* x;
  const float* wt;
  float* out;
  int B, C_in, C_out, Z, X, Y;
  long long x_sb, x_sc, x_sv, o_sb, o_sc, o_sv;
  int vec_out;
  cudaStream_t s;
};

template <int CO_T, int TZ, int TX, int TY, int SY, int SP>
int launch(const Args& a) {
  const long long tiles_z = (a.Z + TZ - 1) / TZ, tiles_x = (a.X + TX - 1) / TX,
                  tiles_y = (a.Y + TY - 1) / TY, co_tiles = (a.C_out + CO_T - 1) / CO_T;
  const long long blocks = (long long)a.B * tiles_z * tiles_x * tiles_y * co_tiles;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  conv3d_mc_kernel<CO_T, TZ, TX, TY, SY, SP><<<(unsigned)blocks, kThreads, 0, a.s>>>(
      a.x, a.wt, a.out, a.C_in, a.C_out, a.Z, a.X, a.Y, a.x_sb, a.x_sc, a.x_sv, a.o_sb,
      a.o_sc, a.o_sv, (int)tiles_z, (int)tiles_x, (int)tiles_y, (int)co_tiles, a.vec_out);
  return (int)cudaGetLastError();
}


// ---- the tensor-core kernel ---------------------------------------------------

constexpr int kTcThreads = 256;
constexpr int kKc = 8;  // input channels per chunk: the K of one mma
constexpr unsigned kTf32Mask = 0xFFFFE000u;  // sign, exponent, 10 mantissa bits

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

__device__ inline void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int bytes = ok ? 4 : 0;  // 0: the four bytes are filled with zeros
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}

__device__ inline void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ inline unsigned tf32_rna(float v) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// c (16 x 8, f32) += a (16 x 8, tf32, row) * b (8 x 8, tf32, col)
__device__ inline void mma_tf32(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                    unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ inline void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ inline float widen(float v) { return v; }
__device__ inline float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// two floats rounded to bf16 in one register: `even` in the low half (the
// even K slot of an mma fragment), `odd` in the high half
__device__ inline unsigned pack_bf16(float even, float odd) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(even, odd);
  return *reinterpret_cast<const unsigned*>(&p);
}

// Weights (any strides) -> B fragments, split. Entry
// (((cot * nc + c) * 27 + tap) * (BN / 8) + j) * 32 + lane holds, for the lane's
// g = lane / 4 and t = lane % 4, output channel co = cot * BN + 8 j + g and
// input channels ci = 8 c + t and ci + 4 of w[co, ci, tap] (zero past C_in or
// C_out): (hi[ci], hi[ci + 4]) as TF32, the B fragment of the hi*hi mma, then
// (bf16 w[ci] | bf16 lo[ci]) and the same of ci + 4, the B fragment of the
// bf16 mma that takes both cross terms; hi = tf32(w) rounded, lo = w - hi.
// W: float, or __nv_bfloat16 for the bf16 form (whose lo is zero).
template <class W>
__global__ void conv3d_mc_split_kernel(const W* __restrict__ w, float4* __restrict__ frag,
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
  const float v0 = (co < C_out && ci < C_in) ? widen(w[off + ci * s_ci]) : 0.0f;
  const float v1 = (co < C_out && ci + 4 < C_in) ? widen(w[off + (ci + 4) * s_ci]) : 0.0f;
  const unsigned h0 = tf32_rna(v0), h1 = tf32_rna(v1);
  const float l0 = __fsub_rn(v0, __uint_as_float(h0)), l1 = __fsub_rn(v1, __uint_as_float(h1));
  frag[i] = make_float4(__uint_as_float(h0), __uint_as_float(h1),
                        __uint_as_float(pack_bf16(v0, l0)), __uint_as_float(pack_bf16(v1, l1)));
}

__device__ inline void store_out(float* o, float v) { *o = v; }
__device__ inline void store_out(__nv_bfloat16* o, float v) { *o = __float2bfloat16_rn(v); }

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

// E: the element type of x and of the output, float or __nv_bfloat16 (the bf16
// form: hi*hi alone, x widened as it is staged). With k_splits > 1 the
// kernel writes f32 partial sums to `dst` whatever E is.
template <class T, class E>
__global__ void __launch_bounds__(kTcThreads, 1)
conv3d_mc_tc_kernel(const E* __restrict__ x, const float4* __restrict__ wfrag,
                    void* __restrict__ dst_raw, int B, int C_in, int C_out, int Z, int X, int Y,
                    int tiles_z, int tiles_x, int tiles_y, int co_tiles, int k_splits, int nc) {
  constexpr bool kHalf = sizeof(E) == 2;
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
  // K split ks writes slab ks of the f32 scratch
  float* const partial = static_cast<float*>(dst_raw) + (long long)ks * B * C_out * V;
  E* const out = static_cast<E*>(dst_raw);

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
  const E* xb = x + (long long)b0 * C_in * V;

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
          if constexpr (kHalf) {
            // the buffer this stage fills is read by no warp before the
            // __syncthreads at the top of its stage: plain stores may go in
            xd[ch * T::CS + p] = ok ? widen(xb[(long long)ci * V + g]) : 0.0f;
          } else {
            cp_async4(xd + ch * T::CS + p, ok ? xb + (long long)ci * V + g : x, ok);
          }
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
          if constexpr (!kHalf) across[e] = pack_bf16(av[e] - __uint_as_float(ahi[e]), av[e]);
        }
#pragma unroll
        for (int j = 0; j < T::NT; ++j) {
          if constexpr (!kHalf) {
            mma_bf16(part[mt][j], across, __float_as_uint(bf[j].z), __float_as_uint(bf[j].w));
          }
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

template <class E>
struct TcArgs {
  const E* x;
  const float4* wfrag;
  E* out;
  float* partial;
  int B, C_in, C_out, Z, X, Y, k_splits;
  cudaStream_t s;
};

template <class T, class E>
int launch_tc(const TcArgs<E>& a) {
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
    cudaError_t e = cudaFuncSetAttribute(conv3d_mc_tc_kernel<T, E>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)T::SMEM);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  void* dst = a.k_splits > 1 ? static_cast<void*>(a.partial) : static_cast<void*>(a.out);
  conv3d_mc_tc_kernel<T, E><<<(unsigned)blocks, kTcThreads, T::SMEM, a.s>>>(
      a.x, a.wfrag, dst, a.B, a.C_in, a.C_out, a.Z, a.X, a.Y, (int)tiles_z, (int)tiles_x,
      (int)tiles_y, (int)co_tiles, a.k_splits, nc);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.k_splits == 1) return (int)e;
  const long long n = (long long)a.B * a.C_out * V;
  const int rblocks = (int)((n + 255) / 256 < 2048 ? (n + 255) / 256 : 2048);
  conv3d_mc_reduce_kernel<E><<<rblocks, 256, 0, a.s>>>(a.partial, a.out, n, a.k_splits);
  return (int)cudaGetLastError();
}

}  // namespace

// The FMA route. x: B samples of C_in channels over Z*X*Y voxels, element (b, c, v) at
// b*x_sb + c*x_sc + v*x_sv (v = (z*X + x)*Y + y), so channels first is
// (C*V, V, 1) and channels last (V*C, 1, C); out likewise with the o_
// strides. wt: the weights transposed to (C_in, 27, C_out), contiguous.
// vec_out: the caller's promise that out is channels first with Y % 4 == 0
// and a 16-byte aligned base, so four y outputs go out as one store.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int snt_widened_conv3d_mc(const float* x, const float* wt, float* out, int B, int C_in,
                             int C_out, int Z, int X, int Y, long long x_sb, long long x_sc,
                             long long x_sv, long long o_sb, long long o_sc, long long o_sv,
                             int vec_out, void* stream) {
  if (B <= 0 || C_in <= 0 || C_out <= 0 || Z <= 0 || X <= 0 || Y <= 0)
    return (int)cudaErrorInvalidValue;
  const Args a{x, wt, out, B, C_in, C_out, Z, X, Y, x_sb, x_sc, x_sv, o_sb, o_sc, o_sv,
               vec_out, static_cast<cudaStream_t>(stream)};
  // template arguments: CO_T, TZ, TX, TY, then the x tile's padded strides
  if (C_out <= 32) {
    if (Y <= 4) return launch<32, 8, 16, 4, 6, 109>(a);
    if (Y <= 8) return launch<32, 8, 8, 8, 10, 101>(a);
    return launch<32, 4, 8, 16, 19, 190>(a);
  }
  if (Y <= 4) return launch<64, 8, 8, 4, 7, 72>(a);
  if (Y <= 8) return launch<64, 4, 8, 8, 10, 101>(a);
  return launch<64, 4, 4, 16, 19, 144>(a);
}

namespace {

template <class E>
int conv3d_mc_tc(const E* x, const E* w, float* frag, E* out, float* partial, int B, int C_in,
                 int C_out, int Z, int X, int Y, long long s_co, long long s_ci, long long s_dz,
                 long long s_dx, long long s_dy, int tile, int k_splits, void* stream) {
  if (B <= 0 || C_in <= 0 || C_out <= 0 || Z <= 0 || X <= 0 || Y <= 0 || tile < 0 || tile > 3 ||
      (long long)Z * X * Y > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bn = tile < 2 ? 32 : 64;
  const int nc = (C_in + kKc - 1) / kKc;
  const long long co_tiles = (C_out + bn - 1) / bn;
  const long long total = co_tiles * nc * 27 * (bn / 8) * 32;
  conv3d_mc_split_kernel<E><<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      w, reinterpret_cast<float4*>(frag), C_in, C_out, s_co, s_ci, s_dz, s_dx, s_dy, bn, nc,
      total);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const TcArgs<E> a{x, reinterpret_cast<const float4*>(frag), out, partial, B, C_in, C_out,
                    Z, X, Y, k_splits, s};
  switch (tile) {
    case 0:
      return launch_tc<Tile<1, 4, 8, 16, 32>, E>(a);
    case 1:
      return launch_tc<Tile<1, 8, 8, 8, 32>, E>(a);
    case 2:
      return launch_tc<Tile<1, 4, 8, 8, 64>, E>(a);
    default:
      return launch_tc<Tile<4, 4, 4, 4, 64>, E>(a);
  }
}

}  // namespace

// The tensor-core route. w: (C_out, C_in, 3, 3, 3) weights with element
// strides s_co, s_ci, s_dz, s_dx, s_dy (any view: the flipped, swapped weights
// of the input gradient need no copy). frag: scratch for the split weight
// fragments, co_tiles * ceil(C_in / 8) * 27 * BN * 16 floats, where BN is the
// tile's channel width (32 for tiles 0 and 1, 64 for 2 and 3). x and out are
// channels first and contiguous. partial: scratch of k_splits * out's size
// (f32) when k_splits > 1, else unused. tile: 0 = 4x8x16 voxels x 32
// channels, 1 = 8x8x8 x 32, 2 = 4x8x8 x 64, 3 = 4 samples x 4x4x4 x 64.
// Launches the split, the conv and, for k_splits > 1, the reduction on
// `stream`; returns cudaGetLastError().
extern "C" int snt_widened_conv3d_mc_tc(const float* x, const float* w, float* frag, float* out,
                                float* partial, int B, int C_in, int C_out, int Z, int X, int Y,
                                long long s_co, long long s_ci, long long s_dz, long long s_dx,
                                long long s_dy, int tile, int k_splits, void* stream) {
  return conv3d_mc_tc<float>(x, w, frag, out, partial, B, C_in, C_out, Z, X, Y, s_co, s_ci,
                             s_dz, s_dx, s_dy, tile, k_splits, stream);
}

// The bf16 form of the tensor-core route: x, w and out are bf16 (their raw
// 16-bit words), everything else as snt_conv3d_mc_tc; the sums are f32 and
// each output is rounded to bf16 once.
extern "C" int snt_widened_conv3d_mc_tc_bf16(const void* x, const void* w, float* frag, void* out,
                                     float* partial, int B, int C_in, int C_out, int Z, int X,
                                     int Y, long long s_co, long long s_ci, long long s_dz,
                                     long long s_dx, long long s_dy, int tile, int k_splits,
                                     void* stream) {
  return conv3d_mc_tc<__nv_bfloat16>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w), frag,
      static_cast<__nv_bfloat16*>(out), partial, B, C_in, C_out, Z, X, Y, s_co, s_ci, s_dz,
      s_dx, s_dy, tile, k_splits, stream);
}
