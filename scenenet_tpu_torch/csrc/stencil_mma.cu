// GENEO stencil conv on the tensor cores: SAME 3D conv of one channel with
// one kernel, x rounded to bf16, the kernel split into bf16 hi + 2^-9 * bf16
// lo, f32 accumulation, an optional relu(tanh(.)) head and an optional fused
// (result >= tau) mask, for Hopper (sm_90a).
//
// Replaces: scenenet_tpu/ops/pallas_conv.py, geneo_stencil_conv_mxu
// (_stencil_mxu_kernel, VMEM-resident, and _geneo_stencil_conv_mxu_hbm /
// _stencil_kernel_hbm_mxu, HBM-streamed): one kernel here serves every
// volume size.
//
// out[b,z,x,y] = sum_{dz,dx,dy} bf16(x)[b, z-pz+dz, x-px+dx, y-py+dy]
//                               * (hi[dz,dx,dy] + lo[dz,dx,dy] / 512)
// with hi = bf16(k), lo = bf16((k - hi) * 512) and torch's asymmetric SAME
// pads p = (k-1)//2 low, k//2 high. The hi and lo sums are kept in separate
// f32 accumulators and combined once, as hi_sum + lo_sum / 512.
//
// Bound on the H100: device memory, in principle. A 64^3 volume moves 2 MB
// (f32 in, f32 out) for 59 M useful multiply-adds per sample, which the bf16
// tensor cores do faster than the memory delivers the volume. What this
// kernel is limited by in practice is the fill of the halo tile (index
// arithmetic and f32 -> bf16 conversion of 2.8 tile elements per output) and
// the rate at which the SM dispatches mma.sync, not either peak.
//
// Design. For 8 neighbouring y outputs the k_y taps of one (dz, dx) plane
// read 8 + k_y - 1 inputs, at most 16 when k_y <= 9. So one 16 x 8 Toeplitz
// block T[j][n] = k[dz, dx, j - n] (0 <= j - n < k_y, else 0) is the B
// operand of an m16n8k16 mma for every y tile, and the A operand is 16 rows
// (16 neighbouring x) of 16 bf16 inputs along y, read with ldmatrix from a
// bf16 halo tile in shared memory. A kernel wider than 9 along y takes more
// K steps of 16 ("chunks"). None of the TPU kernel's 128-deep banded
// matrices is built.
//
// A block of 8 warps computes 8 (z) x 16 (x) x 64 (y) outputs. It converts
// the input tile with its halo to bf16 in shared memory (zero-filled at the
// volume edge: no padded copy of the volume exists) and builds the B
// fragments of every (dz, dx, chunk), hi and lo, once, already in the
// register layout of the mma, so a lane reads its fragment as one 16-byte
// load. Warp w owns y tile w for all 8 z: per (dx, chunk) it holds the k_z
// B fragments in registers, loads each of the 8 + k_z - 1 halo planes' A
// fragment once, and feeds it to every (dz, z) pair that plane serves, two
// mma (hi, lo) each. k_z is a template parameter (1..16) so the accumulators
// and fragments stay in registers. Tile column 0 is y = y0 - py, so every
// ldmatrix row starts at a multiple of 8 bf16 (16 bytes); the row pitch is
// 8 mod 16 elements, which spreads the 8 rows of an ldmatrix over all banks.
// The head uses tanhf, not the fast intrinsic; build without fast math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTz = 8;             // output z per block, all held by each warp
constexpr int kTx = 16;            // output x per block: the M of one mma
constexpr int kWarps = 8;          // one 8-wide y tile per warp
constexpr int kTy = 8 * kWarps;    // output y per block
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxShared = 232448; // bytes a block can use on sm_90
static_assert((kTy - 8) % 16 == 8, "row pitch must be 8 mod 16 elements");

// K steps of 16 inputs that cover the 8 + k_y - 1 inputs of a y tile.
__host__ __device__ inline int n_chunks(int ky) { return (ky + 7 + 15) / 16; }
// Row pitch of the halo tile in bf16 elements: the last warp's last chunk
// ends at column (kTy - 8) + 16 * chunks.
__host__ __device__ inline int tile_pitch(int ky) { return kTy - 8 + 16 * n_chunks(ky); }

inline size_t shared_bytes(int kz, int kx, int ky) {
  const size_t frags = (size_t)kx * n_chunks(ky) * kz * 32 * sizeof(uint4);
  const size_t tile = (size_t)(kTz + kz - 1) * (kTx + kx - 1) * tile_pitch(ky) *
                      sizeof(__nv_bfloat16);
  return frags + tile;
}

__device__ inline uint32_t pack2(__nv_bfloat16 a, __nv_bfloat16 b) {
  return (uint32_t)__bfloat16_as_ushort(a) | ((uint32_t)__bfloat16_as_ushort(b) << 16);
}

// hi = bf16(k), lo = bf16((k - hi) * 512) of tap `idx` of one (dz, dx) row
// of the kernel; 0 outside 0 <= idx < ky. The _rn intrinsics keep the
// subtraction and the scaling as written.
__device__ inline void split_tap(const float* wk, int idx, int ky,
                                 __nv_bfloat16* hi, __nv_bfloat16* lo) {
  const float k = (idx >= 0 && idx < ky) ? wk[idx] : 0.0f;
  *hi = __float2bfloat16_rn(k);
  *lo = __float2bfloat16_rn(__fmul_rn(__fsub_rn(k, __bfloat162float(*hi)), 512.0f));
}

__device__ inline void ldmatrix_x4(uint32_t addr, uint32_t (&a)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ inline void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int KZ>
__global__ void __launch_bounds__(kThreads)
stencil_mma_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   float* __restrict__ out, int Z, int X, int Y, int kx, int ky,
                   int activation, int split, int has_tau, float tau, int tiles_y) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int SZ = kTz + KZ - 1;
  const int SX = kTx + kx - 1;
  const int nc = n_chunks(ky);
  const int pitch = tile_pitch(ky);
  const int nq = kx * nc;  // (dx, chunk) pairs
  uint4* sb = reinterpret_cast<uint4*>(smem_raw);
  __nv_bfloat16* sx =
      reinterpret_cast<__nv_bfloat16*>(smem_raw + (size_t)nq * KZ * 32 * sizeof(uint4));

  const int b = blockIdx.z;
  const int y0 = (blockIdx.x % tiles_y) * kTy;
  const int x0 = (blockIdx.x / tiles_y) * kTx;
  const int z0 = blockIdx.y * kTz;
  const int pz = (KZ - 1) / 2, px = (kx - 1) / 2, py = (ky - 1) / 2;
  const int tid = threadIdx.x;

  // B fragments, entry ((dx * nc + c) * KZ + dz) * 32 + lane: the lane's
  // registers of T_c[j][n] = k[dz, dx, 16 c + j - n]. In the m16n8k16 B
  // layout a lane holds rows j = 2t, 2t+1 (first register) and 2t+8, 2t+9
  // (second) of column n = g, with g = lane / 4, t = lane % 4.
  for (int i = tid; i < nq * KZ * 32; i += kThreads) {
    const int lane = i & 31;
    const int dz = (i >> 5) % KZ;
    const int q = (i >> 5) / KZ;
    const int dx = q / nc, c = q % nc;
    const int g = lane >> 2, t = lane & 3;
    const float* wk = w + (size_t)(dz * kx + dx) * ky;
    const int base = 16 * c + 2 * t - g;
    __nv_bfloat16 h0, h1, h8, h9, l0, l1, l8, l9;
    split_tap(wk, base, ky, &h0, &l0);
    split_tap(wk, base + 1, ky, &h1, &l1);
    split_tap(wk, base + 8, ky, &h8, &l8);
    split_tap(wk, base + 9, ky, &h9, &l9);
    sb[i] = make_uint4(pack2(h0, h1), pack2(h8, h9), pack2(l0, l1), pack2(l8, l9));
  }

  // bf16 halo tile: a thread converts eight neighbouring columns of one
  // (z, x) row and stores them as one 16-byte word, so the row and column
  // arithmetic is paid once per eight elements. Columns past the halo are 0
  // (they meet only zero rows of T, but must be finite).
  const float* xb = x + (size_t)b * Z * X * Y;
  const int halo_y = kTy + ky - 1;
  const int groups = pitch / 8;
  const int units = SZ * SX * groups;
  for (int u = tid; u < units; u += kThreads) {
    const int r = u / groups;
    const int c0 = (u - r * groups) * 8;
    const int sz = r / SX;
    const int gz = z0 - pz + sz, gx = x0 - px + (r - sz * SX);
    const bool inside = gz >= 0 && gz < Z && gx >= 0 && gx < X;
    const float* src = xb + (inside ? ((size_t)gz * X + gx) * Y : 0);
    const int gy0 = y0 - py + c0;
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int gy = gy0 + e;
      v[e] = (inside && c0 + e < halo_y && gy >= 0 && gy < Y) ? src[gy] : 0.0f;
    }
    *reinterpret_cast<uint4*>(sx + r * pitch + c0) = make_uint4(
        pack2(__float2bfloat16_rn(v[0]), __float2bfloat16_rn(v[1])),
        pack2(__float2bfloat16_rn(v[2]), __float2bfloat16_rn(v[3])),
        pack2(__float2bfloat16_rn(v[4]), __float2bfloat16_rn(v[5])),
        pack2(__float2bfloat16_rn(v[6]), __float2bfloat16_rn(v[7])));
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  const int ycol = warp * 8;
  if (y0 + ycol >= Y) return;  // the whole warp: its y tile is outside the volume

  float acc_hi[kTz][4], acc_lo[kTz][4];
#pragma unroll
  for (int zl = 0; zl < kTz; ++zl) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_hi[zl][e] = acc_lo[zl][e] = 0.0f;
  }

  // ldmatrix.x4: lanes 0-7 address the rows of the (x 0-7, y 0-7) quarter
  // of A, 8-15 of (x 8-15, y 0-7), 16-23 of (x 0-7, y 8-15), 24-31 of
  // (x 8-15, y 8-15): the order of the mma's four A registers.
  const int arow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int acol = ycol + (lane >> 4) * 8;
  const uint32_t sx_addr = (uint32_t)__cvta_generic_to_shared(sx);
  const int plane = SX * pitch;

  for (int q = 0; q < nq; ++q) {
    const int dx = q / nc, c = q % nc;
    uint4 bf[KZ];
#pragma unroll
    for (int dz = 0; dz < KZ; ++dz) bf[dz] = sb[(q * KZ + dz) * 32 + lane];
    const uint32_t a_base =
        sx_addr + 2u * (uint32_t)((arow + dx) * pitch + acol + 16 * c);
#pragma unroll
    for (int s = 0; s < SZ; ++s) {
      uint32_t a[4];
      ldmatrix_x4(a_base + 2u * (uint32_t)(s * plane), a);
#pragma unroll
      for (int dz = 0; dz < KZ; ++dz) {
        const int zl = s - dz;  // the output plane that halo plane s feeds through tap dz
        if (zl >= 0 && zl < kTz) {
          mma_bf16(acc_hi[zl], a, bf[dz].x, bf[dz].y);
          if (split) mma_bf16(acc_lo[zl], a, bf[dz].z, bf[dz].w);
        }
      }
    }
  }

  // C layout: registers 0, 1 are (row g, columns 2t, 2t+1), registers 2, 3
  // the same columns of row g + 8; rows are x, columns y.
  const int g = lane >> 2, t = lane & 3;
  float* ob = out + (size_t)b * Z * X * Y;
#pragma unroll
  for (int zl = 0; zl < kTz; ++zl) {
    const int oz = z0 + zl;
    if (oz >= Z) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ox = x0 + g + 8 * (e >> 1);
      const int oy = y0 + ycol + 2 * t + (e & 1);
      if (ox >= X || oy >= Y) continue;
      float v = acc_hi[zl][e];
      if (split) v += acc_lo[zl][e] * (1.0f / 512.0f);
      if (activation) v = fmaxf(tanhf(v), 0.0f);
      if (has_tau) v = (v >= tau) ? 1.0f : 0.0f;
      ob[((size_t)oz * X + ox) * Y + oy] = v;
    }
  }
}

template <int KZ>
int launch(const float* x, const float* w, float* out, int B, int Z, int X, int Y,
           int kx, int ky, int activation, int split, int has_tau, float tau,
           cudaStream_t s) {
  const size_t smem = shared_bytes(KZ, kx, ky);
  if (smem > (size_t)kMaxShared) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        stencil_mma_kernel<KZ>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int tiles_y = (Y + kTy - 1) / kTy;
  const int tiles_x = (X + kTx - 1) / kTx;
  dim3 grid(tiles_y * tiles_x, (Z + kTz - 1) / kTz, B);
  stencil_mma_kernel<KZ><<<grid, kThreads, smem, s>>>(
      x, w, out, Z, X, Y, kx, ky, activation, split, has_tau, tau, tiles_y);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of dynamic shared memory a block needs for this kernel size; the
// kernel cannot run when it exceeds 232448.
extern "C" int snt_stencil_mma_smem(int kz, int kx, int ky) {
  if (kz <= 0 || kx <= 0 || ky <= 0) return 0;
  const size_t bytes = shared_bytes(kz, kx, ky);
  return bytes > (size_t)INT32_MAX ? INT32_MAX : (int)bytes;
}

// x (B, Z, X, Y) f32, kernel (k_z, k_x, k_y) f32, out (B, Z, X, Y) f32, all
// contiguous; 1 <= k_z <= 16. `split` adds the lo sum; `has_tau` writes
// (result >= tau) as 0/1. Launches on `stream`; returns cudaGetLastError().
extern "C" int snt_stencil_mma(const float* x, const float* w, float* out, int B, int Z,
                               int X, int Y, int kz, int kx, int ky, int activation,
                               int split, int has_tau, float tau, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Z <= 0 || X <= 0 || Y <= 0 || kx <= 0 || ky <= 0)
    return (int)cudaErrorInvalidValue;
  switch (kz) {
#define SNT_KZ(K) \
  case K:         \
    return launch<K>(x, w, out, B, Z, X, Y, kx, ky, activation, split, has_tau, tau, s);
    SNT_KZ(1) SNT_KZ(2) SNT_KZ(3) SNT_KZ(4) SNT_KZ(5) SNT_KZ(6) SNT_KZ(7)
    SNT_KZ(8) SNT_KZ(9) SNT_KZ(10) SNT_KZ(11) SNT_KZ(12) SNT_KZ(13)
    SNT_KZ(14) SNT_KZ(15) SNT_KZ(16)
#undef SNT_KZ
    default:
      return (int)cudaErrorInvalidValue;
  }
}
