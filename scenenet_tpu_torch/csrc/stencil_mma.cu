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
// (f32 in, f32 out) for 59 M useful multiply-adds (hi and lo) per sample,
// which the bf16 tensor cores do faster than the memory delivers the volume.
// In practice mma.sync bounds it: on an H100 it sustained about 0.25
// m16n8k16 a clock an SM whatever the number of warps issuing it, so the
// design spends as few mma on zeros as it can and hides the rest behind
// them.
//
// Packing: one m16n8k16 takes two halo planes and two output planes.
//   M = 16 neighbouring x outputs (A rows).
//   K = 16 = 2 halo planes (p) x 8 neighbouring y inputs (yi).
//   N = 8  = 2 output planes (zo) x 4 neighbouring y outputs (yo).
// For the output pair (z, z+1) and the halo pair (2s, 2s+1) the tap is
// dz = 2j + p - zo with j the pair step, and the B block of one (pair step,
// dx, 8-input chunk c) is B[(p, yi)][(zo, yo)] = k[2j + p - zo, dx, 8c + yi
// - yo] (0 outside the kernel). 4 y outputs of a k_y = 5 kernel read exactly
// 8 inputs, so one chunk holds every tap; a pair of outputs walks its k_z + 1
// planes in ceil((k_z + 1) / 2) steps. For (9,5,5): 5 steps x 5 dx x 2 (hi,
// lo) = 50 mma for 16 x 2 x 4 = 128 outputs, 0.39 mma an output (800
// multiply-adds where 450 are useful: B is 56% nonzero, 20 of 32 entries of
// an (p, zo) quarter, 18 of 20 quarters live; 4 outputs of a 5-tap row need
// 8 inputs, so no N = 8, K = 16 packing does better). The previous design
// (one plane a mma, N = 8 y outputs, K = 16 inputs of which 12 live) issued
// 0.70 mma an output (1440 multiply-adds, 31% nonzero).
//
// Schedule: one block of 16 warps an SM, persistent over the tiles of 16 (or
// 8, at small batch: the wrapper's stencil_mma_plan) z x 16 x x 32 y outputs,
// as two groups of 8 warps that take turns on the tensor cores (named
// barriers): while one group runs its mma, the other converts its next
// tile's input with halo to bf16 in shared memory (zero-filled at the
// volume edge: no padded copy of the volume exists; eight 8-column units a
// thread in flight, their indices stepped, not divided) and writes its last
// tile's outputs (through shared memory, so that each row of 32 y leaves as
// one 128-byte line). Warp w of a group owns y quad w for all TZ z: per (dx,
// chunk) it holds the pair steps' B fragments (hi and lo, built once a block
// in the mma's register layout) in registers, loads each halo pair's A
// fragment once and feeds it to every output pair it serves. TZ / 2 and the
// pair steps are template parameters (1..9 steps for k_z 1..16), so
// accumulators and fragments stay in registers (128 a thread: the 512
// threads take the SM's 64 K). A quad starts at a multiple of 4 columns,
// which ldmatrix (16-byte rows) cannot address, so a lane loads its four A
// registers as 32-bit words; the row pitch is 4 mod 8 words, so the 32
// lanes of each load hit 32 banks. Halo elements staged an output: 24 x 20
// x 36 / 8192 = 2.1 at TZ = 16 (2.8 before). Every output sums the same
// mma in the same order at either TZ: the result is bit-identical from run
// to run and between the two tiles.
//
// What the measurements said (H100, 700 W, inside a CUDA graph, B=64, 64^3,
// (9,5,5); scenenet_tpu_torch/csrc/bench/points_dk_times.py --kernels k5 in
// calls that also timed the previous design's kernel at 0.1827-0.1849 ms):
// the packing in blocks of 8 warps with the previous fill and per-lane
// stores, 0.1770; a one-row-a-warp fill with a division a (row, 32 columns) item, 0.4156 (and
// without the divisions 0.2049); each output row staged in shared memory and
// stored as 128-byte lines, 0.1478; the halo staged in f32 by cp.async
// (zero-fill), converted on the A loads, 0.1713-0.1733; the two groups
// taking turns, 0.1411-0.1434 (running freely, 0.1546); eight fill units in
// flight (two before), 0.1371-0.1391 (twelve: 0.1507, spills). Without the
// fill's loads 0.1240, without the mma 0.0954, without both the fill and
// the stores 0.1259; 16 warps issuing mma with neither (no turns), 0.1464.
// Forcing the shared-memory carveout to its maximum changed nothing (two
// blocks an SM either way, by registers); skipping tanhf where relu zeroes
// it, 0.1428-0.1445; A by ldmatrix.x4 from the tile and a copy of it
// shifted by 4 columns (twice the shared memory), 0.1351 against 0.1371-
// 0.1390 (spills, and a card test failed: not kept). The head costs 0.008
// (0.1261-0.1289 without it). B=1: 0.0095-0.0100 against 0.0165-0.0166.
//
// The head uses tanhf, not the fast intrinsic; build without fast math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTx = 16;            // output x a tile: the M of one mma
constexpr int kGroupWarps = 8;     // warps of a group: one 4-wide y quad each
constexpr int kGroupThreads = 32 * kGroupWarps;
constexpr int kThreads = 2 * kGroupThreads;  // two groups take turns on the tensor cores
constexpr int kTy = 4 * kGroupWarps;         // output y a tile
constexpr int kMaxShared = 232448; // bytes a block can use on sm_90
constexpr int kOutPitch = kTy + 4; // f32 row pitch of the staged output tile
constexpr int kFillUnits = 8;      // 8-column units a thread has in flight while filling
// named barriers: 0 is __syncthreads; 1 + g a group's own; 3 + g group g's turn
constexpr int kBarGroup = 1, kBarTurn = 3;

// pair steps that cover the k_z + 1 halo planes of an output pair
__host__ __device__ inline int n_steps(int kz) { return (kz + 2) / 2; }
// K chunks of 8 inputs that cover the 4 + k_y - 1 inputs of a y quad
__host__ __device__ inline int n_chunks(int ky) { return (ky + 10) / 8; }
// Row pitch of the halo tile in bf16 elements: the last warp's last chunk
// ends at column 4 (kGroupWarps - 1) + 8 chunks; 8 mod 16 elements (4 mod 8
// words), so that the 32 lanes of an A load hit 32 banks
__host__ __device__ inline int tile_pitch(int ky) {
  const int p = (4 * (kGroupWarps - 1) + 8 * n_chunks(ky) + 7) / 8 * 8;
  return p % 16 == 0 ? p + 8 : p;
}
__host__ __device__ inline size_t frag_bytes(int kz, int kx, int ky) {
  return (size_t)kx * n_chunks(ky) * n_steps(kz) * 32 * sizeof(uint4);
}
// A group's own space: its bf16 halo tile, then the same space for its
// staged f32 outputs; 16-byte multiples
__host__ __device__ inline size_t stage_bytes(int kz, int kx, int ky, int tz) {
  const size_t tile = (size_t)(tz + 2 * n_steps(kz) - 2) * (kTx + kx - 1) * tile_pitch(ky) *
                      sizeof(__nv_bfloat16);
  const size_t staged = (size_t)tz * kTx * kOutPitch * sizeof(float);
  return tile > staged ? tile : staged;
}
inline size_t shared_bytes(int kz, int kx, int ky, int tz) {
  return frag_bytes(kz, kx, ky) + 2 * stage_bytes(kz, kx, ky, tz);
}

__device__ inline uint32_t pack2(__nv_bfloat16 a, __nv_bfloat16 b) {
  return (uint32_t)__bfloat16_as_ushort(a) | ((uint32_t)__bfloat16_as_ushort(b) << 16);
}

// hi = bf16(k), lo = bf16((k - hi) * 512) of tap `idx` of one (dz, dx) row
// of the kernel; 0 outside 0 <= idx < ky. The _rn intrinsics keep the
// subtraction and the scaling as written.
__device__ inline void split_tap(const float* wk, int idx, int ky, __nv_bfloat16* hi,
                                 __nv_bfloat16* lo) {
  const float k = (idx >= 0 && idx < ky) ? wk[idx] : 0.0f;
  *hi = __float2bfloat16_rn(k);
  *lo = __float2bfloat16_rn(__fmul_rn(__fsub_rn(k, __bfloat162float(*hi)), 512.0f));
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

__device__ inline void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ inline void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// NJ pair steps (k_z = 2 NJ - 1 or 2 NJ - 2), QP output pairs a warp (TZ = 2 QP)
template <int NJ, int QP>
__global__ void __launch_bounds__(kThreads, 1)
stencil_mma_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   float* __restrict__ out, int B, int Z, int X, int Y, int kz, int kx, int ky,
                   int activation, int split, int has_tau, float tau, int tiles_y,
                   int tiles_x, int tiles_z) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kTz = 2 * QP;
  constexpr int SZ = kTz + 2 * NJ - 2;
  const int SX = kTx + kx - 1;
  const int nc = n_chunks(ky);
  const int pitch = tile_pitch(ky);
  const int nq = kx * nc;  // (dx, chunk) pairs
  const int pz = (kz - 1) / 2, px = (kx - 1) / 2, py = (ky - 1) / 2;
  const int group = threadIdx.x / kGroupThreads;
  const int gtid = threadIdx.x % kGroupThreads;
  uint4* sb = reinterpret_cast<uint4*>(smem_raw);
  __nv_bfloat16* sx = reinterpret_cast<__nv_bfloat16*>(
      smem_raw + frag_bytes(kz, kx, ky) + group * stage_bytes(kz, kx, ky, kTz));
  float* so = reinterpret_cast<float*>(sx);

  // B fragments, built once a block by both groups, entry ((dx * nc + c) *
  // NJ + j) * 32 + lane: the lane's registers of B[(p, yi)][(zo, yo)] = k[2j
  // + p - zo, dx, 8c + yi - yo]. In the m16n8k16 B layout a lane holds rows
  // 2t, 2t+1 (p = 0, yi = 2t, 2t+1: first register) and 2t+8, 2t+9 (p = 1:
  // second) of column n = g = 4 zo + yo, with g = lane / 4, t = lane % 4.
  // Stored as (hi 0, hi 1, lo 0, lo 1); without `split` the lo entries are
  // 0, so that the inner loop has no branch (its lo sums stay 0).
  for (int i = threadIdx.x; i < nq * NJ * 32; i += kThreads) {
    const int ln = i & 31;
    const int j = (i >> 5) % NJ;
    const int q = (i >> 5) / NJ;
    const int dx = q / nc, c = q % nc;
    const int zo = (ln >> 2) >> 2, yo = (ln >> 2) & 3, tt = ln & 3;
    uint32_t r[4];
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int dz = 2 * j + p - zo;
      const bool tap = dz >= 0 && dz < kz;
      const float* wk = w + (size_t)((tap ? dz : 0) * kx + dx) * ky;
      const int first = tap ? 8 * c + 2 * tt - yo : -2;  // -2, -1: taps that are 0
      __nv_bfloat16 h0, h1, l0, l1;
      split_tap(wk, first, ky, &h0, &l0);
      split_tap(wk, first + 1, ky, &h1, &l1);
      r[p] = pack2(h0, h1);
      r[2 + p] = split ? pack2(l0, l1) : 0u;
    }
    sb[i] = make_uint4(r[0], r[1], r[2], r[3]);
  }
  __syncthreads();

  const int warp = gtid >> 5, lane = gtid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ycol = 4 * warp;
  const int pw = pitch / 2;  // the tile in 32-bit words: row pitch pw, plane ps
  const int ps = SX * pw;
  const uint32_t* sw = reinterpret_cast<const uint32_t*>(sx);
  const int halo_y = kTy + ky - 1;
  const int groups = pitch / 8;  // 8-column units a row
  const int units = SZ * SX * groups;
  const int step_cols = kGroupThreads % groups, step_rows = kGroupThreads / groups;

  // This block's tiles are blockIdx.x + i gridDim.x; group g takes i = 2k +
  // g in round k. Both groups run every round (a group without a tile only
  // keeps the barriers), so their turns stay paired: group 0 computes, then
  // group 1, then group 0 again, each filling its tile and writing its
  // outputs while the other one computes.
  const int tiles = B * tiles_z * tiles_x * tiles_y;
  const int mine = (tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
  const int rounds = (mine + 1) / 2;
  const int bar_group = kBarGroup + group;
  if (group == 1) bar_arrive(kBarTurn, kThreads);  // group 0 takes the first turn
  for (int k = 0; k < rounds; ++k) {
    const int slot = 2 * k + group;
    const bool has = slot < mine;
    int rest = (int)blockIdx.x + slot * (int)gridDim.x;
    const int y0 = (rest % tiles_y) * kTy;
    rest /= tiles_y;
    const int x0 = (rest % tiles_x) * kTx;
    rest /= tiles_x;
    const int z0 = (rest % tiles_z) * kTz;
    const int b = rest / tiles_z;
    const bool live = has && y0 + ycol < Y;  // else the warp's y quad is outside the volume

    // bf16 halo tile, plane sz = z0 - pz + sz, row r = x0 - px + r, column
    // c = y0 - py + c: a thread converts eight neighbouring columns of one
    // (z, x) row and stores them as one 16-byte word, kFillUnits such units
    // in flight (the accumulators are not live yet: the registers are
    // free). Its units are gtid, gtid + 256, ...: their row, plane and
    // column group are stepped, not divided. Columns past the halo are 0
    // (they meet only zero rows of B, but must be finite).
    const float* xb = x + (size_t)(has ? b : 0) * Z * X * Y;
    int cu = gtid % groups, sr = gtid / groups, sz = 0;  // column group, row, plane
    while (sr >= SX) {
      sr -= SX;
      ++sz;
    }
    for (int u0 = gtid; has && u0 < units; u0 += kFillUnits * kGroupThreads) {
      float v[kFillUnits][8];
      int at[kFillUnits];
#pragma unroll
      for (int h = 0; h < kFillUnits; ++h) {
        at[h] = -1;
#pragma unroll
        for (int e = 0; e < 8; ++e) v[h][e] = 0.0f;
        if (u0 + h * kGroupThreads < units) {
          const int c0 = cu * 8;
          const int gz = z0 - pz + sz, gx = x0 - px + sr;
          at[h] = (sz * SX + sr) * pitch + c0;
          if (gz >= 0 && gz < Z && gx >= 0 && gx < X) {
            const float* src = xb + ((size_t)gz * X + gx) * Y;
            const int gy0 = y0 - py + c0;
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const int gy = gy0 + e;
              if (c0 + e < halo_y && gy >= 0 && gy < Y) v[h][e] = __ldg(src + gy);
            }
          }
        }
        cu += step_cols;  // the next unit: kGroupThreads further
        sr += step_rows;
        if (cu >= groups) {
          cu -= groups;
          ++sr;
        }
        while (sr >= SX) {
          sr -= SX;
          ++sz;
        }
      }
#pragma unroll
      for (int h = 0; h < kFillUnits; ++h) {
        if (at[h] < 0) continue;
        *reinterpret_cast<uint4*>(sx + at[h]) = make_uint4(
            pack2(__float2bfloat16_rn(v[h][0]), __float2bfloat16_rn(v[h][1])),
            pack2(__float2bfloat16_rn(v[h][2]), __float2bfloat16_rn(v[h][3])),
            pack2(__float2bfloat16_rn(v[h][4]), __float2bfloat16_rn(v[h][5])),
            pack2(__float2bfloat16_rn(v[h][6]), __float2bfloat16_rn(v[h][7])));
      }
    }
    bar_sync(bar_group, kGroupThreads);      // the tile is staged
    bar_sync(kBarTurn + group, kThreads);    // and the tensor cores are this group's

    float acc_hi[QP][4], acc_lo[QP][4];
#pragma unroll
    for (int qp = 0; qp < QP; ++qp) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_hi[qp][e] = acc_lo[qp][e] = 0.0f;
    }
    // A layout: registers 0, 1 are rows g, g + 8 of K columns 2t, 2t+1
    // (halo plane 2s, inputs 2t, 2t+1 of the chunk), registers 2, 3 the same
    // of K columns 2t+8, 2t+9 (plane 2s + 1).
    for (int q = 0; q < (live ? nq : 0); ++q) {
      const int dx = q / nc, c = q % nc;
      uint4 bf[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) bf[j] = sb[(q * NJ + j) * 32 + lane];
      const uint32_t* a_base = sw + (g + dx) * pw + (ycol >> 1) + 4 * c + t;
#pragma unroll
      for (int s = 0; s < QP + NJ - 1; ++s) {  // halo pair (2s, 2s + 1)
        const uint32_t* ap = a_base + 2 * s * ps;
        const uint32_t a[4] = {ap[0], ap[8 * pw], ap[ps], ap[ps + 8 * pw]};
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int qp = s - j;  // the output pair that halo pair s feeds through step j
          if (qp >= 0 && qp < QP) {
            mma_bf16(acc_hi[qp], a, bf[j].x, bf[j].y);
            mma_bf16(acc_lo[qp], a, bf[j].z, bf[j].w);
          }
        }
      }
    }
    // the other group's turn (group 1's last one has no next turn to give)
    if (group == 0 || k + 1 < rounds) bar_arrive(kBarTurn + 1 - group, kThreads);
    bar_sync(bar_group, kGroupThreads);  // every warp is done with the halo tile

    // C layout: registers 0, 1 are (row g, columns 2t, 2t+1), registers 2, 3
    // the same columns of row g + 8; rows are x, column n is (zo, yo) = (n /
    // 4, n % 4): zo = t / 2, yo = 2 (t % 2) + (e % 2). The results go
    // through shared memory (f32 rows of kOutPitch: the float2 writes of a
    // warp fill 32 banks twice) so that each output row of 32 y leaves as
    // one 128-byte line, not as 8-byte pieces of 16 lines.
    if (live) {
#pragma unroll
      for (int qp = 0; qp < QP; ++qp) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            v[e] = acc_hi[qp][2 * h + e];
            if (split) v[e] += acc_lo[qp][2 * h + e] * (1.0f / 512.0f);
            if (activation) v[e] = fmaxf(tanhf(v[e]), 0.0f);
            if (has_tau) v[e] = (v[e] >= tau) ? 1.0f : 0.0f;
          }
          const int zl = 2 * qp + (t >> 1), xl = g + 8 * h;
          *reinterpret_cast<float2*>(so + (zl * kTx + xl) * kOutPitch + ycol + 2 * (t & 1)) =
              make_float2(v[0], v[1]);
        }
      }
    }
    bar_sync(bar_group, kGroupThreads);
    float* ob = out + (size_t)b * Z * X * Y;
    const bool vec = Y % 4 == 0;  // y0 is a multiple of 32: whole 16-byte words
    for (int i = gtid; has && i < kTz * kTx * (kTy / 4); i += kGroupThreads) {
      const int row = i / (kTy / 4), quad = i % (kTy / 4);
      const int oz = z0 + row / kTx, ox = x0 + row % kTx, oy = y0 + 4 * quad;
      if (oz >= Z || ox >= X || oy >= Y) continue;
      const float4 v = *reinterpret_cast<const float4*>(so + row * kOutPitch + 4 * quad);
      float* dst = ob + ((size_t)oz * X + ox) * Y + oy;
      if (vec) {
        *reinterpret_cast<float4*>(dst) = v;
      } else {
        dst[0] = v.x;
        if (oy + 1 < Y) dst[1] = v.y;
        if (oy + 2 < Y) dst[2] = v.z;
        if (oy + 3 < Y) dst[3] = v.w;
      }
    }
    bar_sync(bar_group, kGroupThreads);  // the outputs have left before the next fill
  }
}

template <int NJ, int QP>
int launch(const float* x, const float* w, float* out, int B, int Z, int X, int Y, int kz,
           int kx, int ky, int activation, int split, int has_tau, float tau, int sms,
           cudaStream_t s) {
  const size_t smem = shared_bytes(kz, kx, ky, 2 * QP);
  if (smem > (size_t)kMaxShared) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(stencil_mma_kernel<NJ, QP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int tiles_y = (Y + kTy - 1) / kTy;
  const int tiles_x = (X + kTx - 1) / kTx;
  const int tiles_z = (Z + 2 * QP - 1) / (2 * QP);
  const long long tiles = (long long)B * tiles_z * tiles_x * tiles_y;
  if (tiles >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  // one block an SM (its 512 threads take all the registers), each walking
  // its share of the tiles
  const int blocks = (int)(tiles < sms ? tiles : sms);
  stencil_mma_kernel<NJ, QP><<<blocks, kThreads, smem, s>>>(
      x, w, out, B, Z, X, Y, kz, kx, ky, activation, split, has_tau, tau, tiles_y, tiles_x,
      tiles_z);
  return (int)cudaGetLastError();
}

template <int QP>
int launch_steps(const float* x, const float* w, float* out, int B, int Z, int X, int Y,
                 int kz, int kx, int ky, int activation, int split, int has_tau, float tau,
                 int sms, cudaStream_t s) {
  switch (n_steps(kz)) {
#define SNT_NJ(J)                                                                        \
  case J:                                                                                \
    return launch<J, QP>(x, w, out, B, Z, X, Y, kz, kx, ky, activation, split, has_tau, \
                         tau, sms, s);
    SNT_NJ(1) SNT_NJ(2) SNT_NJ(3) SNT_NJ(4) SNT_NJ(5) SNT_NJ(6) SNT_NJ(7) SNT_NJ(8) SNT_NJ(9)
#undef SNT_NJ
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Bytes of dynamic shared memory a block needs for this kernel size and z
// tile (8 or 16); the kernel cannot run when it exceeds 232448.
extern "C" int snt_stencil_mma_smem(int kz, int kx, int ky, int tz) {
  if (kz <= 0 || kx <= 0 || ky <= 0 || tz <= 0) return 0;
  const size_t bytes = shared_bytes(kz, kx, ky, tz);
  return bytes > (size_t)INT32_MAX ? INT32_MAX : (int)bytes;
}

// x (B, Z, X, Y) f32, kernel (k_z, k_x, k_y) f32, out (B, Z, X, Y) f32, all
// contiguous; 1 <= k_z <= 16; tz, the output z a tile (8 or 16), from the
// wrapper's plan. `split` adds the lo sum; `has_tau` writes (result >= tau)
// as 0/1. Launches on `stream`; returns cudaGetLastError().
extern "C" int snt_stencil_mma(const float* x, const float* w, float* out, int B, int Z,
                               int X, int Y, int kz, int kx, int ky, int activation,
                               int split, int has_tau, float tau, int tz, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Z <= 0 || X <= 0 || Y <= 0 || kz <= 0 || kz > 16 || kx <= 0 || ky <= 0)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  if (tz == 16)
    return launch_steps<8>(x, w, out, B, Z, X, Y, kz, kx, ky, activation, split, has_tau, tau,
                           sms, s);
  if (tz == 8)
    return launch_steps<4>(x, w, out, B, Z, X, Y, kz, kx, ky, activation, split, has_tau, tau,
                           sms, s);
  return (int)cudaErrorInvalidValue;
}
