// GENEO stencil kernel gradient, in f32, for Hopper (sm_90a).
//
// Replaces: scenenet_tpu/ops/pallas_conv.py, stencil_dk (_stencil_dk_kernel,
// VMEM-resident, and _stencil_dk_kernel_hbm, HBM-streamed), and its
// z_prepadded form, which halo_stencil_conv's backward takes: the kernels
// here serve every volume size.
//
// dk[dz,dx,dy] = sum_{b,z,x,y} x[b, z-zlo+dz, x-px+dx, y-py+dy] * g[b,z,x,y]
// with torch's asymmetric SAME pads p = (k-1)//2 low, k//2 high in x and y
// (taps that fall outside the volume read 0), so even kernels such as
// (9,6,6) are right. g has Z planes, x has Zin: the SAME form is (Zin = Z,
// zlo = pz = (k_z-1)//2), the halo form (Zin = Z + k_z - 1, zlo = 0), where
// x's slab carries its neighbours' planes and is VALID in z. This is the
// gradient of K2's conv (stencil_conv.cu, the same Zin and zlo) with
// respect to its kernel, given the cotangent g of the conv's output.
//
// Bound on the H100: the SMs' f32 FMAs, as in the forward. At batch 16 and
// 64^3 with a (9,5,5) kernel, each of the 225 taps reduces 4.2 M products:
// 0.94 G FMAs (0.0282 ms at 67 TFLOP/s) against 34 MB of input, so device
// memory is far from the limit; the work is feeding the FMA units from
// shared memory. bench/fma_lds_rate.cu measured here that a warp's 32-bit
// shared load costs about as much issue as six FMAs.
//
// Two kernels, chosen by the caller from the kernel size alone
// (ops/cuda_conv.py stencil_route), then one fixed-order reduce.
//
// stencil_dk_fast_kernel<KZ, KX, KY, TZ, TX, NB>: the kernel sizes the main
// paths run, (9,5,5) first (built as TZ = 4, TX = 16, four blocks an SM),
// every tap loop unrolled at compile time. A block of KY warps takes a
// TZ (z) x TX (x) x 32 (y) tile of g; warp w owns the taps of dy = w, lane
// l the y position y0 + l, so every lane works (the generic kernel leaves 7 of
// 32 idle at (9,5,5)) and a thread keeps all KZ x KX accumulators of its dy
// (45 at (9,5,5)). It walks the TX + KX - 1 halo columns of its tile along
// x: at each it loads the next g column (TZ values; g column lx pairs with
// halo column lx + dx) and one x column (TZ + KZ - 1 values), and every
// (dx, lx) pair the two meet in does TZ * KZ FMAs: the g columns of the
// last KX steps stay in registers, a sliding window. Both tiles are held
// z-innermost, each (x, y) column's z values in a row of 16-byte words whose
// pitch keeps the 8 lanes of a quarter warp on 8 bank groups, so a column
// is read with 16-byte shared loads: 3 + 1 of them at a step for 180 FMAs
// at (9,5,5), where one 32-bit load a value would be 16 (bench/
// fma_lds_rate.cu: a 128-bit load costs little more issue than a 32-bit
// one). The staging transposes: a thread takes whole z columns,
// neighbouring lanes neighbouring y, so each z row of the volume is a
// coalesced read, and stores a column 16 bytes at a time; zeros outside the
// volume. A block walks zg tiles along z (ops/cuda_conv.py stencil_dk_plan:
// as many as leave every SM its four blocks) into the same accumulators. At
// the end each thread stores its accumulators over the tiles, and one thread
// a tap sums its warp's 32 lanes in order: one partial a tap a block.
//
// stencil_dk_kernel<KZ>: the first kernel of this port, for every other kernel size
// (k_z 1..16, runtime k_x and k_y). A block of 8 warps takes an 8 x 8 x 32
// tile of g, stages it and the x halo with per-element index arithmetic;
// the lanes of a warp own (dx, dy) tap columns with k_z accumulators, the
// warps split the tile's 256 (x, y) positions, and the warps' sums are
// added in a fixed order.
//
// Both write partial[tap, block]; reduce_taps_kernel sums each tap's row in
// a fixed order (strided per-thread sums, then a shared-memory tree). Float
// atomics into dk would finish in a different order on every run, so dk,
// and the trained parameters after it, would differ from run to run; with
// the two passes dk is bit-identical across runs on the same input.
//
// What the measurements said (NVIDIA H100 80GB HBM3, 700 W; B=16, 64^3,
// (9,5,5); loops of 20 calls, and device time in a CUDA graph by
// bench/points_dk_times.py; builds of the variants): the first kernel
// 0.151-0.159 ms. The unrolled kernel with y-innermost tiles, staged by
// 16-byte cp.async and read with one 32-bit load a value: 0.077-0.118 over
// tile z 4 or 8, tile x 8 to 24, 2 to 4 blocks an SM and 1 to 4 z tiles a
// block (0.089 loads an FMA at tile 8 x 8); with the staging compiled out it
// still took 0.061-0.074, with the FMAs compiled out 0.032-0.040: the loop's
// loads were the limit, as bench/fma_lds_rate.cu predicts for 32-bit loads.
// z-innermost tiles read 16 bytes at a time: 0.072 in a graph (2.1x the
// first kernel in the same calls), 0.012 at B=1 (0.020). PERF.md section 6,
// row 4, has the numbers beside the bound.

#include <cuda_runtime.h>

namespace {

constexpr int kTy = 32;  // tile y (one warp's width)
constexpr int kTx = 8;   // tile x
constexpr int kTz = 8;   // tile z (a lane's g column)
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kReduceThreads = 256;

template <int KZ>
size_t smem_floats(int kx, int ky) {
  const size_t halo = (size_t)(kTz + KZ - 1) * (kTx + kx - 1) * (kTy + ky);
  const size_t gtile = (size_t)kTz * kTx * kTy;
  const size_t parts = (size_t)kWarps * kx * ky * KZ;
  return halo + gtile + parts;
}

template <int KZ>
__global__ void __launch_bounds__(kThreads)
stencil_dk_kernel(const float* __restrict__ x, const float* __restrict__ g,
                  float* __restrict__ partial, int Z, int X, int Y, int kx,
                  int ky, int tiles_y, int Zin, int zlo) {
  extern __shared__ float smem[];
  constexpr int SZ = kTz + KZ - 1;
  const int SX = kTx + kx - 1;
  const int SY = kTy + ky - 1;  // halo row length
  const int SYP = kTy + ky;     // its stride: one pad column
  const int npairs = kx * ky;
  const int n_taps = KZ * npairs;
  float* sx = smem;
  float* sg = sx + (size_t)SZ * SX * SYP;
  float* sp = sg + kTz * kTx * kTy;

  const int b = blockIdx.z;
  const int y0 = (blockIdx.x % tiles_y) * kTy;
  const int x0 = (blockIdx.x / tiles_y) * kTx;
  const int z0 = blockIdx.y * kTz;
  const int px = (kx - 1) / 2, py = (ky - 1) / 2;
  const int tid = threadIdx.x;
  const size_t vol = (size_t)Z * X * Y;
  const float* xb = x + b * (size_t)Zin * X * Y;
  const float* gb = g + b * vol;

  for (int i = tid; i < SZ * SX * SY; i += kThreads) {
    const int sy = i % SY;
    const int t = i / SY;
    const int sxx = t % SX;
    const int sz = t / SX;
    const int gz = z0 - zlo + sz, gx = x0 - px + sxx, gy = y0 - py + sy;
    float v = 0.0f;
    if (gz >= 0 && gz < Zin && gx >= 0 && gx < X && gy >= 0 && gy < Y)
      v = xb[((size_t)gz * X + gx) * Y + gy];
    sx[(sz * SX + sxx) * SYP + sy] = v;
  }
  for (int i = tid; i < kTz * kTx * kTy; i += kThreads) {
    const int ly = i % kTy;
    const int lx = (i / kTy) % kTx;
    const int lz = i / (kTy * kTx);
    const int gz = z0 + lz, gx = x0 + lx, gy = y0 + ly;
    float v = 0.0f;
    if (gz < Z && gx < X && gy < Y) v = gb[((size_t)gz * X + gx) * Y + gy];
    sg[i] = v;
  }
  __syncthreads();

  const int lane = tid % 32, warp = tid / 32;
  const int plane = SX * SYP;
  for (int p0 = 0; p0 < npairs; p0 += 32) {
    const int p = p0 + lane;
    const bool active = p < npairs;
    const int dx = active ? p / ky : 0;
    const int dy = active ? p % ky : 0;
    float acc[KZ];
#pragma unroll
    for (int dz = 0; dz < KZ; ++dz) acc[dz] = 0.0f;
    for (int pos = warp; pos < kTx * kTy; pos += kWarps) {
      const int lx = pos / kTy, ly = pos % kTy;
      float gz[kTz];
#pragma unroll
      for (int t = 0; t < kTz; ++t) gz[t] = sg[(t * kTx + lx) * kTy + ly];
      const float* col = sx + (lx + dx) * SYP + ly + dy;
      float v[SZ];
#pragma unroll
      for (int s = 0; s < SZ; ++s) v[s] = col[s * plane];
#pragma unroll
      for (int dz = 0; dz < KZ; ++dz) {
#pragma unroll
        for (int t = 0; t < kTz; ++t) acc[dz] = fmaf(v[t + dz], gz[t], acc[dz]);
      }
    }
    if (active) {
#pragma unroll
      for (int dz = 0; dz < KZ; ++dz) sp[(warp * npairs + p) * KZ + dz] = acc[dz];
    }
  }
  __syncthreads();

  const int n_blocks = gridDim.x * gridDim.y * gridDim.z;
  const int blk = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  for (int tap = tid; tap < n_taps; tap += kThreads) {
    const int dz = tap / npairs, p = tap % npairs;
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += sp[(w * npairs + p) * KZ + dz];
    partial[(size_t)tap * n_blocks + blk] = s;
  }
}

// dk[tap] = sum over blocks of partial[tap, block], in a fixed order.
__global__ void __launch_bounds__(kReduceThreads)
reduce_taps_kernel(const float* __restrict__ partial, float* __restrict__ dk,
                   int n_blocks) {
  __shared__ float s[kReduceThreads];
  const int tap = blockIdx.x;
  const float* row = partial + (size_t)tap * n_blocks;
  float acc = 0.0f;
  for (int i = threadIdx.x; i < n_blocks; i += kReduceThreads) acc += row[i];
  s[threadIdx.x] = acc;
  __syncthreads();
  for (int w = kReduceThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) s[threadIdx.x] += s[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) dk[tap] = s[0];
}

template <int KZ>
int launch(const float* x, const float* g, float* dk, float* partial, int B,
           int Z, int X, int Y, int kx, int ky, int Zin, int zlo, cudaStream_t s) {
  const size_t smem = sizeof(float) * smem_floats<KZ>(kx, ky);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        stencil_dk_kernel<KZ>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int tiles_y = (Y + kTy - 1) / kTy;
  const int tiles_x = (X + kTx - 1) / kTx;
  dim3 grid(tiles_y * tiles_x, (Z + kTz - 1) / kTz, B);
  stencil_dk_kernel<KZ><<<grid, kThreads, smem, s>>>(x, g, partial, Z, X, Y, kx,
                                                     ky, tiles_y, Zin, zlo);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int n_blocks = (int)(grid.x * grid.y * grid.z);
  reduce_taps_kernel<<<KZ * kx * ky, kReduceThreads, 0, s>>>(partial, dk, n_blocks);
  return (int)cudaGetLastError();
}


// ---- the unrolled, register-blocked kernel -------------------------------------

// The pitch of a z column in shared memory: a whole number of 16-byte words,
// an odd number of them, so that the 8 lanes of a quarter warp that read
// neighbouring columns 16 bytes at a time fall on 8 different bank groups.
constexpr int column_pitch(int n) { return (n + 3) / 4 % 2 ? (n + 3) / 4 * 4 : (n + 3) / 4 * 4 + 4; }

template <int KZ, int KX, int KY, int TZ, int TX, int NB>
struct FastDk {
  static constexpr int kThreads = 32 * KY;  // one warp a dy
  static constexpr int SZ = TZ + KZ - 1, SX = TX + KX - 1, SY = kTy + KY - 1;
  static constexpr int ZPX = column_pitch(SZ), ZPG = column_pitch(TZ);
  static constexpr int NK = KZ * KX;              // accumulators a thread
  static constexpr int HALO = SX * SY * ZPX;      // x halo: (SX, SY) columns of SZ z
  static constexpr int GTILE = TX * kTy * ZPG;    // g tile: (TX, 32) columns of TZ z
  static constexpr int SUMS = KY * NK * 33;       // the accumulators, over the tiles
  static constexpr size_t SMEM = sizeof(float) * (HALO + GTILE > SUMS ? HALO + GTILE : SUMS);
  static_assert(SZ % 4 == 0 && TZ % 4 == 0, "z columns are read 16 bytes at a time");
};

template <int N>
__device__ __forceinline__ void load_column(float (&v)[N], const float* col) {
  const float4* c4 = reinterpret_cast<const float4*>(col);
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const float4 f = c4[q];
    v[4 * q] = f.x;
    v[4 * q + 1] = f.y;
    v[4 * q + 2] = f.z;
    v[4 * q + 3] = f.w;
  }
}

template <int N>
__device__ __forceinline__ void store_column(float* col, const float (&v)[N]) {
  float4* c4 = reinterpret_cast<float4*>(col);
#pragma unroll
  for (int q = 0; q < N / 4; ++q)
    c4[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}

// HALO: x is a z slab that carries its k_z - 1 halo planes (Zin = Z + KZ - 1, no
// low pad); else the SAME form (Zin = Z, low pad pz), at compile time as in the
// forward (stencil_conv.cu).
template <int KZ, int KX, int KY, int TZ, int TX, int NB, bool HALO>
__global__ void __launch_bounds__(32 * KY, NB)
stencil_dk_fast_kernel(const float* __restrict__ x, const float* __restrict__ g,
                       float* __restrict__ partial, int Z, int X, int Y, int tiles_y,
                       int zg) {
  using F = FastDk<KZ, KX, KY, TZ, TX, NB>;
  constexpr int zlo = HALO ? 0 : (KZ - 1) / 2;
  const int Zin = HALO ? Z + KZ - 1 : Z;
  extern __shared__ __align__(16) float fsmem[];
  float* sx = fsmem;            // x halo column (sxx, sy) at (sxx * SY + sy) * ZPX
  float* sg = fsmem + F::HALO;  // g column (lx, ly) at (lx * 32 + ly) * ZPG

  const int b = blockIdx.z;
  const int y0 = (blockIdx.x % tiles_y) * kTy;
  const int x0 = (blockIdx.x / tiles_y) * TX;
  constexpr int px = (KX - 1) / 2, py = (KY - 1) / 2;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long plane = (long long)X * Y;
  const float* xb = x + b * plane * Zin;
  const float* gb = g + b * plane * Z;

  // warp = dy; lane = y0 + lane
  float acc[KZ][KX];
#pragma unroll
  for (int dz = 0; dz < KZ; ++dz) {
#pragma unroll
    for (int dx = 0; dx < KX; ++dx) acc[dz][dx] = 0.0f;
  }
  const float* xcol = sx + (lane + warp) * F::ZPX;  // halo row sy = lane + dy
  const float* gcol = sg + lane * F::ZPG;

  // the block's zg tiles along z, one after the other
  for (int zt = 0; zt < zg; ++zt) {
    const int z0 = (blockIdx.y * zg + zt) * TZ;
    if (z0 >= Z) break;
    if (zt > 0) __syncthreads();  // every warp is done with the previous tiles
    // Staging: a thread takes whole z columns, neighbouring lanes neighbouring
    // y (each z row a coalesced read), and stores a column 16 bytes at a time;
    // zeros outside the volume.
    for (int c = tid; c < F::SX * F::SY; c += F::kThreads) {
      const int sxx = c / F::SY, sy = c - sxx * F::SY;
      const int gx = x0 - px + sxx, gy = y0 - py + sy;
      const bool ok = gx >= 0 && gx < X && gy >= 0 && gy < Y;
      const long long at = ((long long)(z0 - zlo) * X + gx) * Y + gy;
      float v[F::SZ];
#pragma unroll
      for (int u = 0; u < F::SZ; ++u) {
        const int gz = z0 - zlo + u;
        v[u] = ok && gz >= 0 && gz < Zin ? xb[at + u * plane] : 0.0f;
      }
      store_column(sx + c * F::ZPX, v);
    }
    for (int c = tid; c < TX * kTy; c += F::kThreads) {
      const int gx = x0 + c / kTy, gy = y0 + c % kTy;
      const bool ok = gx < X && gy < Y;
      const long long at = ((long long)z0 * X + gx) * Y + gy;
      float v[TZ];
#pragma unroll
      for (int t = 0; t < TZ; ++t) v[t] = ok && z0 + t < Z ? gb[at + t * plane] : 0.0f;
      store_column(sg + c * F::ZPG, v);
    }
    __syncthreads();

    float gw[TX][TZ];  // g column lx, live for the KX steps it meets
#pragma unroll
    for (int s = 0; s < TX + KX - 1; ++s) {
      if (s < TX) load_column(gw[s], gcol + s * kTy * F::ZPG);
      float xc[F::SZ];
      load_column(xc, xcol + s * F::SY * F::ZPX);
#pragma unroll
      for (int dx = 0; dx < KX; ++dx) {
        const int lx = s - dx;  // the g column halo column s meets through tap dx
        if (lx < 0 || lx >= TX) continue;
#pragma unroll
        for (int dz = 0; dz < KZ; ++dz) {
#pragma unroll
          for (int t = 0; t < TZ; ++t)
            acc[dz][dx] = fmaf(xc[t + dz], gw[lx][t], acc[dz][dx]);
        }
      }
    }
  }

  // each warp's 32 lanes summed in order, one thread a tap
  __syncthreads();  // the tiles are read: the sums go over them
  float* sums = fsmem;  // [dy][dz * KX + dx][lane], rows of 33
#pragma unroll
  for (int dz = 0; dz < KZ; ++dz) {
#pragma unroll
    for (int dx = 0; dx < KX; ++dx) sums[(warp * F::NK + dz * KX + dx) * 33 + lane] = acc[dz][dx];
  }
  __syncthreads();
  const int n_blocks = gridDim.x * gridDim.y * gridDim.z;
  const int blk = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  for (int r = tid; r < KY * F::NK; r += F::kThreads) {
    const float* row = sums + r * 33;
    float v = 0.0f;
#pragma unroll 8
    for (int l = 0; l < 32; ++l) v += row[l];
    const int dy = r / F::NK, k = r % F::NK;  // k = dz * KX + dx
    partial[(size_t)(k * KY + dy) * n_blocks + blk] = v;
  }
}

template <int KZ, int KX, int KY, int TZ, int TX, int NB>
dim3 fast_grid(int B, int Z, int X, int Y, int zg) {
  const int tiles_z = (Z + TZ - 1) / TZ;
  return dim3(((Y + kTy - 1) / kTy) * ((X + TX - 1) / TX), (tiles_z + zg - 1) / zg, B);
}

template <int KZ, int KX, int KY, int TZ, int TX, int NB, bool HALO>
int launch_fast(const float* x, const float* g, float* dk, float* partial, int B, int Z,
                int X, int Y, int zg, cudaStream_t s) {
  using F = FastDk<KZ, KX, KY, TZ, TX, NB>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(stencil_dk_fast_kernel<KZ, KX, KY, TZ, TX, NB, HALO>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)F::SMEM);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid = fast_grid<KZ, KX, KY, TZ, TX, NB>(B, Z, X, Y, zg);
  stencil_dk_fast_kernel<KZ, KX, KY, TZ, TX, NB, HALO><<<grid, F::kThreads, F::SMEM, s>>>(
      x, g, partial, Z, X, Y, (Y + kTy - 1) / kTy, zg);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  reduce_taps_kernel<<<KZ * KX * KY, kReduceThreads, 0, s>>>(
      partial, dk, (int)(grid.x * grid.y * grid.z));
  return (int)cudaGetLastError();
}

// the one size built: KZ, KX, KY, tile z, tile x, blocks an SM (ops/cuda_conv.py
// DK_FAST_TILE, DK_FAST_BLOCKS_PER_SM)
#define SNT_DK_FAST 9, 5, 5, 4, 16, 4

}  // namespace

// The number of first-pass blocks, for sizing the caller's scratch: partial
// must hold snt_stencil_dk_blocks(...) * k_z*k_x*k_y floats. `fast` and
// `zg` as for snt_stencil_dk.
extern "C" int snt_stencil_dk_blocks(int B, int Z, int X, int Y, int fast, int zg) {
  if (fast) {
    if (zg < 1) return -1;
    const dim3 grid = fast_grid<SNT_DK_FAST>(B, Z, X, Y, zg);
    return (int)(grid.x * grid.y * grid.z);
  }
  return ((Y + kTy - 1) / kTy) * ((X + kTx - 1) / kTx) * ((Z + kTz - 1) / kTz) * B;
}

// x (B, Zin, X, Y), g (B, Z, X, Y) f32 contiguous; dk (k_z, k_x, k_y) f32;
// partial scratch as above; g plane z meets x planes z - zlo ... z - zlo +
// k_z - 1 (zeros outside 0 ... Zin - 1): (Zin = Z, zlo = (k_z - 1) / 2) is the
// SAME form, (Zin = Z + k_z - 1, zlo = 0) the halo form. 1 <= k_z <= 16.
// `fast` != 0 takes the unrolled kernel, which exists for (9,5,5) and those two
// forms alone (anything else is refused), each of its blocks taking `zg` >= 1
// tiles along z (ops/cuda_conv.py stencil_dk_plan); 0 the generic one, any
// (Zin, zlo) (`zg` unused).
// Launches on `stream`; returns cudaGetLastError().
extern "C" int snt_stencil_dk(const float* x, const float* g, float* dk,
                              float* partial, int B, int Z, int X, int Y, int kz,
                              int kx, int ky, int fast, int zg, int Zin, int zlo,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Z <= 0 || X <= 0 || Y <= 0 || kx <= 0 || ky <= 0 || Zin <= 0 || zlo < 0)
    return (int)cudaErrorInvalidValue;
  if (fast) {
    if (kz == 9 && kx == 5 && ky == 5 && zg >= 1 && Zin == Z && zlo == (kz - 1) / 2)
      return launch_fast<SNT_DK_FAST, false>(x, g, dk, partial, B, Z, X, Y, zg, s);
    if (kz == 9 && kx == 5 && ky == 5 && zg >= 1 && Zin == Z + kz - 1 && zlo == 0)
      return launch_fast<SNT_DK_FAST, true>(x, g, dk, partial, B, Z, X, Y, zg, s);
    return (int)cudaErrorInvalidValue;
  }
  switch (kz) {
#define SNT_KZ(K) \
  case K:         \
    return launch<K>(x, g, dk, partial, B, Z, X, Y, kx, ky, Zin, zlo, s);
    SNT_KZ(1) SNT_KZ(2) SNT_KZ(3) SNT_KZ(4) SNT_KZ(5) SNT_KZ(6) SNT_KZ(7)
    SNT_KZ(8) SNT_KZ(9) SNT_KZ(10) SNT_KZ(11) SNT_KZ(12) SNT_KZ(13)
    SNT_KZ(14) SNT_KZ(15) SNT_KZ(16)
#undef SNT_KZ
    default:
      return (int)cudaErrorInvalidValue;
  }
}
