// GENEO stencil kernel gradient, in f32, for Hopper (sm_90a).
//
// Replaces: scenenet_tpu/ops/pallas_conv.py, stencil_dk (_stencil_dk_kernel,
// VMEM-resident, and _stencil_dk_kernel_hbm, HBM-streamed): one kernel here
// serves every volume size.
//
// dk[dz,dx,dy] = sum_{b,z,x,y} x[b, z-pz+dz, x-px+dx, y-py+dy] * g[b,z,x,y]
// with torch's asymmetric SAME pads p = (k-1)//2 low, k//2 high (taps that
// fall outside the volume read 0), so even kernels such as (9,6,6) are right.
// This is the gradient of the SAME conv of K2 (stencil_conv.cu) with
// respect to its kernel, given the cotangent g of the conv's output.
//
// Bound on the H100: the SMs' f32 FMAs, as in the forward. At batch 16 and
// 64^3 with a (9,5,5) kernel, each of the 225 taps reduces 4.2 M products:
// 0.94 G FMAs against 34 MB of input, so device memory is far from the
// limit; the work is feeding the FMA units from shared memory.
//
// Design, pass 1: a block of 8 warps takes an 8 (z) x 8 (x) x 32 (y) tile
// of g, as K2 tiles its output, and stages it with the matching x tile and
// its halo (zero-filled at the volume edge: no padded copy of x exists) in
// shared memory. The lanes of a warp own the (dx, dy) tap columns, one
// each, and keep k_z accumulators (all dz) in registers; the warps split
// the tile's 256 (x, y) positions. At each position a lane loads the g
// column (8 values, the same address for every lane: a broadcast) and its
// x column (8+k_z-1 values) and does 8*k_z FMAs. The x rows are stored with
// a stride of 32+k_y floats, so dx*stride+dy falls on a different bank for
// every lane of a warp. More than 32 (dx, dy) columns take further rounds.
// The warps' accumulators are summed in a fixed order and each block writes
// its n_taps partial sums to a (n_blocks, n_taps) scratch.
//
// Pass 2 reduces the partials over the blocks, one block per tap, in a fixed
// order (strided per-thread sums, then a shared-memory tree). Float atomics
// into dk would finish in a different order on every run, so dk, and the
// trained parameters after it, would differ from run to run; with the two
// passes dk is bit-identical across runs on the same input. k_z is a
// template parameter (1..16) so the register arrays are fully unrolled.

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
                  int ky, int tiles_y) {
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
  const int pz = (KZ - 1) / 2, px = (kx - 1) / 2, py = (ky - 1) / 2;
  const int tid = threadIdx.x;
  const size_t vol = (size_t)Z * X * Y;
  const float* xb = x + b * vol;
  const float* gb = g + b * vol;

  for (int i = tid; i < SZ * SX * SY; i += kThreads) {
    const int sy = i % SY;
    const int t = i / SY;
    const int sxx = t % SX;
    const int sz = t / SX;
    const int gz = z0 - pz + sz, gx = x0 - px + sxx, gy = y0 - py + sy;
    float v = 0.0f;
    if (gz >= 0 && gz < Z && gx >= 0 && gx < X && gy >= 0 && gy < Y)
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

  const size_t blk =
      ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  for (int tap = tid; tap < n_taps; tap += kThreads) {
    const int dz = tap / npairs, p = tap % npairs;
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += sp[(w * npairs + p) * KZ + dz];
    partial[blk * n_taps + tap] = s;
  }
}

// dk[tap] = sum over blocks of partial[block, tap], in a fixed order.
__global__ void __launch_bounds__(kReduceThreads)
reduce_taps_kernel(const float* __restrict__ partial, float* __restrict__ dk,
                   int n_blocks, int n_taps) {
  __shared__ float s[kReduceThreads];
  const int tap = blockIdx.x;
  float acc = 0.0f;
  for (int i = threadIdx.x; i < n_blocks; i += kReduceThreads)
    acc += partial[(size_t)i * n_taps + tap];
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
           int Z, int X, int Y, int kx, int ky, cudaStream_t s) {
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
                                                     ky, tiles_y);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int n_blocks = (int)(grid.x * grid.y * grid.z);
  reduce_taps_kernel<<<KZ * kx * ky, kReduceThreads, 0, s>>>(partial, dk,
                                                             n_blocks, KZ * kx * ky);
  return (int)cudaGetLastError();
}

}  // namespace

// The number of pass-1 blocks, for sizing the caller's scratch: partial
// must hold snt_stencil_dk_blocks(...) * k_z*k_x*k_y floats.
extern "C" int snt_stencil_dk_blocks(int B, int Z, int X, int Y) {
  return ((Y + kTy - 1) / kTy) * ((X + kTx - 1) / kTx) * ((Z + kTz - 1) / kTz) * B;
}

// x, g (B, Z, X, Y) f32 contiguous; dk (k_z, k_x, k_y) f32; partial scratch
// as above. 1 <= k_z <= 16. Launches on `stream`; returns cudaGetLastError().
extern "C" int snt_stencil_dk(const float* x, const float* g, float* dk,
                              float* partial, int B, int Z, int X, int Y, int kz,
                              int kx, int ky, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Z <= 0 || X <= 0 || Y <= 0 || kx <= 0 || ky <= 0)
    return (int)cudaErrorInvalidValue;
  switch (kz) {
#define SNT_KZ(K) \
  case K:         \
    return launch<K>(x, g, dk, partial, B, Z, X, Y, kx, ky, s);
    SNT_KZ(1) SNT_KZ(2) SNT_KZ(3) SNT_KZ(4) SNT_KZ(5) SNT_KZ(6) SNT_KZ(7)
    SNT_KZ(8) SNT_KZ(9) SNT_KZ(10) SNT_KZ(11) SNT_KZ(12) SNT_KZ(13)
    SNT_KZ(14) SNT_KZ(15) SNT_KZ(16)
#undef SNT_KZ
    default:
      return (int)cudaErrorInvalidValue;
  }
}
