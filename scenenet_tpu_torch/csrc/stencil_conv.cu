// GENEO stencil conv: SAME 3D conv of one channel with one kernel, plus an
// optional relu(tanh(.)) head, in f32, for Hopper (sm_90a).
//
// Replaces: scenenet_tpu/ops/pallas_conv.py, geneo_stencil_conv
// (_stencil_kernel, VMEM-resident, and _stencil_kernel_hbm, HBM-streamed):
// one kernel here serves every volume size.
//
// out[b,z,x,y] = sum_{dz,dx,dy} x[b, z-pz+dz, x-px+dx, y-py+dy] * k[dz,dx,dy]
// with torch's asymmetric SAME pads p = (k-1)//2 low, k//2 high (taps that
// fall outside the volume read 0), so even kernels such as (9,6,6) are right.
//
// Bound on the H100: the SMs' f32 FMAs. A 64^3 volume with a (9,5,5) kernel
// is 262144 voxels x 225 taps = 59 MFMA per sample against 2 MB of input and
// output traffic, so device memory is far from the limit; what matters is
// feeding the FMA units from shared memory and registers.
//
// Design: a block of 8 x 32 threads computes an 8 (z) x 8 (x) x 32 (y)
// output tile; each thread owns one (x, y) and 8 z outputs in registers.
// The block stages the input tile with its halo (zero-filled at the volume
// edge: no padded copy of the volume exists) and the kernel in shared
// memory. For each (dx, dy) tap a thread loads its z column of 8+k_z-1
// inputs and the k_z weights into registers and does 8*k_z FMAs from them:
// about 3 shared loads per 8 FMAs instead of one per FMA. k_z is a template
// parameter (1..16) so those register arrays are fully unrolled. The head
// uses tanhf, not the fast intrinsic; build without fast math.

#include <cuda_runtime.h>

namespace {

constexpr int kTy = 32;  // output y per block (one warp across y)
constexpr int kTx = 8;   // output x per block
constexpr int kTz = 8;   // output z per thread

template <int KZ>
__global__ void __launch_bounds__(kTy * kTx)
stencil_kernel(const float* __restrict__ x, const float* __restrict__ w,
               float* __restrict__ out, int Z, int X, int Y, int kx, int ky,
               int activation, int tiles_y) {
  extern __shared__ float smem[];
  constexpr int SZ = kTz + KZ - 1;
  const int SX = kTx + kx - 1;
  const int SY = kTy + ky - 1;
  const int nk = KZ * kx * ky;
  float* sw = smem;
  float* sx = smem + nk;

  const int b = blockIdx.z;
  const int y0 = (blockIdx.x % tiles_y) * kTy;
  const int x0 = (blockIdx.x / tiles_y) * kTx;
  const int z0 = blockIdx.y * kTz;
  const int pz = (KZ - 1) / 2, px = (kx - 1) / 2, py = (ky - 1) / 2;
  const int tid = threadIdx.y * kTy + threadIdx.x;
  constexpr int kThreads = kTy * kTx;

  for (int i = tid; i < nk; i += kThreads) sw[i] = w[i];
  const float* xb = x + (size_t)b * Z * X * Y;
  const int tile = SZ * SX * SY;
  for (int i = tid; i < tile; i += kThreads) {
    const int sy = i % SY;
    const int t = i / SY;
    const int sxx = t % SX;
    const int sz = t / SX;
    const int gz = z0 - pz + sz, gx = x0 - px + sxx, gy = y0 - py + sy;
    float v = 0.0f;
    if (gz >= 0 && gz < Z && gx >= 0 && gx < X && gy >= 0 && gy < Y)
      v = xb[((size_t)gz * X + gx) * Y + gy];
    sx[i] = v;
  }
  __syncthreads();

  const int lx = threadIdx.y, ly = threadIdx.x;
  const int plane = SX * SY;
  float acc[kTz];
#pragma unroll
  for (int t = 0; t < kTz; ++t) acc[t] = 0.0f;

  for (int dx = 0; dx < kx; ++dx) {
    for (int dy = 0; dy < ky; ++dy) {
      const float* col = sx + (lx + dx) * SY + ly + dy;
      float v[SZ];
#pragma unroll
      for (int s = 0; s < SZ; ++s) v[s] = col[s * plane];
      float wz[KZ];
#pragma unroll
      for (int dz = 0; dz < KZ; ++dz) wz[dz] = sw[(dz * kx + dx) * ky + dy];
#pragma unroll
      for (int dz = 0; dz < KZ; ++dz) {
#pragma unroll
        for (int t = 0; t < kTz; ++t) acc[t] = fmaf(v[t + dz], wz[dz], acc[t]);
      }
    }
  }

  const int ox = x0 + lx, oy = y0 + ly;
  if (ox >= X || oy >= Y) return;
  float* ob = out + (size_t)b * Z * X * Y;
#pragma unroll
  for (int t = 0; t < kTz; ++t) {
    const int oz = z0 + t;
    if (oz < Z) {
      float c = acc[t];
      if (activation) c = fmaxf(tanhf(c), 0.0f);
      ob[((size_t)oz * X + ox) * Y + oy] = c;
    }
  }
}

template <int KZ>
int launch(const float* x, const float* w, float* out, int B, int Z, int X,
           int Y, int kx, int ky, int activation, cudaStream_t s) {
  const size_t smem =
      sizeof(float) * ((size_t)KZ * kx * ky +
                       (size_t)(kTz + KZ - 1) * (kTx + kx - 1) * (kTy + ky - 1));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        stencil_kernel<KZ>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int tiles_y = (Y + kTy - 1) / kTy;
  const int tiles_x = (X + kTx - 1) / kTx;
  dim3 grid(tiles_y * tiles_x, (Z + kTz - 1) / kTz, B);
  stencil_kernel<KZ><<<grid, dim3(kTy, kTx), smem, s>>>(
      x, w, out, Z, X, Y, kx, ky, activation, tiles_y);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, Z, X, Y) f32, kernel (k_z, k_x, k_y) f32, out (B, Z, X, Y) f32, all
// contiguous; 1 <= k_z <= 16. Launches on `stream`; returns cudaGetLastError().
extern "C" int snt_stencil_conv(const float* x, const float* w, float* out,
                                int B, int Z, int X, int Y, int kz, int kx,
                                int ky, int activation, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Z <= 0 || X <= 0 || Y <= 0 || kx <= 0 || ky <= 0)
    return (int)cudaErrorInvalidValue;
  switch (kz) {
#define SNT_KZ(K) \
  case K:         \
    return launch<K>(x, w, out, B, Z, X, Y, kx, ky, activation, s);
    SNT_KZ(1) SNT_KZ(2) SNT_KZ(3) SNT_KZ(4) SNT_KZ(5) SNT_KZ(6) SNT_KZ(7)
    SNT_KZ(8) SNT_KZ(9) SNT_KZ(10) SNT_KZ(11) SNT_KZ(12) SNT_KZ(13)
    SNT_KZ(14) SNT_KZ(15) SNT_KZ(16)
#undef SNT_KZ
    default:
      return (int)cudaErrorInvalidValue;
  }
}
