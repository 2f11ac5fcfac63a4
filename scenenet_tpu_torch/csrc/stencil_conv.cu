// GENEO stencil conv: SAME 3D conv of one channel with one kernel, plus an
// optional relu(tanh(.)) head, in f32, for Hopper (sm_90a).
//
// Replaces: scenenet_tpu/ops/pallas_conv.py, geneo_stencil_conv
// (_stencil_kernel, VMEM-resident, and _stencil_kernel_hbm, HBM-streamed),
// and its z_prepadded form, the forward of halo_stencil_conv.
//
// out[b,z,x,y] = sum_{dz,dx,dy} x[b, z-zlo+dz, x-px+dx, y-py+dy] * k[dz,dx,dy]
// with torch's asymmetric SAME pads p = (k-1)//2 low, k//2 high in x and y
// (taps that fall outside the volume read 0), so even kernels such as
// (9,6,6) are right. In z the caller gives the input's extent Zin and its
// low pad zlo: the SAME conv is (Zin = Z, zlo = pz = (k_z-1)//2); the halo
// conv of a spatially sharded volume, whose z slab already carries its
// neighbours' k_z - 1 planes, is (Zin = Z + k_z - 1, zlo = 0), VALID in z,
// and reads no zero plane there.
//
// Bound on the H100: the SMs' f32 FMAs. A 64^3 volume with a (9,5,5) kernel
// is 262144 voxels x 225 taps = 59 MFMA per sample against 2 MB of input and
// output traffic, so device memory is far from the limit. It stays an f32
// FMA kernel (it is the exact route the tensor-core stencil is held against),
// so what matters is how little else the FMAs share their dispatch slots
// with. Measured on the card (bench/fma_lds_rate.cu): a loop of FFMAs
// alone sustains 55.5 TFLOP/s of the 67 on paper, and every warp-wide 32-bit
// shared load among them costs as much as six FFMAs.
//
// Two kernels, chosen by the caller from the kernel size alone.
//
// stencil_fast_kernel<KZ, KX, KY, RX = 2, TZ = 8, NB = 4>: the kernel sizes
// the main paths run, (9,5,5) first, with every tap loop unrolled at compile
// time. A block of 32 (y) x 8 threads computes an 8 (z) x 16 (x) x 32 (y)
// tile; a thread owns 8 z outputs of 2 neighbouring x at one y, 16
// accumulators. For each dy it takes the KZ*KX weights of that dy into
// registers (twelve 16-byte shared loads that the whole warp shares), then
// walks the 2 + KX - 1 input columns its two x outputs touch: each column's
// 8 + KZ - 1 values are loaded once and feed every (x output, dx) pair that
// reads them, a sliding window in registers. Per dy that is 6 x 16 + 12 =
// 108 shared loads for 2 x 5 x 72 = 720 FMAs: 0.15 loads an FMA, where the
// generic kernel below does 25 for 72 (0.347). Lanes run along y, so a
// column load is 32 neighbouring floats: no bank conflict. 64 registers, no
// spills, 52 KB of shared memory: four blocks an SM. relu(tanh(c)) is taken
// as 0 wherever c <= 0, so tanhf runs only where the result is not 0.
//
// The halo tile (16 x 20 rows) is staged by cp.async, whose zero-size form
// writes the zeros outside the volume. A tile row starts 4 voxels left of
// the tile, on a 16-byte boundary of the volume's row, and holds 40 floats,
// so that where Y is a multiple of 4 a row is ten 16-byte copies: two
// divisions by constants a copy, none an element. Any other Y takes 4-byte
// copies, a row at a time.
//
// What the measurements said (H100, B=64, 64^3; the generic kernel 0.459
// ms). The first form of this kernel, 4 x outputs a thread (0.097 loads an
// FMA, 118 registers, two blocks an SM) with 4-byte staging, took 0.306; with
// its tap loops compiled out the staging alone took 0.111 and with the
// staging compiled out the FMAs 0.139, and the two did not overlap: both
// blocks of an SM stage at once. 16-byte copies: 0.229. Then blocks an SM
// mattered more than loads an FMA: 2 x outputs a thread at three or four
// blocks an SM, whose staging hides behind the other blocks' FMAs, 0.215 and
// 0.211, and from batch 1 up (0.0095 ms against the generic kernel's
// 0.0146, timed inside a CUDA graph). What did not help: one persistent
// block an SM with the next tile's halo in flight (fewer warps cost more
// than the overlap gains), and z innermost in the tile for 16-byte column
// loads (it rules out the 16-byte copies).
//
// stencil_kernel<KZ>: the first version of this port, for every other
// kernel size. A block of 8 x 32 threads computes an 8 (z) x 8 (x) x 32 (y)
// tile; each thread owns one (x, y) and 8 z outputs. For each (dx, dy) tap a
// thread loads its z column of 8+k_z-1 inputs and the k_z weights and does
// 8*k_z FMAs from them; k_x and k_y are runtime values.
//
// The head uses tanhf, not the fast intrinsic; build without fast math.

#include <cuda_runtime.h>

namespace {

constexpr int kTy = 32;  // output y per block (one warp across y)
constexpr int kTx = 8;   // output x per block
constexpr int kTz = 8;   // output z per thread

template <int KZ>
__global__ void __launch_bounds__(kTy * kTx)
stencil_kernel(const float* __restrict__ x, const float* __restrict__ w,
               float* __restrict__ out, int Z, int X, int Y, int kx, int ky,
               int activation, int tiles_y, int Zin, int zlo) {
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
  const int px = (kx - 1) / 2, py = (ky - 1) / 2;
  const int tid = threadIdx.y * kTy + threadIdx.x;
  constexpr int kThreads = kTy * kTx;

  for (int i = tid; i < nk; i += kThreads) sw[i] = w[i];
  const float* xb = x + (size_t)b * Zin * X * Y;
  const int tile = SZ * SX * SY;
  for (int i = tid; i < tile; i += kThreads) {
    const int sy = i % SY;
    const int t = i / SY;
    const int sxx = t % SX;
    const int sz = t / SX;
    const int gz = z0 - zlo + sz, gx = x0 - px + sxx, gy = y0 - py + sy;
    float v = 0.0f;
    if (gz >= 0 && gz < Zin && gx >= 0 && gx < X && gy >= 0 && gy < Y)
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
           int Y, int kx, int ky, int activation, int Zin, int zlo, cudaStream_t s) {
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
      x, w, out, Z, X, Y, kx, ky, activation, tiles_y, Zin, zlo);
  return (int)cudaGetLastError();
}


// ---- the unrolled, register-blocked kernel -------------------------------------

constexpr int kFastTy = 32;   // output y per block: one warp across y
constexpr int kFastThreads = 256;

// RX neighbouring output x and TZ output z per thread, NB blocks an SM
template <int KZ, int KX, int KY, int RX, int TZ, int NB>
struct Fast {
  static constexpr int TX = (kFastThreads / 32) * RX;  // output x per block
  static constexpr int SZ = TZ + KZ - 1, SX = TX + KX - 1, SY = kFastTy + KY - 1;
  // a tile row holds y0 - 4 ... y0 + TY + 4, so that it starts on a 16-byte
  // boundary of the volume's row and can be copied 16 bytes at a time
  static constexpr int YL = 4;                 // columns left of y0
  static constexpr int SYV = kFastTy + 2 * YL;
  static constexpr int WROW = (KZ * KX + 3) / 4 * 4;  // weights of one dy, padded to 16 bytes
  static constexpr size_t SMEM = sizeof(float) * (KY * WROW + SZ * SX * SYV);
  static_assert((KY - 1) / 2 <= YL && KY / 2 <= YL, "the y halo must fit the padded row");
};

__device__ inline void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int bytes = ok ? 4 : 0;  // 0: the four bytes are filled with zeros
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}

__device__ inline void cp_async16(float* dst, const float* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int bytes = ok ? 16 : 0;  // 0: the sixteen bytes are filled with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}

// HALO: the input is a z slab that carries its k_z - 1 halo planes (Zin = Z +
// KZ - 1, no low pad); else the SAME conv (Zin = Z, low pad pz). Both are
// compile-time forms: with the low pad a runtime argument the SAME form took
// 4% longer at B=16 and 64 on the H100 (in a CUDA graph, 0.0590 against 0.0565
// ms at B=16, bench/points_dk_times.py).
template <int KZ, int KX, int KY, int RX, int TZ, int NB, bool HALO>
__global__ void __launch_bounds__(kFastThreads, NB)
stencil_fast_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    float* __restrict__ out, int Z, int X, int Y, int activation,
                    int tiles_y, int vec) {
  using F = Fast<KZ, KX, KY, RX, TZ, NB>;
  constexpr int zlo = HALO ? 0 : (KZ - 1) / 2;
  const int Zin = HALO ? Z + KZ - 1 : Z;
  extern __shared__ __align__(16) float fsmem[];
  float* sw = fsmem;                 // [dy][dz * KX + dx], rows of WROW
  float* sx = fsmem + KY * F::WROW;  // the halo tile, (SZ, SX, SYV)

  const int b = blockIdx.z;
  const int y0 = (blockIdx.x % tiles_y) * kFastTy;
  const int x0 = (blockIdx.x / tiles_y) * F::TX;
  const int z0 = blockIdx.y * TZ;
  constexpr int px = (KX - 1) / 2, py = (KY - 1) / 2;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;

  for (int i = tid; i < KY * F::WROW; i += kFastThreads) {
    const int dy = i / F::WROW, r = i % F::WROW;
    sw[i] = r < KZ * KX ? w[r * KY + dy] : 0.0f;
  }
  const float* xb = x + (size_t)b * Zin * X * Y;
  if (vec) {
    // 16 bytes a copy: a chunk of 4 y lies all inside the volume or all outside
    constexpr int CH = F::SYV / 4;
    for (int i = tid; i < F::SZ * F::SX * CH; i += kFastThreads) {
      const int r = i / CH, c = i - r * CH;
      const int sz = r / F::SX;
      const int gz = z0 - zlo + sz, gx = x0 - px + (r - sz * F::SX), gy = y0 - F::YL + 4 * c;
      const bool ok = gz >= 0 && gz < Zin && gx >= 0 && gx < X && gy >= 0 && gy < Y;
      cp_async16(sx + r * F::SYV + 4 * c, ok ? xb + ((size_t)gz * X + gx) * Y + gy : xb, ok);
    }
  } else {
    // any alignment: a row at a time, 4 bytes a copy; a warp takes every eighth row
    for (int r = warp; r < F::SZ * F::SX; r += kFastThreads / 32) {
      const int sz = r / F::SX;
      const int gz = z0 - zlo + sz, gx = x0 - px + (r - sz * F::SX);
      const bool row_ok = gz >= 0 && gz < Zin && gx >= 0 && gx < X;
      const float* src = xb + (row_ok ? ((size_t)gz * X + gx) * Y : 0);
      for (int c = F::YL - py + lane; c < F::YL - py + F::SY; c += 32) {
        const int gy = y0 - F::YL + c;
        const bool ok = row_ok && gy >= 0 && gy < Y;
        cp_async4(sx + r * F::SYV + c, ok ? src + gy : xb, ok);
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  const int xt = warp;  // this thread's x outputs: xt * RX ...
  constexpr int plane = F::SX * F::SYV;
  float acc[RX][TZ];
#pragma unroll
  for (int xo = 0; xo < RX; ++xo) {
#pragma unroll
    for (int t = 0; t < TZ; ++t) acc[xo][t] = 0.0f;
  }

#pragma unroll 1
  for (int dy = 0; dy < KY; ++dy) {
    float wr[F::WROW];
    const float4* w4 = reinterpret_cast<const float4*>(sw + dy * F::WROW);
#pragma unroll
    for (int q = 0; q < F::WROW / 4; ++q) {
      const float4 f = w4[q];
      wr[4 * q + 0] = f.x;
      wr[4 * q + 1] = f.y;
      wr[4 * q + 2] = f.z;
      wr[4 * q + 3] = f.w;
    }
    const float* base = sx + (xt * RX) * F::SYV + lane + dy + F::YL - py;
#pragma unroll
    for (int dxp = 0; dxp < RX + KX - 1; ++dxp) {
      float col[F::SZ];
#pragma unroll
      for (int s = 0; s < F::SZ; ++s) col[s] = base[s * plane + dxp * F::SYV];
#pragma unroll
      for (int xo = 0; xo < RX; ++xo) {
        const int dx = dxp - xo;  // the tap through which this column feeds output xo
        if (dx < 0 || dx >= KX) continue;
#pragma unroll
        for (int dz = 0; dz < KZ; ++dz) {
#pragma unroll
          for (int t = 0; t < TZ; ++t)
            acc[xo][t] = fmaf(col[t + dz], wr[dz * KX + dx], acc[xo][t]);
        }
      }
    }
  }

  const int oy = y0 + lane;
  if (oy >= Y) return;
  float* ob = out + (size_t)b * Z * X * Y;
#pragma unroll
  for (int xo = 0; xo < RX; ++xo) {
    const int ox = x0 + xt * RX + xo;
    if (ox >= X) continue;
#pragma unroll
    for (int t = 0; t < TZ; ++t) {
      const int oz = z0 + t;
      if (oz < Z) {
        float c = acc[xo][t];
        // relu(tanh(c)) is 0 wherever c <= 0 (and for a NaN, as fmaxf gives):
        // most of a sparse scene never pays for tanhf
        if (activation) c = c > 0.0f ? tanhf(c) : 0.0f;
        ob[((size_t)oz * X + ox) * Y + oy] = c;
      }
    }
  }
}

template <int KZ, int KX, int KY, int RX, int TZ, int NB, bool HALO>
int launch_fast(const float* x, const float* w, float* out, int B, int Z, int X, int Y,
                int activation, cudaStream_t s) {
  using F = Fast<KZ, KX, KY, RX, TZ, NB>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(stencil_fast_kernel<KZ, KX, KY, RX, TZ, NB, HALO>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)F::SMEM);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int tiles_y = (Y + kFastTy - 1) / kFastTy;
  const int tiles_x = (X + F::TX - 1) / F::TX;
  dim3 grid(tiles_y * tiles_x, (Z + TZ - 1) / TZ, B);
  // rows of the volume start on 16-byte boundaries: the halo goes 16 bytes a copy
  const int vec = Y % 4 == 0 && reinterpret_cast<size_t>(x) % 16 == 0;
  stencil_fast_kernel<KZ, KX, KY, RX, TZ, NB, HALO><<<grid, kFastThreads, F::SMEM, s>>>(
      x, w, out, Z, X, Y, activation, tiles_y, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B, Zin, X, Y) f32, kernel (k_z, k_x, k_y) f32, out (B, Z, X, Y) f32, all
// contiguous; 1 <= k_z <= 16. Output plane z reads input planes z - zlo ...
// z - zlo + k_z - 1, a plane outside 0 ... Zin - 1 reading zeros: the SAME conv
// is (Zin = Z, zlo = (k_z - 1) / 2), the VALID-z conv of a slab that carries
// its halo planes (Zin = Z + k_z - 1, zlo = 0). `fast` != 0 takes the unrolled
// kernel, which exists for (9,5,5) and those two forms alone (anything else is
// refused); 0 the generic one, any (Zin, zlo). Launches on `stream`; returns
// cudaGetLastError().
extern "C" int snt_stencil_conv(const float* x, const float* w, float* out,
                                int B, int Z, int X, int Y, int kz, int kx,
                                int ky, int activation, int fast, int Zin, int zlo,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Z <= 0 || X <= 0 || Y <= 0 || kx <= 0 || ky <= 0 || Zin <= 0 || zlo < 0)
    return (int)cudaErrorInvalidValue;
  if (fast) {
    if (kz == 9 && kx == 5 && ky == 5 && Zin == Z && zlo == (kz - 1) / 2)
      return launch_fast<9, 5, 5, 2, 8, 4, false>(x, w, out, B, Z, X, Y, activation, s);
    if (kz == 9 && kx == 5 && ky == 5 && Zin == Z + kz - 1 && zlo == 0)
      return launch_fast<9, 5, 5, 2, 8, 4, true>(x, w, out, B, Z, X, Y, activation, s);
    return (int)cudaErrorInvalidValue;
  }
  switch (kz) {
#define SNT_KZ(K) \
  case K:         \
    return launch<K>(x, w, out, B, Z, X, Y, kx, ky, activation, Zin, zlo, s);
    SNT_KZ(1) SNT_KZ(2) SNT_KZ(3) SNT_KZ(4) SNT_KZ(5) SNT_KZ(6) SNT_KZ(7)
    SNT_KZ(8) SNT_KZ(9) SNT_KZ(10) SNT_KZ(11) SNT_KZ(12) SNT_KZ(13)
    SNT_KZ(14) SNT_KZ(15) SNT_KZ(16)
#undef SNT_KZ
    default:
      return (int)cudaErrorInvalidValue;
  }
}
