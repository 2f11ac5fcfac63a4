// Multi-channel 3x3x3 SAME conv3d, stride 1, no bias, f32 in, f32 out, f32
// accumulation, for Hopper (sm_90a).
//
// Replaces: scenenet_tpu/ops/pallas_conv_mc.py, conv3d_mc_same
// (_mc_kernel_vmem, whole sample resident, and _mc_kernel, streamed tiles):
// one kernel here serves every volume size and both layouts.
//
// out[b,co,z,x,y] = sum_{ci,dz,dx,dy} x[b,ci,z-1+dz,x-1+dx,y-1+dy] * w[co,ci,dz,dx,dy]
// with taps outside the volume reading 0.
//
// Bound on the H100: the SMs' f32 FMAs. A 32->32 layer at 64^3 does 27*32 =
// 864 FMAs for every output float, so device memory is far from the limit
// (only the 1->32 first layer is bound by its output bytes); what matters is
// feeding the FMA units from shared memory and registers.
//
// Design: an implicit GEMM over K = 27*C_in that never builds the patch
// matrix. A block of 256 threads owns a TZ x TX x TY tile of output voxels
// and CO_T output channels. It walks C_in in steps of 4 channels: each step
// stages the input tile with its one-voxel halo (zero-filled at the volume
// edge: no padded copy of the volume exists) and the 4*27*CO_T weights of
// the step in shared memory. A thread keeps 4 consecutive y outputs x 16
// output channels in registers; for each (ci, dz, dx) it loads the 6 inputs
// that its 4 outputs' three dy taps touch and, per dy, its 16 weights as
// four 128-bit loads that a whole warp shares (a broadcast), then does 192
// FMAs: 18 shared loads for 192 FMAs. The weights come transposed to
// (C_in, 27, C_out), so their staging is coalesced and conflict-free. The
// x tile's row and plane strides (SY, SP) are padded so that a warp's
// loads fall in different banks (two-way conflicts at worst). Tiles are
// chosen by the volume's y extent and C_out, so that the 4^3 and 8^3
// layers of a UNet waste little of a tile. The layouts (channels first or
// last) are element strides: channels-last loads are gathers, and slower.

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

}  // namespace

// x: B samples of C_in channels over Z*X*Y voxels, element (b, c, v) at
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
