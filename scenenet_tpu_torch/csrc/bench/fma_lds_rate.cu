// What the card sustains: f32 FMAs alone, and FMAs with shared-memory loads
// among them, 32-bit or 128-bit. The yardstick the f32 stencil kernel
// (../stencil_conv.cu) is designed against; not part of the kernel library.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o fma_lds_rate fma_lds_rate.cu
//   ./fma_lds_rate
//
// Each thread keeps 32 accumulators and 16 weights in registers; an iteration
// loads 16 floats from shared memory (16 loads of 32 bits, lanes on
// neighbouring words, or 4 of 128 bits, lanes 20 words apart: both free of
// bank conflicts) and does 96, 192 or 288 FMAs with them. 256 threads a block,
// two blocks an SM. Read on an NVIDIA H100 80GB HBM3 at 700 W: FMAs alone 55.5
// TFLOP/s; 16 32-bit loads per 96 / 192 / 288 FMAs 27.7 / 37.2 / 41.5; 4
// 128-bit loads per 96 / 192 / 288 FMAs 45.9 / 53.6 / 51.2. So a warp-wide
// 32-bit shared load costs about as much as six FMAs, and its cost adds to
// theirs instead of hiding behind them.

#include <cstdio>
#include <cuda_runtime.h>
template <int LDS_EVERY>
__global__ void __launch_bounds__(256, 2) k(float* out, int iters, float a, float b) {
  __shared__ float sm[2048];
  for (int i = threadIdx.x; i < 2048; i += 256) sm[i] = a * i;
  __syncthreads();
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = threadIdx.x + i;
  float w[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) w[i] = a + i * b;
  const float* p = sm + (threadIdx.x & 31);
  for (int it = 0; it < iters; ++it) {
    float c[16];
#pragma unroll
    for (int s = 0; s < 16; ++s) c[s] = LDS_EVERY ? p[(s * 36 + it) & 2047 & ~31] : w[s] + it;
#pragma unroll
    for (int r = 0; r < (LDS_EVERY ? LDS_EVERY : 8); ++r) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = fmaf(c[(i + r) & 15], w[(i * 3 + r) & 15], acc[i]);
    }
  }
  float s = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) s += acc[i];
  out[blockIdx.x * 256 + threadIdx.x] = s;
}
template <int REP>
__global__ void __launch_bounds__(256, 2) k4(float* out, int iters, float a, float b) {
  __shared__ __align__(16) float sm[32 * 20 * 8];
  for (int i = threadIdx.x; i < 32 * 20 * 8; i += 256) sm[i] = a * i;
  __syncthreads();
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = threadIdx.x + i;
  float w[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) w[i] = a + i * b;
  const float* p = sm + (threadIdx.x & 31) * 20;
  for (int it = 0; it < iters; ++it) {
    float c[16];
    const float4* q = reinterpret_cast<const float4*>(p + (it & 7) * 640);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const float4 f = q[s];
      c[4 * s] = f.x; c[4 * s + 1] = f.y; c[4 * s + 2] = f.z; c[4 * s + 3] = f.w;
    }
#pragma unroll
    for (int r = 0; r < REP; ++r) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = fmaf(c[(i + r) & 15], w[(i * 3 + r) & 15], acc[i]);
    }
  }
  float s = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) s += acc[i];
  out[blockIdx.x * 256 + threadIdx.x] = s;
}
template <int L>
void run4(const char* name, float* out) {
  cudaEvent_t e0, e1; cudaEventCreate(&e0); cudaEventCreate(&e1);
  const int iters = 2000, blocks = 132 * 2 * 4;
  k4<L><<<blocks, 256>>>(out, iters, 1.0001f, 0.5f);
  cudaEventRecord(e0);
  k4<L><<<blocks, 256>>>(out, iters, 1.0001f, 0.5f);
  cudaEventRecord(e1); cudaEventSynchronize(e1);
  float ms; cudaEventElapsedTime(&ms, e0, e1);
  double fma = (double)blocks * 256 * iters * 32 * L;
  printf("%s: %.3f ms, %.1f TFLOP/s (%s)\n", name, ms, 2 * fma / ms / 1e9, cudaGetErrorString(cudaGetLastError()));
}
template <int L>
void run(const char* name, float* out) {
  cudaEvent_t e0, e1; cudaEventCreate(&e0); cudaEventCreate(&e1);
  const int iters = 2000, blocks = 132 * 2 * 4;
  k<L><<<blocks, 256>>>(out, iters, 1.0001f, 0.5f);
  cudaEventRecord(e0);
  k<L><<<blocks, 256>>>(out, iters, 1.0001f, 0.5f);
  cudaEventRecord(e1); cudaEventSynchronize(e1);
  float ms; cudaEventElapsedTime(&ms, e0, e1);
  double fma = (double)blocks * 256 * iters * 32 * (L ? L : 8);
  printf("%s: %.3f ms, %.1f TFLOP/s (%s)\n", name, ms, 2 * fma / ms / 1e9, cudaGetErrorString(cudaGetLastError()));
}
int main() {
  float* out; cudaMalloc(&out, 132 * 8 * 256 * 4);
  run<0>("pure FFMA, 8x32 per 16 adds", out);
  run<3>("16 LDS per 96 FFMA", out);
  run<6>("16 LDS per 192 FFMA", out);
  run<9>("16 LDS per 288 FFMA", out);
  run4<3>("4 LDS.128 per 96 FFMA", out);
  run4<6>("4 LDS.128 per 192 FFMA", out);
  run4<9>("4 LDS.128 per 288 FFMA", out);
  return 0;
}
