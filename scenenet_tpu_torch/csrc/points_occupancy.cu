// Raw padded points -> voxel grids and bin ids, for Hopper (sm_90a).
//
// Replaces four TPU kernels of scenenet_tpu/ops/pallas_hist.py that share
// the id recipe _bin_flat_ids_in_kernel:
//   - pallas_points_occupancy (_points_hist_kernel, binarize=True,
//     channels=1) by snt_points_occupancy: the serving prep;
//   - pallas_points_binary (binarize=True, channels=2) by
//     snt_points_binary: the training prep, which adds tower presence;
//   - pallas_points_bin_counts (binarize=False, channels 1 or 2) by
//     snt_points_bin_counts: the counts and tower counts themselves, for
//     the density and tower-fraction grids (steps 1 and 2 below, then the
//     int32 counts are converted to f32 in place);
//   - pallas_flat_ids (_points_ids_kernel) by snt_flat_ids: steps 1 and 2
//     with the ids as the output, masked points set to a sentinel.
//
// Computes, per sample b of (B, N, 3) points with a (B, N) mask:
//   1. masked per-axis bounds, expanded to a cube (regular bounding box);
//   2. each valid point's flat (z, x, y) bin id with the f32 recipe
//        rel = (p - lo) * (n / max(hi - lo, 1e-30)),
//        id  = clip(ceil(rel - 1e-4) - 1, 0, n - 1),
//      and its count;
//   3. the min count of every y column over all (z, x);
//   4. occupancy = count > column min, as float {0, 1}, in (z, x, y) order;
//   5. (binary only) tower presence = 1 where any valid point flagged as
//      tower lands in the voxel, else 0.
//
// Bound on the H100: device-memory traffic and atomics, not arithmetic.
// A 64^3 sample of 131072 points reads 1.5 MB of points (twice: bounds,
// then ids) and scatters into 1 MB of int32 counts, which are then read
// twice more (column min, binarize) and 1 MB of f32 occupancy is written.
//
// Design: simple passes. The counts (1 MB per 64^3 sample) do not fit in
// shared memory, so they live in a scratch grid in device memory that the
// wrapper zeroes, and the count pass uses global atomicAdd, which the
// 50 MB L2 absorbs. Tower presence needs no count: every tower point
// stores 1 into a zeroed uint8 flag grid, and concurrent stores of the
// same value are race-free. One block per sample reduces the bounds; that
// block's first thread turns them into lo and 1/step exactly as the TPU
// kernel does. Both entry points share the bounds pass and flat_bin_id, so
// their bins cannot drift apart; the counts and ids entries share them too.
// The counts entry adds tower counts by a second int32 atomicAdd into a
// second zeroed grid; both grids are scratch and output at once (the
// wrapper zeroes them, the last pass converts them in place). Every operation of the id recipe is
// written as an _rn intrinsic, so nvcc cannot contract
// (p - lo) * inv - 1e-4 into an FMA: bin ids match the TPU kernel and the
// plain versions bit for bit. Build without fast math.

#include <cuda_runtime.h>
#include <climits>
#include <stdint.h>

#include "counts_common.cuh"

namespace {

using snt::counts_to_float_kernel;
using snt::elementwise_blocks;

constexpr int kBoundsThreads = 1024;
constexpr int kCountThreads = 256;
constexpr int kColTy = 32;  // y columns per column-min block
constexpr int kColRows = 8;  // row lanes per column-min block

__device__ __forceinline__ int edge_bin(float rel, int n) {
  // ceil(rel - 1e-4) - 1, clipped to [0, n-1]. Clamping in float before
  // the conversion equals the TPU's convert-then-clip for every finite
  // rel of a valid point; NaN (a zero-extent cloud) lands in bin 0 there too.
  float c = ceilf(__fsub_rn(rel, 1e-4f));
  if (isnan(c)) c = 0.0f;
  c = fminf(fmaxf(c, 1.0f), (float)n);
  return (int)c - 1;
}

// The flat (z, x, y) bin id of point p under params q = {lo, 1/step}.
__device__ __forceinline__ size_t flat_bin_id(const float* p, const float* q,
                                              int n_x, int n_y, int n_z) {
  const int ix = edge_bin(__fmul_rn(__fsub_rn(p[0], q[0]), q[3]), n_x);
  const int iy = edge_bin(__fmul_rn(__fsub_rn(p[1], q[1]), q[4]), n_y);
  const int iz = edge_bin(__fmul_rn(__fsub_rn(p[2], q[2]), q[5]), n_z);
  return ((size_t)iz * n_x + ix) * n_y + iy;
}

// Pass 1: params[b] = {lo_x, lo_y, lo_z, inv_x, inv_y, inv_z}.
__global__ void bounds_kernel(const float* __restrict__ pts,
                              const uint8_t* __restrict__ mask,
                              float* __restrict__ params, int N,
                              int n_x, int n_y, int n_z) {
  __shared__ float s_lo[3][kBoundsThreads / 32];
  __shared__ float s_hi[3][kBoundsThreads / 32];
  const int b = blockIdx.x;
  const float big = 3.4e38f;
  float lo[3] = {big, big, big};
  float hi[3] = {-big, -big, -big};
  const float* p = pts + (size_t)b * N * 3;
  const uint8_t* m = mask + (size_t)b * N;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    if (m[i]) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        float v = p[(size_t)i * 3 + a];
        lo[a] = fminf(lo[a], v);
        hi[a] = fmaxf(hi[a], v);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    for (int off = 16; off > 0; off >>= 1) {
      lo[a] = fminf(lo[a], __shfl_down_sync(0xffffffffu, lo[a], off));
      hi[a] = fmaxf(hi[a], __shfl_down_sync(0xffffffffu, hi[a], off));
    }
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    for (int a = 0; a < 3; ++a) {
      s_lo[a][warp] = lo[a];
      s_hi[a][warp] = hi[a];
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const int n_warps = blockDim.x / 32;
    for (int a = 0; a < 3; ++a) {
      for (int w = 1; w < n_warps; ++w) {
        s_lo[a][0] = fminf(s_lo[a][0], s_lo[a][w]);
        s_hi[a][0] = fmaxf(s_hi[a][0], s_hi[a][w]);
      }
    }
    float l[3], h[3], r[3];
    for (int a = 0; a < 3; ++a) {
      l[a] = s_lo[a][0];
      h[a] = s_hi[a][0];
      r[a] = __fsub_rn(h[a], l[a]);
    }
    const float rmax = fmaxf(r[0], fmaxf(r[1], r[2]));
    const float n[3] = {(float)n_x, (float)n_y, (float)n_z};
    float* out = params + (size_t)b * 6;
    for (int a = 0; a < 3; ++a) {
      const float half = __fmul_rn(__fsub_rn(rmax, r[a]), 0.5f);
      const float lo_a = __fsub_rn(l[a], half);
      const float hi_a = __fadd_rn(h[a], half);
      out[a] = lo_a;
      out[3 + a] = __fdiv_rn(n[a], fmaxf(__fsub_rn(hi_a, lo_a), 1e-30f));
    }
  }
}

// Pass 2: counts[b, id] += 1 for every valid point.
__global__ void count_kernel(const float* __restrict__ pts,
                             const uint8_t* __restrict__ mask,
                             const float* __restrict__ params,
                             int* __restrict__ counts, int N,
                             int n_x, int n_y, int n_z) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N || !mask[(size_t)b * N + i]) return;
  const size_t size = (size_t)n_x * n_y * n_z;
  const size_t id = flat_bin_id(pts + ((size_t)b * N + i) * 3,
                                params + (size_t)b * 6, n_x, n_y, n_z);
  atomicAdd(counts + b * size + id, 1);
}

// Pass 2, binary form: counts as above, and flags[b, id] = 1 for every
// valid point with tower[b, i] set (a plain store: no atomics needed).
__global__ void count_tower_kernel(const float* __restrict__ pts,
                                   const uint8_t* __restrict__ mask,
                                   const uint8_t* __restrict__ tower,
                                   const float* __restrict__ params,
                                   int* __restrict__ counts,
                                   uint8_t* __restrict__ flags, int N,
                                   int n_x, int n_y, int n_z) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t pi = (size_t)b * N + i;
  if (i >= N || !mask[pi]) return;
  const size_t size = (size_t)n_x * n_y * n_z;
  const size_t id = flat_bin_id(pts + pi * 3, params + (size_t)b * 6, n_x, n_y, n_z);
  atomicAdd(counts + b * size + id, 1);
  if (tower[pi]) flags[b * size + id] = 1;
}

// Pass 3: colmin[b, y] = min over (z, x) of counts[b, z, x, y].
__global__ void colmin_kernel(const int* __restrict__ counts,
                              int* __restrict__ colmin, int rows, int n_y) {
  __shared__ int s_min[kColRows][kColTy];
  const int b = blockIdx.y;
  const int y = blockIdx.x * kColTy + threadIdx.x;
  int v = INT_MAX;
  if (y < n_y) {
    const int* c = counts + (size_t)b * rows * n_y;
    for (int r = threadIdx.y; r < rows; r += kColRows)
      v = min(v, c[(size_t)r * n_y + y]);
  }
  s_min[threadIdx.y][threadIdx.x] = v;
  __syncthreads();
  if (threadIdx.y == 0 && y < n_y) {
    for (int r = 1; r < kColRows; ++r) v = min(v, s_min[r][threadIdx.x]);
    colmin[(size_t)b * n_y + y] = v;
  }
}

// Pass 4: out = counts > colmin of the voxel's y column.
__global__ void binarize_kernel(const int* __restrict__ counts,
                                const int* __restrict__ colmin,
                                float* __restrict__ out, size_t total,
                                size_t size, int n_y) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t b = i / size;
    out[i] = counts[i] > colmin[b * n_y + i % n_y] ? 1.0f : 0.0f;
  }
}

// Pass 4, binary form: x = counts > colmin, y = flags != 0.
__global__ void binarize_tower_kernel(const int* __restrict__ counts,
                                      const int* __restrict__ colmin,
                                      const uint8_t* __restrict__ flags,
                                      float* __restrict__ out_x,
                                      float* __restrict__ out_y, size_t total,
                                      size_t size, int n_y) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t b = i / size;
    out_x[i] = counts[i] > colmin[b * n_y + i % n_y] ? 1.0f : 0.0f;
    out_y[i] = flags[i] ? 1.0f : 0.0f;
  }
}

// Pass 2, counts form: counts as above, and towers[b, id] += 1 for every
// valid point with tower[b, i] set. `tower` and `towers` may both be null
// (one channel).
__global__ void count_pair_kernel(const float* __restrict__ pts,
                                  const uint8_t* __restrict__ mask,
                                  const uint8_t* __restrict__ tower,
                                  const float* __restrict__ params,
                                  int* __restrict__ counts,
                                  int* __restrict__ towers, int N,
                                  int n_x, int n_y, int n_z) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t pi = (size_t)b * N + i;
  if (i >= N || !mask[pi]) return;
  const size_t size = (size_t)n_x * n_y * n_z;
  const size_t id = flat_bin_id(pts + pi * 3, params + (size_t)b * 6, n_x, n_y, n_z);
  atomicAdd(counts + b * size + id, 1);
  if (tower != nullptr && tower[pi]) atomicAdd(towers + b * size + id, 1);
}

// Pass 2, ids form: ids[b, i] = the point's flat bin id, `invalid` where
// the mask is off (such a point's coordinates are never read).
__global__ void ids_kernel(const float* __restrict__ pts,
                           const uint8_t* __restrict__ mask,
                           const float* __restrict__ params,
                           int* __restrict__ ids, int N, int n_x, int n_y,
                           int n_z, int invalid) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const size_t pi = (size_t)b * N + i;
  ids[pi] = mask[pi] ? (int)flat_bin_id(pts + pi * 3, params + (size_t)b * 6,
                                        n_x, n_y, n_z)
                     : invalid;
}

}  // namespace

// pts (B, N, 3) f32, mask (B, N) bool/uint8, out (B, n_z*n_x*n_y) f32.
// Scratch from the caller: counts (B, size) int32 ZEROED, colmin (B, n_y)
// int32, params (B, 6) f32. Launches on `stream`; returns cudaGetLastError().
extern "C" int snt_points_occupancy(const float* pts, const uint8_t* mask,
                                    float* out, int* counts, int* colmin,
                                    float* params, int B, int N, int n_x,
                                    int n_y, int n_z, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || N <= 0 || n_x <= 0 || n_y <= 0 || n_z <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t size = (size_t)n_x * n_y * n_z;
  bounds_kernel<<<B, kBoundsThreads, 0, s>>>(pts, mask, params, N, n_x, n_y, n_z);
  dim3 cgrid((N + kCountThreads - 1) / kCountThreads, B);
  count_kernel<<<cgrid, kCountThreads, 0, s>>>(pts, mask, params, counts, N,
                                              n_x, n_y, n_z);
  dim3 mgrid((n_y + kColTy - 1) / kColTy, B);
  colmin_kernel<<<mgrid, dim3(kColTy, kColRows), 0, s>>>(
      counts, colmin, n_z * n_x, n_y);
  const size_t total = size * B;
  binarize_kernel<<<elementwise_blocks(total), 256, 0, s>>>(counts, colmin, out,
                                                            total, size, n_y);
  return (int)cudaGetLastError();
}

// pts (B, N, 3) f32, mask and tower (B, N) bool/uint8, out_x and out_y
// (B, n_z*n_x*n_y) f32. Scratch from the caller: counts (B, size) int32
// ZEROED, flags (B, size) uint8 ZEROED, colmin (B, n_y) int32, params (B, 6)
// f32. Launches on `stream`; returns cudaGetLastError().
extern "C" int snt_points_binary(const float* pts, const uint8_t* mask,
                                 const uint8_t* tower, float* out_x,
                                 float* out_y, int* counts, uint8_t* flags,
                                 int* colmin, float* params, int B, int N,
                                 int n_x, int n_y, int n_z, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || N <= 0 || n_x <= 0 || n_y <= 0 || n_z <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t size = (size_t)n_x * n_y * n_z;
  bounds_kernel<<<B, kBoundsThreads, 0, s>>>(pts, mask, params, N, n_x, n_y, n_z);
  dim3 cgrid((N + kCountThreads - 1) / kCountThreads, B);
  count_tower_kernel<<<cgrid, kCountThreads, 0, s>>>(pts, mask, tower, params,
                                                    counts, flags, N, n_x, n_y, n_z);
  dim3 mgrid((n_y + kColTy - 1) / kColTy, B);
  colmin_kernel<<<mgrid, dim3(kColTy, kColRows), 0, s>>>(
      counts, colmin, n_z * n_x, n_y);
  const size_t total = size * B;
  binarize_tower_kernel<<<elementwise_blocks(total), 256, 0, s>>>(
      counts, colmin, flags, out_x, out_y, total, size, n_y);
  return (int)cudaGetLastError();
}

// pts (B, N, 3) f32, mask (B, N) bool/uint8, tower (B, N) bool/uint8 or null.
// counts (B, n_z*n_x*n_y) int32 ZEROED by the caller, towers the same or
// null (with a null `tower` a non-null `towers` stays all zero). On return
// both hold the counts as f32, converted in place. Scratch: params (B, 6)
// f32. Launches on `stream`; returns cudaGetLastError().
extern "C" int snt_points_bin_counts(const float* pts, const uint8_t* mask,
                                     const uint8_t* tower, int* counts,
                                     int* towers, float* params, int B, int N,
                                     int n_x, int n_y, int n_z, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || N <= 0 || n_x <= 0 || n_y <= 0 || n_z <= 0 ||
      (tower != nullptr && towers == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t total = (size_t)n_x * n_y * n_z * B;
  bounds_kernel<<<B, kBoundsThreads, 0, s>>>(pts, mask, params, N, n_x, n_y, n_z);
  dim3 cgrid((N + kCountThreads - 1) / kCountThreads, B);
  count_pair_kernel<<<cgrid, kCountThreads, 0, s>>>(pts, mask, tower, params,
                                                   counts, towers, N, n_x, n_y, n_z);
  counts_to_float_kernel<<<elementwise_blocks(total), 256, 0, s>>>(counts, total);
  if (towers != nullptr)
    counts_to_float_kernel<<<elementwise_blocks(total), 256, 0, s>>>(towers, total);
  return (int)cudaGetLastError();
}

// pts (B, N, 3) f32, mask (B, N) bool/uint8 -> ids (B, N) int32: each valid
// point's flat (z, x, y) bin id, `invalid` for the others. Scratch: params
// (B, 6) f32. Launches on `stream`; returns cudaGetLastError().
extern "C" int snt_flat_ids(const float* pts, const uint8_t* mask, int* ids,
                            float* params, int B, int N, int n_x, int n_y,
                            int n_z, int invalid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || N <= 0 || n_x <= 0 || n_y <= 0 || n_z <= 0)
    return (int)cudaErrorInvalidValue;
  bounds_kernel<<<B, kBoundsThreads, 0, s>>>(pts, mask, params, N, n_x, n_y, n_z);
  dim3 cgrid((N + kCountThreads - 1) / kCountThreads, B);
  ids_kernel<<<cgrid, kCountThreads, 0, s>>>(pts, mask, params, ids, N, n_x, n_y,
                                            n_z, invalid);
  return (int)cudaGetLastError();
}
