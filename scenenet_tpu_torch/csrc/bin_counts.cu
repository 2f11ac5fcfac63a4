// Histograms over flat bin ids computed beforehand, for Hopper (sm_90a).
//
// Replaces two TPU kernels of scenenet_tpu/ops/pallas_hist.py:
//   - pallas_bin_counts (_hist_kernel) by snt_bin_counts (indicator
//     weights, exact) and snt_bin_counts_weighted (float weights applied at
//     bf16 precision, f32 sums);
//   - pallas_sorted_bin_counts (_hist_kernel_sorted) by
//     snt_sorted_bin_counts, for large grids.
//
// All compute, per sample b of (B, N) int32 ids with a (B, N) mask:
//   counts[b, v]  = number of valid points with id v,
//   second[b, v]  = number of those whose flag is set (indicator forms), or
//                   the f32 sum of their weights rounded to bf16 (weighted
//                   form).
// An id outside [0, size) or with its mask off counts nowhere.
//
// Bound on the H100: device-memory traffic and atomics, not arithmetic:
// 6 bytes a point in, 4 bytes a voxel and channel out.
//
// snt_bin_counts: one thread a point, int32 atomicAdd into grids the
// wrapper zeroes, then the int32 counts are converted to f32 in place. At
// 64^3 a batch-16 pair of grids is 32 MB and the 50 MB L2 absorbs the
// atomics. The weighted form adds its bf16-rounded weights with f32
// atomicAdd, whose order changes from run to run: its sums are not
// bit-reproducible (the counts are).
//
// snt_sorted_bin_counts: at 256^3 one channel of counts is 64 MB, more
// than L2, so random atomics would each go to device memory. The ids
// arrive sorted per sample instead: snt_sort_keys turns ids and mask into
// one key a point (the id, or `size` for a point that counts nowhere), the
// wrapper sorts the keys with torch.sort (as the TPU wrapper sorts outside
// its kernel), and every block owns one slab of kSlabBins consecutive
// bins: two binary searches find the contiguous run of the sorted keys
// that falls in its slab, the run is counted into a shared-memory
// histogram with shared-memory atomics (a point's flag is read through the
// sort's permutation), and the slab is written out once, coalesced, as
// f32, zeros included. So no grid needs zeroing, no atomic leaves the SM,
// the keys are read once and every output element is written exactly once,
// whatever the grid's size. Chosen over counting run lengths because the
// flagged (tower) count of a bin falls out of the same loop, with no
// prefix sum of the flags.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "counts_common.cuh"

namespace {

using snt::counts_to_float_kernel;
using snt::elementwise_blocks;

constexpr int kCountThreads = 256;
constexpr int kSlabBins = 4096;  // two int32 histograms of it: 32 KB shared
constexpr int kSlabThreads = 256;

// counts[b, id] += 1 for every valid in-range id; flagged[b, id] += 1 where
// the point's flag is set too. `flag` and `flagged` may both be null.
__global__ void id_count_kernel(const int* __restrict__ ids,
                                const uint8_t* __restrict__ mask,
                                const uint8_t* __restrict__ flag,
                                int* __restrict__ counts,
                                int* __restrict__ flagged, int N, int size) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t pi = (size_t)b * N + i;
  if (i >= N || !mask[pi]) return;
  const int id = ids[pi];
  if (id < 0 || id >= size) return;
  const size_t at = (size_t)b * size + id;
  atomicAdd(counts + at, 1);
  if (flag != nullptr && flag[pi]) atomicAdd(flagged + at, 1);
}

// counts as above; wsum[b, id] += bf16(weight) in f32.
__global__ void id_weight_kernel(const int* __restrict__ ids,
                                 const uint8_t* __restrict__ mask,
                                 const float* __restrict__ weights,
                                 int* __restrict__ counts,
                                 float* __restrict__ wsum, int N, int size) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t pi = (size_t)b * N + i;
  if (i >= N || !mask[pi]) return;
  const int id = ids[pi];
  if (id < 0 || id >= size) return;
  const size_t at = (size_t)b * size + id;
  atomicAdd(counts + at, 1);
  atomicAdd(wsum + at, __bfloat162float(__float2bfloat16_rn(weights[pi])));
}

// keys[i] = ids[i] where the point counts (mask on, id in [0, size)), else
// `size`, which sorts past every bin.
__global__ void sort_keys_kernel(const int* __restrict__ ids,
                                 const uint8_t* __restrict__ mask,
                                 int* __restrict__ keys, size_t total, int size) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int id = ids[i];
    keys[i] = (mask[i] && id >= 0 && id < size) ? id : size;
  }
}

// First index of the ascending `row` whose key is >= `key`.
__device__ __forceinline__ int lower_bound(const int* __restrict__ row, int n,
                                           int key) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = lo + (hi - lo) / 2;
    if (row[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Block (s, b) counts slab s of sample b: bins [s*kSlabBins, +kSlabBins).
// keys (B, N) ascending along N, every key in [0, size] (size = counts
// nowhere); order (B, N) the position each sorted key came from; flag
// (B, N) in the original order, or null.
__global__ void sorted_slab_kernel(const int* __restrict__ keys,
                                   const int64_t* __restrict__ order,
                                   const uint8_t* __restrict__ flag,
                                   float* __restrict__ counts,
                                   float* __restrict__ flagged, int N,
                                   int size) {
  __shared__ int s_counts[kSlabBins];
  __shared__ int s_flagged[kSlabBins];
  __shared__ int s_run[2];
  const int b = blockIdx.y;
  const int first = blockIdx.x * kSlabBins;
  const int width = min(kSlabBins, size - first);
  const int* row = keys + (size_t)b * N;
  for (int k = threadIdx.x; k < width; k += blockDim.x) {
    s_counts[k] = 0;
    s_flagged[k] = 0;
  }
  if (threadIdx.x < 2)
    s_run[threadIdx.x] = lower_bound(row, N, threadIdx.x == 0 ? first : first + width);
  __syncthreads();
  const uint8_t* f = flag == nullptr ? nullptr : flag + (size_t)b * N;
  const int64_t* from = order + (size_t)b * N;
  for (int i = s_run[0] + threadIdx.x; i < s_run[1]; i += blockDim.x) {
    const int k = row[i] - first;
    if (k < 0) continue;  // a negative key: outside the contract, counted nowhere
    atomicAdd(&s_counts[k], 1);
    if (f != nullptr && f[from[i]]) atomicAdd(&s_flagged[k], 1);
  }
  __syncthreads();
  const size_t out = (size_t)b * size + first;
  for (int k = threadIdx.x; k < width; k += blockDim.x) {
    counts[out + k] = (float)s_counts[k];
    if (flagged != nullptr) flagged[out + k] = (float)s_flagged[k];
  }
}

}  // namespace

// ids (B, N) int32, mask (B, N) bool/uint8, flag (B, N) bool/uint8 or null.
// counts (B, size) int32 ZEROED by the caller, flagged the same or null
// (with a null `flag` a non-null `flagged` stays all zero). On return both
// hold the counts as f32, converted in place. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int snt_bin_counts(const int* ids, const uint8_t* mask,
                              const uint8_t* flag, int* counts, int* flagged,
                              int B, int N, int size, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || N <= 0 || size <= 0 || (flag != nullptr && flagged == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t total = (size_t)B * size;
  dim3 grid((N + kCountThreads - 1) / kCountThreads, B);
  id_count_kernel<<<grid, kCountThreads, 0, s>>>(ids, mask, flag, counts, flagged,
                                                N, size);
  counts_to_float_kernel<<<elementwise_blocks(total), 256, 0, s>>>(counts, total);
  if (flagged != nullptr)
    counts_to_float_kernel<<<elementwise_blocks(total), 256, 0, s>>>(flagged, total);
  return (int)cudaGetLastError();
}

// The float-weight form: weights (B, N) f32; counts (B, size) int32 ZEROED
// (f32 on return, as above), wsum (B, size) f32 ZEROED. Launches on
// `stream`; returns cudaGetLastError().
extern "C" int snt_bin_counts_weighted(const int* ids, const uint8_t* mask,
                                       const float* weights, int* counts,
                                       float* wsum, int B, int N, int size,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || N <= 0 || size <= 0) return (int)cudaErrorInvalidValue;
  const size_t total = (size_t)B * size;
  dim3 grid((N + kCountThreads - 1) / kCountThreads, B);
  id_weight_kernel<<<grid, kCountThreads, 0, s>>>(ids, mask, weights, counts, wsum,
                                                 N, size);
  counts_to_float_kernel<<<elementwise_blocks(total), 256, 0, s>>>(counts, total);
  return (int)cudaGetLastError();
}

// ids (B, N) int32, mask (B, N) bool/uint8 -> keys (B, N) int32 for the
// sort: the id of a point that counts, `size` for any other. Launches on
// `stream`; returns cudaGetLastError().
extern "C" int snt_sort_keys(const int* ids, const uint8_t* mask, int* keys,
                             int B, int N, int size, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || N <= 0 || size <= 0) return (int)cudaErrorInvalidValue;
  const size_t total = (size_t)B * N;
  sort_keys_kernel<<<elementwise_blocks(total), 256, 0, s>>>(ids, mask, keys, total,
                                                            size);
  return (int)cudaGetLastError();
}

// keys (B, N) int32 sorted ascending along N, each in [0, size] with `size`
// for a point that counts nowhere; order (B, N) int64, the index along N
// that each sorted key came from; flag (B, N) bool/uint8 in the original
// order, or null. counts (B, size) f32 and flagged (B, size) f32 or null
// need no zeroing: every element is written (a null `flag` writes zeros to
// a non-null `flagged`). Launches on `stream`; returns cudaGetLastError().
extern "C" int snt_sorted_bin_counts(const int* keys, const int64_t* order,
                                     const uint8_t* flag, float* counts,
                                     float* flagged, int B, int N, int size,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || B > 65535 || N <= 0 || size <= 0) return (int)cudaErrorInvalidValue;
  dim3 grid((size + kSlabBins - 1) / kSlabBins, B);
  sorted_slab_kernel<<<grid, kSlabThreads, 0, s>>>(keys, order, flag, counts,
                                                  flagged, N, size);
  return (int)cudaGetLastError();
}
