// Histograms over flat bin ids computed beforehand, for Hopper (sm_90a).
//
// Replaces two TPU kernels of scenenet_tpu/ops/pallas_hist.py:
//   - pallas_bin_counts (_hist_kernel) by snt_bin_counts (indicator
//     weights, exact) and snt_bin_counts_weighted (float weights applied at
//     bf16 precision, f32 sums);
//   - pallas_sorted_bin_counts (_hist_kernel_sorted) by
//     snt_sorted_bin_counts, for large grids (the TPU wrapper sorts the ids
//     to feed each grid step its slab's run; here no sort is needed).
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
// than L2, so random atomics would each go to device memory. Instead every
// block of the last pass owns one slab of kSlabBins (4096) consecutive bins
// of one sample, counts the slab's points with shared-memory atomics (the
// two channels as the halves of one 64-bit counter) and writes the slab out
// once, coalesced, as f32, zeros included: no grid needs zeroing, no
// counting atomic leaves the SM, and every output element is written once.
// A slab only needs its own points, not their order, so the points are
// partitioned by slab, not sorted (a one-digit partition, three launches
// and a memset of 2*B*parts ints):
//   1. part_count_kernel: each kept point's part (id >> shift; a part is a
//      slab up to 256^3, several slabs past it so that a sample has at most
//      kMaxParts) into a block histogram in shared memory, one global add a
//      part a block;
//   2. part_scatter_kernel: each block scans its sample's part counts itself
//      (so no launch of its own), reserves its range of every part it holds
//      by one atomicAdd, and writes one word a point, id | flag << 31, into
//      the part's bucket (B*N words: the upper bound, so nothing is sized on
//      the host and nothing waits for it: the call can be captured in a
//      CUDA graph);
//   3. slab_count_kernel: a block a slab, its run of the bucket read once.
// The partition passes take fewer, longer chunks than the bounds pass (264
// blocks, ops/cuda_hist.py sorted_counts_plan), so that a block reserves a
// part's range once for many points. The order inside a bucket changes from
// run to run; counts are integer atomics, so the result does not. At B=4,
// 128^3 the bytes are 6 MB of ids, mask and flags read twice, 2 MB of
// bucket written and read (the L2 holds it), and 67 MB of output: the
// output bounds it. The previous design made one key a point, sorted each
// sample's keys with torch.sort (about half of its 0.1731 ms at B=4,
// 128^3), found each slab's run by two binary searches and read each flag
// through the sort's int64 permutation.
//
// What the measurements said (H100, inside a CUDA graph; points_dk_times.py
// --passes and throwaway builds of the variants): at B=4, 128^3 the
// previous design 0.156 ms (its sort's kernels about half; its slab pass
// 0.057), this one 0.043 (slab pass 0.029, scatter 0.008, count 0.0025); at
// B=1, 256^3 0.113 against 0.059 (slab pass 0.043: 134 MB, 3.1 TB/s). The
// first version: 0.050 and 0.065, its scatter pass 0.014 at 256^3 where
// each thread loaded its run of 16 part counts one after another (staged
// in shared memory first: 0.011); plain stores in the slab pass: 0.049
// and 0.062 (streaming stores kept); slabs of 2048 bins and 128 threads:
// 0.053 and 0.062. What holds the slab pass at 128^3 under the rate it
// reaches at 256^3: a few ground slabs hold thousands of points each, and
// 2048 blocks of 33 KB of shared memory are 2.6 waves of the 792 the card
// holds at once.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "counts_common.cuh"

namespace {

using snt::counts_to_float_kernel;
using snt::elementwise_blocks;

constexpr int kCountThreads = 256;
constexpr int kUnit = 4 * kCountThreads;  // points a partition block takes a step
constexpr int kSlabBins = 4096;  // a slab: 4096 64-bit counters, 32 KB shared
constexpr int kSlabThreads = 256;
constexpr int kMaxParts = 4096;  // parts a sample: the scatter pass's 32 KB of shared

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

// The partition of snt_sorted_bin_counts. A sample's bins are cut into
// parts of 2^shift bins (shift >= 12: a part is 1 << (shift - 12) slabs of
// kSlabBins; at most kMaxParts parts a sample, so that a block's histogram
// of them fits in shared memory). Grid (chunks, B) of 256-thread blocks,
// each over `chunk_len` points of one sample (a multiple of kUnit), four
// points a thread a step: ids as one 16-byte load, mask and flag bytes as
// one 4-byte load each where vec, else point by point.

// ids i0 .. i0+3 of row `base` and whether each counts (mask on, id in
// [0, size)); f[j] its flag (false where flag is null).
__device__ __forceinline__ void load_ids4(const int* __restrict__ ids,
                                          const uint8_t* __restrict__ mask,
                                          const uint8_t* __restrict__ flag, size_t base,
                                          int end, int i0, bool vec, int id[4], bool keep[4],
                                          bool f[4]) {
  if (vec && i0 + 3 < end) {
    const int4 v = *reinterpret_cast<const int4*>(ids + base + i0);
    const uint32_t mm = *reinterpret_cast<const uint32_t*>(mask + base + i0);
    const uint32_t ff =
        flag == nullptr ? 0u : *reinterpret_cast<const uint32_t*>(flag + base + i0);
    id[0] = v.x; id[1] = v.y; id[2] = v.z; id[3] = v.w;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      keep[j] = ((mm >> (8 * j)) & 0xffu) != 0u;
      f[j] = ((ff >> (8 * j)) & 0xffu) != 0u;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = i0 + j;
      keep[j] = i < end && mask[base + i];
      id[j] = keep[j] ? ids[base + i] : 0;
      f[j] = keep[j] && flag != nullptr && flag[base + i];
    }
  }
}

// Pass 1: count[b, p] = the points of sample b that count and fall in part
// p, by a histogram in shared memory (`parts` ints) and one global add a
// part a block.
__global__ void __launch_bounds__(kCountThreads)
part_count_kernel(const int* __restrict__ ids, const uint8_t* __restrict__ mask,
                  int* __restrict__ count, int N, int size, int shift, int parts,
                  int chunk_len, int vec) {
  extern __shared__ int s_hist[];
  const int b = blockIdx.y;
  for (int k = threadIdx.x; k < parts; k += kCountThreads) s_hist[k] = 0;
  __syncthreads();
  const size_t base = (size_t)b * N;
  const int start = blockIdx.x * chunk_len;
  const int end = (int)min((long long)N, (long long)start + chunk_len);
  for (int i0 = start + 4 * threadIdx.x; i0 < end; i0 += kUnit) {
    int id[4];
    bool keep[4], f[4];
    load_ids4(ids, mask, nullptr, base, end, i0, vec, id, keep, f);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (keep[j] && id[j] >= 0 && id[j] < size) atomicAdd(s_hist + (id[j] >> shift), 1);
  }
  __syncthreads();
  int* row = count + (size_t)b * parts;
  for (int k = threadIdx.x; k < parts; k += kCountThreads)
    if (s_hist[k]) atomicAdd(row + k, s_hist[k]);
}

// Pass 2: every point that counts writes id | flag << 31 into its part's
// bucket, the run bucket[b, start[b, p] .. + count[b, p]) (offsets from
// b*N). Each block first scans count[b, :] itself (the exclusive prefix is
// each part's start; block 0 of a sample also writes it to `start` for
// pass 3), counts its own points a part in shared memory, reserves each
// part's range by one atomicAdd on fill[b, p] (zeroed by the caller), then
// places its points by shared atomics. The order inside a bucket changes
// from run to run; the counts made from it do not.
__global__ void __launch_bounds__(kCountThreads)
part_scatter_kernel(const int* __restrict__ ids, const uint8_t* __restrict__ mask,
                    const uint8_t* __restrict__ flag, const int* __restrict__ count,
                    int* __restrict__ fill, int* __restrict__ start,
                    uint32_t* __restrict__ bucket, int N, int size, int shift, int parts,
                    int chunk_len, int vec) {
  extern __shared__ int s_dyn[];
  int* s_base = s_dyn;          // parts: where this block's run of each part begins
  int* s_loc = s_dyn + parts;   // parts: this block's points a part, then its cursor
  __shared__ int s_warp[kCountThreads / 32];
  const int b = blockIdx.y, tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int* crow = count + (size_t)b * parts;
  // exclusive scan of count[b, :]: the counts into shared memory (coalesced,
  // all loads in flight), a thread sums a run of `per` parts, the block
  // scans the 256 sums, each thread turns its run into prefixes in place
  for (int k = tid; k < parts; k += kCountThreads) {
    s_base[k] = __ldcg(crow + k);
    s_loc[k] = 0;
  }
  __syncthreads();
  const int per = (parts + kCountThreads - 1) / kCountThreads;
  const int k0 = min(parts, tid * per), k1 = min(parts, k0 + per);
  int sum = 0;
  for (int k = k0; k < k1; ++k) sum += s_base[k];
  int inc = sum;
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += v;
  }
  if (lane == 31) s_warp[warp] = inc;
  __syncthreads();
  int before = inc - sum;
  for (int w = 0; w < warp; ++w) before += s_warp[w];
  for (int k = k0; k < k1; ++k) {
    const int n = s_base[k];
    s_base[k] = before;
    if (blockIdx.x == 0) start[(size_t)b * parts + k] = before;
    before += n;
  }
  const size_t base = (size_t)b * N;
  const int first = blockIdx.x * chunk_len;
  const int end = (int)min((long long)N, (long long)first + chunk_len);
  for (int i0 = first + 4 * tid; i0 < end; i0 += kUnit) {
    int id[4];
    bool keep[4], f[4];
    load_ids4(ids, mask, nullptr, base, end, i0, vec, id, keep, f);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (keep[j] && id[j] >= 0 && id[j] < size) atomicAdd(s_loc + (id[j] >> shift), 1);
  }
  __syncthreads();
  int* frow = fill + (size_t)b * parts;
  for (int k = tid; k < parts; k += kCountThreads) {
    const int n = s_loc[k];
    if (n) s_base[k] += atomicAdd(frow + k, n);
    s_loc[k] = 0;
  }
  __syncthreads();
  uint32_t* out = bucket + base;
  for (int i0 = first + 4 * tid; i0 < end; i0 += kUnit) {
    int id[4];
    bool keep[4], f[4];
    load_ids4(ids, mask, flag, base, end, i0, vec, id, keep, f);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (!(keep[j] && id[j] >= 0 && id[j] < size)) continue;
      const int k = id[j] >> shift;
      out[s_base[k] + atomicAdd(s_loc + k, 1)] = (uint32_t)id[j] | ((uint32_t)f[j] << 31);
    }
  }
}

// Pass 3: block (s, b) counts slab s of sample b, bins [s*kSlabBins,
// +kSlabBins), from its part's bucket run: one shared atomic a point (the
// two channels as the halves of one 64-bit counter where kFlag), then the
// slab written once, coalesced, as f32, zeros included (16-byte stores
// where vec; streaming stores, which the L2 need not keep: 10% faster at
// 128^3 than plain ones). A null `flagged` is not written; with kFlag false
// a non-null one gets zeros.
template <bool kFlag>
__global__ void __launch_bounds__(kSlabThreads)
slab_count_kernel(const uint32_t* __restrict__ bucket, const int* __restrict__ start,
                  const int* __restrict__ count, float* __restrict__ counts,
                  float* __restrict__ flagged, int N, int size, int shift, int parts,
                  int vec) {
  using Cell = typename std::conditional<kFlag, unsigned long long, unsigned>::type;
  __shared__ Cell s_cell[kSlabBins];
  const int b = blockIdx.y;
  const int first = blockIdx.x * kSlabBins;
  const int width = min(kSlabBins, size - first);
  for (int k = threadIdx.x; k < kSlabBins; k += kSlabThreads) s_cell[k] = 0;
  const int part = first >> shift;
  const size_t at = (size_t)b * parts + part;
  const int lo = start[at], hi = lo + count[at];
  const uint32_t* run = bucket + (size_t)b * N;
  __syncthreads();
  auto add = [&](uint32_t v) {
    const unsigned k = (v & 0x7fffffffu) - (unsigned)first;
    if (k >= (unsigned)kSlabBins) return;  // another slab of the same part
    if (kFlag)
      atomicAdd(&s_cell[k], 1ull + ((unsigned long long)(v >> 31) << 32));
    else
      atomicAdd(&s_cell[k], 1u);
  };
  int i = lo + threadIdx.x;
  for (; i + 3 * kSlabThreads < hi; i += 4 * kSlabThreads) {  // four loads in flight
    uint32_t v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = run[i + j * kSlabThreads];
#pragma unroll
    for (int j = 0; j < 4; ++j) add(v[j]);
  }
  for (; i < hi; i += kSlabThreads) add(run[i]);
  __syncthreads();
  float* c = counts + (size_t)b * size + first;
  float* g = flagged == nullptr ? nullptr : flagged + (size_t)b * size + first;
  if (vec && width == kSlabBins) {
    for (int q = threadIdx.x; q < kSlabBins / 4; q += kSlabThreads) {
      Cell e[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) e[j] = s_cell[4 * q + j];
      __stcs(reinterpret_cast<float4*>(c) + q,
                make_float4((float)(unsigned)e[0], (float)(unsigned)e[1], (float)(unsigned)e[2],
                         (float)(unsigned)e[3]));
      if (g != nullptr)
        __stcs(reinterpret_cast<float4*>(g) + q,
               kFlag ? make_float4((float)(unsigned)((unsigned long long)e[0] >> 32),
                                   (float)(unsigned)((unsigned long long)e[1] >> 32),
                                   (float)(unsigned)((unsigned long long)e[2] >> 32),
                                   (float)(unsigned)((unsigned long long)e[3] >> 32))
                     : make_float4(0.f, 0.f, 0.f, 0.f));
    }
    return;
  }
  for (int k = threadIdx.x; k < width; k += kSlabThreads) {
    const Cell e = s_cell[k];
    __stcs(c + k, (float)(unsigned)e);
    if (g != nullptr) __stcs(g + k, kFlag ? (float)(unsigned)((unsigned long long)e >> 32) : 0.0f);
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

// ids (B, N) int32, mask (B, N) bool/uint8, flag (B, N) bool/uint8 or null.
// counts (B, size) f32 and flagged (B, size) f32 or null need no zeroing:
// every element is written (a null `flag` writes zeros to a non-null
// `flagged`). A point counts where its mask is on and its id lies in
// [0, size). The plan (ops/cuda_hist.py sorted_counts_plan): parts of
// 2^shift bins, shift >= 12, at most kMaxParts of them a sample; chunks *
// chunk_len >= N, chunk_len a multiple of 1024. scratch: 3*B*parts + B*N
// int32 words of any contents: count, fill and start, (B, parts) each (the
// first two zeroed here), then the (B, N) bucket of uint32 values. No host
// synchronisation: the launches can be captured in a CUDA graph. Launches
// on `stream`; returns cudaGetLastError().
extern "C" int snt_sorted_bin_counts(const int* ids, const uint8_t* mask,
                                     const uint8_t* flag, float* counts, float* flagged,
                                     int* scratch, int B, int N, int size, int shift,
                                     int chunks, int chunk_len, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || B > 65535 || N <= 0 || size <= 0 || shift < 12 || shift > 31 ||
      chunks <= 0 || chunks > 65535 || chunk_len <= 0 || chunk_len % kUnit != 0 ||
      (long long)chunks * chunk_len < N)
    return (int)cudaErrorInvalidValue;
  const int parts = (int)(((long long)size + (1ll << shift) - 1) >> shift);
  if (parts > kMaxParts) return (int)cudaErrorInvalidValue;
  int* count = scratch;
  int* fill = count + (size_t)B * parts;
  int* start = fill + (size_t)B * parts;
  uint32_t* bucket = reinterpret_cast<uint32_t*>(start + (size_t)B * parts);
  const int vec = N % 4 == 0 && reinterpret_cast<size_t>(ids) % 16 == 0 &&
                  reinterpret_cast<size_t>(mask) % 4 == 0 &&
                  reinterpret_cast<size_t>(flag) % 4 == 0;
  const cudaError_t zeroed = cudaMemsetAsync(count, 0, 2 * sizeof(int) * (size_t)B * parts, s);
  if (zeroed != cudaSuccess) return (int)zeroed;
  const dim3 pgrid(chunks, B);
  part_count_kernel<<<pgrid, kCountThreads, sizeof(int) * parts, s>>>(
      ids, mask, count, N, size, shift, parts, chunk_len, vec);
  part_scatter_kernel<<<pgrid, kCountThreads, 2 * sizeof(int) * parts, s>>>(
      ids, mask, flag, count, fill, start, bucket, N, size, shift, parts, chunk_len, vec);
  const dim3 sgrid((unsigned)(((long long)size + kSlabBins - 1) / kSlabBins), B);
  const int vec_out = size % 4 == 0 && reinterpret_cast<size_t>(counts) % 16 == 0 &&
                      reinterpret_cast<size_t>(flagged) % 16 == 0;
  if (flag != nullptr)
    slab_count_kernel<true><<<sgrid, kSlabThreads, 0, s>>>(bucket, start, count, counts,
                                                          flagged, N, size, shift, parts,
                                                          vec_out);
  else
    slab_count_kernel<false><<<sgrid, kSlabThreads, 0, s>>>(bucket, start, count, counts,
                                                           flagged, N, size, shift, parts,
                                                           vec_out);
  return (int)cudaGetLastError();
}

