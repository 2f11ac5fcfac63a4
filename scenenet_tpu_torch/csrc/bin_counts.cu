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
// snt_bin_counts, two routes (ops/cuda_hist.py bin_counts_route picks):
//   - float (N <= 2^24, every main path): one memset of both f32 outputs
//     (allocated as one), then one thread a point adds 1.0f to counts and,
//     where flagged, 1.0f to flagged, by atomics nobody waits for, in the L2
//     (a batch-16 pair of 64^3 grids is 33.5 MB, under its 50 MB). Exact:
//     no voxel can pass 2^24 points, below which every partial sum of ones
//     is an f32 integer. Two device operations a call.
//   - counter (past 2^24 points a sample): one 64-bit counter a voxel in a
//     scratch, zeroed by one memset, the count in its low half and the
//     flagged count in its high half (as K8's slab pass does in shared
//     memory): one atomic a point, and a half cannot carry into the other (N
//     < 2^31). A finishing pass reads each counter once and writes both f32
//     grids with streaming stores. Three device operations a call.
// Both read the ids in their own width (int32 or int64: no conversion pass)
// and the flags in theirs (1, 2, 4 or 8 bytes, nonzero bits meaning set; for
// a float, nonzero bits other than the sign: -0.0 is not set, NaN is), so no
// `weights != 0` pass either, and load a point's mask, id and flag together.
// Nothing waits for the host: the call can be captured in a CUDA graph. The
// previous design zeroed two int32 grids with torch.zeros, counted with two
// atomics a point and converted each grid to f32 in place (five operations
// and a flag pass, every grid read and written twice more). The weighted
// form adds its bf16-rounded weights with f32 atomicAdd, whose order changes
// from run to run: its sums are not bit-reproducible (the counts are); it
// keeps the previous design's passes.
//
// What the measurements said (H100, 700 W, inside a CUDA graph, 64^3, B=16,
// 65536 points, two channels; points_dk_times.py --kernels k7 --passes, the
// previous design's kernel 0.0594-0.0605 ms in the same calls): the counter
// route 0.0448 (memset 0.0104, count 0.0150, finish 0.0164: the finishing
// pass costs more than the second atomic it saves), with discard.global.L2 of the read
// counters 0.0456; the float route 0.0309 (memset 0.0094, count 0.0192),
// with warp-aggregated atomics (__match_any_sync) 0.0308, with four points a
// thread 0.0327-0.0342, with mask, id and flag loaded together 0.0307 (kept:
// no worse); K8's slab partition on the same input 0.0758-0.0770. On the
// smoke's host-exact ids (20% tower points) the float route takes 0.0287.
// At 128^3, B=4: the float route 0.0304-0.0307, the counter route
// 0.0669-0.0705, the previous design's kernel 0.0918-0.0920.
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

// The flag of point i as its raw bits, W bytes wide (W = 0: no flags).
template <int W>
__device__ __forceinline__ unsigned long long flag_bits(const void* flag, size_t i) {
  if (W == 1) return static_cast<const uint8_t*>(flag)[i];
  if (W == 2) return static_cast<const uint16_t*>(flag)[i];
  if (W == 4) return static_cast<const uint32_t*>(flag)[i];
  if (W == 8) return static_cast<const unsigned long long*>(flag)[i];
  return 0;
}

// cell[b, id] += 1 for every valid in-range id: a 32-bit count (W = 0), or
// a 64-bit counter whose high half also counts the points whose flag bits
// meet `value_bits` (W = 1, 2, 4, 8). Grid (ceil(N / 256), B).
template <typename Id, int W>
__global__ void __launch_bounds__(kCountThreads)
cell_count_kernel(const Id* __restrict__ ids, const uint8_t* __restrict__ mask,
                  const void* __restrict__ flag, unsigned long long value_bits,
                  void* __restrict__ cells, int N, int size) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const size_t pi = (size_t)b * N + i;
  // mask, id and flag loaded together, none waiting for another
  const bool keep = mask[pi] != 0;
  const long long id = (long long)ids[pi];
  const bool set = (flag_bits<W>(flag, pi) & value_bits) != 0ull;
  if (!keep || id < 0 || id >= size) return;
  const size_t at = (size_t)b * size + (size_t)id;
  if (W == 0)
    atomicAdd(static_cast<unsigned*>(cells) + at, 1u);
  else
    atomicAdd(static_cast<unsigned long long*>(cells) + at, set ? 0x100000001ull : 1ull);
}

// The float route: counts[b, id] += 1.0f and, where the point's flag bits
// meet `value_bits` (W > 0), flagged[b, id] += 1.0f, straight into the f32
// outputs the caller zeroes: exact while no voxel passes 2^24 points (N <=
// 2^24). One thread a point (four a thread, all loaded before the first
// atomic, was slower: 0.0223 against 0.0192 ms at 64^3, B = 16). Grid
// (ceil(N / 256), B).
template <typename Id, int W>
__global__ void __launch_bounds__(kCountThreads)
float_count_kernel(const Id* __restrict__ ids, const uint8_t* __restrict__ mask,
                   const void* __restrict__ flag, unsigned long long value_bits,
                   float* __restrict__ counts, float* __restrict__ flagged, int N, int size) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const size_t pi = (size_t)b * N + i;
  // mask, id and flag loaded together, none waiting for another
  const bool keep = mask[pi] != 0;
  const long long id = (long long)ids[pi];
  const bool set = (flag_bits<W>(flag, pi) & value_bits) != 0ull;
  if (!keep || id < 0 || id >= size) return;
  const size_t at = (size_t)b * size + (size_t)id;
  atomicAdd(counts + at, 1.0f);
  if (set) atomicAdd(flagged + at, 1.0f);
}

// The finishing pass: counts[k] = low half of cell k, flagged[k] = its high
// half (kTwo), else counts[k] = cell k, as f32, each output written once
// with streaming stores; `total` cells, 16-byte words of them a thread.
template <bool kTwo>
__global__ void cells_to_float_kernel(const void* __restrict__ cells, float* __restrict__ counts,
                                      float* __restrict__ flagged, size_t total) {
  constexpr int kPer = kTwo ? 2 : 4;  // cells a 16-byte load
  const size_t words = total / kPer;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t k = (size_t)blockIdx.x * blockDim.x + threadIdx.x; k < words; k += stride) {
    if (kTwo) {
      const ulonglong2 e = __ldcs(static_cast<const ulonglong2*>(cells) + k);
      __stcs(reinterpret_cast<float2*>(counts) + k,
             make_float2((float)(unsigned)e.x, (float)(unsigned)e.y));
      __stcs(reinterpret_cast<float2*>(flagged) + k,
             make_float2((float)(unsigned)(e.x >> 32), (float)(unsigned)(e.y >> 32)));
    } else {
      const uint4 e = __ldcs(static_cast<const uint4*>(cells) + k);
      __stcs(reinterpret_cast<float4*>(counts) + k,
             make_float4((float)e.x, (float)e.y, (float)e.z, (float)e.w));
    }
  }
  // the ragged tail, fewer than kPer cells
  const size_t k = words * kPer + (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k < total) {
    if (kTwo) {
      const unsigned long long e = static_cast<const unsigned long long*>(cells)[k];
      counts[k] = (float)(unsigned)e;
      flagged[k] = (float)(unsigned)(e >> 32);
    } else {
      counts[k] = (float)static_cast<const unsigned*>(cells)[k];
    }
  }
}

// One count pass: the float route (cells null) into the outputs, else the
// counter route into cells.
template <typename Id>
cudaError_t count_pass(const Id* ids, const uint8_t* mask, const void* flag, int flag_bytes,
                       unsigned long long value_bits, void* cells, float* counts,
                       float* flagged, int B, int N, int size, cudaStream_t s) {
  const dim3 grid((N + kCountThreads - 1) / kCountThreads, B);
  switch (flag_bytes) {
#define SNT_W(W)                                                                              \
  case W:                                                                                     \
    if (cells == nullptr)                                                                     \
      float_count_kernel<Id, W><<<grid, kCountThreads, 0, s>>>(ids, mask, flag, value_bits,  \
                                                               counts, flagged, N, size);    \
    else                                                                                      \
      cell_count_kernel<Id, W><<<grid, kCountThreads, 0, s>>>(ids, mask, flag, value_bits,   \
                                                              cells, N, size);                \
    return cudaSuccess;
    SNT_W(0) SNT_W(1) SNT_W(2) SNT_W(4) SNT_W(8)
#undef SNT_W
    default:
      return cudaErrorInvalidValue;
  }
}

// counts[b, id] += 1 (int32, zeroed by the caller) for every valid in-range
// id; wsum[b, id] += bf16(weight) in f32.
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

// ids (B, N) int32 (id_bytes 4) or int64 (8), mask (B, N) bool/uint8, flag
// (B, N) of flag_bytes (1, 2, 4 or 8) a point, set where its bits are
// nonzero (flag_float: other than the sign bit), or null (flag_bytes 0).
// counts and flagged (B, size) f32 (flagged null without flags), every
// element written. cells null: the float route (N <= 2^24), a memset of
// the outputs (one where flagged follows counts in memory) and the float
// count pass. Else the counter route: cells is a scratch of B * size
// counters of 8 bytes (with flags) or 4, of any contents, 16-byte aligned
// as the outputs; a memset of it, the counter pass and the finishing pass.
// Three operations at most on `stream`, none waiting for the host; returns
// cudaGetLastError().
extern "C" int snt_bin_counts(const void* ids, int id_bytes, const uint8_t* mask,
                              const void* flag, int flag_bytes, int flag_float, void* cells,
                              float* counts, float* flagged, int B, int N, int size,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool two = flag != nullptr;
  if (B <= 0 || B > 65535 || N <= 0 || size <= 0 || (id_bytes != 4 && id_bytes != 8) ||
      two != (flag_bytes != 0) || two != (flagged != nullptr) ||
      (cells == nullptr && N > (1 << 24)) ||
      (cells != nullptr && (reinterpret_cast<size_t>(cells) % 16 != 0 ||
                            reinterpret_cast<size_t>(counts) % 16 != 0 ||
                            reinterpret_cast<size_t>(flagged) % 16 != 0)))
    return (int)cudaErrorInvalidValue;
  const unsigned long long all =
      flag_bytes >= 8 ? ~0ull : (flag_bytes == 0 ? 0ull : (1ull << (8 * flag_bytes)) - 1ull);
  const unsigned long long value_bits =
      flag_float && flag_bytes > 0 ? all >> 1 : all;  // a float's sign bit does not count
  const size_t total = (size_t)B * size;
  cudaError_t e = cudaSuccess;
  if (cells != nullptr) {
    e = cudaMemsetAsync(cells, 0, total * (two ? 8 : 4), s);
  } else if (two && flagged == counts + total) {
    e = cudaMemsetAsync(counts, 0, 2 * total * sizeof(float), s);
  } else {
    e = cudaMemsetAsync(counts, 0, total * sizeof(float), s);
    if (e == cudaSuccess && two) e = cudaMemsetAsync(flagged, 0, total * sizeof(float), s);
  }
  if (e != cudaSuccess) return (int)e;
  e = id_bytes == 8
          ? count_pass(static_cast<const long long*>(ids), mask, flag, flag_bytes, value_bits,
                       cells, counts, flagged, B, N, size, s)
          : count_pass(static_cast<const int*>(ids), mask, flag, flag_bytes, value_bits, cells,
                       counts, flagged, B, N, size, s);
  if (e != cudaSuccess || cells == nullptr) return e != cudaSuccess ? (int)e
                                                                     : (int)cudaGetLastError();
  const int blocks = elementwise_blocks(total / (two ? 2 : 4) + 1);
  if (two)
    cells_to_float_kernel<true><<<blocks, 256, 0, s>>>(cells, counts, flagged, total);
  else
    cells_to_float_kernel<false><<<blocks, 256, 0, s>>>(cells, counts, nullptr, total);
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

