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
//     the density and tower-fraction grids (the int32 counts are converted
//     to f32 in place);
//   - pallas_flat_ids (_points_ids_kernel) by snt_flat_ids: the ids as the
//     output, masked points set to a sentinel.
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
//      tower lands in the voxel, else 0 (a bit a voxel, as occupancy).
//
// Bound on the H100: device-memory bytes, not arithmetic. At B=64 a 64^3
// sample of 131072 padded points is 1.5 MB of points and mask and 1 MB of
// f32 output: 176 MB a call, 0.0526 ms at 3.35 TB/s. The points must be read
// twice (the bounds before any id), and the output written whole.
//
// The bounds pass (all four entries). bounds_kernel runs on a
// (chunks, B) grid that the caller plans (ops/cuda_hist.py bounds_plan):
// enough 256-thread blocks to fill the card at B=1 and at B=64, each over a
// chunk of whole 1024-point units of one sample. A thread reads four points
// at a time as three 16-byte loads (one 4-byte load of their mask bytes)
// where N is a multiple of 4, else point by point. Each block writes its
// masked min and max to partials[b, chunk]. The consumers' blocks reduce the
// partials of their sample in one warp and turn them into lo and 1/step
// (sample_params, the _rn arithmetic of the TPU kernel): a few hundred
// floats from L2, where a launch of its own would cost more at B=1. Min and
// max are exact in any order, so the params equal a one-block reduction's
// bit for bit. Every consumer takes the params from sample_params and the
// ids from flat_bin_id, so the four entries cannot drift apart.
//
// Occupancy without a count grid. A y column's min count is 0 unless every
// one of its n_z*n_x voxels holds a point; then occupancy is "some point
// landed here", one bit a voxel. So the bounds pass also zeroes a bitmap
// (B*size/8 bytes: 2 MB at B=64, 64^3, which the L2 holds) and a (B, n_y)
// int32 `nonempty`; mark_kernel sets each valid point's bit by atomicOr and
// the thread that finds the bit clear adds one to nonempty[b, y] (through
// shared memory); expand_kernel writes the output once, 16 bytes a thread,
// from the bits. A column with nonempty == n_z*n_x (rare; the tests force
// it) is then rewritten exactly by full_column_kernel, one block a sample,
// which returns at once where no column of its sample is full, else counts
// that column's points in shared memory (slabs of at most 11264 voxels),
// takes the min and writes count > min. Four launches (the previous design:
// a zeroed int32 grid and four), nothing zeroed by the caller; at B=64 the
// bytes are the points twice (218 MB) and the output once (67 MB).
//
// What the measurements said (H100, B=64; points_dk_times.py --passes and
// throwaway builds of the variants). Marking straight into the zeroed f32
// output (read the word, atomicExch 1.0f) took 0.097 ms: the 67 MB grid
// does not fit in the L2, so most marks were a read-modify-write of device
// memory, and the zeroing cost the bounds pass 67 MB of writes (0.068 ms
// for it). The bitmap: marks 0.075, bounds 0.048, expand 0.023. What is left
// of marking is L2 operations, one a point: a private copy of the sample's
// bitmap in each block's shared memory, merged once at the end, was slower
// (0.090; 0.021 at B=1, where a block holds 1024 points and the merge walks
// all 8192 words); used as a filter, so that only a block's first point in
// a voxel reaches L2, it takes 0.073.
//
// The training grids (snt_points_binary) come from the same four launches
// as occupancy, so the two entries cannot drift: tower presence is "some
// valid flagged point landed here", one bit a voxel with no column min. The
// bounds pass zeroes a second bitmap right after the first, mark_kernel
// sets a valid flagged point's bit of it too (the mask gates the flag), and
// expand_kernel writes both grids, 16 bytes a thread each; full columns are
// occupancy's alone. The shared-memory filter holds the occupancy bits only:
// two 32 KB bitmaps at 64^3 do not fit under kMarkSmem, and a flagged point's
// bit is set by an atomicOr whose result is not read, so it waits for
// nothing. At B=16, N=65536 the bytes are the points, mask and flags twice
// (29 MB) and two grids once (33.5 MB). The previous design zeroed a 16 MB
// int32 count grid and a 4 MB flag grid in the wrapper, then counted by
// global atomics, took each column's min from the count grid and wrote both
// outputs from both grids: about 90 MB of grid traffic and six launches.
//
// What the measurements said for the training grids (H100, B=16, N=65536,
// 64^3, inside a CUDA graph; points_dk_times.py --passes and throwaway
// builds of the variants): the previous design 0.094 ms; this one 0.053 with
// the mark pass over the bounds plan's 1024-point chunks, of which marking
// 0.030, expand 0.011 (33.5 MB, 3.1 TB/s), bounds 0.008. Marking over
// whole runs of bounds chunks, 3072 points a block (mark_plan: up to 4096
// points, never under 264 blocks), 0.050-0.053 (marking 0.026): the filter
// catches more repeats and its setup is paid less often. 4096 points with
// no floor on the blocks: 0.050 at B=16 but marking 0.010 -> 0.015 at B=1
// (16 blocks); 8192: 0.053. Without the shared filter (read the word, then
// atomicOr): 0.059; a tower bit read before its atomicOr: 0.055; the
// block's first point in a voxel reading the word before its atomicOr:
// 0.050; a second shared filter for the tower bits (64 KB, opted in):
// 0.049, inside the spread of the kept design in the same call, so not
// kept. What holds marking: an L2 atomic for each block's first point in
// a voxel, whose result the thread waits for.
//
// The counts and ids entries keep their own passes (int32 atomics into
// grids the wrapper zeroes, converted in place; the ids as they are) behind
// the shared bounds pass.
//
// Every operation of the id recipe is written as an _rn intrinsic, so nvcc
// cannot contract (p - lo) * inv - 1e-4 into an FMA: bin ids match the TPU
// kernel and the plain versions bit for bit. Build without fast math.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W): PERF.md section 6, row 1, for this
// design against the previous one (one 1024-thread block a sample for the
// bounds, then counts, a column-min pass and a binarize pass over a zeroed
// int32 grid: 0.2969 ms at B=64, of which 42 us of the 63 at B=1 were the
// one-block bounds pass).

#include <cuda_runtime.h>
#include <climits>
#include <stdint.h>

#include "counts_common.cuh"

namespace {

using snt::counts_to_float_kernel;
using snt::elementwise_blocks;

constexpr int kThreads = 256;          // bounds, mark and count passes
constexpr int kUnit = 4 * kThreads;    // points a block takes per step: 4 a thread
constexpr int kFixThreads = 512;       // full_column_kernel
constexpr int kSlab = 11264;           // voxels of a column counted at once: 44 KB
constexpr int kShareY = 8192;          // the most y columns mark_kernel counts in shared memory
constexpr int kMarkSmem = 45 * 1024;   // mark_kernel's dynamic shared memory at most
constexpr float kBig = 3.4e38f;  // the TPU kernel's masked-bound sentinel

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

// Four points i0 .. i0+3 of sample row `base` (= b*N) and their mask bits.
// vec: N % 4 == 0 and both pointers aligned, so the four rows are three
// 16-byte words and the mask bytes one 4-byte word. Otherwise point by
// point, with points past N masked off and a masked point's coordinates
// never read.
__device__ __forceinline__ void load4(const float* __restrict__ pts,
                                      const uint8_t* __restrict__ mask, size_t base,
                                      int N, int i0, bool vec, float p[4][3],
                                      bool m[4]) {
  if (vec) {
    const float4* q = reinterpret_cast<const float4*>(pts + (base + i0) * 3);
    const float4 a = q[0], c = q[1], d = q[2];
    p[0][0] = a.x; p[0][1] = a.y; p[0][2] = a.z;
    p[1][0] = a.w; p[1][1] = c.x; p[1][2] = c.y;
    p[2][0] = c.z; p[2][1] = c.w; p[2][2] = d.x;
    p[3][0] = d.y; p[3][1] = d.z; p[3][2] = d.w;
    const uint32_t mm = *reinterpret_cast<const uint32_t*>(mask + base + i0);
#pragma unroll
    for (int j = 0; j < 4; ++j) m[j] = (mm >> (8 * j)) & 0xffu;
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int i = i0 + j;
    m[j] = i < N && mask[base + i];
#pragma unroll
    for (int a = 0; a < 3; ++a) p[j][a] = m[j] ? pts[(base + i) * 3 + a] : 0.0f;
  }
}

// The tower flags of the same four points, gated by their mask bits m: one
// 4-byte load where vec (then the flags' pointer is 4-byte aligned too).
__device__ __forceinline__ void load_flags4(const uint8_t* __restrict__ flag, size_t base,
                                            int i0, bool vec, const bool m[4], bool t[4]) {
  if (vec) {
    const uint32_t ff = *reinterpret_cast<const uint32_t*>(flag + base + i0);
#pragma unroll
    for (int j = 0; j < 4; ++j) t[j] = m[j] && ((ff >> (8 * j)) & 0xffu);
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) t[j] = m[j] && flag[base + i0 + j];
}

// Point pi (= b*N + i) where `in` (i < N) and its mask bit are set: its
// coordinates into p, and true; a masked point's coordinates are never read.
__device__ __forceinline__ bool load_point(const float* __restrict__ pts,
                                          const uint8_t* __restrict__ mask, size_t pi,
                                          bool in, float p[3]) {
  const bool valid = in && mask[pi];
#pragma unroll
  for (int a = 0; a < 3; ++a) p[a] = valid ? pts[pi * 3 + a] : 0.0f;
  return valid;
}

__device__ __forceinline__ void warp_minmax(float lo[3], float hi[3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    for (int off = 16; off > 0; off >>= 1) {
      lo[a] = fminf(lo[a], __shfl_xor_sync(0xffffffffu, lo[a], off));
      hi[a] = fmaxf(hi[a], __shfl_xor_sync(0xffffffffu, hi[a], off));
    }
  }
}

// Zero n 32-bit words at p, as worker `w` of `workers` threads.
__device__ __forceinline__ void zero_words(uint32_t* p, size_t n, size_t w, size_t workers) {
  if (p == nullptr) return;
  size_t head = 0;
  if (reinterpret_cast<size_t>(p) % 16 == 0) {
    float4* p4 = reinterpret_cast<float4*>(p);
    const size_t n4 = n / 4;
    for (size_t i = w; i < n4; i += workers) p4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    head = n4 * 4;
  }
  for (size_t i = head + w; i < n; i += workers) p[i] = 0u;
}

// The bounds pass: partials[b, chunk] = {min x, y, z, max x, y, z} over the
// chunk's valid points (the sentinels where it has none). Grid (chunks, B).
// The blocks also zero `zero_a` and `zero_b` (n_a, n_b words; either may be
// null) for the pass that follows.
__global__ void __launch_bounds__(kThreads)
bounds_kernel(const float* __restrict__ pts, const uint8_t* __restrict__ mask,
              float* __restrict__ partials, int N, int chunk_len, int vec,
              uint32_t* zero_a, size_t n_a, uint32_t* zero_b, size_t n_b) {
  __shared__ float s_lo[3][kThreads / 32];
  __shared__ float s_hi[3][kThreads / 32];
  const int b = blockIdx.y, chunk = blockIdx.x;
  const size_t blk = (size_t)b * gridDim.x + chunk;
  const size_t workers = (size_t)gridDim.x * gridDim.y * kThreads;
  zero_words(zero_a, n_a, blk * kThreads + threadIdx.x, workers);
  zero_words(zero_b, n_b, blk * kThreads + threadIdx.x, workers);

  float lo[3] = {kBig, kBig, kBig};
  float hi[3] = {-kBig, -kBig, -kBig};
  const size_t base = (size_t)b * N;
  const int end = (int)min((long long)N, (long long)(chunk + 1) * chunk_len);
#pragma unroll 4
  for (int i0 = chunk * chunk_len + 4 * threadIdx.x; i0 < end; i0 += kUnit) {
    float p[4][3];
    bool m[4];
    load4(pts, mask, base, N, i0, vec, p, m);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (!m[j]) continue;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        lo[a] = fminf(lo[a], p[j][a]);
        hi[a] = fmaxf(hi[a], p[j][a]);
      }
    }
  }
  warp_minmax(lo, hi);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      s_lo[a][warp] = lo[a];
      s_hi[a][warp] = hi[a];
    }
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    const int a = threadIdx.x;
    float l = s_lo[a][0], h = s_hi[a][0];
    for (int w = 1; w < kThreads / 32; ++w) {
      l = fminf(l, s_lo[a][w]);
      h = fmaxf(h, s_hi[a][w]);
    }
    partials[blk * 6 + a] = l;
    partials[blk * 6 + 3 + a] = h;
  }
}

// s_q = {lo_x, lo_y, lo_z, inv_x, inv_y, inv_z} of sample b, reduced from
// its partials by warp 0, exactly as the TPU kernel computes them from its
// bounds. Every thread of the block must call it (it synchronises).
__device__ void sample_params(const float* __restrict__ partials, int b, int chunks,
                              int n_x, int n_y, int n_z, float* s_q) {
  if (threadIdx.x < 32) {
    float lo[3] = {kBig, kBig, kBig};
    float hi[3] = {-kBig, -kBig, -kBig};
    for (int c = threadIdx.x; c < chunks; c += 32) {
      const float* p = partials + ((size_t)b * chunks + c) * 6;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        lo[a] = fminf(lo[a], p[a]);
        hi[a] = fmaxf(hi[a], p[3 + a]);
      }
    }
    warp_minmax(lo, hi);
    if (threadIdx.x == 0) {
      float r[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) r[a] = __fsub_rn(hi[a], lo[a]);
      const float rmax = fmaxf(r[0], fmaxf(r[1], r[2]));
      const float n[3] = {(float)n_x, (float)n_y, (float)n_z};
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float half = __fmul_rn(__fsub_rn(rmax, r[a]), 0.5f);
        const float lo_a = __fsub_rn(lo[a], half);
        const float hi_a = __fadd_rn(hi[a], half);
        s_q[a] = lo_a;
        s_q[3 + a] = __fdiv_rn(n[a], fmaxf(__fsub_rn(hi_a, lo_a), 1e-30f));
      }
    }
  }
  __syncthreads();
}

// Occupancy, common case: bit id of sample b's words of `bitmap` (wps words
// a sample, zeroed by the bounds pass) set for every valid point, and
// nonempty[b, y] += 1 for every bit set first. Where the sample's bitmap
// fits in shared memory (smem_bits: 32 KB at 64^3) the block keeps a copy
// of the bits it has set there: a point whose voxel the block has already
// seen costs a shared atomic and nothing in L2, and the block's first point
// in a voxel sets the bit in device memory by atomicOr. Otherwise each
// point reads its word in device memory first (most points land in a voxel
// already set) and then sets the bit. The thread that finds a bit clear in
// device memory counts the voxel, in shared memory where shared_y (one
// global add a column a block at the end), else in device memory. Tower
// presence (`tower` non-null, points_binary): a valid point whose flag is
// set also sets its bit of `tbits` (same layout, zeroed with the bitmap) by
// an atomicOr whose result is not read, so it waits for nothing; no shared
// filter for those bits (see the header). Grid (mark chunks, B): chunks of
// chunk_len points, whole chunks of the bounds plan (ops/cuda_hist.py
// mark_plan; `chunks` is the bounds pass's count, for the partials), walked
// in the reverse order of the bounds pass, so that the first blocks read
// the points the L2 still holds; a thread's next four points are in flight
// while it marks.
__global__ void __launch_bounds__(kThreads)
mark_kernel(const float* __restrict__ pts, const uint8_t* __restrict__ mask,
            const uint8_t* __restrict__ tower, const float* __restrict__ partials,
            uint32_t* __restrict__ bitmap, uint32_t* __restrict__ tbits,
            int* __restrict__ nonempty, int N, int chunks, int chunk_len, int n_x, int n_y,
            int n_z, int wps, int vec, int smem_bits, int shared_y) {
  extern __shared__ uint32_t s_dyn[];
  uint32_t* s_bits = s_dyn;                                          // wps words
  int* s_ne = reinterpret_cast<int*>(s_dyn + (smem_bits ? wps : 0));  // n_y counts
  __shared__ float s_q[6];
  const int b = gridDim.y - 1 - blockIdx.y, chunk = gridDim.x - 1 - blockIdx.x;
  if (smem_bits)
    for (int w = threadIdx.x; w < wps; w += kThreads) s_bits[w] = 0u;
  if (shared_y)
    for (int y = threadIdx.x; y < n_y; y += kThreads) s_ne[y] = 0;
  const size_t base = (size_t)b * N;
  int i0 = chunk * chunk_len + 4 * threadIdx.x;
  const int end = (int)min((long long)N, (long long)(chunk + 1) * chunk_len);
  float p[4][3];
  bool m[4] = {false, false, false, false};
  bool t[4] = {false, false, false, false};
  bool have = i0 < end;
  if (have) {  // in flight meanwhile
    load4(pts, mask, base, N, i0, vec, p, m);
    if (tower != nullptr) load_flags4(tower, base, i0, vec, m, t);
  }
  sample_params(partials, b, chunks, n_x, n_y, n_z, s_q);  // synchronises: shared zeroed
  uint32_t* gbits = bitmap + (size_t)b * wps;
  uint32_t* gtower = tower == nullptr ? nullptr : tbits + (size_t)b * wps;
  int* ne = nonempty + (size_t)b * n_y;
  auto count = [&](unsigned id) {
    const unsigned y = id % (unsigned)n_y;
    if (shared_y)
      atomicAdd(s_ne + y, 1);
    else
      atomicAdd(ne + y, 1);
  };
  while (have) {
    unsigned id[4];
    bool mm[4], tt[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      mm[j] = m[j];
      tt[j] = t[j];
      id[j] = m[j] ? (unsigned)flat_bin_id(p[j], s_q, n_x, n_y, n_z) : 0u;
    }
    i0 += kUnit;
    have = i0 < end;
    if (have) {
      load4(pts, mask, base, N, i0, vec, p, m);
      if (tower != nullptr) load_flags4(tower, base, i0, vec, m, t);
    }
    if (gtower != nullptr) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (tt[j]) atomicOr(gtower + (id[j] >> 5), 1u << (id[j] & 31));
    }
    if (smem_bits) {
      bool first[4];  // the block's first point in its voxel
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t mb = 1u << (id[j] & 31);
        first[j] = mm[j] && (atomicOr(s_bits + (id[j] >> 5), mb) & mb) == 0u;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t mb = 1u << (id[j] & 31);
        if (first[j] && (atomicOr(gbits + (id[j] >> 5), mb) & mb) == 0u) count(id[j]);
      }
      continue;
    }
    uint32_t word[4];  // all four reads in flight before any atomic
#pragma unroll
    for (int j = 0; j < 4; ++j) word[j] = mm[j] ? __ldcg(gbits + (id[j] >> 5)) : 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t mb = 1u << (id[j] & 31);
      if (mm[j] && (word[j] & mb) == 0u && (atomicOr(gbits + (id[j] >> 5), mb) & mb) == 0u)
        count(id[j]);
    }
  }
  if (!shared_y) return;
  __syncthreads();
  for (int y = threadIdx.x; y < n_y; y += kThreads)
    if (s_ne[y]) atomicAdd(ne + y, s_ne[y]);
}

// out[b, v] = bit v of sample b's words of the bitmap, as f32 {0, 1}, and
// out_t[b, v] the same of `tbits` where out_t is non-null (points_binary):
// four voxels a thread and one 16-byte store a grid where size % 4 == 0 and
// the outputs are aligned (vec), else one voxel a thread.
__global__ void __launch_bounds__(kThreads)
expand_kernel(const uint32_t* __restrict__ bitmap, const uint32_t* __restrict__ tbits,
              float* __restrict__ out, float* __restrict__ out_t, unsigned size,
              unsigned total, int wps, int vec) {
  const unsigned stride = gridDim.x * kThreads;
  const unsigned first = blockIdx.x * kThreads + threadIdx.x;
  auto nibble = [](uint32_t nib) {
    return make_float4((float)(nib & 1u), (float)((nib >> 1) & 1u), (float)((nib >> 2) & 1u),
                       (float)(nib >> 3));
  };
  if (vec) {
    for (unsigned q = first; q < total / 4; q += stride) {
      const unsigned b = 4 * q / size, v = 4 * q - b * size;
      const size_t w = (size_t)b * wps + (v >> 5);
      reinterpret_cast<float4*>(out)[q] = nibble((__ldg(bitmap + w) >> (v & 31)) & 0xfu);
      if (out_t != nullptr)
        reinterpret_cast<float4*>(out_t)[q] = nibble((__ldg(tbits + w) >> (v & 31)) & 0xfu);
    }
    return;
  }
  for (unsigned i = first; i < total; i += stride) {
    const unsigned b = i / size, v = i - b * size;
    const size_t w = (size_t)b * wps + (v >> 5);
    out[i] = (float)((__ldg(bitmap + w) >> (v & 31)) & 1u);
    if (out_t != nullptr) out_t[i] = (float)((__ldg(tbits + w) >> (v & 31)) & 1u);
  }
}

__device__ int block_min(int v, int* s_red) {
  for (int off = 16; off > 0; off >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, off));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // s_red may still be read from the previous call
  if (lane == 0) s_red[warp] = v;
  __syncthreads();
  v = s_red[0];
  for (int w = 1; w < (int)blockDim.x / 32; ++w) v = min(v, s_red[w]);
  return v;
}

// Occupancy, the rare case: every y column of sample b whose n_z*n_x voxels
// all hold a point is rewritten as count > column min, from counts made in
// shared memory. One block a sample; it returns at once where no column is
// full. A column of more than kSlab voxels is counted in slabs, twice: for
// the min, then for the output.
__global__ void __launch_bounds__(kFixThreads)
full_column_kernel(const float* __restrict__ pts, const uint8_t* __restrict__ mask,
                   const float* __restrict__ partials, float* __restrict__ out,
                   const int* __restrict__ nonempty, int N, int chunks, int n_x, int n_y,
                   int n_z, int slab) {
  extern __shared__ int s_cnt[];
  __shared__ float s_q[6];
  __shared__ int s_flag[kFixThreads];
  __shared__ int s_red[kFixThreads / 32];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int cells = n_z * n_x;
  const int* ne = nonempty + (size_t)b * n_y;
  bool any = false;
  for (int y = tid; y < n_y; y += kFixThreads) any |= ne[y] == cells;
  if (!__syncthreads_or(any)) return;
  sample_params(partials, b, chunks, n_x, n_y, n_z, s_q);
  const size_t base = (size_t)b * N;
  float* ob = out + (size_t)b * cells * n_y;
  const int n_slabs = (cells + slab - 1) / slab;

  // counts of column y's voxels c0 .. c0+len-1 into s_cnt
  auto count = [&](int y, int c0, int len) {
    for (int c = tid; c < len; c += kFixThreads) s_cnt[c] = 0;
    __syncthreads();
    for (int i = tid; i < N; i += kFixThreads) {
      if (!mask[base + i]) continue;
      const unsigned id = (unsigned)flat_bin_id(pts + (base + i) * 3, s_q, n_x, n_y, n_z);
      if (id % (unsigned)n_y != (unsigned)y) continue;
      const int c = (int)(id / (unsigned)n_y) - c0;
      if (c >= 0 && c < len) atomicAdd(s_cnt + c, 1);
    }
    __syncthreads();
  };
  auto write = [&](int y, int c0, int len, int colmin) {
    for (int c = tid; c < len; c += kFixThreads)
      ob[(size_t)(c0 + c) * n_y + y] = s_cnt[c] > colmin ? 1.0f : 0.0f;
    __syncthreads();
  };

  for (int y0 = 0; y0 < n_y; y0 += kFixThreads) {
    s_flag[tid] = y0 + tid < n_y && ne[y0 + tid] == cells;
    __syncthreads();
    for (int j = 0; j < kFixThreads && y0 + j < n_y; ++j) {
      if (!s_flag[j]) continue;  // the same shared word for every thread
      const int y = y0 + j;
      int colmin = INT_MAX;
      for (int s = 0; s < n_slabs; ++s) {
        const int c0 = s * slab, len = min(slab, cells - c0);
        count(y, c0, len);
        int v = INT_MAX;
        for (int c = tid; c < len; c += kFixThreads) v = min(v, s_cnt[c]);
        colmin = min(colmin, block_min(v, s_red));
      }
      if (n_slabs == 1) {
        write(y, 0, cells, colmin);
      } else {
        for (int s = 0; s < n_slabs; ++s) {
          const int c0 = s * slab, len = min(slab, cells - c0);
          count(y, c0, len);
          write(y, c0, len, colmin);
        }
      }
    }
    __syncthreads();
  }
}

// Pass 2, counts form: counts as above, and towers[b, id] += 1 for every
// valid point with tower[b, i] set. `tower` and `towers` may both be null
// (one channel).
__global__ void __launch_bounds__(kThreads)
count_pair_kernel(const float* __restrict__ pts, const uint8_t* __restrict__ mask,
                  const uint8_t* __restrict__ tower, const float* __restrict__ partials,
                  int* __restrict__ counts, int* __restrict__ towers, int N, int chunks,
                  int n_x, int n_y, int n_z) {
  __shared__ float s_q[6];
  const int b = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t pi = (size_t)b * N + i;
  float p[3];
  const bool valid = load_point(pts, mask, pi, i < N, p);  // in flight meanwhile
  sample_params(partials, b, chunks, n_x, n_y, n_z, s_q);
  if (!valid) return;
  const size_t size = (size_t)n_x * n_y * n_z;
  const size_t id = flat_bin_id(p, s_q, n_x, n_y, n_z);
  atomicAdd(counts + b * size + id, 1);
  if (tower != nullptr && tower[pi]) atomicAdd(towers + b * size + id, 1);
}

// Pass 2, ids form: ids[b, i] = the point's flat bin id, `invalid` where
// the mask is off (such a point's coordinates are never read).
__global__ void __launch_bounds__(kThreads)
ids_kernel(const float* __restrict__ pts, const uint8_t* __restrict__ mask,
           const float* __restrict__ partials, int* __restrict__ ids, int N, int chunks,
           int n_x, int n_y, int n_z, int invalid) {
  __shared__ float s_q[6];
  const int b = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t pi = (size_t)b * N + i;
  float p[3];
  const bool valid = load_point(pts, mask, pi, i < N, p);  // in flight meanwhile
  sample_params(partials, b, chunks, n_x, n_y, n_z, s_q);
  if (i >= N) return;
  ids[pi] = valid ? (int)flat_bin_id(p, s_q, n_x, n_y, n_z) : invalid;
}

bool bad_shape(int B, int N, int n_x, int n_y, int n_z, int chunks, int chunk_len) {
  return B <= 0 || N <= 0 || n_x <= 0 || n_y <= 0 || n_z <= 0 || chunks <= 0 ||
         B > 65535 || chunks > 65535 || chunk_len <= 0 || chunk_len % kUnit != 0 ||
         (long long)chunks * chunk_len < N;
}

// Four points a thread as three 16-byte loads and one 4-byte mask load?
int use_vec(const float* pts, const uint8_t* mask, int N) {
  return N % 4 == 0 && reinterpret_cast<size_t>(pts) % 16 == 0 &&
         reinterpret_cast<size_t>(mask) % 4 == 0;
}

// The shared bounds pass, zeroing `zero_a` / `zero_b` (words) on the way.
void launch_bounds(const float* pts, const uint8_t* mask, float* partials, int B, int N,
                   int chunks, int chunk_len, void* zero_a, size_t n_a, void* zero_b,
                   size_t n_b, cudaStream_t s) {
  const int vec = use_vec(pts, mask, N);
  bounds_kernel<<<dim3(chunks, B), kThreads, 0, s>>>(
      pts, mask, partials, N, chunk_len, vec, static_cast<uint32_t*>(zero_a), n_a,
      static_cast<uint32_t*>(zero_b), n_b);
}

// K1 (tower, out_t null) and K3: the bounds pass zeroes the bitmap(s) and
// nonempty, the mark pass sets the bits, the expand pass writes the
// grid(s), full_column_kernel rewrites occupancy's full columns.
int launch_occupancy(const float* pts, const uint8_t* mask, const uint8_t* tower, float* out,
                     float* out_t, uint32_t* bitmap, uint32_t* tbits, int* nonempty,
                     float* partials, int B, int N, int n_x, int n_y, int n_z, int chunks,
                     int chunk_len, int mark_len, cudaStream_t s) {
  if (bad_shape(B, N, n_x, n_y, n_z, chunks, chunk_len) || mark_len <= 0 ||
      mark_len % chunk_len != 0 || (tower != nullptr && tbits < bitmap))
    return (int)cudaErrorInvalidValue;
  const int mark_chunks = (int)(((long long)N + mark_len - 1) / mark_len);
  const unsigned size = (unsigned)n_x * n_y * n_z, total = size * (unsigned)B;
  const int wps = (int)((size + 31) / 32);  // bitmap words a sample
  if (tower == nullptr) tbits = nullptr;
  // one zeroed span: the occupancy bitmap, and the tower bitmap after it
  const size_t zeroed = (size_t)(tbits == nullptr ? bitmap : tbits) - (size_t)bitmap;
  launch_bounds(pts, mask, partials, B, N, chunks, chunk_len, bitmap,
                zeroed / sizeof(uint32_t) + (size_t)B * wps, nonempty, (size_t)B * n_y, s);
  const int shared_y = n_y <= kShareY;
  const size_t ne_bytes = shared_y ? sizeof(int) * n_y : 0;
  const int smem_bits = sizeof(uint32_t) * (size_t)wps + ne_bytes <= kMarkSmem;
  const int vec = use_vec(pts, mask, N) && reinterpret_cast<size_t>(tower) % 4 == 0;
  mark_kernel<<<dim3(mark_chunks, B), kThreads,
                (smem_bits ? sizeof(uint32_t) * wps : 0) + ne_bytes, s>>>(
      pts, mask, tower, partials, bitmap, tbits, nonempty, N, chunks, mark_len, n_x, n_y, n_z,
      wps, vec, smem_bits, shared_y);
  const int vec_out = size % 4 == 0 && reinterpret_cast<size_t>(out) % 16 == 0 &&
                      reinterpret_cast<size_t>(out_t) % 16 == 0;
  const unsigned blocks = ((vec_out ? total / 4 : total) + kThreads - 1) / kThreads;
  expand_kernel<<<blocks < 16384 ? blocks : 16384, kThreads, 0, s>>>(
      bitmap, tbits, out, out_t, size, total, wps, vec_out);
  const int cells = n_z * n_x;
  const int slab = cells < kSlab ? cells : kSlab;
  full_column_kernel<<<B, kFixThreads, sizeof(int) * slab, s>>>(
      pts, mask, partials, out, nonempty, N, chunks, n_x, n_y, n_z, slab);
  return (int)cudaGetLastError();
}

}  // namespace

// pts (B, N, 3) f32, mask (B, N) bool/uint8, out (B, n_z*n_x*n_y) f32 (any
// contents: every element is written). Scratch from the caller: bitmap of
// B*ceil(size/32) words, nonempty (B, n_y) int32 (both zeroed here),
// partials (B, chunks, 6) f32, where chunks * chunk_len >= N and chunk_len
// is a multiple of 1024 (ops/cuda_hist.py bounds_plan); the mark pass takes
// chunks of mark_len points, a multiple of chunk_len (mark_plan). Launches
// on `stream`; returns cudaGetLastError().
extern "C" int snt_points_occupancy(const float* pts, const uint8_t* mask, float* out,
                                    uint32_t* bitmap, int* nonempty, float* partials, int B,
                                    int N, int n_x, int n_y, int n_z, int chunks,
                                    int chunk_len, int mark_len, void* stream) {
  return launch_occupancy(pts, mask, nullptr, out, nullptr, bitmap, nullptr, nonempty, partials,
                          B, N, n_x, n_y, n_z, chunks, chunk_len, mark_len,
                          static_cast<cudaStream_t>(stream));
}

// pts (B, N, 3) f32, mask and tower (B, N) bool/uint8, out_x and out_y
// (B, n_z*n_x*n_y) f32 (any contents: every element is written): x is
// snt_points_occupancy's grid, y tower presence. Scratch as for
// snt_points_occupancy, and tbits, the tower bitmap of B*ceil(size/32)
// words, past the occupancy bitmap in the same allocation: the words from
// `bitmap` to the end of `tbits` are zeroed here. Launches on `stream`;
// returns cudaGetLastError().
extern "C" int snt_points_binary(const float* pts, const uint8_t* mask,
                                 const uint8_t* tower, float* out_x, float* out_y,
                                 uint32_t* bitmap, uint32_t* tbits, int* nonempty,
                                 float* partials, int B, int N, int n_x, int n_y, int n_z,
                                 int chunks, int chunk_len, int mark_len, void* stream) {
  if (tower == nullptr || out_y == nullptr || tbits == nullptr)
    return (int)cudaErrorInvalidValue;
  return launch_occupancy(pts, mask, tower, out_x, out_y, bitmap, tbits, nonempty, partials, B,
                          N, n_x, n_y, n_z, chunks, chunk_len, mark_len,
                          static_cast<cudaStream_t>(stream));
}

// pts (B, N, 3) f32, mask (B, N) bool/uint8, tower (B, N) bool/uint8 or null.
// counts (B, n_z*n_x*n_y) int32 ZEROED by the caller, towers the same or
// null (with a null `tower` a non-null `towers` stays all zero). On return
// both hold the counts as f32, converted in place. Scratch: partials as for
// snt_points_occupancy. Launches on `stream`; returns cudaGetLastError().
extern "C" int snt_points_bin_counts(const float* pts, const uint8_t* mask,
                                     const uint8_t* tower, int* counts,
                                     int* towers, float* partials, int B, int N,
                                     int n_x, int n_y, int n_z, int chunks, int chunk_len,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_shape(B, N, n_x, n_y, n_z, chunks, chunk_len) ||
      (tower != nullptr && towers == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t total = (size_t)n_x * n_y * n_z * B;
  launch_bounds(pts, mask, partials, B, N, chunks, chunk_len, nullptr, 0, nullptr, 0, s);
  dim3 cgrid((N + kThreads - 1) / kThreads, B);
  count_pair_kernel<<<cgrid, kThreads, 0, s>>>(pts, mask, tower, partials, counts, towers,
                                               N, chunks, n_x, n_y, n_z);
  counts_to_float_kernel<<<elementwise_blocks(total), 256, 0, s>>>(counts, total);
  if (towers != nullptr)
    counts_to_float_kernel<<<elementwise_blocks(total), 256, 0, s>>>(towers, total);
  return (int)cudaGetLastError();
}

// pts (B, N, 3) f32, mask (B, N) bool/uint8 -> ids (B, N) int32: each valid
// point's flat (z, x, y) bin id, `invalid` for the others. Scratch: partials
// as for snt_points_occupancy. Launches on `stream`; returns cudaGetLastError().
extern "C" int snt_flat_ids(const float* pts, const uint8_t* mask, int* ids,
                            float* partials, int B, int N, int n_x, int n_y,
                            int n_z, int invalid, int chunks, int chunk_len, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_shape(B, N, n_x, n_y, n_z, chunks, chunk_len)) return (int)cudaErrorInvalidValue;
  launch_bounds(pts, mask, partials, B, N, chunks, chunk_len, nullptr, 0, nullptr, 0, s);
  dim3 cgrid((N + kThreads - 1) / kThreads, B);
  ids_kernel<<<cgrid, kThreads, 0, s>>>(pts, mask, partials, ids, N, chunks, n_x, n_y, n_z,
                                        invalid);
  return (int)cudaGetLastError();
}
