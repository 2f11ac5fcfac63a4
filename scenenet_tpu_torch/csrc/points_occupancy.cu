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
//     the density and tower-fraction grids (f32 atomics straight into the
//     outputs);
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
// The counts (snt_points_bin_counts, K6) carry K7's float route over
// (bin_counts.cu): both f32 grids are one allocation, zeroed by the bounds
// pass through its zero_a / zero_b arguments, and count_kernel adds 1.0f
// into them by atomics nobody waits for, one a valid point and one more a
// flagged one, exact while no voxel can pass 2^24 points. Two launches and
// no convert pass; past 2^24 points a sample (ops/cuda_hist.py
// points_bin_counts_route) int32 atomics into the same memory and one pass
// that converts both grids in place. count_kernel walks the bounds pass's
// chunks, four points a thread (load4, load_flags4, the flags gated by the
// mask), the next four in flight, and reduces its sample's partials once a
// block. The previous design: two torch.zeros fills of int32 grids, the
// bounds pass, one thread a point (4096 blocks at B=16, each reducing 64
// partials first) and two in-place convert passes: six operations, every
// grid written three times.
//
// K6's count pass and K9's ids pass are launched as programmatic
// dependents of the bounds pass (launch_after), which triggers them as its
// blocks start: their blocks take the SMs as the bounds blocks leave, load
// their first points (inputs the bounds pass does not write) and wait
// (griddepcontrol.wait) for the whole bounds pass, its partials and K6's
// zeroed grids, before reading them. A CUDA graph keeps the edge.
//
// The ids (snt_flat_ids, K9): the bounds pass, then ids_kernel over whole
// runs of bounds chunks (mark_plan, as K1's and K3's mark pass: 3072
// points a block at B=16), four points a thread and their ids as one
// 16-byte store where N % 4 == 0 and the pointers are aligned, else point by
// point; masked points get `invalid` and their coordinates never reach an
// id. The previous design: one point a thread, 4-byte loads and stores,
// 4096 blocks at B=16 each reducing 64 partials before writing 256 ids.
//
// What the measurements said for K6 and K9 (NVIDIA H100 80GB HBM3, 700 W,
// inside a CUDA graph, 64^3; points_dk_times.py --kernels k6,k9 --passes,
// throwaway builds of the variants, each beside the previous design in the
// same call). K6 at B=16, N=65536, two channels, 30% tower points: the
// previous design 0.0721-0.0736 ms (fills 2x0.0053, bounds 0.0082, counts
// 0.0239, converts 2x0.0151); a memset of the one allocation, the bounds
// pass and the count pass over mark_plan's 3072-point chunks 0.0438-0.0454
// (memset 0.0093; bounds 0.0080, as the memset evicts the points: K9's
// bounds pass over the same shape takes 0.0040; counts 0.0249); the same
// with the count pass over the 1024-point bounds chunks 0.0422-0.0424
// (4096 points a block 0.0456, 7168 0.0490); the bounds pass before the
// memset 0.0412; the bounds pass zeroing both grids and the count pass
// over the bounds chunks, 0.0403-0.0407 (bounds and zeroing 0.0149: 47 MB,
// 3.2 TB/s; counts 0.0237), 0.0373-0.0374 on the smoke's inputs (20% tower
// points); kept, with the dependent launch below. Streaming loads of the
// points in the count pass: 0.0404-0.0405, no gain. One point a thread,
// four in flight (lane-strided loads): 0.0457 against 0.0454. A
// block-local table of the voxels of each 1024-point step in shared memory
// (2048 slots, atomicCAS then shared adds, one global atomic a voxel a
// step) to merge repeats: 0.0437 against 0.0404, and 0.0530 against 0.0436
// on a uniform cloud. On that cloud (no repeats) the design above takes
// 0.0436: what holds the count pass is the L2's f32 atomics, about 56 G a
// second here, more distinct lines costing more. B=1
// (131072 padded points): 0.0077 against 0.0135-0.0136. K9 at B=16: the
// previous design 0.0131-0.0133 (bounds 0.0040, ids 0.0080); this one
// 0.0104-0.0107 (ids 0.0053), over 1024-point chunks 0.0121, over 7168
// 0.0124; B=1 0.0057-0.0079 against 0.0058-0.0065, 128^3 B=4 0.0082-0.0086
// against 0.0083-0.0085. A one-read design, a thread-block cluster of 8
// blocks of 1024 threads a sample that stages its points in shared memory
// (16384 points a block at most), reduces the bounds through distributed
// shared memory and writes the ids from the staged points: 0.0168 at
// B=16, 0.0124 at B=1 and at 128^3 B=4, against 0.0120, 0.0058 and 0.0082
// for the two passes in the same call; a cooperative grid whose blocks
// hold their four points a thread in registers across a grid barrier (the
// bounds and the ids in one launch where the bounds chunk is one step,
// capped at 32 registers for eight blocks an SM: spills): 0.0127-0.0128 at
// B=16, 0.0060-0.0072 at B=1, 0.0084-0.0087 at 128^3 B=4, against 0.0106,
// 0.0057-0.0060 and 0.0078-0.0079: neither kept. What holds K9 at B=16:
// the shared bounds pass (0.0040) and a second launch; the ids pass moves
// 17.6 MB in 0.0053 (3.3 TB/s, from the L2). The dependent launch, kept
// (same call, against the plain launches): K6 0.0383-0.0389 against
// 0.0402 at B=16, 0.0069 against 0.0077 at B=1; K9 0.0101 against 0.0104
// at B=16, 0.0051-0.0057 against 0.0057-0.0058 at B=1, 0.0068-0.0071
// against 0.0081 at 128^3 B=4; without the bounds pass's early trigger (the
// dependents launched as its blocks exit) 0.0400 and 0.0102.
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
  // a second pass launched as this one's programmatic dependent (K6, K9)
  // may take the SMs as these blocks leave; it waits for all of them
  asm volatile("griddepcontrol.launch_dependents;");
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

// The count pass of K6 (the float route, kFloat): counts[b, id] += 1.0f for
// every valid point and towers[b, id] += 1.0f for every valid point whose
// tower flag is set (the mask gates the flag), by f32 atomics straight into
// the outputs the bounds pass zeroed: exact while no voxel can pass 2^24
// points. The exact route (kFloat false, past 2^24 points a sample) adds
// int32 ones into the same memory, converted in place afterwards. `tower`
// and `towers` may be null (one channel, or no flags: towers stays zero).
// Grid (chunks, B): the bounds pass's chunks of chunk_len points, walked in
// its reverse order, so that the first blocks read the points the L2 still
// holds. Four points a thread a step (load4, load_flags4), the next four in
// flight while it counts.
template <bool kFloat>
__global__ void __launch_bounds__(kThreads)
count_kernel(const float* __restrict__ pts, const uint8_t* __restrict__ mask,
             const uint8_t* __restrict__ tower, const float* __restrict__ partials,
             float* __restrict__ counts, float* __restrict__ towers, int N, int chunk_len,
             int n_x, int n_y, int n_z, int vec) {
  __shared__ float s_q[6];
  const int chunks = gridDim.x;
  const int b = gridDim.y - 1 - blockIdx.y, chunk = chunks - 1 - blockIdx.x;
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
  asm volatile("griddepcontrol.wait;" ::: "memory");  // the bounds pass done: partials, zeros
  sample_params(partials, b, chunks, n_x, n_y, n_z, s_q);
  const size_t size = (size_t)n_x * n_y * n_z;
  float* c = counts + (size_t)b * size;
  float* w = towers == nullptr ? nullptr : towers + (size_t)b * size;
  auto add = [](float* at) {
    if (kFloat)
      atomicAdd(at, 1.0f);
    else
      atomicAdd(reinterpret_cast<int*>(at), 1);
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
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (mm[j]) add(c + id[j]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (tt[j]) add(w + id[j]);
  }
}

// K9's ids pass: ids[b, i] = the point's flat bin id, `invalid` where the
// mask is off (such a point's coordinates never reach an id). Grid (pass
// chunks, B): chunks of pass_len points, whole chunks of the bounds plan
// (ops/cuda_hist.py mark_plan; `chunks` is the bounds pass's count, for the
// partials), walked in the reverse order of the bounds pass. Four points a
// thread a step, the next four in flight, their ids written as one 16-byte
// store where vec (then the ids are 16-byte aligned too), else point by
// point.
__global__ void __launch_bounds__(kThreads)
ids_kernel(const float* __restrict__ pts, const uint8_t* __restrict__ mask,
           const float* __restrict__ partials, int* __restrict__ ids, int N, int chunks,
           int pass_len, int n_x, int n_y, int n_z, int invalid, int vec) {
  __shared__ float s_q[6];
  const int b = gridDim.y - 1 - blockIdx.y, chunk = gridDim.x - 1 - blockIdx.x;
  const size_t base = (size_t)b * N;
  int i0 = chunk * pass_len + 4 * threadIdx.x;
  const int end = (int)min((long long)N, (long long)(chunk + 1) * pass_len);
  float p[4][3];
  bool m[4] = {false, false, false, false};
  bool have = i0 < end;
  if (have) load4(pts, mask, base, N, i0, vec, p, m);  // in flight meanwhile
  asm volatile("griddepcontrol.wait;" ::: "memory");  // the bounds pass done: partials
  sample_params(partials, b, chunks, n_x, n_y, n_z, s_q);
  while (have) {
    int id[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) id[j] = m[j] ? (int)flat_bin_id(p[j], s_q, n_x, n_y, n_z) : invalid;
    const int at = i0;
    i0 += kUnit;
    have = i0 < end;
    if (have) load4(pts, mask, base, N, i0, vec, p, m);
    if (vec) {
      *reinterpret_cast<int4*>(ids + base + at) = make_int4(id[0], id[1], id[2], id[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (at + j < end) ids[base + at + j] = id[j];
    }
  }
}

// Launch `kernel` on (grid, kThreads) so that it may start while the kernel
// before it on the stream drains (programmatic dependent launch): it reads
// only its inputs until its griddepcontrol.wait.
template <typename... Params, typename... Args>
cudaError_t launch_after(void (*kernel)(Params...), dim3 grid, cudaStream_t s, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
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
// counts (B, n_z*n_x*n_y) f32 of any contents, towers null or the same grid
// right after it in one allocation (with a null `tower` a non-null `towers`
// is all zero): the bounds pass zeroes both. Scratch: partials as for
// snt_points_occupancy; the count pass takes the bounds pass's chunks.
// exact == 0: the float route (N <= 2^24), f32 atomics straight into the
// outputs: two launches. exact == 1: int32 atomics into the same memory and
// one pass that converts it to f32 in place: three launches. Nothing waits
// for the host. Launches on `stream`; returns cudaGetLastError().
extern "C" int snt_points_bin_counts(const float* pts, const uint8_t* mask,
                                     const uint8_t* tower, float* counts, float* towers,
                                     float* partials, int B, int N, int n_x, int n_y, int n_z,
                                     int chunks, int chunk_len, int exact, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t total = (size_t)n_x * n_y * n_z * B;
  if (bad_shape(B, N, n_x, n_y, n_z, chunks, chunk_len) ||
      (tower != nullptr && towers == nullptr) ||
      (towers != nullptr && towers != counts + total) || (exact == 0 && N > (1 << 24)))
    return (int)cudaErrorInvalidValue;
  const size_t grids = (towers == nullptr ? 1 : 2) * total;
  launch_bounds(pts, mask, partials, B, N, chunks, chunk_len, counts, grids, nullptr, 0, s);
  const int vec = use_vec(pts, mask, N) && reinterpret_cast<size_t>(tower) % 4 == 0;
  const cudaError_t e =
      launch_after(exact == 0 ? count_kernel<true> : count_kernel<false>, dim3(chunks, B), s, pts,
                   mask, tower, (const float*)partials, counts, towers, N, chunk_len, n_x, n_y,
                   n_z, vec);
  if (e != cudaSuccess || exact == 0) return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
  counts_to_float_kernel<<<elementwise_blocks(grids), 256, 0, s>>>(reinterpret_cast<int*>(counts),
                                                                   grids);
  return (int)cudaGetLastError();
}

// pts (B, N, 3) f32, mask (B, N) bool/uint8 -> ids (B, N) int32: each valid
// point's flat (z, x, y) bin id, `invalid` for the others. Scratch: partials
// as for snt_points_occupancy; the ids pass takes chunks of pass_len points,
// a multiple of chunk_len (ops/cuda_hist.py mark_plan). Two launches on
// `stream`; returns cudaGetLastError().
extern "C" int snt_flat_ids(const float* pts, const uint8_t* mask, int* ids,
                            float* partials, int B, int N, int n_x, int n_y,
                            int n_z, int invalid, int chunks, int chunk_len, int pass_len,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_shape(B, N, n_x, n_y, n_z, chunks, chunk_len) || pass_len <= 0 ||
      pass_len % chunk_len != 0)
    return (int)cudaErrorInvalidValue;
  launch_bounds(pts, mask, partials, B, N, chunks, chunk_len, nullptr, 0, nullptr, 0, s);
  const int vec = use_vec(pts, mask, N) && reinterpret_cast<size_t>(ids) % 16 == 0;
  const dim3 grid((unsigned)(((long long)N + pass_len - 1) / pass_len), B);
  const cudaError_t e = launch_after(ids_kernel, grid, s, pts, mask, (const float*)partials, ids,
                                     N, chunks, pass_len, n_x, n_y, n_z, invalid, vec);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}
