// Bench copy, not part of the kernel library: the bf16 form of the
// multi-channel conv with the other staging design, kept to time it against
// the library's form in one run (csrc/bench/conv_mc_bf16_times.py). Each
// halo row of a chunk's 16 channels is copied planar by cp.async (16-byte
// middle copies from the tile's aligned y0, a 4-byte copy for each edge
// pair) into a raw ring of two buffers, and the mma loop reads that raw tile
// itself: each A-fragment register is two 16-bit loads (channels 2t and
// 2t + 1 of one voxel) joined by __byte_perm, eight loads an m16 tile and tap
// where the library's form, which pairs the channels in shared memory once a
// chunk, makes four 32-bit loads. Weights, plan, accumulation and K-split
// reduction are the library's. Entry snt_fragpair_conv3d_mc_tc_bf16 takes the
// arguments of snt_conv3d_mc_tc_bf16.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ inline void store_out(float* o, float v) { *o = v; }
__device__ inline void store_out(__nv_bfloat16* o, float v) { *o = __float2bfloat16_rn(v); }

constexpr int kTcThreads = 256;
__device__ inline void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ inline void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// out[i] = partial[0][i] + partial[1][i] + ... in that order (O: float, or
// __nv_bfloat16 for the bf16 form, rounded once).
template <class O>
__global__ void conv3d_mc_reduce_kernel(const float* __restrict__ partial,
                                        O* __restrict__ out, long long n, int k_splits) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    float s = partial[i];
    for (int k = 1; k < k_splits; ++k) s += partial[(long long)k * n + i];
    store_out(out + i, s);
  }
}

constexpr int kKb = 16;  // input channels per bf16 chunk: the K of one bf16 mma


template <int TB_, int TZ_, int TX_, int TY_, int BN_>
struct TileP {
  static constexpr int TB = TB_, TZ = TZ_, TX = TX_, TY = TY_, BN = BN_;
  static constexpr int HZ = TZ + 2, HX = TX + 2, HY = TY + 2;
  static constexpr int VOX = TB * TZ * TX * TY;
  static constexpr int NTB = BN / 8;
  static constexpr int NT = BN == 64 ? 8 : 4;
  static constexpr int MT = 16 / NT;
  static constexpr int WN = BN / (8 * NT);
  static constexpr int WM = 8 / WN;
  static constexpr int ROWS = TB * HZ * HX;
  static constexpr int U = TY >= 8 ? 4 : 2;        // words of one middle copy
  static constexpr int MID = TY / 2;
  static constexpr int NW = MID + 2;               // words of a row: edge, middle, edge
  // word w of a row at word U - 1 + w, so that the middle (w = 1 ..) is aligned
  static constexpr int RW = (U - 1 + NW + U - 1) / U * U;
  static constexpr int RE = 2 * RW;                // row stride in elements
  // channel stride in elements, 8 mod 64: channels 2t of the four t of a warp
  // fall in four different groups of banks
  static constexpr int CHS = (ROWS * RE + 63) / 64 * 64 + 8;
  static constexpr int RAW = kKb * CHS / 2;        // words of one raw buffer
  static constexpr int WSTAGE = 27 * (BN / 16) * 32;  // uint4 of one chunk's weights
  static constexpr size_t SMEM = sizeof(uint4) * 2 * WSTAGE + sizeof(unsigned) * 2 * RAW +
                                 sizeof(int) * ROWS;
  static_assert(WM * MT * 16 == VOX, "the warps must cover the tile");
  static_assert(MID % U == 0 && (CHS / 2) % U == 0, "aligned copies");
};

// cp.async of N bytes (4, 8 or 16), the destination zero-filled where !ok
template <int N>
__device__ inline void cp_async_zfill(void* dst, const void* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int bytes = ok ? N : 0;
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(bytes) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src), "n"(N),
                 "r"(bytes) : "memory");
  }
}

// bf16 weights (any strides, raw 16-bit words) -> B fragments of the bf16 mma.
// Entry (((cot * nc + c) * 27 + tap) * (BN / 16) + jj) * 32 + lane holds, for
// the lane's g = lane / 4 and t = lane % 4, the B fragments (b0, b1) of n8
// tiles 2 jj and 2 jj + 1: output channel co = cot * BN + 8 j + g, b0 the
// input channels ci = 16 c + 2 t and ci + 1 of w[co, ci, tap] (low half, high
// half), b1 those of ci + 8; zero past C_in or C_out.
__global__ void conv3d_mc_pack_bf16_kernel(const unsigned short* __restrict__ w,
                                           uint4* __restrict__ frag, int C_in, int C_out,
                                           long long s_co, long long s_ci, long long s_dz,
                                           long long s_dx, long long s_dy, int bn, int nc,
                                           long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int lane = (int)(i & 31);
  long long r = i >> 5;
  const int njj = bn / 16;
  const int jj = (int)(r % njj);
  r /= njj;
  const int tap = (int)(r % 27);
  r /= 27;
  const int c = (int)(r % nc);
  const int cot = (int)(r / nc);
  const int g = lane >> 2, t = lane & 3;
  const long long toff = (tap / 9) * s_dz + ((tap / 3) % 3) * s_dx + (tap % 3) * s_dy;
  unsigned q[4];
#pragma unroll
  for (int h = 0; h < 4; ++h) {  // b0, b1 of n8 tile 2 jj, then of 2 jj + 1
    const int co = cot * bn + 8 * (2 * jj + h / 2) + g;
    const int ci = kKb * c + 2 * t + 8 * (h % 2);
    unsigned lo = 0, hi = 0;
    if (co < C_out) {
      const unsigned short* p = w + co * s_co + toff;
      if (ci < C_in) lo = p[ci * s_ci];
      if (ci + 1 < C_in) hi = p[(ci + 1) * s_ci];
    }
    q[h] = lo | hi << 16;
  }
  frag[i] = make_uint4(q[0], q[1], q[2], q[3]);
}

template <class T>
__global__ void __launch_bounds__(kTcThreads, 1)
conv3d_mc_fragpair_kernel(const unsigned short* __restrict__ x, const uint4* __restrict__ wfrag,
                          void* __restrict__ dst_raw, int B, int C_in, int C_out, int Z, int X,
                          int Y, int tiles_z, int tiles_x, int tiles_y, int co_tiles,
                          int k_splits, int nc, int aligned) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint4* wbuf = reinterpret_cast<uint4*>(smem_raw);
  unsigned* raw = reinterpret_cast<unsigned*>(wbuf + 2 * T::WSTAGE);
  int* rtab = reinterpret_cast<int*>(raw + 2 * T::RAW);

  int bid = blockIdx.x;
  const int cot = bid % co_tiles;
  bid /= co_tiles;
  const int ks = bid % k_splits;
  bid /= k_splits;
  const int y0 = (bid % tiles_y) * T::TY;
  bid /= tiles_y;
  const int x0 = (bid % tiles_x) * T::TX;
  bid /= tiles_x;
  const int z0 = (bid % tiles_z) * T::TZ;
  const int b0 = (bid / tiles_z) * T::TB;
  const int c_begin = (int)((long long)ks * nc / k_splits);
  const int c_end = (int)((long long)(ks + 1) * nc / k_splits);
  const int V = Z * X * Y;
  const int tid = threadIdx.x;
  float* const partial = static_cast<float*>(dst_raw) + (long long)ks * B * C_out * V;
  __nv_bfloat16* const out = static_cast<__nv_bfloat16*>(dst_raw);

  for (int r = tid; r < T::ROWS; r += kTcThreads) {
    const int lb = r / (T::HZ * T::HX);
    const int gz = z0 - 1 + (r / T::HX) % T::HZ, gx = x0 - 1 + r % T::HX;
    const bool ok = b0 + lb < B && gz >= 0 && gz < Z && gx >= 0 && gx < X;
    rtab[r] = ok ? lb * C_in * V + (gz * X + gx) * Y : -1;
  }
  __syncthreads();
  const unsigned short* xb = x + (long long)b0 * C_in * V;

  // as the library's form, a thread a halo row of one channel at a time, but
  // the row's words in their natural order: word w at U - 1 + w
  auto fill_x = [&](int c) {
    unsigned* rd = raw + (c & 1) * T::RAW;
    const unsigned short* xc = xb + (long long)kKb * c * V;
    const int nch = min(kKb, C_in - kKb * c);
    for (int q = tid; q < kKb * T::ROWS; q += kTcThreads) {
      const int ch = q / T::ROWS, row = q - ch * T::ROWS;
      const int base = rtab[row];
      const bool row_ok = base >= 0 && ch < nch;
      const unsigned short* src = xc + (long long)ch * V + (row_ok ? base : 0);
      unsigned* d = rd + ch * (T::CHS / 2) + row * T::RW + T::U - 1;  // word 0 of the row
      if (aligned) {
#pragma unroll
        for (int k = 0; k < T::MID / T::U; ++k) {
          const int y = y0 + 2 * T::U * k;
          const bool ok = row_ok && y < Y;
          cp_async_zfill<4 * T::U>(d + 1 + T::U * k, ok ? src + y : x, ok);
        }
        const bool lo = row_ok && y0 > 0, hi = row_ok && y0 + T::TY < Y;
        cp_async_zfill<4>(d, lo ? src + y0 - 2 : x, lo);
        cp_async_zfill<4>(d + T::NW - 1, hi ? src + y0 + T::TY : x, hi);
      } else {
#pragma unroll
        for (int w = 0; w < T::NW; ++w) {
          const int gy = y0 - 2 + 2 * w;
          unsigned v = 0;
          if (row_ok && gy >= 0 && gy < Y) v = src[gy];
          if (row_ok && gy + 1 >= 0 && gy + 1 < Y) v |= (unsigned)src[gy + 1] << 16;
          d[w] = v;
        }
      }
    }
  };

  auto fill_w = [&](int c) {
    const uint4* src = wfrag + (long long)(cot * nc + c) * T::WSTAGE;
    uint4* wd = wbuf + (c & 1) * T::WSTAGE;
    for (int i = tid; i < T::WSTAGE; i += kTcThreads) cp_async16(wd + i, src + i);
  };

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % T::WM, wn = warp / T::WM;

  // element offsets of the lane's voxels in a channel's raw rows: halo y at
  // element 2U - 1 + hy of its row
  int voff[T::MT][2];
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int slot = (wm * T::MT + mt) * 16 + g + 8 * h;
      const int ly = slot % T::TY;
      const int lx = (slot / T::TY) % T::TX;
      const int lz = (slot / (T::TY * T::TX)) % T::TZ;
      const int lb = slot / (T::TY * T::TX * T::TZ);
      voff[mt][h] = ((lb * T::HZ + lz) * T::HX + lx) * T::RE + 2 * T::U - 1 + ly;
    }
  }

  float acc[T::MT][T::NT][4], part[T::MT][T::NT][4];
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt) {
#pragma unroll
    for (int j = 0; j < T::NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.0f;
    }
  }

  // as the library's form: a stage is a chunk, copied a stage ahead
  fill_w(c_begin);
  fill_x(c_begin);
  cp_async_commit();
  for (int c = c_begin; c < c_end; ++c) {
    if (c + 1 < c_end) {
      fill_w(c + 1);
      fill_x(c + 1);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt) {
#pragma unroll
      for (int j = 0; j < T::NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mt][j][e] = 0.0f;
      }
    }
#pragma unroll 1
    for (int dz = 0; dz < 3; ++dz) {
      const unsigned short* xa = reinterpret_cast<const unsigned short*>(raw + (c & 1) * T::RAW) +
                                 2 * t * T::CHS + dz * (T::HX * T::RE);
      const uint4* ws = wbuf + (c & 1) * T::WSTAGE + dz * 9 * (T::NTB / 2) * 32 +
                        (wn * T::NT / 2) * 32 + lane;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int toff = (tap / 3) * T::RE + (tap % 3);
        uint4 bq[T::NT / 2];
#pragma unroll
        for (int jj = 0; jj < T::NT / 2; ++jj) bq[jj] = ws[(tap * (T::NTB / 2) + jj) * 32];
#pragma unroll
        for (int mt = 0; mt < T::MT; ++mt) {
          const int v0 = voff[mt][0] + toff, v1 = voff[mt][1] + toff;
          const unsigned a[4] = {
              __byte_perm(xa[v0], xa[T::CHS + v0], 0x5410),
              __byte_perm(xa[v1], xa[T::CHS + v1], 0x5410),
              __byte_perm(xa[8 * T::CHS + v0], xa[9 * T::CHS + v0], 0x5410),
              __byte_perm(xa[8 * T::CHS + v1], xa[9 * T::CHS + v1], 0x5410)};
#pragma unroll
          for (int jj = 0; jj < T::NT / 2; ++jj) {
            mma_bf16(part[mt][2 * jj], a, bq[jj].x, bq[jj].y);
            mma_bf16(part[mt][2 * jj + 1], a, bq[jj].z, bq[jj].w);
          }
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt) {
#pragma unroll
      for (int j = 0; j < T::NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] += part[mt][j][e];
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int slot = (wm * T::MT + mt) * 16 + g + 8 * h;
      const int oy = y0 + slot % T::TY;
      const int ox = x0 + (slot / T::TY) % T::TX;
      const int oz = z0 + (slot / (T::TY * T::TX)) % T::TZ;
      const int ob = b0 + slot / (T::TY * T::TX * T::TZ);
      if (ob >= B || oz >= Z || ox >= X || oy >= Y) continue;
      const long long ooff = (long long)ob * C_out * V + ((long long)oz * X + ox) * Y + oy;
#pragma unroll
      for (int j = 0; j < T::NT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int co = cot * T::BN + (wn * T::NT + j) * 8 + 2 * t + e;
          if (co >= C_out) continue;
          if (k_splits > 1) {
            partial[ooff + (long long)co * V] = acc[mt][j][2 * h + e];
          } else {
            store_out(out + ooff + (long long)co * V, acc[mt][j][2 * h + e]);
          }
        }
      }
    }
  }
}

template <class T>
int launch_fragpair(const unsigned short* x, const uint4* frag, __nv_bfloat16* out,
                    float* partial, int B, int C_in, int C_out, int Z, int X, int Y,
                    int k_splits, cudaStream_t s) {
  const long long V = (long long)Z * X * Y;
  const long long tiles_z = (Z + T::TZ - 1) / T::TZ, tiles_x = (X + T::TX - 1) / T::TX,
                  tiles_y = (Y + T::TY - 1) / T::TY, tiles_b = (B + T::TB - 1) / T::TB,
                  co_tiles = (C_out + T::BN - 1) / T::BN;
  const int nc = (C_in + kKb - 1) / kKb;
  const long long blocks = tiles_b * tiles_z * tiles_x * tiles_y * co_tiles * k_splits;
  if (blocks > 2147483647LL || k_splits < 1 || k_splits > nc ||
      (long long)T::TB * C_in * V > 2147483647LL || (k_splits > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(conv3d_mc_fragpair_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)T::SMEM);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int aligned = Y % (2 * T::U) == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  void* dst = k_splits > 1 ? static_cast<void*>(partial) : static_cast<void*>(out);
  conv3d_mc_fragpair_kernel<T><<<(unsigned)blocks, kTcThreads, T::SMEM, s>>>(
      x, frag, dst, B, C_in, C_out, Z, X, Y, (int)tiles_z, (int)tiles_x, (int)tiles_y,
      (int)co_tiles, k_splits, nc, aligned);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || k_splits == 1) return (int)e;
  const long long n = (long long)B * C_out * V;
  const int rblocks = (int)((n + 255) / 256 < 2048 ? (n + 255) / 256 : 2048);
  conv3d_mc_reduce_kernel<__nv_bfloat16><<<rblocks, 256, 0, s>>>(partial, out, n, k_splits);
  return (int)cudaGetLastError();
}

int launch_pack_bf16(const unsigned short* w, uint4* frag, int C_in, int C_out, long long s_co,
              long long s_ci, long long s_dz, long long s_dx, long long s_dy, int bn,
              cudaStream_t s) {
  const int nc = (C_in + kKb - 1) / kKb;
  const long long co_tiles = (C_out + bn - 1) / bn;
  const long long total = co_tiles * nc * 27 * (bn / 16) * 32;
  conv3d_mc_pack_bf16_kernel<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
      w, frag, C_in, C_out, s_co, s_ci, s_dz, s_dx, s_dy, bn, nc, total);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int snt_fragpair_conv3d_mc_tc_bf16(const void* x, const void* w, void* frag,
                                              void* out, float* partial, int B, int C_in,
                                              int C_out, int Z, int X, int Y, long long s_co,
                                              long long s_ci, long long s_dz, long long s_dx,
                                              long long s_dy, int tile, int k_splits,
                                              void* stream) {
  if (B <= 0 || C_in <= 0 || C_out <= 0 || Z <= 0 || X <= 0 || Y <= 0 || tile < 0 || tile > 3 ||
      (long long)Z * X * Y > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int e = launch_pack_bf16(static_cast<const unsigned short*>(w), static_cast<uint4*>(frag),
                                 C_in, C_out, s_co, s_ci, s_dz, s_dx, s_dy, tile < 2 ? 32 : 64,
                                 s);
  if (e != 0) return e;
  const unsigned short* xs = static_cast<const unsigned short*>(x);
  const uint4* f = static_cast<const uint4*>(frag);
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  switch (tile) {
    case 0:
      return launch_fragpair<TileP<1, 4, 8, 16, 32>>(xs, f, o, partial, B, C_in, C_out, Z, X, Y,
                                                      k_splits, s);
    case 1:
      return launch_fragpair<TileP<1, 8, 8, 8, 32>>(xs, f, o, partial, B, C_in, C_out, Z, X, Y,
                                                     k_splits, s);
    case 2:
      return launch_fragpair<TileP<1, 4, 8, 8, 64>>(xs, f, o, partial, B, C_in, C_out, Z, X, Y,
                                                     k_splits, s);
    default:
      return launch_fragpair<TileP<4, 4, 4, 4, 64>>(xs, f, o, partial, B, C_in, C_out, Z, X, Y,
                                                     k_splits, s);
  }
}
