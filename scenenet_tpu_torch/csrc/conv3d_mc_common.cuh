// Helpers shared by the multi-channel conv's sources (conv3d_mc.cu, the
// forward and input gradient; conv3d_mc_dw.cu, the weight gradient): the
// split of an f32 value into its TF32 part and a bf16 pair, the cp.async
// copies into shared memory, and the two mma.sync forms the split products
// run on.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace snt {

constexpr unsigned kTf32Mask = 0xFFFFE000u;  // sign, exponent, 10 mantissa bits

// two floats rounded to bf16 in one register: `even` in the low half (the
// even K slot of an mma fragment), `odd` in the high half
__device__ inline unsigned pack_bf16(float even, float odd) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(even, odd);
  return *reinterpret_cast<const unsigned*>(&p);
}

__device__ inline void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int bytes = ok ? 4 : 0;  // 0: the four bytes are filled with zeros
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}

__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// c (16 x 8, f32) += a (16 x 8, tf32, row) * b (8 x 8, tf32, col)
__device__ inline void mma_tf32(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

}  // namespace snt
