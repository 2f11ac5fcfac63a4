// Helpers shared by the histogram sources (points_occupancy.cu,
// bin_counts.cu): the launch width of an elementwise pass and the final
// pass that turns int32 counts into the f32 the callers get.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace snt {

inline int elementwise_blocks(size_t total) {
  const size_t blocks = (total + 255) / 256;
  return (int)(blocks < 65536 ? blocks : 65536);
}

// Final pass of the counts kernels: int32 counts -> f32, in place. The
// wrapper hands out the same memory viewed as float32, so a count grid is
// written once by the atomics and once here, and no second grid exists.
// A count is exact in f32 up to 2^24 points in one voxel.
static __global__ void counts_to_float_kernel(int* buf, size_t total) {
  float* out = reinterpret_cast<float*>(buf);
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int v = buf[i];
    out[i] = (float)v;
  }
}

}  // namespace snt
