// Shared definitions of the port's hand-written kernels.
//
// Every kernel source exposes plain C entry points (loaded with ctypes by
// rt_octree_tpu_torch/native/build.py).  An entry launches on the stream
// it is given, allocates nothing, and returns cudaGetLastError() so that a
// refused launch raises in the Python wrapper.
#pragma once

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#define RT_API extern "C" __attribute__((visibility("default")))

namespace rt {

// Packed jump-LUT entry: (depth << 27 | ptr); depth 31 marks a cell that is
// still internal at the LUT level (rt_octree_tpu/ops/traversal.py:24-25).
constexpr int kLutPtrBits = 27;
constexpr int kLutDepthSentinel = 31;
constexpr uint32_t kLutPtrMask = (1u << kLutPtrBits) - 1u;

// int32 power for small bases and exponents (grid resolutions).
__host__ __device__ __forceinline__ int ipow(int base, int exp) {
  int out = 1;
  for (int i = 0; i < exp; ++i) out *= base;
  return out;
}

}  // namespace rt
