// Helpers shared by the port's kernel sources: the element load and store of
// the CUDA-core (fp32) kernels, and the error-string entry every library
// exports. The bf16 kernels use the tensor-core helpers of mma.cuh.

#pragma once

#include <cuda_runtime.h>

namespace {

// Elements are loaded as raw bits and widened when stored to shared memory,
// with nothing between the loads to keep the compiler from issuing them all
// at once (for f32 the widening is the identity).
template <typename T>
struct Raw;
template <>
struct Raw<float> {
  using type = float;
  static __device__ __forceinline__ float f32(float x) { return x; }
};

__device__ __forceinline__ void store(float* p, float x) { *p = x; }

}  // namespace

extern "C" const char* hmv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
