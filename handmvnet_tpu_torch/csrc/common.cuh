// What every kernel source of the port shares: the error-string entry each
// library exports. The tensor-core helpers are in mma.cuh.

#pragma once

#include <cuda_runtime.h>

extern "C" const char* hmv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
