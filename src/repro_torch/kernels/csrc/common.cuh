// Shared by every kernel library of the port: includes and the error
// string the Python loader reads after a failed launch.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace repro {

__device__ __forceinline__ void store_out(float* dst, float v) { *dst = v; }

__device__ __forceinline__ void store_out(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16(v);   // round to nearest even, as astype does
}

__device__ __forceinline__ __nv_bfloat16 bf16_zero() {
  return __float2bfloat16(0.0f);
}

}  // namespace repro
