// Shared helpers of the port's CUDA kernels: dtype conversion to and from
// the f32 accumulator.  Kernels are templated on the storage type (float
// or __nv_bfloat16); every product is taken and summed in f32 and the
// result is rounded once, to nearest even, when it is stored.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace taseg {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store_f(float x, float* p) { *p = x; }
__device__ __forceinline__ void store_f(float x, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(x);
}

// dtype codes shared with the Python wrappers
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

}  // namespace taseg
