// Loads of the sweep constants (c, g), which are stored in float32 or in
// bfloat16 (FlowParams.terms_dtype). bfloat16 is storage only: a value is
// widened as it is loaded (exactly: bfloat16 is the top half of a float32)
// and all arithmetic stays in float32, as in the plain versions.

#pragma once

#include <cuda_bf16.h>

__device__ __forceinline__ float load_term(const float* p, long long i) {
  return p[i];
}

__device__ __forceinline__ float load_term(const __nv_bfloat16* p,
                                           long long i) {
  return __bfloat162float(p[i]);
}
