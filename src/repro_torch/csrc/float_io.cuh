// Loads and stores of the element types the LM kernels take (float32 and
// bf16), converted to and from float32, the type they compute in.  Shared
// by swa_attention.cu and ssd_scan.cu.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fio {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

}  // namespace fio
