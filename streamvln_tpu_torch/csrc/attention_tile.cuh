// Shared helpers of the port's attention kernels (attention_fwd.cuh and
// flash_attention_bwd.cu): the masked-score and invalid-position constants
// and the bf16 packing of two f32 values.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace svt {

constexpr float kNegInf = -1e30f;
constexpr int kInvalidPos = 1 << 30;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

}  // namespace svt
