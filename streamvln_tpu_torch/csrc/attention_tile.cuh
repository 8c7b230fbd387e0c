// Shared helpers of the port's attention kernels: the constants and the
// mma.sync / bf16 packing helpers of the backward kernels K4/K5
// (flash_attention_bwd.cu), which one block of 4 warps runs over 64-row
// query and 64-key tiles; the forward's pack_bf16 and constants
// (attention_fwd.cuh) come from here too.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace svt {

constexpr int kBQ = 64;            // query rows per block (4 warps x 16)
constexpr int kBK = 64;            // keys per tile
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;
constexpr int kInvalidPos = 1 << 30;

__device__ __forceinline__ void mma_bf16_16816(float* c, uint32_t a0,
                                               uint32_t a1, uint32_t a2,
                                               uint32_t a3, uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

}  // namespace svt
