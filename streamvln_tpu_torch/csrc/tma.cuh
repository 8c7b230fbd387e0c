// TMA (the Hopper tensor memory accelerator) for the port's kernels: the
// 4-D tile load into shared memory that completes on an mbarrier, and the
// host's encoding of a strided bf16 view as a tensor map
// (cuTensorMapEncodeTiled, taken from the driver through cudart, so the
// libraries link cudart alone). Used by the attention forward and backward
// (attention_fwd.cuh, flash_attention_bwd.cu) and by K8
// (decode_attention.cu).
#pragma once

#include <cuda.h>   // CUtensorMap and its enums; the encoder is looked
                    // up through cudart (no libcuda link)
#include <cuda_runtime.h>
#include <stdint.h>

namespace svt {
// Internal linkage: each library that includes this keeps its own encoder
// (a static local), not merged with another loaded library's.
namespace {

// Fetch `map` into the TMA unit's cache ahead of its first load.
__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n"
               ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// Load the box at coordinates (c0, c1, c2, c3) of `map` (c0 innermost) into
// shared address `dst`; its bytes count on mbarrier `bar`. Coordinates
// outside the tensor (negative ones too) read as zeros.
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3) : "memory");
}

typedef CUresult (*EncodeTiledFn)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda; take it through cudart's
// entry-point query once, so the library links cudart alone.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A [B, S, H, D] bf16 view (element strides sb, ss, sh; D contiguous) as a
// 4-D tensor map {D, S, H, B} with a (width x rows) box, swizzled over its
// row (width 64, 32 or 16 bf16: 128, 64 or 32 bytes); columns past D and
// rows past S read as zeros.
inline bool encode_view(CUtensorMap* map, const void* ptr, int B, int S,
                        int H, int D, long long sb, long long ss,
                        long long sh, int width, int rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)width, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            width == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
            : width == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                          : CU_TENSOR_MAP_SWIZZLE_32B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
}  // namespace svt
