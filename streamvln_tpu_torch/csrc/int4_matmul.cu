// K6 and K7: products with packed-int4 weights.
//
// K6 (svt_int4_matmul) replaces streamvln_tpu/ops/int4_matmul.py::_kernel:
// out[M, dout] (f32) = x[M, din] @ dequant(W), with W packed uint8
// [din/2, dout] (byte r: row 2r in the low nibble, row 2r+1 in the high
// one, both signed) and f32 scales [din/64, dout]. Each weight is
// nibble * scale in f32, rounded once to x's type (bf16 or f32), then
// multiplied into an f32 sum, as the TPU kernel does; the contraction is
// x[:, 2r] * lo[r] + x[:, 2r+1] * hi[r], the TPU kernel's xe@lo + xo@hi.
//
// Bound on the H100: at decode (M = 1) every weight byte is read once for
// one multiply-add per nibble, ~0.56 B of weight and scale per
// multiply-add, far below the card's ridge: device memory bounds it
// (3.35 TB/s). The design streams the packed bytes once, coalesced: a
// thread loads 16 contiguous bytes of one packed row (16 output columns x
// two rows), so a warp covers 512 columns of a packed row in one 512-byte
// transaction. The 8 warps of a block walk disjoint 32-row scale groups
// (one scale load per 16 columns and group) and sum their partials in
// shared memory in a fixed order. Every block also owns a slice of the
// contraction (grid.z = the wrapper's split) so that narrow outputs still
// fill the 132 SMs; a second pass sums the slices in order, so the result
// is deterministic. x's values for a group are loaded once by the warp
// (one column pair per lane) and broadcast with shuffles. A thread keeps
// MT rows x 16 f32 sums (MT = 1 at decode, 4 above); blocks along grid.y
// take further row tiles. The nibble -> float conversion is exact integer
// arithmetic on the bits (0x4B000000 | u is the float 2^23 + u), which
// spares the int-to-float unit; the dequant arithmetic (~13 instructions
// per byte) is what keeps this simple kernel from the memory bound.
//
// K7 (svt_int4_dequant_split) replaces _dequant_kernel: one layer to
// [2, din/2, dout] in x's type, low-nibble rows then high-nibble rows,
// each value nibble * scale (f32) rounded once. A pure streaming pass
// (0.5 B + scales read, 2 x 2 B written per byte in bf16): one thread per
// 16 packed bytes, 16-byte loads and stores.
//
// C interface (ctypes): pointers are to one layer's slice; the wrapper
// checks shapes (din, dout multiples of 512), types and contiguity, and
// allocates `out` and the split partials `part` ([ks, M, dout] f32, NULL
// when ks == 1). Entries return the CUDA error of their launches.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace svt {

constexpr int K6_WARPS = 8;
constexpr int K6_COLS = 512;        // 32 lanes x 16 bytes
constexpr int GROUP_ROWS = 32;      // packed rows per scale group (64 rows)

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(
    __nv_bfloat16 v) {
  return __bfloat162float(v);
}

// a weight value as the kernel multiplies it: rounded once to T
template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(
    float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// signed nibble (u in 0..15, two's complement) as an exact float:
// (u ^ 8) - 8 == q, and 0x4B000000 | k is the float 2^23 + k
__device__ __forceinline__ float nibble_to_f(uint32_t u) {
  return __int_as_float(0x4B000000u | (u ^ 8u)) - 8388616.0f;
}

__device__ __forceinline__ void load_scales16(const float* p, float* sc) {
  const float4* p4 = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float4 f = __ldg(p4 + i);
    sc[4 * i] = f.x; sc[4 * i + 1] = f.y;
    sc[4 * i + 2] = f.z; sc[4 * i + 3] = f.w;
  }
}

template <typename T, int MT>
__global__ void __launch_bounds__(K6_WARPS * 32)
int4_matmul_kernel(const T* __restrict__ x, const uint8_t* __restrict__ w,
                   const float* __restrict__ s, float* __restrict__ dst,
                   int M, int din, int dout, int ks) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col0 = blockIdx.x * K6_COLS + lane * 16;
  const int m0 = blockIdx.y * MT;
  const int ngroups = din / (2 * GROUP_ROWS);
  const int g_begin = static_cast<int>(
      static_cast<long long>(ngroups) * blockIdx.z / ks);
  const int g_end = static_cast<int>(
      static_cast<long long>(ngroups) * (blockIdx.z + 1) / ks);

  float acc[MT][16];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int b = 0; b < 16; ++b) acc[m][b] = 0.f;

  for (int g = g_begin + warp; g < g_end; g += K6_WARPS) {
    float sc[16];
    load_scales16(s + static_cast<size_t>(g) * dout + col0, sc);
    // lane l holds x[:, 64g + 2l] (pairs with lo) and x[:, 64g + 2l + 1]
    float xe[MT], xo[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      xe[m] = xo[m] = 0.f;
      if (m0 + m < M) {
        const T* xr = x + static_cast<size_t>(m0 + m) * din
            + 2 * (g * GROUP_ROWS + lane);
        xe[m] = to_f<T>(xr[0]);
        xo[m] = to_f<T>(xr[1]);
      }
    }
    const uint8_t* wg = w + static_cast<size_t>(g) * GROUP_ROWS * dout
        + col0;
#pragma unroll 4
    for (int r = 0; r < GROUP_ROWS; ++r) {
      const uint4 p = __ldg(reinterpret_cast<const uint4*>(
          wg + static_cast<size_t>(r) * dout));
      float e[MT], o[MT];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        e[m] = __shfl_sync(0xffffffffu, xe[m], r);
        o[m] = __shfl_sync(0xffffffffu, xo[m], r);
      }
      const uint32_t words[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int b = 0; b < 16; ++b) {
        const uint32_t byte = (words[b >> 2] >> (8 * (b & 3))) & 0xFFu;
        const float wl = round_to<T>(nibble_to_f(byte & 0xFu) * sc[b]);
        const float wh = round_to<T>(nibble_to_f(byte >> 4) * sc[b]);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          acc[m][b] = fmaf(e[m], wl, acc[m][b]);
          acc[m][b] = fmaf(o[m], wh, acc[m][b]);
        }
      }
    }
  }

  // sum the warps' partials in a fixed order, one row at a time
  __shared__ __align__(16) float red[K6_WARPS][K6_COLS];
  float* out = dst + static_cast<size_t>(blockIdx.z) * M * dout;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int b = 0; b < 16; b += 4)
      *reinterpret_cast<float4*>(&red[warp][lane * 16 + b]) =
          make_float4(acc[m][b], acc[m][b + 1], acc[m][b + 2],
                      acc[m][b + 3]);
    __syncthreads();
    if (m0 + m < M) {
      for (int c = threadIdx.x; c < K6_COLS; c += K6_WARPS * 32) {
        float v = 0.f;
#pragma unroll
        for (int i = 0; i < K6_WARPS; ++i) v += red[i][c];
        out[static_cast<size_t>(m0 + m) * dout + blockIdx.x * K6_COLS + c] =
            v;
      }
    }
    __syncthreads();
  }
}

// out[i] = sum over z in order of part[z][i]
__global__ void sum_splits_kernel(const float* __restrict__ part,
                                  float* __restrict__ out, long long n,
                                  int ks) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x)
           + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float v = 0.f;
    for (int z = 0; z < ks; ++z) v += part[z * n + i];
    out[i] = v;
  }
}

template <typename T>
__device__ __forceinline__ void store16(T* dst, const float* v);
template <> __device__ __forceinline__ void store16<float>(float* dst,
                                                         const float* v) {
  float4* d = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    d[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
}
template <> __device__ __forceinline__ void store16<__nv_bfloat16>(
    __nv_bfloat16* dst, const float* v) {
  uint32_t u[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    u[i] = *reinterpret_cast<uint32_t*>(&h);
  }
  uint4* d = reinterpret_cast<uint4*>(dst);
  d[0] = make_uint4(u[0], u[1], u[2], u[3]);
  d[1] = make_uint4(u[4], u[5], u[6], u[7]);
}

template <typename T>
__global__ void int4_dequant_split_kernel(const uint8_t* __restrict__ w,
                                          const float* __restrict__ s,
                                          T* __restrict__ out, int half,
                                          int dout) {
  const long long n = static_cast<long long>(half) * dout;
  for (long long e = (blockIdx.x * static_cast<long long>(blockDim.x)
                      + threadIdx.x) * 16; e < n;
       e += static_cast<long long>(gridDim.x) * blockDim.x * 16) {
    const int r = static_cast<int>(e / dout);
    const int c = static_cast<int>(e - static_cast<long long>(r) * dout);
    const uint4 p = __ldg(reinterpret_cast<const uint4*>(w + e));
    float sc[16];
    load_scales16(s + static_cast<size_t>(r / GROUP_ROWS) * dout + c, sc);
    const uint32_t words[4] = {p.x, p.y, p.z, p.w};
    float lo[16], hi[16];
#pragma unroll
    for (int b = 0; b < 16; ++b) {
      const uint32_t byte = (words[b >> 2] >> (8 * (b & 3))) & 0xFFu;
      lo[b] = nibble_to_f(byte & 0xFu) * sc[b];
      hi[b] = nibble_to_f(byte >> 4) * sc[b];
    }
    store16<T>(out + e, lo);
    store16<T>(out + n + e, hi);
  }
}

template <typename T>
int launch_int4_matmul(const void* x, const void* w, const void* s,
                       void* out, void* part, int M, int din, int dout,
                       int ks, cudaStream_t st) {
  float* dst = static_cast<float*>(ks > 1 ? part : out);
  const T* xp = static_cast<const T*>(x);
  const uint8_t* wp = static_cast<const uint8_t*>(w);
  const float* sp = static_cast<const float*>(s);
  if (M == 1) {
    dim3 grid(dout / K6_COLS, 1, ks);
    int4_matmul_kernel<T, 1><<<grid, K6_WARPS * 32, 0, st>>>(
        xp, wp, sp, dst, M, din, dout, ks);
  } else {
    dim3 grid(dout / K6_COLS, (M + 3) / 4, ks);
    int4_matmul_kernel<T, 4><<<grid, K6_WARPS * 32, 0, st>>>(
        xp, wp, sp, dst, M, din, dout, ks);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || ks == 1) return static_cast<int>(err);
  const long long n = static_cast<long long>(M) * dout;
  const int blocks = static_cast<int>((n + 255) / 256 < 4096
                                      ? (n + 255) / 256 : 4096);
  sum_splits_kernel<<<blocks, 256, 0, st>>>(dst, static_cast<float*>(out),
                                            n, ks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace svt

extern "C" int svt_int4_matmul(const void* x, const void* w, const void* s,
                               void* out, void* part, int M, int din,
                               int dout, int ks, int is_bf16,
                               void* stream) {
  if (M < 1 || din % 512 || dout % 512 || ks < 1 || (ks > 1 && !part) ||
      (M + 3) / 4 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16
      ? svt::launch_int4_matmul<__nv_bfloat16>(x, w, s, out, part, M, din,
                                               dout, ks, st)
      : svt::launch_int4_matmul<float>(x, w, s, out, part, M, din, dout, ks,
                                       st);
}

extern "C" int svt_int4_dequant_split(const void* w, const void* s,
                                      void* out, int half, int dout,
                                      int is_bf16, void* stream) {
  if (half % 256 || dout % 512) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long units = static_cast<long long>(half) * dout / 16;
  const int blocks = static_cast<int>((units + 255) / 256 < 132 * 16
                                      ? (units + 255) / 256 : 132 * 16);
  const uint8_t* wp = static_cast<const uint8_t*>(w);
  const float* sp = static_cast<const float*>(s);
  if (is_bf16)
    svt::int4_dequant_split_kernel<__nv_bfloat16><<<blocks, 256, 0, st>>>(
        wp, sp, static_cast<__nv_bfloat16*>(out), half, dout);
  else
    svt::int4_dequant_split_kernel<float><<<blocks, 256, 0, st>>>(
        wp, sp, static_cast<float*>(out), half, dout);
  return static_cast<int>(cudaGetLastError());
}
