// K8: single-token GQA decode attention over the KV-head-major cache.
//
// Replaces streamvln_tpu/ops/decode_attention.py::_decode_kernel: for each
// batch row b and query head, softmax(q k^T * scale) v over the keys
// 0..length[b]-1 of the cache [B, Hkv, Smax, D] (keys at or past the
// length are not read), with f32 math throughout and the output in q's
// type; a row of length 0 gives zeros.
//
// Bound on the H100: every live key and value is read once for ~4 flops
// per element and head group, ~2 B per multiply-add at G = 7: device
// memory bounds it, and at B = 1 the live prefix is a few MB per layer,
// so a single call is over in microseconds and the launch itself weighs
// as much as the bytes. The TPU kernel runs one grid step per (b, KV
// head) and loops over 512-key blocks; on the H100 that would be 4 blocks
// for 132 SMs at B = 1. Here each block takes one (b, KV head, 128-key
// slice of the capacity) and exits at once when its slice starts at or
// past the row's length (the length stays on the device: no host read),
// so the live prefix is spread over up to length/128 x Hkv blocks. A
// block stages its 32-key tiles of K and V in shared memory (16-byte
// loads), computes the G heads' scores with one key per lane, keeps the
// online-softmax state (max, sum) per head and the unnormalised output in
// registers (thread: one of D columns x every other head), and writes
// them as partials; a second kernel merges a row's slices in order
// (deterministic) and normalises. Masked keys score -1e30, as in the TPU
// kernel.
//
// C interface (ctypes): q [B, 1, Hq, D] and k/v strided (elements; the
// head dim contiguous, 16-byte aligned rows); out contiguous [B, 1, Hq,
// D]; partials f32 [B, Hq, ns] (max, sum) and [B, Hq, ns, D] with ns =
// ceil(Smax / 128), allocated by the wrapper. D must be 128 and G <= 16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace svt {

constexpr int K8_D = 128;
constexpr int K8_TILE = 32;          // keys per staged tile: one per lane
constexpr int K8_SPLIT = 128;        // keys of the capacity per block
constexpr int K8_THREADS = 256;
constexpr int K8_MAXG = 16;
constexpr float K8_NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(K8_THREADS)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v,
                      const int* __restrict__ lengths, long long q_sb,
                      long long q_sh, long long k_sb, long long k_sh,
                      long long k_ss, long long v_sb, long long v_sh,
                      long long v_ss, float* __restrict__ part_m,
                      float* __restrict__ part_l,
                      float* __restrict__ part_acc, int Hq, int Hkv,
                      int Smax, int ns, float scale) {
  constexpr int EPC = 16 / sizeof(T);          // elements per 16 bytes
  constexpr int ROW = K8_D + EPC;              // padded smem row
  constexpr int CPR = K8_D / EPC;              // 16-byte chunks per row
  __shared__ __align__(16) float qs[K8_MAXG][K8_D];
  __shared__ __align__(16) T ks[K8_TILE][ROW];
  __shared__ __align__(16) T vs[K8_TILE][ROW];
  __shared__ float ps[K8_MAXG][K8_TILE];
  __shared__ float m_run[K8_MAXG], l_run[K8_MAXG], alpha[K8_MAXG];

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = min(max(lengths[b], 0), Smax);
  const int start = split * K8_SPLIT;
  const int end = min(len, start + K8_SPLIT);
  const size_t row0 = static_cast<size_t>(b) * Hq
      + static_cast<size_t>(h) * G;            // (b, first head of h)
  if (start >= end) {                          // no live key in the slice
    if (tid < G) {
      part_m[(row0 + tid) * ns + split] = K8_NEG_INF;
      part_l[(row0 + tid) * ns + split] = 0.f;
    }
    return;
  }
  for (int i = tid; i < G * K8_D; i += K8_THREADS) {
    const int g = i / K8_D, d = i % K8_D;
    qs[g][d] = to_f(q[b * q_sb + (h * G + g) * q_sh + d]);
  }
  if (tid < G) {
    m_run[tid] = K8_NEG_INF;
    l_run[tid] = 0.f;
  }
  const int d_own = tid % K8_D, g_off = tid / K8_D;   // heads g_off + 2i
  float acc[K8_MAXG / 2];
#pragma unroll
  for (int i = 0; i < K8_MAXG / 2; ++i) acc[i] = 0.f;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  __syncthreads();

  for (int t0 = start; t0 < end; t0 += K8_TILE) {
    const int nk = min(K8_TILE, end - t0);
    for (int c = tid; c < K8_TILE * CPR; c += K8_THREADS) {
      const int j = c / CPR, e = (c % CPR) * EPC;
      uint4 kk = make_uint4(0u, 0u, 0u, 0u), vv = kk;
      if (j < nk) {
        kk = __ldg(reinterpret_cast<const uint4*>(kb + (t0 + j) * k_ss + e));
        vv = __ldg(reinterpret_cast<const uint4*>(vb + (t0 + j) * v_ss + e));
      }
      *reinterpret_cast<uint4*>(&ks[j][e]) = kk;
      *reinterpret_cast<uint4*>(&vs[j][e]) = vv;
    }
    __syncthreads();

    // scores of head g for the tile's keys (lane = key), then the
    // online-softmax update of head g
    for (int g = warp; g < G; g += K8_THREADS / 32) {
      float s = 0.f;
#pragma unroll 4
      for (int e = 0; e < K8_D; e += EPC) {
        const uint4 raw = *reinterpret_cast<const uint4*>(&ks[lane][e]);
        const T* kv = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int i = 0; i < EPC; ++i) s = fmaf(qs[g][e + i], to_f(kv[i]), s);
      }
      s = lane < nk ? s * scale : K8_NEG_INF;
      float mt = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_old = m_run[g];
      const float m_new = fmaxf(m_old, mt);
      const float p = expf(s - m_new);
      float lt = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        lt += __shfl_xor_sync(0xffffffffu, lt, off);
      ps[g][lane] = p;
      if (lane == 0) {
        const float a = expf(m_old - m_new);
        alpha[g] = a;
        l_run[g] = a * l_run[g] + lt;
        m_run[g] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < K8_MAXG / 2; ++i) {
      const int g = g_off + 2 * i;
      if (g < G) {
        float a = acc[i] * alpha[g];
        for (int j = 0; j < nk; ++j)
          a = fmaf(ps[g][j], to_f(vs[j][d_own]), a);
        acc[i] = a;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < K8_MAXG / 2; ++i) {
    const int g = g_off + 2 * i;
    if (g < G)
      part_acc[((row0 + g) * ns + split) * K8_D + d_own] = acc[i];
  }
  if (tid < G) {
    part_m[(row0 + tid) * ns + split] = m_run[tid];
    part_l[(row0 + tid) * ns + split] = l_run[tid];
  }
}

// merge a (b, head) row's slices in order: out = sum_s acc_s e^(m_s - M)
// / sum_s l_s e^(m_s - M); slices without a live key (l = 0) are skipped
template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ part_m,
                                      const float* __restrict__ part_l,
                                      const float* __restrict__ part_acc,
                                      T* __restrict__ out, int ns) {
  const size_t row = blockIdx.x;
  const int d = threadIdx.x;
  float M = K8_NEG_INF;
  for (int s = 0; s < ns; ++s)
    if (part_l[row * ns + s] > 0.f) M = fmaxf(M, part_m[row * ns + s]);
  float L = 0.f, o = 0.f;
  for (int s = 0; s < ns; ++s) {
    const float l = part_l[row * ns + s];
    if (l > 0.f) {
      const float w = expf(part_m[row * ns + s] - M);
      L += l * w;
      o += part_acc[(row * ns + s) * K8_D + d] * w;
    }
  }
  out[row * K8_D + d] = from_f<T>(L > 0.f ? o / L : 0.f);
}

template <typename T>
int launch_decode(const void* q, const void* k, const void* v,
                  const int* lengths, void* out, float* pm, float* pl,
                  float* pa, const long long* st8, int B, int Hq, int Hkv,
                  int Smax, float scale, cudaStream_t st) {
  const int ns = (Smax + K8_SPLIT - 1) / K8_SPLIT;
  dim3 grid(ns, Hkv, B);
  decode_partial_kernel<T><<<grid, K8_THREADS, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, st8[0], st8[1], st8[2], st8[3],
      st8[4], st8[5], st8[6], st8[7], pm, pl, pa, Hq, Hkv, Smax, ns, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_combine_kernel<T><<<B * Hq, K8_D, 0, st>>>(
      pm, pl, pa, static_cast<T*>(out), ns);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace svt

// strides: q (batch, head), k (batch, head, seq), v (batch, head, seq)
extern "C" int svt_decode_attention(
    const void* q, const void* k, const void* v, const void* lengths,
    void* out, void* part_m, void* part_l, void* part_acc,
    const long long* strides, int B, int Hq, int Hkv, int Smax, int D,
    float scale, int is_bf16, void* stream) {
  if (D != svt::K8_D || Hkv < 1 || Hq % Hkv || Hq / Hkv > svt::K8_MAXG ||
      B < 1 || B > 65535 || Smax < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  return is_bf16
      ? svt::launch_decode<__nv_bfloat16>(q, k, v, len, out, pm, pl, pa,
                                          strides, B, Hq, Hkv, Smax, scale,
                                          st)
      : svt::launch_decode<float>(q, k, v, len, out, pm, pl, pa, strides, B,
                                  Hq, Hkv, Smax, scale, st);
}
