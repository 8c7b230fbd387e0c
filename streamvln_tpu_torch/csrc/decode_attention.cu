// K8: single-token GQA decode attention over the KV-head-major cache, for
// Hopper (sm_90a).
//
// Replaces streamvln_tpu/ops/decode_attention.py::_decode_kernel: for each
// batch row b and query head, softmax(q k^T * scale) v over the keys
// 0..length[b]-1 of the cache [B, Hkv, Smax, D] (keys at or past the
// length are not read), with an f32 softmax state and an f32 output sum,
// the output in q's type; masked scores are -1e30 and a row of length 0
// gives zeros, as in the TPU kernel.
//
// Bound on the H100: every live key and value is read once for ~4 flops
// per element and head group (G = 7): device memory bounds it (3.35 TB/s).
// At B = 1 the live prefix is 0.6-8 MB per layer, so what decides the time
// is how soon its bytes are in flight on many SMs and how short the chain
// after them is: a split of the capacity leaves most blocks idle at short
// lengths, block-wide barriers per tile and long serial dot products
// stall, and a second launch to merge the splits costs as much as the
// bytes.
//
// Design:
// - The grid is (P, Hkv, B), P from the shapes alone (kernel_plan.cuh), and
//   the P blocks of one (row, KV head) form a thread-block cluster (at
//   most 16 blocks, a non-portable size the H100 schedules). Each
//   block reads length[b] on the device and takes an equal 16-aligned share
//   of the live prefix, at least 64 keys, so a short prefix takes fewer
//   blocks; a block past the prefix does no work but joins the merge.
// - A producer warp streams the share's 64-key tiles of K and V into a
//   ring of stages in shared memory with 16-byte asynchronous copies
//   (cp.async, LDGSTS), into key rows padded by 16 bytes so that ldmatrix
//   falls on 32 banks; each stage completes on an mbarrier when every
//   producer lane's copies have landed and is released on another, with no
//   block-wide barrier per tile. No key at or past the share's end is read;
//   V's rows there are zero-filled so that P V stays finite. Four consumer
//   warps take 16 keys each of every stage while the next stages land.
//   (1-D bulk copies, one per 256-byte key row, took ~60 cycles per copy
//   per SM: 0.037 ms at 4096 keys.)
// - bf16: S^T = K q^T and O^T = V^T P^T on the tensor cores (mma.sync
//   m16n8k16), so that the G <= 8 query heads of the KV head are the n side
//   (no padded rows; bf16 products are exact in f32); the online softmax
//   runs in the log2 domain in registers; P^T is moved into the B layout
//   by movmatrix and split into two bf16 terms (hi + lo, f32 weights to
//   about 2^-17); V^T comes from ldmatrix's transposing load. f32:
//   CUDA-core arithmetic.
// - One launch merges the splits in a fixed order: each block merges its
//   four warps' (max, sum, output) in shared memory and sends the result
//   of head row g into the receive area of block g % P of the cluster with
//   st.async, which completes on the receiver's own mbarrier: no cluster
//   barrier at the end, and a block that owns no row leaves once it has
//   sent. (The one cluster barrier is split: all arrive after the mbarrier
//   inits, and a block waits only before its first send.) Block r then
//   merges its head rows r, r + P, ... over the P blocks in split order,
//   normalises and writes the output. Each merge takes the largest max
//   first, then sums the scaled terms in order. Two calls give bit-equal
//   results; the wrapper allocates the output only.
//
// C interface (ctypes): q [B, 1, Hq, D] and k/v strided (elements; the
// head dim contiguous, k/v rows 16-byte aligned); out contiguous [B, 1,
// Hq, D]. D must be 128 and G <= 16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "kernel_plan.cuh"
#include "pipeline.cuh"

namespace svt {
// Internal linkage: the library exports its C entry point only, so no
// instantiation or static local of the shared headers' templates is merged
// with another loaded library's (int4_matmul.cu includes them too).
namespace {

constexpr int K8_D = 128;
constexpr int K8_MAXG = 16;
constexpr int K8_PRODUCERS = 1;            // producer warps
constexpr int K8_THREADS = 128 + 32 * K8_PRODUCERS;   // + 4 consumer warps
constexpr float K8_NEG_INF = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}

// Shared-memory layout: the ring of K/V stages, q in f32 (f32 inputs), the
// cluster merge's receive area (slot (g / P) P + p holds block p's partial
// of head row g at block g % P: at most 2 MAXG slots; (max, sum) pairs),
// the barriers (full and empty per stage, then the receive barrier). The
// warps' partials lie over the ring once it is drained.
template <typename T>
struct DecShape {
  static constexpr int RB = K8_D * sizeof(T);      // bytes of a key row
  static constexpr int ROW = RB + 16;              // padded row
  static constexpr int TILE = kDecTile * ROW;      // one K or V tile
  static constexpr int STAGE = 2 * TILE;           // K, then V
  static constexpr int ST = sizeof(T) == 2 ? 4 : 2;
  static constexpr int SLOTS = 2 * K8_MAXG;
  static constexpr int Q_OFF = ST * STAGE;
  static constexpr int R_ACC = Q_OFF + K8_MAXG * K8_D * 4;  // [SLOTS][D]
  static constexpr int R_ML = R_ACC + SLOTS * K8_D * 4;     // [SLOTS][2]
  static constexpr int BAR_OFF = R_ML + SLOTS * 8;
  static constexpr int SMEM = BAR_OFF + 16 * ST + 8;
  // each warp's (output, max, sum), over the drained ring
  static constexpr int W_ACC = 0;                            // [4][G][D]
  static constexpr int W_M = W_ACC + 4 * K8_MAXG * K8_D * 4; // [4][G]
  static constexpr int W_L = W_M + 4 * K8_MAXG * 4;
  static_assert(W_L + 4 * K8_MAXG * 4 <= Q_OFF, "the partials fit the ring");
};

// n <= N (max, sum, output) partials (log2 units) merged in order: the
// largest max first, then each partial's terms scaled to it and summed in
// index order; a partial that saw no key (sum 0) adds nothing.
template <int N>
__device__ __forceinline__ void merge(const float* pm, const float* pl,
                                      const float* po, int n, float& m,
                                      float& l, float& o) {
  m = K8_NEG_INF;
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (i < n && pl[i] > 0.f) m = fmaxf(m, pm[i]);
  l = o = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (i < n && pl[i] > 0.f) {
      const float c = ex2(pm[i] - m);
      l += pl[i] * c;
      o += po[i] * c;
    }
}

// bf16 pair (q[d], q[d + 1]) of head row g, zero past the G heads
__device__ __forceinline__ uint32_t q_pair(const __nv_bfloat16* qh, int g,
                                           int G, long long q_sh, int d) {
  if (g >= G) return 0u;
  const unsigned short* p =
      reinterpret_cast<const unsigned short*>(qh + g * q_sh + d);
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 16);
}

// The 8 x 8 bf16 matrix of which this thread holds (row gq, columns 2tq,
// 2tq + 1), transposed: the thread then holds the same place of the
// transpose.
__device__ __forceinline__ uint32_t transpose8(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y) : "r"(x));
  return y;
}

// bf16 consumer: 16 keys of every stage on the tensor cores, transposed so
// that the G <= 8 NG heads of the KV head are the n side of the products
// (no padded rows): S^T [16 keys x 8 NG heads] = K q^T, then O^T [128 x 8
// NG] += V^T P^T, K and V^T the A operands from shared memory (ldmatrix,
// V^T transposed on the load), q^T and P^T the B operands in registers
// (P^T's accumulator layout turned into the B layout by movmatrix). Writes
// the warp's partial (heads < G) to the merge area.
template <typename T, int NG>
__device__ __forceinline__ void consume_bf16(
    unsigned char* sm, uint32_t base, uint32_t full0, uint32_t empty0,
    const T* qh, long long q_sh, int G, int nkeys, int ntiles, float sl2,
    int warp, int lane) {
  using S = DecShape<T>;
  const int gq = lane >> 2, tq = lane & 3;
  uint32_t qb[NG][8][2];             // B fragments of q^T, 16 depths each
#pragma unroll
  for (int n = 0; n < NG; ++n)
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      qb[n][s][0] = q_pair(qh, 8 * n + gq, G, q_sh, 16 * s + 2 * tq);
      qb[n][s][1] = q_pair(qh, 8 * n + gq, G, q_sh, 16 * s + 2 * tq + 8);
    }
  // O^T (i, n): head dims 16 i + gq (+ 8 for [2], [3]), heads 8 n + 2 tq
  // (+ 1 for [1], [3]); m, l per head 8 n + 2 tq + c
  float o[8][NG][4], m[NG][2], l[NG][2];
#pragma unroll
  for (int n = 0; n < NG; ++n) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][n][e] = 0.f;
    m[n][0] = m[n][1] = K8_NEG_INF;
    l[n][0] = l[n][1] = 0.f;
  }
  // ldmatrix addresses: K rows key lane & 15, depth +8 for lanes 16-31; V
  // (transposed) rows key (lane & 7) + 8 (lane >> 4), depth +8 for lanes
  // 8-15 and 24-31
  const uint32_t k_off = (16 * warp + (lane & 15)) * S::ROW
      + (lane >> 4) * 16;
  const uint32_t v_off = S::TILE + (16 * warp + (lane & 7)
      + ((lane >> 4) << 3)) * S::ROW + ((lane >> 3) & 1) * 16;
  for (int t = 0; t < ntiles; ++t) {
    const int st = t % S::ST;
    mbar_wait(full0 + 8 * st, (t / S::ST) & 1);
    const int kc = t * kDecTile + 16 * warp;   // the chunk's first key
    if (kc < nkeys) {
      const int nv = nkeys - kc;               // live keys from kc on
      const uint32_t stg = base + st * S::STAGE;
      // sc[n][e]: key gq + 8 (e >> 1), head 8 n + 2 tq + (e & 1)
      float sc[NG][4];
#pragma unroll
      for (int n = 0; n < NG; ++n)
        sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        uint32_t kf[4];
        ldsm_x4(kf, stg + k_off + 32 * s);
#pragma unroll
        for (int n = 0; n < NG; ++n) mma_bf16(sc[n], kf, qb[n][s]);
      }
      uint32_t bh[NG][2], bl[NG][2];           // P^T as B: hi and lo
#pragma unroll
      for (int n = 0; n < NG; ++n) {
        float mx[2];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[n][e] = gq + 8 * (e >> 1) < nv ? sc[n][e] * sl2 : K8_NEG_INF;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          mx[c] = fmaxf(sc[n][c], sc[n][c + 2]);
#pragma unroll
          for (int off = 4; off < 32; off <<= 1)
            mx[c] = fmaxf(mx[c], __shfl_xor_sync(0xffffffffu, mx[c], off));
          mx[c] = fmaxf(mx[c], m[n][c]);
          const float alpha = ex2(m[n][c] - mx[c]);
          m[n][c] = mx[c];
          sc[n][c] = ex2(sc[n][c] - mx[c]);
          sc[n][c + 2] = ex2(sc[n][c + 2] - mx[c]);
          l[n][c] = l[n][c] * alpha + sc[n][c] + sc[n][c + 2];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            o[i][n][c] *= alpha;
            o[i][n][c + 2] *= alpha;
          }
        }
        // keys gq (block 0) and gq + 8 (block 1) of heads 2tq, 2tq + 1,
        // hi + lo, each 8 x 8 block transposed into the B layout
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float x0 = sc[n][2 * h], x1 = sc[n][2 * h + 1];
          const uint32_t hi = pack_bf16x2(x0, x1);
          const uint32_t lo =
              pack_bf16x2(x0 - __uint_as_float(hi << 16),
                          x1 - __uint_as_float(hi & 0xFFFF0000u));
          bh[n][h] = transpose8(hi);
          bl[n][h] = transpose8(lo);
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        uint32_t vf[4];
        ldsm_x4_t(vf, stg + v_off + 32 * i);
#pragma unroll
        for (int n = 0; n < NG; ++n) {
          mma_bf16(o[i][n], vf, bh[n]);
          mma_bf16(o[i][n], vf, bl[n]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * st);
  }
#pragma unroll
  for (int n = 0; n < NG; ++n)
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        l[n][c] += __shfl_xor_sync(0xffffffffu, l[n][c], off);
  bar_sync(1, 128);                  // every consumer is done with the ring
  float* wacc = reinterpret_cast<float*>(sm + S::W_ACC) + warp * K8_MAXG * K8_D;
  float* wm = reinterpret_cast<float*>(sm + S::W_M) + warp * K8_MAXG;
  float* wl = reinterpret_cast<float*>(sm + S::W_L) + warp * K8_MAXG;
#pragma unroll
  for (int n = 0; n < NG; ++n)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int g = 8 * n + 2 * tq + c;
      if (g < G) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          wacc[g * K8_D + 16 * i + gq] = o[i][n][c];
          wacc[g * K8_D + 16 * i + gq + 8] = o[i][n][c + 2];
        }
        if (gq == 0) {
          wm[g] = m[n][c];
          wl[g] = l[n][c];
        }
      }
    }
}

// f32 consumer: 16 keys of every stage on the CUDA cores (lane: key
// lane & 15, half lane >> 4 of the head dim for the scores; head dims
// 4 lane..4 lane + 3 for P V). q in f32 at Q_OFF.
template <typename T>
__device__ __forceinline__ void consume_f32(
    unsigned char* sm, uint32_t full0, uint32_t empty0, int G, int nkeys,
    int ntiles, float sl2, int warp, int lane) {
  using S = DecShape<T>;
  const float* qs = reinterpret_cast<const float*>(sm + S::Q_OFF);
  const int key = lane & 15, half = lane >> 4;
  float m[K8_MAXG], l[K8_MAXG], o[K8_MAXG][4];
#pragma unroll
  for (int g = 0; g < K8_MAXG; ++g) {
    m[g] = K8_NEG_INF;
    l[g] = 0.f;
    o[g][0] = o[g][1] = o[g][2] = o[g][3] = 0.f;
  }
  for (int t = 0; t < ntiles; ++t) {
    const int st = t % S::ST;
    mbar_wait(full0 + 8 * st, (t / S::ST) & 1);
    const int kc = t * kDecTile + 16 * warp;
    if (kc < nkeys) {
      const int nv = nkeys - kc;
      const float* kr = reinterpret_cast<const float*>(
          sm + st * S::STAGE + (16 * warp + key) * S::ROW) + half * 64;
      float p[K8_MAXG];
#pragma unroll
      for (int g = 0; g < K8_MAXG; ++g) p[g] = 0.f;
      for (int d = 0; d < 64; d += 4) {
        const float4 kv = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
        for (int g = 0; g < K8_MAXG; ++g) {
          if (g < G) {
            const float4 qv = *reinterpret_cast<const float4*>(
                qs + g * K8_D + half * 64 + d);
            p[g] = fmaf(qv.x, kv.x, p[g]);
            p[g] = fmaf(qv.y, kv.y, p[g]);
            p[g] = fmaf(qv.z, kv.z, p[g]);
            p[g] = fmaf(qv.w, kv.w, p[g]);
          }
        }
      }
#pragma unroll
      for (int g = 0; g < K8_MAXG; ++g) {
        if (g < G) {
          float s = p[g] + __shfl_xor_sync(0xffffffffu, p[g], 16);
          s = key < nv ? s * sl2 : K8_NEG_INF;
          float mx = s;
#pragma unroll
          for (int off = 8; off > 0; off >>= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
          mx = fmaxf(mx, m[g]);
          const float alpha = ex2(m[g] - mx);
          p[g] = ex2(s - mx);
          float sum = p[g];
#pragma unroll
          for (int off = 8; off > 0; off >>= 1)
            sum += __shfl_xor_sync(0xffffffffu, sum, off);
          l[g] = l[g] * alpha + sum;
          m[g] = mx;
#pragma unroll
          for (int c = 0; c < 4; ++c) o[g][c] *= alpha;
        }
      }
      const float* vr = reinterpret_cast<const float*>(
          sm + st * S::STAGE + S::TILE + 16 * warp * S::ROW) + 4 * lane;
      for (int j = 0; j < 16; ++j) {
        const float4 vv = *reinterpret_cast<const float4*>(
            vr + j * (S::ROW / 4));
#pragma unroll
        for (int g = 0; g < K8_MAXG; ++g) {
          if (g < G) {
            const float pj = __shfl_sync(0xffffffffu, p[g], j);
            o[g][0] = fmaf(pj, vv.x, o[g][0]);
            o[g][1] = fmaf(pj, vv.y, o[g][1]);
            o[g][2] = fmaf(pj, vv.z, o[g][2]);
            o[g][3] = fmaf(pj, vv.w, o[g][3]);
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * st);
  }
  bar_sync(1, 128);
  float* wacc = reinterpret_cast<float*>(sm + S::W_ACC) + warp * K8_MAXG * K8_D;
  float* wm = reinterpret_cast<float*>(sm + S::W_M) + warp * K8_MAXG;
  float* wl = reinterpret_cast<float*>(sm + S::W_L) + warp * K8_MAXG;
#pragma unroll
  for (int g = 0; g < K8_MAXG; ++g) {
    if (g < G) {
      *reinterpret_cast<float4*>(wacc + g * K8_D + 4 * lane) =
          make_float4(o[g][0], o[g][1], o[g][2], o[g][3]);
      if (lane == 0) {
        wm[g] = m[g];
        wl[g] = l[g];
      }
    }
  }
}

// NG: heads of a KV head in tiles of 8 (bf16: 1 for G <= 8, else 2)
template <typename T, int NG>
__global__ void __launch_bounds__(K8_THREADS, 1)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ lengths, T* __restrict__ out,
                        long long q_sb, long long q_sh, long long k_sb,
                        long long k_sh, long long k_ss, long long v_sb,
                        long long v_sh, long long v_ss, int Hq, int Hkv,
                        int Smax, float scale) {
  using S = DecShape<T>;
  extern __shared__ __align__(128) unsigned char sm[];
  const uint32_t base = smem_u32(sm);
  const uint32_t full0 = base + S::BAR_OFF, empty0 = full0 + 8 * S::ST;
  const uint32_t recv = empty0 + 8 * S::ST;
  const int P = gridDim.x, p = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int len = min(max(lengths[b], 0), Smax);
  const Range kr = decode_keys(len, P, p);
  const int nkeys = kr.end - kr.begin;
  const int ntiles = (nkeys + kDecTile - 1) / kDecTile;
  const T* qh = q + b * q_sb + h * G * q_sh;

  if (threadIdx.x == 0) {
    for (int i = 0; i < S::ST; ++i) {
      mbar_init(full0 + 8 * i, 32 * K8_PRODUCERS);   // producer lanes
      mbar_init(empty0 + 8 * i, 4);            // the consumer warps
    }
    mbar_init(recv, 1);                        // + the bytes of the rows
    mbar_init_fence();
  }
  __syncthreads();
  cluster_arrive();                  // the receive barrier is initialised

  if (warp >= 4) {
    // ---- producers: 16-byte chunks of the tile's key rows of K and V,
    // none at or past the share's end (V's rows there are zeros); lane i
    // takes chunk i % CH of rows i / CH, i / CH + RS, ... ----
    constexpr int CH = S::RB / 16;             // chunks of a row
    constexpr int RS = 32 * K8_PRODUCERS / CH; // rows per step
    const int i = threadIdx.x - 128, c = i % CH, j0 = i / CH;
    const T* kb = k + b * k_sb + h * k_sh + (kr.begin + j0) * k_ss
        + c * (16 / sizeof(T));
    const T* vb = v + b * v_sb + h * v_sh + (kr.begin + j0) * v_ss
        + c * (16 / sizeof(T));
    for (int t = 0; t < ntiles; ++t) {
      const int st = t % S::ST;
      if (t >= S::ST) mbar_wait(empty0 + 8 * st, (t / S::ST - 1) & 1);
      const int nk = min(kDecTile, nkeys - t * kDecTile);
      const uint32_t ks = base + st * S::STAGE + j0 * S::ROW + c * 16;
      const long long key0 = static_cast<long long>(t) * kDecTile;
#pragma unroll 8
      for (int j = 0; j < kDecTile; j += RS) {
        const uint32_t dst = ks + j * S::ROW;
        if (j0 + j < nk) {
          cp_async16(dst, kb + (key0 + j) * k_ss);
          cp_async16(dst + S::TILE, vb + (key0 + j) * v_ss);
        } else {
          cp_async16(dst + S::TILE, vb, 0);
        }
      }
      cp_async_arrive(full0 + 8 * st);
    }
    __syncwarp();
  } else if constexpr (sizeof(T) == 2) {
    consume_bf16<T, NG>(sm, base, full0, empty0, qh, q_sh, G, nkeys, ntiles,
                        scale * kLog2e, warp, lane);
  } else {
    float* qs = reinterpret_cast<float*>(sm + S::Q_OFF);
    for (int i = threadIdx.x; i < G * K8_D; i += 128)
      qs[i] = qh[(i / K8_D) * q_sh + i % K8_D];
    bar_sync(1, 128);
    consume_f32<T>(sm, full0, empty0, G, nkeys, ntiles, scale * kLog2e, warp,
                   lane);
  }

  // ---- merge: the block's four warps, sent to the block that owns the
  // head row (g % P); each owner then merges its rows over the P blocks.
  // Thread t takes head dims 4 (t % 32) + 0..3 of rows t / 32 + 4 i. ----
  if (warp >= 4) return;
  bar_sync(1, 128);                  // the warps' partials are written
  cluster_wait();                    // every receive barrier is ready
  const int d4 = 4 * lane;
  {
    const float* wacc = reinterpret_cast<const float*>(sm + S::W_ACC);
    const float* wm = reinterpret_cast<const float*>(sm + S::W_M);
    const float* wl = reinterpret_cast<const float*>(sm + S::W_L);
    for (int g = warp; g < G; g += 4) {
      const float pm[4] = {wm[g], wm[K8_MAXG + g], wm[2 * K8_MAXG + g],
                           wm[3 * K8_MAXG + g]};
      const float pl[4] = {wl[g], wl[K8_MAXG + g], wl[2 * K8_MAXG + g],
                           wl[3 * K8_MAXG + g]};
      float o4[4], mm, ll;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float po[4];
#pragma unroll
        for (int w = 0; w < 4; ++w)
          po[w] = wacc[(w * K8_MAXG + g) * K8_D + d4 + c];
        merge<4>(pm, pl, po, 4, mm, ll, o4[c]);
      }
      const uint32_t owner = g % P, slot = g / P * P + p;
      const uint32_t bar = cluster_addr(recv, owner);
      st_async4(cluster_addr(base + S::R_ACC + 4 * (slot * K8_D + d4), owner),
                make_float4(o4[0], o4[1], o4[2], o4[3]), bar);
      if (lane == 0)
        st_async2(cluster_addr(base + S::R_ML + 8 * slot, owner),
                  make_float2(mm, ll), bar);
    }
  }
  const int owned = p < G ? (G - 1 - p) / P + 1 : 0;
  if (owned == 0) return;
  if (threadIdx.x == 0) mbar_arrive_tx(recv, owned * P * (K8_D * 4 + 8));
  mbar_wait(recv, 0);
  const float* racc = reinterpret_cast<const float*>(sm + S::R_ACC);
  const float* rml = reinterpret_cast<const float*>(sm + S::R_ML);
  const int d = threadIdx.x;
  for (int g = p; g < G; g += P) {
    const int s0 = g / P * P;
    float pm[kDecCluster], pl[kDecCluster], po[kDecCluster];
#pragma unroll
    for (int r = 0; r < kDecCluster; ++r)
      if (r < P) {
        pm[r] = rml[2 * (s0 + r)];
        pl[r] = rml[2 * (s0 + r) + 1];
        po[r] = racc[(s0 + r) * K8_D + d];
      }
    float mm, ll, oo;
    merge<kDecCluster>(pm, pl, po, P, mm, ll, oo);
    out[(static_cast<size_t>(b) * Hq + h * G + g) * K8_D + d] =
        from_f<T>(ll > 0.f ? oo / ll : 0.f);
  }
}

template <typename T, int NG>
cudaError_t launch_decode(const void* q, const void* k, const void* v,
                          const int* lengths, void* out,
                          const long long* st8, int B, int Hq, int Hkv,
                          int Smax, float scale, cudaStream_t st) {
  using S = DecShape<T>;
  static const cudaError_t ready =
      allow_launch(decode_attention_kernel<T, NG>, S::SMEM, true);
  if (ready != cudaSuccess) return ready;
  const int P = decode_splits(Smax, B, Hkv);
  return launch_clustered(
      decode_attention_kernel<T, NG>, dim3(P, Hkv, B), K8_THREADS, P,
      S::SMEM, st, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(out), st8[0],
      st8[1], st8[2], st8[3], st8[4], st8[5], st8[6], st8[7], Hq, Hkv, Smax,
      scale);
}

}  // namespace
}  // namespace svt

// strides: q (batch, head), k (batch, head, seq), v (batch, head, seq)
extern "C" int svt_decode_attention(const void* q, const void* k,
                                    const void* v, const void* lengths,
                                    void* out, const long long* strides,
                                    int B, int Hq, int Hkv, int Smax, int D,
                                    float scale, int is_bf16, void* stream) {
  if (D != svt::K8_D || Hkv < 1 || Hq % Hkv || Hq / Hkv > svt::K8_MAXG ||
      B < 1 || B > 65535 || Hkv > 65535 || Smax < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  const bool wide = Hq / Hkv > 8;
  const cudaError_t err = !is_bf16
      ? svt::launch_decode<float, 1>(q, k, v, len, out, strides, B, Hq, Hkv,
                                     Smax, scale, st)
      : wide ? svt::launch_decode<__nv_bfloat16, 2>(q, k, v, len, out,
                                                    strides, B, Hq, Hkv,
                                                    Smax, scale, st)
             : svt::launch_decode<__nv_bfloat16, 1>(q, k, v, len, out,
                                                    strides, B, Hq, Hkv,
                                                    Smax, scale, st);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}
