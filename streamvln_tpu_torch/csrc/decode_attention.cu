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
// per element and head group: device memory bounds it (3.35 TB/s). At B = 1
// the live prefix is 0.6-67 MB per layer (the 7B's 4 KV heads to Llama-2's
// 32), so what decides the time is how many SMs have its bytes in flight,
// how soon, and how short the chain after them is: a split of the
// capacity leaves most blocks idle at short lengths, block-wide barriers
// per tile and long serial dot products stall, and a second launch to
// merge the splits costs as much as the bytes.
//
// Design:
// - The grid is (P, Hkv, B), and the P blocks of one (row, KV head) form a
//   thread-block cluster (kernel_plan.cuh::decode_cluster, from the shapes
//   alone): P the largest power of two, at most 16 (a non-portable size
//   the H100 schedules), of which one cluster per (row, KV head) is
//   resident in one wave, from the resident clusters the card reports for
//   each size (queried once at the first launch; one block per SM,
//   DecLayout). So the 7B's 4 KV heads and Gemma's one take clusters of
//   16, Qwen2-14B's 8 clusters of 8 (the card keeps 7 of 16 resident),
//   Llama-2's 32 clusters of 2 (30 of 4).
// - Each block reads length[b] on the device (the load in flight while
//   thread 0 starts the barriers) and takes an equal 16-aligned share of
//   the live prefix, at least 32 keys (kernel_plan.cuh::decode_keys), so a
//   short prefix keeps fewer blocks busy. A block whose share is empty
//   arrives on the cluster barrier and exits at once, and owns no row; a
//   block alone in its row writes the output from its own merge. A row of
//   length 0 gets zeros from its first block. The cluster barrier's
//   arrivals are relaxed: all they publish is the mbarrier inits, which
//   their own fence releases (release arrivals cost ~0.3 us a launch).
// - bf16: one producer thread loads the share's 64-key tiles of K and V
//   into a ring of stages in shared memory with TMA (tensor maps encoded on
//   the host per call, a kernel argument), in boxes of 16 key rows x 64
//   depths, 128-byte swizzled so that ldmatrix falls on 32 banks; a stage
//   completes on an mbarrier when its boxes' bytes have landed and is
//   released on another, with no block-wide barrier per tile. A box past
//   the share's end is not loaded and the last one ends at the share's
//   end, starting up to 15 keys early, rows the consumers mask
//   (kernel_plan.cuh::decode_box): no key at or past the share's end is
//   read, and no row is read twice but those. Four consumer warps take 16
//   keys each of every stage while the next stages land. f32: a producer
//   warp copies 16-byte chunks with cp.async into key rows padded by 16
//   bytes, V's rows past the share's end zero-filled. (cp.async for bf16
//   was as fast at head dim 128 and 2.3 us slower at 256 and 4096 keys;
//   1-D bulk copies, one per key row, took ~60 cycles per copy.)
// - bf16: S^T = K q^T and O^T = V^T P^T on the tensor cores (mma.sync
//   m16n8k16), so that the G <= 8 query heads of the KV head are the n side
//   (no padded rows; bf16 products are exact in f32); the online softmax
//   runs in the log2 domain in registers; P^T is moved into the B layout
//   by movmatrix and split into two bf16 terms (hi + lo, f32 weights to
//   about 2^-17); V^T comes from ldmatrix's transposing load. f32:
//   CUDA-core arithmetic.
// - One launch merges the splits in a fixed order (kernel_plan.cuh::
//   decode_weights: the largest max first, then the scaled terms summed in
//   index order): each block merges its four warps' (max, sum, output) in
//   shared memory, every row it holds before it sends any; among the nb
//   busy blocks of the cluster, the result of head row g goes to block g %
//   nb, with st.async to another block (it completes on the receiver's own
//   mbarrier: no cluster barrier at the end; the one cluster barrier is
//   split: all arrive after the mbarrier inits, a block waits only before
//   its first send) and with plain shared stores to itself; the owner
//   merges its rows over the nb blocks in split order, normalises and
//   writes the output. Two calls give bit-equal results; the wrapper
//   allocates the output only, and nothing lives in device memory between
//   launches.
// - What holds it back (%globaltimer stamps per block, tools/ablate.py
//   k8_stamps; PERF.md): a block streams ~25-45 GB/s, with TMA or
//   cp.async, whatever the ring's depth, so one KV head's cluster (at most
//   16 SMs, inside one GPC) streams Gemma's 4 MB prefix at ~0.7 TB/s; a
//   pass costs ~4 us besides its streaming (the launch ~1.1 us, the length
//   read and barriers ~0.6 us, the merge ~1.5-2 us). (A second merge level
//   over several clusters of a row, through an f32 scratch and per-row
//   tickets, took ~3 us more and moved only Gemma past 3584 keys, by ~0.5
//   us: PERF.md.)
//
// Head dims: 128 (Qwen2 and most families) and 256 (Gemma), a template
// parameter. At D = 256 a key row is twice the bytes: a bf16 stage of 64
// keys (K and V) takes 64 KB, so the ring has three stages (four of 32 KB
// at 128) and a block ~210 KB of shared memory, and each consumer warp
// holds twice the O^T and q^T fragments; only bf16 with G <= 8 (one n tile
// of heads: Gemma's G = 8) is instantiated there.
//
// C interface (ctypes): q [B, 1, Hq, D] and k/v strided (elements; the
// head dim contiguous, k/v rows 16-byte aligned); out contiguous [B, 1,
// Hq, D]. D = 128 with G <= 16 (bf16 or f32), or D = 256 with G <= 8
// (bf16).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "kernel_plan.cuh"
#include "pipeline.cuh"
#include "tma.cuh"

namespace svt {
// Internal linkage: the library exports its C entry point only, so no
// instantiation or static local of the shared headers' templates is merged
// with another loaded library's (int4_matmul.cu includes them too).
namespace {

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

// TMA descriptors of the K and V caches (bf16): kDecBoxRows-key x
// 64-depth boxes, 128-byte swizzled; the f32 instance takes an empty
// argument in their place.
struct DecMaps {
  CUtensorMap k, v;
};
struct NoMaps {};

// The block's shared-memory layout (kernel_plan.cuh::DecLayout): NG tiles
// of 8 query heads for bf16, all K8_MAXG for f32.
template <typename T, int NG, int D>
using DecShape =
    DecLayout<sizeof(T), D, sizeof(T) == 2 ? 8 * NG : K8_MAXG>;
template <typename T, int NG, int D>
using MapsOf =
    std::conditional_t<DecShape<T, NG, D>::TMA, DecMaps, NoMaps>;

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
// (no padded rows): S^T [16 keys x 8 NG heads] = K q^T, then O^T [D x 8
// NG] += V^T P^T, K and V^T the A operands from shared memory (ldmatrix,
// V^T transposed on the load), q^T and P^T the B operands in registers
// (P^T's accumulator layout turned into the B layout by movmatrix). Writes
// the warp's partial (heads < G) to the merge area.
template <typename T, int NG, int D>
__device__ __forceinline__ void consume_bf16(
    unsigned char* sm, uint32_t base, uint32_t full0, uint32_t empty0,
    const T* qh, long long q_sh, int G, int nkeys, int ntiles, float sl2,
    int warp, int lane) {
  using S = DecShape<T, NG, D>;
  constexpr int DS = D / 16;         // 16-wide steps of the head dim
  const int gq = lane >> 2, tq = lane & 3;
  uint32_t qb[NG][DS][2];            // B fragments of q^T, 16 depths each
#pragma unroll
  for (int n = 0; n < NG; ++n)
#pragma unroll
    for (int s = 0; s < DS; ++s) {
      qb[n][s][0] = q_pair(qh, 8 * n + gq, G, q_sh, 16 * s + 2 * tq);
      qb[n][s][1] = q_pair(qh, 8 * n + gq, G, q_sh, 16 * s + 2 * tq + 8);
    }
  // O^T (i, n): head dims 16 i + gq (+ 8 for [2], [3]), heads 8 n + 2 tq
  // (+ 1 for [1], [3]); m, l per head 8 n + 2 tq + c
  float o[DS][NG][4], m[NG][2], l[NG][2];
#pragma unroll
  for (int n = 0; n < NG; ++n) {
#pragma unroll
    for (int i = 0; i < DS; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][n][e] = 0.f;
    m[n][0] = m[n][1] = K8_NEG_INF;
    l[n][0] = l[n][1] = 0.f;
  }
  // ldmatrix addresses: K rows key lane & 15, depth +8 for lanes 16-31; V
  // (transposed) rows key (lane & 7) + 8 (lane >> 4), depth +8 for lanes
  // 8-15 and 24-31. In the swizzled boxes (128-byte rows, 64 depths, a
  // column of them 8 KB) the 16-byte chunk j of row r lies at chunk j ^ (r
  // & 7), and r & 7 is lane & 7 for every row this lane addresses.
  const uint32_t k_row = (16 * warp + (lane & 15)) * 128;
  const uint32_t v_row = S::TILE + (16 * warp + (lane & 7)
      + ((lane >> 4) << 3)) * 128;
  const int kh = lane >> 4, vh = (lane >> 3) & 1, x = lane & 7;
  // the 16 depths of step s from depth 8 hf on: their box column, then
  // their chunk in the row
  auto chunk = [x](int s, int hf) -> uint32_t {
    return (s >> 2) * (kDecTile * 128)
        + ((((s & 3) << 1 | hf) ^ x) << 4);
  };
  const int jb = 16 * warp / kDecBoxRows;   // the box of the warp's rows
  const int rb = 16 * warp - jb * kDecBoxRows;   // their first in the box
  for (int t = 0; t < ntiles; ++t) {
    const int st = t % S::ST;
    mbar_wait(full0 + 8 * st, (t / S::ST) & 1);
    // a box past the share's end is not loaded, and the last one ends at
    // the share's end (kernel_plan.cuh::decode_box): this warp's rows
    // before `first` are earlier keys, or zeros, and are masked
    const int first = decode_box(nkeys, t, jb).first - rb;
    if (jb < decode_boxes(nkeys, t) && first < 16) {
      const uint32_t stg = base + st * S::STAGE;
      // sc[n][e]: key gq + 8 (e >> 1), head 8 n + 2 tq + (e & 1)
      float sc[NG][4];
#pragma unroll
      for (int n = 0; n < NG; ++n)
        sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
      for (int s = 0; s < DS; ++s) {
        uint32_t kf[4];
        ldsm_x4(kf, stg + k_row + chunk(s, kh));
#pragma unroll
        for (int n = 0; n < NG; ++n) mma_bf16(sc[n], kf, qb[n][s]);
      }
      uint32_t bh[NG][2], bl[NG][2];           // P^T as B: hi and lo
#pragma unroll
      for (int n = 0; n < NG; ++n) {
        float mx[2];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[n][e] = gq + 8 * (e >> 1) >= first ? sc[n][e] * sl2
                                                 : K8_NEG_INF;
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
          for (int i = 0; i < DS; ++i) {
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
      for (int i = 0; i < DS; ++i) {
        uint32_t vf[4];
        ldsm_x4_t(vf, stg + v_row + chunk(i, vh));
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
  float* wacc = reinterpret_cast<float*>(sm + S::W_ACC) + warp * S::G * D;
  float* wm = reinterpret_cast<float*>(sm + S::W_M) + warp * S::G;
  float* wl = reinterpret_cast<float*>(sm + S::W_L) + warp * S::G;
#pragma unroll
  for (int n = 0; n < NG; ++n)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int g = 8 * n + 2 * tq + c;
      if (g < G) {
#pragma unroll
        for (int i = 0; i < DS; ++i) {
          wacc[g * D + 16 * i + gq] = o[i][n][c];
          wacc[g * D + 16 * i + gq + 8] = o[i][n][c + 2];
        }
        if (gq == 0) {
          wm[g] = m[n][c];
          wl[g] = l[n][c];
        }
      }
    }
}

// f32 consumer (D = 128): 16 keys of every stage on the CUDA cores (lane:
// key lane & 15, half lane >> 4 of the head dim for the scores; head dims
// 4 lane..4 lane + 3 for P V). q in f32 at Q_OFF.
template <typename T>
__device__ __forceinline__ void consume_f32(
    unsigned char* sm, uint32_t full0, uint32_t empty0, int G, int nkeys,
    int ntiles, float sl2, int warp, int lane) {
  constexpr int K8_D = 128;
  using S = DecShape<T, 1, K8_D>;
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
  float* wacc = reinterpret_cast<float*>(sm + S::W_ACC) + warp * S::G * K8_D;
  float* wm = reinterpret_cast<float*>(sm + S::W_M) + warp * S::G;
  float* wl = reinterpret_cast<float*>(sm + S::W_L) + warp * S::G;
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

// An owner's merge of its head rows g = p, p + nb, ... over the nb <= N
// busy blocks' partials in its receive area, in split order, normalised
// into the output: thread t takes head dims t + 128 j.
template <int N, typename T, int NG, int D>
__device__ __forceinline__ void merge_owned(const unsigned char* sm, T* ob,
                                            int p, int G, int nb) {
  using S = DecShape<T, NG, D>;
  const float* racc = reinterpret_cast<const float*>(sm + S::R_ACC);
  const float* rml = reinterpret_cast<const float*>(sm + S::R_ML);
  for (int g = p; g < G; g += nb) {
    const int s0 = decode_slot(g, nb, 0);
    float pm[N], pl[N], cw[N], mm, ll;
#pragma unroll
    for (int r = 0; r < N; ++r)
      if (r < nb) {
        pm[r] = rml[2 * (s0 + r)];
        pl[r] = rml[2 * (s0 + r) + 1];
      }
    decode_weights<N>(pm, pl, nb, cw, mm, ll);
#pragma unroll
    for (int d = threadIdx.x; d < D; d += 128) {
      float oo = 0.f;
#pragma unroll
      for (int r = 0; r < N; ++r)
        if (r < nb && pl[r] > 0.f) oo += racc[(s0 + r) * D + d] * cw[r];
      ob[g * D + d] = from_f<T>(ll > 0.f ? oo / ll : 0.f);
    }
  }
}

// NG: heads of a KV head in tiles of 8 (bf16: 1 for G <= 8, else 2); D:
// the head dim
template <typename T, int NG, int D>
__global__ void __launch_bounds__(K8_THREADS, 1)
decode_attention_kernel(__grid_constant__ const MapsOf<T, NG, D> maps,
                        const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ lengths, T* __restrict__ out,
                        long long q_sb, long long q_sh, long long k_sb,
                        long long k_sh, long long k_ss, long long v_sb,
                        long long v_sh, long long v_ss, int Hq, int Hkv,
                        int Smax, float scale) {
  using S = DecShape<T, NG, D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int P = gridDim.x, p = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  if constexpr (S::TMA) {
    if (threadIdx.x == 128) {        // the descriptors, ahead of the loads
      tma_prefetch(&maps.k);
      tma_prefetch(&maps.v);
    }
  }
  const int length = lengths[b];     // in flight while the barriers start
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;      // the TMA boxes' base
  unsigned char* sm = smem_raw + (base - raw);
  const uint32_t full0 = base + S::BAR_OFF, empty0 = full0 + 8 * S::ST;
  const uint32_t recv = empty0 + 8 * S::ST;
  if (threadIdx.x == 0) {
    for (int i = 0; i < S::ST; ++i) {
      // the TMA thread, or the producer lanes' cp.async arrivals
      mbar_init(full0 + 8 * i, S::TMA ? 1 : 32 * K8_PRODUCERS);
      mbar_init(empty0 + 8 * i, 4);            // the consumer warps
    }
    mbar_init(recv, 1);                        // + the bytes of the rows
    mbar_init_fence();
  }
  const int len = min(max(length, 0), Smax);
  T* ob = out + (static_cast<size_t>(b) * Hq + h * G) * D;
  if (len == 0) {                    // no key: zeros, from the first block
    if (p == 0)
      for (int i = threadIdx.x; i < G * D; i += K8_THREADS)
        ob[i] = from_f<T>(0.f);
    return;
  }
  const Range kr = decode_keys(len, P, p);
  if (kr.end == kr.begin) {          // an empty share: out of the merge
    cluster_arrive_relaxed();        // (the barrier's count, exited or not)
    return;
  }
  const int nb = decode_busy(len, P);   // the busy blocks, 0..nb-1
  const int nkeys = kr.end - kr.begin;
  const int ntiles = (nkeys + kDecTile - 1) / kDecTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* qh = q + b * q_sb + h * G * q_sh;
  __syncthreads();
  cluster_arrive_relaxed();          // the receive barrier is initialised

  if (warp >= 4) {
    if constexpr (S::TMA) {
      // ---- producer (bf16): one thread loads each tile's K and V with
      // TMA, in boxes of kDecBoxRows keys (D / 64 of them side by side); a
      // box past the share's end is not loaded, and the last one ends at
      // the share's end (it starts up to kDecBoxRows - 1 keys early: keys
      // of the rows before, or zeros before key 0), so that no key at or
      // past the share's end is read ----
      if (threadIdx.x == 128)
        for (int t = 0; t < ntiles; ++t) {
          const int st = t % S::ST;
          if (t >= S::ST) mbar_wait(empty0 + 8 * st, (t / S::ST - 1) & 1);
          const int nbox = decode_boxes(nkeys, t);
          const uint32_t stg = base + st * S::STAGE, bar = full0 + 8 * st;
          mbar_arrive_tx(bar, nbox * kDecBoxRows * S::RB * 2);
          for (int j = 0; j < nbox; ++j) {
            const int row = kr.begin + decode_box(nkeys, t, j).row;
            const uint32_t dst = stg + j * (kDecBoxRows * 128);
#pragma unroll
            for (int c = 0; c < D / 64; ++c) {
              tma_load_4d(dst + c * (kDecTile * 128), &maps.k, bar, 64 * c,
                          row, h, b);
              tma_load_4d(dst + S::TILE + c * (kDecTile * 128), &maps.v,
                          bar, 64 * c, row, h, b);
            }
          }
        }
    } else {
      // ---- producers (f32): 16-byte chunks of the tile's key rows of K
      // and V with cp.async, none at or past the share's end (V's rows
      // there are zeros); lane i takes chunk i % CH of rows i / CH, i / CH
      // + RS, ... ----
      constexpr int CH = S::RB / 16;             // chunks of a row
      constexpr int RS = 32 * K8_PRODUCERS / CH; // rows per step
      const int i = threadIdx.x - 128, ch = i % CH, j0 = i / CH;
      const T* kb = k + b * k_sb + h * k_sh + (kr.begin + j0) * k_ss
          + ch * (16 / sizeof(T));
      const T* vb = v + b * v_sb + h * v_sh + (kr.begin + j0) * v_ss
          + ch * (16 / sizeof(T));
      for (int t = 0; t < ntiles; ++t) {
        const int st = t % S::ST;
        if (t >= S::ST) mbar_wait(empty0 + 8 * st, (t / S::ST - 1) & 1);
        const int nk = min(kDecTile, nkeys - t * kDecTile);
        const uint32_t ks = base + st * S::STAGE + j0 * S::ROW + ch * 16;
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
    }
    return;
  }
  if constexpr (sizeof(T) == 2) {
    consume_bf16<T, NG, D>(sm, base, full0, empty0, qh, q_sh, G, nkeys,
                           ntiles, scale * kLog2e, warp, lane);
  } else {
    static_assert(D == 128, "f32 decode takes head dim 128");
    float* qs = reinterpret_cast<float*>(sm + S::Q_OFF);
    for (int i = threadIdx.x; i < G * D; i += 128)
      qs[i] = qh[(i / D) * q_sh + i % D];
    bar_sync(1, 128);
    consume_f32<T>(sm, full0, empty0, G, nkeys, ntiles, scale * kLog2e, warp,
                   lane);
  }

  // ---- merge: the block's four warps (the merge weights once per row),
  // sent to the block that owns the head row (g % nb): to another block
  // with st.async, to itself with plain shared stores; each owner then
  // merges its rows over the nb busy blocks. A block alone in its row
  // writes the output at once. Warp w takes rows w + 4 i, each lane head
  // dims 4 lane + 128 c + 0..3; every row is merged before the first send,
  // so that the loads of all rows overlap. ----
  constexpr int RW = (S::G + 3) / 4, NC = D / 128;
  const bool alone = nb == 1;
  bar_sync(1, 128);                  // the warps' partials are written
  float4 o4[RW][NC];
  float2 ml[RW];
  {
    const float* wacc = reinterpret_cast<const float*>(sm + S::W_ACC);
    const float* wm = reinterpret_cast<const float*>(sm + S::W_M);
    const float* wl = reinterpret_cast<const float*>(sm + S::W_L);
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int g = warp + 4 * i;
      if (g >= G) break;
      const float pm[4] = {wm[g], wm[S::G + g], wm[2 * S::G + g],
                           wm[3 * S::G + g]};
      const float pl[4] = {wl[g], wl[S::G + g], wl[2 * S::G + g],
                           wl[3 * S::G + g]};
      float cw[4];
      decode_weights<4>(pm, pl, 4, cw, ml[i].x, ml[i].y);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int w = 0; w < 4; ++w)
          if (pl[w] > 0.f) {
            const float4 a = *reinterpret_cast<const float4*>(
                wacc + (w * S::G + g) * D + 4 * lane + 128 * c);
            acc.x += a.x * cw[w];
            acc.y += a.y * cw[w];
            acc.z += a.z * cw[w];
            acc.w += a.w * cw[w];
          }
        o4[i][c] = acc;
      }
    }
  }
  if (!alone) cluster_wait();        // every receive barrier is ready
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int g = warp + 4 * i;
    if (g >= G) break;
    if (alone) {
      const float ll = ml[i].y;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        T* o = ob + g * D + 4 * lane + 128 * c;
        o[0] = from_f<T>(ll > 0.f ? o4[i][c].x / ll : 0.f);
        o[1] = from_f<T>(ll > 0.f ? o4[i][c].y / ll : 0.f);
        o[2] = from_f<T>(ll > 0.f ? o4[i][c].z / ll : 0.f);
        o[3] = from_f<T>(ll > 0.f ? o4[i][c].w / ll : 0.f);
      }
      continue;
    }
    const uint32_t owner = decode_owner(g, nb);
    const uint32_t slot = decode_slot(g, nb, p);
    const uint32_t bar = cluster_addr(recv, owner);
    const bool self = owner == static_cast<uint32_t>(p);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const uint32_t off = S::R_ACC + 4 * (slot * D + 4 * lane + 128 * c);
      if (self)                      // its own row: a plain shared store
        *reinterpret_cast<float4*>(sm + off) = o4[i][c];
      else
        st_async4(cluster_addr(base + off, owner), o4[i][c], bar);
    }
    if (lane == 0) {
      if (self)
        *reinterpret_cast<float2*>(sm + S::R_ML + 8 * slot) = ml[i];
      else
        st_async2(cluster_addr(base + S::R_ML + 8 * slot, owner), ml[i],
                  bar);
    }
  }
  const int owned = decode_owned(p, G, nb);
  if (alone || owned == 0) return;
  // the other busy blocks' rows, and this block's own (stored above)
  if (threadIdx.x == 0)
    mbar_arrive_tx(recv, owned * (nb - 1) * (D * 4 + 8));
  mbar_wait(recv, 0);
  bar_sync(1, 128);
  if (nb <= 4)                       // the merge unrolled over nb or more
    merge_owned<4, T, NG, D>(sm, ob, p, G, nb);
  else if (nb <= 8)
    merge_owned<8, T, NG, D>(sm, ob, p, G, nb);
  else
    merge_owned<kDecCluster, T, NG, D>(sm, ob, p, G, nb);
}

// Clusters of p = 1..kDecCluster blocks the card keeps resident at once
// (0 where it refuses a size).
template <typename T, int NG, int D>
cudaError_t resident_clusters(int* resident) {
  using S = DecShape<T, NG, D>;
  for (int p = 1; p <= kDecCluster; ++p) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(p, 1, 1);
    cfg.blockDim = dim3(K8_THREADS, 1, 1);
    cfg.dynamicSmemBytes = S::SMEM;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = p;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(
            &n, decode_attention_kernel<T, NG, D>, &cfg) != cudaSuccess) {
      cudaGetLastError();            // a size the card refuses: none
      n = 0;
    }
    resident[p - 1] = n;
  }
  return resident[0] > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

// Per instance, once: the launch attributes, the blocks an SM holds and
// the resident clusters.
template <typename T, int NG, int D>
struct Instance {
  int resident[kDecCluster] = {};
  int per_sm = 0;
  cudaError_t ready;
  Instance() {
    ready = allow_launch(decode_attention_kernel<T, NG, D>,
                         DecShape<T, NG, D>::SMEM, true);
    if (ready == cudaSuccess)
      ready = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, decode_attention_kernel<T, NG, D>, K8_THREADS,
          DecShape<T, NG, D>::SMEM);
    if (ready == cudaSuccess) ready = resident_clusters<T, NG, D>(resident);
  }
  static const Instance& get() {
    static const Instance inst;
    return inst;
  }
};

// P, the blocks an SM holds and the resident clusters of P blocks
template <typename T, int NG, int D>
cudaError_t plan_decode(int B, int Hkv, int Smax, int* out3) {
  const Instance<T, NG, D>& in = Instance<T, NG, D>::get();
  if (in.ready != cudaSuccess) return in.ready;
  out3[0] = decode_cluster(Smax, B, Hkv, in.resident);
  out3[1] = in.per_sm;
  out3[2] = in.resident[out3[0] - 1];
  return cudaSuccess;
}

template <typename T, int NG, int D>
cudaError_t launch_decode(const void* q, const void* k, const void* v,
                          const int* lengths, void* out,
                          const long long* st8, int B, int Hq, int Hkv,
                          int Smax, float scale, cudaStream_t st) {
  int pl[3];
  const cudaError_t e = plan_decode<T, NG, D>(B, Hkv, Smax, pl);
  if (e != cudaSuccess) return e;
  MapsOf<T, NG, D> maps = {};
  if constexpr (DecShape<T, NG, D>::TMA) {
    if (!encode_view(&maps.k, k, B, Smax, Hkv, D, st8[2], st8[4], st8[3], 64,
                     kDecBoxRows) ||
        !encode_view(&maps.v, v, B, Smax, Hkv, D, st8[5], st8[7], st8[6], 64,
                     kDecBoxRows))
      return cudaErrorInvalidValue;
  }
  return launch_clustered(
      decode_attention_kernel<T, NG, D>, dim3(pl[0], Hkv, B), K8_THREADS,
      pl[0], DecShape<T, NG, D>::SMEM, st, maps, static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v), lengths,
      static_cast<T*>(out), st8[0], st8[1], st8[2], st8[3], st8[4], st8[5],
      st8[6], st8[7], Hq, Hkv, Smax, scale);
}

// the instance of (D, dtype, G); false where none takes it
bool valid(int B, int Hq, int Hkv, int Smax, int D, int is_bf16) {
  const bool wide = Hkv > 0 && Hq / Hkv > 8;
  return !((D != 128 && D != 256) || (D == 256 && (!is_bf16 || wide)) ||
           Hkv < 1 || Hq % Hkv || Hq / Hkv > K8_MAXG || B < 1 ||
           B > 65535 || Hkv > 65535 || Smax < 1);
}

}  // namespace
}  // namespace svt

using svt::launch_decode;
using svt::plan_decode;
using bf16 = __nv_bfloat16;

// strides: q (batch, head), k (batch, head, seq), v (batch, head, seq)
extern "C" int svt_decode_attention(const void* q, const void* k,
                                    const void* v, const void* lengths,
                                    void* out, const long long* strides,
                                    int B, int Hq, int Hkv, int Smax, int D,
                                    float scale, int is_bf16, void* stream) {
  if (!svt::valid(B, Hq, Hkv, Smax, D, is_bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  const bool wide = Hq / Hkv > 8;
  const cudaError_t err =
      D == 256 ? launch_decode<bf16, 1, 256>(q, k, v, len, out, strides, B,
                                             Hq, Hkv, Smax, scale, st)
      : !is_bf16 ? launch_decode<float, 1, 128>(q, k, v, len, out, strides,
                                                B, Hq, Hkv, Smax, scale, st)
      : wide ? launch_decode<bf16, 2, 128>(q, k, v, len, out, strides, B, Hq,
                                           Hkv, Smax, scale, st)
             : launch_decode<bf16, 1, 128>(q, k, v, len, out, strides, B, Hq,
                                           Hkv, Smax, scale, st);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

// The launch plan of these shapes on this card: {P, blocks per SM of the
// instance, resident clusters of P blocks}.
extern "C" int svt_decode_attention_plan(int B, int Hq, int Hkv, int Smax,
                                         int D, int is_bf16, int* out3) {
  if (!svt::valid(B, Hq, Hkv, Smax, D, is_bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool wide = Hq / Hkv > 8;
  return static_cast<int>(
      D == 256 ? plan_decode<bf16, 1, 256>(B, Hkv, Smax, out3)
      : !is_bf16 ? plan_decode<float, 1, 128>(B, Hkv, Smax, out3)
      : wide ? plan_decode<bf16, 2, 128>(B, Hkv, Smax, out3)
             : plan_decode<bf16, 1, 128>(B, Hkv, Smax, out3));
}
