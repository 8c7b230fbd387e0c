// The attention forward shared by K1 (vit_attention.cu), K2 and K3
// (flash_attention.cu), written for Hopper (sm_90a).
//
// A block owns a 128-row query tile of one (batch, query head): 64 rows
// for each of its two consumer warpgroups. Its first warpgroup is the
// producer: one warp loads the Q tile once with TMA, then walks the key
// tiles (BN keys, FwdShape) and keeps K and V tiles in flight into a ring
// of ST stages in shared memory, each stage signalled
// by a "full" mbarrier (the TMA bytes and one producer arrival) and
// released by an "empty" mbarrier (one arrival per consumer warp). The
// producer also reads each tile's key positions: it skips a tile whose
// smallest position exceeds the block's largest query position (the exact
// skip rule; positions need not be sorted), and marks a tile "full" when
// its largest position is <= the block's smallest query position and it
// has no ragged tail, so that the consumers apply no per-element mask to
// it. A stage with k0 = -1 ends the walk.
//
// Each consumer warpgroup computes S = Q K^T with wgmma (both operands in
// shared memory, K-major), runs the online softmax in registers in the
// log2 domain (scale * log2(e) folded into the exponent's FMA), and
// keeps P in registers as the bf16 A operand of O += P V (wgmma with A
// from registers; V is the B operand read MN-major with the transpose
// flag, so nothing is transposed by hand). The softmax of one tile runs
// while the previous tile's P V is on the tensor cores, and two consumer
// warpgroups take turns issuing their products (named barriers), so the
// softmax of one overlaps the products of the other. setmaxnreg moves
// registers from the producer warpgroup to the consumers.
//
// Head dims: the padded head dim DP is 64 (CLIP), 80 (SigLIP's 72) or 128
// (Qwen2). Each tile is kept as 64-column chunks with the 128-byte swizzle
// (a 128-byte row is one swizzle span), and DP = 80 adds a 16-column chunk
// with the 32-byte swizzle; the TMA box of that chunk reads columns 64-71
// and zero-fills 72-79, which add nothing to Q K^T and give output
// columns that are never stored. Every chunk region starts on a 1024-byte
// boundary, as the swizzle pattern and the wgmma descriptors assume.
//
// Numerics: bf16 operands, f32 accumulation; P rounded to bf16 before PV;
// one 1/rowsum at the end. A masked score is -inf; a row whose running
// max never rose above its start of -1e30 (no visible key) is written as
// exact zeros and, with `lse` set (K3), an LSE of -1e30. The LSE is in natural-log
// units (m * ln 2 + ln l), as K4/K5 recompute P = exp(S - LSE) from it.
#pragma once

#include <cuda.h>   // CUtensorMap and its enums; the encoder is looked
                    // up through cudart (no libcuda link)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "attention_plan.cuh"
#include "attention_tile.cuh"
#include "pipeline.cuh"   // smem_u32, the mbarrier wrappers, ex2

namespace svt {
// Internal linkage: the K1 and K2/K3 libraries both instantiate this code,
// and the static locals below (the encoder, the shared-memory attribute
// set once per kernel) must not be merged across them when both are
// loaded into one process.
namespace {

struct FwdArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  float* lse;           // [B, Hq, Sq] f32, or null (no logsumexp)
  const int* q_pos;     // [B, Sq], or null (full attention, K1)
  const int* k_pos;     // [B, Sk], or null
  // element strides of (batch, seq, head); the head dim is contiguous
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int B, Sq, Sk, Hq, Hkv, D;
  float scale;
  float soft_cap;       // <= 0: none
};

// TMA descriptors of q, k, v: [0] the 64-column box (128-byte swizzle),
// [1] the 16-column box of DP = 80 (32-byte swizzle; unused otherwise).
struct FwdMaps {
  CUtensorMap q[2];
  CUtensorMap k[2];
  CUtensorMap v[2];
};

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ---- PTX wrappers --------------------------------------------------------

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

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), swizzle (1 = 128 B, 3 = 32 B).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t swizzle) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
       | static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16
       | static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32
       | static_cast<uint64_t>(swizzle) << 62;
}

constexpr uint32_t kSw128 = 1, kSw32 = 3;

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of wgmma accumulators
// across the asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define SVT_R4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define SVT_R32(d)                                                    \
  SVT_R4(d, 0), SVT_R4(d, 4), SVT_R4(d, 8), SVT_R4(d, 12), SVT_R4(d, 16), \
      SVT_R4(d, 20), SVT_R4(d, 24), SVT_R4(d, 28)

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : SVT_R32(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, "
      "0, 0;\n}\n"
      : SVT_R32(d), SVT_R32((d + 32))
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db,
                                         int scale_d) {
  if (N == 128) wgmma_ss_n128(d, da, db, scale_d);
  else wgmma_ss_n64(d, da, db, scale_d);
}

// d[64 x 64] += A[64 x 16] (registers) B[16 x 64], B MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : SVT_R32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 16] += A[64 x 16] (registers) B[16 x 16], B MN-major.
__device__ __forceinline__ void wgmma_rs_n16(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, "
      "1;\n}\n"
      : SVT_R4(d, 0), SVT_R4(d, 4)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef SVT_R32
#undef SVT_R4

// ---- tile geometry -------------------------------------------------------

constexpr int kConsumers = 2;          // consumer warpgroups per block

template <int DP>
struct FwdShape {
  static constexpr int BM = 64 * kConsumers;   // query rows per block
  // keys per tile: 128 where the stages fit (fewer pipeline round trips
  // per key, wider S products), else 64 (DP = 128)
  static constexpr int BN = DP <= 80 ? 128 : 64;
  static constexpr int NW = DP / 64;                 // 64-column chunks
  static constexpr int TAIL = DP % 64;               // 0 or 16
  static_assert(TAIL == 0 || TAIL == 16, "head dim 64, 80 or 128");
  static constexpr int ST = 4;   // stages: a consumer holds two at a time
  static constexpr int THREADS = 128 * (kConsumers + 1);
  // bytes of a Q and of a K/V tile, and the offsets of their tail chunks
  static constexpr int Q_BYTES = BM * DP * 2;
  static constexpr int KV_BYTES = BN * DP * 2;
  static constexpr int Q_TAIL = NW * BM * 128;
  static constexpr int KV_TAIL = NW * BN * 128;
  static constexpr int Q_OFF = 0;
  // Q buffers: two where a block walks several items (the next item's Q
  // loads during the current one); the prefill and training kernels
  // (DP = 128, positions) take one item per block and need one
  static constexpr int QB = DP == 128 ? 1 : 2;
  static constexpr int K_OFF = Q_OFF + QB * Q_BYTES;
  static constexpr int V_OFF = K_OFF + ST * KV_BYTES;
  static constexpr int POS_OFF = V_OFF + ST * KV_BYTES;
  static constexpr int META_OFF = POS_OFF + ST * BN * 4;
  static constexpr int BAR_OFF = META_OFF + ST * 8;     // 8-byte aligned
  static constexpr int SMEM = BAR_OFF + (4 + 2 * ST) * 8 + 1024;  // + align
};

// ---- consumer steps -------------------------------------------------------

__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// wgmma descriptors advance linearly with the address (16-byte units), so
// the products below add constant offsets to descriptors made once.
__device__ __forceinline__ uint64_t desc_add(uint64_t d, uint32_t bytes) {
  return d + (bytes >> 4);
}

// Issue S = Q K^T for the 64 query rows of one consumer (DP / 16 steps).
// dq: Q's first chunk at this consumer's rows; dqt: Q's tail chunk; dk,
// dkt: the K stage's first and tail chunks.
template <int DP>
__device__ __forceinline__ void issue_qk(float* s, uint64_t dq, uint64_t dqt,
                                         uint64_t dk, uint64_t dkt) {
  using S = FwdShape<DP>;
#pragma unroll
  for (int c = 0; c < S::NW; ++c) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<S::BN>(s, desc_add(dq, c * S::BM * 128 + kk * 32),
                      desc_add(dk, c * S::BN * 128 + kk * 32), c + kk > 0);
  }
  if (S::TAIL) wgmma_ss<S::BN>(s, dqt, dkt, 1);
}

// Issue O += P V: P's 16-key step kk is the A fragment p[kk]; V is read
// MN-major (transposed) from its 64-column chunks (dv) and the 16-column
// tail (dvt).
template <int DP>
__device__ __forceinline__ void issue_pv(float* o, const uint32_t (*p)[4],
                                         uint64_t dv, uint64_t dvt) {
  using S = FwdShape<DP>;
#pragma unroll
  for (int kk = 0; kk < S::BN / 16; ++kk) {
#pragma unroll
    for (int c = 0; c < S::NW; ++c)
      wgmma_rs_n64(o + 32 * c, p[kk],
                   desc_add(dv, c * S::BN * 128 + kk * 16 * 128));
    if (S::TAIL)
      wgmma_rs_n16(o + 32 * S::NW, p[kk], desc_add(dvt, kk * 16 * 32));
  }
}

// Online softmax of one score tile of BN keys (NS = BN / 2 values a
// thread: rows r0 and r0 + 8, columns 8j + 2 quad + {0, 1}). The running
// max m is kept in the log2 domain. Plain scores are scaled inside the
// exponent, ex2(s * sl2 - m) in one FMA; soft-capped scores are moved to
// the log2 domain first. A masked score becomes -inf, so it adds exactly
// 0, and a row that has seen no key keeps m = -1e30. Returns the rescale
// factors al of the earlier sums and leaves the probabilities in s and
// the per-thread row sums in l.
template <int NS>
__device__ __forceinline__ void softmax_tile(
    float* s, bool full, bool capped, bool use_pos, const int* kpos, int k0,
    int sk, int quad, int qp0, int qp1, float sl2, float cap_in,
    float cap_out, float& m0, float& m1, float& l0, float& l1, float& al0,
    float& al1) {
  // each branch is uniform over the block
  float f = sl2;
  if (capped) {
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = tanhf(s[i] * cap_in) * cap_out;
    f = 1.f;
  }
  if (!full) {
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int col = 8 * (i / 4) + 2 * quad + (i & 1);
      const bool vis = use_pos ? kpos[col] <= ((i & 2) ? qp1 : qp0)
                               : k0 + col < sk;
      if (!vis) s[i] = -INFINITY;
    }
  }
  float tm0 = -INFINITY, tm1 = -INFINITY;
#pragma unroll
  for (int i = 0; i < NS; i += 4) {
    tm0 = fmaxf(tm0, fmaxf(s[i], s[i + 1]));
    tm1 = fmaxf(tm1, fmaxf(s[i + 2], s[i + 3]));
  }
  tm0 = fmaxf(tm0, __shfl_xor_sync(0xffffffffu, tm0, 1));
  tm0 = fmaxf(tm0, __shfl_xor_sync(0xffffffffu, tm0, 2));
  tm1 = fmaxf(tm1, __shfl_xor_sync(0xffffffffu, tm1, 1));
  tm1 = fmaxf(tm1, __shfl_xor_sync(0xffffffffu, tm1, 2));
  const float mn0 = fmaxf(m0, tm0 * f), mn1 = fmaxf(m1, tm1 * f);
  al0 = ex2(m0 - mn0);
  al1 = ex2(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int i = 0; i < NS; i += 4) {
    s[i] = ex2(fmaf(s[i], f, -mn0));
    s[i + 1] = ex2(fmaf(s[i + 1], f, -mn0));
    s[i + 2] = ex2(fmaf(s[i + 2], f, -mn1));
    s[i + 3] = ex2(fmaf(s[i + 3], f, -mn1));
    ps0 += s[i] + s[i + 1];
    ps1 += s[i + 2] + s[i + 3];
  }
  l0 = l0 * al0 + ps0;   // per-thread partial, reduced over the quad
  l1 = l1 * al1 + ps1;
}

template <int NO>
__device__ __forceinline__ void rescale(float* o, float al0, float al1) {
#pragma unroll
  for (int i = 0; i < NO; i += 4) {
    o[i] *= al0; o[i + 1] *= al0;
    o[i + 2] *= al1; o[i + 3] *= al1;
  }
}

// The score accumulators of key columns 16kk..16kk+15 are exactly the A
// fragment of one 16-key step of P V, rounded to bf16.
template <int NK>
__device__ __forceinline__ void pack_p(const float* s, uint32_t (*p)[4]) {
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
      p[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
  }
}

// One arrival per warp on a stage's empty barrier, after the warp's
// products that read the stage are done.
__device__ __forceinline__ void release(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// ---- the kernel ----------------------------------------------------------

// Block i walks the work items i, i + grid, ... (attention_plan.cuh: a
// persistent grid for the vision tower, one item per block under
// positions). With two Q buffers the producer loads the next item's Q and
// first K/V tiles while the consumers finish the current item; the stage
// ring runs on across items.
template <int DP>
__global__ void __launch_bounds__(FwdShape<DP>::THREADS, 1)
attention_fwd_kernel(__grid_constant__ const FwdMaps maps, const FwdArgs a) {
  using S = FwdShape<DP>;
  constexpr int BM = S::BM, BN = S::BN, NW = S::NW, TAIL = S::TAIL;
  constexpr int ST = S::ST;

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  int* kpos_s = reinterpret_cast<int*>(sm + S::POS_OFF);
  int* meta_k0 = reinterpret_cast<int*>(sm + S::META_OFF);
  int* meta_full = meta_k0 + ST;
  const uint32_t qfull0 = base + S::BAR_OFF;      // q_full[i] = qfull0 + 8 i
  const uint32_t qempty0 = qfull0 + 16;           // q_empty[i]
  const uint32_t full0 = qempty0 + 16;            // full[s] = full0 + 8 s
  const uint32_t empty0 = full0 + 8 * ST;         // empty[s]

  const int n_qt = (a.Sq + BM - 1) / BM;
  const int hbn = a.Hq * a.B;
  const int items = n_qt * hbn;
  const bool use_pos = a.q_pos != nullptr;
  const int group = a.Hq / a.Hkv;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(qfull0 + 8 * i, 1);
      mbar_init(qempty0 + 8 * i, kConsumers * 4);
    }
    for (int s = 0; s < ST; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers * 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------- producer ----------------
    setmaxnreg_dec<40>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      constexpr int PL = BN / 32;   // key positions a lane reads per tile
      const int n_kt = (a.Sk + BN - 1) / BN;
      int stage = 0;
      uint32_t phase = 0;
      int li = 0;                    // this block's item count
      for (int item = blockIdx.x; item < items; item += gridDim.x, ++li) {
        const TileCoord tc = plan_tile(item, n_qt, hbn, use_pos);
        const int q0 = tc.tile * BM;
        const int h = tc.hb % a.Hq, b = tc.hb / a.Hq;
        const int hk = h / group;
        const int qb = li % S::QB, use = li / S::QB;   // buffer, its use
        if (use > 0) mbar_wait(qempty0 + 8 * qb, (use - 1) & 1);
        if (lane == 0) {
          const uint32_t qf = qfull0 + 8 * qb;
          const uint32_t qs = base + S::Q_OFF + qb * S::Q_BYTES;
          mbar_arrive_tx(qf, S::Q_BYTES);
#pragma unroll
          for (int c = 0; c < NW; ++c)
            tma_load_4d(qs + c * BM * 128, &maps.q[0], qf, c * 64, q0, h, b);
          if (TAIL)
            tma_load_4d(qs + S::Q_TAIL, &maps.q[1], qf, NW * 64, q0, h, b);
        }
        // the tile's smallest and largest query position (real rows only)
        int qmin = INT_MAX, qmax = INT_MIN;
        if (use_pos) {
          const int* qpb = a.q_pos + (long long)b * a.Sq;
          for (int r = lane; r < BM; r += 32) {
            if (q0 + r < a.Sq) {
              const int p = qpb[q0 + r];
              qmin = min(qmin, p);
              qmax = max(qmax, p);
            }
          }
          qmin = __reduce_min_sync(0xffffffffu, qmin);
          qmax = __reduce_max_sync(0xffffffffu, qmax);
        }
        const int* kpb = use_pos ? a.k_pos + (long long)b * a.Sk : nullptr;
        // this lane's key positions (keys lane + 32 i) of a tile; keys
        // past Sk are invalid
        auto key_pos = [&](int k) {
          return k < a.Sk ? (use_pos ? kpb[k] : k) : kInvalidPos;
        };
        int pc[PL];
#pragma unroll
        for (int i = 0; i < PL; ++i) pc[i] = key_pos(lane + 32 * i);
        for (int kt = 0; kt < n_kt; ++kt) {
          const int k0 = kt * BN;
          // the next tile's positions load while this one is handled
          int pn[PL], pmin = INT_MAX, pmax = INT_MIN;
#pragma unroll
          for (int i = 0; i < PL; ++i) {
            pn[i] = key_pos(k0 + BN + lane + 32 * i);
            pmin = min(pmin, pc[i]);
            pmax = max(pmax, pc[i]);
          }
          const int kmin = __reduce_min_sync(0xffffffffu, pmin);
          const int kmax = __reduce_max_sync(0xffffffffu, pmax);
          if (!use_pos || kmin <= qmax) {  // else no key is visible to any row
            const bool full = k0 + BN <= a.Sk && (!use_pos || kmax <= qmin);
            mbar_wait(empty0 + 8 * stage, phase ^ 1);
#pragma unroll
            for (int i = 0; i < PL; ++i)
              kpos_s[stage * BN + lane + 32 * i] = pc[i];
            __syncwarp();
            if (lane == 0) {
              const uint32_t fb = full0 + 8 * stage;
              const uint32_t ks = base + S::K_OFF + stage * S::KV_BYTES;
              const uint32_t vs = base + S::V_OFF + stage * S::KV_BYTES;
              meta_k0[stage] = k0;
              meta_full[stage] = full;
              mbar_arrive_tx(fb, 2 * S::KV_BYTES);
#pragma unroll
              for (int c = 0; c < NW; ++c) {
                tma_load_4d(ks + c * BN * 128, &maps.k[0], fb, c * 64, k0,
                            hk, b);
                tma_load_4d(vs + c * BN * 128, &maps.v[0], fb, c * 64, k0,
                            hk, b);
              }
              if (TAIL) {
                tma_load_4d(ks + S::KV_TAIL, &maps.k[1], fb, NW * 64, k0, hk,
                            b);
                tma_load_4d(vs + S::KV_TAIL, &maps.v[1], fb, NW * 64, k0, hk,
                            b);
              }
            }
            if (++stage == ST) { stage = 0; phase ^= 1; }
          }
#pragma unroll
          for (int i = 0; i < PL; ++i) pc[i] = pn[i];
        }
        // a stage with k0 = -1 ends the item
        mbar_wait(empty0 + 8 * stage, phase ^ 1);
        if (lane == 0) {
          meta_k0[stage] = -1;
          mbar_arrive(full0 + 8 * stage);
        }
        if (++stage == ST) { stage = 0; phase ^= 1; }
      }
    }
  } else {
    // ---------------- consumers ----------------
    setmaxnreg_inc<232>();
    const int cw = wg - 1;                        // consumer index
    const int t = threadIdx.x - 128 * wg;
    const int lane = t & 31;
    const int quad = lane & 3;
    const bool capped = a.soft_cap > 0.f;
    const float sl2 = a.scale * kLog2e;           // plain: score -> log2
    const float cap_in = a.scale / (capped ? a.soft_cap : 1.f);
    const float cap_out = a.soft_cap * kLog2e;
    // descriptors of the K/V stage 0; a stage adds stage * KV_BYTES
    const uint64_t dk = gmma_desc(base + S::K_OFF, 16, 1024, kSw128);
    const uint64_t dkt = gmma_desc(base + S::K_OFF + S::KV_TAIL, 16, 256,
                                   kSw32);
    const uint64_t dv = gmma_desc(base + S::V_OFF, BN * 128, 1024, kSw128);
    const uint64_t dvt = gmma_desc(base + S::V_OFF + S::KV_TAIL, BN * 32, 256,
                                   kSw32);
    constexpr int NS = BN / 2;                    // S registers per thread
    constexpr int NO = 32 * NW + (TAIL ? 8 : 0);  // O registers per thread
    float s[NS];
    uint32_t p[BN / 16][4];
    float o[NO];

    // Software pipeline over an item's key tiles: iteration j issues
    // S_j = Q K_j^T and then O += P_{j-1} V_{j-1}, runs the softmax of S_j
    // while that product is still on the tensor cores, and releases stage
    // j-1 once it is done. A pair of named barriers makes the two consumer
    // warpgroups take turns issuing their products, so one warpgroup's
    // softmax overlaps the other's products.
    if (cw == 1) named_arrive(1, 256);   // warpgroup 0 goes first
    int stage = 0;
    uint32_t phase = 0;
    int li = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++li) {
      const TileCoord tc = plan_tile(item, n_qt, hbn, use_pos);
      const int q0 = tc.tile * BM;
      const int h = tc.hb % a.Hq, b = tc.hb / a.Hq;
      const int r0 = q0 + 64 * cw + 16 * (t >> 5) + (lane >> 2), r1 = r0 + 8;
      const bool ok0 = r0 < a.Sq, ok1 = r1 < a.Sq;
      int qp0 = INT_MIN, qp1 = INT_MIN;
      if (use_pos) {
        const int* qpb = a.q_pos + (long long)b * a.Sq;
        if (ok0) qp0 = qpb[r0];
        if (ok1) qp1 = qpb[r1];
      }
      const int qb = li % S::QB;
      const uint32_t qs = base + S::Q_OFF + qb * S::Q_BYTES;
      const uint64_t dq = gmma_desc(qs + cw * 64 * 128, 16, 1024, kSw128);
      const uint64_t dqt =
          gmma_desc(qs + S::Q_TAIL + cw * 64 * 32, 16, 256, kSw32);
#pragma unroll
      for (int i = 0; i < NO; ++i) o[i] = 0.f;
      float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
      float al0 = 1.f, al1 = 1.f;

      mbar_wait(qfull0 + 8 * qb, (li / S::QB) & 1);
      mbar_wait(full0 + 8 * stage, phase);
      int prev = -1;                               // stage of P_{j-1}
      if (meta_k0[stage] >= 0) {
        // first tile: S_0 and its softmax (O is still zero)
        named_sync(1 + cw, 256);
        wgmma_fence();
        const uint32_t so = stage * S::KV_BYTES;
        issue_qk<DP>(s, dq, dqt, desc_add(dk, so), desc_add(dkt, so));
        wgmma_commit();
        named_arrive(2 - cw, 256);
        wgmma_wait<0>();
        fence_regs<NS>(s);
        softmax_tile<NS>(s, meta_full[stage] != 0, capped, use_pos,
                         kpos_s + stage * BN, meta_k0[stage], a.Sk, quad,
                         qp0, qp1, sl2, cap_in, cap_out, m0, m1, l0, l1, al0,
                         al1);
        pack_p<BN / 16>(s, p);
        prev = stage;
        if (++stage == ST) { stage = 0; phase ^= 1; }
        for (;;) {
          mbar_wait(full0 + 8 * stage, phase);
          const int k0 = meta_k0[stage];
          if (k0 < 0) break;
          named_sync(1 + cw, 256);
          wgmma_fence();
          const uint32_t so = stage * S::KV_BYTES;
          issue_qk<DP>(s, dq, dqt, desc_add(dk, so), desc_add(dkt, so));
          wgmma_commit();
          rescale<NO>(o, al0, al1);
          wgmma_fence();
          const uint32_t po = prev * S::KV_BYTES;
          issue_pv<DP>(o, p, desc_add(dv, po), desc_add(dvt, po));
          wgmma_commit();
          named_arrive(2 - cw, 256);
          wgmma_wait<1>();
          fence_regs<NS>(s);
          softmax_tile<NS>(s, meta_full[stage] != 0, capped, use_pos,
                           kpos_s + stage * BN, k0, a.Sk, quad, qp0, qp1,
                           sl2, cap_in, cap_out, m0, m1, l0, l1, al0, al1);
          wgmma_wait<0>();
          fence_regs<NO>(o);
          release(empty0 + 8 * prev, lane);
          fence_regs<NS>(s);   // P is written after P_{j-1} V_{j-1} is done
          pack_p<BN / 16>(s, p);
          prev = stage;
          if (++stage == ST) { stage = 0; phase ^= 1; }
        }
      }
      // the end stage: Q is read no more (every S product has completed)
      release(empty0 + 8 * stage, lane);
      release(qempty0 + 8 * qb, lane);
      if (++stage == ST) { stage = 0; phase ^= 1; }
      if (prev >= 0) {
        rescale<NO>(o, al0, al1);
        wgmma_fence();
        const uint32_t po = prev * S::KV_BYTES;
        issue_pv<DP>(o, p, desc_add(dv, po), desc_add(dvt, po));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<NO>(o);
        release(empty0 + 8 * prev, lane);
      }

      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      const bool v0 = m0 > kNegInf * 0.5f && l0 > 0.f;
      const bool v1 = m1 > kNegInf * 0.5f && l1 > 0.f;
      const float inv0 = v0 ? 1.f / l0 : 0.f, inv1 = v1 ? 1.f / l1 : 0.f;
      if (a.lse != nullptr && quad == 0) {
        float* lb = a.lse + ((long long)b * a.Hq + h) * a.Sq;
        if (ok0) lb[r0] = v0 ? m0 * kLn2 + logf(l0) : kNegInf;
        if (ok1) lb[r1] = v1 ? m1 * kLn2 + logf(l1) : kNegInf;
      }
      __nv_bfloat16* ob = a.o + b * a.o_sb + h * a.o_sh;
#pragma unroll
      for (int i = 0; i < NO; i += 4) {
        // register i: chunk i / 32 (the tail after the 64-column chunks),
        // n-tile (i % 32) / 4 of 8 columns
        const int d = 64 * (i / 32) + 8 * ((i % 32) / 4) + 2 * quad;
        if (d < a.D) {
          if (ok0)
            *reinterpret_cast<uint32_t*>(ob + r0 * a.o_ss + d) =
                pack_bf16(o[i] * inv0, o[i + 1] * inv0);
          if (ok1)
            *reinterpret_cast<uint32_t*>(ob + r1 * a.o_ss + d) =
                pack_bf16(o[i + 2] * inv1, o[i + 3] * inv1);
        }
      }
    }
  }
}

// ---- host side -----------------------------------------------------------

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
// 4-D tensor map {D, S, H, B} with a (width x rows) box; columns past D and
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
            width == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                        : CU_TENSOR_MAP_SWIZZLE_32B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 132;
  }
  return n;
}

// The forward at padded head dim DP.
template <int DP>
inline cudaError_t attention_forward(const FwdArgs& a, cudaStream_t stream) {
  using S = FwdShape<DP>;
  FwdMaps m;
  for (int w = 0; w < (S::TAIL ? 2 : 1); ++w) {
    const int width = w == 0 ? 64 : S::TAIL;
    if (!encode_view(&m.q[w], a.q, a.B, a.Sq, a.Hq, a.D, a.q_sb, a.q_ss,
                     a.q_sh, width, S::BM) ||
        !encode_view(&m.k[w], a.k, a.B, a.Sk, a.Hkv, a.D, a.k_sb, a.k_ss,
                     a.k_sh, width, S::BN) ||
        !encode_view(&m.v[w], a.v, a.B, a.Sk, a.Hkv, a.D, a.v_sb, a.v_ss,
                     a.v_sh, width, S::BN))
      return cudaErrorInvalidValue;
  }
  if (!S::TAIL) m.q[1] = m.q[0], m.k[1] = m.k[0], m.v[1] = m.v[0];
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        attention_fwd_kernel<DP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  static int per_sm = 0;
  if (per_sm == 0) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, attention_fwd_kernel<DP>, S::THREADS, S::SMEM);
    if (e != cudaSuccess) return e;
    if (per_sm == 0) return cudaErrorInvalidConfiguration;
  }
  const long long items =
      (long long)((a.Sq + S::BM - 1) / S::BM) * a.Hq * a.B;
  if (items == 0) return cudaSuccess;
  if (items > INT_MAX) return cudaErrorInvalidValue;
  const int grid =
      plan_grid((int)items, sm_count(), per_sm, a.q_pos != nullptr);
  attention_fwd_kernel<DP><<<grid, S::THREADS, S::SMEM, stream>>>(m, a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace svt
