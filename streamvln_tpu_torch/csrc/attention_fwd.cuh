// The attention forward shared by K1 (vit_attention.cu), K2 and K3
// (flash_attention.cu), written for Hopper (sm_90a).
//
// A block owns a query tile of one (batch, query head) and has two
// consumer warpgroups. One warp loads the Q tile once with TMA, then walks
// the key tiles (BN keys, FwdShape) and keeps K and V tiles in flight into
// a ring of ST stages in shared memory, each stage signalled by a "full"
// mbarrier (the TMA bytes and one arrival of the walking warp) and
// released by an "empty" mbarrier (one arrival per consumer warp). Under
// positions (K2, K3: one item per block) the consumers' eight warps first
// write two masks of the key tiles (attention_plan.cuh): those the block
// visits (a tile whose smallest position exceeds the block's largest
// query position is skipped, the exact rule for positions in any order)
// and the "full" ones (largest position <= the block's smallest query
// position, no ragged tail: no per-element mask), all the item's key
// positions in flight at once, while the producer loads Q and puts tile 0
// into the ring where the item visits it. The walk then goes over the
// visited tiles only, loading no position of a skipped tile or a full one
// (a masked tile's positions go to its stage), and a stage with k0 = -1
// ends it right after the last visited tile. The walking warp is the
// producer, the first warp of a third warpgroup.
//
// A consumer warpgroup computes S = Q K^T with wgmma (both operands in
// shared memory, K-major), runs the online softmax in registers in the
// log2 domain (scale * log2(e) folded into the exponent's FMA), and keeps
// P in registers as the bf16 A operand of O += P V (wgmma with A from
// registers; V is the B operand read MN-major with the transpose flag, so
// nothing is transposed by hand). setmaxnreg moves registers from the
// producer warpgroup to the consumers (ptxas still caps each thread of a
// 384-thread block at 168). The two warpgroups share the work in one of
// three ways:
// - 128-row tiles (the rule): each warpgroup takes 64 rows and every key
//   tile. The softmax of one tile runs while the previous tile's P V is on
//   the tensor cores, and the warpgroups take turns issuing their products
//   (named barriers), so the softmax of one overlaps the products of the
//   other.
// - K1's split (attention_plan.cuh::plan_split, where 128-row items would
//   leave the card idle): both take the same 64 rows, each every other key
//   tile (the other's it releases unread), and at the end the second
//   leaves its O and (m, l) in shared memory and the first merges them by
//   the running max, in that fixed order.
// - WIDE, head dim 256 (K2/K3 for Gemma): a 64-row O accumulator would be
//   128 f32 registers a thread, so both take the same 64 rows and
//   warpgroup w holds O's columns [128 w, 128 w + 128). Each computes the
//   whole S = Q K^T of a key tile and the same softmax (the same operands
//   in the same order: the same P), and issues its half of P V. S is
//   computed twice; in exchange the warpgroups stay independent and take
//   turns as above, so the softmax of one overlaps the other's products.
//   (S split by depth, its halves crossing through the K stage under a
//   barrier, kept them in lockstep and was 12% slower; one warpgroup
//   forming each key tile's S and P for both, in turn, put products in
//   branches on the warpgroup, which ptxas serializes.) Three stages (Q
//   32 KB, 3 x 64 KB of K and V) fit 227 KB.
//
// Head dims: the padded head dim DP is 64 (CLIP, EVA02), 80 (SigLIP's
// 72), 96 (EVA01-CLIP-g's 88), 112 (CLIP-bigG's and MLCD-bigG's 104), 128
// (Qwen2 and most families) or 256 (Gemma). A tile is kept as 64-column
// chunks with the 128-byte swizzle (a 128-byte row is one swizzle span),
// then a 32-column chunk with the 64-byte swizzle and a 16-column chunk
// with the 32-byte swizzle where DP needs them (FwdShape). The TMA boxes
// of the last chunk read the columns up to D and zero-fill the rest,
// which add nothing to Q K^T and give output columns that are never
// stored. Every chunk region starts on a 1024-byte boundary, as the
// swizzle patterns and the wgmma descriptors assume.
//
// Numerics: bf16 operands, f32 accumulation; P rounded to bf16 before PV;
// one 1/rowsum at the end. A masked score is -inf; a row whose running
// max never rose above its start of -1e30 (no visible key) is written as
// exact zeros and, with `lse` set (K3), an LSE of -1e30. The LSE is in
// natural-log units (m * ln 2 + ln l), as K4/K5 recompute P = exp(S -
// LSE) from it.
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
#include "tma.cuh"        // tma_load_4d, encode_view

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

// TMA descriptors of q, k, v at padded head dim DP: [0] the 64-column box
// (128-byte swizzle), then the 32-column box (64-byte swizzle, index M32)
// and the 16-column box (32-byte swizzle, index M16) where DP has those
// chunks (FwdShape); a kernel parameter, so no larger than it must be.
template <int DP>
struct FwdMaps {
  static constexpr int M32 = 1;
  static constexpr int M16 = FwdShape<DP>::T32 ? 2 : 1;
  static constexpr int N = 1 + (FwdShape<DP>::T32 != 0) +
                           (FwdShape<DP>::T16 != 0);
  CUtensorMap q[N];
  CUtensorMap k[N];
  CUtensorMap v[N];
};

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ---- PTX wrappers --------------------------------------------------------

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), swizzle (1 = 128 B, 2 = 64 B, 3 =
// 32 B).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t swizzle) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
       | static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16
       | static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32
       | static_cast<uint64_t>(swizzle) << 62;
}

constexpr uint32_t kSw128 = 1, kSw64 = 2, kSw32 = 3;

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

// d[64 x 32] += A[64 x 16] (registers) B[16 x 32], B MN-major.
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : SVT_R4(d, 0), SVT_R4(d, 4), SVT_R4(d, 8), SVT_R4(d, 12)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef SVT_R32
#undef SVT_R4


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

// The wgmma descriptors of a tile of `rows` rows at `addr` (FwdShape's
// chunks), from row `row` on: d[0] its first 64-column chunk, d[1] the
// 32-column chunk, d[2] the 16-column chunk. A K-major operand (Q, K)
// steps 8 rows a stride (SBO, the swizzle span x 8); an MN-major one (V)
// also names the bytes between two chunks (LBO).
template <int DP>
__device__ __forceinline__ void chunk_descs(uint64_t* d, uint32_t addr,
                                            int rows, int row, bool mn) {
  using S = FwdShape<DP>;
  d[0] = gmma_desc(addr + row * 128, mn ? rows * 128 : 16, 1024, kSw128);
  d[1] = gmma_desc(addr + S::OFF32 * rows + row * 64, mn ? rows * 64 : 16,
                   512, kSw64);
  d[2] = gmma_desc(addr + S::OFF16 * rows + row * 32, mn ? rows * 32 : 16,
                   256, kSw32);
}

// Issue S = Q K^T for 64 query rows over the 64-column chunks of the depth,
// then the 32- and 16-column chunks (16-column steps): dq the Q tile's
// descriptors at those rows, dk the K stage 0's, `so` the stage's byte
// offset; S is the instance's FwdShape.
template <typename S>
__device__ __forceinline__ void issue_qk(float* s, const uint64_t* dq,
                                         const uint64_t* dk, uint32_t so) {
  const uint64_t k0 = desc_add(dk[0], so);
#pragma unroll
  for (int c = 0; c < S::NW; ++c) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<S::BN>(s, desc_add(dq[0], c * S::BM * 128 + kk * 32),
                      desc_add(k0, c * S::BN * 128 + kk * 32), c + kk > 0);
  }
  if constexpr (S::T32 != 0) {
    const uint64_t k1 = desc_add(dk[1], so);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      wgmma_ss<S::BN>(s, desc_add(dq[1], kk * 32), desc_add(k1, kk * 32), 1);
  }
  if constexpr (S::T16 != 0)
    wgmma_ss<S::BN>(s, dq[2], desc_add(dk[2], so), 1);
}

// Issue O += P V over NCH 64-column chunks of V from dv[0] on, then its
// 32- and 16-column chunks: P's 16-key step kk is the A fragment p[kk]; V
// is read MN-major (transposed); `so` is the stage's byte offset.
template <typename S, int NCH>
__device__ __forceinline__ void issue_pv(float* o, const uint32_t (*p)[4],
                                         const uint64_t* dv, uint32_t so) {
  const uint64_t v0 = desc_add(dv[0], so), v1 = desc_add(dv[1], so),
                 v2 = desc_add(dv[2], so);
#pragma unroll
  for (int kk = 0; kk < S::BN / 16; ++kk) {
#pragma unroll
    for (int c = 0; c < NCH; ++c)
      wgmma_rs_n64(o + 32 * c, p[kk],
                   desc_add(v0, c * S::BN * 128 + kk * 16 * 128));
    if constexpr (S::T32 != 0)
      wgmma_rs_n32(o + 32 * NCH, p[kk], desc_add(v1, kk * 16 * 64));
    if constexpr (S::T16 != 0)
      wgmma_rs_n16(o + 32 * NCH + S::T32 / 2, p[kk],
                   desc_add(v2, kk * 16 * 32));
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

// A stage's first key (-1: the end of the walk), warp-uniform to the
// compiler, as the branches around the products need.
__device__ __forceinline__ int stage_k0(const int* meta_k0, int stage) {
  return __shfl_sync(0xffffffffu, meta_k0[stage], 0);
}

// One arrival per warp on a stage's empty barrier, after the warp's
// products that read the stage are done.
__device__ __forceinline__ void release(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// ---- the walk over an item's key tiles ------------------------------------

// An item's query range and visited- and full-tile masks
// (attention_plan.cuh): every calling warp finds the smallest and largest
// position of the item's real query rows (the nq rows from qp); warp
// `warp` of the nw calling warps takes its batches of U consecutive key
// tiles (mask_batch) with all of a batch's position loads in flight
// together (the first batch with the query positions), and sets the bits
// of the tiles some query row sees and of those every row sees whole
// (tile_bits), one atomic per mask a batch (mask_word, mask_place; the
// masks are zero beforehand).
template <int BM, int BN, int U>
__device__ __forceinline__ void visit_masks(const int* qp, int nq,
                                            const int* kpb, int sk, int n_kt,
                                            uint32_t* vmask, uint32_t* fmask,
                                            int warp, int nw, int lane,
                                            int& qmin, int& qmax) {
  static_assert(32 % U == 0, "a batch's bits share one mask word");
  constexpr int PL = BN / 32, QL = BM / 32;
  int v[U][PL];
  auto load = [&](int t0) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long k0 = (long long)(t0 + u) * BN + lane;
#pragma unroll
      for (int i = 0; i < PL; ++i)   // keys past Sk do not exist
        v[u][i] = k0 + 32 * i < sk ? kpb[k0 + 32 * i] : INT_MAX;
    }
  };
  int t0 = mask_batch(0, warp, nw, U);
  load(t0);
  qmin = INT_MAX;
  qmax = INT_MIN;
#pragma unroll
  for (int i = 0; i < QL; ++i) {
    if (lane + 32 * i < nq) {
      const int p = qp[lane + 32 * i];
      qmin = min(qmin, p);
      qmax = max(qmax, p);
    }
  }
  qmin = __reduce_min_sync(0xffffffffu, qmin);
  qmax = __reduce_max_sync(0xffffffffu, qmax);
  for (int r = 0; t0 < n_kt; t0 = mask_batch(++r, warp, nw, U)) {
    if (r > 0) load(t0);
    uint32_t vb = 0, fb = 0;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      int mn = v[u][0], mx = v[u][0];
#pragma unroll
      for (int i = 1; i < PL; ++i) {
        mn = min(mn, v[u][i]);
        mx = max(mx, v[u][i]);
      }
      tile_bits(t0 + u, u, n_kt, BN, sk, __reduce_min_sync(0xffffffffu, mn),
                __reduce_max_sync(0xffffffffu, mx), qmin, qmax, &vb, &fb);
    }
    if (lane == 0) {
      if (vb) atomicOr(vmask + mask_word(t0), mask_place(vb, t0));
      if (fb) atomicOr(fmask + mask_word(t0), mask_place(fb, t0));
    }
  }
}

// ---- the kernel ----------------------------------------------------------

// Named barriers (0 is __syncthreads): the turn-taking (1, 2), the
// split's merge rows written (3) and read (4), the consumers' tile masks
// built for the producer's walk (5).
constexpr int kMergeFull = 3, kMergeEmpty = 4, kMaskBuilt = 5;

// Block i walks the work items i, i + grid, ... (attention_plan.cuh: a
// persistent grid for the vision tower, one item per block under
// positions). With two Q buffers the producer loads the next item's Q and
// first K/V tiles while the consumers finish the current item; the stage
// ring runs on across items. SPLIT: K1's key split (64-row items).
template <int DP, bool SPLIT, bool KT128>
__global__ void __launch_bounds__(FwdShape<DP, KT128>::THREADS, 1)
attention_fwd_kernel(__grid_constant__ const FwdMaps<DP> maps,
                     const FwdArgs a) {
  using S = FwdShape<DP, KT128>;
  constexpr int BN = S::BN, NW = S::NW, ST = S::ST;
  constexpr bool WIDE = S::WIDE;
  constexpr int M32 = FwdMaps<DP>::M32, M16 = FwdMaps<DP>::M16;
  constexpr int PL = BN / 32;   // key positions a lane reads per tile

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  int* kpos_s = reinterpret_cast<int*>(sm + S::POS_OFF);
  int* meta_k0 = reinterpret_cast<int*>(sm + S::META_OFF);
  int* meta_full = meta_k0 + ST;
  const int n_kt = (a.Sk + BN - 1) / BN;            // key tiles
  uint32_t* vmask = reinterpret_cast<uint32_t*>(sm + S::MASK_OFF);
  uint32_t* fmask = vmask + mask_words(n_kt);
  const uint32_t qfull0 = base + S::BAR_OFF;      // q_full[i] = qfull0 + 8 i
  const uint32_t qempty0 = qfull0 + 16;           // q_empty[i]
  const uint32_t full0 = qempty0 + 16;            // full[s] = full0 + 8 s
  const uint32_t empty0 = full0 + 8 * ST;         // empty[s]

  constexpr int BM = SPLIT ? 64 : S::BM;          // query rows per item
  const int n_qt = (a.Sq + BM - 1) / BM;
  const int hbn = a.Hq * a.B;
  const int items = n_qt * hbn;
  const bool use_pos = a.q_pos != nullptr;
  const int group = a.Hq / a.Hkv;
  const int wg = threadIdx.x / 128;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(qfull0 + 8 * i, 1);
      mbar_init(qempty0 + 8 * i, S::NC * 4);
    }
    for (int s = 0; s < ST; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, S::NC * 4);
    }
    mbar_init_fence();
  }
  // under positions a block takes one item (plan_grid); its masks start
  // empty
  if (use_pos)
    for (int i = threadIdx.x; i < 2 * mask_words(n_kt); i += S::THREADS)
      vmask[i] = 0;
  __syncthreads();

  // The producer warp's walk: stage n of an item is its n-th key tile
  // (under positions its n-th visited tile, in order) and, after the last,
  // an end stage (k0 = -1), issued into the ring once its slot is
  // released. Under positions a tile that is not full (attention_plan.cuh)
  // takes its key positions (keys past Sk as INVALID_POS) to its stage for
  // the consumers' mask; they load while the stage before waits for its
  // slot.
  int w_stage = 0;
  uint32_t w_phase = 0;
  int w_tile = n_kt, w_b = 0, w_hk = 0;
  int w_pos[PL];
  bool w_end = true;
  const int* w_kpb = nullptr;
  auto load_tile = [&](int t) {
    w_tile = t;
    const bool need = use_pos && t < n_kt && !mask_bit(fmask, t);
#pragma unroll
    for (int i = 0; i < PL; ++i) {
      const long long k = (long long)t * BN + lane + 32 * i;
      w_pos[i] = !need ? 0 : k >= a.Sk ? kInvalidPos : w_kpb[k];
    }
  };
  auto next_tile = [&](int t) {
    return use_pos ? next_visited(vmask, n_kt, t) : min(t, n_kt);
  };
  // posts the stage of tile w_tile (the end stage past the last tile)
  auto post = [&]() {
    mbar_wait(empty0 + 8 * w_stage, w_phase ^ 1);
    if (w_tile < n_kt) {
      const int k0 = w_tile * BN;
      const bool full = use_pos ? mask_bit(fmask, w_tile) : k0 + BN <= a.Sk;
      if (use_pos && !full) {
#pragma unroll
        for (int i = 0; i < PL; ++i)
          kpos_s[w_stage * BN + lane + 32 * i] = w_pos[i];
      }
      __syncwarp();
      if (lane == 0) {
        const uint32_t fb = full0 + 8 * w_stage;
        const uint32_t ks = base + S::K_OFF + w_stage * S::KV_BYTES;
        const uint32_t vs = base + S::V_OFF + w_stage * S::KV_BYTES;
        meta_k0[w_stage] = k0;
        meta_full[w_stage] = full;
        mbar_arrive_tx(fb, 2 * S::KV_BYTES);
#pragma unroll
        for (int c = 0; c < NW; ++c) {
          tma_load_4d(ks + c * BN * 128, &maps.k[0], fb, c * 64, k0, w_hk,
                      w_b);
          tma_load_4d(vs + c * BN * 128, &maps.v[0], fb, c * 64, k0, w_hk,
                      w_b);
        }
        if constexpr (S::T32 != 0) {
          tma_load_4d(ks + S::OFF32 * BN, &maps.k[M32], fb, NW * 64, k0,
                      w_hk, w_b);
          tma_load_4d(vs + S::OFF32 * BN, &maps.v[M32], fb, NW * 64, k0,
                      w_hk, w_b);
        }
        if constexpr (S::T16 != 0) {
          tma_load_4d(ks + S::OFF16 * BN, &maps.k[M16], fb,
                      NW * 64 + S::T32, k0, w_hk, w_b);
          tma_load_4d(vs + S::OFF16 * BN, &maps.v[M16], fb,
                      NW * 64 + S::T32, k0, w_hk, w_b);
        }
      }
    } else {
      if (lane == 0) {
        meta_k0[w_stage] = -1;
        mbar_arrive(full0 + 8 * w_stage);
      }
      w_end = true;
    }
    if (++w_stage == ST) { w_stage = 0; w_phase ^= 1; }
  };
  // The walk of item (q0, b) from KV head hk. Under positions tile 0 goes
  // into the ring before the consumers' masks are complete, where the
  // item visits it (as every item whose rows see its keys does): this warp
  // finds tile 0's bits by the masks' rules from the item's query
  // positions and tile 0's key positions, loaded together, and sets its
  // full bit itself (the consumers set the same bits).
  auto walk_start = [&](int q0, int b, int hk) {
    w_b = b;
    w_hk = hk;
    w_kpb = use_pos ? a.k_pos + (long long)b * a.Sk : nullptr;
    w_end = false;
    if (!use_pos) {
      load_tile(next_tile(0));
      return;
    }
    const int* qp = a.q_pos + (long long)b * a.Sq + q0;
    int qmin = INT_MAX, qmax = INT_MIN, kmin = INT_MAX, kmax = INT_MIN;
#pragma unroll
    for (int i = 0; i < PL; ++i) {
      const bool real = lane + 32 * i < a.Sk;
      w_pos[i] = real ? w_kpb[lane + 32 * i] : kInvalidPos;
      kmin = real ? min(kmin, w_pos[i]) : kmin;
      kmax = real ? max(kmax, w_pos[i]) : kmax;
    }
#pragma unroll
    for (int i = 0; i < BM / 32; ++i) {
      if (lane + 32 * i < a.Sq - q0) {
        qmin = min(qmin, qp[lane + 32 * i]);
        qmax = max(qmax, qp[lane + 32 * i]);
      }
    }
    uint32_t vb = 0, fb = 0;
    tile_bits(0, 0, n_kt, BN, a.Sk, __reduce_min_sync(0xffffffffu, kmin),
              __reduce_max_sync(0xffffffffu, kmax),
              __reduce_min_sync(0xffffffffu, qmin),
              __reduce_max_sync(0xffffffffu, qmax), &vb, &fb);
    if (lane == 0 && fb) atomicOr(fmask, fb);
    __syncwarp();
    if (vb) {
      w_tile = 0;
      post();
    }
    named_sync(kMaskBuilt, S::NC * 128 + 32);   // consumers + this warp
    load_tile(next_tile(vb));
  };

  if (wg == 0) {
    // ---------------- producer ----------------
    // under positions (one item per block) the walk starts once the
    // consumers have built the item's masks
    setmaxnreg_dec<40>();
    if (warp != 0) return;
    int li = 0;                      // this block's item count
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++li) {
      const TileCoord tc = plan_tile(item, n_qt, hbn, use_pos);
      const int q0 = tc.tile * BM;
      const int h = tc.hb % a.Hq, b = tc.hb / a.Hq;
      const int qb = li % S::QB, use = li / S::QB;   // buffer, its use
      if (use > 0) mbar_wait(qempty0 + 8 * qb, (use - 1) & 1);
      if (lane == 0) {
        // the Q box has BM rows; each chunk region has room for S::BM
        const uint32_t qf = qfull0 + 8 * qb;
        const uint32_t qs = base + S::Q_OFF + qb * S::Q_BYTES;
        mbar_arrive_tx(qf, BM * DP * 2);
#pragma unroll
        for (int c = 0; c < NW; ++c)
          tma_load_4d(qs + c * S::BM * 128, &maps.q[0], qf, c * 64, q0, h,
                      b);
        if constexpr (S::T32 != 0)
          tma_load_4d(qs + S::OFF32 * S::BM, &maps.q[M32], qf, NW * 64, q0,
                      h, b);
        if constexpr (S::T16 != 0)
          tma_load_4d(qs + S::OFF16 * S::BM, &maps.q[M16], qf,
                      NW * 64 + S::T32, q0, h, b);
      }
      walk_start(q0, b, h / group);
      while (!w_end) {   // the next stage, then the next tile's positions
        post();
        if (!w_end) load_tile(next_tile(w_tile + 1));
      }
    }
  } else {
    // ---------------- consumers ----------------
    setmaxnreg_inc<232>();
    // consumer index; where a branch on it guards a product (the split),
    // warp-uniform to the compiler (a shuffle from lane 0), as ptxas
    // serializes the products of a branch it takes for divergent
    const int cw = (SPLIT ? __shfl_sync(0xffffffffu, wg, 0) : wg) - 1;
    if (use_pos) {
      // one item per block: the consumers' eight warps build its masks
      // (their query and key position loads in flight together) while the
      // producer loads Q and tile 0, then let the walk go on
      const TileCoord tc = plan_tile(blockIdx.x, n_qt, hbn, true);
      const int q0 = tc.tile * BM, b = tc.hb / a.Hq;
      int qmin, qmax;
      visit_masks<BM, BN, 8>(a.q_pos + (long long)b * a.Sq + q0, a.Sq - q0,
                             a.k_pos + (long long)b * a.Sk, a.Sk, n_kt,
                             vmask, fmask, warp - 4, 8, lane, qmin, qmax);
      named_arrive(kMaskBuilt, S::NC * 128 + 32);
    }
    const int t = threadIdx.x - 128 * wg;
    const int quad = lane & 3;
    const bool capped = a.soft_cap > 0.f;
    const float sl2 = a.scale * kLog2e;           // plain: score -> log2
    const float cap_in = a.scale / (capped ? a.soft_cap : 1.f);
    const float cap_out = a.soft_cap * kLog2e;
    // descriptors of the K/V stage 0; a stage adds stage * KV_BYTES. WIDE:
    // this warpgroup's half of V's (and O's) columns
    constexpr int NCH = WIDE ? NW / 2 : NW;       // 64-column chunks of O
    uint64_t dk[3], dv[3];
    chunk_descs<DP>(dk, base + S::K_OFF, BN, 0, false);
    chunk_descs<DP>(dv, base + S::V_OFF, BN, 0, true);
    if constexpr (WIDE) dv[0] = desc_add(dv[0], cw * NCH * BN * 128);
    constexpr int NS = BN / 2;                    // S registers per thread
    constexpr int NO = S::NO;                     // O registers per thread
    // a stage's first key (-1 ends the walk); where a branch on it or on
    // the warpgroup guards a product, read warp-uniform
    auto k0_of = [&](int st) {
      if constexpr (SPLIT) return stage_k0(meta_k0, st);
      else return meta_k0[st];
    };
    float s[NS];
    uint32_t p[BN / 16][4];
    float o[NO];

    // a pair of named barriers makes the two consumer warpgroups take
    // turns issuing their products (warpgroup 0 first)
    constexpr bool turns = !SPLIT;
    if (turns && cw == 1) named_arrive(1, 256);
    int stage = 0;
    uint32_t phase = 0;
    int li = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x, ++li) {
      const TileCoord tc = plan_tile(item, n_qt, hbn, use_pos);
      const int q0 = tc.tile * BM;
      const int h = tc.hb % a.Hq, b = tc.hb / a.Hq;
      const int row = WIDE || SPLIT ? 0 : 64 * cw;  // the warpgroup's rows
      const int r0 = q0 + row + 16 * (t >> 5) + (lane >> 2), r1 = r0 + 8;
      const bool ok0 = r0 < a.Sq, ok1 = r1 < a.Sq;
      int qp0 = INT_MIN, qp1 = INT_MIN;
      if (use_pos) {
        const int* qpb = a.q_pos + (long long)b * a.Sq;
        if (ok0) qp0 = qpb[r0];
        if (ok1) qp1 = qpb[r1];
      }
      const int qb = li % S::QB;
      uint64_t dq[3];
      chunk_descs<DP>(dq, base + S::Q_OFF + qb * S::Q_BYTES, S::BM, row,
                      false);
#pragma unroll
      for (int i = 0; i < NO; ++i) o[i] = 0.f;
      float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
      float al0 = 1.f, al1 = 1.f;

      mbar_wait(qfull0 + 8 * qb, (li / S::QB) & 1);
      mbar_wait(full0 + 8 * stage, phase);
      int prev = -1;            // the stage of this warpgroup's last P V
      int j = 0;                // the item's key tiles so far
      // Software pipeline over an item's key tiles: iteration j issues S_j
      // = Q K_j^T and then O += P_{j-1} V_{j-1}, runs the softmax of S_j
      // while that product is still on the tensor cores, and releases
      // stage j-1 once it is done. Under the split this warpgroup takes
      // the tiles j % 2 == cw and releases the others unread. Every wgmma
      // sits on a path both warpgroups take.
      auto skip_others = [&]() {
        while (SPLIT && (j & 1) != cw && k0_of(stage) >= 0) {
          release(empty0 + 8 * stage, lane);
          ++j;
          if (++stage == ST) { stage = 0; phase ^= 1; }
          mbar_wait(full0 + 8 * stage, phase);
        }
      };
      skip_others();
      if (k0_of(stage) >= 0) {
        // first tile: S_0 and its softmax (O is still zero)
        if (turns) named_sync(1 + cw, 256);
        wgmma_fence();
        issue_qk<S>(s, dq, dk, stage * S::KV_BYTES);
        wgmma_commit();
        if (turns) named_arrive(2 - cw, 256);
        wgmma_wait<0>();
        fence_regs<NS>(s);
        softmax_tile<NS>(s, meta_full[stage] != 0, capped, use_pos,
                         kpos_s + stage * BN, meta_k0[stage], a.Sk, quad,
                         qp0, qp1, sl2, cap_in, cap_out, m0, m1, l0, l1, al0,
                         al1);
        pack_p<BN / 16>(s, p);
        prev = stage;
        ++j;
        if (++stage == ST) { stage = 0; phase ^= 1; }
        for (;;) {
          mbar_wait(full0 + 8 * stage, phase);
          skip_others();
          const int k0 = k0_of(stage);
          if (k0 < 0) break;
          if (turns) named_sync(1 + cw, 256);
          wgmma_fence();
          issue_qk<S>(s, dq, dk, stage * S::KV_BYTES);
          wgmma_commit();
          rescale<NO>(o, al0, al1);
          wgmma_fence();
          issue_pv<S, NCH>(o, p, dv, prev * S::KV_BYTES);
          wgmma_commit();
          if (turns) named_arrive(2 - cw, 256);
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
          ++j;
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
        issue_pv<S, NCH>(o, p, dv, prev * S::KV_BYTES);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<NO>(o);
        release(empty0 + 8 * prev, lane);
      }

      if constexpr (SPLIT) {
        // warpgroup 1's O and (m, l) by thread, merged by warpgroup 0
        float4* mo = reinterpret_cast<float4*>(sm + S::M_OFF);
        float4* mr = mo + (NO / 4) * 128;
        if (cw == 1) {
          if (li > 0) named_sync(kMergeEmpty, 256);  // the last item's read
#pragma unroll
          for (int i = 0; i < NO; i += 4)
            mo[(i / 4) * 128 + t] = make_float4(o[i], o[i + 1], o[i + 2],
                                                o[i + 3]);
          mr[t] = make_float4(m0, m1, l0, l1);
          named_arrive(kMergeFull, 256);
        } else {
          named_sync(kMergeFull, 256);
          const float4 r = mr[t];
          const float mn0 = fmaxf(m0, r.x), mn1 = fmaxf(m1, r.y);
          const float a0 = ex2(m0 - mn0), a1 = ex2(m1 - mn1);
          const float b0 = ex2(r.x - mn0), b1 = ex2(r.y - mn1);
#pragma unroll
          for (int i = 0; i < NO; i += 4) {
            const float4 w = mo[(i / 4) * 128 + t];
            o[i] = o[i] * a0 + w.x * b0;
            o[i + 1] = o[i + 1] * a0 + w.y * b0;
            o[i + 2] = o[i + 2] * a1 + w.z * b1;
            o[i + 3] = o[i + 3] * a1 + w.w * b1;
          }
          l0 = l0 * a0 + r.z * b0;
          l1 = l1 * a1 + r.w * b1;
          m0 = mn0;
          m1 = mn1;
          if (item + (int)gridDim.x < items) named_arrive(kMergeEmpty, 256);
        }
      }
      if (SPLIT && cw == 1) continue;   // warpgroup 0 stores the rows

      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      const bool v0 = m0 > kNegInf * 0.5f && l0 > 0.f;
      const bool v1 = m1 > kNegInf * 0.5f && l1 > 0.f;
      const float inv0 = v0 ? 1.f / l0 : 0.f, inv1 = v1 ? 1.f / l1 : 0.f;
      if (a.lse != nullptr && quad == 0 && (!WIDE || cw == 0)) {
        float* lb = a.lse + ((long long)b * a.Hq + h) * a.Sq;
        if (ok0) lb[r0] = v0 ? m0 * kLn2 + logf(l0) : kNegInf;
        if (ok1) lb[r1] = v1 ? m1 * kLn2 + logf(l1) : kNegInf;
      }
      __nv_bfloat16* ob = a.o + b * a.o_sb + h * a.o_sh;
      const int c0 = WIDE ? 128 * cw : 0;   // this warpgroup's first column
#pragma unroll
      for (int i = 0; i < NO; i += 4) {
        // register i: n-tile i / 4 of 8 columns (the chunks in order)
        const int d = c0 + 8 * (i / 4) + 2 * quad;
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

// One instance's launch: its shared-memory limit (the SM's, as a launch
// under positions adds the mask to S::SMEM) is set and its blocks per SM
// are asked once.
template <int DP, bool SPLIT, bool KT128>
inline cudaError_t launch_forward(const FwdMaps<DP>& m, const FwdArgs& a,
                                  int bm, cudaStream_t stream) {
  using S = FwdShape<DP, KT128>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        attention_fwd_kernel<DP, SPLIT, KT128>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  static int per_sm = 0;
  if (per_sm == 0) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, attention_fwd_kernel<DP, SPLIT, KT128>, S::THREADS,
        S::SMEM);
    if (e != cudaSuccess) return e;
    if (per_sm == 0) return cudaErrorInvalidConfiguration;
  }
  const long long items = (long long)((a.Sq + bm - 1) / bm) * a.Hq * a.B;
  if (items == 0) return cudaSuccess;
  const bool pos = a.q_pos != nullptr;
  // a launch under positions is one item per block (the mask is the
  // item's) and holds a mask bit per key tile
  if (items > INT_MAX || (pos && a.Sk > S::MAX_KEYS))
    return cudaErrorInvalidValue;
  const int grid = plan_grid((int)items, sm_count(), per_sm, pos);
  attention_fwd_kernel<DP, SPLIT, KT128>
      <<<grid, S::THREADS, S::smem(a.Sk, pos), stream>>>(m, a);
  return cudaGetLastError();
}

// The forward at padded head dim DP and key tiles FwdShape<DP, KT128>::BN.
// K1 (no positions, DP < 128) takes the key split where plan_split says
// so (one block per SM: the shared memory of every instance is over half
// of the SM's).
template <int DP, bool KT128>
inline cudaError_t forward_instance(const FwdArgs& a, cudaStream_t stream) {
  using S = FwdShape<DP, KT128>;
  static_assert(2 * S::SMEM > kSmemMax, "one block per SM");
  const bool split = a.q_pos == nullptr && DP < 128 &&
                     plan_split(a.Sq, a.Hq * a.B, sm_count());
  const int bm = split ? 64 : S::BM;
  FwdMaps<DP> m;
  // the box widths in map order: 64, then 32 and 16 where DP has them
  int width[3] = {64, 0, 0};
  if (S::T32) width[FwdMaps<DP>::M32] = 32;
  if (S::T16) width[FwdMaps<DP>::M16] = 16;
  for (int w = 0; w < FwdMaps<DP>::N; ++w) {
    if (!encode_view(&m.q[w], a.q, a.B, a.Sq, a.Hq, a.D, a.q_sb, a.q_ss,
                     a.q_sh, width[w], bm) ||
        !encode_view(&m.k[w], a.k, a.B, a.Sk, a.Hkv, a.D, a.k_sb, a.k_ss,
                     a.k_sh, width[w], S::BN) ||
        !encode_view(&m.v[w], a.v, a.B, a.Sk, a.Hkv, a.D, a.v_sb, a.v_ss,
                     a.v_sh, width[w], S::BN))
      return cudaErrorInvalidValue;
  }
  if constexpr (DP < 128) {
    if (split) return launch_forward<DP, true, KT128>(m, a, bm, stream);
  }
  return launch_forward<DP, false, KT128>(m, a, bm, stream);
}

// The forward at padded head dim DP: at 128 the key-tile width is the
// shape's (fwd_keys128), the same for K2 and K3.
template <int DP>
inline cudaError_t attention_forward(const FwdArgs& a, cudaStream_t stream) {
  if constexpr (DP == 128) {
    if (fwd_keys128(a.Sq, a.Sk, a.Hq * a.B, a.q_pos != nullptr))
      return forward_instance<DP, true>(a, stream);
  }
  return forward_instance<DP, false>(a, stream);
}

}  // namespace
}  // namespace svt
