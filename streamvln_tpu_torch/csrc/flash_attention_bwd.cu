// K4 and K5: the backward of the position-masked GQA flash attention
// (the training path's attention; the forward with its logsumexp is K3 in
// flash_attention.cu), written for Hopper (sm_90a).
//
// K4 svt_flash_bwd_dq replaces streamvln_tpu/ops/flash_attention.py::
// _flash_bwd_dq_kernel, K5 svt_flash_bwd_dkv replaces ::_flash_bwd_dkv_kernel
// together with the sum over the G query heads of a KV head that the TPU
// wrapper does afterwards (_flash_core_bwd :474-475). Both recompute the
// scores S = Q K^T * scale tile by tile and take P = exp(S - LSE) from the
// forward's per-row logsumexp, applied only under the mask k_pos <= q_pos,
// so masked keys, padded rows and rows with no visible key (LSE = -1e30)
// give exactly P = 0. With Dsum = rowsum(dO * O) (one torch reduction in
// the wrapper, as JAX computes it outside its kernels):
//   dP = dO V^T,  dS = P * (dP - Dsum),
//   dQ = dS K * scale,  dK = dS^T Q * scale,  dV = P^T dO.
//
// Bound on the H100: per visible (query, key) pair and head K4 does three
// products of depth D (Q K^T, dO V^T, dS K) and K5 four (K Q^T, V dO^T,
// P^T dO, dS^T Q), against q, k, v, dO, the outputs and the row statistics
// in bytes; at the training shape (S=4096, D=128, 28/4 heads) that is
// thousands of FLOPs per byte, so the tensor cores bound both. Both run on
// the machinery of the forward (attention_fwd.cuh): TMA loads of swizzled
// tiles into a ring of mbarrier stages, two consumer warpgroups of 64 rows
// that take turns issuing wgmma (named barriers, so the exponentials of
// one overlap the products of the other), and the forward's exact skip
// rule and "full tile" flag. Unlike the forward, a block has no producer
// warp (see kBwdThreads): the first warp of the second consumer
// warpgroup keeps the ring full, refilling each slot once both
// warpgroups have released it. Each block first writes the smallest and
// largest position of every 64-entry tile of the streamed dimension into
// shared memory and lists the tiles it visits, so the skip rule costs no
// global loads on the way.
//
// K4: one block per (128-row query tile, batch x q head; 64 rows at D =
// 256), the tiles that see the most keys first (plan_tile). The ring holds
// the Q and dO tiles (loaded once) and streams 64-key K and V tiles with
// their key positions; a stage with k0 = -1 ends the walk. Each consumer
// computes S = Q K^T and dP = dO V^T (wgmma, both operands in shared
// memory, K-major), then P = exp2(S * scale * log2 e - LSE * log2 e) (one
// FMA) and dS = P (dP - Dsum) in registers, rounded to bf16, and dQ += dS K
// (wgmma with A from registers; the K stage is read MN-major with the
// transpose flag, as the forward reads V). The products of one tile are
// issued before the elementwise work of the last one is done with
// (software pipeline, first tile peeled so that no wgmma sits behind a
// branch). dQ is scaled once at the end. A block's LSE and Dsum rows are
// read once by the threads that own them (a TMA box of them would need Sq
// to be a multiple of 4).
//
// K5: one block per (128-key tile, batch x KV head; at D = 256 64 keys and
// a share of the group's q heads, plan_head_split), the key tiles that the
// most queries see first (plan_key_tile). The K and V tile is loaded
// once; the ring streams, for each q head of the group and each 64-row
// query tile, the Q and dO tiles with the tile's query positions, LSE (in
// log2 units) and Dsum. A query tile whose largest position is below the
// block's smallest key position is skipped (the mirror of the forward's
// rule), and a tile is "full" when every query sees every key. Each
// consumer owns 64 keys and keeps their dK and dV in f32 registers across
// all G heads and all query tiles, so the sum over G takes no atomics and
// no buffer, dK/dV are written once and calls are bit-equal. S^T = K Q^T
// and dP^T = V dO^T (wgmma SS; the query is on the N side, so LSE, Dsum
// and positions are column broadcasts read from the stage), then P^T and
// dS^T in registers, then dV += P^T dO and dK += dS^T Q (wgmma RS, the
// same Q/dO stage read MN-major). dK is scaled once at the end.
//
// At D = 256 the two warpgroups share the rows and split the products
// between them instead (WIDE, below).
//
// Numerics: bf16 operands, f32 accumulation; P and dS rounded to bf16
// before their products (the TPU kernels upcast to f32). Carrying them as
// hi + lo bf16 pairs instead leaves Gemma's training gradients as far from
// f32 attention as before (tools/pds_precision.py).
//
// C interface (ctypes): q/dO/dQ [B, Sq, Hq, D], k/v/dK/dV [B, Sk, Hkv, D]
// or KV-head-major, all described by (batch, seq, head) strides in
// elements (multiples of 8) with a contiguous head dim, D 64, 128 or 256;
// lse/dsum [B, Hq, Sq] f32 contiguous; q_pos [B, Sq], k_pos [B, Sk] int32.
#include "attention_fwd.cuh"

namespace svt {
namespace {   // internal linkage, as attention_fwd.cuh

typedef __nv_bfloat16 bf16;

struct BwdArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* lse;    // [B, Hq, Sq]
  const float* dsum;   // [B, Hq, Sq]
  bf16* dq;
  bf16* dk;
  bf16* dv;
  const int* q_pos;    // [B, Sq]
  const int* k_pos;    // [B, Sk]
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long do_sb, do_ss, do_sh;
  long long dq_sb, dq_ss, dq_sh;
  long long dk_sb, dk_ss, dk_sh;
  long long dv_sb, dv_ss, dv_sh;
  // K5 at head dim 256 with `splits` > 1 blocks per (key tile, batch x
  // KV head): each block's f32 dK/dV partial, and one arrival counter per
  // (key tile, batch x KV head), zero at launch
  float* part;
  int* counts;
  int B, Sq, Sk, Hq, Hkv, D, group, splits;
  float scale;
};

// TMA descriptors (64-column boxes, 128-byte swizzle): the per-block tiles
// of one kernel have a box of 128 rows, the streamed ones 64.
struct BwdMaps {
  CUtensorMap q, dout, k, v;
};

// Two consumer warpgroups and no producer warp: 256 threads (two warps on
// each SM sub-partition), so every thread may hold up to 255 registers.
// At D = 128 K5 takes 252 and K4 215 (dK and dV of a consumer's 64 keys
// alone are 128 f32 a thread). With a producer warpgroup, or one producer
// warp, ptxas caps every thread at 168 and spills, setmaxnreg or not. The
// first warp of warpgroup 1, which releases each stage after warpgroup 0
// (it issues second), refills the ring.
constexpr int kBwdThreads = 128 * kConsumers;
constexpr int kLeaderWarp = 4;

// Head dim 256 (Gemma, WIDE below): a 64 x 256 f32 accumulator is 128 registers
// a thread, so a warpgroup holds one and both warpgroups take the same 64
// rows (K4: query rows, K5: keys). Each score product is computed once
// and the warpgroups exchange what the other needs through shared memory
// under named barriers (3 products of depth D per visible (query, key)
// pair and head in K4, 4 in K5):
// - K4: warpgroup 0 forms S = Q K^T and P, warpgroup 1 dP = dO V^T; P goes
//   to warpgroup 1 (f32, 16 KB), which forms dS and sends it back as the
//   bf16 A fragments of dQ += dS K (8 KB); warpgroup w then accumulates
//   dQ's columns [128 w, 128 w + 128).
// - K5: warpgroup 0 owns dV (S^T = K Q^T, P^T, dV += P^T dO), warpgroup 1
//   owns dK (dP^T = V dO^T, dS^T = P^T (dP^T - Dsum) with P^T read from
//   shared memory, f32 as warpgroup 0 formed it, dK += dS^T Q).
// The exchanged tiles are laid out by thread (both warpgroups' 64 x 64
// accumulators put the same elements in the thread of the same index), so
// each thread reads back exactly what its counterpart wrote, in 16-byte
// words. Tiles of 64 rows and two stages keep shared memory under 220 KB.
// K5's grid at this width has a quarter of the pairs of D = 128 (64-key
// tiles, Gemma's one KV head); under one wave plan_head_split gives each
// pair several blocks, each taking a share of the group's q heads. Those
// write f32 partials of dK/dV to a scratch buffer, and the last block of
// the pair to arrive (an arrival counter) sums them in split order and
// writes dK/dV: no atomics touch the outputs, and calls stay bit-equal.
//
// Named barriers of the WIDE exchanges (0 is __syncthreads; the D <= 128
// kernels' turn-taking uses 1 and 2): the P tile written and read, and
// K4's dS tile written and read.
constexpr int kPFull = 1, kPEmpty = 2, kDsFull = 3, kDsEmpty = 4;

// d (+)= A B^T over the head dim: A's rows from `da` (K-major, 64-column
// chunks `a_chunk` bytes apart), B's N rows from `db` (chunks `b_chunk`
// apart); NW * 4 steps of depth 16.
template <int NW, int N>
__device__ __forceinline__ void issue_ss(float* d, uint64_t da,
                                         uint32_t a_chunk, uint64_t db,
                                         uint32_t b_chunk) {
#pragma unroll
  for (int c = 0; c < NW; ++c) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<N>(d, desc_add(da, c * a_chunk + kk * 32),
                  desc_add(db, c * b_chunk + kk * 32), c + kk > 0);
  }
}

// acc[64 x DP] += F B: F's 16-wide depth step kk is the register fragment
// f[kk]; B's KS * 16 rows are read MN-major (transposed) from `db`, its
// 64-column chunks `b_chunk` bytes apart.
template <int NW, int KS>
__device__ __forceinline__ void issue_rs(float* acc, const uint32_t (*f)[4],
                                         uint64_t db, uint32_t b_chunk) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
    for (int c = 0; c < NW; ++c)
      wgmma_rs_n64(acc + 32 * c, f[kk],
                   desc_add(db, c * b_chunk + kk * 16 * 128));
  }
}

// The smem base aligned to 1024 bytes (the 128-byte swizzle's pattern).
__device__ __forceinline__ uint32_t aligned_base(unsigned char*& sm,
                                                 unsigned char* raw) {
  const uint32_t r = smem_u32(raw);
  const uint32_t base = (r + 1023u) & ~1023u;
  sm = raw + (base - r);
  return base;
}

// The smallest and largest entry of each 64-entry tile of pos[0, n), into
// tmin / tmax; entries past n count as pad_min and pad_max. Every warp of
// the block, one tile per warp at a time.
__device__ __forceinline__ void tile_stats(const int* pos, int n,
                                           int n_tiles, int pad_min,
                                           int pad_max, int* tmin,
                                           int* tmax) {
  const int lane = threadIdx.x & 31;
  for (int t = threadIdx.x >> 5; t < n_tiles; t += kBwdThreads / 32) {
    const int i0 = t * 64 + lane, i1 = i0 + 32;
    const int p0 = i0 < n ? pos[i0] : 0, p1 = i1 < n ? pos[i1] : 0;
    const int mn = __reduce_min_sync(
        0xffffffffu, min(i0 < n ? p0 : pad_min, i1 < n ? p1 : pad_min));
    const int mx = __reduce_max_sync(
        0xffffffffu, max(i0 < n ? p0 : pad_max, i1 < n ? p1 : pad_max));
    if (lane == 0) {
      tmin[t] = mn;
      tmax[t] = mx;
    }
  }
}

// The tiles t < n_tiles with keep(t), in order, into `list` (one warp);
// returns their count.
template <typename Keep>
__device__ __forceinline__ int build_list(int n_tiles, Keep keep, int* list,
                                          int lane) {
  int count = 0;
  for (int t0 = 0; t0 < n_tiles; t0 += 32) {
    const int t = t0 + lane;
    const bool k = t < n_tiles && keep(t);
    const unsigned m = __ballot_sync(0xffffffffu, k);
    if (k) list[count + __popc(m & ((1u << lane) - 1u))] = t;
    count += __popc(m);
  }
  __syncwarp();
  return count;
}

// The smallest and largest of the 32 lanes' `cnt` entries p[lane + 32 i]
// (0 <= i < cnt) of rows below n; rows at or past n count as pad_min and
// pad_max (one warp).
__device__ __forceinline__ void block_range(const int* p, int n, int cnt,
                                            int pad_min, int pad_max,
                                            int& mn, int& mx) {
  const int lane = threadIdx.x & 31;
  mn = INT_MAX;
  mx = INT_MIN;
  for (int i = 0; i < cnt; ++i) {
    const int r = lane + 32 * i;
    mn = min(mn, r < n ? p[r] : pad_min);
    mx = max(mx, r < n ? p[r] : pad_max);
  }
  mn = __reduce_min_sync(0xffffffffu, mn);
  mx = __reduce_max_sync(0xffffffffu, mx);
}

// Store rows r0 and r0 + 8 of a 64 x DP accumulator (wgmma layout) times
// `mul` as bf16; rows >= n are not stored.
template <int NO>
__device__ __forceinline__ void store_rows(bf16* out, long long row_stride,
                                           int r0, int n, int quad,
                                           const float* acc, float mul) {
  const int r1 = r0 + 8;
#pragma unroll
  for (int i = 0; i < NO; i += 4) {
    const int d = 64 * (i / 32) + 8 * ((i % 32) / 4) + 2 * quad;
    if (r0 < n)
      *reinterpret_cast<uint32_t*>(out + r0 * row_stride + d) =
          pack_bf16(acc[i] * mul, acc[i + 1] * mul);
    if (r1 < n)
      *reinterpret_cast<uint32_t*>(out + r1 * row_stride + d) =
          pack_bf16(acc[i + 2] * mul, acc[i + 3] * mul);
  }
}

// ---- K4: dQ ---------------------------------------------------------------

// P = exp2(S * sl2 - LSE2) under the mask k_pos <= q_pos (none on a full
// tile), in place in s. Registers as the forward's softmax_tile: rows r0
// and r0 + 8 (lse, qp *0 and *1), key columns 8j + 2 quad + {0, 1}.
template <int NS>
__device__ __forceinline__ void p_tile(float* s, bool full, const int* kpos,
                                       int quad, int qp0, int qp1, float l0,
                                       float l1, float sl2) {
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const bool hi = i & 2;
    const int col = 8 * (i / 4) + 2 * quad + (i & 1);
    const bool vis = full || kpos[col] <= (hi ? qp1 : qp0);
    s[i] = vis ? ex2(fmaf(s[i], sl2, -(hi ? l1 : l0))) : 0.f;
  }
}

// P, then dS = P (dP - Dsum) in place in s (Dsum of rows r0 and r0 + 8 in
// ds0 and ds1).
template <int NS>
__device__ __forceinline__ void ds_tile(float* s, const float* dp, bool full,
                                        const int* kpos, int quad, int qp0,
                                        int qp1, float l0, float l1,
                                        float ds0, float ds1, float sl2) {
  p_tile<NS>(s, full, kpos, quad, qp0, qp1, l0, l1, sl2);
#pragma unroll
  for (int i = 0; i < NS; ++i) s[i] *= dp[i] - ((i & 2) ? ds1 : ds0);
}

// The WIDE exchange tiles, by thread: thread t's NS f32 score registers as
// 16-byte words x[(i / 4) * 128 + t], its NK bf16 A fragments as
// x[kk * 128 + t] (a warp's 32 words are 512 contiguous bytes).
template <int NS>
__device__ __forceinline__ void put_scores(float4* x, const float* s,
                                           int t) {
#pragma unroll
  for (int i = 0; i < NS; i += 4)
    x[(i / 4) * 128 + t] = make_float4(s[i], s[i + 1], s[i + 2], s[i + 3]);
}

template <int NK>
__device__ __forceinline__ void put_frags(uint4* x, const uint32_t (*f)[4],
                                          int t) {
#pragma unroll
  for (int kk = 0; kk < NK; ++kk)
    x[kk * 128 + t] = make_uint4(f[kk][0], f[kk][1], f[kk][2], f[kk][3]);
}

template <int NK>
__device__ __forceinline__ void get_frags(const uint4* x, uint32_t (*f)[4],
                                          int t) {
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    const uint4 w = x[kk * 128 + t];
    f[kk][0] = w.x; f[kk][1] = w.y; f[kk][2] = w.z; f[kk][3] = w.w;
  }
}

template <int DP>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_dq_kernel(__grid_constant__ const BwdMaps maps, const BwdArgs a) {
  using S = DqShape<DP>;
  constexpr int BM = S::BM, BN = S::BN, NW = S::NW, ST = S::ST;

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm;
  const uint32_t base = aligned_base(sm, smem_raw);
  int* kpos_s = reinterpret_cast<int*>(sm + S::POS_OFF);
  int* meta_k0 = reinterpret_cast<int*>(sm + S::META_OFF);
  int* meta_full = meta_k0 + ST;
  const int n_kt = (a.Sk + BN - 1) / BN;
  int* tmin = reinterpret_cast<int*>(sm + S::TILE_OFF);
  int* tmax = tmin + n_kt;
  int* list = tmax + n_kt;
  const uint32_t qfull = base + S::BAR_OFF;
  const uint32_t full0 = qfull + 8;                // full[s] = full0 + 8 s
  const uint32_t empty0 = full0 + 8 * ST;          // empty[s]

  const int n_qt = (a.Sq + BM - 1) / BM;
  const TileCoord tc = plan_tile(blockIdx.x, n_qt, a.Hq * a.B, true);
  const int q0 = tc.tile * BM;
  const int h = tc.hb % a.Hq, b = tc.hb / a.Hq;
  const int hk = h / a.group;
  const int* qpb = a.q_pos + (long long)b * a.Sq;
  const int* kpb = a.k_pos + (long long)b * a.Sk;

  if (threadIdx.x == 0) {
    mbar_init(qfull, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers * 4);
    }
    mbar_init_fence();
  }
  tile_stats(kpb, a.Sk, n_kt, kInvalidPos, kInvalidPos, tmin, tmax);
  __syncthreads();

  const int cw = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  const int lane = t & 31, quad = lane & 3;
  const bool leader = threadIdx.x / 32 == kLeaderWarp;

  // The leader's ring: the key tiles the block visits (the exact skip
  // rule: a tile whose smallest position exceeds the block's largest query
  // position is left out), stage n in slot n % ST after the release of
  // stage n - ST, and the end marker (k0 = -1) as stage `count`.
  int count = 0, issued = 0, qmin = 0, np0 = 0, np1 = 0;
  auto key_pos = [&](int k) { return k < a.Sk ? kpb[k] : kInvalidPos; };
  auto prefetch = [&]() {   // the next stage's key positions
    if (issued < count) {
      const int k0 = list[issued] * BN;
      np0 = key_pos(k0 + lane);
      np1 = key_pos(k0 + 32 + lane);
    }
  };
  auto commit = [&]() {     // issue the next stage
    if (issued > count) return;
    const int slot = issued % ST;
    if (issued >= ST) mbar_wait(empty0 + 8 * slot, (issued / ST - 1) & 1);
    if (issued < count) {
      const int kt = list[issued], k0 = kt * BN;
      kpos_s[slot * BN + lane] = np0;
      kpos_s[slot * BN + 32 + lane] = np1;
      __syncwarp();
      if (lane == 0) {
        const uint32_t fb = full0 + 8 * slot;
        const uint32_t ks = base + S::K_OFF + slot * S::KV_BYTES;
        const uint32_t vs = base + S::V_OFF + slot * S::KV_BYTES;
        meta_k0[slot] = k0;
        // no per-element mask where every key is seen by every row
        meta_full[slot] = k0 + BN <= a.Sk && tmax[kt] <= qmin;
        mbar_arrive_tx(fb, 2 * S::KV_BYTES);
#pragma unroll
        for (int c = 0; c < NW; ++c) {
          tma_load_4d(ks + c * BN * 128, &maps.k, fb, c * 64, k0, hk, b);
          tma_load_4d(vs + c * BN * 128, &maps.v, fb, c * 64, k0, hk, b);
        }
      }
    } else if (lane == 0) {
      meta_k0[slot] = -1;
      mbar_arrive(full0 + 8 * slot);
    }
    __syncwarp();
    ++issued;
  };
  if (leader) {
    int qmax;
    block_range(qpb + q0, a.Sq - q0, BM / 32, INT_MAX, INT_MIN, qmin, qmax);
    count = build_list(n_kt, [&](int kt) { return tmin[kt] <= qmax; }, list,
                       lane);
    if (lane == 0) {
      mbar_arrive_tx(qfull, 2 * S::Q_BYTES);
#pragma unroll
      for (int c = 0; c < NW; ++c) {
        tma_load_4d(base + S::Q_OFF + c * BM * 128, &maps.q, qfull, c * 64,
                    q0, h, b);
        tma_load_4d(base + S::DO_OFF + c * BM * 128, &maps.dout, qfull,
                    c * 64, q0, h, b);
      }
    }
    while (issued < ST && issued <= count) {
      prefetch();
      commit();
    }
  }

  const float sl2 = a.scale * kLog2e;
  const long long rb = ((long long)b * a.Hq + h) * a.Sq;
  // this thread's rows r0 and r0 + 8 (the warpgroups share the tile's
  // rows when WIDE)
  const int row0 = (S::WIDE ? 0 : 64 * cw) + 16 * (t >> 5) + (lane >> 2);
  const int r0 = q0 + row0, r1 = r0 + 8;
  const bool ok0 = r0 < a.Sq, ok1 = r1 < a.Sq;
  const int qp0 = ok0 ? qpb[r0] : INT_MIN, qp1 = ok1 ? qpb[r1] : INT_MIN;
  const float l0 = ok0 ? a.lse[rb + r0] * kLog2e : 0.f;
  const float l1 = ok1 ? a.lse[rb + r1] * kLog2e : 0.f;
  const float ds0 = ok0 ? a.dsum[rb + r0] : 0.f;
  const float ds1 = ok1 ? a.dsum[rb + r1] : 0.f;
  if constexpr (S::WIDE) {
    // warpgroup 0 forms S and P, warpgroup 1 dP and dS, each accumulates
    // half of dQ
    float4* xp = reinterpret_cast<float4*>(sm + S::XP_OFF);
    uint4* xd = reinterpret_cast<uint4*>(sm + S::XD_OFF);
    // S = Q K^T (warpgroup 0) or dP = dO V^T (1): the tile's rows and the
    // stage, both K-major; then this warpgroup's 128 columns of K, read
    // MN-major, for dS K
    const uint64_t da = gmma_desc(base + (cw == 0 ? S::Q_OFF : S::DO_OFF),
                                  16, 1024, kSw128);
    const uint64_t db = gmma_desc(base + (cw == 0 ? S::K_OFF : S::V_OFF),
                                  16, 1024, kSw128);
    const uint64_t dkt = gmma_desc(base + S::K_OFF + 2 * cw * BN * 128,
                                   BN * 128, 1024, kSw128);
    constexpr int NS = BN / 2;          // score registers per thread
    constexpr int NO = 64;              // half of dQ's columns
    float s[NS], acc[NO];
    uint32_t f[BN / 16][4];
#pragma unroll
    for (int i = 0; i < NO; ++i) acc[i] = 0.f;
    // both exchange tiles start empty
    named_arrive(cw == 0 ? kDsEmpty : kPEmpty, 256);
    int stage = 0;
    uint32_t phase = 0;
    mbar_wait(qfull, 0);
    for (;;) {
      if (leader) prefetch();
      mbar_wait(full0 + 8 * stage, phase);
      if (meta_k0[stage] < 0) break;
      const uint32_t so = stage * S::KV_BYTES;
      wgmma_fence();
      issue_ss<NW, BN>(s, da, BM * 128, desc_add(db, so), BN * 128);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<NS>(s);
      if (cw == 0) {
        p_tile<NS>(s, meta_full[stage] != 0, kpos_s + stage * BN, quad, qp0,
                   qp1, l0, l1, sl2);
        named_sync(kPEmpty, 256);
        put_scores<NS>(xp, s, t);
        named_arrive(kPFull, 256);
        named_sync(kDsFull, 256);
        get_frags<BN / 16>(xd, f, t);
        named_arrive(kDsEmpty, 256);
      } else {
        named_sync(kPFull, 256);
#pragma unroll
        for (int i = 0; i < NS; i += 4) {
          const float4 p = xp[(i / 4) * 128 + t];
          s[i] = p.x * (s[i] - ds0);
          s[i + 1] = p.y * (s[i + 1] - ds0);
          s[i + 2] = p.z * (s[i + 2] - ds1);
          s[i + 3] = p.w * (s[i + 3] - ds1);
        }
        named_arrive(kPEmpty, 256);
        pack_p<BN / 16>(s, f);
        named_sync(kDsEmpty, 256);
        put_frags<BN / 16>(xd, f, t);
        named_arrive(kDsFull, 256);
      }
      wgmma_fence();
      issue_rs<2, BN / 16>(acc, f, desc_add(dkt, so), BN * 128);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<NO>(acc);
      release(empty0 + 8 * stage, lane);
      if (leader) commit();   // warpgroup 0 has released this stage too
      if (++stage == ST) { stage = 0; phase ^= 1; }
    }
    bf16* ob = a.dq + b * a.dq_sb + h * a.dq_sh + (long long)q0 * a.dq_ss +
               128 * cw;
    store_rows<NO>(ob, a.dq_ss, row0, a.Sq - q0, quad, acc, a.scale);
    return;
  } else {
    // this warpgroup's Q and dO rows; the K and V stage 0, K-major for the
    // scores, and K read MN-major (transposed) for dS K
    const uint64_t dqa = gmma_desc(base + S::Q_OFF + cw * 64 * 128, 16, 1024,
                                   kSw128);
    const uint64_t doa = gmma_desc(base + S::DO_OFF + cw * 64 * 128, 16,
                                   1024, kSw128);
    const uint64_t dkb = gmma_desc(base + S::K_OFF, 16, 1024, kSw128);
    const uint64_t dvb = gmma_desc(base + S::V_OFF, 16, 1024, kSw128);
    const uint64_t dkt = gmma_desc(base + S::K_OFF, BN * 128, 1024, kSw128);
    constexpr int NS = BN / 2;          // score registers per thread
    constexpr int NO = NW * 32;         // dQ registers per thread
    float s[NS], dp[NS], acc[NO];
    uint32_t f[BN / 16][4];
#pragma unroll
    for (int i = 0; i < NO; ++i) acc[i] = 0.f;
    // Software pipeline: iteration j issues S_j, dP_j and then
    // dQ += dS_{j-1} K_{j-1}, forms dS_j while that product runs and
    // releases stage j-1 once it is done.
    if (cw == 1) named_arrive(1, 256);   // warpgroup 0 goes first
    int stage = 0;
    uint32_t phase = 0;
    mbar_wait(qfull, 0);
    mbar_wait(full0 + 8 * stage, phase);
    int prev = -1;
    if (meta_k0[stage] >= 0) {
      named_sync(1 + cw, 256);
      wgmma_fence();
      issue_ss<NW, BN>(s, dqa, BM * 128, desc_add(dkb, stage * S::KV_BYTES),
                       BN * 128);
      issue_ss<NW, BN>(dp, doa, BM * 128, desc_add(dvb, stage * S::KV_BYTES),
                       BN * 128);
      wgmma_commit();
      named_arrive(2 - cw, 256);
      wgmma_wait<0>();
      fence_regs<NS>(s);
      fence_regs<NS>(dp);
      ds_tile<NS>(s, dp, meta_full[stage] != 0, kpos_s + stage * BN, quad,
                  qp0, qp1, l0, l1, ds0, ds1, sl2);
      pack_p<BN / 16>(s, f);
      prev = stage;
      if (++stage == ST) { stage = 0; phase ^= 1; }
      for (;;) {
        if (leader) prefetch();
        mbar_wait(full0 + 8 * stage, phase);
        if (meta_k0[stage] < 0) break;
        named_sync(1 + cw, 256);
        wgmma_fence();
        issue_ss<NW, BN>(s, dqa, BM * 128, desc_add(dkb, stage * S::KV_BYTES),
                         BN * 128);
        issue_ss<NW, BN>(dp, doa, BM * 128, desc_add(dvb, stage * S::KV_BYTES),
                         BN * 128);
        wgmma_commit();
        issue_rs<NW, BN / 16>(acc, f, desc_add(dkt, prev * S::KV_BYTES),
                              BN * 128);
        wgmma_commit();
        named_arrive(2 - cw, 256);
        wgmma_wait<1>();
        fence_regs<NS>(s);
        fence_regs<NS>(dp);
        ds_tile<NS>(s, dp, meta_full[stage] != 0, kpos_s + stage * BN, quad,
                    qp0, qp1, l0, l1, ds0, ds1, sl2);
        wgmma_wait<0>();
        fence_regs<NO>(acc);
        release(empty0 + 8 * prev, lane);
        if (leader) commit();   // warpgroup 0 has released stage j-1 too
        fence_regs<NS>(s);      // dS_j is packed after dS_{j-1} K is done
        pack_p<BN / 16>(s, f);
        prev = stage;
        if (++stage == ST) { stage = 0; phase ^= 1; }
      }
    }
    if (prev >= 0) {
      wgmma_fence();
      issue_rs<NW, BN / 16>(acc, f, desc_add(dkt, prev * S::KV_BYTES),
                            BN * 128);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<NO>(acc);
    }
    // every stage has been issued: no slot needs releasing
    bf16* ob = a.dq + b * a.dq_sb + h * a.dq_sh + (long long)q0 * a.dq_ss;
    store_rows<NO>(ob, a.dq_ss, row0, a.Sq - q0, quad, acc, a.scale);
  }
}

// ---- K5: dK and dV ----------------------------------------------------------

template <int DP>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_dkv_kernel(__grid_constant__ const BwdMaps maps, const BwdArgs a) {
  using S = DkvShape<DP>;
  constexpr int BK = S::BK, BQ = S::BQ, NW = S::NW, ST = S::ST;

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* sm;
  const uint32_t base = aligned_base(sm, smem_raw);
  int* qpos_s = reinterpret_cast<int*>(sm + S::ROW_OFF);   // [ST][BQ]
  float* lse_s = reinterpret_cast<float*>(qpos_s + ST * BQ);
  float* dsum_s = lse_s + ST * BQ;
  int* meta_q0 = reinterpret_cast<int*>(sm + S::META_OFF);
  int* meta_full = meta_q0 + ST;
  const int n_qt = (a.Sq + BQ - 1) / BQ;
  int* tmin = reinterpret_cast<int*>(sm + S::TILE_OFF);
  int* tmax = tmin + n_qt;
  int* list = tmax + n_qt;
  const uint32_t kvfull = base + S::BAR_OFF;
  const uint32_t full0 = kvfull + 8;
  const uint32_t empty0 = full0 + 8 * ST;

  const KeyItem ki = plan_key_item(blockIdx.x, a.Hkv * a.B, a.group,
                                   S::WIDE ? a.splits : 1);
  const int k0 = ki.tile * BK;
  const int hk = ki.hb % a.Hkv, b = ki.hb / a.Hkv;
  const int h0 = hk * a.group + ki.head0;   // the block's first q head
  const int* qpb = a.q_pos + (long long)b * a.Sq;
  const int* kpb = a.k_pos + (long long)b * a.Sk;

  if (threadIdx.x == 0) {
    mbar_init(kvfull, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers * 4);
    }
    mbar_init_fence();
  }
  // query rows past Sq are left out of a tile's range
  tile_stats(qpb, a.Sq, n_qt, INT_MAX, INT_MIN, tmin, tmax);
  __syncthreads();

  const int cw = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  const int lane = t & 31, quad = lane & 3;
  const bool leader = threadIdx.x / 32 == kLeaderWarp;

  // The leader's ring: for each q head the block takes, the query tiles the
  // block visits (the mirror of the skip rule: a tile whose largest
  // position is below the block's smallest key position is left out),
  // stage n in slot n % ST after the release of stage n - ST, and the end
  // marker (q0 = -1) as stage `total`.
  int count = 0, total = 0, issued = 0, kmax = 0;
  int np0 = 0, np1 = 0;
  float nl0 = 0.f, nl1 = 0.f, nd0 = 0.f, nd1 = 0.f;
  auto prefetch = [&]() {   // the next stage's query positions, LSE, Dsum
    if (issued < total) {
      const int h = h0 + issued / count, q0 = list[issued % count] * BQ;
      const long long rb = ((long long)b * a.Hq + h) * a.Sq;
      const int qa = q0 + lane, qb = qa + 32;
      np0 = qa < a.Sq ? qpb[qa] : INT_MIN;
      np1 = qb < a.Sq ? qpb[qb] : INT_MIN;
      nl0 = qa < a.Sq ? a.lse[rb + qa] * kLog2e : 0.f;
      nl1 = qb < a.Sq ? a.lse[rb + qb] * kLog2e : 0.f;
      nd0 = qa < a.Sq ? a.dsum[rb + qa] : 0.f;
      nd1 = qb < a.Sq ? a.dsum[rb + qb] : 0.f;
    }
  };
  auto commit = [&]() {     // issue the next stage
    if (issued > total) return;
    const int slot = issued % ST;
    if (issued >= ST) mbar_wait(empty0 + 8 * slot, (issued / ST - 1) & 1);
    if (issued < total) {
      const int h = h0 + issued / count, qt = list[issued % count];
      const int q0 = qt * BQ;
      const int ro = slot * BQ + lane;
      qpos_s[ro] = np0;
      qpos_s[ro + 32] = np1;
      lse_s[ro] = nl0;
      lse_s[ro + 32] = nl1;
      dsum_s[ro] = nd0;
      dsum_s[ro + 32] = nd1;
      __syncwarp();
      if (lane == 0) {
        const uint32_t fb = full0 + 8 * slot;
        const uint32_t qs = base + S::Q_OFF + slot * S::QS_BYTES;
        const uint32_t ds = base + S::DO_OFF + slot * S::QS_BYTES;
        meta_q0[slot] = q0;
        // no per-element mask where every query sees every key
        meta_full[slot] = k0 + BK <= a.Sk && q0 + BQ <= a.Sq &&
                          kmax <= tmin[qt];
        mbar_arrive_tx(fb, 2 * S::QS_BYTES);
#pragma unroll
        for (int c = 0; c < NW; ++c) {
          tma_load_4d(qs + c * BQ * 128, &maps.q, fb, c * 64, q0, h, b);
          tma_load_4d(ds + c * BQ * 128, &maps.dout, fb, c * 64, q0, h, b);
        }
      }
    } else if (lane == 0) {
      meta_q0[slot] = -1;
      mbar_arrive(full0 + 8 * slot);
    }
    __syncwarp();
    ++issued;
  };
  if (leader) {
    int kmin;
    block_range(kpb + k0, a.Sk - k0, BK / 32, kInvalidPos, kInvalidPos,
                kmin, kmax);
    count = build_list(n_qt, [&](int qt) { return tmax[qt] >= kmin; }, list,
                       lane);
    total = count * ki.heads;
    if (lane == 0) {
      mbar_arrive_tx(kvfull, 2 * S::KV_BYTES);
#pragma unroll
      for (int c = 0; c < NW; ++c) {
        tma_load_4d(base + S::K_OFF + c * BK * 128, &maps.k, kvfull, c * 64,
                    k0, hk, b);
        tma_load_4d(base + S::V_OFF + c * BK * 128, &maps.v, kvfull, c * 64,
                    k0, hk, b);
      }
    }
    while (issued < ST && issued <= total) {
      prefetch();
      commit();
    }
  }

  const float sl2 = a.scale * kLog2e;
  // this thread's keys row0 and row0 + 8 of the tile (the warpgroups
  // share the tile's keys when WIDE)
  const int row0 = (S::WIDE ? 0 : 64 * cw) + 16 * (t >> 5) + (lane >> 2);
  const int kp0 = k0 + row0 < a.Sk ? kpb[k0 + row0] : kInvalidPos;
  const int kp1 = k0 + row0 + 8 < a.Sk ? kpb[k0 + row0 + 8] : kInvalidPos;
  if constexpr (S::WIDE) {
    // warpgroup 0 owns dV, warpgroup 1 dK
    float4* xp = reinterpret_cast<float4*>(sm + S::XP_OFF);
    // S^T = K Q^T (warpgroup 0) or dP^T = V dO^T (1), both K-major; then
    // dO (for dV += P^T dO) or Q (for dK += dS^T Q), read MN-major
    const uint64_t da = gmma_desc(base + (cw == 0 ? S::K_OFF : S::V_OFF),
                                  16, 1024, kSw128);
    const uint64_t db = gmma_desc(base + (cw == 0 ? S::Q_OFF : S::DO_OFF),
                                  16, 1024, kSw128);
    const uint64_t dt = gmma_desc(base + (cw == 0 ? S::DO_OFF : S::Q_OFF),
                                  BQ * 128, 1024, kSw128);
    constexpr int NS = BQ / 2;          // S^T registers per thread
    constexpr int NO = NW * 32;         // dV or dK registers per thread
    float s[NS], acc[NO];
    uint32_t f[BQ / 16][4];
#pragma unroll
    for (int i = 0; i < NO; ++i) acc[i] = 0.f;
    if (cw == 1) named_arrive(kPEmpty, 256);   // the P tile starts empty
    int stage = 0;
    uint32_t phase = 0;
    mbar_wait(kvfull, 0);
    for (;;) {
      if (leader) prefetch();
      mbar_wait(full0 + 8 * stage, phase);
      if (meta_q0[stage] < 0) break;
      const uint32_t so = stage * S::QS_BYTES;
      wgmma_fence();
      issue_ss<NW, BQ>(s, da, BK * 128, desc_add(db, so), BQ * 128);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<NS>(s);
      // the query (column) broadcasts come from the stage
      if (cw == 0) {
        const bool full = meta_full[stage] != 0;
        const int* qp = qpos_s + stage * BQ;
        const float* lq = lse_s + stage * BQ;
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          const int col = 8 * (i / 4) + 2 * quad + (i & 1);
          const bool vis = full || ((i & 2) ? kp1 : kp0) <= qp[col];
          s[i] = vis ? ex2(fmaf(s[i], sl2, -lq[col])) : 0.f;
        }
        named_sync(kPEmpty, 256);
        put_scores<NS>(xp, s, t);
        named_arrive(kPFull, 256);
      } else {
        const float* dsq = dsum_s + stage * BQ;
        named_sync(kPFull, 256);
#pragma unroll
        for (int i = 0; i < NS; i += 4) {
          const float4 p = xp[(i / 4) * 128 + t];
          const int col = 8 * (i / 4) + 2 * quad;
          const float d0 = dsq[col], d1 = dsq[col + 1];
          s[i] = p.x * (s[i] - d0);
          s[i + 1] = p.y * (s[i + 1] - d1);
          s[i + 2] = p.z * (s[i + 2] - d0);
          s[i + 3] = p.w * (s[i + 3] - d1);
        }
        named_arrive(kPEmpty, 256);
      }
      pack_p<BQ / 16>(s, f);
      wgmma_fence();
      issue_rs<NW, BQ / 16>(acc, f, desc_add(dt, so), BQ * 128);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<NO>(acc);
      release(empty0 + 8 * stage, lane);
      if (leader) commit();   // warpgroup 0 has released this stage too
      if (++stage == ST) { stage = 0; phase ^= 1; }
    }
    // warpgroup 0 writes dV, warpgroup 1 dK (scaled)
    const int n = a.Sk - k0;
    const long long ss = cw == 0 ? a.dv_ss : a.dk_ss;
    bf16* out = cw == 0 ? a.dv + b * a.dv_sb + hk * a.dv_sh + k0 * ss
                        : a.dk + b * a.dk_sb + hk * a.dk_sh + k0 * ss;
    const float mul = cw == 0 ? 1.f : a.scale;
    if (a.splits == 1) {
      store_rows<NO>(out, ss, row0, n, quad, acc, mul);
      return;
    }
    // This block's partial, thread t's registers as 16-byte words
    // [i / 4][t]. The last of the pair's blocks to arrive sums all of them
    // in split order, so the sum does not depend on which block is last;
    // it reads them word by word (the partials summed in registers would
    // not fit beside the accumulator).
    const long long pair =
        ((long long)b * a.Hkv + hk) * ((a.Sk + BK - 1) / BK) + k0 / BK;
    constexpr int WORDS = NO / 4 * 128;
    float4* part = reinterpret_cast<float4*>(a.part) +
                   (pair * a.splits * 2 + cw) * WORDS + t;
#pragma unroll
    for (int i = 0; i < NO; i += 4)
      __stcg(part + ki.split * 2 * WORDS + (i / 4) * 128,
             make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]));
    __threadfence();
    __syncthreads();
    int* last = reinterpret_cast<int*>(sm + S::BAR_OFF - 8);
    if (threadIdx.x == 0)
      *last = atomicAdd(a.counts + pair, 1) == a.splits - 1;
    __syncthreads();
    if (*last == 0) return;
    __threadfence();
#pragma unroll 4
    for (int w = 0; w < NO / 4; ++w) {
      float4 v = __ldcg(part + w * 128);
      for (int sp = 1; sp < a.splits; ++sp) {
        const float4 u = __ldcg(part + sp * 2 * WORDS + w * 128);
        v.x += u.x;
        v.y += u.y;
        v.z += u.z;
        v.w += u.w;
      }
      // store_rows' register i = 4 w: rows row0 and row0 + 8
      const int d = 64 * (w / 8) + 8 * (w % 8) + 2 * quad;
      if (row0 < n)
        *reinterpret_cast<uint32_t*>(out + row0 * ss + d) =
            pack_bf16(v.x * mul, v.y * mul);
      if (row0 + 8 < n)
        *reinterpret_cast<uint32_t*>(out + (row0 + 8) * ss + d) =
            pack_bf16(v.z * mul, v.w * mul);
    }
    return;
  } else {
    // this warpgroup's 64 keys of K and V (A operands); the Q and dO stage 0
    // K-major for the scores, and read MN-major for the dK/dV products
    const uint64_t dka = gmma_desc(base + S::K_OFF + cw * 64 * 128, 16, 1024,
                                   kSw128);
    const uint64_t dva = gmma_desc(base + S::V_OFF + cw * 64 * 128, 16, 1024,
                                   kSw128);
    const uint64_t dqb = gmma_desc(base + S::Q_OFF, 16, 1024, kSw128);
    const uint64_t dob = gmma_desc(base + S::DO_OFF, 16, 1024, kSw128);
    const uint64_t dqt = gmma_desc(base + S::Q_OFF, BQ * 128, 1024, kSw128);
    const uint64_t dot = gmma_desc(base + S::DO_OFF, BQ * 128, 1024, kSw128);
    constexpr int NS = BQ / 2;          // S^T registers per thread
    constexpr int NO = NW * 32;         // dK (and dV) registers per thread
    float s[NS], dp[NS], dk[NO], dv[NO];
    uint32_t pf[BQ / 16][4], sf[BQ / 16][4];
#pragma unroll
    for (int i = 0; i < NO; ++i) dk[i] = dv[i] = 0.f;

    if (cw == 1) named_arrive(1, 256);   // warpgroup 0 goes first
    int stage = 0;
    uint32_t phase = 0;
    mbar_wait(kvfull, 0);
    for (;;) {
      if (leader) prefetch();
      mbar_wait(full0 + 8 * stage, phase);
      if (meta_q0[stage] < 0) break;
      const uint32_t so = stage * S::QS_BYTES;
      named_sync(1 + cw, 256);
      wgmma_fence();
      issue_ss<NW, BQ>(s, dka, BK * 128, desc_add(dqb, so), BQ * 128);
      issue_ss<NW, BQ>(dp, dva, BK * 128, desc_add(dob, so), BQ * 128);
      wgmma_commit();
      named_arrive(2 - cw, 256);
      wgmma_wait<0>();
      fence_regs<NS>(s);
      fence_regs<NS>(dp);
      // P^T and dS^T: the query (column) broadcasts come from the stage
      const bool full = meta_full[stage] != 0;
      const int* qp = qpos_s + stage * BQ;
      const float* lq = lse_s + stage * BQ;
      const float* dsq = dsum_s + stage * BQ;
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int col = 8 * (i / 4) + 2 * quad + (i & 1);
        const bool vis = full || ((i & 2) ? kp1 : kp0) <= qp[col];
        const float p = vis ? ex2(fmaf(s[i], sl2, -lq[col])) : 0.f;
        s[i] = p;
        dp[i] = p * (dp[i] - dsq[col]);
      }
      pack_p<BQ / 16>(s, pf);
      pack_p<BQ / 16>(dp, sf);
      named_sync(1 + cw, 256);
      wgmma_fence();
      issue_rs<NW, BQ / 16>(dv, pf, desc_add(dot, so), BQ * 128);
      issue_rs<NW, BQ / 16>(dk, sf, desc_add(dqt, so), BQ * 128);
      wgmma_commit();
      named_arrive(2 - cw, 256);
      wgmma_wait<0>();
      fence_regs<NO>(dk);
      fence_regs<NO>(dv);
      release(empty0 + 8 * stage, lane);
      if (leader) commit();   // warpgroup 0 has released this stage too
      if (++stage == ST) { stage = 0; phase ^= 1; }
    }
    const int n = a.Sk - k0;
    bf16* kb = a.dk + b * a.dk_sb + hk * a.dk_sh + (long long)k0 * a.dk_ss;
    bf16* vb = a.dv + b * a.dv_sb + hk * a.dv_sh + (long long)k0 * a.dv_ss;
    store_rows<NO>(kb, a.dk_ss, row0, n, quad, dk, a.scale);
    store_rows<NO>(vb, a.dv_ss, row0, n, quad, dv, 1.f);
  }
}

// ---- host side --------------------------------------------------------------

// One block per item. A kernel's shared-memory limit is raised when a
// launch needs more than the last; a launch the card refuses returns its
// error.
template <typename Kernel>
cudaError_t launch_bwd_kernel(Kernel kernel, long long smem, long long items,
                              const BwdMaps& m, const BwdArgs& a,
                              cudaStream_t stream, int& smem_set) {
  if (items == 0) return cudaSuccess;
  if (items > INT_MAX || smem > kSmemMax) return cudaErrorInvalidValue;
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    smem_set = (int)smem;
  }
  kernel<<<(int)items, kBwdThreads, (int)smem, stream>>>(m, a);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_bwd(const BwdArgs& a, bool dkv, cudaStream_t stream) {
  // the per-block tiles have BM (K4) or BK (K5) rows, the streamed ones 64
  const int q_rows = dkv ? 64 : DqShape<DP>::BM;
  const int kv_rows = dkv ? DkvShape<DP>::BK : 64;
  BwdMaps m;
  if (!encode_view(&m.q, a.q, a.B, a.Sq, a.Hq, a.D, a.q_sb, a.q_ss, a.q_sh,
                   64, q_rows) ||
      !encode_view(&m.dout, a.dout, a.B, a.Sq, a.Hq, a.D, a.do_sb, a.do_ss,
                   a.do_sh, 64, q_rows) ||
      !encode_view(&m.k, a.k, a.B, a.Sk, a.Hkv, a.D, a.k_sb, a.k_ss, a.k_sh,
                   64, kv_rows) ||
      !encode_view(&m.v, a.v, a.B, a.Sk, a.Hkv, a.D, a.v_sb, a.v_ss, a.v_sh,
                   64, kv_rows))
    return cudaErrorInvalidValue;
  if (!dkv) {
    using S = DqShape<DP>;
    static int smem_set = 0;
    const long long items = (long long)((a.Sq + S::BM - 1) / S::BM) * a.Hq *
                            a.B;
    return launch_bwd_kernel(flash_bwd_dq_kernel<DP>,
                             bwd_smem<S>((a.Sk + S::BN - 1) / S::BN), items,
                             m, a, stream, smem_set);
  }
  using S = DkvShape<DP>;
  static int smem_set = 0;
  const long long pairs = (long long)((a.Sk + S::BK - 1) / S::BK) * a.Hkv *
                          a.B;
  // the head split is the plan's for this grid, with its scratch
  if (pairs > INT_MAX ||
      a.splits != (S::WIDE ? plan_head_split((int)pairs, a.group,
                                             sm_count()) : 1) ||
      (a.splits > 1 && (a.part == nullptr || a.counts == nullptr)))
    return cudaErrorInvalidValue;
  const long long items = pairs * a.splits;
  return launch_bwd_kernel(flash_bwd_dkv_kernel<DP>,
                           bwd_smem<S>((a.Sq + S::BQ - 1) / S::BQ), items,
                           m, a, stream, smem_set);
}

}  // namespace
}  // namespace svt

static int flash_backward(bool dkv, const void* q, const void* k,
                          const void* v, const void* dout, const void* lse,
                          const void* dsum, void* dq, void* dk, void* dv,
                          const void* q_pos, const void* k_pos,
                          const long long* st, void* part, void* counts,
                          int B, int Sq, int Sk, int Hq, int Hkv, int D,
                          int splits, float scale, void* stream) {
  using svt::bf16;
  if (Hkv <= 0 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  svt::BwdArgs a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.dout = static_cast<const bf16*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.dsum = static_cast<const float*>(dsum);
  a.dq = static_cast<bf16*>(dq);
  a.dk = static_cast<bf16*>(dk);
  a.dv = static_cast<bf16*>(dv);
  a.q_pos = static_cast<const int*>(q_pos);
  a.k_pos = static_cast<const int*>(k_pos);
  a.part = static_cast<float*>(part);
  a.counts = static_cast<int*>(counts);
  long long* f[] = {&a.q_sb, &a.q_ss, &a.q_sh, &a.k_sb, &a.k_ss, &a.k_sh,
                    &a.v_sb, &a.v_ss, &a.v_sh, &a.do_sb, &a.do_ss, &a.do_sh,
                    &a.dq_sb, &a.dq_ss, &a.dq_sh, &a.dk_sb, &a.dk_ss,
                    &a.dk_sh, &a.dv_sb, &a.dv_ss, &a.dv_sh};
  for (int i = 0; i < 21; ++i) *f[i] = st[i];
  a.B = B; a.Sq = Sq; a.Sk = Sk; a.Hq = Hq; a.Hkv = Hkv; a.D = D;
  a.group = Hq / Hkv;
  a.splits = splits;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return svt::launch_bwd<64>(a, dkv, s);
    case 128: return svt::launch_bwd<128>(a, dkv, s);
    case 256: return svt::launch_bwd<256>(a, dkv, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K4. strides: 21 (batch, seq, head) triples in the order q, k, v, dO, dQ,
// dK, dV (the dK/dV triples are unused here).
extern "C" int svt_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* dsum, void* dq,
    const void* q_pos, const void* k_pos, const long long* strides,
    int B, int Sq, int Sk, int Hq, int Hkv, int D, float scale,
    void* stream) {
  return flash_backward(false, q, k, v, dout, lse, dsum, dq, nullptr,
                        nullptr, q_pos, k_pos, strides, nullptr, nullptr, B,
                        Sq, Sk, Hq, Hkv, D, 1, scale, stream);
}

// K5's head split at head dim 256 (plan_head_split on this card; 1 at the
// other head dims, or -1 for a shape K5 does not take): with splits > 1
// the caller passes `part`, splits * 2 * 64 * D f32 per (key tile of 64,
// batch x KV head) pair, and `counts`, one int per pair, zeroed.
extern "C" int svt_flash_bwd_dkv_splits(int B, int Sk, int Hq, int Hkv,
                                        int D) {
  if (B <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0) return -1;
  if (D != 256) return 1;
  const long long pairs = (long long)((Sk + 63) / 64) * Hkv * B;
  return pairs > INT_MAX ? -1 : svt::plan_head_split((int)pairs, Hq / Hkv,
                                                      svt::sm_count());
}

// K5. strides as for K4 (the dQ triple is unused here); part, counts and
// splits as svt_flash_bwd_dkv_splits gives them (null, null, 1 without a
// split).
extern "C" int svt_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* dsum, void* dk, void* dv,
    const void* q_pos, const void* k_pos, const long long* strides,
    void* part, void* counts, int B, int Sq, int Sk, int Hq, int Hkv, int D,
    int splits, float scale, void* stream) {
  return flash_backward(true, q, k, v, dout, lse, dsum, nullptr, dk, dv,
                        q_pos, k_pos, strides, part, counts, B, Sq, Sk, Hq,
                        Hkv, D, splits, scale, stream);
}
