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
// K4: one block per (128-row query tile, batch x q head), the tiles that
// see the most keys first (plan_tile). The ring holds the Q and dO tiles
// (loaded once) and streams 64-key K and V tiles with their key
// positions; a stage with k0 = -1 ends the walk. Each consumer computes
// S = Q K^T and dP = dO V^T (wgmma, both operands in shared memory,
// K-major), then P = exp2(S * scale * log2 e - LSE * log2 e) (one FMA)
// and dS = P (dP - Dsum) in registers, rounded to bf16, and dQ += dS K
// (wgmma with A from registers; the K stage is read MN-major with the
// transpose flag, as the forward reads V). The products of one tile are
// issued before the elementwise work of the last one is done with
// (software pipeline, first tile peeled so that no wgmma sits behind a
// branch). dQ is scaled once at the end. A block's LSE and Dsum rows are
// read once by the threads that own them (a TMA box of them would need Sq
// to be a multiple of 4).
//
// K5: one block per (128-key tile, batch x KV head), the key tiles that
// the most queries see first (plan_key_tile). The K and V tile is loaded
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
// Numerics: bf16 operands, f32 accumulation; P and dS rounded to bf16
// before their products (the TPU kernels upcast to f32).
//
// C interface (ctypes): q/dO/dQ [B, Sq, Hq, D], k/v/dK/dV [B, Sk, Hkv, D]
// or KV-head-major, all described by (batch, seq, head) strides in
// elements (multiples of 8) with a contiguous head dim, D 64 or 128;
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
  int B, Sq, Sk, Hq, Hkv, D, group;
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

// K4's shared memory: the Q and dO tiles (128 rows), ST stages of K and V
// (64 keys) and of their key positions, the stages' (k0, full) words, the
// barriers, then for each 64-key tile its smallest and largest position
// and the list of the tiles the block visits.
template <int DP>
struct DqShape {
  static constexpr int BM = 64 * kConsumers, BN = 64, NW = DP / 64, ST = 4;
  static constexpr int Q_BYTES = BM * DP * 2, KV_BYTES = BN * DP * 2;
  static constexpr int Q_OFF = 0, DO_OFF = Q_BYTES;
  static constexpr int K_OFF = 2 * Q_BYTES;
  static constexpr int V_OFF = K_OFF + ST * KV_BYTES;
  static constexpr int POS_OFF = V_OFF + ST * KV_BYTES;
  static constexpr int META_OFF = POS_OFF + ST * BN * 4;
  static constexpr int BAR_OFF = META_OFF + 2 * ST * 4;
  static constexpr int TILE_OFF = BAR_OFF + (1 + 2 * ST) * 8;
};

// K5's shared memory: the K and V tiles (128 keys), ST stages of Q and dO
// (64 rows) and of their rows' position, LSE (log2 units) and Dsum, the
// stages' (q0, full) words, the barriers, then for each 64-row query tile
// its smallest and largest position and the list of the tiles the block
// visits.
template <int DP>
struct DkvShape {
  static constexpr int BK = 64 * kConsumers, BQ = 64, NW = DP / 64, ST = 4;
  static constexpr int KV_BYTES = BK * DP * 2, QS_BYTES = BQ * DP * 2;
  static constexpr int K_OFF = 0, V_OFF = KV_BYTES;
  static constexpr int Q_OFF = 2 * KV_BYTES;
  static constexpr int DO_OFF = Q_OFF + ST * QS_BYTES;
  static constexpr int ROW_OFF = DO_OFF + ST * QS_BYTES;  // pos, lse, dsum
  static constexpr int META_OFF = ROW_OFF + 3 * ST * BQ * 4;
  static constexpr int BAR_OFF = META_OFF + 2 * ST * 4;
  static constexpr int TILE_OFF = BAR_OFF + (1 + 2 * ST) * 8;
};

// Dynamic shared memory of a kernel whose streamed dimension has n_tiles
// 64-entry tiles (three ints each), with room to align the base.
template <typename S>
int smem_bytes(int n_tiles) {
  return S::TILE_OFF + 12 * n_tiles + 1024;
}

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
// tile), then dS = P (dP - Dsum) in place in s. Registers as the forward's
// softmax_tile: rows r0 and r0 + 8 (lse, dsum, qp *0 and *1), key columns
// 8j + 2 quad + {0, 1}.
template <int NS>
__device__ __forceinline__ void ds_tile(float* s, const float* dp, bool full,
                                        const int* kpos, int quad, int qp0,
                                        int qp1, float l0, float l1,
                                        float ds0, float ds1, float sl2) {
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const bool hi = i & 2;
    const int col = 8 * (i / 4) + 2 * quad + (i & 1);
    const bool vis = full || kpos[col] <= (hi ? qp1 : qp0);
    const float p = vis ? ex2(fmaf(s[i], sl2, -(hi ? l1 : l0))) : 0.f;
    s[i] = p * (dp[i] - (hi ? ds1 : ds0));
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

  const int row0 = 64 * cw + 16 * (t >> 5) + (lane >> 2);   // in the tile
  const int r0 = q0 + row0, r1 = r0 + 8;
  const bool ok0 = r0 < a.Sq, ok1 = r1 < a.Sq;
  const int qp0 = ok0 ? qpb[r0] : INT_MIN, qp1 = ok1 ? qpb[r1] : INT_MIN;
  const long long rb = ((long long)b * a.Hq + h) * a.Sq;
  const float l0 = ok0 ? a.lse[rb + r0] * kLog2e : 0.f;
  const float l1 = ok1 ? a.lse[rb + r1] * kLog2e : 0.f;
  const float ds0 = ok0 ? a.dsum[rb + r0] : 0.f;
  const float ds1 = ok1 ? a.dsum[rb + r1] : 0.f;
  const float sl2 = a.scale * kLog2e;
  // this warpgroup's Q and dO rows; the K and V stage 0, K-major for the
  // scores, and K read MN-major (transposed) for dS K
  const uint64_t dqa = gmma_desc(base + S::Q_OFF + cw * 64 * 128, 16, 1024,
                                 kSw128);
  const uint64_t doa = gmma_desc(base + S::DO_OFF + cw * 64 * 128, 16, 1024,
                                 kSw128);
  const uint64_t dkb = gmma_desc(base + S::K_OFF, 16, 1024, kSw128);
  const uint64_t dvb = gmma_desc(base + S::V_OFF, 16, 1024, kSw128);
  const uint64_t dkt = gmma_desc(base + S::K_OFF, BN * 128, 1024, kSw128);
  constexpr int NS = BN / 2;          // score registers per thread
  constexpr int NO = DP / 2;          // dQ registers per thread
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

  const TileCoord tc = plan_key_tile(blockIdx.x, a.Hkv * a.B);
  const int k0 = tc.tile * BK;
  const int hk = tc.hb % a.Hkv, b = tc.hb / a.Hkv;
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

  // The leader's ring: for each q head of the group, the query tiles the
  // block visits (the mirror of the skip rule: a tile whose largest
  // position is below the block's smallest key position is left out),
  // stage n in slot n % ST after the release of stage n - ST, and the end
  // marker (q0 = -1) as stage `total`.
  int count = 0, total = 0, issued = 0, kmax = 0;
  int np0 = 0, np1 = 0;
  float nl0 = 0.f, nl1 = 0.f, nd0 = 0.f, nd1 = 0.f;
  auto prefetch = [&]() {   // the next stage's query positions, LSE, Dsum
    if (issued < total) {
      const int j = issued / count, q0 = list[issued % count] * BQ;
      const long long rb = ((long long)b * a.Hq + hk * a.group + j) * a.Sq;
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
      const int j = issued / count, qt = list[issued % count];
      const int q0 = qt * BQ, h = hk * a.group + j;
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
    total = count * a.group;
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

  const int row0 = 64 * cw + 16 * (t >> 5) + (lane >> 2);   // in the tile
  const int kp0 = k0 + row0 < a.Sk ? kpb[k0 + row0] : kInvalidPos;
  const int kp1 = k0 + row0 + 8 < a.Sk ? kpb[k0 + row0 + 8] : kInvalidPos;
  const float sl2 = a.scale * kLog2e;
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
  constexpr int NO = DP / 2;          // dK (and dV) registers per thread
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

// ---- host side --------------------------------------------------------------

// One block per item. A kernel's shared-memory limit is raised when a
// launch needs more than the last; a launch the card refuses returns its
// error.
template <typename Kernel>
cudaError_t launch_bwd_kernel(Kernel kernel, int smem, long long items,
                              const BwdMaps& m, const BwdArgs& a,
                              cudaStream_t stream, int& smem_set) {
  if (items == 0) return cudaSuccess;
  if (items > INT_MAX) return cudaErrorInvalidValue;
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  kernel<<<(int)items, kBwdThreads, smem, stream>>>(m, a);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_bwd(const BwdArgs& a, bool dkv, cudaStream_t stream) {
  // the per-block tiles have 128-row boxes, the streamed ones 64
  const int q_rows = dkv ? 64 : 128, kv_rows = dkv ? 128 : 64;
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
                             smem_bytes<S>((a.Sk + S::BN - 1) / S::BN), items,
                             m, a, stream, smem_set);
  }
  using S = DkvShape<DP>;
  static int smem_set = 0;
  const long long items = (long long)((a.Sk + S::BK - 1) / S::BK) * a.Hkv *
                          a.B;
  return launch_bwd_kernel(flash_bwd_dkv_kernel<DP>,
                           smem_bytes<S>((a.Sq + S::BQ - 1) / S::BQ), items,
                           m, a, stream, smem_set);
}

}  // namespace
}  // namespace svt

static int flash_backward(bool dkv, const void* q, const void* k,
                          const void* v, const void* dout, const void* lse,
                          const void* dsum, void* dq, void* dk, void* dv,
                          const void* q_pos, const void* k_pos,
                          const long long* st, int B, int Sq, int Sk, int Hq,
                          int Hkv, int D, float scale, void* stream) {
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
  long long* f[] = {&a.q_sb, &a.q_ss, &a.q_sh, &a.k_sb, &a.k_ss, &a.k_sh,
                    &a.v_sb, &a.v_ss, &a.v_sh, &a.do_sb, &a.do_ss, &a.do_sh,
                    &a.dq_sb, &a.dq_ss, &a.dq_sh, &a.dk_sb, &a.dk_ss,
                    &a.dk_sh, &a.dv_sb, &a.dv_ss, &a.dv_sh};
  for (int i = 0; i < 21; ++i) *f[i] = st[i];
  a.B = B; a.Sq = Sq; a.Sk = Sk; a.Hq = Hq; a.Hkv = Hkv; a.D = D;
  a.group = Hq / Hkv;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return svt::launch_bwd<64>(a, dkv, s);
    case 128: return svt::launch_bwd<128>(a, dkv, s);
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
                        nullptr, q_pos, k_pos, strides, B, Sq, Sk, Hq, Hkv,
                        D, scale, stream);
}

// K5. strides as for K4 (the dQ triple is unused here).
extern "C" int svt_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* dsum, void* dk, void* dv,
    const void* q_pos, const void* k_pos, const long long* strides,
    int B, int Sq, int Sk, int Hq, int Hkv, int D, float scale,
    void* stream) {
  return flash_backward(true, q, k, v, dout, lse, dsum, nullptr, dk, dv,
                        q_pos, k_pos, strides, B, Sq, Sk, Hq, Hkv, D, scale,
                        stream);
}
