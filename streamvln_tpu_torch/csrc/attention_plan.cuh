// Launch plans of the attention kernels: the order of the work items of
// the forward (attention_fwd.cuh; query tile, batch x head) and of the
// backward (flash_attention_bwd.cu; K4 takes the forward's, K5 key tile,
// batch x KV head and, at head dim 256, a share of the query heads), the
// forward's query rows per item (K1's key split) and grid size, the
// forward's tile geometry and shared-memory layout (FwdShape) and its
// key-tile width at head dim 128 (fwd_keys128), the backward's (DqShape,
// DkvShape) and, under positions, the key tiles a block of the forward
// visits (the skip rule, the "full" tile rule and the walk over the
// visited-tile mask). Plain C++ with no CUDA types, so the host compiler
// can build it too
// (tests/test_torch_attention_plan.py).
#pragma once

#include <limits.h>
#include <stdint.h>

#ifdef __CUDACC__
#define SVT_HD __host__ __device__ __forceinline__
#else
#define SVT_HD inline
#endif

namespace svt {

constexpr int kConsumers = 2;          // consumer warpgroups per block
constexpr int kSmemMax = 232448;       // dynamic shared memory of a block

// ---- the key tiles a block visits under positions ----
// Key j is visible to query i iff k_pos[j] <= q_pos[i]. A block whose real
// query rows hold positions in [qmin, qmax] visits key tile t (the BN keys
// from t * BN; none at or past Sk) iff the smallest position of its keys
// is <= qmax: the exact skip rule, for positions in any order. A visited
// tile is "full" (no per-element mask) when it holds BN keys and its
// largest position is <= qmin, so that every row sees every key. The
// kernels keep two masks of one bit per tile (bit t % 32 of word t / 32):
// the visited tiles, then the full ones, built by all of a block's
// consumer warps before the walk (attention_fwd.cuh::visit_masks), which
// then loads no key position of a tile it skips or of a full one.

SVT_HD int mask_words(int n_tiles) { return (n_tiles + 31) / 32; }

SVT_HD bool mask_bit(const uint32_t* mask, int t) {
  return (mask[t >> 5] >> (t & 31)) & 1u;
}

SVT_HD bool tile_visited(int kmin, int qmax) { return kmin <= qmax; }

SVT_HD bool tile_full(int t, int bn, int sk, int kmax, int qmin) {
  return (long long)(t + 1) * bn <= sk && kmax <= qmin;
}

// The mask builder's share of the tiles: warp w of the nw building warps
// takes batches of u consecutive tiles (u divides 32), its r-th batch
// starting at tile mask_batch(r, w, nw, u), a multiple of u, so that the
// batch's bits share one mask word.
SVT_HD int mask_batch(int r, int warp, int nw, int u) {
  return (r * nw + warp) * u;
}

// Tile t = t0 + i of a batch from t0 (of n_tiles, with the smallest and
// largest position of its keys) sets bit i of the batch's visited bits vb
// and, where full, of its full bits fb.
SVT_HD void tile_bits(int t, int i, int n_tiles, int bn, int sk, int kmin,
                      int kmax, int qmin, int qmax, uint32_t* vb,
                      uint32_t* fb) {
  if (t < n_tiles && tile_visited(kmin, qmax)) {
    *vb |= 1u << i;
    if (tile_full(t, bn, sk, kmax, qmin)) *fb |= 1u << i;
  }
}

// A batch's bits from tile t0 go into mask word mask_word(t0), shifted
// as mask_place(bits, t0): bit i lands on tile t0 + i.
SVT_HD int mask_word(int t0) { return t0 >> 5; }

SVT_HD uint32_t mask_place(uint32_t bits, int t0) {
  return bits << (t0 & 31);
}

// The first visited tile at or after tile t in a mask of n_tiles bits, or
// n_tiles where none is left (the producer's walk).
SVT_HD int next_visited(const uint32_t* mask, int n_tiles, int t) {
  if (t >= n_tiles) return n_tiles;
  int w = t >> 5;
  uint32_t bits = mask[w] & (0xffffffffu << (t & 31));
  while (bits == 0) {
    if (++w >= mask_words(n_tiles)) return n_tiles;
    bits = mask[w];
  }
#ifdef __CUDA_ARCH__
  return (w << 5) + __ffs(bits) - 1;
#else
  return (w << 5) + __builtin_ctz(bits);
#endif
}

// The forward's tile geometry at padded head dim DP (attention_fwd.cuh);
// KT128: 128-key tiles at DP = 128 (fwd_keys128 below says where).
// A tile's head dim is kept as 64-column chunks (128-byte swizzle), then
// a 32-column chunk (64-byte swizzle) and a 16-column chunk (32-byte
// swizzle) where DP needs them: 80 = 64 + 16, 96 = 64 + 32, 112 = 64 + 32
// + 16. A chunk of a tile of R rows holds R rows of its width; the
// chunks follow one another, each on a 1024-byte boundary.
template <int DP, bool KT128 = false>
struct FwdShape {
  // WIDE (DP = 256): a 64-row O accumulator would be 128 f32 registers a
  // thread, so both consumer warpgroups take the same 64 query rows, each
  // holding half of O's columns
  static constexpr bool WIDE = DP == 256;
  static constexpr int NC = kConsumers;
  static constexpr int BM = WIDE ? 64 : 64 * NC;   // query rows per block
  // keys per tile: 128 where the stages fit (fewer pipeline round trips
  // per key, wider S products), else 64. At DP = 128 three stages of 64
  // KB fit beside the Q tile, and the consumers hold S, O and P of a
  // 128-key tile (64 + 64 f32 and 32 words a thread) within setmaxnreg's
  // 232 registers; both widths are built there, and fwd_keys128 picks
  // one by the shape
  static constexpr int BN = DP <= 80 || KT128 ? 128 : 64;
  static_assert(!KT128 || DP == 128, "128-key tiles at DP = 128 only");
  static constexpr int NW = DP / 64;               // 64-column chunks
  static constexpr int T32 = DP % 64 >= 32 ? 32 : 0;
  static constexpr int T16 = DP % 32;
  static_assert((DP >= 64 && DP <= 128 && DP % 16 == 0) || DP == 256,
                "head dim 64-128 in steps of 16, or 256");
  // bytes of a chunk's rows: columns 64 * c .. are at chunk(c) * rows
  static constexpr int OFF32 = NW * 128;            // x rows: the 32-col
  static constexpr int OFF16 = NW * 128 + T32 * 2;  // x rows: the 16-col
  // stages: a consumer holds two at a time; three where a stage is 64 KB
  // (DP = 256, and 128 keys at DP = 128)
  static constexpr int ST = WIDE || BN * DP >= 128 * 128 ? 3 : 4;
  static constexpr int THREADS = 128 * (NC + 1);
  // O registers a consumer thread holds (a 64 x 64 chunk is 32)
  static constexpr int NO = (WIDE ? NW / 2 : NW) * 32 + T32 / 2 + T16 / 2;
  static constexpr int Q_BYTES = BM * DP * 2;
  static constexpr int KV_BYTES = BN * DP * 2;
  // Q buffers: two where a block walks several items (the next item's Q
  // loads during the current one); the prefill and training kernels
  // (DP >= 128, positions) take one item per block and need one
  static constexpr int QB = DP >= 128 ? 1 : 2;
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + QB * Q_BYTES;
  static constexpr int V_OFF = K_OFF + ST * KV_BYTES;
  // K1's key split (DP < 128): one warpgroup's O (f32, by thread) and
  // row state (m, l), which the other merges
  static constexpr int M_BYTES = DP < 128 ? 64 * DP * 4 + 128 * 16 : 0;
  static constexpr int M_OFF = V_OFF + ST * KV_BYTES;
  static constexpr int POS_OFF = M_OFF + M_BYTES;
  static constexpr int META_OFF = POS_OFF + ST * BN * 4;
  static constexpr int BAR_OFF = META_OFF + ST * 8;     // 8-byte aligned
  // under positions, the visited- and full-tile masks (one bit per key
  // tile each) follow the barriers; their size depends on Sk (smem)
  static constexpr int MASK_OFF = BAR_OFF + (4 + 2 * ST) * 8;
  static constexpr int SMEM = MASK_OFF + 1024;          // + align
  static_assert(SMEM <= kSmemMax, "the block's shared memory fits the SM");
  // a launch's dynamic shared memory: the mask's words under positions
  static SVT_HD int smem(int sk, bool pos) {
    return SMEM + (pos ? 8 * mask_words((sk + BN - 1) / BN) : 0);
  }
  // the most keys whose masks fit beside the ring
  static constexpr long long MAX_KEYS =
      (long long)(kSmemMax - SMEM) / 8 * 32 * BN;
};

// The forward's key-tile width at padded head dim 128: 128-key tiles
// (FwdShape<128, true>) or 64. K2 and K3 take the width this gives for
// their shape, whether or not the LSE is written, so that a forward under
// grad (K3) and one without (K2) round P against the running maxima of the
// same key spans and give the same bits (the reference's two forwards run
// one kernel body). The widths were timed against each other on the H100
// at the main paths' shapes (tools/ablate.py d128_bn64 and d128_bn128;
// PERF.md): 128-key tiles were faster wherever the grid holds
// kKeys128Items (128-row query tile, batch x head) items or more (5-12%
// at a B=8 wave of 768-row prefills, S = 1024 preference pairs, the 2560
// bucket, anyres, the train and 32k steps); at fewer, one item's latency
// rules and 64-key tiles were faster or level (the 7B's served 768-row
// prefill, 168 items: 10% for K2; 32 and 40 heads at 768 rows). A call
// past the 128-key instance's MAX_KEYS takes 64-key tiles, whose masks
// hold 81x the keys.
constexpr int kKeys128Items = 256;

SVT_HD bool fwd_keys128(int sq, int sk, int heads_batch, bool pos) {
  if (pos && sk > FwdShape<128, true>::MAX_KEYS) return false;
  return (long long)((sq + 127) / 128) * heads_batch >= kKeys128Items;
}

// ---- the backward's tile geometry (flash_attention_bwd.cu) ----

// K4's shared memory: the Q and dO tiles (BM rows), ST stages of K and V
// (64 keys), when WIDE the P (f32) and dS (bf16) exchange tiles, the
// stages' key positions and (k0, full) words, the barriers, then for each
// 64-key tile its smallest and largest position and the list of the tiles
// the block visits.
template <int DP>
struct DqShape {
  static constexpr bool WIDE = DP > 128;
  static constexpr int BM = WIDE ? 64 : 64 * kConsumers, BN = 64;
  static constexpr int NW = DP / 64, ST = WIDE ? 2 : 4;
  static constexpr int Q_BYTES = BM * DP * 2, KV_BYTES = BN * DP * 2;
  static constexpr int Q_OFF = 0, DO_OFF = Q_BYTES;
  static constexpr int K_OFF = 2 * Q_BYTES;
  static constexpr int V_OFF = K_OFF + ST * KV_BYTES;
  static constexpr int XP_OFF = V_OFF + ST * KV_BYTES;
  static constexpr int XD_OFF = XP_OFF + (WIDE ? BM * BN * 4 : 0);
  static constexpr int POS_OFF = XD_OFF + (WIDE ? BM * BN * 2 : 0);
  static constexpr int META_OFF = POS_OFF + ST * BN * 4;
  static constexpr int BAR_OFF = META_OFF + 2 * ST * 4;
  static constexpr int TILE_OFF = BAR_OFF + (1 + 2 * ST) * 8;
};

// K5's shared memory: the K and V tiles (BK keys), ST stages of Q and dO
// (64 rows), when WIDE the P^T exchange tile (f32), the stages' row
// position, LSE (log2 units) and Dsum, their (q0, full) words, when WIDE
// the "last split" flag, the barriers, then for each 64-row query tile its
// smallest and largest position and the list of the tiles the block
// visits.
template <int DP>
struct DkvShape {
  static constexpr bool WIDE = DP > 128;
  static constexpr int BK = WIDE ? 64 : 64 * kConsumers, BQ = 64;
  static constexpr int NW = DP / 64, ST = WIDE ? 2 : 4;
  static constexpr int KV_BYTES = BK * DP * 2, QS_BYTES = BQ * DP * 2;
  static constexpr int K_OFF = 0, V_OFF = KV_BYTES;
  static constexpr int Q_OFF = 2 * KV_BYTES;
  static constexpr int DO_OFF = Q_OFF + ST * QS_BYTES;
  static constexpr int XP_OFF = DO_OFF + ST * QS_BYTES;
  static constexpr int ROW_OFF = XP_OFF + (WIDE ? BK * BQ * 4 : 0);
  static constexpr int META_OFF = ROW_OFF + 3 * ST * BQ * 4;
  static constexpr int BAR_OFF = META_OFF + 2 * ST * 4 + (WIDE ? 8 : 0);
  static constexpr int TILE_OFF = BAR_OFF + (1 + 2 * ST) * 8;
};

// Dynamic shared memory of a backward kernel whose streamed dimension
// has n_tiles 64-entry tiles (its smallest and largest position and its
// place in the visit list: three ints each), with room to align the base;
// a launch needing more than kSmemMax is refused.
template <typename S>
SVT_HD long long bwd_smem(long long n_tiles) {
  return S::TILE_OFF + 12 * n_tiles + 1024;
}

// K1 (no positions, DP < 128): the query rows of a work item. 128 rows,
// one 64-row half per consumer warpgroup, or 64 rows that both
// warpgroups share, each taking every other key tile, their rows merged
// by the running max and sum at the end (the split). A split item costs
// more than half of a 128-row one (its key tiles are loaded for half the
// rows), so the split is taken only where it adds no round over the
// grid's block slots (items / slots, rounded up): where the 128-row items
// leave slots idle and the 64-row ones still fit them. (Taking it where
// it adds a round lost 25-30% at S = 577, batch 1, and 15% at batch 3-4.)
SVT_HD bool plan_split(int S, int heads_batch, int slots) {
  const long long n128 = (long long)((S + 127) / 128) * heads_batch;
  const long long n64 = (long long)((S + 63) / 64) * heads_batch;
  return (n64 + slots - 1) / slots <= (n128 + slots - 1) / slots;
}

struct TileCoord {
  int tile;   // query (or key) tile: rows from tile * (rows per block)
  int hb;     // batch * heads + head
};

// Work item `item` of n_tiles * heads_batch (query tile, batch x head)
// pairs. Under positions (causal prefill and training) the last query
// tiles, which see the most keys, come first, all heads and batches of one
// tile before the next, so the short tiles fill the tail. Without
// positions (the vision tower) every tile sees every key, and the tiles of
// one (batch, head) come together, so the blocks running at one time share
// its keys and values in the L2 cache.
SVT_HD TileCoord plan_tile(int item, int n_tiles, int heads_batch,
                           bool causal) {
  TileCoord c;
  if (causal) {
    c.tile = n_tiles - 1 - item / heads_batch;
    c.hb = item % heads_batch;
  } else {
    c.tile = item % n_tiles;
    c.hb = item / n_tiles;
  }
  return c;
}

// Work item `item` of the backward's dK/dV kernel (key tile, batch x KV
// head), one block each. Under positions the first key tiles, which the
// most queries see, come first, all heads and batches of one tile before
// the next, so the short tiles fill the tail.
SVT_HD TileCoord plan_key_tile(int item, int heads_batch) {
  TileCoord c;
  c.tile = item / heads_batch;
  c.hb = item % heads_batch;
  return c;
}

// K5 at head dim 256 (flash_attention_bwd.cu, WIDE): how many blocks share
// the G query heads of one (key tile, batch x KV head). A grid of `items`
// such pairs under one wave leaves SMs idle and ends with the heaviest key
// tile (causal: tile 0 is seen by every query) on its own; there the G
// heads are split over the smallest divisor s of G that gives at least two
// waves (items * s >= 2 * sms), or over G where none does. At a wave or
// more the grid keeps one block per pair. Each block then sums G / s heads
// into an f32 partial and the partials are summed in a fixed order.
SVT_HD int plan_head_split(int items, int group, int sms) {
  if (items >= sms) return 1;
  int s = 1;
  for (int d = 2; d <= group; ++d) {
    if (group % d) continue;
    s = d;
    if ((long long)items * d >= 2LL * sms) break;
  }
  return s;
}

// Work item `item` of K5's grid with `splits` blocks per (key tile, batch
// x KV head) pair: plan_key_tile's order over heads_batch * splits, so the
// splits of a pair run side by side, and the query heads [head0, head0 +
// heads) of the group that the item takes.
struct KeyItem {
  int tile, hb, split, head0, heads;
};

SVT_HD KeyItem plan_key_item(int item, int heads_batch, int group,
                             int splits) {
  const TileCoord c = plan_key_tile(item, heads_batch * splits);
  KeyItem k;
  k.tile = c.tile;
  k.hb = c.hb / splits;
  k.split = c.hb % splits;
  k.heads = group / splits;
  k.head0 = k.split * k.heads;
  return k;
}

// Grid size. Without positions every item is the same work: a persistent
// grid of one block per block slot of the card (blocks an SM holds at once
// x SMs, never more than the items), block i taking items i, i + grid,
// ..., so each block's next item loads while it finishes the current one.
// Under positions the items differ in work (causal), and a fixed
// round-robin leaves SMs idle at the end; there each block takes one item
// and the hardware hands items out as SMs free up.
SVT_HD int plan_grid(int items, int sms, int blocks_per_sm, bool causal) {
  const long long slots = (long long)sms * blocks_per_sm;
  return causal || items < slots ? items : (int)slots;
}

}  // namespace svt
