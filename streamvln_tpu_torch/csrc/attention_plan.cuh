// Launch plans of the attention kernels: the order of the work items of
// the forward (attention_fwd.cuh; query tile, batch x head) and of the
// backward (flash_attention_bwd.cu; K4 takes the forward's, K5 key tile,
// batch x KV head and, at head dim 256, a share of the query heads), the
// forward's query rows per item (K1's key split) and grid size, and the
// forward's tile geometry and shared-memory layout (FwdShape). Plain C++
// with no CUDA types, so the host compiler can build it too
// (tests/test_torch_attention_plan.py).
#pragma once

#ifdef __CUDACC__
#define SVT_HD __host__ __device__ __forceinline__
#else
#define SVT_HD inline
#endif

namespace svt {

constexpr int kConsumers = 2;          // consumer warpgroups per block
constexpr int kSmemMax = 232448;       // dynamic shared memory of a block

// The forward's tile geometry at padded head dim DP (attention_fwd.cuh).
// A tile's head dim is kept as 64-column chunks (128-byte swizzle), then
// a 32-column chunk (64-byte swizzle) and a 16-column chunk (32-byte
// swizzle) where DP needs them: 80 = 64 + 16, 96 = 64 + 32, 112 = 64 + 32
// + 16. A chunk of a tile of R rows holds R rows of its width; the
// chunks follow one another, each on a 1024-byte boundary.
template <int DP>
struct FwdShape {
  // WIDE (DP = 256): a 64-row O accumulator would be 128 f32 registers a
  // thread, so both consumer warpgroups take the same 64 query rows, each
  // holding half of O's columns
  static constexpr bool WIDE = DP == 256;
  static constexpr int NC = kConsumers;
  static constexpr int BM = WIDE ? 64 : 64 * NC;   // query rows per block
  // keys per tile: 128 where the stages fit (fewer pipeline round trips
  // per key, wider S products), else 64
  static constexpr int BN = DP <= 80 ? 128 : 64;
  static constexpr int NW = DP / 64;               // 64-column chunks
  static constexpr int T32 = DP % 64 >= 32 ? 32 : 0;
  static constexpr int T16 = DP % 32;
  static_assert((DP >= 64 && DP <= 128 && DP % 16 == 0) || DP == 256,
                "head dim 64-128 in steps of 16, or 256");
  // bytes of a chunk's rows: columns 64 * c .. are at chunk(c) * rows
  static constexpr int OFF32 = NW * 128;            // x rows: the 32-col
  static constexpr int OFF16 = NW * 128 + T32 * 2;  // x rows: the 16-col
  // stages: a consumer holds two at a time; three at DP = 256
  static constexpr int ST = WIDE ? 3 : 4;
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
  static constexpr int SMEM = BAR_OFF + (4 + 2 * ST) * 8 + 1024;  // + align
  static_assert(SMEM <= kSmemMax, "the block's shared memory fits the SM");
};

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
