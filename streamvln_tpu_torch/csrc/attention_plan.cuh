// Launch plans of the attention kernels: the order of the work items of
// the forward (attention_fwd.cuh; query tile, batch x head) and of the
// backward (flash_attention_bwd.cu; K4 takes the forward's, K5 key tile,
// batch x KV head and, at head dim 256, a share of the query heads), and
// the size of the forward's grid. Plain C++ with no CUDA types, so the
// host compiler can build it too (tests/test_torch_attention_plan.py).
#pragma once

#ifdef __CUDACC__
#define SVT_HD __host__ __device__ __forceinline__
#else
#define SVT_HD inline
#endif

namespace svt {

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
