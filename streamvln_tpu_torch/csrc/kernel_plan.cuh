// Launch plans of K6 and K7 (int4_matmul.cu) and K8 (decode_attention.cu):
// how many blocks a launch takes and which share of the work each block
// owns; K8's shared-memory layout and the order of its merge. Plain C++
// with no CUDA types, so the host compiler can build it too
// (tests/test_torch_kernel_plan.py).
#pragma once

#include <math.h>

#ifndef SVT_HD
#ifdef __CUDACC__
#define SVT_HD __host__ __device__ __forceinline__
#else
#define SVT_HD inline
#endif
#endif

namespace svt {

constexpr int kSms = 132;            // SMs of the H100 SXM

struct Range {
  int begin, end;                    // [begin, end)
};

// ---- K6: out[M, dout] = x[M, din] @ dequant(W) ------------------------

constexpr int kI4Cols = 128;         // output columns per block
constexpr int kI4GroupRows = 32;     // packed rows per scale group (64 rows)
constexpr int kI4Cluster = 8;        // most splits of a tile (portable size)

// Blocks that split the contraction of one 128-column tile (one cluster):
// the fewest that give every SM four blocks at M <= 8 (the dequant is the
// work; more warps hide its latency) or two above (each block also
// streams x's rows), at most kI4Cluster, and at least one scale group
// each. It depends on the shapes alone.
SVT_HD int int4_splits(int M, int din, int dout) {
  const int tiles = dout / kI4Cols;
  const int groups = din / (2 * kI4GroupRows);
  const int per_sm = M <= 8 ? 4 : 2;
  int ks = (per_sm * kSms + tiles - 1) / tiles;
  if (ks > kI4Cluster) ks = kI4Cluster;
  if (ks > groups) ks = groups;
  return ks < 1 ? 1 : ks;
}

// Scale groups of split z: consecutive, every group in exactly one split.
SVT_HD Range int4_groups(int groups, int splits, int z) {
  Range r;
  r.begin = static_cast<int>(static_cast<long long>(groups) * z / splits);
  r.end = static_cast<int>(static_cast<long long>(groups) * (z + 1) / splits);
  return r;
}

// ---- K7: one layer unpacked to [2, half, dout] --------------------------
//
// A unit is `rows` packed rows of one kUnpackCols-column tile (16 columns
// for each lane of a warp) inside one scale group: a whole group (32
// rows) where that gives every warp of a full grid a unit, else 8 rows,
// or 2 where 8-row units would give fewer than kUnpackMinUnits per SM (a
// small layer's few stores then spread over more warps). A lane reads
// its 16 scales once per unit. Units are numbered row-major (the tiles of
// the first rows, then of the next ones), and the grid sweeps them in
// that order: unit u goes to warp u % (blocks warps), counting the warps
// of all blocks first (warp w of block b is b + w blocks), so that the
// card works on a compact window of the output and no block holds more
// than one unit over another. The grid is one block per SM (fewer where
// there are fewer units); its warps are the fewest that take a block's
// units in as few rounds as kUnpackWarps warps would, so that no warp of
// a block holds more than one unit over another and a last round is not
// left to a few warps alone (at Qwen2-14B's down projection, 16.4 units a
// block, 16 warps left a second 32-row unit to a few warps and took 13%
// longer than 9 warps of one or two). Every index fits 32 bits (the
// launcher refuses 2 half dout >= 2^31).

constexpr int kUnpackCols = 512;     // columns of a unit (a warp's)
constexpr int kUnpackWarps = 16;     // most warps of a block
constexpr int kUnpackMinUnits = 4;   // 8-row units an SM needs at least

struct UnpackGrid {
  int blocks, warps, rows;           // warps of each block; rows of a unit
};

SVT_HD int unpack_units(int half, int dout, int rows) {
  return half / rows * (dout / kUnpackCols);
}

SVT_HD UnpackGrid unpack_grid(int half, int dout) {
  UnpackGrid g;
  g.rows = unpack_units(half, dout, 32) >= kSms * kUnpackWarps ? 32
      : unpack_units(half, dout, 8) >= kUnpackMinUnits * kSms ? 8 : 2;
  const int units = unpack_units(half, dout, g.rows);
  g.blocks = units < kSms ? units : kSms;
  const int most = (units + g.blocks - 1) / g.blocks;     // of a block
  const int rounds = (most + kUnpackWarps - 1) / kUnpackWarps;
  g.warps = (most + rounds - 1) / rounds;
  return g;
}

// The units of warp w of block b: begin, begin + step, ... below end.
struct UnpackRun {
  int begin, end, step;
};
SVT_HD UnpackRun unpack_run(int units, UnpackGrid g, int b, int w) {
  UnpackRun r;
  r.begin = b + w * g.blocks;
  r.end = units;
  r.step = g.blocks * g.warps;
  return r;
}

// Unit u: its tile's first column and its first packed row.
struct UnpackUnit {
  int col, row;
};
SVT_HD UnpackUnit unpack_unit(int dout, int rows, int u) {
  const int tiles = dout / kUnpackCols;
  UnpackUnit t;
  t.col = u % tiles * kUnpackCols;
  t.row = u / tiles * rows;
  return t;
}

// ---- K8: decode attention over keys 0..length-1 of the cache ------------
//
// The P blocks of one (batch row, KV head) form one thread-block cluster
// and split its live prefix into 16-aligned shares of at least
// kDecMinShare keys (so a short prefix keeps fewer blocks busy); the busy
// blocks merge their partials in distributed shared memory. The grid
// depends on the shapes alone (the length stays on the device), sized so
// that one wave holds every cluster: from the clusters of each size the
// card keeps resident at once (queried once, at one block per SM: the
// block's shared memory below).

constexpr int kDecTile = 64;         // keys per pipeline stage
constexpr int kDecAlign = 16;        // a share starts on a 16-key boundary
constexpr int kDecMinShare = 32;     // no block takes fewer keys than this
// most blocks of a cluster: a non-portable size, which the H100 schedules
constexpr int kDecCluster = 16;
constexpr int kSmemPerSm = 233472;   // shared memory an SM gives its blocks
constexpr int kSmemPerBlock = 1024;  // of which the system keeps per block

// Receive-area slots of a block: an owner of ceil(G / nb) head rows holds
// nb partials of each (nb busy blocks in its cluster); the most over nb.
SVT_HD constexpr int decode_slots(int G) {
  int most = 0;
  for (int nb = 1; nb <= kDecCluster; ++nb) {
    const int s = (G + nb - 1) / nb * nb;
    if (s > most) most = s;
  }
  return most;
}

// Shared-memory layout of a block, E bytes an element, head dim D, at most
// GM query heads per KV head (offsets from the block's base, rounded up to
// 1024 bytes): the ring of K/V stages of 64 key rows each, q in f32 (f32
// inputs only), the receive area (slot (g / nb) nb + p holds block p's
// partial of head row g; (max, sum) pairs apart) and the barriers (full
// and empty per stage, then the receive barrier). The four warps' partials
// lie over the drained ring. bf16 tiles are loaded with TMA, in boxes of
// kDecBoxRows key rows x 128 bytes (64 depths), 128-byte swizzled so that
// ldmatrix falls on 32 banks: a tile is D / 64 columns of such boxes, 8 KB
// each, four stages at D = 128 (128 KB), three at 256 (192 KB). f32 rows
// are copied with cp.async into rows padded by 16 bytes, two stages. One
// block per SM either way.
constexpr int kDecBoxRows = 16;      // key rows of a TMA box
template <int E, int D, int GM>
struct DecLayout {
  static constexpr int G = GM;
  static constexpr bool TMA = E == 2;              // bf16: TMA boxes
  static constexpr int RB = D * E;                 // bytes of a key row
  static constexpr int ROW = TMA ? RB : RB + 16;   // f32: padded row
  static constexpr int TILE = kDecTile * ROW;      // one K or V tile
  static constexpr int STAGE = 2 * TILE;           // K, then V
  static constexpr int ST = !TMA ? 2 : D == 128 ? 4 : 3;
  static constexpr int SLOTS = decode_slots(G);
  static constexpr int Q_OFF = ST * STAGE;
  static constexpr int R_ACC = Q_OFF + (E == 4 ? G * D * 4 : 0);
  static constexpr int R_ML = R_ACC + SLOTS * D * 4;
  static constexpr int BAR_OFF = R_ML + SLOTS * 8;
  static constexpr int SMEM = BAR_OFF + 16 * ST + 8 + 1024;   // + the base
  static constexpr int W_ACC = 0;                  // [4][G][D]
  static constexpr int W_M = W_ACC + 4 * G * D * 4;   // [4][G]
  static constexpr int W_L = W_M + 4 * G * 4;
  static_assert(W_L + 4 * G * 4 <= Q_OFF, "the partials fit the ring");
  static_assert(!TMA || (D % 64 == 0 && kDecBoxRows % 8 == 0 &&
                         kDecTile % kDecBoxRows == 0),
                "TMA boxes start on 1024-byte boundaries");
  static_assert(SMEM + kSmemPerBlock <= kSmemPerSm, "a block fits the SM");
};

// P, the blocks of the one cluster of each (row, KV head): the largest
// power of two, at most kDecCluster, of which one cluster per (row, KV
// head) is resident in one wave (rows <= resident[P - 1], the clusters of
// P blocks the card keeps resident at once), and no more blocks than the
// capacity has minimum shares; one block where even single blocks take
// more than one wave. Powers of two pack the H100's 16-18-SM GPCs: at
// Qwen2-14B's 8 KV heads clusters of 8 were 7% faster than of 9, at
// Llama-2's 32 clusters of 2 5% faster than of 3 (PERF.md).
SVT_HD int decode_cluster(int smax, int batch, int kv_heads,
                          const int* resident) {
  const int rows = batch * kv_heads;
  const int most = (smax + kDecMinShare - 1) / kDecMinShare;
  for (int p = kDecCluster; p > 1; p /= 2)
    if (p <= most && resident[p - 1] >= rows) return p;
  return 1;
}

// The 16-aligned share of each of `splits` parts of `length` live keys,
// at least kDecMinShare.
SVT_HD int decode_share(int length, int splits) {
  int share = (length + splits - 1) / splits;
  share = (share + kDecAlign - 1) / kDecAlign * kDecAlign;
  return share < kDecMinShare ? kDecMinShare : share;
}

// Keys of block p of `splits` for `length` live keys: consecutive shares
// cut at the length, so that no block reads at or past it. A block past
// the prefix gets an empty range; the busy blocks are the first ones.
SVT_HD Range decode_keys(int length, int splits, int p) {
  const int share = decode_share(length, splits);
  const long long b = static_cast<long long>(share) * p;
  Range r;
  r.begin = b < length ? static_cast<int>(b) : length;
  r.end = b + share < length ? static_cast<int>(b + share) : length;
  return r;
}

// Blocks with keys: blocks 0..busy-1 (none for a row of length 0).
SVT_HD int decode_busy(int length, int splits) {
  if (length <= 0) return 0;
  const int share = decode_share(length, splits);
  return (length + share - 1) / share;
}

// TMA boxes of a block's share of n keys (bf16): tile t (64 keys) is
// loaded in decode_boxes(n, t) boxes of kDecBoxRows key rows; box j holds
// rows j kDecBoxRows.. of the tile in shared memory. A box starts at its
// own first key, or earlier where that would take it past the share's
// end: the last box of the share ends at key n, starting `first` rows
// early (keys of the rows before it, or nothing before key 0), and its
// first `first` rows are masked. So every key of the share is taken
// exactly once and none at or past n is read.
struct DecBox {
  int row;                           // the share's key of its first row
  int first;                         // its rows before its own first key
};
SVT_HD int decode_boxes(int n, int t) {
  const int left = n - t * kDecTile;
  const int boxes = (left + kDecBoxRows - 1) / kDecBoxRows;
  return boxes < kDecTile / kDecBoxRows ? boxes : kDecTile / kDecBoxRows;
}
SVT_HD DecBox decode_box(int n, int t, int j) {
  const int start = t * kDecTile + j * kDecBoxRows;
  const int row = start < n - kDecBoxRows ? start : n - kDecBoxRows;
  DecBox box;
  box.row = row;
  box.first = start - row;
  return box;
}

// The merge, among the nb busy blocks of a cluster: block g % nb owns head
// row g, and block p's partial of it lands in the owner's slot (g / nb) nb
// + p.
SVT_HD int decode_owner(int g, int nb) { return g % nb; }
SVT_HD int decode_slot(int g, int nb, int p) { return g / nb * nb + p; }
// head rows that block p owns of G
SVT_HD int decode_owned(int p, int G, int nb) {
  return p < G ? (G - 1 - p) / nb + 1 : 0;
}

SVT_HD float dec_ex2(float x) {
#ifdef __CUDA_ARCH__
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
#else
  return exp2f(x);
#endif
}

// The merge of n <= N (max, sum, output) partials (log2 units), in order:
// the largest max m of those with keys first, then each partial's weight
// c[i] = 2^(m_i - m) (decode_weight: 0 for one that saw no key, sum 0)
// and l = sum_i l_i c[i] in index order. Both levels (the four warps of a
// block, the busy blocks of a cluster) merge so, in a fixed order, so two
// calls give bit-equal results.
SVT_HD float decode_weight(float mi, float li, float m) {
  return li > 0.f ? dec_ex2(mi - m) : 0.f;
}

template <int N>
SVT_HD void decode_weights(const float* pm, const float* pl, int n,
                           float* c, float& m, float& l) {
  m = -1e30f;
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (i < n && pl[i] > 0.f && pm[i] > m) m = pm[i];
  l = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    c[i] = i < n ? decode_weight(pm[i], pl[i], m) : 0.f;
    if (i < n) l += pl[i] * c[i];
  }
}

// ... and the outputs: o = sum_i o_i c[i] over the partials with keys.
template <int N>
SVT_HD void decode_merge(const float* pm, const float* pl, const float* po,
                         int n, float& m, float& l, float& o) {
  float c[N];
  decode_weights<N>(pm, pl, n, c, m, l);
  o = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (i < n && pl[i] > 0.f) o += po[i] * c[i];
}

}  // namespace svt
