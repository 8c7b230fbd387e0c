"""The launch plans of the port's attention kernels
(`streamvln_tpu_torch/csrc/attention_plan.cuh`): the order of the work
items of the forward and of the backward's dK/dV kernel (K5), K5's split
of a KV head's query heads at head dim 256, the forward's grid size, K1's
query rows per item (the key split), the forward's tile geometry and
shared-memory layout at every padded head dim, and the key tiles a block
of the forward visits under positions (the skip and full-tile rules, the
mask builder's batches, words and bits, and the walk over the masks). The
header is plain C++; the host compiler builds it here behind a small C
shim, so these tests run the very functions the kernels' launcher and
blocks call.
"""
import ctypes
import os
import shutil
import subprocess

import pytest

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "streamvln_tpu_torch", "csrc")
SHIM = r"""
#include "attention_plan.cuh"
extern "C" {
void tile(int item, int n_tiles, int hb, int causal, int* out) {
  const svt::TileCoord c = svt::plan_tile(item, n_tiles, hb, causal != 0);
  out[0] = c.tile;
  out[1] = c.hb;
}
void key_tile(int item, int hb, int* out) {
  const svt::TileCoord c = svt::plan_key_tile(item, hb);
  out[0] = c.tile;
  out[1] = c.hb;
}
int grid(int items, int sms, int per_sm, int causal) {
  return svt::plan_grid(items, sms, per_sm, causal != 0);
}
int head_split(int items, int group, int sms) {
  return svt::plan_head_split(items, group, sms);
}
void key_item(int item, int hb, int group, int splits, int* out) {
  const svt::KeyItem k = svt::plan_key_item(item, hb, group, splits);
  out[0] = k.tile;
  out[1] = k.hb;
  out[2] = k.split;
  out[3] = k.head0;
  out[4] = k.heads;
}
int split(int S, int hb, int slots) {
  return svt::plan_split(S, hb, slots);
}
int mask_batch(int r, int warp, int nw, int u) {
  return svt::mask_batch(r, warp, nw, u);
}
int mask_word(int t0) { return svt::mask_word(t0); }
uint32_t mask_place(uint32_t bits, int t0) {
  return svt::mask_place(bits, t0);
}
// One block's masks as attention_fwd.cuh::visit_masks builds them (nw
// warps, batches of u tiles, each tile's smallest and largest key position
// where the kernel reduces them over a warp), then the producer's walk
// over them: the visited tiles in order into `list`, their full flags into
// `full`; returns their count. `mask` has 2 mask_words(tiles) words.
int visits(const int* kpos, int sk, int bn, int qmin, int qmax, int nw,
           int u, uint32_t* mask, int* list, int* full) {
  const int n = (sk + bn - 1) / bn, words = svt::mask_words(n);
  for (int w = 0; w < 2 * words; ++w) mask[w] = 0;
  for (int w = 0; w < nw; ++w)
    for (int r = 0, t0 = 0; (t0 = svt::mask_batch(r, w, nw, u)) < n; ++r) {
      uint32_t vb = 0, fb = 0;
      for (int i = 0; i < u; ++i) {
        int lo = INT_MAX, hi = INT_MIN;   // keys past Sk do not exist
        for (long long k = (long long)(t0 + i) * bn;
             k < sk && k < (long long)(t0 + i + 1) * bn; ++k) {
          lo = kpos[k] < lo ? kpos[k] : lo;
          hi = kpos[k] > hi ? kpos[k] : hi;
        }
        svt::tile_bits(t0 + i, i, n, bn, sk, lo, hi, qmin, qmax, &vb, &fb);
      }
      mask[svt::mask_word(t0)] |= svt::mask_place(vb, t0);
      mask[words + svt::mask_word(t0)] |= svt::mask_place(fb, t0);
    }
  int c = 0;
  for (int t = svt::next_visited(mask, n, 0); t < n;
       t = svt::next_visited(mask, n, t + 1)) {
    list[c] = t;
    full[c++] = svt::mask_bit(mask + words, t);
  }
  return c;
}
}
template <int DP, bool KT128 = false>
static void fill_shape(int* out) {
  using S = svt::FwdShape<DP, KT128>;
  const int v[] = {S::SMEM, S::BM, S::BN, S::NW, S::T32, S::T16, S::ST,
                   S::NO, S::Q_BYTES, S::KV_BYTES, S::QB, S::Q_OFF,
                   S::K_OFF, S::V_OFF, S::M_OFF, S::M_BYTES, S::POS_OFF,
                   S::WIDE, S::OFF32, S::OFF16, S::THREADS,
                   S::BAR_OFF, S::MASK_OFF,
                   S::smem(4096, true), S::smem(32768, true),
                   S::smem(4096, false), (int)S::MAX_KEYS};
  for (int i = 0; i < (int)(sizeof(v) / sizeof(v[0])); ++i) out[i] = v[i];
}
template <int DP>
static void fill_bwd(int* out, int dkv) {
  if (dkv) {
    using S = svt::DkvShape<DP>;
    const int v[] = {S::WIDE, S::BK, S::BQ, S::NW, S::ST, S::KV_BYTES,
                     S::QS_BYTES, S::K_OFF, S::V_OFF, S::Q_OFF, S::DO_OFF,
                     S::XP_OFF, S::ROW_OFF, S::META_OFF, S::BAR_OFF,
                     S::TILE_OFF, svt::bwd_smem<S>(4096 / 64),
                     svt::bwd_smem<S>(32768 / 64)};
    for (int i = 0; i < (int)(sizeof(v) / sizeof(v[0])); ++i) out[i] = v[i];
  } else {
    using S = svt::DqShape<DP>;
    const int v[] = {S::WIDE, S::BM, S::BN, S::NW, S::ST, S::KV_BYTES,
                     S::Q_BYTES, S::K_OFF, S::V_OFF, S::Q_OFF, S::DO_OFF,
                     S::XP_OFF, S::POS_OFF, S::META_OFF, S::BAR_OFF,
                     S::TILE_OFF, svt::bwd_smem<S>(4096 / 64),
                     svt::bwd_smem<S>(32768 / 64), S::XD_OFF};
    for (int i = 0; i < (int)(sizeof(v) / sizeof(v[0])); ++i) out[i] = v[i];
  }
}
extern "C" int bwd_shape(int dp, int dkv, int* out) {
  switch (dp) {
    case 64: fill_bwd<64>(out, dkv); return 0;
    case 128: fill_bwd<128>(out, dkv); return 0;
    case 256: fill_bwd<256>(out, dkv); return 0;
  }
  return 1;
}
extern "C" int keys128(int sq, int sk, int hb, int pos) {
  return svt::fwd_keys128(sq, sk, hb, pos != 0);
}
extern "C" long long max_keys(int keys128) {
  return keys128 ? svt::FwdShape<128, true>::MAX_KEYS
                 : svt::FwdShape<128>::MAX_KEYS;
}
extern "C" int fwd_shape(int dp, int* out) {
  switch (dp) {
    case 129: fill_shape<128, true>(out); return 0;   // K3's 128-key tiles
    case 64: fill_shape<64>(out); return 0;
    case 80: fill_shape<80>(out); return 0;
    case 96: fill_shape<96>(out); return 0;
    case 112: fill_shape<112>(out); return 0;
    case 128: fill_shape<128>(out); return 0;
    case 256: fill_shape<256>(out); return 0;
  }
  return 1;
}
"""
SHAPE_KEYS = ("SMEM", "BM", "BN", "NW", "T32", "T16", "ST", "NO", "Q_BYTES",
              "KV_BYTES", "QB", "Q_OFF", "K_OFF", "V_OFF", "M_OFF",
              "M_BYTES", "POS_OFF", "WIDE", "OFF32", "OFF16",
              "THREADS", "BAR_OFF", "MASK_OFF", "SMEM_4096",
              "SMEM_32768", "SMEM_NOPOS", "MAX_KEYS")
# the block's dynamic shared memory on the H100 (227 KB)
SMEM_MAX = 232448
# K1's head dims and the instance each runs (csrc/vit_attention.cu)
K1_PADDED = {64: 64, 72: 80, 88: 96, 104: 112}
H100_SMS = 132


@pytest.fixture(scope="module")
def plan(tmp_path_factory):
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler to build the plan header")
    d = tmp_path_factory.mktemp("plan")
    src, lib = d / "shim.cpp", d / "libplan.so"
    src.write_text(SHIM)
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I", CSRC,
                    "-o", str(lib), str(src)], check=True)
    return ctypes.CDLL(str(lib))


def _tile(plan, item, n_tiles, hb, causal):
    out = (ctypes.c_int * 2)()
    plan.tile(item, n_tiles, hb, int(causal), out)
    return out[0], out[1]


# 128-row query tiles: the tower at batch 1, 9 and 32 (S=729, 16 heads),
# prefill buckets 768 and 2560 (28 heads), training (S=4096, B=2), and
# small edge cases
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n_tiles,hb", [
    (6, 16), (6, 9 * 16), (6, 32 * 16), (6, 28), (20, 28), (32, 2 * 28),
    (12, 28), (1, 5), (7, 1)])
def test_items_cover_every_tile_once(plan, n_tiles, hb, causal):
    seen = {_tile(plan, i, n_tiles, hb, causal) for i in range(n_tiles * hb)}
    assert seen == {(t, h) for t in range(n_tiles) for h in range(hb)}


def test_causal_items_start_with_the_heaviest_tiles(plan):
    n_tiles, hb = 12, 28
    tiles = [_tile(plan, i, n_tiles, hb, True)[0]
             for i in range(n_tiles * hb)]
    assert tiles[:hb] == [n_tiles - 1] * hb
    assert all(a >= b for a, b in zip(tiles, tiles[1:]))


def test_bidirectional_items_keep_a_head_together(plan):
    n_tiles, hb = 6, 144
    got = [_tile(plan, i, n_tiles, hb, False) for i in range(n_tiles * hb)]
    for h in range(hb):
        run = got[h * n_tiles:(h + 1) * n_tiles]
        assert run == [(t, h) for t in range(n_tiles)]


@pytest.mark.parametrize("items,per_sm,causal,want", [
    (864, 1, False, 132),    # K1 batch 9, 128-row tiles: persistent
    (96, 1, False, 96),      # K1 batch 1: fewer items than SMs
    (600, 2, False, 264),
    (1792, 1, True, 1792),   # training: one item per block
    (168, 1, True, 168),
])
def test_grid(plan, items, per_sm, causal, want):
    assert plan.grid(items, H100_SMS, per_sm, int(causal)) == want


def _key_tile(plan, item, hb):
    out = (ctypes.c_int * 2)()
    plan.key_tile(item, hb, out)
    return out[0], out[1]


# K5's 128-key tiles: training (S=4096, B=2 x 4 KV heads), the 4096-slot
# bucket at batch 1, and small edge cases
@pytest.mark.parametrize("n_tiles,hb", [
    (32, 8), (32, 4), (2, 14), (1, 5), (5, 3)])
def test_key_items_cover_every_tile_once(plan, n_tiles, hb):
    got = [_key_tile(plan, i, hb) for i in range(n_tiles * hb)]
    assert sorted(got) == [(t, h) for t in range(n_tiles)
                           for h in range(hb)]


def test_key_items_start_with_the_heaviest_tiles(plan):
    """Under causal positions key tile t is seen by the queries from t's
    first key on, so tile 0 carries the most work: every head and batch
    of tile 0 first, then tile 1, ..."""
    n_tiles, hb = 32, 8
    got = [_key_tile(plan, i, hb) for i in range(n_tiles * hb)]
    assert [c[0] for c in got[:hb]] == [0] * hb
    assert [c[1] for c in got[:hb]] == list(range(hb))
    assert all(a[0] <= b[0] for a, b in zip(got, got[1:]))


def _key_item(plan, item, hb, group, splits):
    out = (ctypes.c_int * 5)()
    plan.key_item(item, hb, group, splits, out)
    return tuple(out)


def _k5_makespan(plan, S, n_valid, BK, BQ, G, hb, sms=H100_SMS, splits=1):
    """K5's grid at the training layout (valid tokens at 0..n-1, padded
    queries at 0, padded keys invalid): each item's causal work in
    (query tile, head) steps, handed to the SMs in plan_key_item's order
    (plan_key_tile's with one split), each to the SM that frees first (one
    block per SM). Returns the makespan over the ideal (total work /
    SMs)."""
    import heapq
    n_kt = -(-S // BK)
    qmax = [max(q if q < n_valid else 0
                for q in range(t * BQ, min(S, t * BQ + BQ)))
            for t in range(-(-S // BQ))]
    work = [sum(m >= (t * BK if t * BK < n_valid else 1 << 30)
                for m in qmax) for t in range(n_kt)]
    free = [0] * sms
    for i in range(n_kt * hb * splits):
        tile, _, _, _, heads = _key_item(plan, i, hb, G, splits)
        heapq.heappush(free, heapq.heappop(free) + heads * work[tile])
    return max(free) / (G * sum(work) * hb / sms)


def test_key_tile_order_bounds_the_makespan(plan):
    """The training shape (B=2, S=4096, 3,900 valid tokens, 4 KV heads of
    G=7): 256 items of 128 keys on 132 SMs end within 1.10x of the ideal,
    the tail being the heaviest item itself (key tile 0 takes 64 query
    tiles x 7 heads); 64-key tiles would end at 1.03x."""
    r128 = _k5_makespan(plan, 4096, 3900, 128, 64, 7, 8)
    r64 = _k5_makespan(plan, 4096, 3900, 64, 64, 7, 8)
    assert 1.09 < r128 < 1.10 and 1.02 < r64 < 1.03, (r128, r64)


# K5 at head dim 256: 64-key tiles, one block per (key tile, batch x KV
# head) pair at a wave or more, else the group's q heads split
@pytest.mark.parametrize("items,group,want", [
    (128, 8, 4),     # Gemma's training shape: 64 key tiles x B=2 x 1
    (80, 8, 4),
    (8, 8, 8),       # no divisor gives two waves: all of the group
    (12, 2, 2),
    (100, 7, 7),     # a prime group splits whole or not at all
    (132, 8, 1),
    (144, 2, 1),
    (256, 7, 1),     # streamvln_7b's grid (128-key tiles at D = 128)
])
def test_head_split(plan, items, group, want):
    assert plan.head_split(items, group, H100_SMS) == want


def test_head_split_balances_gemmas_grid(plan):
    """Gemma's training shape (B=2, S=4096, 3,900 valid, one KV head of
    G=8 at D = 256): 128 pairs of 64 keys on 132 SMs end at 2.2x the ideal,
    the heaviest key tile (all 61 query tiles x 8 heads) alone in the
    tail; the plan's 4 splits (512 items) end within 1.15x."""
    splits = plan.head_split(64 * 2, 8, H100_SMS)
    assert splits == 4
    one = _k5_makespan(plan, 4096, 3900, 64, 64, 8, 2)
    split = _k5_makespan(plan, 4096, 3900, 64, 64, 8, 2, splits=splits)
    assert one > 2.0 and split < 1.15, (one, split)


def test_head_split_leaves_7bs_grid_alone(plan):
    """streamvln_7b (G=7, 128-key tiles, 4 KV heads x B=2): 256 pairs
    take no split, and the grid is the one plan_key_tile gives."""
    assert plan.head_split(32 * 8, 7, H100_SMS) == 1
    got = [_key_item(plan, i, 8, 7, 1) for i in range(32 * 8)]
    assert [(k[0], k[1]) for k in got] == \
        [_key_tile(plan, i, 8) for i in range(32 * 8)]
    assert all(k[2:] == (0, 0, 7) for k in got)


@pytest.mark.parametrize("n_tiles,hb,group,splits", [
    (64, 2, 8, 4), (40, 2, 8, 4), (4, 2, 8, 8), (3, 4, 2, 2), (5, 3, 6, 3),
    (32, 8, 7, 1)])
def test_split_items_cover_every_pair_and_head_once(plan, n_tiles, hb,
                                                    group, splits):
    """Every (key tile, batch x KV head, q head of the group) is taken by
    exactly one block, the splits of a pair take disjoint head ranges in
    split order, and the heaviest key tiles still come first."""
    seen = []
    tiles = []
    for i in range(n_tiles * hb * splits):
        tile, h, split, head0, heads = _key_item(plan, i, hb, group, splits)
        assert heads == group // splits and head0 == split * heads
        seen += [(tile, h, j) for j in range(head0, head0 + heads)]
        tiles.append(tile)
    assert sorted(seen) == [(t, h, j) for t in range(n_tiles)
                            for h in range(hb) for j in range(group)]
    assert all(a <= b for a, b in zip(tiles, tiles[1:]))


def _shape(plan, dp):
    out = (ctypes.c_int * len(SHAPE_KEYS))()
    assert plan.fwd_shape(dp, out) == 0
    return dict(zip(SHAPE_KEYS, out))


@pytest.mark.parametrize("dp", [64, 80, 96, 112, 128, 256])
def test_forward_layout_fits_the_sm(plan, dp):
    """Every instance's chunks make up its head dim (64-column chunks, then
    a 32- and a 16-column chunk), every chunk region of a Q, K or V tile
    starts on a 1024-byte boundary (the swizzle patterns), the regions
    follow one another without overlap and the block's shared memory (plus
    the alignment slack) fits 227 KB; K1's instances (DP < 128) hold the
    split's merge rows (warpgroup 1's O by thread and its row state)."""
    s = _shape(plan, dp)
    assert s["NW"] * 64 + s["T32"] + s["T16"] == dp
    assert s["SMEM"] <= SMEM_MAX
    for rows in (s["BM"], s["BN"], 64):
        for off in (0, s["OFF32"] * rows, s["OFF16"] * rows):
            assert off % 1024 == 0, (rows, off)
    assert s["Q_BYTES"] == s["BM"] * dp * 2
    assert s["KV_BYTES"] == s["BN"] * dp * 2
    assert s["K_OFF"] == s["Q_OFF"] + s["QB"] * s["Q_BYTES"]
    assert s["V_OFF"] == s["K_OFF"] + s["ST"] * s["KV_BYTES"]
    assert s["M_OFF"] == s["V_OFF"] + s["ST"] * s["KV_BYTES"]
    assert s["POS_OFF"] == s["M_OFF"] + s["M_BYTES"]
    for off in ("K_OFF", "V_OFF", "M_OFF"):
        assert s[off] % 1024 == 0
    assert s["THREADS"] == 384
    assert s["SMEM"] == s["BAR_OFF"] + (4 + 2 * s["ST"]) * 8 + 1024
    assert s["MASK_OFF"] == s["BAR_OFF"] + (4 + 2 * s["ST"]) * 8
    # under positions the two masks' words (one bit per key tile each:
    # visited, full) follow
    assert s["SMEM_NOPOS"] == s["SMEM"]
    for sk in (4096, 32768):
        words = -(-(-(-sk // s["BN"])) // 32)
        assert s[f"SMEM_{sk}"] == s["SMEM"] + 8 * words <= SMEM_MAX
    if dp < 128:
        assert s["M_BYTES"] == s["NO"] * 128 * 4 + 128 * 16
    else:
        assert s["M_BYTES"] == 0


def test_forward_at_head_dim_256_is_wide(plan):
    """DP = 256: both consumer warpgroups on one 64-row tile, each holding
    half of O (64 f32 registers a thread, as a 64 x 128 tile), and three
    stages of 64-key K and V tiles beside the 32 KB Q tile, which a fourth
    stage would not fit."""
    s = _shape(plan, 256)
    assert s["WIDE"] == 1 and s["BM"] == 64 and s["BN"] == 64
    assert s["ST"] == 3 and s["NO"] == 64 and s["QB"] == 1
    assert s["Q_BYTES"] == 32768 and s["KV_BYTES"] == 32768
    assert s["SMEM"] + 2 * s["KV_BYTES"] > SMEM_MAX


@pytest.mark.parametrize("D", [64, 72, 88, 104])
def test_k1_pads_the_zoo_head_dims_to_a_16_column_step(plan, D):
    """K1's instances pad D to the next multiple of 16 (the depth step of
    S = Q K^T): 88 -> 96 and 104 -> 112 (8% and 7% of the products),
    where 128 took 31% and 19%."""
    dp = K1_PADDED[D]
    s = _shape(plan, dp)
    assert dp - D < 16 and s["NW"] * 64 + s["T32"] + s["T16"] == dp
    assert not s["WIDE"] and s["BM"] == 128


def _k1_cover(plan, B, S, H, D, slots=H100_SMS):
    """Walks K1's items as the kernel does (plan_split, plan_tile, each
    warpgroup's rows and key tiles) and counts how often each (batch x
    head, query row, key tile) is taken. Returns the counts and whether
    the split was taken."""
    import numpy as np
    s = _shape(plan, K1_PADDED[D])
    hb, bn = B * H, s["BN"]
    split = bool(plan.split(S, hb, slots))
    bm = 64 if split else 128
    n_qt, n_kt = -(-S // bm), -(-S // bn)
    counts = np.zeros((hb, S, n_kt), np.int32)
    for item in range(n_qt * hb):
        tile, h = _tile(plan, item, n_qt, hb, False)
        q0 = tile * bm
        for cw in (0, 1):
            r0 = q0 if split else q0 + 64 * cw
            keys = [kt for kt in range(n_kt) if not split or kt % 2 == cw]
            counts[h, r0:min(r0 + 64, S), keys] += 1
    return counts, split


# the zoo's rows (chip_smoke.VIT_ZOO_SHAPES), SigLIP's batches on the main
# paths, and ragged S at the zoo's head dims at batch 1 and 2
@pytest.mark.parametrize("B,S,H,D", [
    (1, 257, 16, 88), (1, 257, 16, 104), (1, 577, 16, 104),
    (1, 577, 16, 64), (4, 577, 16, 64), (9, 577, 16, 64), (1, 197, 12, 64),
    (3, 729, 16, 72), (4, 729, 16, 72), (5, 729, 16, 72),
    (1, 729, 16, 72), (8, 729, 16, 72), (16, 729, 16, 72),
    (28, 729, 16, 72), (32, 729, 16, 72),
    (1, 65, 4, 88), (2, 129, 4, 104), (1, 191, 4, 64), (2, 197, 4, 88),
    (1, 257, 4, 104), (2, 577, 4, 64), (1, 1, 2, 88)])
def test_k1_items_cover_every_row_and_key_once(plan, B, S, H, D):
    counts, _ = _k1_cover(plan, B, S, H, D)
    assert bool((counts == 1).all())


# K1 at batch 1 (and 2): the shapes, the 128-row items and the plan's
# grid. The split takes 64-row items wherever they fill more SMs and add
# no round over them; where 64-row items would exceed the SMs (S = 577 x
# 16 heads: 160) the 128-row items stay, one round on 80 SMs.
@pytest.mark.parametrize("B,S,H,split,grid", [
    (1, 257, 16, True, 80), (1, 197, 12, True, 48), (1, 577, 16, False, 80),
    (1, 729, 16, False, 96), (2, 257, 4, True, 40), (1, 65, 4, True, 8),
    (4, 577, 16, False, 132), (3, 729, 16, False, 132)])
def test_k1_grid_fills_the_card_where_no_round_is_added(plan, B, S, H,
                                                        split, grid):
    hb = B * H
    got = bool(plan.split(S, hb, H100_SMS))
    items = -(-S // (64 if got else 128)) * hb
    assert got == split
    assert plan.grid(items, H100_SMS, 1, 0) == grid
    n64, n128 = -(-S // 64) * hb, -(-S // 128) * hb
    # the grid is the most blocks a plan can have in one round
    assert grid == (n64 if n64 <= H100_SMS else min(n128, H100_SMS))


def test_forward_at_head_dim_128_fits_its_masks(plan):
    """DP = 128 (Qwen2 and most families): 128-row blocks of a producer
    and two consumer warpgroups; K3 (the training forward) takes 128-key
    tiles in three stages of 64 KB beside the 32 KB Q tile (a fourth would
    not fit), K2 64-key tiles in four of 32 KB; both leave room for the
    visited- and full-tile masks far past the 32k step's 32,768 keys."""
    for dp, bn, st in ((128, 64, 4), (129, 128, 3)):
        s = _shape(plan, dp)
        assert s["WIDE"] == 0 and s["THREADS"] == 384
        assert s["BM"] == 128 and s["BN"] == bn and s["ST"] == st
        assert s["QB"] == 1 and s["Q_BYTES"] == 32768
        assert s["KV_BYTES"] == bn * 256 and s["NO"] == 64
        assert s["SMEM"] <= SMEM_MAX
        words = -(-(32768 // bn) // 32)
        assert s["SMEM_32768"] == s["SMEM"] + 8 * words <= SMEM_MAX
        assert s["MAX_KEYS"] >= 200_000
        assert SMEM_MAX - 8 < s["SMEM"] + 8 * (s["MAX_KEYS"] // bn // 32) \
            <= SMEM_MAX
    k3 = _shape(plan, 129)
    assert k3["SMEM"] + 2 * k3["KV_BYTES"] > SMEM_MAX


# the kernels' mask builder: the consumers' eight warps, 8-tile batches
MASK_WARPS, MASK_BATCH = 8, 8


def _visits(plan, kpos, bn, qmin, qmax):
    """The visited tiles and full flags of one block, from its masks as the
    kernels build them (the shim's `visits`)."""
    import numpy as np
    sk = len(kpos)
    n = -(-sk // bn)
    kp = np.ascontiguousarray(kpos, np.int32)
    mask = (ctypes.c_uint32 * max(1, 2 * -(-n // 32)))()
    lst, full = (ctypes.c_int * max(1, n))(), (ctypes.c_int * max(1, n))()
    c = plan.visits(kp.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), sk, bn,
                    qmin, qmax, MASK_WARPS, MASK_BATCH, mask, lst, full)
    return list(lst[:c]), list(full[:c])


def _enumerate(kpos, bn, qmin, qmax):
    """The same by plain enumeration: tile t (bn keys from t * bn, none past
    Sk) is visited iff its smallest position is <= qmax, full iff it
    holds bn keys and its largest is <= qmin."""
    sk, lst, full = len(kpos), [], []
    for t in range(-(-sk // bn)):
        keys = kpos[t * bn:(t + 1) * bn]
        if min(keys) <= qmax:
            lst.append(t)
            full.append(int(len(keys) == bn and max(keys) <= qmin))
    return lst, full


INVALID = 1 << 30
WAVE_OFFSETS = (0, 765, 772, 0, 1536, 3000, 300, 0)


def _rows(case):
    """(q_pos rows, k_pos rows) of a main-path case, as numpy int32."""
    import numpy as np
    ar = np.arange
    if case in ("prefill300", "prefill1900", "prefill2560"):
        off, sq = {"prefill300": (300, 768), "prefill1900": (1900, 768),
                   "prefill2560": (300, 2560)}[case]
        q = (off + ar(sq))[None].astype(np.int32)
        q[0, 7] = -1                           # a query that sees no key
        return q, ar(4096, dtype=np.int32)[None]
    if case == "wave":
        # the B=8 wave: rows at their offsets, an idle row (the last) and
        # keys from slot 1000 on INVALID_POS (the one before it)
        q = (np.asarray(WAVE_OFFSETS)[:, None] + ar(768)[None]) \
            .astype(np.int32)
        q[0, 7] = -1
        q[-1] = -1
        k = np.tile(ar(4096, dtype=np.int32), (8, 1))
        k[-2, 1000:] = INVALID
        return q, k
    if case in ("anyres3032", "anyres3046"):
        n = int(case[6:])
        return ar(n, dtype=np.int32)[None], ar(n, dtype=np.int32)[None]
    if case in ("train", "long"):
        S, nv = (4096, 3900) if case == "train" else (32768, 32000)
        p = ar(S, dtype=np.int32)
        q = np.where(p < nv, p, 0)[None].repeat(2 if case == "train" else 1,
                                                0)
        q[-1, 7] = -1
        k = np.where(p < nv, p, INVALID)[None].repeat(q.shape[0], 0)
        return q.astype(np.int32), k.astype(np.int32)
    if case == "ragged":
        # Sq = 700 from position 300 over Sk = 1500 slots, a padded tail
        q = (300 + ar(700))[None].astype(np.int32)
        k = ar(1500, dtype=np.int32)[None]
        k[:, 1040:] = INVALID
        return q, k
    # unsorted: positions shuffled on both sides, ragged lengths
    rng = np.random.default_rng(7)
    k = rng.permutation(1000).astype(np.int32)[None]
    k[0, rng.choice(1000, 50, replace=False)] = INVALID
    q = rng.integers(-5, 1200, (1, 333)).astype(np.int32)
    return q, k


@pytest.mark.parametrize("case", [
    "prefill300", "prefill1900", "prefill2560", "wave", "anyres3032",
    "anyres3046", "train", "long", "ragged", "unsorted"])
@pytest.mark.parametrize("bm,bn", [(128, 128), (128, 64), (64, 64)])
def test_visited_tiles_match_enumeration(plan, case, bm, bn):
    """The key tiles a block visits and their full flags, from the masks
    built with the kernels' batch, word and bit arithmetic (eight warps of
    8-tile batches, tile_bits) and walked with next_visited, against a
    plain enumeration of
    kmin <= qmax over the key tiles, for every query tile of the main
    paths' rows: the 7B prefill at offsets 300 and 1900 of the 4096-slot
    cache, the B=8 wave (an idle row, an INVALID_POS tail), anyres's 3032
    and 3046, training at 3,900 of 4096 and 32,000 of 32768 (every 16th
    query tile and the last), Sq and Sk not multiples of 64, and unsorted
    positions; 128-row blocks of 128-key tiles (head dim 64, and K3 at
    128) and of 64-key tiles (K2 at 128), and 64-row blocks of 64-key
    tiles (head dim 256)."""
    q, k = _rows(case)
    sq = q.shape[1]
    tiles = range(-(-sq // bm))
    if case == "long":
        tiles = sorted(set(tiles[::16]) | {tiles[-1]})
    for b in range(q.shape[0]):
        kpos = k[min(b, k.shape[0] - 1)]
        kl = kpos.tolist()
        for t in tiles:
            rows = q[b, t * bm:(t + 1) * bm]
            qmin, qmax = int(rows.min()), int(rows.max())
            got = _visits(plan, kpos, bn, qmin, qmax)
            assert got == _enumerate(kl, bn, qmin, qmax), (case, b, t)
    # the walk is the visible prefix: nothing after the last visited tile
    if case == "prefill300":
        got, _ = _visits(plan, k[0], bn, int(q[0].min()), int(q[0].max()))
        assert got == list(range(-(-1068 // bn)))


@pytest.mark.parametrize("n_tiles", [1, 33, 48, 64, 100, 256, 512, 4096])
def test_mask_batches_set_every_tile_once(plan, n_tiles):
    """The mask builder's share of the key tiles (mask_batch, mask_word,
    mask_place), as the kernels' eight warps of 8-tile batches take them:
    every tile is taken by one warp in one batch, and its bit lands in word
    t / 32 at bit t % 32 (64 key tiles: the 4096-slot cache; 48: anyres;
    256 and 512: the 32k step at 128- and 64-key tiles; 4096: 262,144
    keys)."""
    plan.mask_place.restype = ctypes.c_uint32
    taken = [0] * n_tiles
    for w in range(MASK_WARPS):
        r = 0
        while (t0 := plan.mask_batch(r, w, MASK_WARPS, MASK_BATCH)) < n_tiles:
            assert t0 % MASK_BATCH == 0
            word = plan.mask_word(t0)
            for i in range(MASK_BATCH):
                t = t0 + i
                if t < n_tiles:
                    taken[t] += 1
                    assert word == t // 32
                    assert plan.mask_place(1 << i, t0) == 1 << (t % 32)
            r += 1
    assert taken == [1] * n_tiles


# The backward's geometry (DqShape, DkvShape): K4's fields, then K5's
# (BM/BK the rows or keys a block holds, BN/BQ the streamed tile, Q_BYTES
# or QS_BYTES its tile of one operand, KV_BYTES K4's streamed / K5's held
# tile)
DQ_KEYS = ("WIDE", "BM", "BN", "NW", "ST", "KV_BYTES", "Q_BYTES", "K_OFF",
           "V_OFF", "Q_OFF", "DO_OFF", "XP_OFF", "POS_OFF", "META_OFF",
           "BAR_OFF", "TILE_OFF", "SMEM_4096", "SMEM_32768", "XD_OFF")
DKV_KEYS = ("WIDE", "BK", "BQ", "NW", "ST", "KV_BYTES", "QS_BYTES", "K_OFF",
            "V_OFF", "Q_OFF", "DO_OFF", "XP_OFF", "ROW_OFF", "META_OFF",
            "BAR_OFF", "TILE_OFF", "SMEM_4096", "SMEM_32768")


def _bwd_shape(plan, dp, dkv):
    keys = DKV_KEYS if dkv else DQ_KEYS
    out = (ctypes.c_int * len(keys))()
    assert plan.bwd_shape(dp, int(dkv), out) == 0
    return dict(zip(keys, out))


@pytest.mark.parametrize("dkv", [False, True], ids=["K4", "K5"])
@pytest.mark.parametrize("dp", [64, 128, 256])
def test_backward_layout_fits_the_sm(plan, dp, dkv):
    """Every backward instance's tiles start on 1024-byte boundaries (the
    128-byte swizzle's pattern), its regions follow one another without
    overlap, and its shared memory with the tile lists (three ints per
    64-entry tile of the streamed dimension) and the alignment slack fits
    227 KB at S = 4096 (the train step) and S = 32768 (the 32k step)."""
    s = _bwd_shape(plan, dp, dkv)
    held, streamed = (s["BK"], s["BQ"]) if dkv else (s["BM"], s["BN"])
    tile = s["QS_BYTES"] if dkv else s["KV_BYTES"]   # a streamed tile
    own = s["KV_BYTES"] if dkv else s["Q_BYTES"]     # a held tile
    assert s["NW"] * 64 == dp
    assert own == held * dp * 2 and tile == streamed * dp * 2
    if dkv:
        order = [(s["K_OFF"], own), (s["V_OFF"], own),
                 (s["Q_OFF"], s["ST"] * tile), (s["DO_OFF"], s["ST"] * tile)]
        after = s["XP_OFF"]
    else:
        order = [(s["Q_OFF"], own), (s["DO_OFF"], own),
                 (s["K_OFF"], s["ST"] * tile), (s["V_OFF"], s["ST"] * tile)]
        after = s["XP_OFF"]
    assert order[0][0] == 0
    for (a, n), (b, _) in zip(order, order[1:] + [(after, 0)]):
        assert a % 1024 == 0 and a + n == b
    assert s["META_OFF"] < s["BAR_OFF"] < s["TILE_OFF"]
    for sk in (4096, 32768):
        assert s[f"SMEM_{sk}"] == s["TILE_OFF"] + 12 * (sk // 64) + 1024
        assert s[f"SMEM_{sk}"] <= SMEM_MAX, (dp, dkv, sk)


@pytest.mark.parametrize("dp,held,st", [(64, 128, 4), (128, 128, 4),
                                         (256, 64, 2)])
def test_backward_stage_counts(plan, dp, held, st):
    """D = 64 and 128: K4 holds 128 query rows and K5 128 keys (one 64-row
    half per consumer warpgroup), each streaming 64-entry tiles through 4
    stages. D = 256 (WIDE): both warpgroups on one 64-row tile, 2 stages of
    64 entries, and the exchange tiles (K4: P in f32 and dS in bf16, K5:
    P^T in f32) between the stages and the rows' words."""
    dq, dkv = _bwd_shape(plan, dp, False), _bwd_shape(plan, dp, True)
    assert (dq["BM"], dq["BN"], dq["ST"]) == (held, 64, st)
    assert (dkv["BK"], dkv["BQ"], dkv["ST"]) == (held, 64, st)
    wide = dp == 256
    assert dq["WIDE"] == dkv["WIDE"] == int(wide)
    assert dq["XD_OFF"] - dq["XP_OFF"] == (64 * 64 * 4 if wide else 0)
    assert dq["POS_OFF"] - dq["XD_OFF"] == (64 * 64 * 2 if wide else 0)
    assert dkv["ROW_OFF"] - dkv["XP_OFF"] == (64 * 64 * 4 if wide else 0)


# The forward's key-tile width at head dim 128 (fwd_keys128), one for K2
# and K3, at the shapes the card runs, as timed on the H100 (PERF.md, PR
# 21): (B, Sq, Sk, Hq, width). The 7B's prefill buckets 768 and 2560 in
# the 4096-slot cache, the B=8 wave of 768-row prefills, Llama-2's (32
# heads) and Qwen2-14B's (40) 768-row prefills, anyres's uncached
# prefills, phase 12's DPO / reward / PPO forwards (B=2, S = 1024), the
# train step and the 32k step.
KEY_TILE_SHAPES = ((1, 768, 4096, 28, 64), (1, 2560, 4096, 28, 128),
                   (8, 768, 4096, 28, 128), (1, 768, 4096, 32, 64),
                   (1, 768, 4096, 40, 64), (1, 3032, 3032, 28, 128),
                   (1, 3046, 3046, 28, 128), (2, 1024, 1024, 28, 128),
                   (2, 4096, 4096, 28, 128), (1, 32768, 32768, 28, 128))


@pytest.mark.parametrize("B,sq,sk,hq,width", KEY_TILE_SHAPES)
def test_key_tile_width_at_the_main_shapes(plan, B, sq, sk, hq, width):
    assert (128 if plan.keys128(sq, sk, B * hq, 1) else 64) == width


@pytest.mark.parametrize("sk", [4096, 208_896, 208_897, 1 << 20,
                                17_006_592])
def test_key_tile_width_never_exceeds_its_masks(plan, sk):
    """The rule sends no call under positions past the key count whose
    visited- and full-tile masks fit beside the chosen instance's ring
    (FwdShape::MAX_KEYS), at any query count: past the 128-key
    instance's, the 64-key instance takes the call."""
    plan.max_keys.restype = ctypes.c_longlong
    for sq in (1, 768, 4096, 32768):
        wide = plan.keys128(sq, sk, 28, 1)
        assert sk <= plan.max_keys(wide), (sq, sk, wide)
    assert plan.max_keys(1) == 208_896
    assert not plan.keys128(32768, 208_897, 28, 1)
