"""The launch plans of the port's attention kernels
(`streamvln_tpu_torch/csrc/attention_plan.cuh`): the order of the work
items of the forward and of the backward's dK/dV kernel (K5), K5's split
of a KV head's query heads at head dim 256, the forward's grid size, K1's
query rows per item (the key split) and the forward's tile geometry and
shared-memory layout at every padded head dim. The header is plain
C++; the host compiler builds it here behind a small C shim, so these tests
run the very functions the kernels' launcher and blocks call.
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
}
template <int DP>
static void fill_shape(int* out) {
  using S = svt::FwdShape<DP>;
  const int v[] = {S::SMEM, S::BM, S::BN, S::NW, S::T32, S::T16, S::ST,
                   S::NO, S::Q_BYTES, S::KV_BYTES, S::QB, S::Q_OFF,
                   S::K_OFF, S::V_OFF, S::M_OFF, S::M_BYTES, S::POS_OFF,
                   S::WIDE, S::OFF32, S::OFF16, S::THREADS,
                   S::BAR_OFF};
  for (int i = 0; i < (int)(sizeof(v) / sizeof(v[0])); ++i) out[i] = v[i];
}
extern "C" int fwd_shape(int dp, int* out) {
  switch (dp) {
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
              "THREADS", "BAR_OFF")
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
