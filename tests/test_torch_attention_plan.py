"""The launch plans of the port's attention kernels
(`streamvln_tpu_torch/csrc/attention_plan.cuh`): the order of the work
items of the forward and of the backward's dK/dV kernel (K5), K5's split
of a KV head's query heads at head dim 256, and the forward's grid
size. The header is plain
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
}
"""
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
