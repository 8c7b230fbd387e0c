"""The launch plans of the port's attention kernels
(`streamvln_tpu_torch/csrc/attention_plan.cuh`): the order of the work
items of the forward and of the backward's dK/dV kernel (K5), and the
forward's grid size. The header is plain
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


def _k5_makespan(plan, S, n_valid, BK, BQ, G, hb, sms=H100_SMS):
    """K5's grid at the training layout (valid tokens at 0..n-1, padded
    queries at 0, padded keys invalid): each item's causal work in
    (query tile, head) steps, handed to the SMs in plan_key_tile's order,
    each to the SM that frees first (one block per SM). Returns the
    makespan over the ideal (total work / SMs)."""
    import heapq
    n_kt = -(-S // BK)
    qmax = [max(q if q < n_valid else 0
                for q in range(t * BQ, min(S, t * BQ + BQ)))
            for t in range(-(-S // BQ))]
    work = [G * sum(m >= (t * BK if t * BK < n_valid else 1 << 30)
                    for m in qmax) for t in range(n_kt)]
    free = [0] * sms
    for i in range(n_kt * hb):
        tile, _ = _key_tile(plan, i, hb)
        heapq.heappush(free, heapq.heappop(free) + work[tile])
    return max(free) / (sum(work) * hb / sms)


def test_key_tile_order_bounds_the_makespan(plan):
    """The training shape (B=2, S=4096, 3,900 valid tokens, 4 KV heads of
    G=7): 256 items of 128 keys on 132 SMs end within 1.10x of the ideal,
    the tail being the heaviest item itself (key tile 0 takes 64 query
    tiles x 7 heads); 64-key tiles would end at 1.03x."""
    r128 = _k5_makespan(plan, 4096, 3900, 128, 64, 7, 8)
    r64 = _k5_makespan(plan, 4096, 3900, 64, 64, 7, 8)
    assert 1.09 < r128 < 1.10 and 1.02 < r64 < 1.03, (r128, r64)
