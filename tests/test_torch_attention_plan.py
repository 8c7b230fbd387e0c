"""The launch plan of the port's attention forward
(`streamvln_tpu_torch/csrc/attention_plan.cuh`): the order of the work
items and the grid size. The header is plain
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
