"""The launch plans of the port's K6 (int4 dequant-matmul), K7 (int4
unpack) and K8 (decode attention) kernels
(`streamvln_tpu_torch/csrc/kernel_plan.cuh`): the contraction split and
block count of K6; K7's grid and the runs of units its warps take; K8's
shared-memory layout and the
blocks per SM it allows, its grid (clusters sized so that one wave holds
them), its live-prefix shares and its merge (the warps of a block, then the
blocks of a cluster). The header is plain
C++; the host compiler builds it here behind a small C shim, so these tests
run the very functions the kernels' launchers and blocks call.
"""
import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "streamvln_tpu_torch", "csrc")
SHIM = r"""
#include "kernel_plan.cuh"
#include <string.h>
using namespace svt;
template <class L> void layout(int* out) {
  out[0] = L::SMEM;
  out[1] = L::W_L + 4 * L::G * 4;
  out[2] = L::Q_OFF;
  out[3] = L::SLOTS;
  out[4] = L::ST;
}
extern "C" {
int i4_splits(int M, int din, int dout) {
  return svt::int4_splits(M, din, dout);
}
void i4_groups(int groups, int splits, int z, int* out) {
  const svt::Range r = svt::int4_groups(groups, splits, z);
  out[0] = r.begin;
  out[1] = r.end;
}
int dec_cluster(int smax, int batch, int kv_heads, const int* resident) {
  return decode_cluster(smax, batch, kv_heads, resident);
}
void dec_keys(int length, int splits, int p, int* out) {
  const svt::Range r = svt::decode_keys(length, splits, p);
  out[0] = r.begin;
  out[1] = r.end;
}
int dec_busy(int length, int splits) { return decode_busy(length, splits); }
int dec_boxes(int n, int t) { return decode_boxes(n, t); }
void dec_box(int n, int t, int j, int* out) {
  const DecBox b = decode_box(n, t, j);
  out[0] = b.row;
  out[1] = b.first;
}
// the instances: bf16 D 128 G <= 8, bf16 D 128 G <= 16, f32 D 128 G <= 16,
// bf16 D 256 G <= 8 -> {SMEM, end of the warps' partials, Q_OFF, SLOTS, ST}
void dec_layout(int inst, int* out) {
  if (inst == 0) layout<DecLayout<2, 128, 8>>(out);
  if (inst == 1) layout<DecLayout<2, 128, 16>>(out);
  if (inst == 2) layout<DecLayout<4, 128, 16>>(out);
  if (inst == 3) layout<DecLayout<2, 256, 8>>(out);
}
float dec_merge(const float* m, const float* l, const float* o, int n,
                float* ml) {
  float mm, ll, oo;
  decode_merge<kDecCluster>(m, l, o, n, mm, ll, oo);
  ml[0] = mm;
  ml[1] = ll;
  return oo;
}
// One head row of K8 as its blocks merge it: scores s (log2 units) and
// values v [length][D] of a row over a cluster of `cluster` blocks
// (decode_keys); each block's four warps take 16 keys of every 64-key tile
// (partial: max, sum, output, in f32), merged in the block (decode_merge),
// then over the busy blocks of the cluster in split order, and normalised.
// A row that no block takes (length 0) is zeros.
void dec_row(const float* s, const float* v, int length, int D, int cluster,
             float* out) {
  memset(out, 0, sizeof(float) * D);
  const int nb = decode_busy(length, cluster);
  if (nb == 0) return;
  float bm[kDecCluster], bl[kDecCluster];
  static float bo[kDecCluster][512];
  for (int r = 0; r < nb; ++r) {
    const Range kr = decode_keys(length, cluster, r);
    float wm[4], wl[4], wo[4][512];
    for (int w = 0; w < 4; ++w) {
      wm[w] = -1e30f;
      wl[w] = 0.f;
      for (int d = 0; d < D; ++d) wo[w][d] = 0.f;
    }
    for (int j = kr.begin; j < kr.end; ++j) {
      const int w = (j - kr.begin) % kDecTile / 16;
      if (s[j] > wm[w]) wm[w] = s[j];
    }
    for (int j = kr.begin; j < kr.end; ++j) {
      const int w = (j - kr.begin) % kDecTile / 16;
      const float e = exp2f(s[j] - wm[w]);
      wl[w] += e;
      for (int d = 0; d < D; ++d) wo[w][d] += e * v[j * D + d];
    }
    for (int d = 0; d < D; ++d) {
      const float po[4] = {wo[0][d], wo[1][d], wo[2][d], wo[3][d]};
      decode_merge<4>(wm, wl, po, 4, bm[r], bl[r], bo[r][d]);
    }
  }
  for (int d = 0; d < D; ++d) {
    float po[kDecCluster], mm, ll, oo;
    for (int r = 0; r < nb; ++r) po[r] = bo[r][d];
    decode_merge<kDecCluster>(bm, bl, po, nb, mm, ll, oo);
    out[d] = ll > 0.f ? oo / ll : 0.f;
  }
}
int dec_owner(int g, int nb) { return decode_owner(g, nb); }
int dec_slot(int g, int nb, int p) { return decode_slot(g, nb, p); }
int dec_owned(int p, int G, int nb) { return decode_owned(p, G, nb); }
int dec_const(int i) {
  const int c[] = {kSms, kDecCluster, kDecMinShare, kSmemPerSm,
                   kSmemPerBlock, kDecTile, kDecBoxRows};
  return c[i];
}
int i4_cluster() { return svt::kI4Cluster; }
int cols() { return svt::kI4Cols; }
// K7: {blocks, warps, rows}, the units, and each warp's units with every
// unit's (first column, first packed row), warp by warp in grid order;
// returns the units written
void i7_grid(int half, int dout, int* out) {
  const UnpackGrid g = unpack_grid(half, dout);
  out[0] = g.blocks;
  out[1] = g.warps;
  out[2] = g.rows;
}
int i7_units(int half, int dout, int rows) {
  return unpack_units(half, dout, rows);
}
int i7_walk(int half, int dout, int* count, int* col, int* row) {
  const UnpackGrid g = unpack_grid(half, dout);
  const int units = unpack_units(half, dout, g.rows);
  int n = 0;
  for (int b = 0; b < g.blocks; ++b)
    for (int w = 0; w < g.warps; ++w) {
      const UnpackRun r = unpack_run(units, g, b, w);
      count[b * g.warps + w] = 0;
      for (int u = r.begin; u < r.end; u += r.step, ++n) {
        const UnpackUnit t = unpack_unit(dout, g.rows, u);
        col[n] = t.col;
        row[n] = t.row;
        ++count[b * g.warps + w];
      }
    }
  return n;
}
int i7_const(int i) {
  const int c[] = {kUnpackMinUnits, kUnpackCols, kUnpackWarps,
                   kI4GroupRows};
  return c[i];
}
}
"""
# (M, din, dout) of every int4 product on the main path (streamvln_7b with
# fused q/k/v and gate/up): the decode projections and lm_head at one row,
# gate/up at the kernel's 128 rows
MAIN_PATH_INT4 = {"qkv": (1, 3584, 4608), "o": (1, 3584, 3584),
                  "gate_up": (1, 3584, 37888), "down": (1, 18944, 3584),
                  "lm_head": (1, 3584, 152064),
                  "gate_up_128": (128, 3584, 37888)}
LENGTHS = (0, 1, 15, 16, 17, 63, 64, 300, 1900, 2049, 4095, 4096)
# (din, dout) of every K7 launch on the main paths: streamvln_7b's fused
# qkv, o (and q), fused gate/up, down, lm_head, and the k/v and gate/up
# that a QLoRA step unpacks unfused; Qwen2-14B's qkv, o, gate/up, down,
# lm_head (--bits 4)
K7_MAIN = {"qkv": (3584, 4608), "o": (3584, 3584), "gu": (3584, 37888),
           "down": (18944, 3584), "lm_head": (3584, 152064),
           "k/v": (3584, 512), "gate/up": (3584, 18944),
           "qkv 14b": (5120, 7168), "o 14b": (5120, 5120),
           "gu 14b": (5120, 27648), "down 14b": (13824, 5120),
           "lm_head 14b": (5120, 152064)}
# the CUDA tests' shapes (din 512-1024, dout 512-1536)
K7_TEST = ((512, 512), (1024, 512), (512, 1536), (1024, 1536),
           (1024, 1024))


@pytest.fixture(scope="module")
def plan(tmp_path_factory):
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler to build the plan header")
    d = tmp_path_factory.mktemp("kernel_plan")
    src, lib = d / "shim.cpp", d / "libkplan.so"
    src.write_text(SHIM)
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I", CSRC,
                    "-o", str(lib), str(src)], check=True)
    cdll = ctypes.CDLL(str(lib))
    cdll.dec_merge.restype = ctypes.c_float
    return cdll


def _range(fn, *args):
    out = (ctypes.c_int * 2)()
    fn(*args, out)
    return out[0], out[1]


# K8's instances (kernel_plan.cuh::DecLayout) -> their index in the shim
DEC_INSTANCES = {"bf16 D=128 G<=8": 0, "bf16 D=128 G<=16": 1,
                 "f32 D=128 G<=16": 2, "bf16 D=256 G<=8": 3}
# the blocks per SM every instance's shared memory allows, which the plan
# assumes (the card's resident-cluster counts are taken at this occupancy,
# and __launch_bounds__ states it)
PER_SM = 1
# a stated H100 SXM layout for the resident-cluster capacity: 132 SMs in 8
# GPCs, a cluster inside one GPC (the card reports its own counts; phase 2
# of chip_smoke.py records them)
GPCS = (18, 18, 16, 16, 16, 16, 16, 16)
# (smax, batch, KV heads, head dim) of every K8 launch on the card's paths:
# the 7B (28/4), Gemma (8/1, D = 256), Qwen2-14B (40/8), Llama-2 (32/32), a
# batched wave of 8, and the cache of the CUDA tests
DEC_SHAPES = ((4096, 1, 4, 128), (4096, 1, 1, 256), (4096, 1, 8, 128),
              (4096, 1, 32, 128), (4096, 8, 4, 128), (4096, 7, 1, 256),
              (1024, 7, 8, 128), (4096, 2, 1, 256), (1024, 3, 32, 128))


def _resident(model):
    """resident[p - 1]: clusters of p blocks at once, per capacity model."""
    if model == "ideal":
        return [sum(GPCS) * PER_SM // p for p in range(1, 17)]
    return [sum(g * PER_SM // p for g in GPCS) for p in range(1, 17)]


def _plan(plan, smax, batch, kv_heads, model="gpc"):
    return plan.dec_cluster(smax, batch, kv_heads,
                            (ctypes.c_int * 16)(*_resident(model)))


def test_cluster_sizes(plan):
    # K6: the portable 8; K8: the H100's non-portable 16
    assert (plan.i4_cluster(), plan.dec_const(1)) == (8, 16)


@pytest.mark.parametrize("name", sorted(MAIN_PATH_INT4))
def test_int4_main_path_shapes_fill_the_card(plan, name):
    M, din, dout = MAIN_PATH_INT4[name]
    ks = plan.i4_splits(M, din, dout)
    assert 1 <= ks <= plan.i4_cluster()
    assert dout // plan.cols() * ks >= plan.dec_const(0)   # grid's blocks


@pytest.mark.parametrize("M,din,dout", [
    *MAIN_PATH_INT4.values(), (1, 512, 512), (5, 512, 2048),
    (1, 1024, 1536), (128, 1024, 512), (40, 512, 37888),
    (20, 1024, 1536), (2, 3584, 3584), (8, 3584, 3584),
    (128, 3584, 3584)])
def test_int4_splits_cover_every_group_once(plan, M, din, dout):
    groups = din // 64
    ks = plan.i4_splits(M, din, dout)
    assert 1 <= ks <= min(groups, plan.i4_cluster())
    seen = []
    for z in range(ks):
        b, e = _range(plan.i4_groups, groups, ks, z)
        assert e > b                    # every split has a group
        seen += range(b, e)
    assert seen == list(range(groups))


def _k7_walk(plan, din, dout):
    """K7's plan at one shape: (blocks, warps, rows), the units, each
    warp's count of units in grid order, and every unit's (column, row)
    in the order the warps take them."""
    half = din // 2
    grid = (ctypes.c_int * 3)()
    plan.i7_grid(half, dout, grid)
    blocks, warps, rows = grid
    units = plan.i7_units(half, dout, rows)
    count = (ctypes.c_int * (blocks * warps))()
    col, row = (ctypes.c_int * units)(), (ctypes.c_int * units)()
    n = plan.i7_walk(half, dout, count, col, row)
    assert n == units
    return ((blocks, warps, rows), units, np.array(count), np.array(col),
            np.array(row))


@pytest.mark.parametrize("din,dout", [*K7_MAIN.values(), *K7_TEST])
def test_unpack_units_cover_every_element_once(plan, din, dout):
    """Every (packed row, column) of the output is in exactly one unit of
    exactly one warp: the units' rows x 512-column rectangles tile [half,
    dout], and each lies inside one scale group."""
    cols, group = plan.i7_const(1), plan.i7_const(3)
    (_, _, rows), units, _, col, row = _k7_walk(plan, din, dout)
    assert rows in (2, 8, 32) and group % rows == 0
    assert units == din // 2 // rows * (dout // cols)
    assert (col % cols == 0).all() and (row % rows == 0).all()
    cover = np.zeros((din // 2 // rows, dout // cols), np.int32)
    np.add.at(cover, (row // rows, col // cols), 1)
    assert (cover == 1).all()


@pytest.mark.parametrize("name", sorted(K7_MAIN))
def test_unpack_grid_fills_the_card(plan, name):
    """At every main-path shape: one block on every SM, of at most
    kUnpackWarps warps, the fewest that take a block's units in as few
    rounds as kUnpackWarps would; no block holds more than one unit over
    another, no warp more than one over another; whole groups where they
    give every warp of a full grid a unit (a lane then reads each group's
    scales once); and the grid sweeps the units in row-major order, unit
    u to warp u % (blocks warps), the warps of all blocks counted first."""
    din, dout = K7_MAIN[name]
    half, sms, most = din // 2, plan.dec_const(0), plan.i7_const(2)
    (blocks, warps, rows), units, count, col, row = _k7_walk(plan, din,
                                                             dout)
    assert blocks == sms and 1 <= warps <= most
    n = count.reshape(blocks, warps)
    assert n.sum(1).max() - n.sum(1).min() <= 1
    assert n.max() - n.min() <= 1
    per_block = -(-units // blocks)
    rounds = -(-per_block // most)
    assert n.max() == rounds and warps == -(-per_block // rounds)
    want = 32 if half // 32 * (dout // 512) >= sms * most else \
        8 if half // 8 * (dout // 512) >= plan.i7_const(0) * sms else 2
    assert rows == want
    u = row // rows * (dout // 512) + col // 512
    start = np.concatenate([[0], np.cumsum(count)[:-1]])
    for b in range(blocks):
        for w in range(warps):
            i = b * warps + w
            mine = u[start[i]:start[i] + count[i]]
            gw = b + w * blocks
            assert (mine == gw + blocks * warps * np.arange(count[i])).all()


@pytest.mark.parametrize("din,dout", K7_TEST)
def test_unpack_grid_at_the_test_shapes(plan, din, dout):
    """Below 132 units every unit has a block of one warp."""
    (blocks, warps, rows), units, _, _, _ = _k7_walk(plan, din, dout)
    sms = plan.dec_const(0)
    want = (units, 1) if units < sms else (sms, -(-units // sms))
    assert (blocks, warps) == want and rows == 2


# blocks of the cluster of each (row, KV head) on the stated GPC layout:
# the largest power of two of which one cluster per (row, KV head) fits a
# wave
@pytest.mark.parametrize("smax,batch,kv_heads,want", [
    (4096, 1, 4, 16),      # the main path: a cluster of 16 per KV head
    (1024, 1, 28, 4),
    (4096, 8, 4, 4),
    (4096, 64, 4, 1),      # a large batch: one block per row
    (1024, 8, 8, 2),
    (100, 1, 4, 4),        # no more splits than minimum shares
    (16, 1, 1, 1),
    (4096, 300, 4, 1)])
def test_decode_splits(plan, smax, batch, kv_heads, want):
    assert _plan(plan, smax, batch, kv_heads) == want


# the same by head dim: one block per SM at both (the shared memory each
# instance takes, DecLayout), so the same plan
@pytest.mark.parametrize("smax,batch,kv_heads,head_dim,want", [
    (4096, 1, 4, 128, 16),     # the 7B
    (4096, 1, 1, 256, 16),     # Gemma-2B: one KV head, one cluster of 16
    (4096, 8, 8, 256, 2),      # one block per SM at head dim 256 ...
    (4096, 8, 8, 128, 2),      # ... and at 128 (two would not be resident)
    (4096, 32, 8, 256, 1)])
def test_decode_splits_by_head_dim(plan, smax, batch, kv_heads, head_dim,
                                   want):
    assert _plan(plan, smax, batch, kv_heads) == want


@pytest.mark.parametrize("splits", [1, 2, 5, 8, 16])
@pytest.mark.parametrize("length", LENGTHS)
def test_decode_shares_cover_every_live_key_once(plan, length, splits):
    least = plan.dec_const(2)
    keys = []
    for p in range(splits):
        b, e = _range(plan.dec_keys, length, splits, p)
        assert 0 <= b <= e <= length    # no block reads at or past length
        if e > b:
            assert b % 16 == 0          # shares start on 16-key boundaries
            assert e - b >= min(least, length - b)
        keys += range(b, e)
    assert keys == list(range(length))


@pytest.mark.parametrize("splits", [8, 16])
def test_decode_short_prefix_takes_fewer_blocks(plan, splits):
    busy = [p for p in range(splits)
            if _range(plan.dec_keys, 300, splits, p)[1]
            > _range(plan.dec_keys, 300, splits, p)[0]]
    # 48-key shares over 8 splits, 32-key (the least) over 16
    assert busy == list(range(7 if splits == 8 else 10))
    assert plan.dec_busy(300, splits) == len(busy)
    share = 4096 // splits
    assert all(_range(plan.dec_keys, 4096, splits, p)
               == (share * p, share * (p + 1)) for p in range(splits))


@pytest.mark.parametrize("name", sorted(DEC_INSTANCES))
def test_decode_layout_fits_the_blocks_per_sm(plan, name):
    """The shared memory the header computes gives exactly the blocks per
    SM the plan assumes: 233,472 bytes an SM, 1 KB kept per block."""
    out = (ctypes.c_int * 5)()
    plan.dec_layout(DEC_INSTANCES[name], out)
    smem, w_end, q_off, slots, stages = out
    per_sm_bytes, reserved = plan.dec_const(3), plan.dec_const(4)
    assert per_sm_bytes == 233472 and reserved == 1024
    assert per_sm_bytes // (smem + reserved) == PER_SM
    assert w_end <= q_off               # the warps' partials over the ring
    assert stages >= 2 and slots <= 32


@pytest.mark.parametrize("model", ["gpc", "ideal"])
@pytest.mark.parametrize("smax,batch,kv_heads,head_dim", DEC_SHAPES)
def test_decode_plan_is_one_wave(plan, smax, batch, kv_heads, head_dim,
                                 model):
    resident = _resident(model)
    P = _plan(plan, smax, batch, kv_heads, model)
    rows = batch * kv_heads
    most = -(-smax // plan.dec_const(2))
    assert 1 <= P <= plan.dec_const(1)
    assert P <= most                    # whole minimum shares
    assert P & (P - 1) == 0             # a power of two
    if rows <= resident[0]:
        assert rows <= resident[P - 1]  # every cluster in the first wave
        # the largest such power of two
        assert all(resident[p - 1] < rows or p > most
                   for p in (2, 4, 8, 16) if p > P)
    else:
        assert P == 1


@pytest.mark.parametrize("smax,batch,kv_heads,head_dim", DEC_SHAPES)
@pytest.mark.parametrize("length", LENGTHS)
def test_decode_plan_shares_cover_every_live_key_once(
        plan, smax, batch, kv_heads, head_dim, length):
    """Over the plan's cluster every live key goes to exactly one block,
    never past the length, in shares that start on 16-key boundaries; the
    busy blocks come first, as many as decode_busy counts."""
    if length > smax:
        return
    P = _plan(plan, smax, batch, kv_heads)
    keys, busy = [], 0
    for p in range(P):
        b, e = _range(plan.dec_keys, length, P, p)
        assert 0 <= b <= e <= length
        if e > b:
            assert b % 16 == 0
            assert p == busy            # the busy blocks come first
            busy += 1
        keys += range(b, e)
    assert keys == list(range(length))
    assert busy == plan.dec_busy(length, P)


@pytest.mark.parametrize("n", [1, 15, 16, 17, 31, 32, 33, 63, 64, 65, 80,
                               127, 129, 144, 256, 455, 1366, 4096])
def test_decode_boxes_take_every_key_of_a_share_once(plan, n):
    """The TMA boxes of a share of n keys (kernel_plan.cuh::decode_box):
    their unmasked rows hold every key exactly once, each in its own tile
    and in the row the consumers read it from; no box reads at or past key
    n, and rows before key 0 are only ever masked ones."""
    tile, rows = plan.dec_const(5), plan.dec_const(6)
    assert tile % rows == 0 and rows % 8 == 0
    out = (ctypes.c_int * 2)()
    keys = []
    for t in range(-(-n // tile)):
        boxes = plan.dec_boxes(n, t)
        assert 1 <= boxes <= tile // rows
        assert boxes * rows >= min(tile, n - t * tile)   # the tile's keys
        for j in range(boxes):
            plan.dec_box(n, t, j, out)
            row, first = out
            assert row + rows <= n                       # none past the end
            assert 0 <= first < rows
            assert row + first == t * tile + j * rows    # its own first key
            live = list(range(row + first, row + rows))
            assert all(t * tile <= key < (t + 1) * tile for key in live)
            keys += live
    assert keys == list(range(n))


@pytest.mark.parametrize("G", [1, 5, 7, 8, 16])
@pytest.mark.parametrize("nb", [1, 2, 3, 5, 8, 9, 15, 16])
def test_decode_level_one_slots(plan, G, nb):
    """Each (head row, sender) lands in its own slot of the owner's receive
    area, inside the area, and the owners' rows cover every row once."""
    out = (ctypes.c_int * 5)()
    plan.dec_layout(0 if G <= 8 else 1, out)
    slots = out[3]
    owned = {}
    for g in range(G):
        owner = plan.dec_owner(g, nb)
        assert owner < nb
        owned.setdefault(owner, []).append(g)
        got = {plan.dec_slot(g, nb, p) for p in range(nb)}
        assert len(got) == nb and max(got) < slots
    for p in range(nb):
        assert plan.dec_owned(p, G, nb) == len(owned.get(p, []))
    taken = [plan.dec_slot(g, nb, p) for g in owned.get(0, [])
             for p in range(nb)]
    assert len(set(taken)) == len(taken)


def _softmax_f64(s, v):
    p = np.exp2(s.astype(np.float64) - s.max())
    return (p / p.sum()) @ v.astype(np.float64), (p / p.sum()) @ np.abs(
        v.astype(np.float64))


@pytest.mark.parametrize("length", [1, 15, 63, 64, 65, 300, 1900, 2049,
                                    4096])
@pytest.mark.parametrize("cluster", [1, 3, 9, 16])
def test_decode_two_level_merge_is_the_softmax(plan, length, cluster):
    """The plan's split partials merged in order (the warps of a block,
    then the busy blocks of the cluster) equal a one-pass f64 softmax
    within f32 rounding."""
    rng = np.random.default_rng(length + cluster)
    D = 64
    s = (rng.standard_normal(length) * 3).astype(np.float32)
    v = rng.standard_normal((length, D)).astype(np.float32)
    out = np.zeros(D, np.float32)
    plan.dec_row(s.ctypes.data_as(ctypes.c_void_p),
                 v.ctypes.data_as(ctypes.c_void_p), length, D, cluster,
                 out.ctypes.data_as(ctypes.c_void_p))
    ref, ref_abs = _softmax_f64(s, v)
    assert np.all(np.abs(out - ref) <= 1e-5 * ref_abs + 1e-7)


def test_decode_merge_skips_an_empty_partial(plan):
    """A partial that saw no key (sum 0, max -1e30) changes nothing, at any
    place in the order, and its max does not count."""
    m = np.array([1.5, 0.25, 3.0], np.float32)
    l = np.array([2.0, 1.0, 4.0], np.float32)
    o = np.array([0.5, -1.0, 2.0], np.float32)
    ml = (ctypes.c_float * 2)()

    def merge(m, l, o):
        r = plan.dec_merge(*(x.ctypes.data_as(ctypes.c_void_p)
                             for x in (m, l, o)), len(m), ml)
        return r, ml[0], ml[1]
    want = merge(m, l, o)
    for at in range(4):
        m2 = np.insert(m, at, np.float32(9.0 if at == 1 else -1e30))
        l2, o2 = np.insert(l, at, 0.0), np.insert(o, at, 123.0)
        assert merge(m2.astype(np.float32), l2.astype(np.float32),
                     o2.astype(np.float32)) == want


@pytest.mark.parametrize("cluster", [1, 16])
def test_decode_zero_length_row_gives_zeros(plan, cluster):
    out = np.full(64, 7.0, np.float32)
    dummy = np.zeros(64, np.float32)
    assert plan.dec_busy(0, cluster) == 0
    for p in range(cluster):            # no block takes a key
        b, e = _range(plan.dec_keys, 0, cluster, p)
        assert b == e
    plan.dec_row(dummy.ctypes.data_as(ctypes.c_void_p),
                 dummy.ctypes.data_as(ctypes.c_void_p), 0, 64, cluster,
                 out.ctypes.data_as(ctypes.c_void_p))
    assert np.all(out == 0)
