"""The launch plans of the port's K6 (int4 dequant-matmul) and K8 (decode
attention) kernels (`streamvln_tpu_torch/csrc/kernel_plan.cuh`): the
contraction split and block count of K6 and the live-prefix shares of K8.
The header is plain C++; the host compiler builds it here behind a small C
shim, so these tests run the very functions the kernels' launchers and
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
#include "kernel_plan.cuh"
extern "C" {
int i4_splits(int M, int din, int dout) {
  return svt::int4_splits(M, din, dout);
}
void i4_groups(int groups, int splits, int z, int* out) {
  const svt::Range r = svt::int4_groups(groups, splits, z);
  out[0] = r.begin;
  out[1] = r.end;
}
int dec_splits(int smax, int batch, int kv_heads) {
  return svt::decode_splits(smax, batch, kv_heads);
}
int dec_splits_d(int smax, int batch, int kv_heads, int head_dim) {
  return svt::decode_splits(smax, batch, kv_heads, head_dim);
}
void dec_keys(int length, int splits, int p, int* out) {
  const svt::Range r = svt::decode_keys(length, splits, p);
  out[0] = r.begin;
  out[1] = r.end;
}
int sms() { return svt::kSms; }
int i4_cluster() { return svt::kI4Cluster; }
int dec_cluster() { return svt::kDecCluster; }
int cols() { return svt::kI4Cols; }
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
    return ctypes.CDLL(str(lib))


def _range(fn, *args):
    out = (ctypes.c_int * 2)()
    fn(*args, out)
    return out[0], out[1]


def test_cluster_sizes(plan):
    # K6: the portable 8; K8: the H100's non-portable 16
    assert (plan.i4_cluster(), plan.dec_cluster()) == (8, 16)


@pytest.mark.parametrize("name", sorted(MAIN_PATH_INT4))
def test_int4_main_path_shapes_fill_the_card(plan, name):
    M, din, dout = MAIN_PATH_INT4[name]
    ks = plan.i4_splits(M, din, dout)
    assert 1 <= ks <= plan.i4_cluster()
    assert dout // plan.cols() * ks >= plan.sms()    # blocks of the grid


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


@pytest.mark.parametrize("smax,batch,kv_heads,want", [
    (4096, 1, 4, 16),      # the main path: one row, Qwen2-7B's 4 KV heads
    (1024, 1, 28, 10),
    (4096, 8, 4, 9),
    (4096, 64, 4, 2),      # a large batch needs fewer splits per row
    (1024, 8, 8, 5),
    (100, 1, 4, 2),        # no more splits than minimum shares
    (16, 1, 1, 1),
    (4096, 300, 4, 1)])
def test_decode_splits(plan, smax, batch, kv_heads, want):
    assert plan.dec_splits(smax, batch, kv_heads) == want


@pytest.mark.parametrize("smax,batch,kv_heads,head_dim,want", [
    (4096, 1, 4, 128, 16),     # head dim 128 is the default
    (4096, 1, 1, 256, 16),     # Gemma-2B: one KV head, capped by the cluster
    (4096, 8, 8, 256, 3),      # one block per SM at head dim 256 ...
    (4096, 8, 8, 128, 5),      # ... two at 128
    (4096, 32, 8, 256, 1)])
def test_decode_splits_by_head_dim(plan, smax, batch, kv_heads, head_dim,
                                   want):
    assert plan.dec_splits_d(smax, batch, kv_heads, head_dim) == want


@pytest.mark.parametrize("splits", [1, 2, 5, 8, 16])
@pytest.mark.parametrize("length", LENGTHS)
def test_decode_shares_cover_every_live_key_once(plan, length, splits):
    keys = []
    for p in range(splits):
        b, e = _range(plan.dec_keys, length, splits, p)
        assert 0 <= b <= e <= length    # no block reads at or past length
        if e > b:
            assert b % 16 == 0          # shares start on 16-key boundaries
            assert e - b >= min(64, length - b)
        keys += range(b, e)
    assert keys == list(range(length))


@pytest.mark.parametrize("splits", [8, 16])
def test_decode_short_prefix_takes_fewer_blocks(plan, splits):
    busy = [p for p in range(splits)
            if _range(plan.dec_keys, 300, splits, p)[1]
            > _range(plan.dec_keys, 300, splits, p)[0]]
    assert busy == [0, 1, 2, 3, 4]      # 64-key shares: 5 blocks
    share = 4096 // splits
    assert all(_range(plan.dec_keys, 4096, splits, p)
               == (share * p, share * (p + 1)) for p in range(splits))
