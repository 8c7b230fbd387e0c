"""Ablations of the port's hand-written kernels on the card.

    python3 tools/ablate.py [--tree DIR] [variant ...]

Builds copies of `streamvln_tpu_torch/csrc/` with one part taken out or one
setting changed under `streamvln_tpu_torch/_build/ablate/<variant>/` and
times the kernels of the libraries a variant changes through their
wrappers at the main path's shapes by device time (torch.profiler), beside
the kernels as they are ("base", every library). The attention forward
(`attention_fwd.cuh`: K1 vit_attention, K2/K3 flash_attention) is timed on
the settled yardstick (chip_smoke.graph_ms; K1 over operand copies past
the L2 cache) at the SigLIP batches (1, 8, 16, 28, 32), the encoder zoo's
shapes (chip_smoke.VIT_ZOO_SHAPES), the prefill shapes and the train
step's, at head dims 128 and 256 (Gemma: K2 and K3 at Sq 768 and 2560 on
the 4096-slot cache, K3 at B=2 S=4096; K2 and K3 both at the shapes of
the key-tile width rule: the B=8 wave, S = 1024 pairs, the train and 32k
steps), the backward (`flash_attention_bwd.cu`: K4 dQ, K5 dK/dV) on the
same yardstick at the train step's shape at head dims 128 and 256 and by
CUDA events at the 32k step's; K6
(int4 dequant-matmul,
`int4_matmul.cu`) and K8 (decode attention, `decode_attention.cu`) at the
decode path's shapes over a rotation of operand copies that misses the L2
cache; K8 also at the families' decode shapes (Gemma's head dim 256, G = 5,
G = 1), on the settled yardstick (chip_smoke.graph_ms: one CUDA graph of
the rotation, replayed between CUDA events, the median of its readings);
K7 (int4 unpack, `int4_matmul.cu`) on the same yardstick at every shape
chip_smoke.py checks, beside a copy and a fill of its output's size (the
card's stream rates; the "int4" variant times K6 and K7 as they are).
An ablated kernel computes wrong results: the point is how much of the
time each part holds (`fwd_noexp`, `fwd_noqk`, `fwd_nopv`, `fwd_noload`:
the forward's exponentials, products and K/V loads; `d128_bn64`,
`d128_bn128`: the width rule forced one way; `bwd_k5_nowait`,
`bwd_noscores`, `bwd_k4_early`: K5's dV/dK wait, the score products, K4's
preamble). Prints the card and
one JSON line per variant;
"k8_stamps" also one per K8 case with K8's timeline: when its blocks reach
each phase, from the first block's start.
Needs a CUDA card and nvcc. Each edit names a file of `csrc/` and exact text
of it: when the source changes, a variant that no longer matches stops with
an error. With `--tree DIR` the kernels and wrappers are another checkout's
(its `streamvln_tpu_torch/`, e.g. the parent commit unpacked with `git
archive`), timed by this script: "base" there against "base" here, in
turns, compares two commits on one card.
"""
from __future__ import annotations

import ctypes
import importlib.util
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TREE = sys.argv[2] if __name__ == "__main__" and sys.argv[1:2] == \
    ["--tree"] else HERE
sys.path.insert(0, os.path.abspath(TREE))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
from streamvln_tpu_torch.kernels import build  # noqa: E402

ATTN = ("vit_attention", "flash_attention")
BWD = "flash_attention_bwd"
K6, K8 = "int4_matmul", "decode_attention"
FWD, PLAN = "attention_fwd.cuh", "kernel_plan.cuh"
PLAN_A = "attention_plan.cuh"
_SPLIT_RULE = ("  return (n64 + slots - 1) / slots <= (n128 + slots - 1) / "
               "slots;")
BWD_CU = f"{BWD}.cu"
_SKIP = ("      if (n > 0) {{ __syncwarp(); if (lane == 0) "
         "mbar_arrive(empty0 + 8 * st); continue; }}\n{}")
_PACK = "    d[b] = pack_bf16x2(q[2 * b] * sc[b], q[2 * b + 1] * sc[b]);"
# P or dS as a hi + lo pair of bf16 fragments: hi = bf16(x), lo = bf16(x -
# hi), so hi + lo carries ~16 bits of x
_HILO = """template <int NK>
__device__ __forceinline__ void {}(const float* s, uint32_t (*hi)[4],
                                   uint32_t (*lo)[4]) {{
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {{
#pragma unroll
    for (int r = 0; r < 4; ++r) {{
      const float x0 = s[8 * kk + 2 * r], x1 = s[8 * kk + 2 * r + 1];
      const uint32_t h = pack_bf16(x0, x1);
      hi[kk][r] = h;
      lo[kk][r] = pack_bf16(x0 - __uint_as_float(h << 16),
                            x1 - __uint_as_float(h & 0xFFFF0000u));
    }}
  }}
}}

"""
_FWD_HILO = [
    (FWD, "// One arrival per warp on a stage's empty barrier",
     _HILO.format("pack_p_hilo")
     + "// One arrival per warp on a stage's empty barrier"),
    (FWD, "    uint32_t p[BN / 16][4];",
     "    uint32_t p[BN / 16][4], pl[BN / 16][4];"),
    (FWD, "pack_p<BN / 16>(s, p);", "pack_p_hilo<BN / 16>(s, p, pl);"),
    (FWD, "issue_pv<S, NCH>(o, p, dv, prev * S::KV_BYTES);",
     "issue_pv<S, NCH>(o, p, dv, prev * S::KV_BYTES);\n"
     "          issue_pv<S, NCH>(o, pl, dv, prev * S::KV_BYTES);")]
_BWD_HILO = [
    (BWD_CU, "// ---- K4: dQ ----", _HILO.format("pack_ds_hilo")
     + "// ---- K4: dQ ----"),
    # K4: dS and its lo part through the exchange tile, twice its size
    (PLAN_A, "XD_OFF + (WIDE ? BM * BN * 2 : 0)",
     "XD_OFF + (WIDE ? BM * BN * 4 : 0)"),
    (BWD_CU, "    uint32_t f[BN / 16][4];",
     "    uint32_t f[BN / 16][4], fl[BN / 16][4];"),
    (BWD_CU, "        get_frags<BN / 16>(xd, f, t);",
     "        get_frags<BN / 16>(xd, f, t);\n"
     "        get_frags<BN / 16>(xd + 4 * 128, fl, t);"),
    (BWD_CU, "        pack_p<BN / 16>(s, f);\n",
     "        pack_ds_hilo<BN / 16>(s, f, fl);\n"),
    (BWD_CU, "        put_frags<BN / 16>(xd, f, t);",
     "        put_frags<BN / 16>(xd, f, t);\n"
     "        put_frags<BN / 16>(xd + 4 * 128, fl, t);"),
    (BWD_CU, "      issue_rs<2, BN / 16>(acc, f, desc_add(dkt, so), BN * 128);",
     "      issue_rs<2, BN / 16>(acc, f, desc_add(dkt, so), BN * 128);\n"
     "      issue_rs<2, BN / 16>(acc, fl, desc_add(dkt, so), BN * 128);"),
    # K5: P^T (warpgroup 0) and dS^T (1)
    (BWD_CU, "    uint32_t f[BQ / 16][4];",
     "    uint32_t f[BQ / 16][4], fl[BQ / 16][4];"),
    (BWD_CU, "      pack_p<BQ / 16>(s, f);",
     "      pack_ds_hilo<BQ / 16>(s, f, fl);"),
    (BWD_CU, "      issue_rs<NW, BQ / 16>(acc, f, desc_add(dt, so), BQ * 128);",
     "      issue_rs<NW, BQ / 16>(acc, f, desc_add(dt, so), BQ * 128);\n"
     "      issue_rs<NW, BQ / 16>(acc, fl, desc_add(dt, so), BQ * 128);")]
# the key-tile width rule at head dim 128 (attention_plan.cuh::
# fwd_keys128), forced one way for K2 and K3 alike
_RULE = ("  return (long long)((sq + 127) / 128) * heads_batch >= "
         "kKeys128Items;")
# the backward's parts (each variant computes wrong results): K5 issuing
# the next query tile's S^T and dP^T without waiting for this tile's dV
# and dK products (the wait moved past the loop), K4's and K5's score
# products (S and dP) left out, K4's Q and dO load issued before the tile
# statistics (by thread 0, right after the barriers are made)
_K5_WAIT = """      wgmma_wait<0>();
      fence_regs<NO>(dk);
      fence_regs<NO>(dv);
      release(empty0 + 8 * stage, lane);"""
_K5_STORE = """    const int n = a.Sk - k0;
    bf16* kb = a.dk"""
_K4_SCORES = ["""      issue_ss<NW, BN>(s, dqa, BM * 128, desc_add(dkb, stage * S::KV_BYTES),
                       BN * 128);
      issue_ss<NW, BN>(dp, doa, BM * 128, desc_add(dvb, stage * S::KV_BYTES),
                       BN * 128);
""", """        issue_ss<NW, BN>(s, dqa, BM * 128, desc_add(dkb, stage * S::KV_BYTES),
                         BN * 128);
        issue_ss<NW, BN>(dp, doa, BM * 128, desc_add(dvb, stage * S::KV_BYTES),
                         BN * 128);
"""]
_K5_SCORES = """      issue_ss<NW, BQ>(s, dka, BK * 128, desc_add(dqb, so), BQ * 128);
      issue_ss<NW, BQ>(dp, dva, BK * 128, desc_add(dob, so), BQ * 128);
"""
_K4_QLOAD = """    if (lane == 0) {
      mbar_arrive_tx(qfull, 2 * S::Q_BYTES);
#pragma unroll
      for (int c = 0; c < NW; ++c) {
        tma_load_4d(base + S::Q_OFF + c * BM * 128, &maps.q, qfull, c * 64,
                    q0, h, b);
        tma_load_4d(base + S::DO_OFF + c * BM * 128, &maps.dout, qfull,
                    c * 64, q0, h, b);
      }
    }
"""
_K4_INIT = """      mbar_init(empty0 + 8 * s, kConsumers * 4);
    }
    mbar_init_fence();
  }
  tile_stats(kpb, a.Sk, n_kt, kInvalidPos, kInvalidPos, tmin, tmax);"""
# the forward's parts (each variant computes wrong results): the
# softmax's exponentials, S = Q K^T or P V in the loop over key tiles, the
# K/V loads (the stage's barrier completes on the walking warp's arrival)
_EXP = """    s[i] = ex2(fmaf(s[i], f, -mn0));
    s[i + 1] = ex2(fmaf(s[i + 1], f, -mn0));
    s[i + 2] = ex2(fmaf(s[i + 2], f, -mn1));
    s[i + 3] = ex2(fmaf(s[i + 3], f, -mn1));"""
_QK = """          issue_qk<S>(s, dq, dk, stage * S::KV_BYTES);
          wgmma_commit();
          rescale<NO>(o, al0, al1);"""
_KV = """        mbar_arrive_tx(fb, 2 * S::KV_BYTES);
#pragma unroll
        for (int c = 0; c < NW; ++c) {
          tma_load_4d(ks + c * BN * 128, &maps.k[0], fb, c * 64, k0, w_hk,
                      w_b);
          tma_load_4d(vs + c * BN * 128, &maps.v[0], fb, c * 64, k0, w_hk,
                      w_b);
        }"""
# under positions: tile 0 issued only once the consumers' masks are built
# (as PR 20 first had it), and the masks built without loading a position
# (right for positions 0..S-1 only: anyres's rows; the rest compute wrong
# results)
_EARLY0 = """    if (vb) {
      w_tile = 0;
      post();
    }
"""
_LATE0 = [(FWD, _EARLY0, ""), (FWD, "    load_tile(next_tile(vb));",
                               "    w_tile = next_tile(0);\n"
                               "    if (w_tile != 0) load_tile(w_tile);")]
_MASKS = """      visit_masks<BM, BN, 8>(a.q_pos + (long long)b * a.Sq + q0, a.Sq - q0,
                             a.k_pos + (long long)b * a.Sk, a.Sk, n_kt,
                             vmask, fmask, warp - 4, 8, lane, qmin, qmax);"""
_MASKS_NOPOS = """      qmin = q0;
      qmax = min(q0 + BM, a.Sq) - 1;
      for (int t = threadIdx.x - 128; t < n_kt; t += 256) {
        if (t * BN <= qmax) atomicOr(vmask + (t >> 5), 1u << (t & 31));
        if (tile_full(t, BN, a.Sk, t * BN + BN - 1, qmin))
          atomicOr(fmask + (t >> 5), 1u << (t & 31));
      }"""
# K8's rows: (case tag, Hq, Hkv, D, layers, live lengths of 4096 slots)
K8_ROWS = (("", 28, 4, 128, 28, (300, 1900, 2049, 4096)),
           (" D=256", 8, 1, 256, 18, (300, 1900, 2049, 4096)),
           (" G=5", 40, 8, 128, 28, (300, 4096)),
           (" G=1", 32, 32, 128, 12, (300, 4096)))
# K8's phases, stamped by thread 0 of every block into a __device__ array
# read back through svt_stamps: start, init (barriers up, the length read),
# consumed (the share streamed and the warps' partials written), sent (the
# block's rows sent to their owners), received (an owner's partials in)
# and end (the block's last instruction, whichever return it takes)
K8_PHASES = ("start", "init", "consumed", "sent", "received", "end")
K8_STAMP_BLOCKS = 8192
_K8_CU = f"{K8}.cu"
_STAMP = """__device__ unsigned long long g_stamps[8192 * 6];
__device__ __forceinline__ void stamp(int k) {
  if (threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_stamps[((blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x
              + blockIdx.x) * 6 + k] = t;
  }
}
"""
_STAMP_READ = """
extern "C" int svt_stamps(void* dst, int n, int clear) {
  if (clear) {
    void* a;
    cudaGetSymbolAddress(&a, svt::g_stamps);
    return static_cast<int>(cudaMemset(a, 0, n));
  }
  return static_cast<int>(cudaMemcpyFromSymbol(dst, svt::g_stamps, n));
}
"""
_EXIT = ("    cluster_arrive_relaxed();        // (the barrier's count, "
         "exited or not)\n    return;")
_LAST = "    merge_owned<kDecCluster, T, NG, D>(sm, ob, p, G, nb);\n}\n"
_K8_STAMPS = [
    (_K8_CU, "constexpr float kLog2e = 1.4426950408889634f;\n",
     "constexpr float kLog2e = 1.4426950408889634f;\n" + _STAMP),
    (_K8_CU, "  const int length = lengths[b];",
     "  stamp(0);\n  const int length = lengths[b];"),
    (_K8_CU, _EXIT, _EXIT.replace("    return;", "    stamp(5);\n    return;")),
    (_K8_CU, "  cluster_arrive_relaxed();          // the receive barrier is "
     "initialised\n", "  cluster_arrive_relaxed();          // the receive "
     "barrier is initialised\n  stamp(1);\n"),
    (_K8_CU, "  bar_sync(1, 128);                  // the warps' partials are "
     "written\n", "  bar_sync(1, 128);                  // the warps' "
     "partials are written\n  stamp(2);\n"),
    (_K8_CU, "  const int owned = decode_owned(p, G, nb);\n  if (alone || "
     "owned == 0) return;", "  stamp(3);\n  const int owned = "
     "decode_owned(p, G, nb);\n  if (alone || owned == 0) {\n    stamp(5);\n"
     "    return;\n  }"),
    (_K8_CU, "  mbar_wait(recv, 0);\n", "  mbar_wait(recv, 0);\n  stamp(4);\n"),
    (_K8_CU, _LAST, _LAST[:-2] + "\n  stamp(5);\n}\n"),
    (_K8_CU, None, _STAMP_READ)]
# K7's shapes: every one chip_smoke.py checks (the main paths' int4
# projections of streamvln_7b and Qwen2-14B, and the QLoRA step's unfused
# k/v and gate/up)
K7_SHAPES = tuple((n, din, dout) for n, din, dout, M in
                  chip_smoke.INT4_SHAPES if M == 1) + chip_smoke.K7_SHAPES
_K7_CU = f"{K6}.cu"
_K7_SCALES = """        const float4 v = __ldg(reinterpret_cast<const float4*>(
            sg + k * 32 * NPC) + i);
        sc[k][4 * i] = v.x;
        sc[k][4 * i + 1] = v.y;
        sc[k][4 * i + 2] = v.z;
        sc[k][4 * i + 3] = v.w;"""
_K7_LOAD = "          ld_chunk<WORDS>(w + off + i * dout + k * 32 * NPC, p[i][k]);"
_K7_LOADS = """      uint32_t p[SUB][K][WORDS];
#pragma unroll
      for (int i = 0; i < SUB; ++i)
#pragma unroll
        for (int k = 0; k < K; ++k)
""" + _K7_LOAD + """
#pragma unroll
      for (int i = 0; i < SUB; ++i)
#pragma unroll
        for (int k = 0; k < K; ++k) {"""
_K7_ST = '"st.global.v4.b32 [%0], {%1, %2, %3, %4};\\n"'
_K7_RUN = """  r.begin = b + w * g.blocks;
  r.end = units;
  r.step = g.blocks * g.warps;"""
_K7_ROWS = "  g.rows = unpack_units(half, dout, 32) >= kSms * kUnpackWarps ? 32"
# K7 with each row's two 512-column halves staged in shared memory (two
# buffers a warp) and written by one lane with two bulk copies
# (cp.async.bulk.global.shared::cta), in place of the lanes' 16-byte stores
_K7_BULK_PTX = """__device__ __forceinline__ void bulk_store(void* g, const void* s,
                                           int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\\n"
               ::"l"(g), "r"(smem_u32(s)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
}

// The plan (kernel_plan.cuh) gives each warp its units of ROWS rows; a"""
_K7_STORE_LOOP = """#pragma unroll
      for (int i = 0; i < SUB; ++i)
#pragma unroll
        for (int k = 0; k < K; ++k) {
          float l[NPC], h[NPC];
#pragma unroll
          for (int j = 0; j < WORDS; ++j)
            unpack_word(p[i][k][j], sc[k] + 4 * j, l + 4 * j, h + 4 * j);
          T* dst = out + off + i * dout + k * 32 * NPC;
          st_out(dst, to16(l, dst));
          st_out(dst + plane, to16(h, dst));
        }"""
_K7_BULK_LOOP = """#pragma unroll
      for (int i = 0; i < SUB; ++i) {
        T* stg = stage + ((threadIdx.x >> 5) * 2 + (nrow & 1))
            * 2 * kUnpackCols;
        if (lane == 0) bulk_wait_read<1>();
        __syncwarp();
#pragma unroll
        for (int k = 0; k < K; ++k) {
          float l[NPC], h[NPC];
#pragma unroll
          for (int j = 0; j < WORDS; ++j)
            unpack_word(p[i][k][j], sc[k] + 4 * j, l + 4 * j, h + 4 * j);
          T* sd = stg + k * 32 * NPC + NPC * lane;
          *reinterpret_cast<uint4*>(sd) = to16(l, sd);
          *reinterpret_cast<uint4*>(sd + kUnpackCols) = to16(h, sd);
        }
        fence_async_shared();
        __syncwarp();
        if (lane == 0) {
          T* g = out + (t.row + r0 + i) * dout + t.col;
          bulk_store(g, stg, kUnpackCols * sizeof(T));
          bulk_store(g + plane, stg + kUnpackCols, kUnpackCols * sizeof(T));
          bulk_commit();
        }
        ++nrow;
      }"""
_K7_BULK = [
    (_K7_CU, "\n// The plan (kernel_plan.cuh) gives each warp its units of ROWS rows; a",
     "\n" + _K7_BULK_PTX),
    (_K7_CU, "  const int plane = half * dout;               // elements of one half\n",
     "  const int plane = half * dout;               // elements of one half\n"
     "  extern __shared__ __align__(128) unsigned char smraw[];\n"
     "  T* stage = reinterpret_cast<T*>(smraw);\n  int nrow = 0;\n"),
    (_K7_CU, _K7_STORE_LOOP, _K7_BULK_LOOP),
    (_K7_CU, """    }
  }
}

template <typename T>
cudaError_t launch_unpack(""", """    }
  }
  if (lane == 0) bulk_wait_read<0>();
}

template <typename T>
cudaError_t launch_unpack("""),
    (_K7_CU, "  T* op = static_cast<T*>(out);\n",
     "  T* op = static_cast<T*>(out);\n"
     "  const int smem = g.warps * 4 * kUnpackCols * sizeof(T);\n"
     "  cudaFuncSetAttribute(int4_unpack_kernel<T, 32, 8>, "
     "cudaFuncAttributeMaxDynamicSharedMemorySize, smem);\n"
     "  cudaFuncSetAttribute(int4_unpack_kernel<T, 8, 8>, "
     "cudaFuncAttributeMaxDynamicSharedMemorySize, smem);\n"
     "  cudaFuncSetAttribute(int4_unpack_kernel<T, 2, 2>, "
     "cudaFuncAttributeMaxDynamicSharedMemorySize, smem);\n")] + [
    (_K7_CU, f"int4_unpack_kernel<T, {r}, {b}><<<grid, block, 0, st>>>",
     f"int4_unpack_kernel<T, {r}, {b}><<<grid, block, smem, st>>>")
    for r, b in ((32, 8), (8, 8), (2, 2))]
# name: (libraries it changes, edits as (file in csrc/, old text, new text))
VARIANTS = {
    "base": ((*ATTN, BWD, K6, K8), []),
    # K8 as it is, alone
    "k8": ((K8,), []),
    # K6 and K7 as they are, alone
    "int4": ((K6,), []),
    # K7: no scale loads (every scale 1)
    "k7_noscale": ((K6,), [(_K7_CU, _K7_SCALES, "        sc[k][4 * i] = "
                            "sc[k][4 * i + 1] = sc[k][4 * i + 2] = "
                            "sc[k][4 * i + 3] = 1.f;")]),
    # K7: no packed loads (the words made from the unit's offset): the
    # stores' pattern alone
    "k7_noload": ((K6,), [(_K7_CU, _K7_LOAD, """          for (int j = 0; j < WORDS; ++j)
            p[i][k][j] = off * 2654435761u + i * 40503u + k + j;""")]),
    # K7: no stores (the values still computed, fed to an empty asm)
    "k7_nostore": ((K6,), [(_K7_CU, _K7_ST, '""')]),
    # K7: one row's load in flight per warp (each load after the last
    # row's stores)
    "k7_oneload": ((K6,), [(_K7_CU, _K7_LOADS, """#pragma unroll
      for (int i = 0; i < SUB; ++i)
#pragma unroll
        for (int k = 0; k < K; ++k) {
          uint32_t p[SUB][K][WORDS];
""" + _K7_LOAD)]),
    # K7: stores with evict-first priority in L2 (st.global.cs)
    "k7_st_cs": ((K6,), [(_K7_CU, _K7_ST, _K7_ST.replace(
        "st.global.", "st.global.cs."))]),
    # K7: each row's halves by bulk copies from shared memory
    "k7_bulk": ((K6,), _K7_BULK),
    # K7: blocks of up to 32, 8 or 4 warps instead of 16
    "k7_w32": ((K6,), [(PLAN, "constexpr int kUnpackWarps = 16;",
                        "constexpr int kUnpackWarps = 32;")]),
    "k7_w8": ((K6,), [(PLAN, "constexpr int kUnpackWarps = 16;",
                       "constexpr int kUnpackWarps = 8;")]),
    "k7_w4": ((K6,), [(PLAN, "constexpr int kUnpackWarps = 16;",
                       "constexpr int kUnpackWarps = 4;")]),
    # K7: each block its own contiguous run of units, its warps taking
    # them in turn, instead of the grid sweeping them
    "k7_band": ((K6,), [(PLAN, _K7_RUN, """  const int lo = static_cast<int>(
      static_cast<long long>(units) * b / g.blocks);
  r.begin = lo + w;
  r.end = static_cast<int>(static_cast<long long>(units) * (b + 1)
                           / g.blocks);
  r.step = g.warps;""")]),
    # K7: up to 16 warps a block whatever the rounds they leave
    "k7_w16": ((K6,), [(PLAN, "  g.warps = (most + rounds - 1) / rounds;",
                        "  g.warps = most < kUnpackWarps ? most : "
                        "kUnpackWarps;")]),
    # K7: 8-row units at the large layers too (scales read per 8 rows)
    "k7_units8": ((K6,), [(PLAN, _K7_ROWS, "  g.rows = false ? 32")]),
    # K7: 16 rows' loads in flight per lane at the large layers, not 8
    "k7_sub16": ((K6,), [(_K7_CU, "int4_unpack_kernel<T, 32, 8>",
                          "int4_unpack_kernel<T, 32, 16>")]),
    # K7: no 2-row units at the small layers
    "k7_no2": ((K6,), [(PLAN, "constexpr int kUnpackMinUnits = 4;",
                        "constexpr int kUnpackMinUnits = 0;")]),
    # K8: consumers release every stage unread
    "k8_noconsume": ((K8,), [(
        f"{K8}.cu", "    if (jb < decode_boxes(nkeys, t) && first < 16) {",
        "    if (false) {")]),
    # K8: clusters of at most the portable 8 blocks
    "k8_c8": ((K8,), [(PLAN, "constexpr int kDecCluster = 16;",
                       "constexpr int kDecCluster = 8;")]),
    # the launch alone: every block returns at once (same grid, clusters
    # and shared memory)
    "k6_empty": ((K6,), [(f"{K6}.cu", "  using S = I4Shape<NT>;\n  constexpr",
                          "  if (M > 0) return;\n  using S = I4Shape<NT>;\n"
                          "  constexpr")]),
    "k8_empty": ((K8,), [(f"{K8}.cu", "  using S = DecShape<T, NG, D>;\n"
                          "  extern", "  if (Hq > 0) return;\n"
                          "  using S = DecShape<T, NG, D>;\n  extern")]),
    # K8: shares of at least 64 keys (a full tile) instead of 32, and the
    # reverse (for a tree that takes 64)
    "k8_share64": ((K8,), [(PLAN, "constexpr int kDecMinShare = 32;",
                            "constexpr int kDecMinShare = 64;")]),
    # K8 (bf16): TMA boxes of 64 key rows (a whole tile; the last one
    # ending at the share's end) instead of 16
    "k8_box64": ((K8,), [(PLAN, "constexpr int kDecBoxRows = 16;",
                          "constexpr int kDecBoxRows = 64;")]),
    # K8: the cluster barrier's arrivals with release semantics
    "k8_release": ((K8,), [(f"{K8}.cu", "cluster_arrive_relaxed();",
                            "cluster_arrive();")]),
    # K8: clusters of any size up to 16, not powers of two only
    "k8_any_size": ((K8,), [(PLAN, "p > 1; p /= 2)", "p > 1; --p)")]),
    # the attention forward as it is, alone (K1, K2, K3), and K2/K3 alone
    "attn": (ATTN, []),
    "fwd": (ATTN[1:], []),
    # K1 without the key split: 128-row items at every shape
    "k1_nosplit": (ATTN[:1], [(PLAN_A, _SPLIT_RULE, "  return false;")]),
    # K1's split also where 128-row items leave block slots idle (the
    # 64-row items then take a second round)
    "k1_fill": (ATTN[:1], [(PLAN_A, _SPLIT_RULE,
                            "  return n128 < slots ||" + _SPLIT_RULE[8:])]),
    # the forward at head dim 256 with two stages instead of three
    "d256_st2": (ATTN[1:], [(
        PLAN_A,
        "static constexpr int ST = WIDE || BN * DP >= 128 * 128 ? 3 : 4;",
        "static constexpr int ST = WIDE ? 2 : BN * DP >= 128 * 128 ? 3 : 4;"
    )]),
    "fwd_noexp": (ATTN[1:], [(FWD, _EXP, _EXP.replace("ex2(", "("))]),
    "fwd_noqk": (ATTN[1:], [(FWD, _QK, _QK.split("\n", 1)[1])]),
    "fwd_nopv": (ATTN[1:], [(
        FWD, "          issue_pv<S, NCH>(o, p, dv, prev * S::KV_BYTES);\n",
        "")]),
    # (K2/K3 only: every flash instance's head dim is a multiple of 64)
    "fwd_noload": (ATTN[1:], [(FWD, _KV, "        mbar_arrive(fb);")]),
    "fwd_tile0_late": (ATTN[1:], _LATE0),
    "fwd_masks_nopos": (ATTN[1:], [(FWD, _MASKS, _MASKS_NOPOS)]),
    # the forward at head dim 128 at every shape on 64-key tiles in 4
    # stages, or on 128-key tiles in 3 (K2 and K3 alike)
    "d128_bn64": (ATTN[1:], [(PLAN_A, _RULE, "  return false;")]),
    "d128_bn128": (ATTN[1:], [(PLAN_A, _RULE, "  return true;")]),
    # the backward (K4, K5) as it is, alone, and its parts
    "bwd": ((BWD,), []),
    "bwd_k5_nowait": ((BWD,), [
        (BWD_CU, _K5_WAIT, "      release(empty0 + 8 * stage, lane);"),
        (BWD_CU, _K5_STORE, "    wgmma_wait<0>();\n    fence_regs<NO>(dk);\n"
         "    fence_regs<NO>(dv);\n" + _K5_STORE)]),
    "bwd_noscores": ((BWD,), [(BWD_CU, x, "") for x in _K4_SCORES]
                     + [(BWD_CU, _K5_SCORES, "")]),
    "bwd_k4_early": ((BWD,), [
        (BWD_CU, _K4_QLOAD, ""),
        (BWD_CU, _K4_INIT, _K4_INIT.replace(
            "    mbar_init_fence();\n",
            "    mbar_init_fence();\n" + _K4_QLOAD.replace(
                "    if (lane == 0) {\n", "    {\n")))]),
    # K1 at head dims 88 and 104 on the DP = 128 instance (the TPU
    # kernel's padding to 128 lanes) instead of 96 and 112
    "k1_pad128": (ATTN[:1], [
        ("vit_attention.cu",
         "    case 88: return svt::attention_forward<96>(a, st);\n"
         "    case 104: return svt::attention_forward<112>(a, st);",
         "    case 88:\n"
         "    case 104: return svt::attention_forward<128>(a, st);")]),
    # K8 with %globaltimer stamps per block at its phase boundaries (the
    # kernel's timeline; ncu does not run on the card's machine): times as
    # "k8", then the stamps of each K8 case's last rotation
    "k8_stamps": ((K8,), _K8_STAMPS),
}


def apply_edits(name: str) -> str:
    """Copy csrc/ and apply the variant's edits (each must match the source
    exactly). Returns the copy's directory."""
    d = os.path.join(build.BUILD_DIR, "ablate", name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(build.CSRC, d)
    for fn, old, new in VARIANTS[name][1]:
        path = os.path.join(d, fn)
        with open(path) as f:
            src = f.read()
        if old is None:                 # appended to the file
            old, new = src, src + new
        if old not in src:
            raise RuntimeError(f"{name}: {fn} no longer contains {old!r}; "
                               f"update the variant")
        with open(path, "w") as f:
            f.write(src.replace(old, new))
    return d


def build_variant(name: str) -> dict:
    """apply_edits, then start one nvcc per library the variant changes.
    Returns {lib: (process, path)}."""
    d = apply_edits(name)
    procs = {}
    for lib in VARIANTS[name][0]:
        out = os.path.join(d, f"lib{lib}.so")
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", out,
               os.path.join(d, f"{lib}.cu")]
        procs[lib] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      out)
    return procs


def use_variant(procs: dict) -> None:
    """Wait for a variant's builds and make the wrappers launch it (a
    variant named again is loaded again, its build kept)."""
    for lib, (proc, path) in procs.items():
        out = proc.stdout.read() if not proc.stdout.closed else ""
        proc.wait()
        proc.stdout.close()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {path}:\n{out}")
        print(f"{lib}: {chip_smoke.ptxas_summary(out)}", file=sys.stderr)
        for line in out.splitlines():
            if "serialized" in line:
                print(f"  {line.strip()[-160:]}", file=sys.stderr)
        cdll = ctypes.CDLL(path)
        for sym, argtypes in build.ARGTYPES.items():
            if hasattr(cdll, sym):
                getattr(cdll, sym).argtypes = argtypes
                getattr(cdll, sym).restype = ctypes.c_int
        if hasattr(cdll, "svt_stamps"):
            cdll.svt_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_int]
            cdll.svt_stamps.restype = ctypes.c_int
        build._libs[lib] = cdll


def cases(torch, libs) -> dict:
    """{case: (library, [calls], calls timed: 0 for the settled
    yardstick)} of the libraries `libs`: K1 at the SigLIP batches and
    the zoo's shapes, K2 at the prefill buckets 768 and 2560 over a
    4096-slot cache from position 300 (also at Gemma's head dim 256,
    with K3), K3, K4 and K5 at the train
    step's shape (also at Gemma's head dim 256); K6 at every int4
    projection's shape chip_smoke.py checks; K7 at every shape
    it unpacks on the main paths (K7_SHAPES) beside a copy of its output's
    size (the card's stream rate, graph-timed as K7 is) and a fill of it
    (a write-only stream); K8 at 300 and 4096
    live keys of a 4096-slot cache (K8_ROWS: the main path's and the
    families' shapes, over their layers' caches), each over operand copies
    past 2.5x the 50 MB L2 cache."""
    from streamvln_tpu_torch.ops import decode_attention as da
    from streamvln_tpu_torch.ops import flash_attention as fa
    from streamvln_tpu_torch.ops import int4_matmul as i4
    from streamvln_tpu_torch.ops import vit_attention as va
    g = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda") \
            .to(torch.bfloat16)
    out = {}
    if ATTN[0] in libs:
        # K1 at the SigLIP batches and the zoo's shapes, each over operand
        # copies past the L2 cache
        shapes = [(B, 729, 16, 72) for B in (1, 8, 16, 28, 32)] + [
            s for s in chip_smoke.VIT_ZOO_SHAPES if s[1:] != (729, 16, 72)
            or s[0] not in (1, 8, 16, 28, 32)]
        for B, S, H, D in shapes:
            ops = [tuple(rnd(B, S, H, D) for _ in range(3)) for _ in range(
                chip_smoke._copies(4 * B * S * H * D * 2))]
            out[f"K1 B={B} S={S} H={H} D={D}"] = ("vit_attention", [
                lambda o=o: va.vit_attention(*o) for o in ops], 0)
    if ATTN[1] in libs:
        kp = torch.arange(4096, device="cuda", dtype=torch.int32)[None]
        # K2 (and at head dim 256 K3) on the 4096-slot cache from position
        # 300: Qwen2-7B's 28/4 heads, Gemma's 8/1 at head dim 256, and at
        # Sq 768 the families' group sizes 1 (32/32) and 5 (40/8)
        for hq, hkv, d, sqs in ((28, 4, 128, (768, 2560)),
                                (8, 1, 256, (768, 2560)),
                                (32, 32, 128, (768,)),
                                (40, 8, 128, (768,))):
            for sq in sqs:
                q, k, v = rnd(1, sq, hq, d), rnd(1, hkv, 4096, d), \
                    rnd(1, hkv, 4096, d)
                qp = (300 + torch.arange(sq, device="cuda",
                                         dtype=torch.int32))[None]
                tag = f" D={d}" if d != 128 else f" G={hq // hkv}" \
                    if hq != 28 else ""
                out[f"K2{tag} Sq={sq}"] = ("flash_attention", [
                    lambda q=q, k=k, v=v, qp=qp: fa.flash_attention(
                        q, k, v, qp, kp, kv_major=True)] * 10, 0)
                if d == 256 or hq == 28:
                    out[f"K3{tag} Sq={sq}"] = ("flash_attention", [
                        lambda q=q, k=k, v=v, qp=qp: fa.flash_attention_lse(
                            q, k, v, qp, kp, kv_major=True)] * 10, 0)
                if (hq, sq) == (28, 768):
                    # the cache cut to the slots a query sees: the same
                    # output without the walk over the key tiles past them
                    n = 300 + sq
                    out["K2 Sq=768 live"] = ("flash_attention", [
                        lambda q=q, k=k[:, :, :n], v=v[:, :, :n], qp=qp,
                        kp=kp[:, :n].contiguous(): fa.flash_attention(
                            q, k, v, qp, kp, kv_major=True)] * 10, 0)
        # K2 without a cache at anyres's prefills, over operand copies
        # past the L2 cache (K3 too: the width study)
        for S in (3032, 3046):
            pos = torch.arange(S, device="cuda", dtype=torch.int32)[None] \
                .contiguous()
            ops = [(rnd(1, S, 28, 128), rnd(1, S, 4, 128), rnd(1, S, 4, 128))
                   for _ in range(chip_smoke._copies(
                       2 * (2 * S * 28 * 128 + 2 * S * 4 * 128)))]
            out[f"K2 anyres Sq={S}"] = ("flash_attention", [
                lambda o=o, p=pos: fa.flash_attention(*o, p, p)
                for o in ops], 0)
            out[f"K3 anyres Sq={S}"] = ("flash_attention", [
                lambda o=o, p=pos: fa.flash_attention_lse(*o, p, p)
                for o in ops], 0)
        # the batch worker's wave of 8 768-row prefills at their offsets of
        # the 4096-slot cache, and phase 12's DPO / reward / PPO forwards
        # (B=2 S=1024, 919 valid): K2 and K3
        q, k, v = rnd(8, 768, 28, 128), rnd(8, 4, 4096, 128), \
            rnd(8, 4, 4096, 128)
        qp = (torch.tensor(chip_smoke.WAVE_OFFSETS, device="cuda",
                           dtype=torch.int32)[:, None]
              + torch.arange(768, device="cuda", dtype=torch.int32)[None]) \
            .contiguous()
        kp8 = kp.repeat(8, 1).contiguous()
        for tag, f in (("K2", fa.flash_attention),
                       ("K3", fa.flash_attention_lse)):
            out[f"{tag} wave B=8 Sq=768"] = ("flash_attention", [
                lambda f=f, q=q, k=k, v=v, qp=qp: f(q, k, v, qp, kp8,
                                                    kv_major=True)] * 10, 0)
        qp12, kp12 = chip_smoke.train_positions(torch, 2, 1024, 919, "cuda")
        q, k, v = rnd(2, 1024, 28, 128), rnd(2, 1024, 4, 128), \
            rnd(2, 1024, 4, 128)
        for tag, f in (("K2", fa.flash_attention),
                       ("K3", fa.flash_attention_lse)):
            out[f"{tag} pref B=2 S=1024"] = ("flash_attention", [
                lambda f=f, q=q, k=k, v=v: f(q, k, v, qp12, kp12)] * 10, 0)
    if ATTN[1] in libs or BWD in libs:
        S, n = 4096, 3900
        q, k, v = rnd(2, S, 28, 128), rnd(2, S, 4, 128), rnd(2, S, 4, 128)
        pos = torch.arange(S, device="cuda", dtype=torch.int32)
        qp = torch.where(pos < n, pos, 0)[None].repeat(2, 1).contiguous()
        kp3 = torch.where(pos < n, pos, fa.INVALID_POS)[None].repeat(2, 1) \
            .contiguous()
        out["K3"] = ("flash_attention", [
            lambda q=q, k=k, v=v, qp=qp: fa.flash_attention_lse(
                q, k, v, qp, kp3)] * 10, 0)
        out["K2 train"] = ("flash_attention", [
            lambda q=q, k=k, v=v, qp=qp: fa.flash_attention(
                q, k, v, qp, kp3)] * 10, 0)
        # the 32k step's (B=1, 32,000 valid), by CUDA events as phase 9c
        SL, nl = chip_smoke.LONG_S, chip_smoke.LONG_VALID
        ql, kl, vl = rnd(1, SL, 28, 128), rnd(1, SL, 4, 128), \
            rnd(1, SL, 4, 128)
        qpl, kpl = chip_smoke.train_positions(torch, 1, SL, nl, "cuda")
        out["K3 32k"] = ("flash_attention", [
            lambda: fa.flash_attention_lse(ql, kl, vl, qpl, kpl)], "events")
        out["K2 32k"] = ("flash_attention", [
            lambda: fa.flash_attention(ql, kl, vl, qpl, kpl)], "events")
        o, lse = fa.flash_attention_lse(q, k, v, qp, kp3)
        do = rnd(2, S, 28, 128)
        bwd = (q, k, v, do, lse, fa._dsum(do, o), qp, kp3)
        out["K4"] = (BWD, [lambda: fa.flash_bwd_dq(*bwd)] * 10, 0)
        out["K5"] = (BWD, [lambda: fa.flash_bwd_dkv(*bwd)] * 10, 0)
        ol, lsel = fa.flash_attention_lse(ql, kl, vl, qpl, kpl)
        dol = rnd(1, SL, 28, 128)
        bwdl = (ql, kl, vl, dol, lsel, fa._dsum(dol, ol), qpl, kpl)
        del ol
        out["K4 32k"] = (BWD, [lambda: fa.flash_bwd_dq(*bwdl)], "events")
        out["K5 32k"] = (BWD, [lambda: fa.flash_bwd_dkv(*bwdl)], "events")
        # ... and at Gemma's (head dim 256, 8/1 heads)
        q, k, v = rnd(2, S, 8, 256), rnd(2, S, 1, 256), rnd(2, S, 1, 256)
        out["K3 D=256"] = ("flash_attention", [
            lambda q=q, k=k, v=v, qp=qp: fa.flash_attention_lse(
                q, k, v, qp, kp3)] * 10, 0)
        o, lse = fa.flash_attention_lse(q, k, v, qp, kp3)
        do = rnd(2, S, 8, 256)
        bwd256 = (q, k, v, do, lse, fa._dsum(do, o), qp, kp3)
        out["K4 D=256"] = (BWD, [lambda: fa.flash_bwd_dq(*bwd256)] * 10, 0)
        out["K5 D=256"] = (BWD, [lambda: fa.flash_bwd_dkv(*bwd256)] * 10,
                           0)
    if K6 in libs:
        # K6 at every int4 projection's shape that chip_smoke.py checks:
        # the 7B's at 1, 7 and 128 rows, Qwen2-14B's at one row
        for name, din, dout, M in chip_smoke.INT4_SHAPES:
            name = f"{name} M={M}" if M > 1 else name
            n = max(1, -(-int(125e6) // (din * dout // 2
                                         + din * dout // 16)))
            ws = [(torch.randint(0, 256, (1, din // 2, dout), generator=g,
                                 device="cuda", dtype=torch.uint8),
                   torch.rand((1, din // 64, dout), generator=g,
                              device="cuda") * 0.01) for _ in range(n)]
            x = rnd(M, din)
            out[f"K6 {name}"] = (K6, [
                lambda w=w, s=s, x=x: i4.int4_matmul(x, w, s, 0)
                for w, s in ws], 24)
        # K7 over operand copies past the L2 cache, and a copy of its
        # output's size over sources past it into one destination
        for name, din, dout in K7_SHAPES:
            n = chip_smoke._copies(din // 2 * dout * 5)
            ws = [(torch.randint(0, 256, (1, din // 2, dout), generator=g,
                                 device="cuda", dtype=torch.uint8),
                   torch.rand((1, din // 64, dout), generator=g,
                              device="cuda") * 0.01) for _ in range(n)]
            out[f"K7 {name}"] = (K6, [
                lambda w=w, s=s: i4.int4_dequant_split(w, s, 0)
                for w, s in ws], 0)
            srcs = [rnd(din, dout) for _ in range(
                chip_smoke._copies(din * dout * 4))]
            dst = torch.empty_like(srcs[0])
            out[f"copy {name}"] = (K6, [lambda a=a, d=dst: d.copy_(a)
                                        for a in srcs], 0)
            # a write-only stream of the output's size
            out[f"fill {name}"] = (K6, [lambda d=dst: d.fill_(1.0)], 0)
    if K8 in libs:
        # K8 at the main path's shape (28/4 heads over 28 layers) and the
        # families' (Gemma 8/1 at D = 256 over 18 layers, Qwen2-14B 40/8 over
        # 28, Llama-2 32/32 over 12), each over its layers' caches in turn
        for tag, Hq, Hkv, D, L, lens in K8_ROWS:
            dq = rnd(L, 1, 1, Hq, D)
            dk, dv = rnd(L, 1, Hkv, 4096, D), rnd(L, 1, Hkv, 4096, D)
            for n in lens:
                lens_t = torch.full((1,), n, dtype=torch.int32, device="cuda")
                out[f"K8{tag} {n}"] = (K8, [
                    lambda i=i, q=dq, k=dk, v=dv, ln=lens_t:
                    da.decode_attention(q[i], k[i], v[i], ln)
                    for i in range(L)], 2 * L)
    return out


def time_case(torch, case, fns, calls) -> float:
    """The attention forward and K8 on the settled yardstick (no bound: an
    ablated kernel may beat it; `calls` 0), K3 at 32k by CUDA events
    (`calls` "events", 5 calls), the others by device time."""
    if calls == "events":
        return chip_smoke.time_ms(torch, fns[0], iters=5)
    if not calls or case.startswith("K8"):
        return chip_smoke.graph_ms(torch, fns, 0.0, case)["ms"]
    return chip_smoke.device_ms(torch, fns, calls)


def k8_timeline(torch, fns) -> dict:
    """The stamped K8's last rotation of `fns`, after two unstamped ones:
    per phase, the median and the latest time over the blocks from the
    first block's start (us), and the blocks that reached it."""
    lib = build._libs[K8]
    n = K8_STAMP_BLOCKS * len(K8_PHASES)
    host = (ctypes.c_ulonglong * n)()
    for f in fns + fns:
        f()
    torch.cuda.synchronize()
    lib.svt_stamps(None, n * 8, 1)
    torch.cuda.synchronize()
    for f in fns:
        f()
    torch.cuda.synchronize()
    lib.svt_stamps(ctypes.addressof(host), n * 8, 0)
    k = len(K8_PHASES)
    rows = [host[k * i:k * i + k] for i in range(K8_STAMP_BLOCKS)
            if host[k * i]]
    t0 = min(r[0] for r in rows)
    out = {}
    for j, name in enumerate(K8_PHASES):
        us = sorted((r[j] - t0) / 1e3 for r in rows if r[j])
        if us:
            out[name] = {"median": round(us[len(us) // 2], 3),
                         "latest": round(us[-1], 3), "blocks": len(us)}
    return out


def main(argv) -> int:
    import torch
    if argv[:1] == ["--tree"]:
        argv = argv[2:]
    if not torch.cuda.is_available():
        print("ablate: needs a CUDA card", file=sys.stderr)
        return 2
    names = argv or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        print(f"ablate: unknown variants {unknown}", file=sys.stderr)
        return 2
    builds = {n: build_variant(n) for n in dict.fromkeys(names)}
    work = cases(torch, {lib for n in names for lib in VARIANTS[n][0]})
    print(torch.cuda.get_device_name(0), subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())
    for n in names:
        use_variant(builds[n])
        libs = VARIANTS[n][0]
        print(json.dumps({"variant": n, "tree": TREE, "ms": {
            c: round(time_case(torch, c, fns, calls), 5)
            for c, (lib, fns, calls) in work.items() if lib in libs}}),
            flush=True)
        if n == "k8_stamps":
            for c, (lib, fns, _) in work.items():
                if lib == K8:
                    print(json.dumps({"variant": n, "case": c, "phases_us":
                                      k8_timeline(torch, fns)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
