"""Ablations of the port's hand-written kernels on the card.

    python3 tools/ablate.py [variant ...]

Builds copies of `streamvln_tpu_torch/csrc/` with one part taken out or one
setting changed under `streamvln_tpu_torch/_build/ablate/<variant>/` and
times the kernels of the libraries a variant changes through their
wrappers at the main path's shapes by device time (torch.profiler), beside
the kernels as they are ("base", every library). The attention forward
(`attention_fwd.cuh`: K1 vit_attention, K2/K3 flash_attention) is timed at
the SigLIP and prefill shapes and the train step's, the backward
(`flash_attention_bwd.cu`: K4 dQ, K5 dK/dV) at the train step's shape; K6
(int4 dequant-matmul,
`int4_matmul.cu`) and K8 (decode attention, `decode_attention.cu`) at the
decode path's shapes over a rotation of operand copies that misses the L2
cache. An ablated kernel computes wrong results: the point is how much of
the time each part holds. Prints the card and one JSON line per variant.
Needs a CUDA card and nvcc. Each edit names a file of `csrc/` and exact text
of it: when the source changes, a variant that no longer matches stops with
an error.
"""
from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import device_ms  # noqa: E402
from streamvln_tpu_torch.kernels import build  # noqa: E402

ATTN = ("vit_attention", "flash_attention")
BWD = "flash_attention_bwd"
K6, K8 = "int4_matmul", "decode_attention"
FWD, PLAN = "attention_fwd.cuh", "kernel_plan.cuh"
BWD_CU = f"{BWD}.cu"
_SKIP = ("      if (n > 0) {{ __syncwarp(); if (lane == 0) "
         "mbar_arrive(empty0 + 8 * st); continue; }}\n{}")
_PACK = "    d[b] = pack_bf16x2(q[2 * b] * sc[b], q[2 * b + 1] * sc[b]);"
# name: (libraries it changes, edits as (file in csrc/, old text, new text))
VARIANTS = {
    "base": ((*ATTN, BWD, K6, K8), []),
    # attention forward: ex2 -> a multiply (the MUFU pipe's share)
    "noexp": (ATTN, [(
        "pipeline.cuh",
        "  float y;\n  asm(\"ex2.approx.ftz.f32 %0, %1;\\n\" : \"=f\"(y) "
        ": \"f\"(x));\n  return y;", "  return x * 0.5f;")]),
    # attention forward: the S = Q K^T products
    "noqk": (ATTN, [(FWD, "      wgmma_ss<S::BN>(s, desc_add(dq,",
                     "      if (0) wgmma_ss<S::BN>(s, desc_add(dq,"),
                    (FWD, "  if (S::TAIL) wgmma_ss<S::BN>(s, dqt, dkt, 1);",
                     "")]),
    # attention forward: the P V products
    "nopv": (ATTN, [(FWD, "      wgmma_rs_n64(o + 32 * c, p[kk],",
                     "      if (0) wgmma_rs_n64(o + 32 * c, p[kk],"),
                    (FWD, "      wgmma_rs_n16(o + 32 * S::NW, p[kk], "
                     "desc_add(dvt, kk * 16 * 32));", "      ;")]),
    # attention forward, K1 only (D=72): the 16-column chunk in both
    # products
    "notail": (ATTN, [(FWD, "  if (S::TAIL) wgmma_ss<S::BN>(s, dqt, dkt, 1);",
                       ""),
                      (FWD, "      wgmma_rs_n16(o + 32 * S::NW, p[kk], "
                       "desc_add(dvt, kk * 16 * 32));", "      ;")]),
    # attention forward: the two consumer warpgroups' turn-taking
    "noping": (ATTN, [(FWD, "named_sync(1 + cw, 256);", ""),
                      (FWD, "named_arrive(2 - cw, 256);", ""),
                      (FWD, "if (cw == 1) named_arrive(1, 256);", "")]),
    # K4/K5: the exponentials (P = S * scale - LSE instead)
    "bwd_noexp": ((BWD,), [(BWD_CU, "ex2(fmaf(", "(fmaf(")]),
    # K4/K5: the products fed from registers (dS K; P^T dO and dS^T Q)
    "bwd_nods": ((BWD,), [
        (BWD_CU, "issue_rs<NW, BN / 16>(acc, f,",
         "if (0) issue_rs<NW, BN / 16>(acc, f,"),
        (BWD_CU, "issue_rs<NW, BQ / 16>(dv, pf,",
         "if (0) issue_rs<NW, BQ / 16>(dv, pf,"),
        (BWD_CU, "issue_rs<NW, BQ / 16>(dk, sf,",
         "if (0) issue_rs<NW, BQ / 16>(dk, sf,")]),
    # K4/K5: consumers release every stage unread (the ring alone)
    "bwd_noconsume": ((BWD,), [
        (BWD_CU, "  int prev = -1;\n  if (meta_k0[stage] >= 0) {",
         "  int prev = -1;\n  while (meta_k0[stage] >= 0) {\n"
         "    release(empty0 + 8 * stage, lane);\n"
         "    if (leader) { prefetch(); commit(); }\n"
         "    if (++stage == ST) { stage = 0; phase ^= 1; }\n"
         "    mbar_wait(full0 + 8 * stage, phase);\n  }\n  if (0) {"),
        (BWD_CU, "    if (meta_q0[stage] < 0) break;\n",
         "    if (meta_q0[stage] < 0) break;\n"
         "    release(empty0 + 8 * stage, lane);\n"
         "    if (leader) commit();\n"
         "    if (++stage == ST) { stage = 0; phase ^= 1; }\n"
         "    continue;\n")]),
    # K4/K5: the launch alone (same grid and shared memory)
    "bwd_empty": ((BWD,), [
        (BWD_CU, "  using S = DqShape<DP>;\n  constexpr",
         "  if (a.B > 0) return;\n  using S = DqShape<DP>;\n  constexpr"),
        (BWD_CU, "  using S = DkvShape<DP>;\n  constexpr",
         "  if (a.B > 0) return;\n  using S = DkvShape<DP>;\n  constexpr")]),
    # K6: the nibble -> bf16 arithmetic (the raw word goes to the products)
    "k6_nodequant": ((K6,), [(f"{K6}.cu", _PACK, "    d[b] = w >> b;")]),
    # K6: the scale multiplies only
    "k6_nofmul": ((K6,), [(
        f"{K6}.cu", _PACK, "    d[b] = pack_bf16x2(q[2 * b], q[2 * b + 1]);")]),
    # K6: the tensor-core products (a cheap use of the operands instead)
    "k6_nomma": ((K6,), [(
        f"{K6}.cu",
        "for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[j][nt], a, bf[nt]);",
        "for (int nt = 0; nt < NT; ++nt) acc[j][nt][0] += "
        "__uint_as_float(a[0] ^ bf[nt][0]);")]),
    # K6: consumers release every stage unread (the copy pipeline alone)
    "k6_noconsume": ((K6,), [(
        f"{K6}.cu", "      const unsigned char* stg = sm + st * S::STAGE;\n"
        "      float sc",
        _SKIP.format("      const unsigned char* stg = sm + st * S::STAGE;\n"
                     "      float sc"))]),
    # K6: clusters of up to 16 blocks (non-portable)
    "k6_c16": ((K6,), [(PLAN, "constexpr int kI4Cluster = 8;",
                        "constexpr int kI4Cluster = 16;"),
                       (f"{K6}.cu", "S::SMEM_MAX, false);",
                        "S::SMEM_MAX, true);")]),
    # K6: splits for two blocks per SM at every M
    "k6_2per_sm": ((K6,), [(PLAN, "const int per_sm = M <= 8 ? 4 : 2;",
                            "const int per_sm = 2;")]),
    # K8: consumers release every stage unread
    "k8_noconsume": ((K8,), [(
        f"{K8}.cu",
        "    const int kc = t * kDecTile + 16 * warp;   // the chunk's first "
        "key\n    if (kc < nkeys) {",
        "    const int kc = t * kDecTile + 16 * warp;   // the chunk's first "
        "key\n    if (kc < 0) {")]),
    # K8: two producer warps instead of one
    "k8_prod2": ((K8,), [(f"{K8}.cu", "constexpr int K8_PRODUCERS = 1;",
                          "constexpr int K8_PRODUCERS = 2;")]),
    # K8: clusters of at most the portable 8 blocks
    "k8_c8": ((K8,), [(PLAN, "constexpr int kDecCluster = 16;",
                       "constexpr int kDecCluster = 8;")]),
    # the launch alone: every block returns at once (same grid, clusters
    # and shared memory)
    "k6_empty": ((K6,), [(f"{K6}.cu", "  using S = I4Shape<NT>;\n  constexpr",
                          "  if (M > 0) return;\n  using S = I4Shape<NT>;\n"
                          "  constexpr")]),
    "k8_empty": ((K8,), [(f"{K8}.cu", "  using S = DecShape<T>;\n  extern",
                          "  if (Hq > 0) return;\n  using S = DecShape<T>;\n"
                          "  extern")]),
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
    """Wait for a variant's builds and make the wrappers launch it."""
    for lib, (proc, path) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {path}:\n{out}")
        cdll = ctypes.CDLL(path)
        for sym, argtypes in build.ARGTYPES.items():
            if hasattr(cdll, sym):
                getattr(cdll, sym).argtypes = argtypes
                getattr(cdll, sym).restype = ctypes.c_int
        build._libs[lib] = cdll


def cases(torch) -> dict:
    """{case: (library, [calls], calls timed)}: K1 at batch 1 and 9
    (SigLIP), K2 at the prefill buckets 768 and 2560 over a 4096-slot cache
    from position 300, K3, K4 and K5 at the train step's shape; K6 at every int4
    projection's decode shape and gate/up at 128 rows, K8 at 300 and 4096
    live keys of a 4096-slot cache, each over operand copies past 2.5x the
    50 MB L2 cache."""
    from streamvln_tpu_torch.ops import decode_attention as da
    from streamvln_tpu_torch.ops import flash_attention as fa
    from streamvln_tpu_torch.ops import int4_matmul as i4
    from streamvln_tpu_torch.ops import vit_attention as va
    g = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda") \
            .to(torch.bfloat16)
    out = {}
    for B in (1, 9):
        q, k, v = (rnd(B, 729, 16, 72) for _ in range(3))
        out[f"K1 B={B}"] = ("vit_attention", [
            lambda q=q, k=k, v=v: va.vit_attention(q, k, v)], 10)
    kp = torch.arange(4096, device="cuda", dtype=torch.int32)[None]
    for sq in (768, 2560):
        q, k, v = rnd(1, sq, 28, 128), rnd(1, 4, 4096, 128), \
            rnd(1, 4, 4096, 128)
        qp = (300 + torch.arange(sq, device="cuda", dtype=torch.int32))[None]
        out[f"K2 Sq={sq}"] = ("flash_attention", [
            lambda q=q, k=k, v=v, qp=qp: fa.flash_attention(
                q, k, v, qp, kp, kv_major=True)], 10)
    S, n = 4096, 3900
    q, k, v = rnd(2, S, 28, 128), rnd(2, S, 4, 128), rnd(2, S, 4, 128)
    pos = torch.arange(S, device="cuda", dtype=torch.int32)
    qp = torch.where(pos < n, pos, 0)[None].repeat(2, 1).contiguous()
    kp3 = torch.where(pos < n, pos, fa.INVALID_POS)[None].repeat(2, 1) \
        .contiguous()
    out["K3"] = ("flash_attention", [
        lambda q=q, k=k, v=v, qp=qp: fa.flash_attention_lse(
            q, k, v, qp, kp3)], 10)
    o, lse = fa.flash_attention_lse(q, k, v, qp, kp3)
    do = rnd(2, S, 28, 128)
    bwd = (q, k, v, do, lse, fa._dsum(do, o), qp, kp3)
    out["K4"] = (BWD, [lambda: fa.flash_bwd_dq(*bwd)], 10)
    out["K5"] = (BWD, [lambda: fa.flash_bwd_dkv(*bwd)], 10)
    for name, din, dout, M in (("qkv", 3584, 4608, 1), ("o", 3584, 3584, 1),
                               ("gu", 3584, 37888, 1),
                               ("down", 18944, 3584, 1),
                               ("lm_head", 3584, 152064, 1),
                               ("gu128", 3584, 37888, 128)):
        n = max(1, -(-int(125e6) // (din * dout // 2 + din * dout // 16)))
        ws = [(torch.randint(0, 256, (1, din // 2, dout), generator=g,
                             device="cuda", dtype=torch.uint8),
               torch.rand((1, din // 64, dout), generator=g, device="cuda")
               * 0.01) for _ in range(n)]
        x = rnd(M, din)
        out[f"K6 {name}"] = (K6, [
            lambda w=w, s=s, x=x: i4.int4_matmul(x, w, s, 0)
            for w, s in ws], 24)
    dq = rnd(28, 1, 1, 28, 128)
    dk, dv = rnd(28, 1, 4, 4096, 128), rnd(28, 1, 4, 4096, 128)
    for n in (300, 4096):
        lens = torch.full((1,), n, dtype=torch.int32, device="cuda")
        out[f"K8 {n}"] = (K8, [
            lambda i=i, lens=lens: da.decode_attention(dq[i], dk[i], dv[i],
                                                       lens)
            for i in range(28)], 56)
    return out


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("ablate: needs a CUDA card", file=sys.stderr)
        return 2
    names = argv or list(VARIANTS)
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        print(f"ablate: unknown variants {unknown}", file=sys.stderr)
        return 2
    builds = {n: build_variant(n) for n in names}
    work = cases(torch)
    print(torch.cuda.get_device_name(0), subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())
    for n in names:
        use_variant(builds[n])
        libs = VARIANTS[n][0]
        print(json.dumps({"variant": n, "ms": {
            c: round(device_ms(torch, fns, calls), 4)
            for c, (lib, fns, calls) in work.items() if lib in libs}}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
