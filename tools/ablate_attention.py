"""Ablations of the port's attention forward
(`streamvln_tpu_torch/csrc/attention_fwd.cuh`) on the card.

    python3 tools/ablate_attention.py [variant ...]

Builds copies of the forward with one part taken out -- the
exponentials, the S = Q K^T products, the P V products, the 16-column
head-dim tail chunk, the two consumer warpgroups' turn-taking -- under
`streamvln_tpu_torch/_build/ablate/<variant>/`, and times K1, K2 and K3
through their wrappers at the main path's shapes by device time
(torch.profiler), beside the kernel as it is ("base"). An ablated kernel
computes wrong results: the point is how much of the time each part
holds. Prints the card and one JSON line per variant. Needs a CUDA card
and nvcc. A variant's edits are exact text of the forward: when the
forward changes, a variant that no longer matches stops with an error.
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
from streamvln_tpu_torch.kernels import build  # noqa: E402

FWD = "attention_fwd.cuh"
VARIANTS = {
    "base": [],
    # ex2 -> a multiply: the MUFU pipe's share
    "noexp": [("  float y;\n  asm(\"ex2.approx.ftz.f32 %0, %1;\\n\" : \"=f\"(y) "
               ": \"f\"(x));\n  return y;", "  return x * 0.5f;")],
    "noqk": [("      wgmma_ss<S::BN>(s, desc_add(dq,",
              "      if (0) wgmma_ss<S::BN>(s, desc_add(dq,"),
             ("  if (S::TAIL) wgmma_ss<S::BN>(s, dqt, dkt, 1);", "")],
    "nopv": [("      wgmma_rs_n64(o + 32 * c, p[kk],",
              "      if (0) wgmma_rs_n64(o + 32 * c, p[kk],"),
             ("      wgmma_rs_n16(o + 32 * S::NW, p[kk], "
              "desc_add(dvt, kk * 16 * 32));", "      ;")],
    # K1 only (D=72): the 16-column chunk in both products
    "notail": [("  if (S::TAIL) wgmma_ss<S::BN>(s, dqt, dkt, 1);", ""),
               ("      wgmma_rs_n16(o + 32 * S::NW, p[kk], "
                "desc_add(dvt, kk * 16 * 32));", "      ;")],
    "noping": [("named_sync(1 + cw, 256);", ""),
               ("named_arrive(2 - cw, 256);", ""),
               ("if (cw == 1) named_arrive(1, 256);", "")],
}
LIBS = ("vit_attention", "flash_attention")


def build_variant(name: str) -> dict:
    """Copy csrc/, apply the variant's edits to the forward (each must
    match the source exactly) and start one nvcc per library. Returns
    {lib: (process, path)}."""
    d = os.path.join(build.BUILD_DIR, "ablate", name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(build.CSRC, d)
    path = os.path.join(d, FWD)
    with open(path) as f:
        src = f.read()
    for old, new in VARIANTS[name]:
        if old not in src:
            raise RuntimeError(f"{name}: the forward no longer contains "
                               f"{old!r}; update the variant")
        src = src.replace(old, new)
    with open(path, "w") as f:
        f.write(src)
    procs = {}
    for lib in LIBS:
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


def device_ms(torch, fn, calls=10) -> float:
    """Summed device time of the kernels `fn` launches, per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.end - e.time_range.start for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e3 / calls


def cases(torch):
    """The main path's shapes: K1 at batch 1 and 9 (SigLIP), K2 at the
    prefill buckets 768 and 2560 over a 4096-slot cache from position
    300, K3 at the train step's shape."""
    from streamvln_tpu_torch.ops import flash_attention as fa
    from streamvln_tpu_torch.ops import vit_attention as va
    g = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda") \
            .to(torch.bfloat16)
    out = {}
    for B in (1, 9):
        q, k, v = (rnd(B, 729, 16, 72) for _ in range(3))
        out[f"K1 B={B}"] = (lambda q=q, k=k, v=v: va.vit_attention(q, k, v))
    kp = torch.arange(4096, device="cuda", dtype=torch.int32)[None]
    for sq in (768, 2560):
        q, k, v = rnd(1, sq, 28, 128), rnd(1, 4, 4096, 128), \
            rnd(1, 4, 4096, 128)
        qp = (300 + torch.arange(sq, device="cuda", dtype=torch.int32))[None]
        out[f"K2 Sq={sq}"] = (lambda q=q, k=k, v=v, qp=qp: fa.flash_attention(
            q, k, v, qp, kp, kv_major=True))
    S, n = 4096, 3900
    q, k, v = rnd(2, S, 28, 128), rnd(2, S, 4, 128), rnd(2, S, 4, 128)
    pos = torch.arange(S, device="cuda", dtype=torch.int32)
    qp = torch.where(pos < n, pos, 0)[None].repeat(2, 1).contiguous()
    kp3 = torch.where(pos < n, pos, fa.INVALID_POS)[None].repeat(2, 1) \
        .contiguous()
    out["K3"] = lambda: fa.flash_attention_lse(q, k, v, qp, kp3)
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
        print(json.dumps({"variant": n, "ms": {
            c: round(device_ms(torch, fn), 4) for c, fn in work.items()}}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
