"""The attention and int4 kernels' rows on the settled yardstick, alone.

    python3 tools/yardstick.py [--tree DIR] [group ...]

Builds the kernel libraries and runs chip_smoke.py's kernel checks (each
against its plain version, timed on `chip_smoke.graph_ms` beside its
library call, and by torch.profiler device time) without the rest of the
script. Groups (default all):
  k1      K1 at the SigLIP batches the main paths send (1, 8, 16, 28, 32)
          and at chip_smoke.VIT_ZOO_SHAPES;
  int4    K6 at every int4 projection's shape and K7 at its shapes
          (beside a copy of its output's size);
  anyres  K2 without a cache at anyres's two prefills (ANYRES_SQ);
  d128    the positioned forward at head dim 128 (Qwen2-7B's 28/4 heads):
          K2 at the prefill buckets 768 and 2560 over the 4096-slot
          KV-head-major cache from position 300 (SDPA on the live prefix
          beside it), K2 at 768 over the cache cut to its live prefix
          (1,068 slots: the same output, so the gap is the walk over the
          key tiles no query sees), K3 (with K4/K5) at the train step's
          shape (B=2 S=4096, 3,900 valid; causal SDPA over the valid rows
          beside it), K2 uncached at ANYRES_SQ, and K3 at S=32768 (32,000
          valid) by CUDA events (LONG_K3_CALLS calls);
  d256    K2 and K3 at head dim 256 (8/1 heads) over the 4096-slot cache
          at Sq 768 and 2560, and K3 (with K4/K5) at Gemma-2B's training
          shape (B=2 S=4096, 3,900 valid);
  cross   the two int4 routes at 16-256 rows (CROSS_ROWS) of gate/up, o
          and down (CROSS_SHAPES): K6 (up to 128 rows) against K7 plus
          the f32-accumulating product (`int4_prefill_matmul`), each over
          weight copies past the L2 cache, graph-timed (the place of
          KERNEL_MAX_ROWS).
Prints the card and one JSON line per record, and writes them all to
chiprun_out/yardstick.json. With `--tree DIR` the kernels and wrappers
are another checkout's (its `streamvln_tpu_torch/`, e.g. the parent
commit unpacked with `git archive`), checked and timed by this tree's
chip_smoke.py. Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TREE = sys.argv[2] if __name__ == "__main__" and sys.argv[1:2] == \
    ["--tree"] else HERE
sys.path.insert(0, os.path.abspath(TREE))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

GROUPS = ("k1", "int4", "anyres", "d128", "d256", "cross")
SIGLIP_BATCHES = (1, 8, 16, 28, 32)
# the uncached prefill lengths of chip_smoke's two anyres images
ANYRES_SQ = (3032, 3046)
CROSS_ROWS = (16, 32, 64, 128, 256)
LONG_K3_CALLS = 5
CROSS_SHAPES = (("gu", 3584, 37888), ("o", 3584, 3584),
                ("down", 18944, 3584))


def crossover(torch, i4, quant) -> list:
    """K6 against K7 plus the product at CROSS_ROWS rows of CROSS_SHAPES:
    graph-timed ms of each route per call (K6 only up to its 128 rows)."""
    cs = chip_smoke
    recs = []
    for i, (name, din, dout) in enumerate(CROSS_SHAPES):
        wp, s = cs.int4_weight(torch, quant, din, dout, 70 + i)
        n = cs._copies(wp.numel() * 5)
        ops = [(wp, s)] + [(wp.clone(), s.clone()) for _ in range(n - 1)]
        for M in CROSS_ROWS:
            g = torch.Generator(device="cuda").manual_seed(M)
            x = torch.randn((M, din), generator=g, device="cuda") \
                .to(torch.bfloat16)
            what = f"{name} M={M} din={din} dout={dout}"
            k7 = cs.graph_ms(torch, [
                lambda a=a, b=b: i4.int4_prefill_matmul(x, a, b, 0)
                for a, b in ops], 0.0, f"K7 + product {what}")
            k6 = cs.graph_ms(torch, [
                lambda a=a, b=b: i4.int4_matmul(x, a, b, 0)
                for a, b in ops], 0.0, f"K6 {what}") \
                if M <= i4.KERNEL_MAX_ROWS else {"ms": None}
            recs.append({"shape": what, "M": M, "k6_ms": k6["ms"],
                         "k7_product_ms": k7["ms"], "rotation": n})
        del ops, wp, s
    return recs


def long_k3(torch, fa) -> dict:
    """K3 at the 32k step's attention shape (B=1, S=32768, 32,000 valid,
    28/4 heads, D=128, the training layout) by CUDA events over
    LONG_K3_CALLS calls, as phase 9c times it; phase 9c holds it against
    chunked_attention."""
    cs = chip_smoke
    S, n = cs.LONG_S, cs.LONG_VALID
    g = torch.Generator(device="cuda").manual_seed(9)
    q, k, v = (torch.randn((1, S, h, 128), generator=g, device="cuda")
               .to(torch.bfloat16) for h in (28, 4, 4))
    q_pos, k_pos = cs.train_positions(torch, 1, S, n, "cuda")
    ms = cs.time_ms(torch, lambda: fa.flash_attention_lse(q, k, v, q_pos,
                                                          k_pos),
                    iters=LONG_K3_CALLS)
    # query 7 sees no key (8 pairs less); padded queries see key 0
    pairs = (n * (n + 1) // 2 - 8 + (S - n)) * 28
    nbytes = 2 * (2 * S * 28 * 128 + 2 * S * 4 * 128) + 4 * 28 * S + 8 * S
    b_ms, b_by = cs.bound(4.0 * pairs * 128, nbytes)
    return {"kernel": "flash_attention_lse", "shape": f"B=1 S={S} "
            f"valid={n} Hq=28 Hkv=4 D=128 bf16 [B,S,Hkv,D]", "event_ms": ms,
            "calls": LONG_K3_CALLS, "bound_ms": b_ms, "bound_by": b_by}


def run(torch, group: str) -> list:
    import torch.nn.functional as F

    from streamvln_tpu_torch.models import quant
    from streamvln_tpu_torch.ops import flash_attention as fa
    from streamvln_tpu_torch.ops import int4_matmul as i4
    from streamvln_tpu_torch.ops import vit_attention as va
    cs = chip_smoke
    if group == "k1":
        return [cs.check_vit(torch, F, va, b) for b in SIGLIP_BATCHES] + [
            cs.check_vit(torch, F, va, B, S=S, H=H, D=D)
            for B, S, H, D in cs.VIT_ZOO_SHAPES]
    if group == "int4":
        k6, k7 = cs.check_int4(torch, i4, quant)
        return k6 + k7
    if group == "cross":
        return crossover(torch, i4, quant)
    if group == "anyres":
        return [cs.check_flash_uncached(torch, F, fa, s) for s in ANYRES_SQ]
    if group == "d128":
        recs = [cs.check_flash(torch, F, fa, sq, graph=True)
                for sq in (768, 2560)]
        recs.append(cs.check_flash(torch, F, fa, 768, graph=True, live=True))
        train = cs.check_training_kernels(torch, F, fa, graph=True)
        recs += [dict(train[n], kernel=n) for n in train]
        recs += [cs.check_flash_uncached(torch, F, fa, s) for s in ANYRES_SQ]
        return recs + [long_k3(torch, fa)]
    recs = [cs.check_flash(torch, F, fa, sq, Hq=8, Hkv=1, D=256, lse=lse,
                           graph=True)
            for sq in (768, 2560) for lse in (False, True)]
    train = cs.check_training_kernels(torch, F, fa, Hq=8, Hkv=1, D=256,
                                      graph=True)
    return recs + [dict(train[n], kernel=n) for n in train]


def main(argv) -> int:
    import torch
    if argv[:1] == ["--tree"]:
        argv = argv[2:]
    if not torch.cuda.is_available():
        print("yardstick: needs a CUDA card", file=sys.stderr)
        return 2
    groups = argv or list(GROUPS)
    unknown = [g for g in groups if g not in GROUPS]
    if unknown:
        print(f"yardstick: unknown groups {unknown}", file=sys.stderr)
        return 2
    from streamvln_tpu_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    card = chip_smoke.card_line()
    print(card, flush=True)
    out = {"card": card, "tree": TREE}
    for g in groups:
        out[g] = run(torch, g)
        for r in out[g]:
            print(json.dumps({"group": g, **r}, default=str), flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "yardstick.json"), "w") as f:
        json.dump(out, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
