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
  bwd     the backward beside causal SDPA's over the valid rows alone (dQ,
          dK and dV in one call, its forward outside the timed window; the
          faster of GQA without copies and K/V repeated per query head,
          with the backend the dispatcher took): K4, K5 and K4 + K5 as one
          call, graph-timed at the 7B's training shape (B=2 S=4096, 3,900
          valid, 28/4 heads, D=128) and Gemma-2B's (8/1 heads, D=256), and
          by CUDA events at the 32k step's (B=1 S=32768, 32,000 valid,
          LONG_K3_CALLS calls); K3 beside causal SDPA's forward over the
          valid rows at Gemma-2B's shape (graph-timed) and at 32k (events).
          Bounds: 6, 8 and 10 x D x visible pairs for K4, K5 and K4 + K5
          (10 for the library too: the least work for the three gradients),
          4 for K3 and its library;
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

GROUPS = ("k1", "int4", "anyres", "d128", "d256", "cross", "bwd")
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


def sdpa_backend(torch, q, k, v, gqa: bool) -> str:
    """The backend the SDPA dispatcher takes for a causal call on these
    tensors ([B, H, S, D], requiring grad)."""
    from torch.nn.attention import SDPBackend
    try:
        return SDPBackend(torch._fused_sdp_choice(
            q, k, v, is_causal=True, enable_gqa=gqa)).name
    except (RuntimeError, TypeError, ValueError) as e:   # a label only
        return f"not known ({type(e).__name__}: {e})"


def causal_sdpa(torch, F, q, k, v, dout, n, G, stream):
    """Causal SDPA over the first n rows of [B, S, H, D] q/k/v (dO for the
    backward), in [B, H, n, D]: for each of GQA without copies and K/V
    repeated per query head, (variant, backend, forward call, backward
    call). The backward call takes dQ, dK and dV of one forward made
    beforehand on `stream` (retain_graph; autograd runs a backward on its
    forward's stream), so the forward is outside its time."""
    out = []
    for variant in ("enable_gqa", "repeated"):
        gqa = variant == "enable_gqa"
        qt, kt, vt = (x[:, :n].transpose(1, 2) for x in (q, k, v))
        if not gqa:
            kt, vt = (x.repeat_interleave(G, dim=1) for x in (kt, vt))
        qt, kt, vt = (x.contiguous().requires_grad_() for x in (qt, kt, vt))
        dot = dout[:, :n].transpose(1, 2).contiguous()

        def fwd(qt=qt, kt=kt, vt=vt, gqa=gqa):
            with torch.no_grad():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=gqa)
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                               enable_gqa=gqa)
        torch.cuda.synchronize()

        def bwd(o=o, qt=qt, kt=kt, vt=vt, dot=dot):
            return torch.autograd.grad(o, (qt, kt, vt), dot,
                                       retain_graph=True)
        out.append((variant, sdpa_backend(torch, qt, kt, vt, gqa), fwd,
                    bwd))
    return out


def backward_rows(torch, F, fa, B, S, n, Hq, Hkv, D, events=False) -> list:
    """K4, K5, K4 + K5 (one call) and K3 at one training shape beside
    causal SDPA's backward and forward over the n valid rows (the faster
    variant; both logged): graph-timed (graph_ms over GRAPH_CALLS calls),
    or by CUDA events over LONG_K3_CALLS calls with `events`."""
    cs = chip_smoke
    g = torch.Generator(device="cuda").manual_seed(11)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda") \
            .to(torch.bfloat16)
    q, dout = rnd(B, S, Hq, D), rnd(B, S, Hq, D)
    k, v = rnd(B, S, Hkv, D), rnd(B, S, Hkv, D)
    q_pos, k_pos = cs.train_positions(torch, B, S, n, "cuda")
    out, lse = fa.flash_attention_lse(q, k, v, q_pos, k_pos)
    args = (q, k, v, dout, lse, fa._dsum(dout, out), q_pos, k_pos)
    # visible (query, key) pairs x heads: the valid rows' causal triangle,
    # the padded queries (position 0) seeing key 0, query 7 of the last
    # row none
    pairs = float(B * (n * (n + 1) // 2 + (S - n)) - 8) * Hq
    e, rows = 2, B * Hq * S * 4
    qb, kb, pos_b = B * S * Hq * D * e, B * S * Hkv * D * e, 2 * B * S * 4
    shape = (f"B={B} S={S} valid={n} Hq={Hq} Hkv={Hkv} D={D} bf16 "
             f"[B,S,Hkv,D]")
    kern = {
        "flash_bwd_dq": (6, 3 * qb + 2 * kb + 2 * rows + pos_b,
                         lambda: fa.flash_bwd_dq(*args)),
        "flash_bwd_dkv": (8, 2 * qb + 4 * kb + 2 * rows + pos_b,
                          lambda: fa.flash_bwd_dkv(*args)),
        "flash_bwd_dq+dkv": (10, 3 * qb + 4 * kb + 2 * rows + pos_b,
                             lambda: (fa.flash_bwd_dq(*args),
                                      fa.flash_bwd_dkv(*args))),
        "flash_attention_lse": (4, 2 * qb + 2 * kb + rows + pos_b,
                                lambda: fa.flash_attention_lse(
                                    q, k, v, q_pos, k_pos))}

    def timed(fn, b_ms, what, stream=None):
        if events:
            return cs.time_ms(torch, fn, iters=LONG_K3_CALLS), None
        r = cs.graph_ms(torch, [fn] * cs.GRAPH_CALLS, b_ms, what,
                        stream=stream)
        return r["ms"], r
    lib = {}
    side = torch.cuda.Stream()
    for variant, backend, fwd, bwd in causal_sdpa(torch, F, q, k, v, dout,
                                                  n, Hq // Hkv, side):
        for what, fn, mult in (("bwd", bwd, 10), ("fwd", fwd, 4)):
            b_ms, _ = cs.bound(mult * D * n * (n + 1) / 2 * B * Hq, 0)
            ms, r = timed(fn, b_ms, f"causal SDPA {what} {variant}",
                          side)
            lib.setdefault(what, []).append(
                {"variant": variant, "backend": backend, "ms": ms,
                 "graph": r})
        cs.log(f"bwd SDPA {variant} ({backend}) {shape}: "
               f"{json.dumps({w: lib[w][-1]['ms'] for w in lib})}")
    recs = []
    for name, (mult, nbytes, fn) in kern.items():
        b_ms, b_by = cs.bound(mult * D * pairs, nbytes)
        ms, r = timed(fn, b_ms, f"{name} at {shape}")
        side = lib["fwd" if name == "flash_attention_lse" else "bwd"]
        best = min((x for x in side if x["ms"] is not None),
                   key=lambda x: x["ms"], default=None)
        recs.append({
            "kernel": name, "shape": shape,
            "timing": "cuda events" if events else "graph", "ms": ms,
            "graph": r, "bound_ms": b_ms, "bound_by": b_by,
            "flops": mult * D * pairs, "bytes": nbytes,
            "library": "causal F.scaled_dot_product_attention over the "
                       f"{n} valid rows, "
                       + ("forward" if name == "flash_attention_lse" else
                          "backward (dQ, dK, dV in one call)"),
            "library_ms": best["ms"] if best else None,
            "library_variant": best["variant"] if best else None,
            "library_backend": best["backend"] if best else None,
            "library_all": side,
            "factor": ms / best["ms"] if best and ms else None})
    return recs


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
    if group == "bwd":
        return backward_rows(torch, F, fa, 2, 4096, 3900, 28, 4, 128) + \
            backward_rows(torch, F, fa, 2, 4096, 3900, 8, 1, 256) + \
            backward_rows(torch, F, fa, 1, cs.LONG_S, cs.LONG_VALID, 28, 4,
                          128, events=True)
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
