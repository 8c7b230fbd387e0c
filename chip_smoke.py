"""Chip smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):
  1. check for a card, build every CUDA kernel from `streamvln_tpu_torch/
     csrc` (one nvcc per source, all at once), print the build seconds and
     the card's name and power limit;
  2. hold each kernel against its plain PyTorch version at the main path's
     shapes in bf16 (max abs error vs tolerance), and time the kernel, the
     plain version and, as a yardstick only, one PyTorch library call on
     the same work (the port never calls it);
  3. drive the main path at full width: streamvln_7b (SigLIP-so400m +
     Qwen2-7B) with random bf16 weights made on the card, a ByteTokenizer
     and a 4096-slot KV cache; VLNAgent.step over 480x640 frames for steps
     0..32 with a model call every 4th step (9 calls, crossing the window
     reset with <memory> at step 32); check tokens, logits, cache
     bookkeeping and that both kernels' launch counts grew as the path
     requires; then check the first call's prefill logits against the
     repo's own dense attention path on the same weights;
     One more (mid-window) agent call runs under torch.profiler: device
     busy time (union of kernel intervals), idle share against the median
     unprofiled mid-window call, kernel launches and the top kernels by
     device time (in chiprun_out/chip_smoke.json);
  4. print the kernels JSON line, the card line, and the result line.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

H100_BF16_FLOPS = 989e12      # dense tensor-core peak, SXM data sheet
H100_BYTES_PER_S = 3.35e12    # HBM3
# kernel vs plain version, elementwise |out - ref| <= ATOL + RTOL * |ref|:
# RTOL is two bf16 ulps (one for each side's output rounding), ATOL the
# bf16 rounding of P summed over the keys on outputs near 0 (every row
# here sees 301 keys or more, so that rounding averages out; the CUDA unit
# tests, with rows that see few keys, bound it without averaging)
KERNEL_ATOL, KERNEL_RTOL = 1e-3, 2.0 ** -6
# kernels vs dense attention through 28 bf16 layers: rounding drifts,
# the direction of the logits must not
REF_MIN_COSINE = 0.99


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(log_text: str) -> str:
    """'DP=<head dim pad>: <regs> regs, <smem> B smem' per instantiation,
    from nvcc's -Xptxas -v output."""
    import re
    out = []
    for dp, body in re.findall(r"attention_tile_kernelILi(\d+)E.*?'(.*?)"
                               r"Compile time", log_text, re.S):
        m = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", body, re.S)
        spill = re.search(r"(\d+) bytes spill stores", body)
        if m:
            out.append(f"DP={dp}: {m.group(1)} regs, {m.group(2)} B smem, "
                       f"{spill.group(1) if spill else '?'} B spill")
    return "; ".join(out) or "no ptxas output (library was already built)"


def time_ms(torch, fn, iters=10, warmup=2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float):
    t_ops = flops / H100_BF16_FLOPS * 1e3
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def compare(out, ref) -> dict:
    """Max abs error, the worst share of the elementwise tolerance used,
    and the outputs' mean magnitude (what the tolerance is set against)."""
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    tol = KERNEL_ATOL + KERNEL_RTOL * ref.abs()
    return {"max_abs_err": err.max().item(),
            "tol_share": (err / tol).max().item(),
            "ref_mean_abs": ref.abs().mean().item()}


def tol_text(c: dict) -> str:
    return (f"max_abs_err {c['max_abs_err']:.3e} ({c['tol_share']:.3f} of "
            f"the tolerance {KERNEL_ATOL} + {KERNEL_RTOL:.4g}*|ref|; mean "
            f"|ref| {c['ref_mean_abs']:.3e})")


def check_vit(torch, F, va, B, rng_seed=0):
    S, H, D = 729, 16, 72
    g = torch.Generator(device="cuda").manual_seed(rng_seed)
    q, k, v = (torch.randn((B, S, H, D), generator=g, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    out = va.vit_attention(q, k, v)
    torch.cuda.synchronize()
    c = compare(out, va.vit_attention_plain(q, k, v))
    ms = time_ms(torch, lambda: va.vit_attention(q, k, v))
    plain = time_ms(torch, lambda: va.vit_attention_plain(q, k, v), iters=3)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    lib = time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt))
    b_ms, b_by = bound(4.0 * S * S * D * H * B, 4.0 * B * S * H * D * 2)
    rec = {"shape": f"B={B} S={S} H={H} D={D} bf16", **c,
           "ms": ms, "plain_ms": plain, "library_ms": lib,
           "bound_ms": b_ms, "bound_by": b_by}
    log(f"K1 vit_attention {rec['shape']}: {tol_text(c)} kernel {ms:.4f} "
        f"ms plain {plain:.4f} ms sdpa {lib:.4f} ms bound {b_ms:.4f} ms "
        f"({b_by})")
    if not c["tol_share"] <= 1.0:
        raise AssertionError(f"vit_attention disagrees: {c}")
    return rec


def check_flash(torch, F, fa, Sq, cap=4096, off=300, seed=1):
    B, Hq, Hkv, D = 1, 28, 4, 128
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, Sq, Hq, D), generator=g, device="cuda") \
        .to(torch.bfloat16)
    k, v = (torch.randn((B, Hkv, cap, D), generator=g, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    q_pos = (off + torch.arange(Sq, device="cuda", dtype=torch.int32))[None]
    q_pos[0, 7] = -1                      # a row that sees no key
    k_pos = torch.arange(cap, device="cuda", dtype=torch.int32)[None] \
        .contiguous()
    out = fa.flash_attention(q, k, v, q_pos, k_pos, kv_major=True)
    torch.cuda.synchronize()
    ref = fa.flash_attention_plain(q, k, v, q_pos, k_pos, kv_major=True)
    if not torch.all(out[0, 7] == 0):
        raise AssertionError("flash_attention: row with no visible key "
                             "is not zero")
    c = compare(out, ref)
    ms = time_ms(torch, lambda: fa.flash_attention(q, k, v, q_pos, k_pos,
                                                   kv_major=True))
    plain = time_ms(torch, lambda: fa.flash_attention_plain(
        q, k, v, q_pos, k_pos, kv_major=True), iters=3)
    # yardstick on the live prefix only (the slots the kernel reads),
    # GQA without copies where this torch has enable_gqa
    k_live = int(q_pos.max().item()) + 1      # cache slots any query sees
    mask = (k_pos[:, None, :k_live] <= q_pos[:, :, None])[:, None]
    kl, vl = k[:, :, :k_live], v[:, :, :k_live]
    qt = q.transpose(1, 2).contiguous()
    if torch.__version__ >= "2.5":
        lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kl, vl, attn_mask=mask, enable_gqa=True))
    else:
        kx, vx = (x.repeat_interleave(Hq // Hkv, dim=1) for x in (kl, vl))
        lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kx, vx, attn_mask=mask))
    pairs = mask.sum().item()                 # visible (query, key) pairs
    nbytes = 2 * (2 * B * Sq * Hq * D + 2 * B * Hkv * k_live * D) \
        + 4 * (B * Sq + B * cap)
    b_ms, b_by = bound(4.0 * pairs * D * Hq, nbytes)
    rec = {"shape": f"Sq={Sq} Hq={Hq} Hkv={Hkv} D={D} kv_major "
                    f"cache={cap} offset={off} bf16",
           **c, "ms": ms, "plain_ms": plain,
           "library_ms": lib, "bound_ms": b_ms, "bound_by": b_by}
    log(f"K2 flash_attention {rec['shape']}: {tol_text(c)} kernel {ms:.4f} "
        f"ms plain {plain:.4f} ms sdpa {lib:.4f} ms bound {b_ms:.4f} ms "
        f"({b_by})")
    if not c["tol_share"] <= 1.0:
        raise AssertionError(f"flash_attention disagrees: {c}")
    return rec


def profile_call(torch, agent, frame, instruction, unprofiled_ms) -> dict:
    """One agent model call under torch.profiler: device busy time as the
    union of kernel intervals, and kernels ranked by device time. The idle
    share is taken against `unprofiled_ms` (the median wall time of the
    same kind of call without the profiler, whose overhead would inflate
    it) and, for reference, against the profiled call's own wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        agent.step(0, frame, instruction, run_model=True)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy_us, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy_us += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy_us += cur_e - cur_s
    by_name = {}
    for s, e, name in sorted((e.time_range.start, e.time_range.end, e.name)
                             for e in prof.events()
                             if e.device_type == DeviceType.CUDA):
        t, n = by_name.get(name, (0.0, 0))
        by_name[name] = (t + (e - s) / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    busy = busy_us / 1e3
    rec = {"wall_ms_profiled": wall, "wall_ms_unprofiled": unprofiled_ms,
           "device_busy_ms": busy,
           "device_idle_share": 1.0 - busy / unprofiled_ms,
           "device_idle_share_profiled_wall": 1.0 - busy / wall,
           "kernel_launches": len(spans),
           "top": [{"name": n[:120], "ms": t, "count": c}
                   for n, (t, c) in top]}
    log(f"profile: device busy {busy:.2f} ms; idle share "
        f"{rec['device_idle_share']:.3f} of the unprofiled median wall "
        f"{unprofiled_ms:.2f} ms ({rec['device_idle_share_profiled_wall']:.3f}"
        f" of the profiled wall {wall:.2f} ms); {len(spans)} kernel launches")
    for r in rec["top"]:
        log(f"  {r['ms']:9.3f} ms {r['count']:6d}x {r['name']}")
    return rec


def main() -> int:
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one GPU",
              file=sys.stderr)
        return 2
    from streamvln_tpu_torch.agent import VLNAgent
    from streamvln_tpu_torch.configs import streamvln_7b
    from streamvln_tpu_torch.data.tokenizer import ByteTokenizer
    from streamvln_tpu_torch.kernels import build
    from streamvln_tpu_torch.ops import flash_attention as fa
    from streamvln_tpu_torch.ops import vit_attention as va
    from streamvln_tpu_torch.streaming.engine import StreamingEngine
    from streamvln_tpu_torch.weights import init

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. build
    t0 = time.perf_counter()
    build.build_all()
    log(f"phase 1: built {list(build.KERNELS)} in "
        f"{time.perf_counter() - t0:.2f} s")
    for name in build.KERNELS:
        log(f"  {name}: {ptxas_summary(build.build_logs.get(name, ''))}")
    card = card_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. kernels against their plain versions at main-path shapes
    vit = [check_vit(torch, F, va, B) for B in (1, 9)]
    flash = [check_flash(torch, F, fa, Sq) for Sq in (768, 2560)]

    # 3. the main path at full width
    cfg = streamvln_7b()
    t0 = time.perf_counter()
    params = init(cfg, torch.Generator(device="cuda").manual_seed(0),
                  device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    log(f"phase 3: streamvln_7b bf16 weights on the card in "
        f"{time.perf_counter() - t0:.2f} s "
        f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB)")
    tok = ByteTokenizer()
    engine = StreamingEngine(params, cfg, cache_capacity=4096,
                             max_new_tokens=16, stop_ids=(tok.im_end_id,))
    agent = VLNAgent(engine, tok)
    calls = []
    collect = engine.collect

    def recording_collect(handle):
        out = collect(handle)
        calls.append({"tokens": out[0], "phase_ms": engine.last_phase_ms,
                      "logits_finite": bool(torch.isfinite(
                          engine.last_logits).all())})
        return out
    engine.collect = recording_collect

    frames = np.random.default_rng(0).integers(0, 256, (33, 480, 640, 3),
                                               np.uint8)
    instruction = "walk past the sofa and stop at the kitchen door"
    # warm-up call on a separate engine state, then reset (not counted)
    agent.step(0, frames[0], instruction, run_model=True)
    agent.reset_memory(0)
    calls.clear()
    torch.cuda.synchronize()

    va.launches = 0
    fa.launches = 0
    wall = []
    for step in range(33):
        run = step % cfg.num_future_steps == 0
        t0 = time.perf_counter()
        actions, _, _ = agent.step(0, frames[step], instruction,
                                   run_model=run)
        if run:
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
            if actions is None or not actions:
                raise AssertionError(f"step {step}: no actions")
            if engine.envs[0].kv_length != int(engine.cache.length[0]):
                raise AssertionError(
                    f"step {step}: KV length {int(engine.cache.length[0])} "
                    f"!= bookkeeping {engine.envs[0].kv_length}")
    n_vit, n_flash = va.launches, fa.launches
    n_calls = len(calls)
    if n_calls != 9:
        raise AssertionError(f"expected 9 model calls, got {n_calls}")
    for i, c in enumerate(calls):
        if not c["tokens"] or not all(0 <= t < cfg.llm.vocab_size
                                      for t in c["tokens"]):
            raise AssertionError(f"call {i}: bad tokens {c['tokens']}")
        if not c["logits_finite"]:
            raise AssertionError(f"call {i}: non-finite logits")
        vis, pre, dec = c["phase_ms"]
        n_dec = max(len(c["tokens"]) - 1, 1)
        log(f"call {i}: wall {wall[i]:.2f} ms = vision {vis:.2f} + prefill "
            f"{pre:.2f} + decode {dec:.2f} ms ({len(c['tokens'])} tokens, "
            f"{dec / n_dec:.2f} ms/decode token)")
    want_vit = cfg.vision.num_layers * n_calls          # one frame a call
    want_flash = cfg.llm.num_layers * n_calls           # one prefill a call
    log(f"launches on the main path: vit_attention {n_vit} (want "
        f"{want_vit}), flash_attention {n_flash} (want {want_flash})")
    if n_vit != want_vit or n_flash != want_flash:
        raise AssertionError("kernel launch counts do not match the path")

    engine.collect = collect
    # the profiled call is a mid-window call: compare with calls 1..7
    prof = profile_call(torch, agent, frames[-1], instruction,
                        float(np.median(wall[1:8])))

    # reference check: the first call's prefill logits, kernels vs the
    # repo's dense attention path, on the same weights and inputs
    outs = []
    for impl in ("auto", "dense"):
        eng = StreamingEngine(params, cfg, cache_capacity=4096,
                              max_new_tokens=2, stop_ids=(tok.im_end_id,),
                              attn_impl=impl)
        VLNAgent(eng, tok).step(0, frames[0], instruction, run_model=True)
        outs.append(eng.last_logits.float())
        del eng
    a, b = outs
    cos = torch.nn.functional.cosine_similarity(a, b, dim=-1).min().item()
    rel = ((a - b).abs().max() / b.abs().max()).item()
    top1 = bool((a.argmax(-1) == b.argmax(-1)).all())
    log(f"reference check (prefill logits, kernels vs dense): cosine "
        f"{cos:.6f} max rel diff {rel:.3e} top-1 agree {top1}")
    if not cos > REF_MIN_COSINE:
        raise AssertionError("kernel path disagrees with the dense path")

    # 4. summary
    kernels = []
    for name, src, replaces, recs, n in (
            ("vit_attention", "streamvln_tpu_torch/csrc/vit_attention.cu",
             "streamvln_tpu/ops/vit_attention.py:37", vit, n_vit),
            ("flash_attention",
             "streamvln_tpu_torch/csrc/flash_attention.cu",
             "streamvln_tpu/ops/flash_attention.py:49", flash, n_flash)):
        head = recs[0]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": n,
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "shape": head["shape"],
            "shapes": recs})
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "kernels": kernels, "calls": calls,
                   "wall_ms": wall, "profile": prof}, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
