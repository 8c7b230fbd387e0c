"""Chip smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):
  1. check for a card, build every CUDA kernel from `streamvln_tpu_torch/
     csrc` (one nvcc per source, all at once), print the build seconds,
     each kernel's registers, shared memory and spill (ptxas), the counts
     of tensor-core (HGMMA wgmma, HMMA mma.sync) and asynchronous copy
     (UTMALDG TMA, UBLKCP bulk, LDGSTS) instructions in the SASS of every
     library: the K1, K2/K3 and K4/K5 libraries must hold HGMMA and
     UTMALDG, the K6/K7 and the K8 libraries a tensor-core op and an
     asynchronous copy; the K4/K5 kernels must spill no register and keep
     their wgmma unserialized (ptxas); and the card's name and power
     limit;
  2. hold each serving kernel against its plain PyTorch version at the
     main path's shapes (max abs error vs tolerance), and time the kernel,
     the plain version and, as a yardstick only, one PyTorch library call
     on the same work (the port never calls it): K1 in bf16 at batch 1,
     the history backfill's num_history (8 frames, phase 5) and the
     training tower batch of phase 4b (32 frames); every batch a main
     path sends K1 must be one of these; K2 in bf16 at B=1 (Sq 768 and
     2560) and at a batched worker's wave (B=8, Sq 768, rows at their
     own offsets, an idle row that sees no key, INVALID_POS keys) (K1
     and K2 by device time, with their event time and host cost per
     call); K6
     (int4 dequant-matmul) at every int4 projection's decode shape, the
     four layer projections at the speculative verify's 7 rows and
     gate/up at 128 rows, K7 (int4 unpack) for qkv, o, gate/up, down, the
     lm_head and the unfused k/v and gate/up of the QLoRA step (the script
     fails at its end if any phase launched K7 at another shape), K8
     (decode attention) at four live lengths of a 4096-slot cache; K6, K7
     and K8 timed over enough operand copies to miss the L2 cache, as the
     decode path does, with their host cost per call; every K6 and K8
     shape also checks that a second call is bit-equal to the first and
     that a call launches one kernel;
  3. drive the main path at full width: streamvln_7b (SigLIP-so400m +
     Qwen2-7B) with random bf16 weights made on the card (q/k/v and
     gate/up fused, as the engine does), a ByteTokenizer and a 4096-slot
     KV cache; VLNAgent.step over 480x640 frames for steps 0..32 with a
     model call every 4th step (9 calls, crossing the window reset with
     <memory> at step 32); check tokens, logits, cache bookkeeping and the
     exact launch counts of K1 and K2; check the first call's prefill
     logits against the repo's own dense attention path on the same
     weights. One more (mid-window) agent call runs under torch.profiler:
     device busy time (union of kernel intervals), idle share against the
     median unprofiled mid-window call, kernel launches and the top
     kernels by device time (in chiprun_out/chip_smoke.json);
     3b. two agent calls of an engine with attn_impl="decode_kernel" on
     the same weights: K8 exactly 28 times per fed token, no K1 (the
     tower runs dense under that impl, as in the reference), and a decode
     step's logits through K8 against the dense path on the same cache;
     3c. int4 weight-only serving: the weights quantized on the card by
     quant.quantize_llm(bits=4), the engine's default fusion, the same 9
     calls with exact launch counts of K1, K2, K6 and K7, per-call times,
     weight GiB and peak memory, the first call's prefill logits against
     the int4 weights dequantized to bf16 on the dense path, and one
     profiled mid-window call;
     3d. the serving variants in turns over the same steps: bf16,
     decode_kernel, int4 and bf16_spec (spec_lookup=6), each with decode ms
     per emitted token, tokens per decode forward and call wall;
     3e. speculative decode against greedy: two bf16 engines (spec_lookup 6
     and 0) take the 9 calls in lockstep; where a call differs, the
     greedy gap at its first differing position must lie within
     SPEC_FLIP_BOUND x the largest logit difference of the two paths at
     the positions where they agree, with the speculative token the
     greedy runner-up;
     3f. sampling: a temperature 0.7 / top-p 0.9 call deterministic by seed
     and equal to an engine's that runs its sampled steps eagerly, and a
     greedy row beside a sampled row equal to a greedy engine's;
     3g. (run right after 3d, on its four engines) every decode forward of
     the 9 calls of each variant replayed and checked bit for bit against
     the same step run eagerly from the state the replay starts from; a
     tensor rebound after capture makes the next replay raise.
     From phase 3 on, every decode graph is captured under
     torch.cuda.set_sync_debug_mode("error") and its capture time logged;
     every decode forward is one replay of the graph captured for its loop
     (streaming/decode_graph.py), and the profiled calls count the host's
     kernel launches and copies per decode forward;
  4. training: (a) the training kernels K3 (forward + LSE), K4 (dQ) and
     K5 (dK/dV) against their plain versions at the train step's shape
     (B=2, S=4096, 28/4 heads, D=128, bf16, 3,900 valid tokens, padded
     keys at INVALID_POS, one row that sees no key), each timed beside
     its plain version and SDPA's forward / backward under autograd; dQ,
     dK and dV bit-equal over two calls;
     (b) LoRA SFT of streamvln_7b on the phase-3 weights (rank 16 on the
     seven default targets): 3 optimizer steps of 2 micro-batches of two
     VLN windows (8 <memory> + 8 current 480x640 frames each, bucket
     4096), with checks on losses, grad norms, frozen weights, adapter
     updates and exact launch counts, a kernels-vs-dense check of one
     micro-batch's loss and LoRA gradients, per-step times, tokens/s and
     peak memory, and one micro-step under torch.profiler;
  5. the evaluation entry point: eval_cli.main (--model_size 7b
     --env_backend fake --num_episodes 2 --max_steps_per_episode 36, the
     default --spec_lookup 6) in-process on the phase's own streamvln_7b
     weights (random bf16, steered to walk: steer_to_walk), with
     result.json, exact K1/K2 launch counts, every verify forward a graph
     replay, model-call p50/p90, tokens per verify forward and peak memory;
  6. the serving stack (serving_stack) on one streamvln_7b init made by the
     entry points' own eval_cli.build_agent(None, "7b") (spec_lookup
     6, random bf16 weights steered to walk, its 4096 KV slots), plus an
     n_envs=8 engine of 4096 slots over the same weights; every server
     on 127.0.0.1 in a daemon thread; frames travel as JPEG, as the
     robot's client sends them:
     6a http_server's AgentService after its warm-up, 480x640 frames
     posted by the Go2 client (a model call each) across the step-32
     window reset until the KV cache's guard refuses one with a 400
     (with the ByteTokenizer, within the second window), exact K1/K2
     counts, request and model-call p50/p90 and their difference (HTTP,
     JPEG encode and decode, the agent's other steps), and
     Go2VlnManager's plan/control against it; 6b controller, model
     worker (registered, heartbeat seen) and web server: two 64-token
     /worker_generate_stream requests (greedy; temperature 0.7 top-p
     0.9) in generate + continue_decode chunks that extend each other,
     one /chat, time to first chunk and continue_decode ms per token;
     6c the batch worker: 8 concurrent requests in one wave and a lone
     one among 7 idle rows (which keep KV, lengths, shadow and feature
     slots), 26 K1 at B=8 and 28 K2 per wave, every decode forward a
     graph replay (and a profiled wave's host_ops), each row against the
     same request served alone at B=1 (prefill cosine > REF_MIN_COSINE,
     tokens equal or parted at a near-tie, require_near_ties), requests/s
     at waves of 8 and 1 (at the client and per engine call), decode ms
     per token at B=8; a mixed wave (rows MIXED_SAMPLED_ROWS sampled: the
     sampled graph at B=8, its greedy rows equal to an all-greedy call of
     the same requests or parted at a near-tie, the sampled rows' tokens
     in the top-p support, every forward a replay); one wave at the
     worker's default wait (wave sizes reported); 6d the fused
     preprocessing: siglip.forward_raw against preprocess + forward on one
     frame (max |diff| / max |ref| < 0.02), vision ms per frame both ways
     in turns, and 9 agent calls with fused_preprocess=True with exact
     K1/K2 counts; its record lands in chip_smoke.json under
     "serving_stack" and one summary line is printed;
  7. the turnkey command (turnkey_command): phase 5's weights (random
     bf16 streamvln_7b from seed 0, steered to walk, unfused) written by
     utils/checkpoint.save_hf in bf16 as HF shards of at most 5 GB with a
     model.safetensors.index.json into a temporary directory (removed in
     every case; no tokenizer files, so the ByteTokenizer), then, with
     tests/habitat_stub.py installed (4 episodes of 480x640 frames),
     eval_cli.main(--model_path <dir> --model_size 7b --env_backend habitat
     --habitat_config_path config/vln_r2r.yaml --eval_split val_unseen
     --max_steps_per_episode 12) in-process, twice: result.json with 4
     episode lines and the aggregate, finite metrics, exact K1/K2 launches
     per model call, every verify forward a graph replay, and a second run
     (resume) with no model call and the same aggregate; the loaded tree
     bit-equal to the written one, loaded by the port's per-layer device
     staging and, as a yardstick, converted on the host and then uploaded
     (each timed: read, convert, upload), one agent call over the loaded
     weights equal to one over the in-memory weights (tokens and prefill
     logits), and the build's device peak within 1 GiB of the random-init
     build's;
     prints the load seconds and GB/s, the host's peak RSS and the
     model-call p50/p90 beside the card's name and power limit; its
     record lands in chip_smoke.json under "turnkey";
  8. the quantized tail (quantized_tail), at full width on the phase-3
     weights made again from their seed: 8a the kv_int8 engine
     (kv_int8_serving): int8 k/v and f32 scales [28, 1, 4, 4096], its
     bytes against the bf16 cache's, 9 agent calls over steps 0..32 with
     exactly 26 K1 and 28 K2 per call and no K8, peak memory, the first
     call's prefill logits against a bf16-cache engine's (cosine >
     REF_MIN_COSINE), tokens call by call against the bf16-cache engine
     and, with spec_lookup 6, against the kv_int8 greedy engine (lockstep:
     equal or parted at a near-tie), the four variants in turns (decode ms
     per emitted token, call wall, a profiled call's host ops), every
     decode and verify forward of both kv_int8 variants replayed bit for
     bit against eager, and a rebound scale buffer making the next replay
     raise; 8b the int8 tower (int8_tower: quantize_vision weights on one
     frame against the bf16 tower at the reference test's bounds, vision
     ms per frame in turns), and, run last, when nothing else of the phase
     is left on the card, eval_cli.main --kv_int8 --vision_int8 as phase 5
     runs it (result.json, exact K1/K2, every verify forward a replay,
     model-call p50/p90, peak memory); 8c act_int8 (act_int8_check:
     quantize_llm(bits=8) with and without cfg.llm.act_int8, prefill
     logits and one LoRA micro-step's gradients, cosine >
     ACT_INT8_MIN_COSINE); 8d QLoRA (qlora_steps: int4 weights quantized
     on the card and the bf16 LLM freed, LoRA rank 16, one micro-batch
     through the kernels
     against the plain int4 route at the training gates, 3 optimizer
     steps of phase 4b's micro-batches with exact K3/K4/K5 counts and K7
     split into forward, recompute and backward, frozen base and packed
     leaves bit-equal, adapters moved, step ms, tokens/s and peak memory
     beside phase 4b's, then merge_lora into the int4 weights and one
     agent call on them); its record lands in chip_smoke.json under
     "quantized_tail" and one summary line is printed beside the card's
     name and power limit;
  9. print the kernels JSON line (K1-K8; each with bound_share = bound_ms
     / ms and vs_library = ms / library_ms; K1, K2 with their phase-8
     launches, K3-K5 and K7 with the QLoRA step's), the card line, and the
     result line.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import time

H100_BF16_FLOPS = 989e12      # dense tensor-core peak, SXM data sheet
H100_BYTES_PER_S = 3.35e12    # HBM3
# kernel vs plain version, elementwise |out - ref| <= ATOL + RTOL * |ref|:
# RTOL is two bf16 ulps (one for each side's output rounding), ATOL the
# bf16 rounding of P summed over the keys on outputs near 0, where a query
# sees FEW_KEYS keys or more, so that rounding averages out. A query that
# sees fewer (K2's wave: rows that start at position 0) adds the bound
# of the CUDA unit tests and phase 4a, which does not average: 2^-8 *
# sum_k p_k |v_k| (each side's P off by at most 2^-9 relative)
KERNEL_ATOL, KERNEL_RTOL = 1e-3, 2.0 ** -6
FEW_KEYS = 301
# kernels vs dense attention through 28 bf16 layers: rounding drifts,
# the direction of the logits must not
REF_MIN_COSINE = 0.99
# training kernels vs their plain versions (which round P and dS to bf16
# as the kernels do): LSE (f32) 1e-4 + 1e-5*|ref| (f32 sums in another
# order and the fast exp on O(1) scores); K3's output as K2's plus
# 2^-8*sum_k p|v| (rows that see few keys do not average P's rounding
# out); dQ/dK/dV 2^-6*|ref| (the two sides' output rounding) + 2^-7 *
# the sum of |terms| of the product whose bf16 factor (dS, or P for dV)
# can round one ulp apart on the two sides (f32 inputs a few ulps apart,
# amplified where dP - Dsum cancels), + 1e-5 for f32 summation order
LSE_ATOL, LSE_RTOL = 1e-4, 1e-5
GRAD_RTOL, GRAD_FLIP, GRAD_ATOL = 2.0 ** -6, 2.0 ** -7, 1e-5
# K2 at a batched worker's wave (phase 6c: 8 env slots, a 768-token
# bucket): the active rows of a fresh wave start at 0, idle rows stay at the
# lengths of their last request (~760), and rows that served longer
# dialogues further on
WAVE_OFFSETS = (0, 765, 772, 0, 1536, 3000, 300, 0)
# phase 6c: how long the batch worker waits for a wave to fill in the
# waves whose rows are checked (the 8 requests must form one wave). The
# worker's default wait is measured by one more 8-request wave, its wave
# sizes and the spread of its arrivals at the queue reported, not gated:
# the 8 client threads share the interpreter with the server threads that
# read and decode their frames
WAVE_WAIT_MS = 1000.0
# phase 6c's mixed wave: the rows that ask for sampling
MIXED_SAMPLED_ROWS, MIXED_TEMPERATURE, MIXED_TOP_P = (1, 5), 0.7, 0.9
# frames through the tower per training micro-batch (phase 4b): 2 VLN
# windows x (8 <memory> + 8 current frames)
TRAIN_TOWER_BATCH = 32
# LoRA training, kernels vs dense attention on one micro-batch
TRAIN_LOSS_RTOL, TRAIN_GRAD_MIN_COSINE = 1e-2, 0.99
# K6 vs its plain version: both f32 from the same bf16-rounded weights,
# so only the f32 summation order differs: 1e-5 * sum_k |x_k w_k| + 1e-6
K6_SUM_RTOL, K6_ATOL = 1e-5, 1e-6
# K8 vs its plain version in f32: half a bf16 ulp of the output + f32 order
K8_RTOL, K8_ATOL = 2.0 ** -8, 1e-5
# speculative vs greedy decode in bf16 (spec_vs_greedy): where a call
# differs, the greedy gap between its token and the speculative one must lie
# within 2 x the two paths' largest logit difference measured at the
# positions where they agree (the most that rounding can move a gap between
# two tokens), and every compared position must point the same way
SPEC_FLIP_BOUND, SPEC_MIN_COSINE = 2.0, 0.999
# phase 5's walking weights (steer_to_walk): the 56 residual writes (norm
# ~30 each at random init) scaled by 2^-12 add at most ~0.4, as a random
# walk ~0.06, to a unit embedding; the chain's next token gains ~12 logits
# against random logits of unit spread
STEER_RESIDUAL, STEER_LOGIT = 2.0 ** -12, 12.0
# phase 8b: the int8 tower (quant.quantize_vision) on one full-width frame
# against the bf16 tower, at the reference test's bounds
# (tests/test_siglip.py::test_vision_int8_close_to_float): max |diff| /
# max |ref| and the least per-token cosine
TOWER_INT8_MAX_REL, TOWER_INT8_MIN_COSINE = 0.05, 0.999
# phase 8c: act_int8 against weight-only int8 on the same weights (prefill
# logits, one LoRA micro-step's gradients), as tests/test_quant.py asks of
# the gradient
ACT_INT8_MIN_COSINE = 0.99
# phase 7's checkpoint: shards of at most 5 GB, as HF's save_pretrained
# writes them; its build may take at most 1 GiB more of the card than the
# random-init build
TURNKEY_SHARD_BYTES, TURNKEY_MEMORY_SLACK = 5 * 10**9, 2**30


def log(*a):
    print(*a, flush=True)


def _version(torch):
    return tuple(int(x) for x in torch.__version__.split("+")[0]
                 .split(".")[:2])


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(log_text: str) -> str:
    """'<kernel><template args>: <regs> regs, <smem> B smem, <spill> B
    spill' per instantiation, from nvcc's -Xptxas -v output."""
    import re
    out = []
    for mangled, body in re.findall(
            r"Compiling entry function '(_ZN3svt\w+)'(.*?)"
            r"(?=Compiling entry function|\Z)", log_text, re.S):
        # nested names after svt::, skipping an anonymous namespace
        pos, name = len("_ZN3svt"), ""
        while True:
            head = re.match(r"\d+", mangled[pos:])
            n = int(head.group(0))
            name = mangled[pos + head.end():pos + head.end() + n]
            pos += head.end() + n
            if not name.startswith("_GLOBAL__N"):
                break
        targs = mangled[pos:].split("EE")[0]
        args = (["bf16"] if "__nv_bfloat16" in targs else
                ["f32"] if targs.startswith("If") else []) \
            + re.findall(r"Li(\d+)E?", targs)
        regs = re.search(r"Used (\d+) registers", body)
        smem = re.search(r"(\d+) bytes smem", body)
        spill = re.search(r"(\d+) bytes spill stores", body)
        if regs:
            label = f"{name}<{','.join(args)}>" if args else name
            out.append(f"{label}: {regs.group(1)} regs, "
                       f"{smem.group(1) if smem else 0} B smem, "
                       f"{spill.group(1) if spill else '?'} B spill")
    return "; ".join(out) or "no ptxas output (library was already built)"


SASS_OPS = ("HGMMA", "HMMA", "UTMALDG", "UBLKCP", "LDGSTS")


def sass_counts(path: str) -> dict:
    """Counts of tensor-core (HGMMA wgmma, HMMA mma.sync) and asynchronous
    copy (UTMALDG TMA, UBLKCP bulk copy, LDGSTS cp.async) instructions in
    the SASS of a built library (cuobjdump -sass)."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", path], capture_output=True,
                         text=True, timeout=300)
    if out.returncode != 0:
        raise RuntimeError(f"cuobjdump failed on {path}: {out.stderr}")
    import re
    return {op: len(re.findall(rf"\b{op}\b", out.stdout)) for op in SASS_OPS}


WGMMA_TMA_LIBS = ("vit_attention", "flash_attention", "flash_attention_bwd")


def sass_ok(name: str, c: dict) -> bool:
    """What each library's design relies on: wgmma and TMA in the
    attention forward (K1, K2/K3) and backward (K4/K5); a tensor-core op
    and an asynchronous copy in K6 (int4_matmul, with K7) and in K8
    (decode_attention)."""
    mma = c["HGMMA"] or c["HMMA"]
    copy = c["UTMALDG"] or c["UBLKCP"] or c["LDGSTS"]
    if name in WGMMA_TMA_LIBS:
        return bool(c["HGMMA"] and c["UTMALDG"])
    return bool(mma and copy)


def registers_ok(log_text: str) -> bool:
    """No register spill and no wgmma serialized for want of registers in
    a library's kernels, from nvcc's -Xptxas -v output."""
    import re
    spills = [int(n) for n in re.findall(r"(\d+) bytes spill stores",
                                         log_text)]
    return bool(spills) and not any(spills) and \
        "serialized due to insufficient register" not in log_text


def require(what: str, **conditions):
    """Fail naming each condition of `what` that does not hold."""
    failed = [name for name, ok in conditions.items() if not ok]
    if failed:
        raise AssertionError(f"{what}: {', '.join(failed)} failed")


def cuda_events(torch, run, attempts=3) -> list:
    """The CUDA kernel events torch.profiler records while `run()` runs.
    A capture that recorded no kernel at all (taken to be the card's
    tracing dropping the whole window) is logged and taken again, up to
    `attempts` times; work that launches nothing still reads as no
    event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if events:
            break
        log(f"  profiler capture {attempt + 1} of {attempts} recorded no "
            f"CUDA kernel")
    return events


GRAPH_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host",
                    4: "graph", 5: "empty"}


def launches_per_call(torch, fn) -> list:
    """The operations one call of `fn` puts on its stream (kernels,
    copies, memsets), by type: the nodes of a CUDA graph captured from
    the call (cuGraphGetNodes). Capture sees every enqueued operation,
    so unlike a torch.profiler window it cannot drop or gain one."""
    import ctypes
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")
    handle, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    rc = cu.cuGraphGetNodes(handle, None, ctypes.byref(n))
    nodes = (ctypes.c_void_p * n.value)()
    rc = rc or cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n))
    kinds = []
    for node in nodes[:n.value]:
        t = ctypes.c_int(-1)
        rc = rc or cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                         ctypes.byref(t))
        kinds.append(GRAPH_NODE_TYPES.get(t.value, f"type {t.value}"))
    graph.reset()
    if rc:
        raise RuntimeError(f"counting captured graph nodes failed: CUDA "
                           f"driver error {rc}")
    return kinds


def host_us(torch, fn, calls=200) -> float:
    """Wall time per call of back-to-back calls (one synchronize at the
    end): the wrapper's host cost (checks, tensor-map encodes, launch)
    where that exceeds the kernel's device time."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


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


def compare(out, ref, few_keys_term=None) -> dict:
    """Max abs error, the worst share of the elementwise tolerance used,
    and the outputs' mean magnitude (what the tolerance is set against).
    `few_keys_term`: 2^-8 * sum_k p_k |v_k| on the queries that see fewer
    than FEW_KEYS keys, 0 elsewhere (see KERNEL_ATOL)."""
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    tol = KERNEL_ATOL + KERNEL_RTOL * ref.abs()
    if few_keys_term is not None:
        tol = tol + few_keys_term
    return {"max_abs_err": err.max().item(),
            "tol_share": (err / tol).max().item(),
            "ref_mean_abs": ref.abs().mean().item()}


def tol_text(c: dict) -> str:
    few = c.get("queries_seeing_few_keys")
    few = f" + 2^-8*sum p|v| on the {few} queries that see fewer than " \
        f"{FEW_KEYS} keys" if few else ""
    return (f"max_abs_err {c['max_abs_err']:.3e} ({c['tol_share']:.3f} of "
            f"the tolerance {KERNEL_ATOL} + {KERNEL_RTOL:.4g}*|ref|{few}; "
            f"mean |ref| {c['ref_mean_abs']:.3e})")


def check_vit(torch, F, va, B, rng_seed=0):
    """K1 against its plain version at the SigLIP shape, batch B. Times:
    the kernel's device time (torch.profiler; at batch 1 the wrapper's
    host cost exceeds it, so an event time would measure the host), its
    event time and host cost per call, SDPA's device and event time."""
    S, H, D = 729, 16, 72
    g = torch.Generator(device="cuda").manual_seed(rng_seed)
    q, k, v = (torch.randn((B, S, H, D), generator=g, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    out = va.vit_attention(q, k, v)
    torch.cuda.synchronize()
    c = compare(out, va.vit_attention_plain(q, k, v))

    def kernel():
        return va.vit_attention(q, k, v)
    ms, event_ms, h_us = device_ms(torch, [kernel]), time_ms(torch, kernel), \
        host_us(torch, kernel)
    plain = time_ms(torch, lambda: va.vit_attention_plain(q, k, v), iters=3)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt)
    lib, lib_event = device_ms(torch, [sdpa]), time_ms(torch, sdpa)
    b_ms, b_by = bound(4.0 * S * S * D * H * B, 4.0 * B * S * H * D * 2)
    rec = {"shape": f"B={B} S={S} H={H} D={D} bf16", "batch": B, **c,
           "ms": ms, "event_ms": event_ms, "host_us": h_us,
           "plain_ms": plain, "library_ms": lib,
           "library_event_ms": lib_event, "bound_ms": b_ms, "bound_by": b_by}
    log(f"K1 vit_attention {rec['shape']}: {tol_text(c)} kernel {ms:.4f} "
        f"ms device ({event_ms:.4f} event-timed, {h_us:.1f} us host per "
        f"call) plain {plain:.4f} ms sdpa {lib:.4f} ms device "
        f"({lib_event:.4f} event-timed) bound {b_ms:.4f} ms ({b_by})")
    if not c["tol_share"] <= 1.0:
        raise AssertionError(f"vit_attention disagrees: {c}")
    return rec


def check_flash(torch, F, fa, Sq, offsets=(300,), cap=4096, seed=1):
    """K2 against its plain version: a prefill of Sq queries into a
    cap-slot KV-head-major cache, one batch row per entry of `offsets`
    (row b's queries at positions offsets[b] .. offsets[b] + Sq - 1); query
    7 of row 0 sees no key (q_pos -1). Several rows are a batched worker's
    wave: rows at different offsets, an idle row whose queries all see no
    key (the last) and a row whose keys from slot 1000 on are INVALID_POS
    (the one before it)."""
    B, Hq, Hkv, D = len(offsets), 28, 4, 128
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, Sq, Hq, D), generator=g, device="cuda") \
        .to(torch.bfloat16)
    k, v = (torch.randn((B, Hkv, cap, D), generator=g, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    q_pos = (torch.tensor(offsets, dtype=torch.int32, device="cuda")[:, None]
             + torch.arange(Sq, device="cuda", dtype=torch.int32)[None]) \
        .contiguous()
    q_pos[0, 7] = -1                      # a query that sees no key
    k_pos = torch.arange(cap, device="cuda", dtype=torch.int32)[None] \
        .repeat(B, 1)
    if B > 1:
        q_pos[-1] = -1                    # an idle row: no key at all
        k_pos[-2, 1000:] = fa.INVALID_POS
    out = fa.flash_attention(q, k, v, q_pos, k_pos, kv_major=True)
    torch.cuda.synchronize()
    ref = fa.flash_attention_plain(q, k, v, q_pos, k_pos, kv_major=True)
    if not (torch.all(out[0, 7] == 0)
            and (B == 1 or torch.all(out[-1] == 0))):
        raise AssertionError("flash_attention: a row with no visible key "
                             "is not zero")
    n_seen = (k_pos[:, None, :] <= q_pos[:, :, None]).sum(-1)    # [B, Sq]
    few = (n_seen > 0) & (n_seen < FEW_KEYS)
    term = None
    if few.any():
        term = torch.where(few[:, :, None, None], 2.0 ** -8 * (
            fa.flash_attention_plain(q, k, v.abs(), q_pos, k_pos,
                                     kv_major=True).float()), 0.0)
    c = compare(out, ref, term)
    c["queries_seeing_few_keys"] = int(few.sum())
    del term

    def kernel():
        return fa.flash_attention(q, k, v, q_pos, k_pos, kv_major=True)
    ms, event_ms, h_us = device_ms(torch, [kernel]), time_ms(torch, kernel), \
        host_us(torch, kernel)
    plain = time_ms(torch, lambda: fa.flash_attention_plain(
        q, k, v, q_pos, k_pos, kv_major=True), iters=3)
    # yardstick on the live prefix only (the slots the kernel reads),
    # GQA without copies where this torch has enable_gqa
    k_live = min(int(q_pos.max().item()) + 1, cap)  # slots any query sees
    mask = (k_pos[:, None, :k_live] <= q_pos[:, :, None])[:, None]
    kl, vl = k[:, :, :k_live], v[:, :, :k_live]
    qt = q.transpose(1, 2).contiguous()
    if _version(torch) >= (2, 5):
        def sdpa():
            return F.scaled_dot_product_attention(
                qt, kl, vl, attn_mask=mask, enable_gqa=True)
    else:
        kx, vx = (x.repeat_interleave(Hq // Hkv, dim=1) for x in (kl, vl))

        def sdpa():
            return F.scaled_dot_product_attention(qt, kx, vx,
                                                  attn_mask=mask)
    lib, lib_event = device_ms(torch, [sdpa]), time_ms(torch, sdpa)
    pairs = mask.sum().item()                 # visible (query, key) pairs
    # each row reads the keys some query of it sees
    seen = (k_pos <= q_pos.max(dim=1, keepdim=True).values).sum().item()
    nbytes = 2 * (2 * B * Sq * Hq * D + 2 * Hkv * seen * D) \
        + 4 * (B * Sq + B * cap)
    b_ms, b_by = bound(4.0 * pairs * D * Hq, nbytes)
    rows = f"B={B} offsets={list(offsets)} " if B > 1 else \
        f"offset={offsets[0]} "
    rec = {"shape": f"Sq={Sq} Hq={Hq} Hkv={Hkv} D={D} kv_major "
                    f"cache={cap} {rows}bf16", "batch": B,
           **c, "ms": ms, "event_ms": event_ms, "host_us": h_us,
           "plain_ms": plain, "library_ms": lib,
           "library_event_ms": lib_event, "bound_ms": b_ms, "bound_by": b_by}
    log(f"K2 flash_attention {rec['shape']}: {tol_text(c)} kernel {ms:.4f} "
        f"ms device ({event_ms:.4f} event-timed, {h_us:.1f} us host per "
        f"call) plain {plain:.4f} ms sdpa {lib:.4f} ms device "
        f"({lib_event:.4f} event-timed) bound {b_ms:.4f} ms ({b_by})")
    if not c["tol_share"] <= 1.0:
        raise AssertionError(f"flash_attention disagrees: {c}")
    return rec


def time_cold_ms(torch, fns, iters=12, warmup=2) -> float:
    """time_ms over a rotation of `fns`, each bound to its own copy of the
    operands, so that the working set exceeds the 50 MB L2 cache as it
    does on the decode path (28 layers' weights and caches in turn).
    Where a call's host work outlasts its kernels, this measures the host;
    device_ms gives the kernels' own time."""
    k = [0]

    def step():
        fns[k[0] % len(fns)]()
        k[0] += 1
    return time_ms(torch, step, iters=max(iters, len(fns)), warmup=warmup)


def _copies(nbytes: int) -> int:
    """Operand copies that take a rotation past 2.5x the L2 cache."""
    return max(1, -(-int(2.5 * 50e6) // max(nbytes, 1)))


def int4_weight(torch, quant, din, dout, seed):
    """A random fan-in-scaled [din, dout] weight quantized by the port's
    quantize_weight_int4, as a one-layer stack ([1, din/2, dout] uint8,
    [1, din/64, dout] f32)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.randn((din, dout), generator=g, device="cuda")
    wp, s = quant.quantize_weight_int4(w.mul_(din ** -0.5))
    del w
    return wp[None].contiguous(), s[None].contiguous()


def int4pack_yardstick(torch, i4, wp, s):
    """The same weights repacked for torch._weight_int4pack_mm: unsigned
    nibbles q + 8 with zero point 8 ((u - 8) * scale + 0), the scales
    rounded to bf16 (the port keeps them f32), group 64, torch's tiled
    [dout, din] layout. Returns a function of x, or raises where this
    torch lacks the op."""
    _, half, dout = wp.shape
    lo, hi = i4.unpack_nibbles(wp[0])
    q = torch.stack([lo, hi], 1).reshape(2 * half, dout).t().contiguous()
    q = q + 8
    u8 = ((q[:, 0::2] << 4) | q[:, 1::2]).to(torch.uint8)
    del q, lo, hi
    packed = torch._convert_weight_to_int4pack(u8, 8)
    sb = s[0].to(torch.bfloat16)
    sz = torch.stack([sb, torch.zeros_like(sb)], -1).contiguous()
    return lambda x: torch._weight_int4pack_mm(x, packed, 64, sz)


# every int4 projection at one row (greedy decode), the four layer
# projections at 7 rows (the speculative verify forward: spec_lookup 6 + 1)
# and gate/up at 128 rows (the top of K6's range)
INT4_SHAPES = (("qkv", 3584, 4608, 1), ("o", 3584, 3584, 1),
               ("gu", 3584, 37888, 1), ("down", 18944, 3584, 1),
               ("lm_head", 3584, 152064, 1), ("gu", 3584, 37888, 128),
               ("qkv", 3584, 4608, 7), ("o", 3584, 3584, 7),
               ("gu", 3584, 37888, 7), ("down", 18944, 3584, 7))
# K7 alone at the unfused projections a QLoRA step unpacks (LoRA keeps q,
# k, v and gate, up apart; q is o's shape): k/v and gate/up
K7_SHAPES = (("k/v", 3584, 512), ("gate/up", 3584, 18944))


def check_int4(torch, i4, quant):
    """K6 at every int4 projection's decode shape (M=1; fused qkv and
    gate/up, o, down, lm_head), the layer projections at the speculative
    verify's M=7 and gate/up at M=128, and K7 for qkv, o, gate/up, down
    and the lm_head and at K7_SHAPES, against their plain versions. K6: f32 out on both sides from the
    same bf16-rounded weights, so only the f32 summation order differs:
    |err| <= 1e-5 * sum_k |x_k w_k| + 1e-6 elementwise; a second call
    bit-equal; one kernel and nothing else enqueued per call (a captured
    CUDA graph's nodes). K7: bit-equal."""
    weights, recs, dq = {}, [], []
    for i, (name, din, dout, M) in enumerate(INT4_SHAPES):
        if (din, dout) not in weights:
            weights[(din, dout)] = int4_weight(torch, quant, din, dout, i)
        wp, s = weights[(din, dout)]
        half = din // 2
        g = torch.Generator(device="cuda").manual_seed(100 + i)
        x = torch.randn((M, din), generator=g, device="cuda") \
            .to(torch.bfloat16)
        out = i4.int4_matmul(x, wp, s, 0)
        again = i4.int4_matmul(x, wp, s, 0)
        torch.cuda.synchronize()
        bit_equal = torch.equal(out, again)
        del again
        ref = i4.int4_matmul_plain(x, wp, s, 0)
        lo, hi = i4._scaled_halves(wp[0], s[0], torch.bfloat16)
        term = x[:, 0::2].float().abs() @ lo.float().abs() \
            + x[:, 1::2].float().abs() @ hi.float().abs()
        err = (out - ref).abs()
        share = (err / (K6_SUM_RTOL * term + K6_ATOL)).max().item()
        wb = torch.cat([lo, hi])                # bf16 [din, dout], split rows
        del term, lo, hi
        n = _copies(wp.numel() + s.numel() * 4)
        ops = [(wp, s, wb)] + [(wp.clone(), s.clone(), wb.clone())
                               for _ in range(n - 1)]
        kfns = [(lambda a=a, b=b: i4.int4_matmul(x, a, b, 0))
                for a, b, _ in ops]
        ms, event_ms = device_ms(torch, kfns), time_cold_ms(torch, kfns)
        h_us, per_call = host_us(torch, kfns[0]), launches_per_call(
            torch, kfns[0])
        plain = time_ms(torch, lambda: i4.int4_matmul_plain(x, wp, s, 0),
                        iters=3, warmup=1)
        xs = i4._split_cols(x)
        mm_ms = device_ms(torch, [(lambda c=c: torch.mm(xs, c))
                                  for _, _, c in ops])
        try:
            packs = [int4pack_yardstick(torch, i4, a, b) for a, b, _ in ops]
            pack_ms = device_ms(torch, [(lambda f=f: f(x)) for f in packs])
            pack_err = ((packs[0](x).float() - ref).abs().max()
                        / ref.abs().max()).item()
            pack_note = None
            del packs
        except (AttributeError, RuntimeError) as e:
            pack_ms = pack_err = None
            pack_note = f"torch._weight_int4pack_mm unavailable: {e}"[:200]
        nbytes = half * dout + (din // 64) * dout * 4 + M * din * 2 \
            + M * dout * 4
        b_ms, b_by = bound(2.0 * M * din * dout, nbytes)
        rec = {"shape": f"{name} M={M} din={din} dout={dout} bf16 x, int4 "
                        f"group 64", "max_abs_err": err.max().item(),
               "tol_share": share, "bit_equal": bit_equal, "ms": ms,
               "event_ms": event_ms, "host_us": h_us,
               "kernels_per_call": len(per_call), "enqueued": per_call,
               "plain_ms": plain,
               "library_ms": pack_ms if pack_ms is not None else mm_ms,
               "library": "torch._weight_int4pack_mm" if pack_ms is not None
               else "torch.mm on the bf16-dequantized weight",
               "int4pack_ms": pack_ms, "int4pack_max_rel_err": pack_err,
               "int4pack_note": pack_note, "mm_bf16_ms": mm_ms,
               "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
               "rotation": n}
        log(f"K6 int4_matmul {rec['shape']}: max_abs_err "
            f"{rec['max_abs_err']:.3e} ({share:.3f} of 1e-5*sum|xw| + 1e-6) "
            f"bit-equal {bit_equal}, enqueues {per_call} per call; kernel "
            f"{ms:.4f} ms device ({event_ms:.4f} ms event-timed, {h_us:.1f} "
            f"us host per call) plain {plain:.4f} ms int4pack {pack_ms} ms "
            f"(max rel err {pack_err}) mm bf16 {mm_ms:.4f} ms bound "
            f"{b_ms:.4f} ms ({b_by}); {n} copies")
        if pack_note:
            log(f"  {pack_note}")
        recs.append(rec)
        require(f"int4_matmul at {rec['shape']}", agrees=share <= 1.0,
                deterministic=bit_equal, one_launch=per_call == ["kernel"])
        del ops, wb, xs, out, ref, err
        if M == 1:
            dq.append(check_dequant(torch, i4, name, wp, s))
    del weights
    for i, (name, din, dout) in enumerate(K7_SHAPES):
        wp, s = int4_weight(torch, quant, din, dout, 50 + i)
        dq.append(check_dequant(torch, i4, name, wp, s))
        del wp, s
    torch.cuda.empty_cache()
    return recs, dq


def check_dequant(torch, i4, name, wp, s):
    """K7 against its plain version: bit-equal."""
    _, half, dout = wp.shape
    out = i4.int4_dequant_split(wp, s, 0, torch.bfloat16)
    torch.cuda.synchronize()
    ref = i4.int4_dequant_split_plain(wp, s, 0, torch.bfloat16)
    equal = torch.equal(out, ref)
    err = (out.float() - ref.float()).abs().max().item()
    del out, ref
    n = _copies(wp.numel() * 5)
    ops = [(wp, s)] + [(wp.clone(), s.clone()) for _ in range(n - 1)]
    kfns = [(lambda a=a, b=b: i4.int4_dequant_split(a, b, 0, torch.bfloat16))
            for a, b in ops]
    ms, event_ms = device_ms(torch, kfns), time_cold_ms(torch, kfns)
    plain = time_ms(torch, lambda: i4.int4_dequant_split_plain(
        wp, s, 0, torch.bfloat16), iters=3, warmup=1)
    nbytes = half * dout + (2 * half // 64) * dout * 4 + 2 * half * dout * 2
    b_ms, b_by = bound(0.0, nbytes)
    rec = {"shape": f"{name} din={2 * half} dout={dout} -> bf16 "
                    f"[2, {half}, {dout}]", "key": [2 * half, dout, "bfloat16"],
           "max_abs_err": err,
           "bit_equal": equal, "ms": ms, "event_ms": event_ms,
           "plain_ms": plain,
           "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
           "bytes": nbytes, "rotation": n}
    log(f"K7 int4_dequant_split {rec['shape']}: bit-equal {equal} kernel "
        f"{ms:.4f} ms device ({event_ms:.4f} ms event-timed) plain "
        f"{plain:.4f} ms bound {b_ms:.4f} ms ({b_by})")
    if not equal:
        raise AssertionError(f"int4_dequant_split differs at {rec['shape']}")
    return rec


def check_decode(torch, F, da, lengths=(300, 1900, 4096, 2049), L=28,
                 cap=4096, seed=7):
    """K8 against its plain version run in f32 on the same (upcast) inputs,
    at a 28-layer bf16 cache's shapes: |err| <= 2^-8 |ref| + 1e-5 (the
    kernel's one bf16 output rounding, half an ulp, plus f32 summation
    order); a second call bit-equal; one kernel per call. Timed over the
    28 layers in turn, beside SDPA on the live prefix (enable_gqa)."""
    B, Hq, Hkv, D = 1, 28, 4, 128
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((L, B, 1, Hq, D), generator=g, device="cuda") \
        .to(torch.bfloat16)
    k, v = (torch.randn((L, B, Hkv, cap, D), generator=g, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    recs = []
    for n in lengths:
        lens = torch.full((B,), n, dtype=torch.int32, device="cuda")
        out = da.decode_attention(q[0], k[0], v[0], lens)
        again = da.decode_attention(q[0], k[0], v[0], lens)
        torch.cuda.synchronize()
        bit_equal = torch.equal(out, again)
        ref = da.decode_attention_plain(q[0].float(), k[0].float(),
                                        v[0].float(), lens)
        err = (out.float() - ref).abs()
        share = (err / (K8_RTOL * ref.abs() + K8_ATOL)).max().item()
        kfns = [(lambda i=i: da.decode_attention(q[i], k[i], v[i], lens))
                for i in range(L)]
        ms, event_ms = device_ms(torch, kfns, 2 * L), \
            time_cold_ms(torch, kfns, iters=2 * L)
        h_us, per_call = host_us(torch, kfns[0]), launches_per_call(
            torch, kfns[0])
        plain = time_ms(torch, lambda: da.decode_attention_plain(
            q[0], k[0], v[0], lens), iters=3, warmup=1)
        qt = [q[i].transpose(1, 2) for i in range(L)]
        lib = device_ms(torch, [
            (lambda i=i: F.scaled_dot_product_attention(
                qt[i], k[i][:, :, :n], v[i][:, :, :n], enable_gqa=True))
            for i in range(L)], 2 * L)
        nbytes = 2 * B * Hkv * n * D * 2 + 2 * B * Hq * D * 2 + 4 * B
        b_ms, b_by = bound(4.0 * B * Hq * n * D, nbytes)
        rec = {"shape": f"B={B} Hq={Hq} Hkv={Hkv} D={D} length={n} "
                        f"cache={cap} bf16", "max_abs_err": err.max().item(),
               "tol_share": share, "bit_equal": bit_equal, "ms": ms,
               "event_ms": event_ms, "host_us": h_us,
               "kernels_per_call": len(per_call), "enqueued": per_call,
               "plain_ms": plain, "library_ms": lib, "bound_ms": b_ms,
               "bound_by": b_by, "bytes": nbytes}
        log(f"K8 decode_attention {rec['shape']}: max_abs_err "
            f"{rec['max_abs_err']:.3e} ({share:.3f} of 2^-8|ref| + 1e-5) "
            f"bit-equal {bit_equal}, enqueues {per_call} per call; kernel "
            f"{ms:.4f} ms device ({event_ms:.4f} ms event-timed, {h_us:.1f} "
            f"us host per call) "
            f"plain {plain:.4f} ms sdpa {lib:.4f} ms bound {b_ms:.4f} ms "
            f"({b_by})")
        recs.append(rec)
        require(f"decode_attention at length {n}", agrees=share <= 1.0,
                deterministic=bit_equal, one_launch=per_call == ["kernel"])
    del q, k, v
    torch.cuda.empty_cache()
    return recs


def train_positions(torch, B, S, n_valid, device):
    """Positions as forward_train makes them: valid tokens at 0..n-1,
    padded queries at position 0, padded keys at INVALID_POS; query 7 of
    the last row is given position -1, so it sees no key."""
    from streamvln_tpu_torch.ops.flash_attention import INVALID_POS
    pos = torch.arange(S, device=device, dtype=torch.int32)
    q_pos = torch.where(pos < n_valid, pos, 0)[None].repeat(B, 1)
    k_pos = torch.where(pos < n_valid, pos, INVALID_POS)[None].repeat(B, 1)
    q_pos[B - 1, 7] = -1
    return q_pos.contiguous(), k_pos.contiguous()


def bwd_rounding_terms(torch, fa, q, k, v, dout, lse, dsum, q_pos, k_pos):
    """Per element of dQ, dK, dV ([B, S, H, D], k's layout [B, S, Hkv,
    D]): scale*sum|dS||K|, scale*sum|dS||Q| and sum P|dO|, the products
    whose bf16-rounded factor a one-ulp flip changes."""
    B, S, Hq, D = q.shape
    scale = D ** -0.5
    p, ds, qf, kf, dof = fa._bwd_core(q, k, v, dout, lse, dsum, q_pos,
                                      k_pos, scale, False)
    ds = ds.abs()
    t_dq = torch.einsum("bhgqk,bhkd->bqhgd", ds, kf.abs()) \
        .reshape(B, S, Hq, D) * scale
    t_dk = torch.einsum("bhgqk,bqhgd->bhkd", ds, qf.abs()) * scale
    t_dv = torch.einsum("bhgqk,bqhgd->bhkd", p, dof.abs())
    return t_dq, t_dk.transpose(1, 2), t_dv.transpose(1, 2)


def grad_compare(out, ref, term) -> dict:
    """Max abs error and the worst share of the elementwise tolerance
    2^-6|ref| + 2^-7 term + 1e-5."""
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    tol = GRAD_RTOL * ref.abs() + GRAD_FLIP * term + GRAD_ATOL
    return {"max_abs_err": err.max().item(),
            "tol_share": (err / tol).max().item(),
            "ref_rms": ref.square().mean().sqrt().item()}


def check_training_kernels(torch, F, fa, B=2, S=4096, n_valid=3900,
                           Hq=28, Hkv=4, D=128, seed=3):
    """Phase 4a: K3, K4 and K5 against their plain versions on the same
    inputs at the train step's attention shape, each timed beside its
    plain version and SDPA (forward for K3; its backward, which computes
    dQ, dK and dV in one call, for K4 and K5)."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda") \
            .to(torch.bfloat16)
    q, dout = rnd(B, S, Hq, D), rnd(B, S, Hq, D)
    k, v = rnd(B, S, Hkv, D), rnd(B, S, Hkv, D)
    q_pos, k_pos = train_positions(torch, B, S, n_valid, "cuda")
    shape = (f"B={B} S={S} valid={n_valid} Hq={Hq} Hkv={Hkv} D={D} bf16 "
             f"[B,S,Hkv,D]")

    out, lse = fa.flash_attention_lse(q, k, v, q_pos, k_pos)
    torch.cuda.synchronize()
    ref_out, ref_lse = fa.flash_attention_lse_plain(q, k, v, q_pos, k_pos)
    few = fa.flash_attention_plain(q, k, v.abs(), q_pos, k_pos).float()
    err = (out.float() - ref_out.float()).abs()
    tol = KERNEL_ATOL + KERNEL_RTOL * ref_out.float().abs() + 2.0 ** -8 * few
    c_out = {"max_abs_err": err.max().item(),
             "tol_share": (err / tol).max().item()}
    del few, err, tol
    seen = ref_lse > fa.NEG_INF / 2
    lerr = (lse - ref_lse).abs()[seen]
    c_lse = {"max_abs_err": lerr.max().item(), "tol_share": (
        lerr / (LSE_ATOL + LSE_RTOL * ref_lse.abs()[seen])).max().item()}
    unseen_ok = bool((out[B - 1, 7] == 0).all()) and \
        bool((lse[B - 1, :, 7] == fa.NEG_INF).all()) and \
        torch.equal(lse <= fa.NEG_INF / 2, ~seen)
    del ref_out, ref_lse

    dsum = fa._dsum(dout, out)
    args = (q, k, v, dout, lse, dsum, q_pos, k_pos)
    dq = fa.flash_bwd_dq(*args)
    dk, dv = fa.flash_bwd_dkv(*args)
    torch.cuda.synchronize()
    # no atomics and a fixed order of sums: a second call is bit-equal
    dk2, dv2 = fa.flash_bwd_dkv(*args)
    bit_equal = torch.equal(fa.flash_bwd_dq(*args), dq) and \
        torch.equal(dk2, dk) and torch.equal(dv2, dv)
    del dk2, dv2
    t_dq, t_dk, t_dv = bwd_rounding_terms(torch, fa, *args)
    c_dq = grad_compare(dq, fa.flash_bwd_dq_plain(*args), t_dq)
    rdk, rdv = fa.flash_bwd_dkv_plain(*args)
    c_dk, c_dv = grad_compare(dk, rdk, t_dk), grad_compare(dv, rdv, t_dv)
    del rdk, rdv, t_dq, t_dk, t_dv
    unseen_ok = unseen_ok and bool((dq[B - 1, 7] == 0).all())

    ms3 = time_ms(torch, lambda: fa.flash_attention_lse(q, k, v, q_pos,
                                                        k_pos))
    ms4 = time_ms(torch, lambda: fa.flash_bwd_dq(*args))
    ms5 = time_ms(torch, lambda: fa.flash_bwd_dkv(*args))
    plain3 = time_ms(torch, lambda: fa.flash_attention_lse_plain(
        q, k, v, q_pos, k_pos), iters=2, warmup=1)
    plain4 = time_ms(torch, lambda: fa.flash_bwd_dq_plain(*args), iters=2,
                     warmup=1)
    plain5 = time_ms(torch, lambda: fa.flash_bwd_dkv_plain(*args), iters=2,
                     warmup=1)
    # yardstick: SDPA on the same masked work ([B, H, S, D]), forward
    # alone and its backward under autograd; the faster of GQA without
    # copies (enable_gqa) and K/V repeated per query head beforehand
    mask = (k_pos[:, None, :] <= q_pos[:, :, None])[:, None]
    dot = dout.transpose(1, 2).contiguous()
    lib = {}
    for variant in ("enable_gqa", "repeated"):
        kt, vt = (x.transpose(1, 2) for x in (k, v))
        if variant == "repeated":
            kt, vt = (x.repeat_interleave(Hq // Hkv, dim=1)
                      for x in (kt, vt))
        qt, kt, vt = (x.contiguous().requires_grad_()
                      for x in (q.transpose(1, 2), kt, vt))

        def sdpa():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask,
                enable_gqa=variant == "enable_gqa")
        with torch.no_grad():
            fwd = time_ms(torch, sdpa)
        o = sdpa()
        bwd = time_ms(torch, lambda: torch.autograd.grad(
            o, (qt, kt, vt), dot, retain_graph=True))
        lib[variant] = (fwd, bwd)
        del o, qt, kt, vt
    log(f"4a SDPA (fwd ms, bwd ms): {lib}")
    lib_fwd = min(f for f, _ in lib.values())
    lib_bwd = min(b for _, b in lib.values())

    pairs = float(mask.sum().item()) * Hq       # visible (q, k) x heads
    e = 2                                        # bytes per bf16 element
    qb, kb = B * S * Hq * D * e, B * S * Hkv * D * e
    rows = B * Hq * S * 4                        # one f32 per row and head
    pos_b = 2 * B * S * 4
    work = {
        "flash_attention_lse": (4 * D * pairs, 2 * qb + 2 * kb + rows + pos_b,
                                c_out, ms3, plain3, lib_fwd, 108),
        "flash_bwd_dq": (6 * D * pairs, 3 * qb + 2 * kb + 2 * rows + pos_b,
                         c_dq, ms4, plain4, lib_bwd, 130),
        "flash_bwd_dkv": (8 * D * pairs, 2 * qb + 4 * kb + 2 * rows + pos_b,
                          {"dk": c_dk, "dv": c_dv}, ms5, plain5, lib_bwd,
                          171),
    }
    recs = {}
    for name, (flops, nbytes, c, ms, plain, lib, line) in work.items():
        b_ms, b_by = bound(flops, nbytes)
        err = max(x["max_abs_err"] for x in c.values()) \
            if name == "flash_bwd_dkv" else c["max_abs_err"]
        recs[name] = {"shape": shape, "max_abs_err": err, "checks": c,
                      "ms": ms, "plain_ms": plain, "library_ms": lib,
                      "bound_ms": b_ms, "bound_by": b_by,
                      "flops": flops, "bytes": nbytes,
                      "replaces": f"streamvln_tpu/ops/flash_attention.py:"
                                  f"{line}",
                      "library": "F.scaled_dot_product_attention "
                                 + ("forward" if line == 108 else
                                    "backward (dQ, dK and dV in one call)")}
        log(f"4a {name} {shape}: {json.dumps(c)} kernel {ms:.4f} ms plain "
            f"{plain:.4f} ms sdpa {lib:.4f} ms bound {b_ms:.4f} ms ({b_by})")
    recs["flash_attention_lse"]["checks"] = {"out": c_out, "lse": c_lse}
    log(f"4a LSE: {json.dumps(c_lse)}; the row that sees no key gives "
        f"out 0, LSE -1e30, dQ 0: {unseen_ok}; dQ, dK, dV bit-equal over "
        f"two calls: {bit_equal}")
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        recs[name]["bit_equal"] = bit_equal
    shares = [c_out["tol_share"], c_lse["tol_share"], c_dq["tol_share"],
              c_dk["tol_share"], c_dv["tol_share"]]
    if not (unseen_ok and bit_equal and all(x <= 1.0 for x in shares)):
        raise AssertionError(f"training kernels disagree: {shares} "
                             f"unseen row ok {unseen_ok}, bit-equal "
                             f"{bit_equal}")
    return recs


def vln_batches(torch, np, cfg, tok, n_micro, per_micro, seed=0):
    """Micro-batches of VLN training samples: each sample is the second
    32-step window of a random 64-step episode (8 <memory> frames + 8
    current frames), its 480x640 uint8 frames made and preprocessed on
    the card, its dialogue tokenized and the batch collated by the port's
    own data code."""
    from streamvln_tpu_torch.data.collate import collate
    from streamvln_tpu_torch.data.vln_dataset import vln_sample, vln_window
    from streamvln_tpu_torch.ops.preprocess import preprocess_frames
    rng = np.random.default_rng(seed)
    g = torch.Generator(device="cuda").manual_seed(seed)
    rooms = ("kitchen", "bedroom", "hallway", "stairs", "sofa", "bathroom")
    batches = []
    for _ in range(n_micro):
        samples = []
        for _ in range(per_micro):
            actions = rng.integers(1, 4, 64).tolist()
            time_ids, win, frame_ids = vln_window(cfg, actions, 32)
            frames = torch.randint(0, 256, (len(frame_ids), 480, 640, 3),
                                   generator=g, device="cuda",
                                   dtype=torch.uint8)
            a, b = rng.choice(len(rooms), 2, replace=False)
            instruction = (f"walk past the {rooms[a]} and stop at the "
                           f"{rooms[b]} door")
            images = preprocess_frames(frames, cfg.vision.image_size)
            samples.append(vln_sample(tok, cfg, images, instruction, win,
                                      32, time_ids, rng))
        batches.append(collate(samples, cfg))
    return batches


def lora_loss_and_grads(torch, streamvln, params, cfg, batch, attn_impl):
    """Loss of one micro-batch (remat, chunked CE) and the gradients of
    the LoRA leaves, outside the optimizer."""
    from streamvln_tpu_torch.parallel.train import LAYOUT_KEYS, tree_leaves
    lora = [t for p, t in tree_leaves(params) if t.requires_grad]
    layout = {k: torch.as_tensor(batch[k]).cuda() for k in LAYOUT_KEYS}
    images = batch["images"].to(params["vision"]["patch_w"].dtype)
    loss, _ = streamvln.forward_train(
        params, cfg, images, layout, attn_impl=attn_impl,
        remat=True, loss_chunk_size=512)
    grads = torch.autograd.grad(loss, lora)
    return loss.item(), torch.cat([x.float().flatten() for x in grads])


def train_full_width(torch, np, params, cfg, tok, fa, va):
    """Phase 4b: LoRA SFT steps of streamvln_7b at full width on the
    phase-3 weights; returns the record of the run and its micro-batches
    (phase 8 trains on them again)."""
    from streamvln_tpu_torch.models import lora as lora_lib
    from streamvln_tpu_torch.models import streamvln
    from streamvln_tpu_torch.parallel.train import (
        TrainConfig, create_train_state, make_train_step, tree_leaves)

    tcfg = TrainConfig(lora_only=True, grad_accum_steps=2, remat=True,
                       loss_chunk_size=512, total_steps=3)
    params = lora_lib.add_lora(
        params, torch.Generator(device="cuda").manual_seed(1), rank=16,
        alpha=32.0)
    state = create_train_state(params, tcfg)
    base = {p: t.to("cpu") for p, t in tree_leaves(params)
            if not lora_lib.is_lora_path(p)}
    lora_b0 = {p: t.detach().clone() for p, t in tree_leaves(params)
               if p.endswith("_lora_b")}
    n_micro = 3 * tcfg.grad_accum_steps
    t0 = time.perf_counter()
    batches = vln_batches(torch, np, cfg, tok, n_micro + 1, 2)
    torch.cuda.synchronize()
    T = batches[0]["token_ids"].shape[1]
    valid = [int(b["valid"].sum()) for b in batches]
    log(f"4b: {len(batches)} micro-batches of 2 VLN windows made and "
        f"collated in {time.perf_counter() - t0:.2f} s; bucket {T}, valid "
        f"tokens per micro-batch {valid}, images "
        f"{tuple(batches[0]['images'].shape)}")
    if T != 4096:
        raise AssertionError(f"expected the 4096 bucket, got {T}")
    tower_batch = batches[0]["images"].shape[0] * \
        batches[0]["images"].shape[1]            # windows x frames
    if tower_batch != TRAIN_TOWER_BATCH:
        raise AssertionError("phase 2 times K1 at a tower batch of "
                             f"{TRAIN_TOWER_BATCH}; 4b feeds {tower_batch}")

    # kernels vs dense attention on one micro-batch (also the warm-up)
    ref = {}
    for impl in ("auto", "dense"):
        t0 = time.perf_counter()
        ref[impl] = lora_loss_and_grads(torch, streamvln, params, cfg,
                                        batches[-1], impl)
        torch.cuda.synchronize()
        log(f"4b reference {impl}: loss {ref[impl][0]:.6f} in "
            f"{time.perf_counter() - t0:.2f} s")
    (la, ga), (ld, gd) = ref["auto"], ref["dense"]
    rel = abs(la - ld) / abs(ld)
    cos = torch.nn.functional.cosine_similarity(ga, gd, dim=0).item()
    log(f"4b kernels vs dense: loss rel diff {rel:.3e}, LoRA grad cosine "
        f"{cos:.6f}")
    if not (rel <= TRAIN_LOSS_RTOL and cos >= TRAIN_GRAD_MIN_COSINE):
        raise AssertionError("training through the kernels disagrees with "
                             "the dense attention path")
    del ref, ga, gd

    step = make_train_step(cfg, tcfg, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    fa.launches = fa.lse_launches = fa.dq_launches = fa.dkv_launches = 0
    va.launches, va.launches_by_batch = 0, {}
    metrics, micro_ms = [], []
    for i in range(n_micro):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batches[i])
        torch.cuda.synchronize()
        micro_ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append({"loss": m["loss"].item(),
                        "grad_norm": m["grad_norm"].item()})
        log(f"4b micro-step {i}: loss {metrics[-1]['loss']:.6f} grad_norm "
            f"{metrics[-1]['grad_norm']:.6f} {micro_ms[-1]:.2f} ms")
    counts = {"vit_attention": va.launches, "flash_attention": fa.launches,
              "flash_attention_lse": fa.lse_launches,
              "flash_bwd_dq": fa.dq_launches,
              "flash_bwd_dkv": fa.dkv_launches}
    vit_by_batch = by_batch(va)
    peak = torch.cuda.max_memory_allocated()
    L, Lv = cfg.llm.num_layers, cfg.vision.num_layers
    # per micro-step: the frozen tower runs K1 once per layer (no grad, so
    # no recompute); each decoder layer runs K3 in the forward and again
    # in its checkpoint's recompute, then K4 and K5 once in the backward;
    # K2 (the no-grad prefill kernel) never
    want = {"vit_attention": Lv * n_micro, "flash_attention": 0,
            "flash_attention_lse": 2 * L * n_micro,
            "flash_bwd_dq": L * n_micro, "flash_bwd_dkv": L * n_micro}
    log(f"4b launches on the training path: {counts} (want {want}); K1 "
        f"by batch {vit_by_batch}")
    opt_ms = [sum(micro_ms[i:i + 2]) for i in range(0, n_micro, 2)]
    tok_step = [valid[i] + valid[i + 1] for i in range(0, n_micro, 2)]
    rates = [n / ms * 1e3 for ms, n in zip(opt_ms, tok_step)]
    for j, (ms, n, r) in enumerate(zip(opt_ms, tok_step, rates)):
        log(f"4b optimizer step {j}: {ms:.2f} ms, {n} valid tokens, "
            f"{r:.1f} tokens/s")
    med, med_rate = float(np.median(opt_ms)), float(np.median(rates))
    log(f"4b median optimizer step {med:.2f} ms, {med_rate:.1f} valid "
        f"tokens/s; peak memory allocated {peak / 2**30:.2f} GiB")

    finite = all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
                 and m["grad_norm"] > 0 for m in metrics)
    frozen_ok = all(torch.equal(t.to("cpu"), base[p])
                    for p, t in tree_leaves(state.params) if p in base)
    moved = sum(not torch.equal(t, lora_b0[p])
                for p, t in tree_leaves(state.params) if p in lora_b0)
    log(f"4b checks: finite losses and grad norms > 0 {finite}; base "
        f"weights bit-identical {frozen_ok}; LoRA B stacks changed {moved} "
        f"of {len(lora_b0)}")
    require("LoRA training", finite=finite, frozen_weights=frozen_ok,
            adapters_moved=moved == len(lora_b0), launch_counts=counts == want,
            k1_batches=sum(vit_by_batch.values()) == counts["vit_attention"])

    prof = profile_call(torch, lambda: step(state, batches[-1]),
                        float(np.median(micro_ms[1:])))
    return {"train_config": {k: getattr(tcfg, k) for k in (
                "lora_only", "grad_accum_steps", "remat", "loss_chunk_size",
                "total_steps", "learning_rate")},
            "lora": {"rank": 16, "alpha": 32.0,
                     "targets": list(lora_lib.DEFAULT_TARGETS)},
            "bucket": T, "valid_tokens": valid, "metrics": metrics,
            "micro_ms": micro_ms, "optimizer_step_ms": opt_ms,
            "median_step_ms": med,
            "tokens_per_s": med_rate,
            "peak_memory_bytes": peak, "launches": counts,
            "vit_launches_by_batch": vit_by_batch,
            "reference": {"loss_rel_diff": rel, "lora_grad_cosine": cos},
            "profile": prof}, batches


def profile_call(torch, fn, unprofiled_ms) -> dict:
    """One call of `fn` (an agent model call, a train micro-step) under
    torch.profiler: device busy time as the union of kernel intervals, and
    kernels ranked by device time. The idle share is taken against
    `unprofiled_ms` (the median wall time of the same kind of call without
    the profiler, whose overhead would inflate it) and, for reference,
    against the profiled call's own wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy_us = busy_within(spans)
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
                   for n, (t, c) in top],
           "kernel_names": sorted(n[:120] for n in by_name),
           **host_ops(prof, spans)}
    log(f"profile: device busy {busy:.2f} ms; idle share "
        f"{rec['device_idle_share']:.3f} of the unprofiled median wall "
        f"{unprofiled_ms:.2f} ms ({rec['device_idle_share_profiled_wall']:.3f}"
        f" of the profiled wall {wall:.2f} ms); {len(spans)} kernel launches")
    log(f"  host runtime calls {rec['runtime_calls']}; between graph "
        f"launches {rec['between_graph_launches']} over "
        f"{rec['graph_intervals']} decode forwards: "
        f"{rec['host_ops_per_decode_forward']} kernel launches or copies "
        f"per decode forward besides its graph launch and flag read")
    if rec["graph_intervals"]:
        log(f"  decode window (first to last graph launch) "
            f"{rec['decode_window_ms']:.2f} ms, device busy "
            f"{rec['decode_window_busy_ms']:.2f} ms (idle share "
            f"{rec['decode_window_idle_share']:.3f}); host us per decode "
            f"forward by call {rec['host_us_per_forward']}")
    for r in rec["top"]:
        log(f"  {r['ms']:9.3f} ms {r['count']:6d}x {r['name']}")
    return rec


HOST_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx")
HOST_COPIES = ("cudaMemcpyAsync", "cudaMemsetAsync", "cudaMemcpy",
               "cudaMemset")


def busy_within(spans, lo=float("-inf"), hi=float("inf")) -> float:
    """Microseconds covered by the union of (start, end) intervals,
    clipped to [lo, hi]."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def host_ops(prof, spans) -> dict:
    """Kernel launches, copies and graph launches the host issued in a
    profiled call (CUDA runtime and driver calls traced by the profiler),
    and those issued between its first and its last graph launch: each
    such interval is one decode forward after the first, and holds its
    graph launch and the copy that reads the loop's flag. Host operations
    per decode forward = launches and copies in the intervals over their
    count, less that one copy (null without two graph launches). Also
    that window's length, the device's busy time in it (`spans`, the
    kernels' intervals), and the host microseconds per forward spent in
    each runtime call there (the flag read's synchronize waits for the
    device; the rest is the host's own)."""
    from torch.autograd import DeviceType
    calls = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == DeviceType.CPU
                   and e.name.startswith(("cuda", "cu")))
    counts, between, host_us = {}, {}, {}
    graph = [t for t, _, n in calls if n == "cudaGraphLaunch"]
    intervals = max(len(graph) - 1, 0)
    for t, end, n in calls:
        counts[n] = counts.get(n, 0) + 1
        if intervals and graph[0] <= t < graph[-1]:
            host_us[n] = host_us.get(n, 0.0) + (end - t) / intervals
            if t > graph[0]:
                between[n] = between.get(n, 0) + 1
    ops = sum(v for n, v in between.items()
              if n in HOST_LAUNCHES + HOST_COPIES)
    rec = {"runtime_calls": counts, "between_graph_launches": between,
           "graph_launches": len(graph), "graph_intervals": intervals,
           "host_ops_per_decode_forward":
               ops / intervals - 1 if intervals else None}
    if intervals:
        window = (graph[-1] - graph[0]) / 1e3
        busy = busy_within(spans, graph[0], graph[-1]) / 1e3
        rec.update(decode_window_ms=window, decode_window_busy_ms=busy,
                   decode_window_idle_share=1.0 - busy / window,
                   host_us_per_forward={n: round(v, 1)
                                        for n, v in host_us.items()})
    return rec


def record_calls(torch, engine):
    """Record each collected call's tokens, phase times and whether its
    logits are finite; returns (records, a function that stops it)."""
    calls = []
    collect = engine.collect

    def recording_collect(handle):
        out = collect(handle)
        calls.append({"tokens": out[0], "phase_ms": engine.last_phase_ms,
                      "logits_finite": bool(torch.isfinite(
                          engine.last_logits).all())})
        return out
    engine.collect = recording_collect

    def restore():
        engine.collect = collect
    return calls, restore


def drive_calls(torch, agent, engine, cfg, frames, instruction, reset,
                n_steps=33):
    """A warm-up call (its state reset), then VLNAgent.step over steps
    0..n_steps-1 of 480x640 frames with a model call every
    num_future_steps (33 steps: 9 calls, the window reset and the
    <memory> call at step 32). `reset()` zeroes the launch counts just
    before the steps. Checks tokens, finite logits and the KV
    bookkeeping; returns (calls, wall ms of each call)."""
    calls, restore = record_calls(torch, engine)
    agent.step(0, frames[0], instruction, run_model=True)
    agent.reset_memory(0)
    calls.clear()
    torch.cuda.synchronize()
    reset()
    wall = []
    for step in range(n_steps):
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
    restore()
    want = -(-n_steps // cfg.num_future_steps)
    if len(calls) != want:
        raise AssertionError(f"expected {want} model calls, got "
                             f"{len(calls)}")
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
    return calls, wall


def fed_tokens(calls) -> int:
    """Decode forwards of the calls: every token after a call's first
    (which comes from the prefill) was produced by feeding the one before
    it."""
    return sum(len(c["tokens"]) - 1 for c in calls)


def logits_agreement(torch, a, b) -> dict:
    a, b = a.float(), b.float()
    return {"cosine": torch.nn.functional.cosine_similarity(
                a, b, dim=-1).min().item(),
            "max_rel_diff": ((a - b).abs().max() / b.abs().max()).item(),
            "top1_agree": bool((a.argmax(-1) == b.argmax(-1)).all())}


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def serve_decode_kernel(torch, fused, cfg, tok, frames, instruction,
                        counts, reset):
    """Phase 3b: two agent calls of an engine under
    attn_impl="decode_kernel" (K8 at every decode step, dense tower and
    prefill) on the phase-3 weights; K8 must run exactly 28 times per fed
    token and K1 never. Then
    one more decode step from that engine's cache, through K8 and through
    the dense path on identical copies of the cache: the logits must agree
    (cosine > 0.99)."""
    from streamvln_tpu_torch.agent import VLNAgent
    from streamvln_tpu_torch.models import qwen2
    from streamvln_tpu_torch.streaming.engine import StreamingEngine
    eng = StreamingEngine(fused, cfg, cache_capacity=4096,
                          max_new_tokens=16, stop_ids=(tok.im_end_id,),
                          attn_impl="decode_kernel")
    agent = VLNAgent(eng, tok)
    calls, wall = drive_calls(torch, agent, eng, cfg, frames, instruction,
                              reset, n_steps=5)
    got = counts()
    fed = fed_tokens(calls)
    L = cfg.llm.num_layers
    # the tower runs dense under decode_kernel (the reference's dispatch)
    want = {"vit_attention": 0, "flash_attention": 0, "int4_matmul": 0,
            "int4_dequant_split": 0, "decode_attention": L * fed}
    log(f"3b launches under decode_kernel ({len(calls)} calls, {fed} fed "
        f"tokens): {got} (want {want})")
    if got != want:
        raise AssertionError("decode_kernel launch counts do not match")

    def step_logits(impl):
        c = qwen2.KVCache(eng.cache.k.clone(), eng.cache.v.clone(),
                          eng.cache.length.clone())
        ids = torch.tensor([[eng.envs[0].pending_token]], device=eng.device)
        emb = qwen2.embed_tokens(eng.params["llm"], ids).to(torch.bfloat16)
        logits, _ = qwen2.forward(eng.params["llm"], cfg.llm, emb,
                                  c.length[:, None], cache=c,
                                  attn_impl=impl)
        del c
        return logits[:, 0]
    with torch.no_grad():
        agree = logits_agreement(torch, step_logits("decode_kernel"),
                                 step_logits("dense"))
    agree["cache_length"] = int(eng.cache.length[0])
    log(f"3b decode-step logits, K8 vs dense on the same cache (length "
        f"{agree['cache_length']}): cosine {agree['cosine']:.6f} max rel "
        f"diff {agree['max_rel_diff']:.3e} top-1 agree "
        f"{agree['top1_agree']}")
    if not agree["cosine"] > REF_MIN_COSINE:
        raise AssertionError("decode kernel disagrees with the dense path")
    return {"calls": calls, "wall_ms": wall, "fed_tokens": fed,
            "launches": got, "reference": agree}, eng


def serve_int4(torch, np, params, cfg, tok, frames, instruction, counts,
               reset):
    """Phase 3c: the phase-3 weights quantized on the card by the port's
    quantize_llm(bits=4); an engine (which fuses q/k/v and gate/up) runs the 9
    agent calls over steps 0..32 as phase 3 does, with exact launch
    counts; then the first call's prefill logits against the same int4
    weights dequantized to bf16 (dequantize_llm) on the dense path, and
    one profiled mid-window call."""
    from streamvln_tpu_torch.agent import VLNAgent
    from streamvln_tpu_torch.models import quant
    from streamvln_tpu_torch.streaming.engine import StreamingEngine
    t0 = time.perf_counter()
    q4 = quant.quantize_llm(params, bits=4)
    torch.cuda.synchronize()
    q_s = time.perf_counter() - t0
    gib = {"llm_bf16": tree_bytes(params["llm"]) / 2**30,
           "llm_int4": tree_bytes(q4["llm"]) / 2**30}
    log(f"3c: quantize_llm(bits=4) on the card in {q_s:.2f} s; LLM weights "
        f"{gib['llm_int4']:.3f} GiB int4 (embed bf16) vs "
        f"{gib['llm_bf16']:.3f} GiB bf16")
    eng = StreamingEngine(q4, cfg, cache_capacity=4096, max_new_tokens=16,
                          stop_ids=(tok.im_end_id,))
    del q4
    agent = VLNAgent(eng, tok)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    calls, wall = drive_calls(torch, agent, eng, cfg, frames, instruction,
                              reset)
    got = counts()
    peak = torch.cuda.max_memory_allocated()
    fed = fed_tokens(calls)
    L, n = cfg.llm.num_layers, len(calls)
    # per call: K1 per tower layer, K2 per layer (prefill), K7 for the 4
    # fused projections of each layer (prefill rows > 128), K6 for the
    # prefill's one-row lm_head and, per fed token, 4 per layer + lm_head
    want = {"vit_attention": cfg.vision.num_layers * n,
            "flash_attention": L * n, "int4_matmul": n + (4 * L + 1) * fed,
            "int4_dequant_split": 4 * L * n, "decode_attention": 0}
    log(f"3c launches on the int4 path ({n} calls, {fed} fed tokens): {got} "
        f"(want {want}); peak memory allocated {peak / 2**30:.2f} GiB")
    if got != want:
        raise AssertionError("int4 launch counts do not match the path")
    prof = profile_call(torch, lambda: agent.step(
        0, frames[-1], instruction, run_model=True),
        float(np.median(wall[1:8])))

    # reference: prefill logits of the first call, int4 kernels vs the
    # same int4 weights dequantized to bf16 on the dense path
    outs = []
    dq = quant.dequantize_llm(eng.params, torch.bfloat16)
    for tree, impl in ((eng.params, "auto"), (dq, "dense")):
        e = StreamingEngine(tree, cfg, cache_capacity=4096, max_new_tokens=2,
                            stop_ids=(tok.im_end_id,), attn_impl=impl)
        VLNAgent(e, tok).step(0, frames[0], instruction, run_model=True)
        outs.append(e.last_logits.float())
        del e
    del dq
    agree = logits_agreement(torch, *outs)
    log(f"3c reference (prefill logits, int4 kernels vs dequantized bf16 "
        f"dense): cosine {agree['cosine']:.6f} max rel diff "
        f"{agree['max_rel_diff']:.3e} top-1 agree {agree['top1_agree']}")
    if not agree["cosine"] > REF_MIN_COSINE:
        raise AssertionError("int4 path disagrees with its dequantized "
                             "reference")
    torch.cuda.empty_cache()
    return {"calls": calls, "wall_ms": wall, "fed_tokens": fed,
            "launches": got, "weights_gib": gib, "quantize_s": q_s,
            "peak_memory_bytes": peak, "profile": prof,
            "reference": agree}, eng


def paired_timing(torch, np, engines, cfg, tok, frames, instruction,
                  what="3d"):
    """Phase 3d: the serving variants in turns on one host and card. Each
    engine gets a fresh agent; for steps 0..32 every agent takes the same
    step, and at each model call the order of the engines rotates, so
    host noise falls on all of them alike. Decode ms per token is per
    emitted token (a speculative forward emits several); tokens per
    forward is the decode loop's emitted tokens over its forwards. Returns
    per-engine call records and medians over the mid-window calls 1..7."""
    from streamvln_tpu_torch.agent import VLNAgent
    names = list(engines)
    agents = {n: VLNAgent(engines[n], tok) for n in names}
    recs = {n: [] for n in names}
    for n in names:
        agents[n].reset_memory(0)
    k = 0
    for step in range(33):
        run = step % cfg.num_future_steps == 0
        order = names[k % len(names):] + names[:k % len(names)]
        for n in order:
            calls, restore = record_calls(torch, engines[n])
            f0 = engines[n].decode_forwards
            t0 = time.perf_counter()
            agents[n].step(0, frames[step], instruction, run_model=run)
            if run:
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
                c = calls[0]
                vis, pre, dec = c["phase_ms"]
                emitted = len(c["tokens"]) - 1
                forwards = engines[n].decode_forwards - f0
                recs[n].append({"wall_ms": wall, "vision_ms": vis,
                                "prefill_ms": pre, "decode_ms": dec,
                                "tokens": len(c["tokens"]),
                                "forwards": forwards,
                                "tokens_per_forward":
                                    emitted / max(forwards, 1),
                                "decode_ms_per_token":
                                    dec / max(emitted, 1)})
            restore()
        k += run
    out = {}
    for n in names:
        mid = recs[n][1:8]
        med = {key: float(np.median([r[key] for r in mid])) for key in (
            "wall_ms", "vision_ms", "prefill_ms", "decode_ms_per_token",
            "tokens_per_forward")}
        emitted = sum(r["tokens"] - 1 for r in recs[n])
        forwards = sum(r["forwards"] for r in recs[n])
        log(f"{what} {n}: one more mid-window call under the profiler")
        prof = profile_call(torch, lambda: agents[n].step(
            0, frames[-1], instruction, run_model=True), med["wall_ms"])
        out[n] = {"calls": recs[n], "median_mid_window": med,
                  "memory_call": recs[n][-1],
                  "tokens_per_forward": emitted / max(forwards, 1),
                  "profile": prof}
        log(f"{what} {n}: mid-window medians wall {med['wall_ms']:.2f} ms, "
            f"vision {med['vision_ms']:.2f}, prefill {med['prefill_ms']:.2f},"
            f" decode {med['decode_ms_per_token']:.2f} ms per emitted token; "
            f"{emitted} tokens in {forwards} decode forwards over the "
            f"{len(recs[n])} calls ({out[n]['tokens_per_forward']:.3f} per "
            f"forward); <memory> call prefill "
            f"{recs[n][-1]['prefill_ms']:.2f} ms")
    return out


def strict_captures(torch, captures: list):
    """From here on, capture every decode graph under
    torch.cuda.set_sync_debug_mode("error"), so that a synchronizing
    operation in a step's warm-up or capture raises, and record each
    capture: its loop kind, batch, queries per forward, seconds (warm-up
    and capture) and the launches each replay adds per kernel."""
    from streamvln_tpu_torch.streaming import decode_graph as dg
    init = dg.StepGraph.__init__

    def strict(self, fn, state, reads, generator=None):
        torch.cuda.set_sync_debug_mode("error")
        try:
            init(self, fn, state, reads, generator)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        B, S = self.outputs["logits"].shape[:2]
        kind = "verify" if "drafts" in self.outputs else \
            "sample" if generator is not None else "token"
        rec = {"kind": kind, "batch": B, "queries": S,
               "seconds": self.capture_s, "per_replay": {
                   f"{m.__name__.rsplit('.', 1)[-1]}.{a}": d
                   for (m, a), d in zip(dg.COUNTERS, self.per_replay)}}
        captures.append(rec)
    dg.StepGraph.__init__ = strict


def log_captures(what, captures):
    """One line: each decode graph captured, its seconds and the port
    kernels each of its replays launches."""
    def one(c):
        per = ", ".join(f"{k} {v}" for k, v in c["per_replay"].items() if v)
        return (f"{c['kind']} B={c['batch']} S={c['queries']} "
                f"{c['seconds']:.3f} s ({per or 'no port kernel'})")
    log(f"{what}: {len(captures)} decode graphs captured: "
        + "; ".join(one(c) for c in captures))


def graphs_vs_eager(torch, engines, cfg, tok, frames, instruction,
                    what="3g"):
    """Phase 3g: each serving variant over steps 0..32 (9 calls across the
    window reset and its <memory> call), every decode forward checked:
    before each replay the captured step runs eagerly from the state the
    replay starts from (cache, shadow, loop state; those are put back
    after it, and its launches are taken back from the counts), and the
    replay must give the same logits (and drafts), tokens and state, bit
    for bit. Every decode forward must be a replay. Then a cache length
    rebound to a new tensor must make the next replay raise."""
    from streamvln_tpu_torch.agent import VLNAgent
    from streamvln_tpu_torch.streaming import decode_graph as dg
    replay = dg.StepGraph.replay
    box = {"replays": 0, "differ": []}

    def checked(self):
        live = {n: t for n, t in self._reads().items()
                if not n.startswith("llm/")}
        live.update({f"state.{k}": v for k, v in self.state.items()})
        saved = {n: t.clone() for n, t in live.items()}
        counts = dg._counts()
        eager_out = {k: v.clone() for k, v in self.fn(self.state).items()}
        eager = {n: t.clone() for n, t in live.items()}
        dg._add([a - b for a, b in zip(counts, dg._counts())])
        for n, t in live.items():
            t.copy_(saved[n])
        replay(self)
        differ = [n for n in eager_out
                  if not torch.equal(eager_out[n], self.outputs[n])]
        differ += [n for n in live if not torch.equal(eager[n], live[n])]
        box["replays"] += 1
        if differ:
            box["differ"].append(differ)
    out = {}
    dg.StepGraph.replay = checked
    try:
        for name, eng in engines.items():
            agent = VLNAgent(eng, tok)
            agent.reset_memory(0)
            r0, f0, d0 = box["replays"], eng.decode_forwards, \
                len(box["differ"])
            for step in range(33):
                agent.step(0, frames[step], instruction,
                           run_model=step % cfg.num_future_steps == 0)
            out[name] = {"replays": box["replays"] - r0,
                         "decode_forwards": eng.decode_forwards - f0,
                         "differing_replays": box["differ"][d0:]}
            log(f"{what} {name}: {out[name]['replays']} replays for "
                f"{out[name]['decode_forwards']} decode forwards over 9 "
                f"calls, {len(out[name]['differing_replays'])} differing "
                f"from the eager step")
    finally:
        dg.StepGraph.replay = replay
    eng = next(iter(engines.values()))
    length = eng.cache.length
    eng.cache.length = length.clone()
    try:
        next(iter(eng.graphs.values())).replay()
        raised = ""
    except RuntimeError as err:
        raised = str(err)
    eng.cache.length = length
    log(f"{what} a cache length rebound to a new tensor: the next replay "
        f"raised {raised!r}")
    for name, r in out.items():
        require(f"{what} {name}", every_forward_a_replay=r["replays"]
                == r["decode_forwards"] > 0,
                replays_bit_equal_to_eager=not r["differing_replays"])
    require(f"{what} rebound tensor", raises="no longer hold the storage"
            in raised)
    return {"variants": out, "rebound_raised": raised}


def capture_decode():
    """Record, for batch row 0, the f32 logits of every decode forward and
    the drafts of every speculative one, read from the captured graph's
    static output buffers after each replay (a replay runs no Python of
    the step); returns (record, stop)."""
    from streamvln_tpu_torch.streaming.decode_graph import StepGraph
    rec = {"logits": [], "drafts": []}
    replay = StepGraph.replay

    def recorded(self):
        replay(self)
        rec["logits"].append(self.outputs["logits"][0].float().clone())
        if "drafts" in self.outputs:
            rec["drafts"].append(self.outputs["drafts"][0].tolist())
    StepGraph.replay = recorded

    def stop():
        StepGraph.replay = replay
    return rec, stop


def position_logits(prefill, rec, n_tokens, k, stop_ids, max_new):
    """The logits that chose each emitted token of one call: the prefill's
    (`prefill` [V]) for token 0, then per decode forward its one column
    (greedy) or the columns it emitted (speculative: 1 + the accepted
    draft prefix, cut at the first stop token and at the budget, as
    _verify_step does)."""
    pos = [prefill]
    for i, lg in enumerate(rec["logits"]):
        if not k:
            pos.append(lg[0])
            continue
        truth, d = lg.argmax(-1).tolist(), rec["drafts"][i]
        e = 1
        while e <= k and d[e - 1] == truth[e - 1]:
            e += 1
        stops = [j for j in range(e) if truth[j] in stop_ids]
        e = min(stops[0] + 1 if stops else e, max_new - len(pos))
        pos += [lg[j] for j in range(e)]
    if len(pos) != n_tokens:
        raise AssertionError(f"{len(pos)} logit rows for {n_tokens} tokens")
    return pos


def spec_vs_greedy(torch, np, fused, cfg, tok, frames, instruction,
                   steps=33, capacity=4096, buckets=None):
    """Speculative decode (spec_lookup=6) against greedy: two engines on
    the same weights take the agent's calls over `steps` steps in lockstep,
    each call's per-position logits recorded. Speculation is exact only in
    exact arithmetic: in bf16 the 7-query verify forward and the 1-query
    step round differently, so a call may differ.

    The two paths' rounding is measured where they agree: R is the largest
    |g_v - p_v| (g: greedy logits, p: the verify forward's, over the whole
    vocabulary) at every position up to, not including, each call's first
    difference. At a first difference, the greedy top-1 token t must beat
    the speculative choice s, s must be the greedy runner-up, and the
    greedy gap must satisfy g_t - g_s <= SPEC_FLIP_BOUND x R: p orders s
    over t only if g_t - g_s <= |p_t - g_t| + |p_s - g_s|, which is at most
    2R where the rounding is no larger than at the agreeing positions. A
    flip at a gap the observed rounding cannot explain fails. Every
    position compared (up to the first difference) must also agree in
    direction (cosine >= SPEC_MIN_COSINE). After a differing call the
    speculative engine takes the greedy engine's KV cache, lengths and
    pending token, and the greedy tokens into its shadow, so every call
    starts from the same dialogue."""
    from streamvln_tpu_torch.streaming.engine import StreamingEngine
    k = 6
    kw = {} if buckets is None else {"buckets": buckets}
    greedy, spec = (StreamingEngine(fused, cfg, cache_capacity=capacity,
                                    max_new_tokens=16, spec_lookup=n,
                                    stop_ids=(tok.im_end_id,), **kw)
                    for n in (0, k))
    return lockstep(torch, greedy, spec, cfg, tok, frames, instruction,
                    resync, f"spec vs greedy (spec_lookup={k})", steps)


def lockstep(torch, ref, other, cfg, tok, frames, instruction, sync, what,
             steps=33) -> dict:
    """Two engines on the same weights take the agent's calls over `steps`
    steps in lockstep, each call's per-position logits recorded (every
    decode forward must be a graph replay); `ref` is the reference path
    (greedy), `other` the path held to it. Each call's tokens must be
    equal or part at a near-tie (paths_part, require_near_ties), every
    compared position must point the same way (SPEC_MIN_COSINE), and
    after a differing call sync(other, ref, ref's tokens) gives `other`
    the reference's dialogue, so every call starts from the same one."""
    from streamvln_tpu_torch.agent import VLNAgent
    engines = {"ref": ref, "other": other}
    agents = {n: VLNAgent(e, tok) for n, e in engines.items()}
    calls, identical, flips, agree_deltas = [], 0, [], []
    for step in range(steps):
        run = step % cfg.num_future_steps == 0
        got = {}
        for name, agent in agents.items():
            rec, stop = capture_decode()
            e = engines[name]
            made, restore = record_calls(torch, e)
            f0 = e.decode_forwards
            try:
                agent.step(0, frames[step], instruction, run_model=run)
            finally:
                stop()
                restore()
            if e.envs[0].kv_length != int(e.cache.length[0]):
                raise AssertionError(f"{what}, {name} step {step}: KV "
                                     f"length {int(e.cache.length[0])} != "
                                     f"bookkeeping {e.envs[0].kv_length}")
            # every decode forward is a graph replay, and each replay was
            # recorded from the graph's output buffers
            if len(rec["logits"]) != e.decode_forwards - f0:
                raise AssertionError(
                    f"{what}, {name} step {step}: recorded "
                    f"{len(rec['logits'])} decode forwards, the engine "
                    f"counted {e.decode_forwards - f0}")
            if run:
                toks = made[0]["tokens"]
                got[name] = (toks, position_logits(
                    e.last_logits[0].float(), rec, len(toks), e.spec_lookup,
                    e.stop_ids, e.max_new))
        if not run:
            continue
        (gt, gl), (st, sl) = got["ref"], got["other"]
        c = {"call": len(calls), "greedy": gt, "spec": st,
             **paths_part(torch, gt, gl, st, sl, agree_deltas)}
        calls.append(c)
        if c["min_cosine"] < SPEC_MIN_COSINE:
            raise AssertionError(f"{what} call {c['call']}: logits disagree "
                                 f"in direction ({c['min_cosine']:.6f})")
        if "position" not in c:
            identical += 1
            continue
        flips.append(c)
        sync(other, ref, gt)
    rounding, bound = require_near_ties(what, flips, agree_deltas)
    diffs = [c["call"] for c in flips]
    emitted, forwards = other.decode_tokens, other.decode_forwards
    log(f"{what}: {identical} of {len(calls)} calls identical; calls "
        f"{diffs} differ within the bound; max |logit diff| over compared "
        f"positions {max(c['max_abs_logit_diff'] for c in calls):.4f} "
        f"(agreeing positions {rounding:.4f}), min cosine "
        f"{min(c['min_cosine'] for c in calls):.6f}; the other engine "
        f"{emitted} tokens in {forwards} decode forwards")
    del engines, agents
    return {"identical_calls": identical, "compared_calls": len(calls),
            "calls": calls, "differing_calls": diffs,
            "rounding_at_agreeing_positions": rounding,
            "agreeing_positions": len(agree_deltas), "flip_bound": bound,
            "spec_tokens": emitted, "spec_forwards": forwards}


def paths_part(torch, gt, gl, st, sl, agree_deltas) -> dict:
    """Where two decode paths of one call part: `gt`/`gl` the reference
    path's tokens and the logits that chose each (greedy, or a request
    served alone), `st`/`sl` the other path's (speculative, or a row of a
    batch). The largest |logit difference| and the least cosine over the
    positions up to the first differing token, that token's record
    (position, both tokens, the reference's top two, its gap between
    them, the logit difference there) if the tokens part, and each
    agreeing position's largest difference appended to `agree_deltas`."""
    n = min(len(gt), len(st))
    first = next((i for i in range(n) if gt[i] != st[i]), None)
    upto = n if first is None else first + 1
    deltas = [float((gl[i] - sl[i]).abs().max()) for i in range(upto)]
    cos = [float(torch.nn.functional.cosine_similarity(
        gl[i], sl[i], dim=0)) for i in range(upto)]
    rec = {"max_abs_logit_diff": max(deltas), "min_cosine": min(cos)}
    if first is None:
        if len(gt) != len(st):
            raise AssertionError(f"one path stopped early: {st} vs {gt}")
        agree_deltas += deltas
        return rec
    agree_deltas += deltas[:first]
    g, sp = gl[first], sl[first]
    t, s_tok = gt[first], st[first]
    rec.update(position=first, greedy_token=t, spec_token=s_tok,
               greedy_top2=g.topk(2).indices.tolist(),
               greedy_gap=float(g[t] - g[s_tok]),
               spec_pick_gap=float(sp[s_tok] - sp[t]),
               logit_diff_there=deltas[first])
    return rec


def require_near_ties(what, flips, agree_deltas):
    """Every parting (`paths_part`) must be a near-tie: the reference
    path's token its top-1, the other path's its runner-up, and the gap
    between them within SPEC_FLIP_BOUND x R, R the largest logit
    difference at the positions where the paths agree (the most rounding
    was seen to move a logit). Returns (R, the bound)."""
    if flips and not agree_deltas:
        raise AssertionError(f"{what}: the paths part with no agreeing "
                             f"position to measure rounding at")
    rounding = max(agree_deltas, default=0.0)
    bound = SPEC_FLIP_BOUND * rounding
    for c in flips:
        c["bound"] = bound
        log(f"{what}: call {c['call']} differs at position "
            f"{c['position']}: reference {c['greedy_token']} (top-2 "
            f"{c['greedy_top2']}), other {c['spec_token']}; reference "
            f"gap {c['greedy_gap']:.4f} <= bound {bound:.4f} (= "
            f"{SPEC_FLIP_BOUND} x max |logit diff| {rounding:.4f} over "
            f"{len(agree_deltas)} agreeing positions; "
            f"{c['logit_diff_there']:.4f} there)?")
        require(f"{what}, call {c['call']}",
                reference_top1=c["greedy_top2"][0] == c["greedy_token"],
                other_is_reference_runner_up=c["greedy_top2"][1]
                == c["spec_token"],
                gap_within_rounding_bound=c["greedy_gap"] <= bound)
    return rounding, bound


def resync(spec, greedy, tokens):
    """Give the speculative engine the greedy engine's dialogue after a
    call whose tokens differed: its KV cache, lengths and env bookkeeping,
    and, in its token-id shadow, the greedy call's fed tokens (all but the
    pending last one) after the prompt the two engines share."""
    spec.cache.k.copy_(greedy.cache.k)
    spec.cache.v.copy_(greedy.cache.v)
    if spec.cache.quantized:
        spec.cache.k_scale.copy_(greedy.cache.k_scale)
        spec.cache.v_scale.copy_(greedy.cache.v_scale)
    spec.cache.length.copy_(greedy.cache.length)
    a, b = spec.envs[0], greedy.envs[0]
    a.pending_token, a.kv_length = b.pending_token, b.kv_length
    fed = tokens[:-1]
    start = b.kv_length - len(fed)
    spec.ids_buf[0, start:b.kv_length] = spec.ids_buf.new_tensor(fed)


def sampling_on_card(torch, fused, cfg, tok, frames, instruction):
    """Sampled decode on the card: a temperature 0.7 / top-p 0.9 call on
    two bf16 engines with the same sample_seed gives the same tokens, and
    so does an engine that runs its sampled steps eagerly (cuda_graphs
    off: the graph draws what the eager step draws); in one generate_batch
    of two envs, a greedy row beside a sampled row equals a greedy
    engine's row."""
    import numpy as np
    from streamvln_tpu_torch.data import chatml
    from streamvln_tpu_torch.streaming.engine import StreamingEngine
    ids, _ = chatml.tokenize_dialogue(
        tok, [("user", chatml.observation_prompt(None, instruction))],
        add_system=True, with_labels=False)
    ids = np.concatenate([ids, np.asarray(chatml.generation_prompt(tok),
                                          np.int32)])

    def engine(n_envs=1, graphs=True):
        e = StreamingEngine(fused, cfg, n_envs=n_envs, cache_capacity=4096,
                            max_new_tokens=16, stop_ids=(tok.im_end_id,),
                            cuda_graphs=graphs)
        e.sample_seed = 5
        return e
    runs = [engine(graphs=g).generate(0, frames[0], ids, step_id=0,
                                      temperature=0.7, top_p=0.9)
            for g in (True, True, False)]
    reqs = [(0, frames[0], ids, 0, ()), (1, frames[1], ids, 0, ())]
    greedy = engine(2).generate_batch(reqs)
    mixed = engine(2).generate_batch(reqs, temperature={1: 0.7},
                                     top_p={1: 0.9})
    rec = {"sampled": runs[0], "same_seed_equal": runs[0] == runs[1],
           "eager_equal": runs[0] == runs[2],
           "greedy_row": greedy[0], "mixed_greedy_row": mixed[0],
           "mixed_sampled_row": mixed[1],
           "greedy_row_equal": mixed[0] == greedy[0]}
    log(f"sampling on the card: T=0.7 top-p 0.9 tokens {runs[0]}; same seed "
        f"same tokens {rec['same_seed_equal']}, eager steps the same tokens "
        f"{rec['eager_equal']}; greedy row beside a sampled row equals the "
        f"greedy engine's {rec['greedy_row_equal']}")
    require("sampled decode on the card", tokens_in_vocabulary=all(
        0 <= t < cfg.llm.vocab_size for t in runs[0] + mixed[1]),
        tokens_emitted=bool(runs[0]),
        same_seed_same_tokens=rec["same_seed_equal"],
        graph_draws_the_eager_tokens=rec["eager_equal"],
        greedy_row_equal=rec["greedy_row_equal"])
    return rec


def steer_to_walk(params):
    """Make random weights walk in the fake env: their text holds no action
    glyph, so the agent would STOP at an episode's first step. The
    residual writes of every decoder layer (o_w, down_w) are scaled by
    STEER_RESIDUAL, so the final hidden state stays along the current
    token's embedding, and the lm_head column of the next token of the
    chain "\n" -> e2 -> 86 -> 91 -> e2 (the UTF-8 bytes of the up arrow)
    gains STEER_LOGIT * e_cur / (|e_cur| sqrt(D)): about STEER_LOGIT logits
    where the hidden state points along e_cur, against random logits of
    unit spread. Calls then emit five up arrows; the towers, shapes and
    kernels are unchanged."""
    llm = params["llm"]
    for name in ("o_w", "down_w"):
        llm["layers"][name].mul_(STEER_RESIDUAL)
    emb, head = llm["embed"].float(), llm["lm_head"]
    for cur, nxt in ((10, 0xE2), (0xE2, 0x86), (0x86, 0x91), (0x91, 0xE2)):
        e = emb[cur]
        head[:, nxt] += (STEER_LOGIT * e / (e.norm() * e.numel() ** 0.5)
                         ).to(head.dtype)


@contextlib.contextmanager
def steered_weights():
    """While open, the port's weights.init steers the weights it makes to
    walk (steer_to_walk)."""
    from streamvln_tpu_torch import weights
    init0 = weights.init

    def steered_init(*a, **k):
        p = init0(*a, **k)
        steer_to_walk(p)
        return p
    weights.init = steered_init
    try:
        yield
    finally:
        weights.init = init0


@contextlib.contextmanager
def counted_builds(torch, eval_cli, box):
    """While open, every agent eval_cli.build_agent builds counts its model
    calls (box["calls"]) and its history backfill passes that encode a
    frame (box["backfills"]) into `box`, which also gets the last engine
    ("engine"), its tokenizer's class ("tokenizer") and the device memory
    of the build ("build_peak_bytes":
    max_memory_allocated, reset before the build, read once the engine
    exists, less what was allocated before it)."""
    build0 = eval_cli.build_agent
    box.update(calls=0, backfills=0)

    def build_agent(*a, **k):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        agent = build0(*a, **k)
        torch.cuda.synchronize()
        box["build_peak_bytes"] = torch.cuda.max_memory_allocated() - base
        box["tokenizer"] = type(agent.tok).__name__
        eng = agent.engine
        collect, backfill = eng.collect, eng.backfill_batch

        def counted_collect(handle):
            box["calls"] += 1
            return collect(handle)

        def counted_backfill(env, frames_u8, step_ids):
            st = eng.envs[env]
            box["backfills"] += any(s not in st.frame_slots
                                    for s in step_ids)
            return backfill(env, frames_u8, step_ids)
        eng.collect, eng.backfill_batch = counted_collect, counted_backfill
        box["engine"] = eng
        return agent
    eval_cli.build_agent = build_agent
    try:
        yield box
    finally:
        eval_cli.build_agent = build0


def eval_entry_point(torch, va, counts, reset, flags=(), name="eval",
                     what="phase 5", model_size="7b"):
    """Phase 5: the evaluation entry point as users run it,
    eval_cli.main(--model_size 7b --env_backend fake --num_episodes 2
    --max_steps_per_episode 36, default --spec_lookup 6, and `flags`), in
    process on the card: build_agent makes streamvln_7b's random bf16
    weights (steered to walk, steer_to_walk), and VLNEvaluator runs two
    36-step episodes of 480x640 frames across the step-32 window reset and
    its <memory> call. Checks result.json (2 episode lines + the
    aggregate), the launch counts (K1 once per tower layer and K2 once per
    decoder layer per model call, K1 once per tower layer per history
    backfill pass) and that every verify forward was a graph replay, and
    reports the evaluator's model-call p50/p90, the realized tokens per
    verify forward, peak memory and whether the engine's KV cache and tower
    are int8 (phase 8b passes --kv_int8 --vision_int8)."""
    import io
    from streamvln_tpu_torch import eval_cli
    out_dir = os.path.join("chiprun_out", name)
    result = os.path.join(out_dir, "result.json")
    if os.path.exists(result):
        os.remove(result)               # result.json resumes otherwise
    box = {}
    printed = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset()
    t0 = time.perf_counter()
    with counted_builds(torch, eval_cli, box), steered_weights(), \
            contextlib.redirect_stdout(printed):
        final = eval_cli.main([
            "--model_size", model_size, "--env_backend", "fake",
            "--num_episodes", "2", "--max_steps_per_episode", "36",
            "--output_path", out_dir, *flags])
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got, by_b = counts(), by_batch(va)
    eng = box.pop("engine")
    peak = torch.cuda.max_memory_allocated()
    with open(result) as f:
        lines = [json.loads(x) for x in f]
    n, b = box["calls"], box["backfills"]
    Lv, L = eng.cfg.vision.num_layers, eng.cfg.llm.num_layers
    want = {"vit_attention": Lv * (n + b), "flash_attention": L * n,
            "int4_matmul": 0, "int4_dequant_split": 0, "decode_attention": 0}
    rec = {"final": final, "episodes": lines[:-1], "model_calls": n,
           "backfill_passes": b, "launches": got,
           "vit_launches_by_batch": by_b, "decode_tokens": eng.decode_tokens,
           "decode_forwards": eng.decode_forwards,
           "tokens_per_forward": eng.decode_tokens
           / max(eng.decode_forwards, 1),
           "graph_replays": sum(g.replays for g in eng.graphs.values()),
           "peak_memory_bytes": peak, "seconds": seconds,
           "kv_int8": eng.cache.quantized,
           "tower_int8": "fc1_w_scale" in eng.params["vision"]["layers"],
           "flags": list(flags), "printed": printed.getvalue().strip()}
    log(f"{what}: eval_cli.main {' '.join(flags)} printed {rec['printed']}")
    log(f"{what}: {len(lines) - 1} episodes ("
        f"{[r['steps'] for r in lines[:-1]]} steps), {n} model calls, {b} "
        f"history backfill passes in {seconds:.1f} s; launches {got} (want "
        f"{want}), K1 by batch {by_b}; model call p50 "
        f"{final.get('model_call_p50_ms', 0):.2f} ms p90 "
        f"{final.get('model_call_p90_ms', 0):.2f} ms; {eng.decode_tokens} "
        f"tokens in {eng.decode_forwards} verify forwards, "
        f"{rec['graph_replays']} graph replays "
        f"({rec['tokens_per_forward']:.3f} per forward); peak memory "
        f"allocated {peak / 2**30:.2f} GiB")
    del eng
    require(f"the evaluation entry point ({what})",
            episode_and_aggregate_lines=len(lines) == 3
            and "episode_id" not in lines[-1] and lines[-1]["length"] == 2,
            episodes_of_36_steps=all(r["steps"] == 36 for r in lines[:-1]),
            history_backfill=b >= 1, launch_counts=got == want,
            every_decode_forward_a_replay=rec["graph_replays"]
            == rec["decode_forwards"] > 0,
            model_call_latency="model_call_p50_ms" in final)
    return rec


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


@contextlib.contextmanager
def rss_peak(period_s=0.02):
    """While open, a thread samples the process's resident set
    (/proc/self/statm) every `period_s`; yields a dict whose "peak_gib"
    is the largest sample once closed (VmHWM cannot be reset in every
    sandbox, so the window's own peak is sampled)."""
    import threading
    page = os.sysconf("SC_PAGE_SIZE")
    box, done = {"peak_gib": 0.0}, threading.Event()

    def sample():
        while True:
            with open("/proc/self/statm") as f:
                rss = int(f.read().split()[1]) * page / 2**30
            box["peak_gib"] = max(box["peak_gib"], rss)
            if done.wait(period_s):
                return
    t = threading.Thread(target=sample, daemon=True)
    t.start()
    try:
        yield box
    finally:
        done.set()
        t.join()


def one_call(torch, params, cfg, frame, instruction, device="cuda"):
    """One agent call on a fresh engine over `params` (fused here, as
    eval_cli.build_agent fuses): its tokens and prefill logits."""
    from streamvln_tpu_torch.agent import VLNAgent
    from streamvln_tpu_torch.data.tokenizer import ByteTokenizer
    from streamvln_tpu_torch.models.fuse import fuse_projections
    from streamvln_tpu_torch.streaming.engine import StreamingEngine
    tok = ByteTokenizer()
    engine = StreamingEngine(fuse_projections(params), cfg,
                             cache_capacity=4096, max_new_tokens=16,
                             stop_ids=(tok.im_end_id, tok.eos_id),
                             spec_lookup=6, device=device,
                             compute_dtype=params["llm"]["embed"].dtype)
    calls, restore = record_calls(torch, engine)
    VLNAgent(engine, tok).step(0, frame, instruction, run_model=True)
    restore()
    return calls[0]["tokens"], engine.last_logits.float().cpu()


def turnkey_command(torch, np, va, counts, reset, model_size="7b",
                    device="cuda", shard_bytes=TURNKEY_SHARD_BYTES):
    """Phase 7: the reference's turnkey command on the card at full width.
    Phase 5's weights (random bf16 streamvln_7b from seed 0, steered to
    walk, unfused) are written as an HF checkpoint in bf16, as the
    published weights ship: shards of at most TURNKEY_SHARD_BYTES with a
    model.safetensors.index.json (no tokenizer files: the ByteTokenizer,
    as the reference picks for such a directory). Then, with the habitat
    stub installed (tests/habitat_stub.py: 4 episodes of 480x640 frames),
    `eval_cli.main --model_path <dir> --model_size 7b --env_backend habitat
    ...` runs twice: the second run must run no model call and give the
    same aggregate (resume). Checks result.json, the exact K1/K2 launches
    per model call and graph replays; that the loaded tree equals the
    written one bit for bit (the loader's device staging and, as a
    yardstick, the conversion on the host then one upload, each timed:
    read, convert, upload); that one agent call over the loaded weights equals
    one over the in-memory weights (tokens, prefill logits); and that the
    build's device peak stays within TURNKEY_MEMORY_SLACK of the
    random-init build's (eval_cli.build_agent(None, "7b")). The checkpoint
    directory is removed in every case."""
    import io
    import shutil
    import tempfile
    from streamvln_tpu_torch import eval_cli, weights
    from streamvln_tpu_torch.configs import build_config
    from streamvln_tpu_torch.models import convert_hf
    from streamvln_tpu_torch.utils import checkpoint
    import yaml  # noqa: F401  (the stub reads config/vln_r2r.yaml with it)
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    import habitat_stub

    import argparse
    cfg = build_config(argparse.Namespace(
        model_size=model_size, spatial_pool_mode="bilinear", num_frames=32,
        num_future_steps=4, num_history=8))
    dtype = torch.bfloat16 if device == "cuda" else torch.float32
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    params = weights.init(cfg, torch.Generator(device=device).manual_seed(0),
                          device=device, dtype=dtype)
    steer_to_walk(params)
    nbytes = tree_bytes(params)
    tmp = tempfile.gettempdir()
    free = shutil.disk_usage(tmp).free
    root = tmp if free >= 2 * nbytes else os.path.abspath("chiprun_out")
    os.makedirs(root, exist_ok=True)
    free = shutil.disk_usage(root).free
    ckpt = tempfile.mkdtemp(prefix="turnkey_ckpt_", dir=root)
    mods = None
    rec = {"checkpoint_dir_root": root, "disk_free_before_bytes": free}
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        paths = checkpoint.save_hf(params, cfg, ckpt, dtype,
                                   max_shard_bytes=shard_bytes)
        rec["write_s"] = time.perf_counter() - t0
        rec["shards"] = [os.path.basename(p) for p in paths]
        rec["checkpoint_bytes"] = sum(os.path.getsize(p) for p in paths)
        log(f"phase 7: wrote {len(paths)} {dtype} shards, "
            f"{rec['checkpoint_bytes'] / 2**30:.3f} GiB, in "
            f"{rec['write_s']:.2f} s to {root} ({free / 2**30:.1f} GiB "
            f"free before)")
        require("phase 7: the checkpoint", shards_with_an_index=len(paths)
                > 1 and os.path.exists(os.path.join(
                    ckpt, "model.safetensors.index.json")),
                shards_within_the_limit=all(
                    os.path.getsize(p) <= shard_bytes + 2**20
                    for p in paths))
        # the written weights stay on the host; the card is free for builds
        written = tree_map(lambda t: t.cpu(), params)
        rec["written_tree_gib"] = tree_bytes(written) / 2**30
        del params
        gc.collect()
        torch.cuda.empty_cache()

        # the random-init build's device peak, for the load's to meet
        box = {}
        with counted_builds(torch, eval_cli, box):
            agent = eval_cli.build_agent(None, model_size, device=device)
        rec["random_init_build_peak_bytes"] = box["build_peak_bytes"]
        del agent, box
        gc.collect()
        torch.cuda.empty_cache()

        # the turnkey command, twice (the second resumes)
        mods, _ = habitat_stub.install()
        out_dir = os.path.join("chiprun_out", "turnkey")
        result = os.path.join(out_dir, "result.json")
        if os.path.exists(result):
            os.remove(result)
        argv = ["--model_path", ckpt, "--model_size", model_size,
                "--device", device,
                "--env_backend", "habitat",
                "--habitat_config_path", "config/vln_r2r.yaml",
                "--eval_split", "val_unseen", "--output_path", out_dir,
                "--max_steps_per_episode", "12"]
        load0 = convert_hf.load_streamvln_checkpoint
        runs = []
        for run in range(2):
            box, stats, printed = {}, {}, io.StringIO()

            def load(*a, **k):
                return load0(*a, **dict(k, stats=stats))
            convert_hf.load_streamvln_checkpoint = load
            reset()
            t0 = time.perf_counter()
            try:
                with counted_builds(torch, eval_cli, box), \
                        rss_peak() as rss, \
                        contextlib.redirect_stdout(printed):
                    final = eval_cli.main(argv)
                    torch.cuda.synchronize()
            finally:
                convert_hf.load_streamvln_checkpoint = load0
            eng = box.pop("engine")
            runs.append({
                "final": final, "seconds": time.perf_counter() - t0,
                "model_calls": box["calls"], "backfills": box["backfills"],
                "launches": counts(), "vit_launches_by_batch": by_batch(va),
                "decode_forwards": eng.decode_forwards,
                "decode_tokens": eng.decode_tokens,
                "graph_replays": sum(g.replays for g in eng.graphs.values()),
                "build_peak_bytes": box["build_peak_bytes"], "load": stats,
                "peak_rss_gib": rss["peak_gib"],
                "tokenizer": box["tokenizer"],
                "printed": printed.getvalue().strip()})
            Lv, L = cfg.vision.num_layers, cfg.llm.num_layers
            runs[-1]["want"] = {
                "vit_attention": Lv * (box["calls"] + box["backfills"]),
                "flash_attention": L * box["calls"], "int4_matmul": 0,
                "int4_dequant_split": 0, "decode_attention": 0}
            if run == 0:
                with open(result) as f:
                    lines = [json.loads(x) for x in f]
            del eng
            gc.collect()
            torch.cuda.empty_cache()
        habitat_stub.uninstall(mods)
        mods = None
        first, again = runs
        rec["runs"], rec["episodes"] = runs, lines[:-1]
        load_s = {k: first["load"][k] for k in ("read_s", "convert_s",
                                                "upload_s")}
        total = sum(load_s.values())
        keys = ("sucs_all", "spls_all", "oss_all", "ones_all", "length")
        episode_keys = ("success", "spl", "os", "ne")
        log(f"phase 7: eval_cli.main printed {first['printed']}; resumed "
            f"{again['printed']}")
        log(f"phase 7: load {total:.2f} s = read {load_s['read_s']:.3f} + "
            f"convert {load_s['convert_s']:.2f} + upload "
            f"{load_s['upload_s']:.2f} s, "
            f"{first['load']['bytes'] / total / 1e9:.2f} GB/s; build peak "
            f"{first['build_peak_bytes'] / 2**30:.3f} GiB vs random init "
            f"{rec['random_init_build_peak_bytes'] / 2**30:.3f} GiB; host "
            f"peak RSS {first['peak_rss_gib']:.2f} GiB (of which "
            f"{rec['written_tree_gib']:.2f} the written tree kept for the "
            f"bit check); {first['model_calls']} model calls, "
            f"{len(lines) - 1} episodes ({[r['steps'] for r in lines[:-1]]} "
            f"steps) in {first['seconds']:.1f} s, model call p50 "
            f"{first['final'].get('model_call_p50_ms', 0):.2f} ms p90 "
            f"{first['final'].get('model_call_p90_ms', 0):.2f} ms; launches "
            f"{first['launches']} (want {first['want']}); "
            f"{first['graph_replays']} replays of "
            f"{first['decode_forwards']} verify forwards; tokenizer "
            f"{first['tokenizer']}; resume: "
            f"{again['model_calls']} calls in {again['seconds']:.1f} s")
        require("phase 7: the turnkey command",
                episode_and_aggregate_lines=len(lines) == 5
                and "episode_id" not in lines[-1] and lines[-1]["length"] == 4,
                finite_metrics=all(np.isfinite(r[k]) for r in lines[:-1]
                                   for k in episode_keys)
                and all(np.isfinite(first["final"][k]) for k in keys),
                model_calls=first["model_calls"] > 0,
                launch_counts=first["launches"] == first["want"],
                every_decode_forward_a_replay=first["graph_replays"]
                == first["decode_forwards"] > 0,
                model_call_latency="model_call_p50_ms" in first["final"],
                resume_runs_no_model_call=again["model_calls"] == 0
                and again["launches"] == again["want"],
                resume_same_aggregate=all(again["final"][k]
                                          == first["final"][k] for k in keys),
                build_memory_within_slack=first["build_peak_bytes"]
                <= rec["random_init_build_peak_bytes"] + TURNKEY_MEMORY_SLACK)

        # the loaded tree against the written one: the loader's per-layer
        # device staging, and as a yardstick the same conversion on the
        # host (the stacks transposed by the CPU) followed by one upload
        # per leaf
        def host_staged(stats):
            tree = convert_hf.load_streamvln_checkpoint(ckpt, cfg, dtype,
                                                        "cpu", stats=stats)
            t0 = time.perf_counter()
            tree = tree_map(lambda t: t.to(device), tree)
            torch.cuda.synchronize()
            stats["upload_s"] += time.perf_counter() - t0
            return tree
        rec["stagings"] = {}
        for stage, load in (
                ("device", lambda st: convert_hf.load_streamvln_checkpoint(
                    ckpt, cfg, dtype, device, stats=st)),
                ("host", host_staged)):
            stats = {}
            t0 = time.perf_counter()
            loaded = load(stats)
            torch.cuda.synchronize()
            stats["wall_s"] = time.perf_counter() - t0
            got, want = dict(tree_leaves(loaded)), dict(tree_leaves(written))
            unequal = sorted(k for k in want if k not in got
                             or got[k].dtype != want[k].dtype
                             or not torch.equal(got[k].cpu(), want[k]))
            stats["unequal_leaves"] = unequal
            stats["leaves"] = len(want)
            rec["stagings"][stage] = stats
            log(f"phase 7: {stage} staging: {stats['wall_s']:.2f} s (read "
                f"{stats['read_s']:.3f}, convert {stats['convert_s']:.2f}, "
                f"upload {stats['upload_s']:.2f}), "
                f"{stats['bytes'] / stats['wall_s'] / 1e9:.2f} GB/s; "
                f"{len(want) - len(unequal)}/{len(want)} leaves bit-equal "
                f"to the written tree")
            require(f"phase 7: {stage} staging", bit_equal=not unequal)
            if stage != "device":
                del loaded
                continue
            frame = np.random.default_rng(7).integers(0, 256, (480, 640, 3),
                                                      np.uint8)
            instruction = "walk past the sofa and stop at the kitchen door"
            t_loaded = one_call(torch, loaded, cfg, frame, instruction,
                                device)
            del loaded
            gc.collect()
            torch.cuda.empty_cache()
            t_memory = one_call(
                torch, tree_map(lambda t: t.to(device), written), cfg,
                frame, instruction, device)
            gc.collect()
            torch.cuda.empty_cache()
        agree = logits_agreement(torch, t_loaded[1], t_memory[1])
        rec["one_call"] = {
            "tokens_loaded": t_loaded[0], "tokens_in_memory": t_memory[0],
            "logits_bit_equal": bool(torch.equal(t_loaded[1], t_memory[1])),
            **agree}
        log(f"phase 7: one call over the loaded vs the in-memory weights: "
            f"tokens {t_loaded[0]} / {t_memory[0]}, prefill logits "
            f"bit-equal {rec['one_call']['logits_bit_equal']} (cosine "
            f"{agree['cosine']:.6f})")
        require("phase 7: loaded vs in-memory weights",
                tokens_equal=t_loaded[0] == t_memory[0],
                prefill_logits_bit_equal=rec["one_call"]["logits_bit_equal"])
    finally:
        if mods is not None:
            habitat_stub.uninstall(mods)
        shutil.rmtree(ckpt, ignore_errors=True)
    rec["launches"] = first["launches"]
    rec["vit_launches_by_batch"] = first["vit_launches_by_batch"]
    rec["seconds"] = time.perf_counter() - t_phase
    return rec


def jpeg_b64(frame) -> str:
    """A frame as a base64 JPEG, as the robot's client (post_frame) sends
    it."""
    import base64
    import io
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, format="JPEG")
    return base64.b64encode(buf.getvalue()).decode()


def start_server(server):
    """serve_forever on a daemon thread; returns (url, thread)."""
    import threading
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return f"http://127.0.0.1:{server.server_address[1]}", thread


def stop_servers(*pairs):
    for server, thread in pairs:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)


def record_batches(engine, logits=False):
    """Wrap engine.generate_batch: per call its wall ms on the host clock
    (the call returns once its tokens are on the host), its requests,
    tokens, phase ms (vision, prefill, decode), each row's decode forwards
    and, with `logits`, a copy of its rows' prefill last-token logits;
    returns (records, restore)."""
    recs, gb, collect = [], engine.generate_batch, engine.collect
    box = {}

    def counted_collect(handle):
        box["iters"] = handle["result"][:, 1 + engine.max_new].tolist()
        return collect(handle)

    def recorded(requests, temperature=None, top_p=None):
        requests = list(requests)
        t0 = time.perf_counter()
        out = gb(requests, temperature=temperature, top_p=top_p)
        rec = {"wall_ms": (time.perf_counter() - t0) * 1e3,
               "requests": requests, "tokens": out,
               "temperature": temperature, "top_p": top_p,
               "phase_ms": engine.last_phase_ms, "iters": box["iters"]}
        if logits:
            rec["prefill_logits"] = engine.last_logits.float().clone()
        recs.append(rec)
        return out
    engine.generate_batch, engine.collect = recorded, counted_collect

    def restore():
        engine.generate_batch, engine.collect = gb, collect
    return recs, restore


def record_replays():
    """Record every decode graph replay: its f32 logits (all rows) and the
    loop's per-row token counts before and after it; returns (records,
    stop)."""
    from streamvln_tpu_torch.streaming.decode_graph import StepGraph
    recs = []
    replay = StepGraph.replay

    def recorded(self):
        n0 = self.state["n"].clone()
        replay(self)
        recs.append((self.outputs["logits"].float().clone(), n0,
                     self.state["n"].clone()))
    StepGraph.replay = recorded

    def stop():
        StepGraph.replay = replay
    return recs, stop


def row_positions(prefill, reps, row, n_tokens):
    """The logits that chose each of a speculative call's tokens in batch
    row `row`: the prefill's for the first, then the columns each verify
    forward emitted for that row (its count grew by as many)."""
    pos = [prefill]
    for lg, n0, n1 in reps:
        pos += [lg[row, j] for j in range(int(n1[row] - n0[row]))]
    if len(pos) != n_tokens:
        raise AssertionError(f"row {row}: {len(pos)} logit rows for "
                             f"{n_tokens} tokens")
    return pos


def robot_path(torch, np, agent, frames, instruction, counts, reset, va):
    """6a: the robot path. http_server's AgentService after its main's
    warm-up, served on 127.0.0.1 at the entry point's own settings; the
    Go2 client posts each frame (JPEG, the first with reset and the
    instruction): at num_future_steps agent steps per request and a model
    call each, the requests cross the step-32 window reset and its
    <memory> call. With the ByteTokenizer (ROADMAP queue 1 item 6: no HF
    tokenizer yet) a window's prompts are ~5x a BPE tokenizer's, and the
    second window passes the 4096 KV slots build_agent gives: the engine's
    guard refuses that call, and the server answers 400, as the
    reference's does. Frames are posted until that refusal. Then
    Go2VlnManager's plan/control loop (its first post resets) against the
    same server."""
    import urllib.error
    from streamvln_tpu_torch.realworld import go2_vln_client as client
    from streamvln_tpu_torch.serve import http_server
    eng = agent.engine
    service = http_server.AgentService(
        agent, instruction, num_future_steps=agent.cfg.num_future_steps,
        run_root=os.path.join("chiprun_out", "serve_runs"))
    http_server.warm_up(agent, instruction)
    server = http_server.serve(service, "127.0.0.1", 0)
    url, thread = start_server(server)
    recs, restore = record_batches(eng)
    backfill, passes = eng.backfill_batch, []

    def counted_backfill(env, frames_u8, step_ids):
        passes.append(any(s not in eng.envs[env].frame_slots
                          for s in step_ids))
        return backfill(env, frames_u8, step_ids)
    eng.backfill_batch = counted_backfill
    walls, actions, calls_per, kv_max, refusal = [], [], [], 0, None
    torch.cuda.synchronize()
    reset()
    try:
        for i, f in enumerate(frames):
            n0 = len(recs)
            t0 = time.perf_counter()
            try:
                reply = client.post_frame(
                    url, f, reset=i == 0,
                    instruction=instruction if i == 0 else None,
                    timeout=300.0)
            except urllib.error.HTTPError as e:
                refusal = {"request": i, "code": e.code,
                           "error": json.loads(e.read()).get("error", "")}
                break
            walls.append((time.perf_counter() - t0) * 1e3)
            actions.append(reply)
            calls_per.append(len(recs) - n0)
            kv_max = max(kv_max, eng.envs[0].kv_length)
        got, by_b, b = counts(), by_batch(va), sum(passes)
        # the refused call wrote nothing: the host's and the card's lengths
        # still agree
        kv_ok = eng.envs[0].kv_length == int(eng.cache.length[0])
        mgr = client.Go2VlnManager(server_url=url, instruction=instruction,
                                   use_ros=False)
        mgr.set_odom(0.0, 0.0, 0.0)
        plans = []
        for f in frames[:3]:
            mgr.set_image(f)
            plans.append({"actions": mgr.plan_once(),
                          "command": list(mgr.control_once())})
        goal = mgr.homo_goal[:2, 3].tolist()
    finally:
        restore()
        eng.backfill_batch = backfill
        stop_servers((server, thread))
    calls = recs[:sum(calls_per)]
    n = len(calls)
    Lv, L = agent.cfg.vision.num_layers, agent.cfg.llm.num_layers
    want = {"vit_attention": Lv * (n + b), "flash_attention": L * n,
            "int4_matmul": 0, "int4_dequant_split": 0, "decode_attention": 0}
    call_wall = [c["wall_ms"] for c in calls]
    share = [w - cw for w, cw in zip(walls, call_wall)]
    phases = {k: float(np.median([c["phase_ms"][i] for c in calls]))
              for i, k in enumerate(("vision_ms", "prefill_ms",
                                     "decode_ms"))}
    steps = len(walls) * agent.cfg.num_future_steps
    rec = {"requests": len(walls), "agent_steps": steps, "model_calls": n,
           "backfill_passes": b, "refusal": refusal,
           "request_ms_p50": float(np.median(walls)),
           "request_ms_p90": float(np.percentile(walls, 90)),
           "call_ms_p50": float(np.median(call_wall)),
           "call_ms_p90": float(np.percentile(call_wall, 90)),
           "http_share_ms_p50": float(np.median(share)),
           "http_share_ms_p90": float(np.percentile(share, 90)),
           "phase_ms_p50": phases, "request_ms": walls,
           "call_ms": call_wall, "actions": actions, "launches": got,
           "max_kv_length": kv_max, "kv_capacity": eng.cache.capacity,
           "vit_launches_by_batch": by_b, "plans": plans, "goal_xy": goal}
    log(f"6a robot path: {len(walls)} JPEG 480x640 frames served over HTTP "
        f"({steps} agent steps), then {refusal}; {n} model calls, {b} "
        f"backfill passes, KV up to {kv_max} of {eng.cache.capacity} slots; "
        f"request p50 {rec['request_ms_p50']:.2f} p90 "
        f"{rec['request_ms_p90']:.2f} ms, model call p50 "
        f"{rec['call_ms_p50']:.2f} p90 {rec['call_ms_p90']:.2f} ms, outside "
        f"the call (JPEG encode and decode, HTTP, the agent's other steps) "
        f"p50 {rec['http_share_ms_p50']:.2f} p90 "
        f"{rec['http_share_ms_p90']:.2f} ms; call phases p50 {phases}; "
        f"launches {got} (want {want}); Go2 plans "
        f"{[p['actions'] for p in plans]} goal {goal}")
    require("6a robot path", one_model_call_per_request=calls_per
            == [1] * len(walls),
            crosses_window_reset=steps > agent.cfg.num_frames,
            refused_by_the_kv_guard=refusal is not None
            and refusal["code"] == 400
            and "KV cache would overflow" in refusal["error"],
            every_request_walks=all(a and 0 not in a for a in actions),
            launch_counts=got == want, kv_bookkeeping=kv_ok,
            go2_plans=all(p["actions"] for p in plans),
            go2_commands_finite=all(np.isfinite(p["command"]).all()
                                    for p in plans))
    return rec


def chat_path(torch, np, agent, frames, instruction):
    """6b: controller, model worker and web server on 127.0.0.1 threads.
    The worker registers and its heartbeat reaches the controller; two
    /worker_generate_stream requests with a budget of 4 x max_new (one
    greedy, one at temperature 0.7 / top-p 0.9) stream one generate and
    continue_decode chunks, each chunk's text extending the one before
    (less an incomplete last character: the ByteTokenizer's bytes of one
    arrow can straddle two chunks); one /chat goes through the web
    server."""
    import urllib.request
    from streamvln_tpu_torch.serve import controller, model_worker, \
        web_server
    eng = agent.engine
    ctrl = controller.Controller()
    c_srv = controller.serve_controller(ctrl, "127.0.0.1", 0)
    c_url, c_thread = start_server(c_srv)
    name = "streamvln-7b"
    worker = model_worker.ModelWorker(agent, agent.tok, name,
                                      controller_addr=c_url)
    w_srv = model_worker.serve_worker(worker, "127.0.0.1", 0)
    worker.worker_addr, w_thread = start_server(w_srv)
    web = web_server.serve_web(c_url, "127.0.0.1", 0)
    web_url, web_thread = start_server(web)
    interval = model_worker.HEARTBEAT_INTERVAL_S
    cont, chunk_ms = eng.continue_decode, []

    def timed_continue(env, **kw):
        t0 = time.perf_counter()
        out = cont(env, **kw)
        chunk_ms.append(((time.perf_counter() - t0) * 1e3, len(out)))
        return out
    eng.continue_decode = timed_continue
    streams = []
    try:
        model_worker.HEARTBEAT_INTERVAL_S = 0.2
        worker.register()
        registered = list(ctrl.workers) == [worker.worker_addr]
        entry = ctrl.workers[worker.worker_addr]
        entry.queue_length = 7        # the next heartbeat reports 0
        worker.start_heartbeat()
        deadline = time.monotonic() + 30
        while entry.queue_length and time.monotonic() < deadline:
            time.sleep(0.05)
        heartbeat = entry.queue_length == 0
        budget = 4 * eng.max_new
        # the first greedy and sampled streams capture the pending token's
        # token-loop and the sampled-loop graphs: warm both up, then measure
        for temp, top_p in ((None, None), (0.7, 0.9)) * 2:
            n0 = len(chunk_ms)
            body = {"prompt": instruction, "image_b64": jpeg_b64(frames[0]),
                    "max_new_tokens": budget, "temperature": temp,
                    "top_p": top_p}
            req = urllib.request.Request(
                worker.worker_addr + "/worker_generate_stream",
                data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            arrivals, buf = [], b""
            t0 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=300) as r:
                while True:
                    piece = r.read1(65536)
                    if not piece:
                        break
                    buf += piece
                    while b"\0" in buf:
                        part, buf = buf.split(b"\0", 1)
                        arrivals.append(((time.perf_counter() - t0) * 1e3,
                                         json.loads(part)))
            texts = [c["text"] for _, c in arrivals]
            cont_ms = chunk_ms[n0:]
            streams.append({
                "temperature": temp, "top_p": top_p,
                "chunks": len(arrivals),
                "continue_decode_chunks": len(cont_ms),
                "first_chunk_ms": arrivals[0][0] if arrivals else None,
                "chunk_arrival_ms": [t for t, _ in arrivals],
                "continue_decode_ms_per_token":
                    sum(ms for ms, _ in cont_ms)
                    / max(sum(n for _, n in cont_ms), 1),
                "text_chars": [len(t) for t in texts],
                "ok": bool(arrivals) and all(
                    c["error_code"] == 0 for _, c in arrivals),
                # a chunk that ends inside a multi-byte character decodes
                # it as U+FFFD, which the next chunk's text completes
                "cumulative": all(b.startswith(a.rstrip("\ufffd"))
                                  for a, b in zip(texts, texts[1:]))})
        chat = web_server._post(web_url + "/api/chat", {
            "model": name, "prompt": instruction,
            "image_b64": jpeg_b64(frames[1])})
    finally:
        model_worker.HEARTBEAT_INTERVAL_S = interval
        eng.continue_decode = cont
        stop_servers((web, web_thread), (w_srv, w_thread),
                     (c_srv, c_thread))
        # the heartbeat thread beats for the life of the process, as the
        # reference's does, and holds the worker: drop the worker's agent,
        # or its weights and caches stay on the card through phase 8
        worker.agent = None
    warm, streams = streams[:2], streams[2:]
    rec = {"registered": registered, "heartbeat": heartbeat,
           "streams": streams, "warm_up_first_chunk_ms": [
               s_["first_chunk_ms"] for s_ in warm],
           "chat": {k: chat.get(k) for k in (
               "error_code", "actions", "generate_time")}}
    for s_ in streams:
        log(f"6b stream (temperature {s_['temperature']}): {s_['chunks']} "
            f"chunks ({s_['continue_decode_chunks']} continue_decode), "
            f"first chunk {s_['first_chunk_ms']:.2f} ms, continue_decode "
            f"{s_['continue_decode_ms_per_token']:.2f} ms per token, text "
            f"chars {s_['text_chars']}")
    log(f"6b warm-up streams (graph captures): first chunk "
        f"{rec['warm_up_first_chunk_ms']} ms")
    log(f"6b controller: registered {registered}, heartbeat {heartbeat}; "
        f"/chat through the web server: {rec['chat']}")
    require("6b chat path", registered=registered, heartbeat=heartbeat,
            streams_ok=all(s_["ok"] for s_ in warm + streams),
            several_continue_decode_chunks=all(
                s_["continue_decode_chunks"] >= 2 for s_ in warm + streams),
            chunks_extend=all(s_["cumulative"] for s_ in warm + streams),
            chat_ok=chat.get("error_code") == 0)
    return rec


def batched_waves(torch, np, agent, agent8, frames, instruction, counts,
                  reset, va):
    """6c: BatchedWorker over an n_envs=8 engine on the same weights. A
    warm-up wave (its B=8 graphs captured under strict_captures), then 8
    concurrent /worker_generate requests coalesce into one wave, then a
    lone request (at the worker's default wait, which it waits out) runs
    in a wave with 7 idle rows, which keep their KV,
    lengths, shadow and feature slots. Each row of the 8-wave is held
    against the same request (its frame and token ids) served alone by
    the B=1 engine: prefill logits within REF_MIN_COSINE, tokens equal or
    parted at a near-tie (require_near_ties). Every decode forward of a
    wave is a graph replay (replays = the longest row's verify forwards;
    one more wave under the profiler: host_ops), and each wave runs K1
    and K2 once per layer at B=8. Then a mixed wave (the bodies of
    MIXED_SAMPLED_ROWS ask for sampling, so the wave takes the sampled
    loop, its graph captured at B=8 by a warm-up mixed wave, with the
    per-row greedy gate): its
    greedy rows against the same requests in the same slots run all
    greedy (equal or parted at a near-tie: the sampled loop feeds one
    token per forward, the greedy call verifies spec_lookup + 1), its
    sampled rows' tokens in the top-p support of the logits that chose
    them, every forward a replay. Last, the 8 requests once more at the
    worker's default wait, whose wave sizes and queue arrivals are
    reported."""
    import inspect
    import threading
    from streamvln_tpu_torch.serve import batch_worker
    from streamvln_tpu_torch.streaming.engine import _nucleus
    from streamvln_tpu_torch.serve.web_server import _post
    eng1, eng8 = agent.engine, agent8.engine
    B = eng8.n_envs
    worker = batch_worker.BatchedWorker(agent8, agent8.tok,
                                        "streamvln-7b-batched",
                                        max_wait_ms=WAVE_WAIT_MS)
    srv = batch_worker.serve_batch_worker(worker, "127.0.0.1", 0)
    url, thread = start_server(srv)
    bodies = [{"prompt": f"{instruction}, then wait by door {i}",
               "image_b64": jpeg_b64(frames[i])} for i in range(B)]

    def wave(sent):
        out = [None] * len(sent)

        def call(i):
            out[i] = _post(url + "/worker_generate", sent[i])
        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(sent))]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        return out, (time.perf_counter() - t0) * 1e3
    recs, restore = record_batches(eng8, logits=True)
    reps, stop = record_replays()
    try:
        wave(bodies)                            # warm-up: B=8 captures
        del recs[:], reps[:]
        reset()
        r8, client8 = wave(bodies)
        got8, by8 = counts(), by_batch(va)
        reps8 = list(reps)
        idle = {"length": eng8.cache.length[1:].clone(),
                "k": eng8.cache.k[:, 1:].clone(),
                "v": eng8.cache.v[:, 1:].clone(),
                "ids": eng8.ids_buf[1:].clone(),
                "feat": eng8.feat_cache[1:, :-1].clone()}
        del reps[:]
        # a lone request waits out the worker's gathering: at its default
        default_ms = inspect.signature(batch_worker.BatchedWorker).parameters[
            "max_wait_ms"].default
        worker.max_wait_s = default_ms / 1e3
        reset()
        r1, client1 = wave(bodies[:1])
        worker.max_wait_s = WAVE_WAIT_MS / 1e3
        got1, by1 = counts(), by_batch(va)
        reps1 = list(reps)
        stop()
        restore()
        w8, w1 = recs[0], recs[-1]
        kept = {"length": torch.equal(idle["length"],
                                      eng8.cache.length[1:]),
                "kv": torch.equal(idle["k"], eng8.cache.k[:, 1:])
                and torch.equal(idle["v"], eng8.cache.v[:, 1:]),
                "shadow": torch.equal(idle["ids"], eng8.ids_buf[1:]),
                "features": torch.equal(idle["feat"],
                                        eng8.feat_cache[1:, :-1])}
        del idle
        # one more 8-wave of the same requests, here under the profiler
        # (the batcher thread waits on its queue meanwhile)
        for slot in range(B):
            agent8.reset_memory(slot)
        prof = profile_call(torch, lambda: eng8.generate_batch(
            w8["requests"]), w8["wall_ms"])
        mixed = [dict(body, temperature=MIXED_TEMPERATURE,
                      top_p=MIXED_TOP_P) if i in MIXED_SAMPLED_ROWS else body
                 for i, body in enumerate(bodies)]
        wave(mixed)                             # warm-up: B=8 capture
        recs_m, restore = record_batches(eng8, logits=True)
        reps_m, stop = record_replays()
        rm, client_m = wave(mixed)
        # the same requests in the same slots, all greedy
        n_m = len(reps_m)
        for slot in range(B):
            agent8.reset_memory(slot)
        eng8.generate_batch(recs_m[0]["requests"])
        stop()
        restore()
        reps_m, reps_g = reps_m[:n_m], reps_m[n_m:]
        # the worker's default wait, with each request's arrival at the
        # queue (after its handler thread decoded the frame)
        arrivals, put = [], worker.requests.put

        def timed_put(item, *a, **k):
            arrivals.append(time.perf_counter())
            return put(item, *a, **k)
        worker.requests.put = timed_put
        worker.max_wait_s = default_ms / 1e3
        rd, client_d = wave(bodies)
    finally:
        stop()
        restore()
        stop_servers((srv, thread))
        worker.stop()
    mixed_rec = mixed_wave(torch, _nucleus, recs_m[1], reps_g, recs_m[0],
                           reps_m, rm, client_m, B)
    default_wait = {"max_wait_ms": default_ms,
                    "batch_sizes": [x.get("batch_size") for x in rd],
                    "client_ms": client_d,
                    "requests_per_s_client": B * 1e3 / client_d,
                    "arrival_spread_ms": (max(arrivals) - min(arrivals))
                    * 1e3, "arrival_ms": [(t - min(arrivals)) * 1e3
                                          for t in sorted(arrivals)]}
    # each row against the same request served alone by the B=1 engine
    rows, flips, agree, alone_ms = [], [], [], []
    for r, (env, frame, ids, step, hist) in enumerate(w8["requests"]):
        eng1.reset_episode(0)
        rep, stop = record_replays()
        t0 = time.perf_counter()
        try:
            toks = eng1.generate(0, frame, ids, step, hist)
        finally:
            stop()
        alone_ms.append((time.perf_counter() - t0) * 1e3)
        pre1 = eng1.last_logits[0].float().clone()
        batched = w8["tokens"][env]
        c = {"call": r, "alone": toks, "batched": batched,
             "prefill_cosine": float(torch.nn.functional.cosine_similarity(
                 pre1, w8["prefill_logits"][env], dim=0)),
             **paths_part(torch, toks, row_positions(pre1, rep, 0,
                                                     len(toks)),
                          batched, row_positions(w8["prefill_logits"][env],
                                                 reps8, env, len(batched)),
                          agree)}
        rows.append(c)
        if "position" in c:
            flips.append(c)
    rounding, bound = require_near_ties("6c batched row vs alone", flips,
                                        agree)
    Lv, L = agent.cfg.vision.num_layers, agent.cfg.llm.num_layers
    want = {"vit_attention": Lv, "flash_attention": L, "int4_matmul": 0,
            "int4_dequant_split": 0, "decode_attention": 0}
    emitted = [len(t) - 1 for t in w8["tokens"].values()]
    dec = w8["phase_ms"][2] if w8["phase_ms"] else float("nan")
    rec = {
        "batch_sizes_8": [x.get("batch_size") for x in r8],
        "batch_sizes_1": [x.get("batch_size") for x in r1],
        "wave8_ms": w8["wall_ms"], "wave1_ms": w1["wall_ms"],
        "wave8_client_ms": client8, "wave1_client_ms": client1,
        "alone_ms": alone_ms,
        "requests_per_s_wave8": B * 1e3 / w8["wall_ms"],
        "requests_per_s_wave1": 1e3 / w1["wall_ms"],
        "requests_per_s_wave8_client": B * 1e3 / client8,
        "requests_per_s_wave1_client": 1e3 / client1,
        "requests_per_s_alone_b1": 1e3 / float(np.median(alone_ms)),
        "phase_ms_wave8": w8["phase_ms"], "phase_ms_wave1": w1["phase_ms"],
        "decode_ms_per_token_all_rows": dec / max(sum(emitted), 1),
        "decode_ms_per_token_longest_row": dec / max(max(emitted), 1),
        "tokens_per_verify_forward": sum(emitted) / max(sum(w8["iters"]),
                                                        1),
        "verify_forwards_wave8": max(w8["iters"]), "replays_wave8":
            len(reps8), "verify_forwards_wave1": max(w1["iters"]),
        "replays_wave1": len(reps1),
        "launches_wave8": got8, "launches_wave1": got1,
        "vit_launches_by_batch": {k: by8.get(k, 0) + by1.get(k, 0)
                                  for k in set(by8) | set(by1)},
        "idle_rows_kept": kept, "rows": rows, "flip_bound": bound,
        "rounding_at_agreeing_positions": rounding,
        "min_prefill_cosine": min(c["prefill_cosine"] for c in rows),
        "min_position_cosine": min(c["min_cosine"] for c in rows),
        "profile": prof, "mixed_wave": mixed_rec,
        "default_wait": default_wait}
    log(f"6c batched waves: 8 requests in waves of {rec['batch_sizes_8']}, "
        f"a lone one in {rec['batch_sizes_1']}; wave walls {w8['wall_ms']:.2f}"
        f" / {w1['wall_ms']:.2f} ms (client {client8:.2f} / {client1:.2f}); "
        f"requests/s at the client {rec['requests_per_s_wave8_client']:.2f} "
        f"in waves of 8, {rec['requests_per_s_wave1_client']:.2f} in waves "
        f"of 1; per engine call {rec['requests_per_s_wave8']:.2f} / "
        f"{rec['requests_per_s_wave1']:.2f}, "
        f"{rec['requests_per_s_alone_b1']:.2f} on the B=1 engine; phases "
        f"{w8['phase_ms']}; decode {rec['decode_ms_per_token_all_rows']:.2f} "
        f"ms per emitted token over all rows "
        f"({rec['decode_ms_per_token_longest_row']:.2f} per token of the "
        f"longest row), {rec['tokens_per_verify_forward']:.3f} tokens per "
        f"verify forward; replays {len(reps8)} / {len(reps1)} for "
        f"{max(w8['iters'])} / {max(w1['iters'])} forwards; launches "
        f"{got8} / {got1} (want {want}), K1 by batch {by8} / {by1}; idle "
        f"rows kept {kept}; rows vs alone: prefill cosine >= "
        f"{rec['min_prefill_cosine']:.6f}, position cosine >= "
        f"{rec['min_position_cosine']:.6f}, {len(flips)} of {len(rows)} "
        f"rows part (bound {bound:.4f}); at the worker's default wait of "
        f"{default_ms} ms the 8 requests ran in waves of "
        f"{default_wait['batch_sizes']} (arrivals spread over "
        f"{default_wait['arrival_spread_ms']:.2f} ms, client "
        f"{client_d:.2f} ms)")
    ops = prof["host_ops_per_decode_forward"]
    require("6c batched waves",
            coalesced_into_one_wave=rec["batch_sizes_8"] == [B] * B,
            lone_wave=rec["batch_sizes_1"] == [1],
            replies_ok=all(x.get("error_code") == 0 for x in r8 + r1),
            launch_counts=got8 == want and got1 == want,
            k1_at_batch_8=by8 == {f"B={B}": Lv} and by1 == by8,
            every_forward_a_replay=len(reps8) == max(w8["iters"]) > 0
            and len(reps1) == max(w1["iters"]) > 0,
            profiled_forwards_replay=ops is not None and ops <= 4,
            idle_rows_kept=all(kept.values()),
            prefill_cosine=rec["min_prefill_cosine"] > REF_MIN_COSINE,
            position_cosine=rec["min_position_cosine"] > REF_MIN_COSINE,
            default_wait_replies_ok=all(x.get("error_code") == 0
                                        for x in rd))
    return rec


def token_positions(prefill, reps, row, n_tokens):
    """The logits that chose each of a token-loop call's tokens in batch
    row `row`: the prefill's for the first, then each forward's (one token
    per forward while the row decodes)."""
    pos = [prefill] + [lg[row, 0] for lg, _, _ in reps[:n_tokens - 1]]
    if len(pos) != n_tokens:
        raise AssertionError(f"row {row}: {len(pos)} logit rows for "
                             f"{n_tokens} tokens")
    return pos


def mixed_wave(torch, nucleus, wg, reps_g, wm, reps_m, replies, client_ms,
               B) -> dict:
    """6c's mixed wave `wm` against the same requests in the same slots,
    all greedy, `wg` (record_batches records, with their replays). Greedy
    rows: tokens equal or parted at a near-tie. Sampled rows: each token
    inside the engine's nucleus (`_nucleus`, at the row's temperature and
    top-p) of the logits that chose it."""
    temps = {int(e): t for e, t in (wm["temperature"] or {}).items()
             if t > 1e-3}
    tops = wm["top_p"] or {}
    flips, agree, support, rows = [], [], [], []
    for env in wm["tokens"]:
        toks = wm["tokens"][env]
        pos = token_positions(wm["prefill_logits"][env], reps_m, env,
                              len(toks))
        if env in temps:
            t = torch.tensor([temps[env]], dtype=torch.float32,
                             device=pos[0].device)
            p = torch.tensor([tops.get(env, 1.0)], dtype=torch.float32,
                             device=pos[0].device)
            kept = [nucleus(lg[None].float(), t, p)[0].isfinite()
                    for lg in pos]
            support += [bool(k[tok]) for k, tok in zip(kept, toks)]
            rows.append({"env": env, "sampled": True, "tokens": toks,
                         "greedy_tokens": wg["tokens"][env],
                         "support_sizes": [int(k.sum()) for k in kept]})
            continue
        gt = wg["tokens"][env]
        c = {"env": env, "sampled": False,
             **paths_part(torch, gt, row_positions(
                 wg["prefill_logits"][env], reps_g, env, len(gt)), toks, pos,
                 agree)}
        rows.append(c)
        if "position" in c:
            flips.append(c)
    rounding, bound = require_near_ties(
        "6c mixed wave's greedy rows vs the greedy wave", flips, agree)
    rec = {"batch_sizes": [x.get("batch_size") for x in replies],
           "sampled_slots": sorted(temps), "client_ms": client_ms,
           "wall_ms": wm["wall_ms"], "phase_ms": wm["phase_ms"],
           "forwards": max(wm["iters"]), "replays": len(reps_m),
           "greedy_rows_parted": len(flips), "flip_bound": bound,
           "rounding_at_agreeing_positions": rounding,
           "sampled_tokens": len(support),
           "sampled_tokens_in_support": sum(support), "rows": rows}
    log(f"6c mixed wave: waves of {rec['batch_sizes']}, sampled slots "
        f"{rec['sampled_slots']} (temperature {MIXED_TEMPERATURE}, top-p "
        f"{MIXED_TOP_P}); client {client_ms:.2f} ms, call "
        f"{wm['wall_ms']:.2f} ms; {len(reps_m)} replays for "
        f"{rec['forwards']} forwards; greedy rows vs the greedy wave: "
        f"{len(flips)} of {B - len(temps)} part (bound {bound:.4f}); "
        f"sampled tokens in the top-p support {sum(support)} of "
        f"{len(support)}, support sizes "
        f"{[r['support_sizes'] for r in rows if r['sampled']]}")
    require("6c mixed wave", one_wave=rec["batch_sizes"] == [B] * B,
            replies_ok=all(x.get("error_code") == 0 for x in replies),
            sampled_rows=len(temps) == len(MIXED_SAMPLED_ROWS),
            every_forward_a_replay=len(reps_m) == rec["forwards"] > 0,
            sampled_tokens_in_top_p_support=bool(support) and all(support))
    return rec


def fused_preprocessing(torch, np, agent, frames, instruction, counts,
                        reset, va):
    """6d: the fused resize/normalise/patch-embed on the card. On one
    frame, siglip.forward_raw against preprocess_frames + forward, held to
    the reference's bar (max |diff| / max |ref| < 0.02) as the reference's
    test holds it: in f32 (dense attention), here at so400m's full width
    and depth. In bf16, the engine's dtype, the patch embeddings are held
    to the same bar; the tower outputs of the two bf16 paths are reported,
    each beside its distance from the f32 tower (what bf16 alone moves
    through 26 random layers). Then the engine's whole vision step (tower,
    projector, pool) timed both ways in turns, and an agent pass over
    steps 0..32 (9 calls) on an engine with fused_preprocess=True, with
    exact K1/K2 counts."""
    from streamvln_tpu_torch.agent import VLNAgent
    from streamvln_tpu_torch.models import siglip
    from streamvln_tpu_torch.ops.fused_patch_embed import fused_patch_embed
    from streamvln_tpu_torch.ops.linear import matmul_f32
    from streamvln_tpu_torch.ops.preprocess import preprocess_frames
    from streamvln_tpu_torch.streaming import engine as engine_mod
    eng1 = agent.engine
    params, cfg, dt = eng1.params, eng1.cfg, eng1.compute_dtype
    vcfg, S = cfg.vision, cfg.vision.image_size
    x = torch.from_numpy(frames[0][None]).to(eng1.device)

    def rel(a, b):
        return float((a.float() - b.float()).abs().max()
                     / b.float().abs().max())

    def two_stage_embed(vp, dtype):
        px = siglip.patchify(preprocess_frames(x, S, dtype=dtype),
                             vcfg.patch_size)
        return (matmul_f32(px, vp["patch_w"]) + vp["patch_b"].float()
                ).to(dtype)
    vis = params["vision"]
    vis32 = {k: ({n: t.float() for n, t in v.items()} if isinstance(v, dict)
                 else v.float()) for k, v in vis.items()}
    with torch.no_grad():
        ref32 = siglip.forward(vis32, vcfg, preprocess_frames(
            x, S, dtype=torch.float32), attn_impl="dense")
        f32_rel = rel(siglip.forward_raw(vis32, vcfg, x, attn_impl="dense",
                                         compute_dtype=torch.float32), ref32)
        embed_rel = rel(fused_patch_embed(
            x, vis["patch_w"], vis["patch_b"], image_size=S,
            patch_size=vcfg.patch_size, compute_dtype=dt),
            two_stage_embed(vis, dt))
        two = siglip.forward(vis, vcfg, preprocess_frames(x, S, dtype=dt))
        raw = siglip.forward_raw(vis, vcfg, x, compute_dtype=dt)
        bf16 = {"fused_vs_two_stage": rel(raw, two),
                "two_stage_vs_f32": rel(two, ref32),
                "fused_vs_f32": rel(raw, ref32)}
        del vis32, ref32, two, raw
        vision = {False: [], True: []}
        for fused in (False, True, True, False):
            vision[fused].append(time_ms(torch, lambda: engine_mod._encode(
                params, cfg, x, eng1.attn_impl, dt, fused), iters=10))
    engf = engine_mod.StreamingEngine(
        params, cfg, max_new_tokens=eng1.max_new, stop_ids=eng1.stop_ids,
        compute_dtype=dt, spec_lookup=eng1.spec_lookup,
        fused_preprocess=True, device=eng1.device)
    agentf = VLNAgent(engf, agent.tok)
    calls, wall = drive_calls(torch, agentf, engf, cfg, frames, instruction,
                              reset)
    got_counts, by_b = counts(), by_batch(va)
    n = len(calls)
    want = {"vit_attention": cfg.vision.num_layers * n,
            "flash_attention": cfg.llm.num_layers * n, "int4_matmul": 0,
            "int4_dequant_split": 0, "decode_attention": 0}
    rec = {"max_rel_diff_f32": f32_rel, "max_rel_diff_embed_bf16": embed_rel,
           "tower_bf16": bf16, "vision_ms_unfused": vision[False],
           "vision_ms_fused": vision[True], "calls": n,
           "call_vision_ms": [c["phase_ms"][0] for c in calls if
                              c["phase_ms"]],
           "wall_ms": wall, "launches": got_counts,
           "vit_launches_by_batch": by_b}
    log(f"6d fused preprocessing, max |diff| / max |ref| against the two-"
        f"stage path (bar 0.02): f32 tower output {f32_rel:.4e}, bf16 patch "
        f"embeddings {embed_rel:.4e}; bf16 tower outputs {bf16}; vision "
        f"step per frame unfused "
        f"{vision[False]} ms, fused {vision[True]} ms (in turns); "
        f"{n} agent calls with fused_preprocess=True, call vision ms "
        f"{[round(v, 2) for v in rec['call_vision_ms']]}, launches "
        f"{got_counts} (want {want})")
    require("6d fused preprocessing", f32_tower_within_bar=f32_rel < 0.02,
            bf16_embeddings_within_bar=embed_rel < 0.02,
            nine_calls=n == 9, launch_counts=got_counts == want)
    del agentf, engf
    return rec


def serving_stack(torch, np, va, counts, reset, model_size="7b",
                  device="cuda"):
    """Phase 6: the serving stack at full width (6a-6d) on one 7B init:
    the entry points' agent from eval_cli.build_agent (steered to walk)
    and a second engine of 8 env slots over the same weight tree, as
    batch_worker.main's build_agent(n_envs=8) would build it."""
    from streamvln_tpu_torch.agent import VLNAgent
    from streamvln_tpu_torch.streaming.engine import StreamingEngine
    # the servers and clients talk on the loopback only
    os.environ["no_proxy"] = "127.0.0.1,localhost"
    # earlier phases' engines may sit in reference cycles: free them, so
    # that the peak is phase 6's own
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    log(f"phase 6: {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated "
        f"before its weights")
    t0 = time.perf_counter()
    from streamvln_tpu_torch import eval_cli
    with steered_weights():
        agent = eval_cli.build_agent(None, model_size, device=device)
    e1 = agent.engine
    # what batch_worker.main's build_agent(n_envs=8) builds (4096 slots)
    eng8 = StreamingEngine(e1.params, e1.cfg, n_envs=8,
                           max_new_tokens=e1.max_new, stop_ids=e1.stop_ids,
                           compute_dtype=e1.compute_dtype,
                           spec_lookup=e1.spec_lookup, device=e1.device)
    agent8 = VLNAgent(eng8, agent.tok, deterministic_conjunction=False)
    frames = np.random.default_rng(6).integers(0, 256, (36, 480, 640, 3),
                                               np.uint8)
    instruction = "walk down the hallway and stop at the second door"
    rec = {"robot": robot_path(torch, np, agent, frames, instruction,
                               counts, reset, va)}
    rec["chat"] = chat_path(torch, np, agent, frames, instruction)
    rec["batched"] = batched_waves(torch, np, agent, agent8, frames,
                                   instruction, counts, reset, va)
    del agent8, eng8
    gc.collect()
    rec["fused"] = fused_preprocessing(torch, np, agent, frames, instruction,
                                       counts, reset, va)
    rec["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    rec["seconds"] = time.perf_counter() - t0
    rec["vit_launches_by_batch"] = sorted(
        set(rec["robot"]["vit_launches_by_batch"])
        | set(rec["batched"]["vit_launches_by_batch"])
        | set(rec["fused"]["vit_launches_by_batch"]))
    return rec


def requantize_sync(other, ref, tokens):
    """Give an int8-cache engine a bf16-cache engine's dialogue after a
    call whose tokens differed: the reference's cache quantized as the
    int8 cache's appends quantize it (per token and head, qwen2.
    _quantize_kv), its lengths and env bookkeeping."""
    from streamvln_tpu_torch.models import qwen2
    for src, dst, sc in ((ref.cache.k, other.cache.k, other.cache.k_scale),
                         (ref.cache.v, other.cache.v, other.cache.v_scale)):
        for layer in range(src.shape[0]):
            q, scale = qwen2._quantize_kv(src[layer])
            dst[layer].copy_(q)
            sc[layer].copy_(scale)
    other.cache.length.copy_(ref.cache.length)
    a, b = other.envs[0], ref.envs[0]
    a.pending_token, a.kv_length = b.pending_token, b.kv_length


def kv_int8_serving(torch, np, params, cfg, tok, frames, instruction,
                    counts, reset, device="cuda"):
    """Phase 8a: the kv_int8 engine on the phase-3 bf16 weights (fused as
    the engine fuses them): the cache's layout and bytes against the bf16
    cache's; the 9 agent calls over steps 0..32 with exact launch counts
    (26 K1 and 28 K2 per call, no K8: decode and verify forwards attend
    over the int8 cache dense, with the scales folded in) and the peak
    memory; the first call's prefill logits against a bf16-cache engine's;
    tokens call by call against the bf16-cache engine (greedy) and, with
    spec_lookup 6, against the kv_int8 greedy engine, equal or parted at a
    near-tie (lockstep); the four variants (bf16 and kv_int8 caches, greedy
    and spec 6) in turns with one profiled call each (paired_timing); every
    decode and verify forward of both kv_int8 variants replayed bit for
    bit against the eager step (graphs_vs_eager); a scale buffer rebound
    after capture makes the next replay raise."""
    from streamvln_tpu_torch.agent import VLNAgent
    from streamvln_tpu_torch.models.fuse import fuse_projections
    from streamvln_tpu_torch.streaming.engine import StreamingEngine
    fused = fuse_projections(params)

    def engine(kv_int8, spec=0, max_new=16):
        return StreamingEngine(fused, cfg, cache_capacity=4096,
                               max_new_tokens=max_new, spec_lookup=spec,
                               stop_ids=(tok.im_end_id,), kv_int8=kv_int8,
                               device=device,
                               compute_dtype=params["llm"]["embed"].dtype)
    e8, e16 = engine(True), engine(False)
    c = e8.cache
    L, Hkv = cfg.llm.num_layers, cfg.llm.num_kv_heads
    layout = {"k": str(c.k.dtype), "v": str(c.v.dtype),
              "k_scale": list(c.k_scale.shape),
              "v_scale": list(c.v_scale.shape),
              "scale_dtype": str(c.k_scale.dtype)}
    nbytes = {"int8": tree_bytes([c.k, c.v, c.k_scale, c.v_scale]),
              "bf16": tree_bytes([e16.cache.k, e16.cache.v])}
    ratio = nbytes["int8"] / nbytes["bf16"]
    D = cfg.llm.head_dim
    log(f"8a kv_int8 cache: {layout}; {nbytes['int8'] / 1e6:.1f} MB against "
        f"the bf16 cache's {nbytes['bf16'] / 1e6:.1f} MB ({ratio:.4f}; "
        f"(D + 4) / 2D = {(D + 4) / (2 * D):.4f})")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    calls, wall = drive_calls(torch, VLNAgent(e8, tok), e8, cfg, frames,
                              instruction, reset)
    got = counts()
    peak = torch.cuda.max_memory_allocated()
    n = len(calls)
    want = {"vit_attention": cfg.vision.num_layers * n,
            "flash_attention": L * n, "int4_matmul": 0,
            "int4_dequant_split": 0, "decode_attention": 0}
    log(f"8a launches over {n} kv_int8 calls: {got} (want {want}); peak "
        f"memory allocated {peak / 2**30:.2f} GiB")
    require("8a kv_int8 cache",
            int8_values=layout["k"] == layout["v"] == "torch.int8",
            scale_shapes=layout["k_scale"] == layout["v_scale"]
            == [L, 1, Hkv, 4096] and layout["scale_dtype"] == "torch.float32",
            bytes=nbytes["int8"] * 2 * cfg.llm.head_dim
            == nbytes["bf16"] * (cfg.llm.head_dim + 4),
            launch_counts=got == want)

    outs = []
    for kv in (False, True):
        e = engine(kv, max_new=2)
        VLNAgent(e, tok).step(0, frames[0], instruction, run_model=True)
        outs.append(e.last_logits.float())
        del e
    prefill = logits_agreement(torch, *outs)
    log(f"8a prefill logits, kv_int8 vs bf16 cache: cosine "
        f"{prefill['cosine']:.6f} max rel diff {prefill['max_rel_diff']:.3e} "
        f"top-1 agree {prefill['top1_agree']}")
    require("8a prefill over the int8 cache",
            cosine=prefill["cosine"] > REF_MIN_COSINE)

    tokens = lockstep(torch, engine(False), engine(True), cfg, tok, frames,
                      instruction, requantize_sync,
                      "8a kv_int8 vs bf16 cache (greedy)")
    spec = lockstep(torch, engine(True), engine(True, 6), cfg, tok, frames,
                    instruction, resync,
                    "8a kv_int8: spec_lookup 6 vs greedy")
    gc.collect()

    variants = {"kv_int8": e8, "bf16": e16, "kv_int8_spec": engine(True, 6),
                "bf16_spec": engine(False, 6)}
    paired = paired_timing(torch, np, variants, cfg, tok, frames,
                           instruction, "8a")
    for name, r in paired.items():
        ops = r["profile"]["host_ops_per_decode_forward"]
        require(f"8a {name}: the profiled call's decode forwards",
                graph_replays=ops is not None,
                at_most_4_launches_or_copies_besides_replay_and_flag=ops
                is not None and ops <= 4)
    replays = graphs_vs_eager(torch, {n: variants[n] for n in (
        "kv_int8", "kv_int8_spec")}, cfg, tok, frames, instruction, "8a")
    scale = e8.cache.k_scale
    e8.cache.k_scale = scale.clone()
    raised = ""
    try:
        for graph in list(e8.graphs.values())[:1]:
            graph.replay()
    except RuntimeError as err:
        raised = str(err)
    e8.cache.k_scale = scale
    log(f"8a a k_scale rebound to a new tensor: the next replay raised "
        f"{raised!r}")
    require("8a rebound scale", raises="cache.k_scale" in raised)
    med = {k: v["median_mid_window"] for k, v in paired.items()}
    log("8a in turns, mid-window medians (decode ms per emitted token / "
        "call wall ms): " + "; ".join(
            f"{k} {v['decode_ms_per_token']:.2f} / {v['wall_ms']:.2f}"
            for k, v in med.items()))
    del variants, e8, e16, fused
    return {"layout": layout, "cache_bytes": nbytes, "bytes_ratio": ratio,
            "calls": calls, "wall_ms": wall, "launches": got,
            "peak_memory_bytes": peak, "prefill_vs_bf16_cache": prefill,
            "tokens_vs_bf16_cache": tokens, "spec_vs_greedy": spec,
            "paired": paired, "graphs_vs_eager": replays,
            "rebound_scale_raised": raised}


def int8_tower(torch, params, cfg, frames, va, device="cuda"):
    """Phase 8b, first part: the SigLIP tower with quant.quantize_vision
    weights on one 480x640 frame against the bf16 tower (max |diff| /
    max |ref| < TOWER_INT8_MAX_REL, per-token cosine >
    TOWER_INT8_MIN_COSINE), K1 once per tower layer in each, and vision ms
    per frame (the tower on preprocessed pixels, CUDA events), int8 and
    bf16 in turns."""
    from streamvln_tpu_torch.models import quant, siglip
    from streamvln_tpu_torch.ops.preprocess import preprocess_frames
    vision = {"bf16": params["vision"],
              "int8": quant.quantize_vision(params["vision"])}
    img = preprocess_frames(torch.from_numpy(frames[:1]).to(device),
                            cfg.vision.image_size,
                            dtype=params["vision"]["patch_w"].dtype)
    out = {}
    with torch.no_grad():
        for name, tree in vision.items():
            n0 = va.launches
            out[name] = siglip.forward(tree, cfg.vision, img).float()
            out[name + "_k1"] = va.launches - n0
        ref, got = out["bf16"], out["int8"]
        rel = ((got - ref).abs().max() / ref.abs().max()).item()
        cos = torch.nn.functional.cosine_similarity(
            got, ref, dim=-1).min().item()
        ms = {"bf16": [], "int8": []}
        for order in (("int8", "bf16"), ("bf16", "int8")) * 2:
            for name in order:
                ms[name].append(time_ms(torch, lambda: siglip.forward(
                    vision[name], cfg.vision, img), iters=5))
    int8_bytes = tree_bytes(vision["int8"]["layers"])
    bf16_bytes = tree_bytes(params["vision"]["layers"])
    log(f"8b int8 tower vs bf16 on one frame: max rel diff {rel:.4e} (bound "
        f"{TOWER_INT8_MAX_REL}), least per-token cosine {cos:.6f} (bound "
        f"{TOWER_INT8_MIN_COSINE}); K1 {out['int8_k1']} / {out['bf16_k1']}; "
        f"vision ms per frame in turns int8 {ms['int8']} vs bf16 "
        f"{ms['bf16']}; layer weights {int8_bytes / 2**30:.3f} GiB vs "
        f"{bf16_bytes / 2**30:.3f} GiB")
    require("8b int8 tower", max_rel_diff=rel < TOWER_INT8_MAX_REL,
            per_token_cosine=cos > TOWER_INT8_MIN_COSINE,
            k1_per_layer=out["int8_k1"] == out["bf16_k1"]
            == cfg.vision.num_layers)
    return {"max_rel_diff": rel, "min_cosine": cos,
            "vision_ms_int8": ms["int8"], "vision_ms_bf16": ms["bf16"],
            "layer_bytes_int8": int8_bytes, "layer_bytes_bf16": bf16_bytes}


def act_int8_check(torch, params, cfg, tok, frames, instruction, batch,
                   device="cuda"):
    """Phase 8c: the phase-3 weights quantized by quantize_llm(bits=8) on
    the card, with and without cfg.llm.act_int8: one full-width prefill's
    logits (an agent call of max_new_tokens 2 each: its prefill ms too),
    then one LoRA micro-step (rank 16 on the seven targets, B made nonzero
    so A takes a gradient; remat, chunked CE) on a phase-4b micro-batch:
    loss, LoRA gradients and micro-step ms; both cosines >
    ACT_INT8_MIN_COSINE."""
    import dataclasses
    from streamvln_tpu_torch.agent import VLNAgent
    from streamvln_tpu_torch.models import lora as lora_lib
    from streamvln_tpu_torch.models import quant, streamvln
    from streamvln_tpu_torch.parallel.train import tree_leaves
    from streamvln_tpu_torch.streaming.engine import StreamingEngine
    q8 = quant.quantize_llm(params, bits=8)
    cfgs = {"act_int8": dataclasses.replace(cfg, llm=dataclasses.replace(
        cfg.llm, act_int8=True)), "weight_only": cfg}
    logits, prefill_ms = {}, {}
    for name, c in cfgs.items():
        e = StreamingEngine(q8, c, cache_capacity=4096, max_new_tokens=2,
                            stop_ids=(tok.im_end_id,), device=device,
                            compute_dtype=params["llm"]["embed"].dtype)
        agent = VLNAgent(e, tok)
        agent.step(0, frames[0], instruction, run_model=True)
        agent.reset_memory(0)
        agent.step(0, frames[0], instruction, run_model=True)
        logits[name] = e.last_logits.float()
        prefill_ms[name] = e.last_phase_ms[1]
        del e, agent
    agree = logits_agreement(torch, logits["act_int8"],
                             logits["weight_only"])
    g = torch.Generator(device=device).manual_seed(2)
    lp = lora_lib.add_lora(q8, torch.Generator(device=device).manual_seed(1),
                           rank=16, alpha=32.0)
    for path, t in tree_leaves(lp):
        if path.endswith("_lora_b"):
            t.normal_(0.0, 0.01, generator=g)
        t.requires_grad_(lora_lib.is_lora_path(path)
                         and t.is_floating_point())
    step = {}
    for name, c in cfgs.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step[name] = lora_loss_and_grads(torch, streamvln, lp, c, batch,
                                         "auto")
        torch.cuda.synchronize()
        step[name] += ((time.perf_counter() - t0) * 1e3,)
    (la, ga, ma), (lw, gw, mw) = step["act_int8"], step["weight_only"]
    cos = torch.nn.functional.cosine_similarity(ga, gw, dim=0).item()
    rel = abs(la - lw) / abs(lw)
    log(f"8c act_int8 vs weight-only int8: prefill logits cosine "
        f"{agree['cosine']:.6f} (top-1 agree {agree['top1_agree']}), prefill "
        f"{prefill_ms['act_int8']:.2f} vs {prefill_ms['weight_only']:.2f} ms;"
        f" LoRA micro-step loss {la:.6f} vs {lw:.6f} (rel {rel:.3e}), "
        f"gradient cosine {cos:.6f}, {ma:.1f} vs {mw:.1f} ms")
    require("8c act_int8", prefill_cosine=agree["cosine"]
            > ACT_INT8_MIN_COSINE, lora_gradient_cosine=cos
            > ACT_INT8_MIN_COSINE, finite_loss=math.isfinite(la))
    del lp, q8
    return {"prefill": agree, "prefill_ms": prefill_ms,
            "loss": {"act_int8": la, "weight_only": lw}, "loss_rel_diff": rel,
            "lora_gradient_cosine": cos,
            "micro_step_ms": {"act_int8": ma, "weight_only": mw}}


@contextlib.contextmanager
def plain_int4_route(torch):
    """While open, every packed-int4 product of the decoder and the lm_head
    takes the plain route: the layer dequantized in f32 and one f32 product
    (autograd differentiates it), in place of K6 or K7 and a bf16 product."""
    from streamvln_tpu_torch.models import qwen2, quant
    product = qwen2._int4_product

    def plain(x, w, s):
        return torch.matmul(x.float(), quant.dequant_int4(w, s,
                                                          torch.float32))
    qwen2._int4_product = plain
    try:
        yield
    finally:
        qwen2._int4_product = product


@contextlib.contextmanager
def k7_by_phase(torch, i4, box):
    """While open, K7's launches in each train micro-step are split three
    ways into `box`: "forward" (up to the return of forward_train),
    "backward" (the launches counted inside the K7 product's backward) and
    "recompute" (the rest of the backward: the checkpoints' forwards run
    again)."""
    from streamvln_tpu_torch.models import streamvln
    fwd, bwd = streamvln.forward_train, i4._Int4PrefillMatmul.backward
    box.update(forward=0, recompute=0, backward=0, mark=None)

    def forward_train(*a, **k):
        out = fwd(*a, **k)
        box["mark"] = i4.dequant_launches
        return out

    def backward(ctx, g):
        n = i4.dequant_launches
        out = bwd(ctx, g)
        box["backward"] += i4.dequant_launches - n
        return out
    streamvln.forward_train = forward_train
    i4._Int4PrefillMatmul.backward = staticmethod(backward)
    try:
        yield box
    finally:
        streamvln.forward_train = fwd
        i4._Int4PrefillMatmul.backward = staticmethod(bwd)


def qlora_steps(torch, np, q4, q_s, cfg, tok, frames, instruction, batches,
                fa, va, i4, bf16_lora, device="cuda"):
    """Phase 8d: QLoRA. `q4`: the phase-3 weights quantized to int4 on the
    card (quantize_llm(bits=4), in `q_s` seconds; the bf16 LLM already
    freed), with LoRA rank 16 on the seven targets; one
    micro-batch's loss and LoRA gradients through the kernels against the
    plain int4 route (plain_int4_route; the training gates); 3 optimizer
    steps (lora_only, grad accum 2, remat, chunked CE) of phase 4b's
    micro-batches with exact K3/K4/K5 and K7 counts, K7 split into the
    forward, the checkpoints' recompute and the backward (k7_by_phase);
    finite losses, the packed weights, their scales and every other base
    leaf bit-equal after the steps, the adapters moved; step ms, tokens/s
    and peak memory beside phase 4b's bf16 LoRA step; then merge_lora
    into the int4 weights and one agent call on the merged weights."""
    from streamvln_tpu_torch.models import lora as lora_lib
    from streamvln_tpu_torch.models import streamvln
    from streamvln_tpu_torch.parallel.train import (
        TrainConfig, create_train_state, make_train_step, tree_leaves)
    tcfg = TrainConfig(lora_only=True, grad_accum_steps=2, remat=True,
                       loss_chunk_size=512, total_steps=3)
    state = create_train_state(lora_lib.add_lora(
        q4, torch.Generator(device=device).manual_seed(1), rank=16,
        alpha=32.0), tcfg)
    del q4
    base = {p: t.to("cpu") for p, t in tree_leaves(state.params)
            if not lora_lib.is_lora_path(p)}
    packed = sum(t.dtype == torch.uint8 for t in base.values())
    lora_b0 = {p: t.detach().clone() for p, t in tree_leaves(state.params)
               if p.endswith("_lora_b")}

    ref = {}
    for route in ("kernels", "plain"):
        t0 = time.perf_counter()
        with plain_int4_route(torch) if route == "plain" else \
                contextlib.nullcontext():
            ref[route] = lora_loss_and_grads(torch, streamvln, state.params,
                                             cfg, batches[-1], "auto")
        torch.cuda.synchronize()
        log(f"8d reference {route}: loss {ref[route][0]:.6f} in "
            f"{time.perf_counter() - t0:.2f} s")
    (lk, gk), (lp_, gp) = ref["kernels"], ref["plain"]
    rel = abs(lk - lp_) / abs(lp_)
    cos = torch.nn.functional.cosine_similarity(gk, gp, dim=0).item()
    del ref, gk, gp
    log(f"8d int4 kernels vs the plain int4 route: loss rel diff {rel:.3e}, "
        f"LoRA grad cosine {cos:.6f}")
    require("8d QLoRA through the kernels vs the plain int4 route",
            loss=rel <= TRAIN_LOSS_RTOL, lora_gradient_cosine=cos
            >= TRAIN_GRAD_MIN_COSINE)

    step = make_train_step(cfg, tcfg, device=device)
    n_micro = 3 * tcfg.grad_accum_steps
    valid = [int(b["valid"].sum()) for b in batches]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    fa.launches = fa.lse_launches = fa.dq_launches = fa.dkv_launches = 0
    va.launches, va.launches_by_batch = 0, {}
    i4.launches = i4.dequant_launches = 0
    metrics, micro_ms, k7 = [], [], []
    box = {}
    with k7_by_phase(torch, i4, box):
        for i in range(n_micro):
            n7, b0 = i4.dequant_launches, box["backward"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batches[i])
            torch.cuda.synchronize()
            micro_ms.append((time.perf_counter() - t0) * 1e3)
            fwd = box["mark"] - n7
            bwd = box["backward"] - b0
            k7.append({"forward": fwd, "backward": bwd,
                       "recompute": i4.dequant_launches - n7 - fwd - bwd})
            metrics.append({"loss": m["loss"].item(),
                            "grad_norm": m["grad_norm"].item()})
            log(f"8d micro-step {i}: loss {metrics[-1]['loss']:.6f} "
                f"grad_norm {metrics[-1]['grad_norm']:.6f} "
                f"{micro_ms[-1]:.2f} ms; K7 {k7[-1]}")
    peak = torch.cuda.max_memory_allocated()
    counts = {"vit_attention": va.launches, "flash_attention": fa.launches,
              "flash_attention_lse": fa.lse_launches,
              "flash_bwd_dq": fa.dq_launches, "flash_bwd_dkv": fa.dkv_launches,
              "int4_matmul": i4.launches,
              "int4_dequant_split": i4.dequant_launches}
    vit_by_batch = by_batch(va)
    L, Lv = cfg.llm.num_layers, cfg.vision.num_layers
    T = batches[0]["token_ids"].shape[1]
    chunks = T // tcfg.loss_chunk_size
    # per micro-step: the seven unfused LoRA-carrying projections of each
    # layer and the lm_head of each CE chunk, all above 128 rows (K7);
    # remat runs each again in the backward; every one takes a backward
    # but layer 0's q/k/v, whose input (the frozen embeddings and tower
    # features) needs no gradient
    k7_want = {"forward": 7 * L + chunks, "backward": 7 * L - 3 + chunks,
               "recompute": 7 * L + chunks}
    want = {"vit_attention": Lv * n_micro, "flash_attention": 0,
            "flash_attention_lse": 2 * L * n_micro,
            "flash_bwd_dq": L * n_micro, "flash_bwd_dkv": L * n_micro,
            "int4_matmul": 0,
            "int4_dequant_split": sum(k7_want.values()) * n_micro}
    log(f"8d launches on the QLoRA path: {counts} (want {want}); K7 per "
        f"micro-step {k7_want}; K1 by batch {vit_by_batch}")
    opt_ms = [sum(micro_ms[i:i + 2]) for i in range(0, n_micro, 2)]
    tok_step = [valid[i] + valid[i + 1] for i in range(0, n_micro, 2)]
    rates = [n / ms * 1e3 for ms, n in zip(opt_ms, tok_step)]
    med, med_rate = float(np.median(opt_ms)), float(np.median(rates))
    log(f"8d median optimizer step {med:.2f} ms, {med_rate:.1f} valid "
        f"tokens/s, peak memory allocated {peak / 2**30:.2f} GiB, "
        f"{resident / 2**30:.2f} GiB of it resident before the steps "
        f"(phase 4b bf16 LoRA: {bf16_lora['median_step_ms']:.2f} ms, "
        f"{bf16_lora['tokens_per_s']:.1f} tokens/s, "
        f"{bf16_lora['peak_memory_bytes'] / 2**30:.2f} GiB)")
    finite = all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
                 and m["grad_norm"] > 0 for m in metrics)
    frozen_ok = all(torch.equal(t.to("cpu"), base[p])
                    for p, t in tree_leaves(state.params) if p in base)
    moved = sum(not torch.equal(t, lora_b0[p])
                for p, t in tree_leaves(state.params) if p in lora_b0)
    log(f"8d checks: finite {finite}; {len(base)} base leaves ({packed} "
        f"packed int4) bit-identical {frozen_ok}; LoRA B stacks changed "
        f"{moved} of {len(lora_b0)}")
    require("8d QLoRA", finite=finite, frozen_base_and_packed=frozen_ok,
            packed_leaves=packed == 8, adapters_moved=moved == len(lora_b0),
            launch_counts=counts == want,
            k7_by_phase=all(k == k7_want for k in k7),
            k1_batches=sum(vit_by_batch.values()) == counts["vit_attention"])
    del base, lora_b0
    t0 = time.perf_counter()
    with torch.no_grad():
        merged = lora_lib.merge_lora(state.params)
    del state
    gc.collect()
    torch.cuda.synchronize()
    merge_s = time.perf_counter() - t0
    layers = merged["llm"]["layers"]
    merged_ok = layers["gate_w"].dtype == torch.uint8 and not any(
        "_lora_" in k for k in layers)
    toks, lg = one_call(torch, merged, cfg, frames[0], instruction, device)
    log(f"8d merge_lora into the int4 weights in {merge_s:.2f} s (int4 "
        f"stacks {merged_ok}); one agent call on the merged weights: "
        f"{len(toks)} tokens, finite logits {bool(torch.isfinite(lg).all())}")
    require("8d merged weights", int4_without_adapters=merged_ok,
            tokens=bool(toks) and all(0 <= t < cfg.llm.vocab_size
                                      for t in toks),
            finite_logits=bool(torch.isfinite(lg).all()))
    del merged
    return {"quantize_s": q_s, "reference": {"loss_rel_diff": rel,
                                             "lora_grad_cosine": cos},
            "metrics": metrics, "micro_ms": micro_ms,
            "optimizer_step_ms": opt_ms, "median_step_ms": med,
            "tokens_per_s": med_rate, "peak_memory_bytes": peak,
            "resident_bytes_before_steps": resident,
            "launches": counts, "k7_per_micro_step": k7,
            "k7_want_per_micro_step": k7_want,
            "vit_launches_by_batch": vit_by_batch, "merge_s": merge_s,
            "merged_call_tokens": toks,
            "bf16_lora": {k: bf16_lora[k] for k in (
                "median_step_ms", "tokens_per_s", "peak_memory_bytes")}}


def quantized_tail(torch, np, cfg, tok, frames, instruction, batches,
                   bf16_lora, va, fa, i4, counts, reset, model_size="7b",
                   device="cuda", dtype=None):
    """Phase 8: the quantized tail at full width (streamvln_7b, 4096 KV
    slots, 480x640 frames, the ByteTokenizer) on the phase-3 weights, made
    again from their seed (phase 3 freed them): 8a the kv_int8 engine
    (kv_int8_serving); 8b the int8 tower alone (int8_tower); 8c act_int8
    (act_int8_check); 8d QLoRA (qlora_steps) on the weights quantized to
    int4, the bf16 LLM freed first; then 8b's entry point, eval_cli.main
    --kv_int8 --vision_int8 on phase 5's steered weights
    (eval_entry_point), once nothing else of the phase is left on the
    card, so that its peak memory is its own. Returns the phase's
    record."""
    from streamvln_tpu_torch.models import quant
    from streamvln_tpu_torch.weights import init
    t_start = time.perf_counter()
    # what earlier phases left in reference cycles (engines, agents) goes
    # first, so that the phase's peaks are its own
    gc.collect()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    params = init(cfg, torch.Generator(device=device).manual_seed(0),
                  device=device, dtype=dtype or torch.bfloat16)
    # K1's batch sizes over the phase (each sub-phase resets the counts)
    batches_k1 = set()
    rec = {"kv_int8": kv_int8_serving(torch, np, params, cfg, tok, frames,
                                      instruction, counts, reset, device)}
    batches_k1 |= set(by_batch(va))
    gc.collect()
    torch.cuda.empty_cache()
    rec["tower"] = int8_tower(torch, params, cfg, frames, va, device)
    batches_k1 |= set(by_batch(va))
    rec["act_int8"] = act_int8_check(torch, params, cfg, tok, frames,
                                     instruction, batches[-1], device)
    batches_k1 |= set(by_batch(va))
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    q4 = quant.quantize_llm(params, bits=4)
    torch.cuda.synchronize()
    q_s = time.perf_counter() - t0
    del params
    gc.collect()
    torch.cuda.empty_cache()
    rec["qlora"] = qlora_steps(torch, np, q4, q_s, cfg, tok, frames,
                               instruction, batches, fa, va, i4, bf16_lora,
                               device)
    batches_k1 |= set(rec["qlora"]["vit_launches_by_batch"])
    del q4
    gc.collect()
    torch.cuda.empty_cache()
    flags = ("--kv_int8", "--vision_int8") + (
        () if device == "cuda" else ("--device", device))
    rec["entry_point"] = eval_entry_point(
        torch, va, counts, reset, flags=flags, name="eval_int8", what="8b",
        model_size=model_size)
    require("8b the entry point's engine", kv_int8=rec["entry_point"][
        "kv_int8"], tower_int8=rec["entry_point"]["tower_int8"])
    batches_k1 |= set(rec["entry_point"]["vit_launches_by_batch"])
    rec["vit_batches"] = sorted(batches_k1)
    rec["resident_bytes_at_start"] = resident
    gc.collect()
    torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t_start
    return rec


def quantized_tail_summary(q, card) -> str:
    """Phase 8 on one line, beside the card's name and power limit."""
    a, t, e, c, d = (q["kv_int8"], q["tower"], q["entry_point"],
                     q["act_int8"], q["qlora"])
    med = {k: v["median_mid_window"] for k, v in a["paired"].items()}
    return (f"phase 8 quantized tail ({card}): kv_int8 cache "
            f"{a['cache_bytes']['int8'] / 1e6:.1f} MB vs bf16 "
            f"{a['cache_bytes']['bf16'] / 1e6:.1f} MB; decode ms per emitted "
            f"token kv_int8 {med['kv_int8']['decode_ms_per_token']:.2f} vs "
            f"bf16 {med['bf16']['decode_ms_per_token']:.2f} (spec 6: "
            f"{med['kv_int8_spec']['decode_ms_per_token']:.2f} vs "
            f"{med['bf16_spec']['decode_ms_per_token']:.2f}); int8 tower rel "
            f"diff {t['max_rel_diff']:.3e}, vision ms/frame "
            f"{min(t['vision_ms_int8']):.2f} vs bf16 "
            f"{min(t['vision_ms_bf16']):.2f}; eval_cli --kv_int8 "
            f"--vision_int8 model call p50 "
            f"{e['final']['model_call_p50_ms']:.2f} p90 "
            f"{e['final']['model_call_p90_ms']:.2f} ms; act_int8 cosine "
            f"{c['prefill']['cosine']:.5f} / grad "
            f"{c['lora_gradient_cosine']:.5f}; QLoRA step "
            f"{d['median_step_ms']:.2f} ms, {d['tokens_per_s']:.1f} "
            f"tokens/s, {d['peak_memory_bytes'] / 2**30:.2f} GiB (bf16 "
            f"LoRA {d['bf16_lora']['median_step_ms']:.2f} ms); "
            f"{q['seconds']:.1f} s")


def device_ms(torch, fns, calls=None) -> float:
    """Device time per call of a rotation of `fns`: the summed durations
    of the CUDA kernels they launch (torch.profiler), so that a host
    slower than the kernels does not count; see time_cold_ms for the
    rotation."""
    calls = calls or max(12, len(fns))
    for f in fns[:2]:
        f()
    torch.cuda.synchronize()

    def run():
        for i in range(calls):
            fns[i % len(fns)]()
    events = cuda_events(torch, run)
    if not events:
        log("  no capture recorded a kernel: the time is taken with CUDA "
            "events over the same rotation instead")
        return time_cold_ms(torch, fns, iters=calls)
    total_us = sum(e.time_range.end - e.time_range.start for e in events)
    return total_us / 1e3 / calls


def kernel_entry(name, src, replaces, launches, recs, head=0, **extra):
    """One kernel's record of the kernels line: the numbers of its head
    shape, every shape under "shapes"."""
    r = recs[head]
    for x in recs:
        x.update(shares(x))
    return {"name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(x["max_abs_err"] for x in recs),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], **shares(r), "shape": r["shape"],
            "shapes": recs, **extra}


def serving_launches(serving, name) -> dict:
    """A kernel's launches in phase 6, by sub-phase."""
    return {"robot": serving["robot"]["launches"][name],
            "wave8": serving["batched"]["launches_wave8"][name],
            "wave1": serving["batched"]["launches_wave1"][name],
            "fused": serving["fused"]["launches"][name]}


def qtail_launches(q, name) -> dict:
    """A kernel's launches in phase 8, by sub-phase (8a's 9 kv_int8 calls,
    8b's entry point, 8d's 6 QLoRA micro-steps)."""
    return {"kv_int8": q["kv_int8"]["launches"][name],
            "entry_point": q["entry_point"]["launches"][name],
            "qlora": q["qlora"]["launches"][name]}


def serving_summary(s) -> str:
    """Phase 6 on one line."""
    r, c, b, f = s["robot"], s["chat"], s["batched"], s["fused"]
    greedy = c["streams"][0]
    return (f"phase 6 serving stack: robot request p50 "
            f"{r['request_ms_p50']:.2f} p90 {r['request_ms_p90']:.2f} ms "
            f"(outside the call p50 {r['http_share_ms_p50']:.2f} ms; "
            f"{r['requests']} served, the next refused with "
            f"{(r['refusal'] or {}).get('code')}); stream "
            f"first chunk {greedy['first_chunk_ms']:.2f} ms, "
            f"{greedy['chunks']} chunks, continue_decode "
            f"{greedy['continue_decode_ms_per_token']:.2f} ms/token; "
            f"requests/s at the client: waves of 8 "
            f"{b['requests_per_s_wave8_client']:.2f} vs waves of 1 "
            f"{b['requests_per_s_wave1_client']:.2f} (per engine call "
            f"{b['requests_per_s_wave8']:.2f} / "
            f"{b['requests_per_s_wave1']:.2f}, B=1 "
            f"{b['requests_per_s_alone_b1']:.2f}); default wait: "
            f"waves {b['default_wait']['batch_sizes']}; mixed wave "
            f"{b['mixed_wave']['sampled_tokens_in_support']}/"
            f"{b['mixed_wave']['sampled_tokens']} sampled in support; decode "
            f"{b['decode_ms_per_token_all_rows']:.2f} ms/token over rows at "
            f"B=8; fused vision {min(f['vision_ms_fused']):.3f} vs unfused "
            f"{min(f['vision_ms_unfused']):.3f} ms/frame (f32 tower rel "
            f"diff {f['max_rel_diff_f32']:.2e}); peak "
            f"{s['peak_memory_bytes'] / 2**30:.2f} GiB; {s['seconds']:.1f} s")


def turnkey_summary(t, card) -> str:
    """Phase 7 on one line, beside the card's name and power limit."""
    first = t["runs"][0]
    load = first["load"]
    total = load["read_s"] + load["convert_s"] + load["upload_s"]
    return (f"phase 7 turnkey ({card}): checkpoint "
            f"{t['checkpoint_bytes'] / 2**30:.3f} GiB in "
            f"{len(t['shards'])} shards written in {t['write_s']:.2f} s; load "
            f"{total:.2f} s (read {load['read_s']:.3f}, convert "
            f"{load['convert_s']:.2f}, upload {load['upload_s']:.2f}) = "
            f"{load['bytes'] / total / 1e9:.2f} GB/s; host staging "
            f"{t['stagings']['host']['wall_s']:.2f} s vs device "
            f"{t['stagings']['device']['wall_s']:.2f} s; build peak "
            f"{first['build_peak_bytes'] / 2**30:.3f} GiB vs random init "
            f"{t['random_init_build_peak_bytes'] / 2**30:.3f} GiB; host peak "
            f"RSS {first['peak_rss_gib']:.2f} GiB (written tree "
            f"{t['written_tree_gib']:.2f}); model call p50 "
            f"{first['final']['model_call_p50_ms']:.2f} p90 "
            f"{first['final']['model_call_p90_ms']:.2f} ms; "
            f"{t['seconds']:.1f} s")


def by_batch(va) -> dict:
    """K1's launches by batch size since its counts were last reset."""
    return {f"B={b}": n for b, n in sorted(va.launches_by_batch.items())}


def shares(r) -> dict:
    """bound_share = bound_ms / ms (the share of the card's bound the
    kernel reaches); vs_library = ms / library_ms (null without one)."""
    lib = r.get("library_ms")
    return {"bound_share": r["bound_ms"] / r["ms"],
            "vs_library": r["ms"] / lib if lib else None}


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
    from streamvln_tpu_torch.models import quant
    from streamvln_tpu_torch.models.fuse import fuse_projections
    from streamvln_tpu_torch.ops import decode_attention as da
    from streamvln_tpu_torch.ops import flash_attention as fa
    from streamvln_tpu_torch.ops import int4_matmul as i4
    from streamvln_tpu_torch.ops import vit_attention as va
    from streamvln_tpu_torch.streaming.engine import StreamingEngine
    from streamvln_tpu_torch.weights import init

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    def reset_counts():
        va.launches = fa.launches = i4.launches = i4.dequant_launches = 0
        da.launches, va.launches_by_batch = 0, {}

    def serving_counts():
        return {"vit_attention": va.launches, "flash_attention": fa.launches,
                "int4_matmul": i4.launches,
                "int4_dequant_split": i4.dequant_launches,
                "decode_attention": da.launches}

    # 1. build
    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"phase 1: built {list(build.KERNELS)} in "
        f"{time.perf_counter() - t0:.2f} s")
    for name in build.KERNELS:
        log(f"  {name}: {ptxas_summary(build.build_logs.get(name, ''))}")
    sass = {n: sass_counts(libs[n]) for n in build.KERNELS}
    log(f"  SASS instruction counts (wgmma HGMMA, mma.sync HMMA, TMA load "
        f"UTMALDG, bulk copy UBLKCP, cp.async LDGSTS): {sass}")
    if not all(sass_ok(n, c) for n, c in sass.items()):
        raise AssertionError("a library lacks the instructions its design "
                             "relies on")
    # K4/K5 keep dK, dV (or dQ) and two score tiles in registers
    bwd_log = build.build_logs.get("flash_attention_bwd")
    if bwd_log is not None and not registers_ok(bwd_log):
        raise AssertionError("the K4/K5 kernels spill registers or "
                             "serialize their wgmma")
    card = card_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. kernels against their plain versions at main-path shapes
    # K1 at each batch a main path sends: one frame per model call, the
    # history backfill of num_history frames (phase 5), the training tower
    vit = [check_vit(torch, F, va, B) for B in
           (1, streamvln_7b().num_history, TRAIN_TOWER_BATCH)]
    flash = [check_flash(torch, F, fa, Sq) for Sq in (768, 2560)] + \
        [check_flash(torch, F, fa, 768, offsets=WAVE_OFFSETS)]
    int4_recs, dequant_recs = check_int4(torch, i4, quant)
    decode_recs = check_decode(torch, F, da)

    # 3. the main path at full width (bf16; q/k/v and gate/up fused once,
    # as the engine would, and shared by this phase's engines)
    cfg = streamvln_7b()
    t0 = time.perf_counter()
    params = init(cfg, torch.Generator(device="cuda").manual_seed(0),
                  device="cuda", dtype=torch.bfloat16)
    fused = fuse_projections(params)
    torch.cuda.synchronize()
    log(f"phase 3: streamvln_7b bf16 weights on the card, fused, in "
        f"{time.perf_counter() - t0:.2f} s "
        f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB)")
    tok = ByteTokenizer()
    captures = []
    strict_captures(torch, captures)
    engine = StreamingEngine(fused, cfg, cache_capacity=4096,
                             max_new_tokens=16, stop_ids=(tok.im_end_id,))
    agent = VLNAgent(engine, tok)
    frames = np.random.default_rng(0).integers(0, 256, (33, 480, 640, 3),
                                               np.uint8)
    instruction = "walk past the sofa and stop at the kitchen door"
    calls, wall = drive_calls(torch, agent, engine, cfg, frames,
                              instruction, reset_counts)
    counts = serving_counts()
    vit_by_batch = by_batch(va)
    n_vit, n_flash = counts["vit_attention"], counts["flash_attention"]
    n_calls = len(calls)
    want = {"vit_attention": cfg.vision.num_layers * n_calls,
            "flash_attention": cfg.llm.num_layers * n_calls,
            "int4_matmul": 0, "int4_dequant_split": 0,
            "decode_attention": 0}
    log(f"launches on the main path: {counts} (want {want}); K1 by "
        f"batch {vit_by_batch}")
    if counts != want or sum(vit_by_batch.values()) != n_vit:
        raise AssertionError("kernel launch counts do not match the path")

    # the profiled call is a mid-window call: compare with calls 1..7
    prof = profile_call(
        torch, lambda: agent.step(0, frames[-1], instruction,
                                  run_model=True),
        float(np.median(wall[1:8])))

    # reference check: the first call's prefill logits, kernels vs the
    # repo's dense attention path, on the same weights and inputs
    outs = []
    for impl in ("auto", "dense"):
        eng = StreamingEngine(fused, cfg, cache_capacity=4096,
                              max_new_tokens=2, stop_ids=(tok.im_end_id,),
                              attn_impl=impl)
        VLNAgent(eng, tok).step(0, frames[0], instruction, run_model=True)
        outs.append(eng.last_logits.float())
        del eng
    ref3 = logits_agreement(torch, *outs)
    log(f"reference check (prefill logits, kernels vs dense): cosine "
        f"{ref3['cosine']:.6f} max rel diff {ref3['max_rel_diff']:.3e} "
        f"top-1 agree {ref3['top1_agree']}")
    if not ref3["cosine"] > REF_MIN_COSINE:
        raise AssertionError("kernel path disagrees with the dense path")
    del agent, outs

    # 3b. decode attention through K8 (bf16 weights)
    dk, engine_dk = serve_decode_kernel(torch, fused, cfg, tok, frames,
                                        instruction, serving_counts,
                                        reset_counts)
    # 3c. int4 weight-only serving of the same weights
    int4, engine4 = serve_int4(torch, np, params, cfg, tok, frames,
                               instruction, serving_counts, reset_counts)
    # K6 and K8 merge their splits inside their one launch
    second_pass = [n for n in int4["profile"]["kernel_names"]
                   if "sum_splits" in n or "decode_combine" in n]
    if second_pass:
        raise AssertionError(f"second-pass kernels in the profiled int4 "
                             f"call: {second_pass}")
    # 3d. the serving variants in turns (bf16_spec: prompt-lookup
    # speculation, the evaluation entry point's default)
    engine_spec = StreamingEngine(fused, cfg, cache_capacity=4096,
                                  max_new_tokens=16, spec_lookup=6,
                                  stop_ids=(tok.im_end_id,))
    variants = {"bf16": engine, "bf16_decode_kernel": engine_dk,
                "int4": engine4, "bf16_spec": engine_spec}
    paired = paired_timing(torch, np, variants, cfg, tok, frames,
                           instruction)
    for name, r in paired.items():
        ops = r["profile"]["host_ops_per_decode_forward"]
        require(f"3d {name}: the profiled call's decode forwards",
                graph_replays=ops is not None,
                at_most_4_launches_or_copies_besides_replay_and_flag=ops
                is not None and ops <= 4)
    # 3g. every decode forward of the four variants replayed against the
    # same step run eagerly
    replays = graphs_vs_eager(torch, variants, cfg, tok, frames,
                              instruction)
    log_captures("phases 3-3d", captures)
    del engine, engine_dk, engine4, engine_spec, variants
    gc.collect()
    # 3e. speculative decode against greedy, call by call
    spec = spec_vs_greedy(torch, np, fused, cfg, tok, frames, instruction)
    # 3f. sampled decode
    sampling = sampling_on_card(torch, fused, cfg, tok, frames, instruction)
    del fused
    # the call recorders leave each engine in a reference cycle (its
    # restored bound `collect`): collect them now, or their weights and
    # caches stay allocated through phase 4 and its peak memory
    gc.collect()
    torch.cuda.empty_cache()

    # 4. training: the kernels at the train step's shape, then LoRA SFT
    train_k = check_training_kernels(torch, F, fa)
    train, train_batches = train_full_width(torch, np, params, cfg, tok, fa,
                                            va)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # 5. the evaluation entry point (it makes its own weights)
    n_captures = len(captures)
    evaluation = eval_entry_point(torch, va, serving_counts, reset_counts)
    evaluation["captures"] = captures[n_captures:]
    log_captures("phase 5", evaluation["captures"])

    # 6. the serving stack at full width (it makes its own weights)
    n_captures = len(captures)
    serving = serving_stack(torch, np, va, serving_counts, reset_counts)
    serving["captures"] = captures[n_captures:]
    log_captures("phase 6", serving["captures"])

    # 7. the turnkey command: an HF checkpoint and the habitat backend
    n_captures = len(captures)
    turnkey = turnkey_command(torch, np, va, serving_counts, reset_counts)
    turnkey["captures"] = captures[n_captures:]
    log_captures("phase 7", turnkey["captures"])

    # 8. the quantized tail: the int8 KV cache, the int8 tower and
    # eval_cli --kv_int8 --vision_int8, act_int8, QLoRA
    n_captures = len(captures)
    qtail = quantized_tail(torch, np, cfg, tok, frames, instruction,
                           train_batches, train, va, fa, i4, serving_counts,
                           reset_counts)
    qtail["captures"] = captures[n_captures:]
    log_captures("phase 8", qtail["captures"])
    del train_batches

    sent = set(vit_by_batch) | set(train["vit_launches_by_batch"]) | \
        set(evaluation["vit_launches_by_batch"]) | \
        set(serving["vit_launches_by_batch"]) | \
        set(turnkey["vit_launches_by_batch"]) | \
        set(qtail["vit_batches"])
    unchecked = sent - {f"B={r['batch']}" for r in vit}
    if unchecked:
        raise AssertionError(f"the main paths sent K1 batches {unchecked} "
                             f"that phase 2 did not check")
    k7_shapes = {f"{din}x{dout} {dt}": n for (din, dout, dt), n
                 in sorted(i4.dequant_launches_by_shape.items())}
    unchecked = set(i4.dequant_launches_by_shape) - {
        tuple(r["key"]) for r in dequant_recs}
    if unchecked:
        raise AssertionError(f"the run launched K7 at (din, dout, dtype) "
                             f"{sorted(unchecked)}, which phase 2 did not "
                             f"check")
    log(f"K7 launches by shape over the whole run: {k7_shapes}")

    # 9. summary
    kernels = [
        kernel_entry("vit_attention",
                     "streamvln_tpu_torch/csrc/vit_attention.cu",
                     "streamvln_tpu/ops/vit_attention.py:37", n_vit, vit,
                     launches_by_batch=vit_by_batch,
                     launches_by_batch_training=train[
                         "vit_launches_by_batch"],
                     launches_int4=int4["launches"]["vit_attention"],
                     launches_decode_kernel=dk["launches"]["vit_attention"],
                     launches_training=train["launches"]["vit_attention"],
                     launches_eval=evaluation["launches"]["vit_attention"],
                     launches_serving_stack=serving_launches(
                         serving, "vit_attention"),
                     launches_turnkey=turnkey["launches"]["vit_attention"],
                     launches_quantized_tail=qtail_launches(
                         qtail, "vit_attention")),
        kernel_entry("flash_attention",
                     "streamvln_tpu_torch/csrc/flash_attention.cu",
                     "streamvln_tpu/ops/flash_attention.py:49", n_flash,
                     flash,
                     launches_int4=int4["launches"]["flash_attention"],
                     launches_eval=evaluation["launches"][
                         "flash_attention"],
                     launches_serving_stack=serving_launches(
                         serving, "flash_attention"),
                     launches_turnkey=turnkey["launches"][
                         "flash_attention"],
                     launches_quantized_tail=qtail_launches(
                         qtail, "flash_attention"))]
    for name, src in (
            ("flash_attention_lse",
             "streamvln_tpu_torch/csrc/flash_attention.cu"),
            ("flash_bwd_dq",
             "streamvln_tpu_torch/csrc/flash_attention_bwd.cu"),
            ("flash_bwd_dkv",
             "streamvln_tpu_torch/csrc/flash_attention_bwd.cu")):
        r = train_k[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": r["replaces"], "launches": train["launches"][name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            **shares(r), "shape": r["shape"], "library": r["library"],
            "launches_qlora": qtail["qlora"]["launches"][name]})
    kernels += [
        kernel_entry("int4_matmul",
                     "streamvln_tpu_torch/csrc/int4_matmul.cu",
                     "streamvln_tpu/ops/int4_matmul.py:93",
                     int4["launches"]["int4_matmul"], int4_recs, head=2,
                     library=int4_recs[2]["library"]),
        kernel_entry("int4_dequant_split",
                     "streamvln_tpu_torch/csrc/int4_matmul.cu",
                     "streamvln_tpu/ops/int4_matmul.py:170",
                     int4["launches"]["int4_dequant_split"], dequant_recs,
                     head=2, launches_qlora=qtail["qlora"]["launches"][
                         "int4_dequant_split"],
                     launches_qlora_per_micro_step=qtail["qlora"][
                         "k7_per_micro_step"],
                     launches_by_shape=k7_shapes),
        kernel_entry("decode_attention",
                     "streamvln_tpu_torch/csrc/decode_attention.cu",
                     "streamvln_tpu/ops/decode_attention.py:31",
                     dk["launches"]["decode_attention"], decode_recs,
                     library="F.scaled_dot_product_attention (enable_gqa) "
                             "on the live prefix")]
    seconds = time.perf_counter() - t_start
    log(serving_summary(serving))
    log(turnkey_summary(turnkey, card))
    log(quantized_tail_summary(qtail, card))
    log(f"chip_smoke: all phases passed in {seconds:.1f} s")
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "sass": sass, "kernels": kernels,
                   "calls": calls,
                   "wall_ms": wall, "profile": prof, "reference": ref3,
                   "decode_kernel": dk, "int4": int4, "paired": paired,
                   "spec_vs_greedy": spec, "sampling": sampling,
                   "graphs_vs_eager": replays, "captures": captures,
                   "training_kernels": train_k, "training": train,
                   "evaluation": evaluation, "serving_stack": serving,
                   "turnkey": turnkey, "quantized_tail": qtail,
                   "seconds": seconds}, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
