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
     call; K1 and SDPA also on the settled yardstick below, over operand
     copies past the L2 cache, and K2 at B=1 beside SDPA on the live
     prefix (GRAPH_CALLS calls); K1, K2 and K3 wherever checked: a second
     call bit-equal, one kernel enqueued per call and two replays of a
     captured CUDA graph bit-equal to the eager call); K6
     (int4 dequant-matmul) at every int4 projection's decode shape, the
     four layer projections at the speculative verify's 7 rows and
     gate/up at 128 rows, K7 (int4 unpack) for qkv, o, gate/up, down, the
     lm_head and the unfused k/v and gate/up of the QLoRA step (the script
     fails at its end if any phase launched K7 at another shape), K8
     (decode attention) at four live lengths of a 4096-slot cache; K6, K7
     and K8 timed over enough operand copies to miss the L2 cache, as the
     decode path does, with their host cost per call; every K6, K7 and
     K8 shape also checks that a second call is bit-equal to the first
     and that a call launches one kernel, K7 in bf16 and f32; K6 (beside
     int4pack), K7 (beside a copy of its output's size, the card's
     stream rate) and K8 (beside SDPA) also on the settled yardstick
     (graph_ms: a rotation
     captured into one CUDA graph, replayed GRAPH_REPLAYS times between
     CUDA events, the median of GRAPH_RUNS readings with min and max; a
     reading below the bound is refused, logged and not recorded), with
     K8's launch plan;
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
     its plain version and SDPA's forward / backward under autograd, K3
     also on the settled yardstick beside causal SDPA over the valid
     rows; dQ, dK and dV bit-equal over two calls; the same at Gemma-2B's
     training shape (8/1 heads, D=256: K4/K5's WIDE instance, K5 with its
     head split);
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
  9. the training entry point (train_cli): 9a `train.main` in process at
     full width (--model_size 7b --lora_enable --lora_r 16 --batch_size 2
     --grad_accum_steps 2 --num_steps 6 --save_steps 6 --log_steps 1
     --eval_steps 4 --eval_episodes 1 --prefetch_depth 2) on synthetic
     trajectories of 480x640 JPEG frames in a directory under
     tempfile.gettempdir() (removed in every case; the phase raises with
     the bytes it writes when that disk has less free): 6 finite loss
     lines, the metrics.jsonl mirror, one eval/ line, exact K1/K3/K4/K5
     launches per micro-step, K1/K2 per tower pass and prefill of the
     evaluation, frozen weights bit-equal to the initial ones, every
     adapter moved, one checkpoint (step 6) restored bit-equal to the final
     state (accumulator included), the hook called once more on the final
     params returning the memory it took; optimizer-step ms, valid
     tokens/s, peak memory, the time each micro-step waits for its batch,
     one profiled micro-step's idle share and the save's seconds and bytes,
     beside phase 4b's, all read from what the command writes and a
     wrapper of its step function (step_probe); 9b the command at
     --model_size 0.5b (the full SigLIP tower) to step 3, then resumed to
     4 with --export_hf: the second run logs step 4 alone, checkpoints 3
     and 4, lora_adapters.npz holds every adapter and hf_export loads back
     through load_streamvln_checkpoint bit-equal in f32 to merge_lora of
     the final params (9a saves once and the resume runs at 0.5b because a
     7B checkpoint is 15.6 GiB and a one-card run may write 45 GiB to disk
     in all, phase 7's checkpoint included); 9c one LoRA optimizer step of
     streamvln_7b at S = 32768 under "auto" with the reference's 32k
     recipe (remat_chunk 7, mlp_chunk 2048, loss_chunk 1024) on
     tests/test_train_32k.py's layout: finite loss and grad norm, exact
     K1/K3/K4/K5 counts, seconds, valid tokens/s, peak memory; then K3's
     output against the port's chunked_attention in f32 and K4/K5's dQ,
     dK, dV at B=1, S=32768, 28/4 heads against their plain versions on
     the kernels' own LSE and Dsum and against chunked_attention's
     autograd (one query block at a time) moved by the Dsum source, at
     phase 4a's tolerances, the unmoved gap reported by range of rows;
     each timed beside chunked_attention and SDPA where it takes
     the shape. Every tower batch phase 9 sends K1 is checked as phase 2
     checks its batches;
 10. the LLM families (families): 10a the kernels at the families'
     shapes against their plain versions at phase 2's tolerances, timed
     by device time beside SDPA and their bounds: K2 and K3 at head dim
     256 (Gemma: 8 query heads on 1 KV head) at Sq 768 and 2560 on the
     4096-slot KV-major cache, K8 there at lengths 300, 1900, 2049 and
     4096, K2 and K8 at group sizes 1 (32/32 heads) and 5 (40/8), K8 and
     K2 at Sq 768 also on phase 2's settled yardstick beside SDPA; phase
     1 requires the head-dim-256 instances to spill no register, and
     phase 2 checks K6 and K7 at Qwen2-14B's int4 shapes; 10b each
     registry family at full width through eval_cli.build_agent (random
     bf16 weights from seed 0; qwen2-moe-a2.7b, gemma-2b, mpt-7b,
     llama3-8b, llama2-7b, mistral-7b, qwen2-14b also with --bits 4, and
     mixtral-8x7b at 8 of its 32 layers, FAMILY_DEPTH: its bf16 weights
     exceed the card): three agent calls (step 0, step 16, step 32 after
     the window reset, with <memory>), each call's last-position prefill
     logits under "auto" within cosine REF_MIN_COSINE of the same weights
     under "dense" (int4: dequantized), exact K2 counts (none for MPT's
     alibi, which takes dense attention as in the reference), K1 at every
     tower pass, K6/K7 under --bits 4; vision, prefill and decode ms, ms
     per decoded token, weight GiB and peak memory; gemma-2b (D = 256),
     llama2-7b (G = 1) and qwen2-14b (G = 5) also one call under
     decode_kernel (K8 once per layer per fed token, a decode step against
     dense); each family's agents freed and the
     card's memory back within FAMILY_MEMORY_SLACK; 10c every decode and
     verify replay bit-equal to the eager step (3g) on qwen2-moe-a2.7b and
     mpt-7b, and Qwen2-MoE's capacity dispatch at factor E/K against the
     dense dispatch (cosine, prefill ms of both); 10d one streamvln_7b
     call for each strided spatial_pool_mode (average, max) at 169 tokens
     a frame, against dense, and the native loader: where jpeglib.h (the
     libav headers) are on the host compiler's include path the JPEG
     (video) library must build, resize_batch_u8 within one 8-bit step of
     PIL on 480x640 frames and load_preprocess_jpegs timed per frame
     against PIL; its record lands in chip_smoke.json under "families";
 11. the vision tail and the offline tools (vision_tail): 11a K1 at the
     encoder zoo's and anyres's (B, S, H, D) (VIT_ZOO_SHAPES: head dims 88
     and 104 padded to 96 and 112, 64 at S2's 1, 4 and 9 crops, 72 at
     anyres's tile batches 3-5) against its plain version as phase 2 holds
     it, timed beside SDPA and its bound, with the padding's share of the
     products; 11b every tower of ZOO_TOWERS (CLIP-L-336 and its S2
     at 336/672/1008, MLCD-bigG-336, CLIP-bigG, EVA01-CLIP-g, EVA02-L-336,
     EVA02-B-16) at its published depth and width through
     build_vision_tower (random bf16 weights from seed 0), one frame under
     "auto" within cosine REF_MIN_COSINE of "dense" with K1 at every block
     and nothing else, ms per image, weight GiB and peak memory, each
     freed before the next with the card's memory back within
     ZOO_MEMORY_SLACK; convert_hf_clip_tower and convert_eva_tower round
     trips bit-equal on state dicts made on the card from CLIP-L's and
     EVA02-B's weights; the perceiver and qformer resamplers on [8, 729,
     1152] bf16 features against f32; 11c one streamvln_7b agent
     (build_agent) shared by everything after: generate_anyres on a
     480x640 and a 384x1152 image (first-step logits against dense, K1
     once per tower layer at the tile batch, K2 once per layer per
     generated token, ms per generated token), K2 at each image's
     uncached prefill length against its plain version and causal SDPA,
     offline.main (2 square videos, 2 anyres images), benchmark.main in
     process (2 tasks x 3 entries) and run_external_benchmark (a child at
     --model_size 0.5b on cuda); 11d dagger.main (2 fake-env episodes,
     data_iteration 1) and trajectory_generation.main (4 episodes), the
     annotation schema, the save gate's decision of every episode and
     episodes per minute; everything written under tempfile.gettempdir()
     and removed. Every K1 shape phase 11 sent must be one 11a or phase 2
     checked;
 12. the last modules (last_modules): 12a `train.main --model_size
     gemma-2b --lora_enable` in process at full depth (18 layers; K3 and
     K4/K5 at head dim 256), GEMMA_STEPS micro-steps with exact launches
     per micro-step, its checkpoint writes skipped, then on a fresh
     micro-batch the loss within GEMMA_LOSS_ATOL of attn_impl="chunked"
     and the LoRA gradients' 1 - cosine against chunked within
     GEMMA_GRAD_FLOOR_FACTOR times that of "dense" against chunked (two
     f32 attention paths); 12b an NCCL group of
     world size 1 from torchrun's variables (set here, through the
     command's init_distributed), two streamvln_7b LoRA steps through the
     mesh route (1, 1, 1), params as DTensors, against the same steps with
     no group (phase 4b's tolerances; bit-equality reported), and
     make_ring_attention against chunked_attention at S=4096, 28/4 heads;
     12c DPO (the policy's own base as the reference), the reward model
     and PPO on streamvln_7b with LoRA, PREF_STEPS steps each on
     ByteTokenizer pairs that share PREF_FRAMES 480x640 frames: finite
     metrics, DPO accuracy, ms per step, peak memory, K1-K5 launches by
     trainer; 12d DDPO with a small convolutional denoiser at SD's latent
     shape (B=8, 4x64x64): a 50-step rollout with log-probs and 3 steps;
     12e SDPA again at the two shapes whose library time PR 14's table
     marks not valid, five device-time captures and one event time each;
 13. print the kernels JSON line (K1-K8; each with bound_share = bound_ms
     / ms and vs_library = ms / library_ms; K1, K2 with their phase-8
     launches, K3-K5 and K7 with the QLoRA step's, K1 and K3-K5 with phase
     9's and K3-K5 at S=32768 under "long_context", every kernel with
     phase 10's launches by family and K3 at head dim 256, K1 and K2 with
     phase 11's by sub-phase and their shapes, K3-K5 with phase 12's by
     trainer and K4/K5's head-dim-256 instance as records of their own),
     the card line, and the result line.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import statistics
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
# the settled kernel yardstick (graph_ms): replays of one captured rotation
# between two CUDA events, readings of which the median ranks, and the
# calls captured where a rotation has one operand set (K2)
GRAPH_REPLAYS, GRAPH_RUNS, GRAPH_CALLS = 20, 5, 10
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
# phase 9a: synthetic trajectories for the training command, their lengths
# (actions) drawn per episode: windows at an episode's start carry no
# <memory> frames and an episode's last window is short, so the tower's
# batch (2 windows x the longer window's frames) varies
TRAIN_CLI_EPISODES, TRAIN_CLI_LENGTHS = 6, (40, 97)
# phase 9c: the reference's 7B recipe at its training length
# (streamvln_tpu/train.py:73-76), and the kernels held against
# chunked_attention at that length: valid tokens, and the query block of
# the reference's blocked autograd
LONG_S = 32768
LONG_RECIPE = {"remat_chunk": 7, "mlp_chunk": 2048, "loss_chunk_size": 1024}
LONG_VALID, LONG_Q_BLOCK = 32000, 2048
# phase 9c reports the kernels' gap to chunked_attention by range of rows:
# rows that see 1, 2-7, 8-63, ... keys, and the padding
LONG_ROW_RANGES = (0, 1, 2, 8, 64, 512, 4096, LONG_VALID, LONG_S)
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


def replay_equals_eager(torch, fn, eager) -> bool:
    """`fn` captured into a CUDA graph and replayed twice (its outputs
    zeroed before each replay): every output bit-equal to `eager`, the
    same call run eagerly, each time."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = fn()
    outs = outs if isinstance(outs, tuple) else (outs,)
    eager = eager if isinstance(eager, tuple) else (eager,)
    ok = True
    for _ in range(2):
        for x in outs:
            x.zero_()
        graph.replay()
        torch.cuda.synchronize()
        ok = ok and all(torch.equal(x, y) for x, y in zip(outs, eager))
    graph.reset()
    return ok


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


def graph_ms(torch, fns, bound_ms, what, replays=GRAPH_REPLAYS,
             runs=GRAPH_RUNS, attempts=3, stream=None) -> dict:
    """Per-call device time of a rotation of `fns` on the settled
    yardstick: the rotation (each call once, in order) captured into one
    CUDA graph, replayed `replays` times between two CUDA events, `runs`
    such readings; the median with min and max. Nothing is dropped as a
    profiler window can drop kernels, and the host's launch cost is out.
    A reading below `bound_ms` cannot be a measurement of the work: the
    set is logged as refused and taken again, up to `attempts` times, and
    after that not recorded (ms None). `stream`: the stream to capture on
    (where an autograd backward is captured, the stream its forward ran
    on, so that its kernels go to the capture)."""
    for f in fns:
        f()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for f in fns:
            f()
    refused = []
    try:
        for _ in range(attempts):
            graph.replay()
            torch.cuda.synchronize()
            vals = []
            for _ in range(runs):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(replays):
                    graph.replay()
                end.record()
                end.synchronize()
                vals.append(start.elapsed_time(end) / (replays * len(fns)))
            if min(vals) >= bound_ms:
                return {"ms": statistics.median(vals), "min": min(vals),
                        "max": max(vals), "refused": refused}
            refused.append(vals)
            log(f"  {what}: graph-timed readings {vals} below the bound "
                f"{bound_ms:.4f} ms: refused")
    finally:
        graph.reset()
    return {"ms": None, "min": None, "max": None, "refused": refused}


def graph_text(g: dict) -> str:
    if g["ms"] is None:
        return f"refused ({len(g['refused'])} sets below the bound)"
    return f"{g['ms']:.4f} ms ({g['min']:.4f}-{g['max']:.4f})"


def graph_pair(torch, kfns, lfns, bound_ms, what) -> tuple:
    """A kernel's rotation `kfns` and, where one exists, the library's
    `lfns` on the settled yardstick (graph_ms): the record's fields
    (graph_*, library_graph_*) and the log's text."""
    kg = graph_ms(torch, kfns, bound_ms, what)
    rec = {"graph_ms": kg["ms"], "graph_min": kg["min"],
           "graph_max": kg["max"], "graph_refused": kg["refused"]}
    text = f"graph-timed {graph_text(kg)}"
    if lfns is not None:
        lg = graph_ms(torch, lfns, bound_ms, f"library at {what}")
        rec.update(library_graph_ms=lg["ms"], library_graph_min=lg["min"],
                   library_graph_max=lg["max"],
                   library_graph_refused=lg["refused"])
        text += f", library {graph_text(lg)}"
    return rec, text


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


def check_vit(torch, F, va, B, rng_seed=0, S=729, H=16, D=72):
    """K1 against its plain version at the SigLIP shape (or the given S, H,
    D), batch B; a second call bit-equal. Times: the kernel and SDPA on
    the settled yardstick (graph_ms over a rotation of operand copies past
    the L2 cache; it ranks them), the kernel's device time (torch.profiler;
    at batch 1 the wrapper's host cost exceeds it, so an event time would
    measure the host), its event time and host cost per call, SDPA's
    device and event time. The bound counts the unpadded products;
    padding_share is the share of the kernel's products spent on the head
    dim's padding."""
    g = torch.Generator(device="cuda").manual_seed(rng_seed)
    q, k, v = (torch.randn((B, S, H, D), generator=g, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    out = va.vit_attention(q, k, v)
    again = va.vit_attention(q, k, v)
    torch.cuda.synchronize()
    bit_equal = torch.equal(out, again)
    del again
    # every query sees all S keys: below FEW_KEYS the rounding of P does
    # not average out (KERNEL_ATOL's note)
    few = S < FEW_KEYS
    c = compare(out, va.vit_attention_plain(q, k, v), 2.0 ** -8
                * va.vit_attention_plain(q, k, v.abs()).float()
                if few else None)
    c["queries_seeing_few_keys"] = B * S if few else 0

    def kernel():
        return va.vit_attention(q, k, v)
    per_call = launches_per_call(torch, kernel)
    replays_ok = replay_equals_eager(torch, kernel, out)
    ms, event_ms, h_us = device_ms(torch, [kernel]), time_ms(torch, kernel), \
        host_us(torch, kernel)
    plain = time_ms(torch, lambda: va.vit_attention_plain(q, k, v), iters=3)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt)
    lib, lib_event = device_ms(torch, [sdpa]), time_ms(torch, sdpa)
    b_ms, b_by = bound(4.0 * S * S * D * H * B, 4.0 * B * S * H * D * 2)
    shape = f"B={B} S={S} H={H} D={D} bf16"
    n = _copies(4 * B * S * H * D * 2)
    ops = [(q, k, v)] + [tuple(x.clone() for x in (q, k, v))
                         for _ in range(n - 1)]
    lops = [(qt, kt, vt)] + [tuple(x.transpose(1, 2).contiguous()
                                   for x in o) for o in ops[1:]]
    graphs, graph_line = graph_pair(
        torch, [(lambda o=o: va.vit_attention(*o)) for o in ops],
        [(lambda o=o: F.scaled_dot_product_attention(*o)) for o in lops],
        b_ms, f"K1 at {shape}")
    del ops, lops
    rec = {"shape": shape, "batch": B,
           "key": [B, S, H, D], "padded_head_dim": padded_head_dim(D),
           "padding_share": 1.0 - D / padded_head_dim(D), **c,
           "bit_equal": bit_equal, "enqueued": per_call,
           "graph_replays_equal_eager": replays_ok, "ms": ms,
           "event_ms": event_ms, "host_us": h_us, "plain_ms": plain,
           "library_ms": lib, "library_event_ms": lib_event,
           "bound_ms": b_ms, "bound_by": b_by, **graphs, "rotation": n}
    log(f"K1 vit_attention {rec['shape']}: {tol_text(c)} bit-equal "
        f"{bit_equal}, enqueues {per_call} per call, graph replays equal "
        f"eager {replays_ok}; {graph_line} ({n} copies); kernel {ms:.4f} "
        f"ms device "
        f"({event_ms:.4f} event-timed, {h_us:.1f} us host per call) plain "
        f"{plain:.4f} ms sdpa {lib:.4f} ms device ({lib_event:.4f} "
        f"event-timed) bound {b_ms:.4f} ms ({b_by})")
    require(f"vit_attention at {shape}", agrees=c["tol_share"] <= 1.0,
            deterministic=bit_equal, one_launch=per_call == ["kernel"],
            graph_replays_equal_eager=replays_ok)
    return rec


def check_flash(torch, F, fa, Sq, offsets=(300,), cap=4096, seed=1,
                Hq=28, Hkv=4, D=128, lse=False, graph=False, live=False):
    """K2 against its plain version: a prefill of Sq queries into a
    cap-slot KV-head-major cache, one batch row per entry of `offsets`
    (row b's queries at positions offsets[b] .. offsets[b] + Sq - 1); query
    7 of row 0 sees no key (q_pos -1). Several rows are a batched worker's
    wave: rows at different offsets, an idle row whose queries all see no
    key (the last) and a row whose keys from slot 1000 on are INVALID_POS
    (the one before it). Heads and head dim default to Qwen2-7B's; with
    `lse` it is K3 (the same forward with the row logsumexp), its output
    held as K2's and its LSE within LSE_ATOL + LSE_RTOL * |ref|; a second
    call bit-equal, one kernel enqueued per call, and replays of a
    captured CUDA graph bit-equal to the eager call. With `graph`, the
    kernel and SDPA also on the settled yardstick (graph_ms over
    GRAPH_CALLS calls). With `live`, the cache is cut to the slots some
    query sees (the same output: the kernel skips the rest), so the gap
    to the whole cache is the cost of the key tiles it does not visit."""
    B = len(offsets)
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
    if live:
        cap = min(int(q_pos.max().item()) + 1, cap)
        k, v = k[:, :, :cap], v[:, :, :cap]
        k_pos = k_pos[:, :cap].contiguous()
    kfn = fa.flash_attention_lse if lse else fa.flash_attention

    def kernel():
        return kfn(q, k, v, q_pos, k_pos, kv_major=True)
    first, again = kernel(), kernel()
    torch.cuda.synchronize()
    first = first if lse else (first,)
    again = again if lse else (again,)
    bit_equal = all(torch.equal(x, y) for x, y in zip(first, again))
    del again
    per_call = launches_per_call(torch, kernel)
    replays_ok = replay_equals_eager(torch, kernel,
                                     first if lse else first[0])
    if lse:
        out, out_lse = first
        torch.cuda.synchronize()
        ref, ref_lse = fa.flash_attention_lse_plain(q, k, v, q_pos, k_pos,
                                                    kv_major=True)
        seen_any = ref_lse != fa.NEG_INF
        lse_err = (out_lse - ref_lse).abs()[seen_any]
        lse_share = (lse_err / (LSE_ATOL + LSE_RTOL * ref_lse.abs()[seen_any])
                     ).max().item()
        if not torch.equal(out_lse == fa.NEG_INF, ~seen_any):
            raise AssertionError("flash_attention_lse: rows with no visible "
                                 "key disagree")
        del out_lse, ref_lse
    else:
        out = first[0]
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
    if lse:
        c["lse_tol_share"] = lse_share
    del term, first
    pfn = fa.flash_attention_lse_plain if lse else fa.flash_attention_plain
    ms, event_ms, h_us = device_ms(torch, [kernel]), time_ms(torch, kernel), \
        host_us(torch, kernel)
    plain = time_ms(torch, lambda: pfn(q, k, v, q_pos, k_pos, kv_major=True),
                    iters=3)
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
        + 4 * (B * Sq + B * cap) + (4 * B * Hq * Sq if lse else 0)
    b_ms, b_by = bound(4.0 * pairs * D * Hq, nbytes)
    rows = f"B={B} offsets={list(offsets)} " if B > 1 else \
        f"offset={offsets[0]} "
    rec = {"shape": f"Sq={Sq} Hq={Hq} Hkv={Hkv} D={D} kv_major "
                    f"cache={cap} {rows}bf16", "batch": B,
           **c, "bit_equal": bit_equal, "enqueued": per_call,
           "graph_replays_equal_eager": replays_ok,
           "ms": ms, "event_ms": event_ms, "host_us": h_us,
           "plain_ms": plain, "library_ms": lib,
           "library_event_ms": lib_event, "bound_ms": b_ms, "bound_by": b_by}
    what = "K3 flash_attention_lse" if lse else "K2 flash_attention"
    graph_line = ""
    if graph:
        graphs, text = graph_pair(torch, [kernel] * GRAPH_CALLS,
                                  [sdpa] * GRAPH_CALLS, b_ms,
                                  f"{what} {rec['shape']}")
        rec.update(graphs)
        graph_line = f" {text};"
    lse_text = f", LSE {c['lse_tol_share']:.3f} of {LSE_ATOL} + " \
        f"{LSE_RTOL}*|ref|" if lse else ""
    log(f"{what} {rec['shape']}: {tol_text(c)}{lse_text}; bit-equal "
        f"{bit_equal}, enqueues {per_call} per call, graph replays equal "
        f"eager {replays_ok};{graph_line} kernel "
        f"{ms:.4f} ms device ({event_ms:.4f} event-timed, {h_us:.1f} us "
        f"host per call) plain {plain:.4f} ms sdpa {lib:.4f} ms device "
        f"({lib_event:.4f} event-timed) bound {b_ms:.4f} ms ({b_by})")
    require(f"{what} at {rec['shape']}", agrees=c["tol_share"] <= 1.0
            and c.get("lse_tol_share", 0.0) <= 1.0, deterministic=bit_equal,
            one_launch=per_call == ["kernel"],
            graph_replays_equal_eager=replays_ok)
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
               ("gu", 3584, 37888, 7), ("down", 18944, 3584, 7),
               # Qwen2-14B --bits 4 (phase 10b) at one row; its prefill's
               # K7 launches at the same (din, dout) are checked with them
               ("qkv 14b", 5120, 7168, 1), ("o 14b", 5120, 5120, 1),
               ("gu 14b", 5120, 27648, 1), ("down 14b", 13824, 5120, 1),
               ("lm_head 14b", 5120, 152064, 1))
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
    CUDA graph's nodes). K7: check_dequant."""
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
        mfns = [(lambda c=c: torch.mm(xs, c)) for _, _, c in ops]
        mm_ms = device_ms(torch, mfns)
        nbytes = half * dout + (din // 64) * dout * 4 + M * din * 2 \
            + M * dout * 4
        b_ms, b_by = bound(2.0 * M * din * dout, nbytes)
        what = f"K6 {name} M={M} din={din} dout={dout}"
        try:
            packs = [int4pack_yardstick(torch, i4, a, b) for a, b, _ in ops]
            lfns = [(lambda f=f: f(x)) for f in packs]
            pack_ms = device_ms(torch, lfns)
            pack_err = ((packs[0](x).float() - ref).abs().max()
                        / ref.abs().max()).item()
            pack_note = None
            graphs, graph_line = graph_pair(torch, kfns, lfns, b_ms, what)
            del packs, lfns
        except (AttributeError, RuntimeError) as e:
            pack_ms = pack_err = None
            pack_note = f"torch._weight_int4pack_mm unavailable: {e}"[:200]
            graphs, graph_line = graph_pair(torch, kfns, mfns, b_ms, what)
        del mfns
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
               "rotation": n, **graphs}
        log(f"K6 int4_matmul {rec['shape']}: max_abs_err "
            f"{rec['max_abs_err']:.3e} ({share:.3f} of 1e-5*sum|xw| + 1e-6) "
            f"bit-equal {bit_equal}, enqueues {per_call} per call; "
            f"{graph_line} ({rec['library']}); kernel "
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
    """K7 against its plain version: bit-equal in bf16 and in f32, a
    second call bit-equal, one kernel and nothing else enqueued per call
    (a captured CUDA graph's nodes). Timed in bf16 on the settled
    yardstick beside the card's practical stream rate: `dst.copy_(src)` of
    two bf16 buffers of K7's output size, graph-timed over sources past
    2.5x the L2 cache into one destination, as K7 writes one output
    (copy_ms: a ceiling for a stream on this card, not a library call for
    the function, so library_ms stays None); the GB/s of each."""
    _, half, dout = wp.shape
    checks = {}
    for dt in (torch.bfloat16, torch.float32):
        out = i4.int4_dequant_split(wp, s, 0, dt)
        again = i4.int4_dequant_split(wp, s, 0, dt)
        torch.cuda.synchronize()
        ref = i4.int4_dequant_split_plain(wp, s, 0, dt)
        checks[dt] = (torch.equal(out, ref), torch.equal(out, again),
                      (out.float() - ref.float()).abs().max().item())
        del out, again, ref
    equal, again_equal, err = checks[torch.bfloat16]
    f32_equal, f32_again, _ = checks[torch.float32]
    per_call = launches_per_call(
        torch, lambda: i4.int4_dequant_split(wp, s, 0, torch.bfloat16))
    n = _copies(wp.numel() * 5)
    ops = [(wp, s)] + [(wp.clone(), s.clone()) for _ in range(n - 1)]
    kfns = [(lambda a=a, b=b: i4.int4_dequant_split(a, b, 0, torch.bfloat16))
            for a, b in ops]
    ms, event_ms = device_ms(torch, kfns), time_cold_ms(torch, kfns)
    plain = time_ms(torch, lambda: i4.int4_dequant_split_plain(
        wp, s, 0, torch.bfloat16), iters=3, warmup=1)
    nbytes = half * dout + (2 * half // 64) * dout * 4 + 2 * half * dout * 2
    b_ms, b_by = bound(0.0, nbytes)
    shape = f"{name} din={2 * half} dout={dout} -> bf16 [2, {half}, {dout}]"
    graphs, graph_line = graph_pair(torch, kfns, None, b_ms, f"K7 {shape}")
    del ops, kfns
    out_elems = 2 * half * dout
    m = _copies(2 * 2 * out_elems)
    srcs = [torch.empty(out_elems, dtype=torch.bfloat16, device="cuda")
            .normal_() for _ in range(m)]
    dst = torch.empty_like(srcs[0])
    copy = graph_ms(torch, [(lambda a=a: dst.copy_(a)) for a in srcs],
                    bound(0.0, 2 * 2 * out_elems)[0], f"copy at K7 {shape}")
    del srcs, dst

    def gbps(nb, t):
        return nb / t / 1e6 if t else None
    k7_gbps, copy_gbps = gbps(nbytes, graphs["graph_ms"]), \
        gbps(2 * 2 * out_elems, copy["ms"])
    rec = {"shape": shape, "key": [2 * half, dout, "bfloat16"],
           "f32_key": [2 * half, dout, "float32"],
           "max_abs_err": err, "bit_equal": equal,
           "second_call_bit_equal": again_equal, "f32_bit_equal": f32_equal,
           "f32_second_call_bit_equal": f32_again,
           "kernels_per_call": len(per_call), "enqueued": per_call,
           "ms": ms, "event_ms": event_ms, "plain_ms": plain,
           "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
           "bytes": nbytes, "rotation": n, **graphs,
           "copy_ms": copy["ms"], "copy_min": copy["min"],
           "copy_max": copy["max"], "copy_refused": copy["refused"],
           "copy_rotation": m, "graph_gbps": k7_gbps,
           "copy_gbps": copy_gbps,
           "share_of_copy": k7_gbps / copy_gbps if k7_gbps and copy_gbps
           else None}
    log(f"K7 int4_dequant_split {rec['shape']}: bit-equal {equal} (f32 "
        f"{f32_equal}), second call {again_equal} (f32 {f32_again}), "
        f"enqueues {per_call} per call; {graph_line} = {k7_gbps} GB/s; "
        f"copy of the output's size {graph_text(copy)} = {copy_gbps} GB/s; "
        f"kernel {ms:.4f} ms device ({event_ms:.4f} ms event-timed) plain "
        f"{plain:.4f} ms bound {b_ms:.4f} ms ({b_by})")
    require(f"int4_dequant_split at {rec['shape']}", bit_equal=equal,
            f32_bit_equal=f32_equal, deterministic=again_equal and f32_again,
            one_launch=per_call == ["kernel"])
    return rec


def check_decode(torch, F, da, lengths=(300, 1900, 4096, 2049), L=28,
                 cap=4096, seed=7, Hq=28, Hkv=4, D=128):
    """K8 against its plain version run in f32 on the same (upcast) inputs,
    at an L-layer bf16 cache's shapes (heads and head dim Qwen2-7B's by
    default): |err| <= 2^-8 |ref| + 1e-5 (the kernel's one bf16 output
    rounding, half an ulp, plus f32 summation order); a second call
    bit-equal; one kernel per call. Timed over the L layers in turn by
    device time (torch.profiler) beside SDPA on the live prefix
    (enable_gqa), and both on the settled yardstick (graph_ms, which ranks
    them); with the launch plan (the blocks of the cluster of each KV head,
    the instance's blocks per SM and the resident clusters of that size, as
    the card reports them)."""
    B = 1
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((L, B, 1, Hq, D), generator=g, device="cuda") \
        .to(torch.bfloat16)
    k, v = (torch.randn((L, B, Hkv, cap, D), generator=g, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    plan = da.plan(B, Hq, Hkv, cap, D)
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
        nbytes = 2 * B * Hkv * n * D * 2 + 2 * B * Hq * D * 2 + 4 * B
        b_ms, b_by = bound(4.0 * B * Hq * n * D, nbytes)
        kfns = [(lambda i=i: da.decode_attention(q[i], k[i], v[i], lens))
                for i in range(L)]
        ms, event_ms = device_ms(torch, kfns, 2 * L), \
            time_cold_ms(torch, kfns, iters=2 * L)
        h_us, per_call = host_us(torch, kfns[0]), launches_per_call(
            torch, kfns[0])
        plain = time_ms(torch, lambda: da.decode_attention_plain(
            q[0], k[0], v[0], lens), iters=3, warmup=1)
        qt = [q[i].transpose(1, 2) for i in range(L)]
        lfns = [(lambda i=i: F.scaled_dot_product_attention(
            qt[i], k[i][:, :, :n], v[i][:, :, :n], enable_gqa=True))
            for i in range(L)]
        lib = device_ms(torch, lfns, 2 * L)
        graphs, graph_line = graph_pair(
            torch, kfns, lfns, b_ms, f"K8 Hq={Hq} Hkv={Hkv} D={D} length={n}")
        rec = {"shape": f"B={B} Hq={Hq} Hkv={Hkv} D={D} length={n} "
                        f"cache={cap} bf16", "max_abs_err": err.max().item(),
               "tol_share": share, "bit_equal": bit_equal, "ms": ms,
               "event_ms": event_ms, "host_us": h_us,
               "kernels_per_call": len(per_call), "enqueued": per_call,
               "plain_ms": plain, "library_ms": lib, "bound_ms": b_ms,
               "bound_by": b_by, "bytes": nbytes, "plan": plan, **graphs}
        log(f"K8 decode_attention {rec['shape']}: max_abs_err "
            f"{rec['max_abs_err']:.3e} ({share:.3f} of 2^-8|ref| + 1e-5) "
            f"bit-equal {bit_equal}, enqueues {per_call} per call; plan "
            f"{plan}; kernel {graph_line} (SDPA); kernel {ms:.4f} ms "
            f"device ({event_ms:.4f} "
            f"ms event-timed, {h_us:.1f} us host per call) plain "
            f"{plain:.4f} ms sdpa {lib:.4f} ms device; bound {b_ms:.4f} ms "
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
                           Hq=28, Hkv=4, D=128, seed=3, graph=False):
    """Phase 4a: K3, K4 and K5 against their plain versions on the same
    inputs at the train step's attention shape, each timed beside its
    plain version and causal SDPA over the n_valid valid rows (forward for
    K3; its backward, which computes dQ, dK and dV in one call, for K4 and
    K5: the same causal work without the padding). With `graph`, K3 also on
    the settled yardstick (graph_ms over GRAPH_CALLS calls) beside causal
    SDPA over the n_valid valid rows (the same causal work without the
    padding)."""
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
    # yardstick: causal SDPA over the n_valid valid rows ([B, H, n, D]),
    # forward alone and its backward under autograd; the faster of GQA
    # without copies (enable_gqa) and K/V repeated per query head
    mask = (k_pos[:, None, :] <= q_pos[:, :, None])[:, None]
    dot = dout[:, :n_valid].transpose(1, 2).contiguous()
    lib = {}
    for variant in ("enable_gqa", "repeated"):
        kt, vt = (x[:, :n_valid].transpose(1, 2) for x in (k, v))
        if variant == "repeated":
            kt, vt = (x.repeat_interleave(Hq // Hkv, dim=1)
                      for x in (kt, vt))
        qt, kt, vt = (x.contiguous().requires_grad_()
                      for x in (q[:, :n_valid].transpose(1, 2), kt, vt))

        def sdpa():
            return F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True,
                enable_gqa=variant == "enable_gqa")
        with torch.no_grad():
            fwd = time_ms(torch, sdpa)
        o = sdpa()
        bwd = time_ms(torch, lambda: torch.autograd.grad(
            o, (qt, kt, vt), dot, retain_graph=True))
        lib[variant] = (fwd, bwd)
        del o, qt, kt, vt
    log(f"4a causal SDPA over the {n_valid} valid rows (fwd ms, bwd ms): "
        f"{lib}")
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
                      "library": "causal F.scaled_dot_product_attention "
                                 f"over the {n_valid} valid rows, "
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
    # blocks per (64-key tile, batch x KV head) pair: the head split
    recs["flash_bwd_dkv"]["head_splits"] = fa.dkv_splits(B, S, Hq, Hkv, D)
    if graph:
        r = recs["flash_attention_lse"]
        qv, kv, vv = (x[:, :n_valid].transpose(1, 2).contiguous()
                      for x in (q, k, v))
        graphs, text = graph_pair(
            torch, [lambda: fa.flash_attention_lse(q, k, v, q_pos, k_pos)]
            * GRAPH_CALLS, [lambda: F.scaled_dot_product_attention(
                qv, kv, vv, is_causal=True, enable_gqa=True)] * GRAPH_CALLS,
            r["bound_ms"], f"K3 at {shape}")
        r.update(graphs, library_graph=f"causal F.scaled_dot_product_"
                 f"attention over the {n_valid} valid rows")
        log(f"4a flash_attention_lse {shape}: {text} (library: causal SDPA "
            f"over the {n_valid} valid rows)")
        del qv, kv, vv
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
                    what="3g", n_steps=33):
    """Phase 3g: each serving variant over steps 0..n_steps-1 (33: 9 calls
    across the window reset and its <memory> call), every decode forward
    checked:
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
            for step in range(n_steps):
                agent.step(0, frames[step], instruction,
                           run_model=step % cfg.num_future_steps == 0)
            out[name] = {"replays": box["replays"] - r0,
                         "decode_forwards": eng.decode_forwards - f0,
                         "differing_replays": box["differ"][d0:]}
            log(f"{what} {name}: {out[name]['replays']} replays for "
                f"{out[name]['decode_forwards']} decode forwards over "
                f"{-(-n_steps // cfg.num_future_steps)} calls, "
                f"{len(out[name]['differing_replays'])} differing from the "
                f"eager step")
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


def write_trajectories(np, root, n, seed=0, hw=(480, 640)):
    """`n` synthetic episodes in the trajectory format (the port's
    write_trajectory / write_annotations): lengths drawn from
    TRAIN_CLI_LENGTHS, random uint8 frames of `hw`, one instruction each.
    Returns the frames written."""
    from streamvln_tpu_torch.data.vln_dataset import (write_annotations,
                                                      write_trajectory)
    rng = np.random.default_rng(seed)
    rooms = ("kitchen", "bedroom", "hallway", "stairs", "sofa", "bathroom")
    entries, frames = [], 0
    for ep in range(n):
        length = int(rng.integers(*TRAIN_CLI_LENGTHS))
        a, b = rng.choice(len(rooms), 2, replace=False)
        entries.append(write_trajectory(
            root, f"ep{ep}", rng.integers(0, 256, (length, *hw, 3), np.uint8),
            [f"walk past the {rooms[a]} and stop at the {rooms[b]} door"],
            rng.integers(1, 4, length).tolist()))
        frames += length
    write_annotations(root, entries)
    return frames


def state_bytes(state) -> int:
    from streamvln_tpu_torch.utils.checkpoint import _state_tree
    return sum(t.numel() * t.element_size()
               for _, t in tree_leaves(_state_tree(state))
               if hasattr(t, "numel"))


def dir_bytes(path) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def kernel_counts(va, fa) -> dict:
    return {"vit_attention": va.launches, "flash_attention": fa.launches,
            "flash_attention_lse": fa.lse_launches,
            "flash_bwd_dq": fa.dq_launches, "flash_bwd_dkv": fa.dkv_launches}


def count_diff(after: dict, before: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after
            if after[k] != before.get(k, 0)}


@contextlib.contextmanager
def step_probe(torch, va, fa, box, metrics_path, profile_at=None):
    """While open, the step function train.main builds
    (parallel.train.make_train_step) is wrapped, and nothing else of the
    command: per micro-step the wrapper records when its call started
    (time.time, the clock of the "ts" that MetricsLogger writes to
    `metrics_path` after each step's log line), the kernels' launch counts
    and K1's launches by batch before and after the call (host counters:
    no synchronization), the allocated device memory at the start, the
    tower batch and bucket, and the valid tokens as a device sum read after
    the run. Micro-step number `profile_at` (from 0) runs under
    torch.profiler, its idle share against the median wall of the earlier
    micro-steps, read from `metrics_path`."""
    from streamvln_tpu_torch.parallel import train as train_lib
    make = train_lib.make_train_step
    box["micro"] = []

    def make_train_step(cfg, tcfg, device="cuda", mesh=None):
        step = make(cfg, tcfg, device, mesh=mesh)

        def probed(state, batch):
            m = {"t_start": time.time(), "before": kernel_counts(va, fa),
                 "vit_before": dict(va.launches_by_batch),
                 "memory_at_start": torch.cuda.memory_allocated(),
                 "profiled": len(box["micro"]) == profile_at}
            if m["profiled"]:
                walls = [(r["ts"] - x["t_start"]) * 1e3 for r, x in
                         zip(step_lines(read_log(metrics_path)), box["micro"])]
                out = {}
                box["profile"] = profile_call(
                    torch, lambda: out.setdefault("r", step(state, batch)),
                    statistics.median(walls[1:] or walls))
                res = out["r"]
            else:
                res = step(state, batch)
            B, V = batch["images"].shape[:2]
            m.update(after=kernel_counts(va, fa),
                     vit_after=dict(va.launches_by_batch), tower_batch=B * V,
                     bucket=int(batch["valid"].shape[1]),
                     tokens=int(batch["valid"].numel()),
                     valid=batch["valid"].sum())
            box["micro"].append(m)
            return res
        return probed
    train_lib.make_train_step = make_train_step
    try:
        yield box
    finally:
        train_lib.make_train_step = make


def step_lines(lines) -> list:
    return [r for r in lines if "loss" in r]


def read_log(path) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f]


def train_command(torch, np, va, fa, reset, tmp, model_size="7b",
                  device="cuda"):
    """Phase 9a: `train.main` in process at full width on synthetic
    trajectories (480x640 JPEG frames): a LoRA run of 6 micro-steps (2
    windows a micro-batch, 2 micro-batches an optimizer step), the
    mid-training evaluation at step 4 and one checkpoint, of step 6 (the
    loop's save; the final save of the same step is skipped). One save:
    a 7B checkpoint holds the whole state (15.6 GiB), and a one-card run
    may write 45 GiB to disk in all, phase 7's 15 GiB checkpoint included;
    the resume runs in 9b at 0.5b. Checks the log lines, the metrics.jsonl
    mirror, the eval line, exact launches per micro-step and per tower pass
    and prefill of the evaluation, frozen weights bit-equal to the initial
    ones, every adapter moved, the checkpoint restored bit-equal to the
    final state, and a direct call of the evaluation hook on the final
    params returning the memory it took. The numbers come from what the
    command writes (the "ts" of metrics.jsonl) and the step_probe."""
    from streamvln_tpu_torch import train
    from streamvln_tpu_torch.configs import build_config
    from streamvln_tpu_torch import weights
    from streamvln_tpu_torch.data.tokenizer import load_tokenizer
    from streamvln_tpu_torch.eval.hook import MidTrainingEvaluator
    from streamvln_tpu_torch.models import lora as lora_lib
    from streamvln_tpu_torch.utils import checkpoint
    import argparse

    rec = {}
    traj, out = os.path.join(tmp, "traj"), os.path.join(tmp, "run")
    os.makedirs(traj)
    t0 = time.perf_counter()
    n_frames = write_trajectories(np, traj, TRAIN_CLI_EPISODES)
    rec["trajectory_frames"] = n_frames
    rec["trajectory_bytes"] = dir_bytes(traj)
    log(f"9a: {TRAIN_CLI_EPISODES} episodes, {n_frames} frames of 480x640 "
        f"({rec['trajectory_bytes'] / 2**20:.1f} MiB of JPEG) written in "
        f"{time.perf_counter() - t0:.2f} s")
    cfg = build_config(argparse.Namespace(
        model_size=model_size, spatial_pool_mode="bilinear", num_frames=32,
        num_future_steps=4, num_history=8))
    argv = ["--video_folders", traj, "--output_dir", out,
            "--model_size", model_size, "--lora_enable", "--lora_r", "16",
            "--batch_size", "2", "--grad_accum_steps", "2",
            "--num_steps", "6", "--save_steps", "6", "--log_steps", "1",
            "--eval_steps", "4", "--eval_episodes", "1",
            "--prefetch_depth", "2", "--device", device]
    ckpt_dir = os.path.join(out, "ckpt")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    box = {}
    t0 = time.perf_counter()
    with step_probe(torch, va, fa, box, os.path.join(out, "metrics.jsonl"),
                    profile_at=2):
        state = train.main(argv)
    t_end = time.time()
    rec["seconds"] = time.perf_counter() - t0
    rec["final_step"] = state.step
    rec["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    rec["latest_step"] = checkpoint.latest_step(ckpt_dir)
    rec["checkpoints"] = sorted(os.listdir(ckpt_dir))
    micro = box["micro"]
    for m in micro:
        m["valid_tokens"] = int(m.pop("valid").item())
    log(f"9a run: {rec['seconds']:.1f} s, peak "
        f"{rec['peak_memory_bytes'] / 2**30:.2f} GiB, ends at step "
        f"{state.step}, checkpoints {rec['checkpoints']}")

    # frozen leaves as built (the command's init made again from its seeds,
    # on the same device: the same bits), adapters moved, the checkpoint
    # restored bit-equal into fresh tensors; the LoRA group (adapters and
    # lora_scale, lora.is_lora_path, as the reference labels it) trains
    leaves = dict(tree_leaves(state.params))
    built = dict(tree_leaves(lora_lib.add_lora(
        weights.init(cfg, torch.Generator(device=device).manual_seed(0),
                     device=device, dtype=leaves["/vision/patch_w"].dtype),
        torch.Generator(device=device).manual_seed(1), rank=16)))
    frozen_ok = all(torch.equal(leaves[p], t) for p, t in built.items()
                    if not lora_lib.is_lora_path(p))
    b_moved = [p for p, t in leaves.items()
               if p.endswith("_lora_b") and bool(t.abs().sum() > 0)]
    a_moved = [p for p, t in built.items()
               if p.endswith("_lora_a") and not torch.equal(leaves[p], t)]
    del built
    gc.collect()
    torch.cuda.empty_cache()
    target = type(state)(*tree_map(
        lambda x: torch.empty_like(x) if isinstance(x, torch.Tensor)
        else x, list(state)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored = checkpoint.restore_checkpoint(ckpt_dir, target, 6)
    torch.cuda.synchronize()
    rec["restore_s"] = time.perf_counter() - t0
    a = list(tree_leaves(checkpoint._state_tree(state)))
    b = list(tree_leaves(checkpoint._state_tree(restored)))
    same = [(p, torch.equal(x, y) if isinstance(x, torch.Tensor)
             else x == y) for (p, x), (q, y) in zip(a, b)]
    rec["restore_bit_equal"] = all(ok for _, ok in same) and \
        len(same) == len(a) == len(b)
    rec["restored_leaves"] = len(same)
    n_lora = sum(p.endswith("_lora_b") for p in leaves)
    log(f"9a after step 6: base leaves bit-equal to the initial weights "
        f"{frozen_ok}; adapter stacks moved: B {len(b_moved)} of "
        f"{n_lora} (A {len(a_moved)}); latest_step {rec['latest_step']}; "
        f"the step-6 checkpoint restored in {rec['restore_s']:.2f} s, "
        f"{len(same)} leaves bit-equal to the final state "
        f"{rec['restore_bit_equal']} (accumulator, moments, counts and "
        f"micro-step included)")
    del target, restored, leaves, a, b, same
    gc.collect()
    torch.cuda.empty_cache()

    # the hook once more, on the final params: the memory it takes comes back
    args = train.build_argparser().parse_args(argv)
    hook = MidTrainingEvaluator(
        cfg, load_tokenizer(args.model_path, args.model_max_length),
        n_episodes=args.eval_episodes, seed=args.seed)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    c0 = kernel_counts(va, fa)
    hook.evaluate(state.params, 6)
    torch.cuda.synchronize()
    rec["hook_memory"] = {"before": before,
                          "after": torch.cuda.memory_allocated(),
                          "launches": count_diff(kernel_counts(va, fa), c0)}
    del state, hook
    gc.collect()
    torch.cuda.empty_cache()

    lines = read_log(os.path.join(out, "metrics.jsonl"))
    log_lines = read_log(os.path.join(out, "train_log.jsonl"))
    steps = step_lines(lines)
    evals = [r for r in lines if any(k.startswith("eval/") for k in r)]
    rec["log"] = log_lines
    L, Lv = cfg.llm.num_layers, cfg.vision.num_layers
    # the evaluation at step 4 runs between micro-steps 4 and 5
    ev = {"launches": count_diff(micro[4]["before"], micro[3]["after"]),
          "vit_by_batch": count_diff(micro[4]["vit_before"],
                                     micro[3]["vit_after"])}
    for m in micro:
        m["launches"] = count_diff(m.pop("after"), m.pop("before"))
        m["vit_by_batch"] = count_diff(m.pop("vit_after"),
                                       m.pop("vit_before"))
    # per micro-step: K1 once per tower layer (the frozen tower takes no
    # gradient), K3 in each decoder layer's forward and its recompute, K4
    # and K5 once each
    per_micro = {"vit_attention": Lv, "flash_attention_lse": 2 * L,
                 "flash_bwd_dq": L, "flash_bwd_dkv": L}
    micro_ok = len(micro) == 6 and all(
        m["launches"] == per_micro and sum(m["vit_by_batch"].values()) == Lv
        for m in micro)
    # per model call of the evaluation K2 once per decoder layer (the
    # prefill) and K1 once per tower layer for the call's frames and for
    # each history backfill pass, and no other kernel: the calls are K2's
    # launches over L, the tower passes K1's over Lv
    def eval_ok(launches):
        k1, k2 = launches.get("vit_attention", 0), \
            launches.get("flash_attention", 0)
        return set(launches) <= {"vit_attention", "flash_attention"} and \
            k2 >= L and k2 % L == 0 and k1 % Lv == 0 and k1 // Lv >= k2 // L
    ev["model_calls"] = ev["launches"].get("flash_attention", 0) // L
    ev["tower_passes"] = ev["launches"].get("vit_attention", 0) // Lv
    hm = rec["hook_memory"]
    rec["tower_batches"] = sorted({m["tower_batch"] for m in micro})
    rec["vit_batches_sent"] = sorted(
        {int(k) for m in micro for k in m["vit_by_batch"]}
        | {int(k) for k in ev["vit_by_batch"]})
    log(f"9a launches per micro-step {[m['launches'] for m in micro]} (want "
        f"{per_micro} each); tower batches {rec['tower_batches']}, buckets "
        f"{[m['bucket'] for m in micro]}; evaluation at step 4: "
        f"{ev['launches']} ({ev['model_calls']} model calls, "
        f"{ev['tower_passes']} tower passes); the hook on the final params: "
        f"{hm['launches']}, memory allocated before / after "
        f"{hm['before']} / {hm['after']}; eval line {evals}")
    finite = all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
                 for r in steps)
    require("9a: the training command",
            six_step_lines=[r["step"] for r in step_lines(log_lines)]
            == [1, 2, 3, 4, 5, 6],
            finite_losses_and_grad_norms=finite,
            mirror=[r["step"] for r in steps] == [1, 2, 3, 4, 5, 6],
            one_eval_line=len(evals) == 1 and evals[0]["step"] == 4
            and "eval/sucs_all" in evals[0],
            launches_per_micro_step=micro_ok,
            evaluation_launches=eval_ok(ev["launches"])
            and eval_ok(hm["launches"]),
            evaluation_memory_returned=hm["after"] <= hm["before"],
            frozen_weights=frozen_ok,
            every_adapter_moved=len(b_moved) == n_lora,
            ends_at_6=rec["final_step"] == 6,
            one_checkpoint_6=rec["checkpoints"] == ["6"]
            and rec["latest_step"] == 6,
            restore_bit_equal=rec["restore_bit_equal"])

    # numbers from what the command wrote: a micro-step's wall from its
    # call's start to its line's "ts" (the step, the loss read back, the
    # log lines), the wait before it from the previous line's "ts" (the
    # prefetcher.get() of its batch); the evaluation and the save from the
    # lines around them
    prev = {id(r): lines[i - 1] if i else None for i, r in enumerate(lines)}
    for m, r in zip(micro, steps):
        m["ms"] = (r["ts"] - m["t_start"]) * 1e3
        p_ = prev[id(r)]
        m["wait_ms"] = None if p_ is None else (m["t_start"] - p_["ts"]) * 1e3
        m["loss"] = r["loss"]
    ev["seconds"] = evals[0]["ts"] - steps[3]["ts"] if evals else None
    ev["result"] = evals[0] if evals else None
    rec["evaluation"] = ev
    # from step 6's line to main's return: the loop's save of step 6, the
    # prefetcher's close (its worker finishes the batch in hand) and the
    # final save of step 6, skipped
    rec["save"] = {"step": 6, "seconds": t_end - steps[-1]["ts"],
                   "bytes": dir_bytes(os.path.join(ckpt_dir, "6"))}
    opt = [(micro[i], micro[i + 1]) for i in range(0, len(micro), 2)]
    rec["optimizer_step_ms"] = [x["ms"] + y["ms"] for x, y in opt]
    rec["optimizer_step_profiled"] = [x["profiled"] or y["profiled"]
                                      for x, y in opt]
    rec["valid_tokens_per_s"] = [(x["valid_tokens"] + y["valid_tokens"])
                                 / (x["ms"] + y["ms"]) * 1e3 for x, y in opt]
    clean = [i for i, p_ in enumerate(rec["optimizer_step_profiled"])
             if not p_]
    rec["median_step_ms"] = float(np.median(
        [rec["optimizer_step_ms"][i] for i in clean]))
    rec["median_valid_tokens_per_s"] = float(np.median(
        [rec["valid_tokens_per_s"][i] for i in clean]))
    # the first get() waits for the worker's first batch: no line before it
    waits = [m["wait_ms"] for m in micro[1:]]
    rec["prefetch_wait_ms"] = waits
    rec["prefetch_wait_share"] = sum(waits) / sum(m["ms"] for m in micro[1:])
    rec["profile"] = box.get("profile")
    rec["micro_steps"] = micro
    log(f"9a optimizer steps {['%.2f' % x for x in rec['optimizer_step_ms']]}"
        f" ms (profiled {rec['optimizer_step_profiled']}), median "
        f"{rec['median_step_ms']:.2f} ms, "
        f"{rec['median_valid_tokens_per_s']:.1f} valid tokens/s; prefetch "
        f"waits {['%.2f' % w for w in waits]} ms "
        f"({rec['prefetch_wait_share']:.4f} of the micro-steps after the "
        f"first); peak {rec['peak_memory_bytes'] / 2**30:.2f} GiB; "
        f"evaluation {ev['seconds']:.2f} s; save of step 6 "
        f"{rec['save']['bytes']} bytes in {rec['save']['seconds']:.2f} s "
        f"({rec['save']['bytes'] / rec['save']['seconds'] / 1e9:.2f} GB/s)")
    return rec


def resume_and_export(torch, np, va, fa, reset, tmp, model_size="0.5b",
                      device="cuda"):
    """Phase 9b at --model_size 0.5b (the full SigLIP tower) on 9a's
    trajectories: `train.main --lora_enable --grad_accum_steps 2
    --num_steps 3` (its final save lands between the two micro-steps of an
    optimizer step), then the same command with --num_steps 4 --export_hf
    resuming from it: the second run logs step 4 alone and ends at 4, the
    checkpoints are 3 and 4, lora_adapters.npz holds every adapter of the
    final state, and hf_export loads back through load_streamvln_checkpoint
    bit-equal in f32 to merge_lora of the final params."""
    from streamvln_tpu_torch import train
    from streamvln_tpu_torch.configs import build_config
    from streamvln_tpu_torch.models import convert_hf
    from streamvln_tpu_torch.models import lora as lora_lib
    from streamvln_tpu_torch.utils import checkpoint
    import argparse
    out = os.path.join(tmp, "export")
    argv = ["--video_folders", os.path.join(tmp, "traj"), "--output_dir",
            out, "--model_size", model_size, "--lora_enable",
            "--batch_size", "2", "--grad_accum_steps", "2",
            "--save_steps", "10", "--log_steps", "1", "--device", device]
    gc.collect()
    torch.cuda.empty_cache()
    reset()
    t0 = time.perf_counter()
    first = train.main(argv + ["--num_steps", "3"])
    first_step = first.step
    del first
    state = train.main(argv + ["--num_steps", "4", "--export_hf"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernel_counts(va, fa)
    cfg = build_config(argparse.Namespace(
        model_size=model_size, spatial_pool_mode="bilinear", num_frames=32,
        num_future_steps=4, num_history=8))
    with torch.no_grad():
        merged = tree_map(lambda t: t.float(),
                          lora_lib.merge_lora(state.params))
    loaded = convert_hf.load_streamvln_checkpoint(
        os.path.join(out, "hf_export"), cfg, torch.float32, device)
    a, b = dict(tree_leaves(merged)), dict(tree_leaves(loaded))
    export_equal = set(a) == set(b) and all(torch.equal(a[p], b[p])
                                            for p in a)
    layers = state.params["llm"]["layers"]
    want = {k for k in layers if "_lora_" in k} | {"lora_scale"}
    with np.load(os.path.join(out, "lora_adapters.npz")) as npz:
        files = set(npz.files)
        npz_equal = files == want and all(
            np.array_equal(npz[k], (layers[k] if k in layers else
                                    state.params["llm"][k])
                           .detach().cpu().numpy()) for k in want)
    ckpt_dir = os.path.join(out, "ckpt")
    log_lines = read_log(os.path.join(out, "train_log.jsonl"))
    rec = {"seconds": seconds, "launches": launches,
           "first_run_step": first_step, "final_step": state.step,
           "checkpoints": sorted(os.listdir(ckpt_dir)),
           "checkpoint_bytes": dir_bytes(ckpt_dir),
           "export_bytes": dir_bytes(os.path.join(out, "hf_export")),
           "export_leaves": len(a), "export_bit_equal": export_equal,
           "adapters": sorted(files), "adapters_equal": npz_equal,
           "vit_launches_by_batch": by_batch(va), "log": log_lines}
    log(f"9b {model_size} runs to step 3 and, resumed, to 4 with the "
        f"export: {seconds:.1f} s; steps logged "
        f"{[r['step'] for r in log_lines]}, checkpoints {rec['checkpoints']} "
        f"({rec['checkpoint_bytes'] / 2**30:.3f} GiB); {len(files)} arrays "
        f"in lora_adapters.npz equal to the state's {npz_equal}; hf_export "
        f"{rec['export_bytes'] / 2**30:.3f} GiB, {len(a)} leaves loaded back "
        f"bit-equal (f32) to merge_lora of the final params {export_equal}; "
        f"launches {launches}")
    require("9b: the resume and the export", adapters_npz=npz_equal,
            hf_export_loads_back_bit_equal=export_equal,
            resumed_at_3_logs_4_ends_at_4=first_step == 3
            and state.step == 4
            and [r["step"] for r in log_lines] == [1, 2, 3, 4],
            checkpoints_3_4=rec["checkpoints"] == ["3", "4"]
            and checkpoint.latest_step(ckpt_dir) == 4,
            finite_steps=all(np.isfinite(r["loss"]) for r in log_lines))
    del state, merged, loaded, a, b
    return rec


def long_context_step(torch, np, va, fa, reset, model_size="7b",
                      device="cuda", S=LONG_S):
    """Phase 9c: one LoRA optimizer step of streamvln_7b at S = 32768 under
    attn_impl="auto" with the reference's 7B@32k recipe (remat,
    remat_chunk 7, mlp_chunk 2048, loss_chunk 1024) on
    tests/test_train_32k.py's layout (one image, labels on the second half
    of 400 tokens, padded to S): finite loss and grad norm, exact K1 and
    K3/K4/K5 counts, step seconds, valid tokens/s (and padded positions/s,
    the step being mostly padding), peak memory."""
    import argparse
    from streamvln_tpu_torch import weights
    from streamvln_tpu_torch.configs import build_config
    from streamvln_tpu_torch.models import lora as lora_lib
    from streamvln_tpu_torch.models.streamvln import (build_splice_layout,
                                                      stack_layouts)
    from streamvln_tpu_torch.ops.preprocess import preprocess_frames
    from streamvln_tpu_torch.parallel.train import (
        TrainConfig, create_train_state, make_train_step)
    cfg = build_config(argparse.Namespace(
        model_size=model_size, spatial_pool_mode="bilinear", num_frames=32,
        num_future_steps=4, num_history=8))
    dtype = torch.bfloat16 if device == "cuda" else torch.float32
    gc.collect()
    torch.cuda.empty_cache()
    params = lora_lib.add_lora(
        weights.init(cfg, torch.Generator(device=device).manual_seed(0),
                     device=device, dtype=dtype),
        torch.Generator(device=device).manual_seed(1), rank=16, alpha=32.0)
    tcfg = TrainConfig(lora_only=True, remat=True, total_steps=1,
                       **LONG_RECIPE)
    state = create_train_state(params, tcfg)
    step = make_train_step(cfg, tcfg, device=device)
    ids = np.full((400,), 5, np.int32)
    ids[1] = -200                                   # <image>
    labels = np.where(np.arange(400) > 200, ids, -100).astype(np.int32)
    batch = stack_layouts([build_splice_layout(ids, cfg, labels=labels,
                                               pad_to=S)])
    del batch["lengths"]
    frame = torch.randint(0, 256, (1, 480, 640, 3), device=device,
                          dtype=torch.uint8,
                          generator=torch.Generator(device=device)
                          .manual_seed(2))
    batch["images"] = preprocess_frames(frame, cfg.vision.image_size,
                                        dtype)[None]
    valid = int(np.asarray(batch["valid"]).sum())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    t0 = time.perf_counter()
    state, m = step(state, batch)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    got = kernel_counts(va, fa)
    L, Lv, rc = cfg.llm.num_layers, cfg.vision.num_layers, \
        LONG_RECIPE["remat_chunk"]
    # K3: each layer's forward, its recompute in the layer's own
    # checkpoint, and the chunk checkpoint's recompute, which stops (early
    # stop) once the chunk's last layer's input is saved: rc - 1 layers
    want = {"vit_attention": Lv, "flash_attention": 0,
            "flash_attention_lse": 2 * L + (L // rc) * (rc - 1),
            "flash_bwd_dq": L, "flash_bwd_dkv": L}
    rec = {"S": S, "valid_tokens": valid, "seconds": seconds,
           "loss": m["loss"].item(), "grad_norm": m["grad_norm"].item(),
           "valid_tokens_per_s": valid / seconds,
           "padded_positions_per_s": S / seconds,
           "peak_memory_bytes": peak, "launches": got, "want": want,
           "recipe": LONG_RECIPE, "vit_launches_by_batch": by_batch(va)}
    log(f"9c {model_size} LoRA step at S={S} ({valid} valid tokens, "
        f"{LONG_RECIPE}): loss {rec['loss']:.6f} grad_norm "
        f"{rec['grad_norm']:.6f} in {seconds:.2f} s ({valid / seconds:.1f} "
        f"valid tokens/s; {S / seconds:.0f} padded positions/s); peak "
        f"{peak / 2**30:.2f} GiB; launches {got} (want {want})")
    require("9c: the 32k step", finite=np.isfinite(rec["loss"])
            and np.isfinite(rec["grad_norm"]) and rec["grad_norm"] > 0,
            launch_counts=got == want)
    del state, params, step, m, batch
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def long_plain_backward(torch, fa, q, k, v, dout, lse, dsum, eps, q_pos,
                        k_pos, qb=1024):
    """Phase 9c, one query block of `qb` rows at a time ([.., qb, S]
    scores), the plain versions' formulas (fa._bwd_core) on the kernels'
    own LSE and Dsum: the plain dQ, dK, dV in the inputs' dtype (as phase
    4a's plain versions return them); phase 4a's rounding terms per
    element (scale * sum |dS||K|, scale * sum |dS||Q|, sum P |dO|); and the
    shift of dQ and dK that the Dsum source makes against
    chunked_attention's autograd. The kernels take Dsum from their bf16
    output, autograd from chunked_attention's f32 output; with `eps` [B,
    Hq, S] the first minus the second, dS moves by -P eps, so dQ moves by
    -scale * eps * sum_k P_k K_k and dK by -scale * sum_q P eps Q (dV does
    not take Dsum). Returns ((dq, dk, dv), (t_dq, t_dk, t_dv), (s_dq,
    s_dk)), each [B, S, H, D]."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    G, scale = Hq // Hkv, D ** -0.5
    dq, t_dq, s_dq = (torch.zeros((B, S, Hq, D), device=q.device)
                      for _ in range(3))
    dk, dv, t_dk, t_dv, s_dk = (torch.zeros((B, Hkv, S, D), device=q.device)
                                for _ in range(5))
    for i in range(0, S, qb):
        sl = slice(i, i + qb)
        p, ds, qf, kf, dof = fa._bwd_core(
            q[:, sl], k, v, dout[:, sl], lse[:, :, sl].contiguous(),
            dsum[:, :, sl].contiguous(), q_pos[:, sl], k_pos, scale, False)
        n = p.shape[3]
        pe = p * eps[:, :, sl].reshape(B, Hkv, G, n)[..., None]

        def to_q(x):                    # [B, Hkv, G, n, D] -> [B, n, Hq, D]
            return x.permute(0, 3, 1, 2, 4).reshape(B, n, Hq, D) * scale
        dq[:, sl] = to_q(torch.einsum("bhgqk,bhkd->bhgqd", ds, kf))
        s_dq[:, sl] = to_q(torch.einsum("bhgqk,bhkd->bhgqd", pe, kf))
        dk += torch.einsum("bhgqk,bqhgd->bhkd", ds, qf) * scale
        s_dk += torch.einsum("bhgqk,bqhgd->bhkd", pe, qf) * scale
        dv += torch.einsum("bhgqk,bqhgd->bhkd", p, dof)
        ds.abs_()
        t_dq[:, sl] = to_q(torch.einsum("bhgqk,bhkd->bhgqd", ds, kf.abs()))
        t_dk += torch.einsum("bhgqk,bqhgd->bhkd", ds, qf.abs()) * scale
        t_dv += torch.einsum("bhgqk,bqhgd->bhkd", p, dof.abs())
        del p, ds, pe, qf, kf, dof
    kv = [x.transpose(1, 2) for x in (dk, dv, t_dk, t_dv, s_dk)]
    return ((dq.to(q.dtype), kv[0].to(k.dtype), kv[1].to(v.dtype)),
            (t_dq, kv[2], kv[3]), (s_dq, kv[4]))


def by_rows(got, ref, term, bounds=LONG_ROW_RANGES) -> dict:
    """grad_compare over each range of rows (axis 1) in `bounds`."""
    return {f"[{a},{b})": grad_compare(got[:, a:b], ref[:, a:b],
                                       term[:, a:b])
            for a, b in zip(bounds[:-1], bounds[1:])}


def check_long_kernels(torch, F, fa, S=LONG_S, n_valid=LONG_VALID, Hq=28,
                       Hkv=4, D=128, seed=7):
    """Phase 9c: K3's output and K4/K5's dQ, dK, dV at B=1, S=32768 (n_valid
    valid tokens, the rest padding as forward_train lays it out). Query 7
    sees no key: the kernels give 0 there, chunked_attention the mean of v
    (the reference's result), so its output is skipped and its dO set to 0.
    - K3's output against the port's chunked_attention in f32 on the same
      bf16 values, within phase 4a's KERNEL_ATOL + KERNEL_RTOL|ref| + 2^-8
      sum p|v|.
    - K4/K5 against their plain versions on the kernels' own LSE and Dsum
      (long_plain_backward), within phase 4a's GRAD_RTOL|ref| + GRAD_FLIP *
      term + GRAD_ATOL, the term the products whose bf16 factor (dS, or P
      for dV) can round one ulp apart.
    - The same gradients against chunked_attention's autograd, one query
      block of LONG_Q_BLOCK rows at a time (each row's softmax spans all
      keys, so the blocks are independent; their dK and dV are summed),
      moved by what the kernels' Dsum changes (long_plain_backward), at the
      same tolerance. Unmoved, the gap is reported by range of rows: the
      Dsum from the bf16 output is off by up to ~2^-9 sum_d |dO|(|O| +
      sum p|v|), and on rows that see a few keys sum_k P_k K_k is O(1)
      while dS = P(dP - Dsum) may cancel, so the shift can exceed phase
      4a's term there.
    Times K3, K4, K5, chunked_attention's forward and blocked backward, and
    SDPA where it takes the shape."""
    from streamvln_tpu_torch.ops.attention import chunked_attention
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda") \
            .to(torch.bfloat16)
    B = 1
    q, dout = rnd(B, S, Hq, D), rnd(B, S, Hq, D)
    k, v = rnd(B, S, Hkv, D), rnd(B, S, Hkv, D)
    q_pos, k_pos = train_positions(torch, B, S, n_valid, "cuda")
    dout[:, 7] = 0
    shape = (f"B={B} S={S} valid={n_valid} Hq={Hq} Hkv={Hkv} D={D} bf16 "
             f"[B,S,Hkv,D]")
    out, lse = fa.flash_attention_lse(q, k, v, q_pos, k_pos)
    dsum = fa._dsum(dout, out)
    args = (q, k, v, dout, lse, dsum, q_pos, k_pos)
    dq = fa.flash_bwd_dq(*args)
    dk, dv = fa.flash_bwd_dkv(*args)
    torch.cuda.synchronize()
    unseen_ok = bool((out[0, 7] == 0).all()) and bool((dq[0, 7] == 0).all())

    qf, kf, vf = q.float(), k.float(), v.float()
    with torch.no_grad():
        ref = chunked_attention(qf, kf, vf, q_pos, k_pos)
        few = chunked_attention(qf, kf, vf.abs(), q_pos, k_pos)
    seen = torch.ones(S, dtype=torch.bool, device="cuda")
    seen[7] = False
    err = (out.float() - ref).abs()[:, seen]
    tol = (KERNEL_ATOL + KERNEL_RTOL * ref.abs() + 2.0 ** -8 * few)[:, seen]
    c_out = {"max_abs_err": err.max().item(),
             "tol_share": (err / tol).max().item(),
             "skipped_rows": 1}
    # the kernels' Dsum (from their bf16 output) minus autograd's (from
    # chunked_attention's f32 output), per row
    eps = dsum - (dout.float() * ref).sum(-1).transpose(1, 2)
    del ref, few, err, tol
    dq_ref = torch.zeros_like(qf)
    dk_ref, dv_ref = torch.zeros_like(kf), torch.zeros_like(vf)
    kr, vr = kf.clone().requires_grad_(), vf.clone().requires_grad_()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(0, S, LONG_Q_BLOCK):
        sl = slice(i, i + LONG_Q_BLOCK)
        qi = qf[:, sl].clone().requires_grad_()
        o = chunked_attention(qi, kr, vr, q_pos[:, sl], k_pos)
        gq, gk, gv = torch.autograd.grad(o, (qi, kr, vr),
                                         dout[:, sl].float())
        dq_ref[:, sl] = gq
        dk_ref += gk
        dv_ref += gv
        del o, gq, gk, gv, qi
    torch.cuda.synchronize()
    chunked_fwd_bwd_s = time.perf_counter() - t0
    del kr, vr
    (p_dq, p_dk, p_dv), (t_dq, t_dk, t_dv), (s_dq, s_dk) = \
        long_plain_backward(torch, fa, q, k, v, dout, lse, dsum, eps, q_pos,
                            k_pos)
    # against the plain versions on the kernels' own LSE and Dsum, at phase
    # 4a's tolerance
    c_dq = grad_compare(dq, p_dq, t_dq)
    c_dk, c_dv = grad_compare(dk, p_dk, t_dk), grad_compare(dv, p_dv, t_dv)
    # against chunked_attention's autograd moved by the Dsum source, at the
    # same tolerance; and its raw gap by range of rows
    witness = {"dq": grad_compare(dq, dq_ref - s_dq, t_dq),
               "dk": grad_compare(dk, dk_ref - s_dk, t_dk),
               "dv": grad_compare(dv, dv_ref, t_dv)}
    raw = {"dq": by_rows(dq, dq_ref, t_dq),
           "dk": by_rows(dk, dk_ref, t_dk),
           "dv": by_rows(dv, dv_ref, t_dv),
           "dsum_shift_dq": by_rows(dq_ref - s_dq, dq_ref, t_dq),
           "eps_max_abs": eps.abs().max().item()}
    log(f"9c K4/K5 against chunked_attention's autograd moved by the Dsum "
        f"source (dQ by -scale*eps*sum P K, dK by -scale*sum P eps Q; eps "
        f"max {raw['eps_max_abs']:.3e}): {json.dumps(witness)}")
    for name in ("dq", "dk", "dv", "dsum_shift_dq"):
        log(f"9c raw gap to chunked_attention by rows, {name}: "
            f"{json.dumps(raw[name])}")
    del t_dq, t_dk, t_dv, s_dq, s_dk, dq_ref, dk_ref, dv_ref, p_dq, p_dk, \
        p_dv, eps

    ms3 = time_ms(torch, lambda: fa.flash_attention_lse(q, k, v, q_pos,
                                                        k_pos), iters=5)
    ms4 = time_ms(torch, lambda: fa.flash_bwd_dq(*args), iters=5)
    ms5 = time_ms(torch, lambda: fa.flash_bwd_dkv(*args), iters=5)
    with torch.no_grad():
        chunked_ms = time_ms(torch, lambda: chunked_attention(
            qf, kf, vf, q_pos, k_pos), iters=1, warmup=1)
    # yardstick: SDPA's memory-efficient kernel with the boolean mask
    # ([B, 1, S, S], 1 GiB) and K/V repeated per query head; the math
    # kernel would need the [B, Hq, S, S] f32 scores (120 GB)
    lib = {"fwd": None, "bwd": None, "why": None}
    try:
        from torch.nn.attention import SDPBackend, sdpa_kernel
        mask = (k_pos[:, None, :] <= q_pos[:, :, None])[:, None]
        qt = q.transpose(1, 2).contiguous().requires_grad_()
        kt, vt = (x.transpose(1, 2).repeat_interleave(Hq // Hkv, dim=1)
                  .contiguous().requires_grad_() for x in (k, v))
        dot = dout.transpose(1, 2).contiguous()
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            def sdpa():
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      attn_mask=mask)
            with torch.no_grad():
                lib["fwd"] = time_ms(torch, sdpa, iters=3, warmup=1)
            o = sdpa()
            lib["bwd"] = time_ms(torch, lambda: torch.autograd.grad(
                o, (qt, kt, vt), dot, retain_graph=True), iters=3, warmup=1)
        del o, qt, kt, vt, dot, mask
    except (RuntimeError, torch.OutOfMemoryError) as e:
        lib["why"] = f"{type(e).__name__}: {str(e)[:160]}"
    log(f"9c SDPA at S={S} (fwd ms, bwd ms): {lib}")
    # visible (query, key) pairs: keys are positions 0..n_valid-1 in order
    k_sorted = torch.sort(k_pos[0]).values
    pairs = float(torch.searchsorted(k_sorted, q_pos[0], right=True)
                  .sum().item()) * Hq
    e = 2
    qbytes, kbytes = B * S * Hq * D * e, B * S * Hkv * D * e
    rows, pos_b = B * Hq * S * 4, 2 * B * S * 4
    work = {
        "flash_attention_lse": (4 * D * pairs, 2 * qbytes + 2 * kbytes + rows
                                + pos_b, c_out, ms3, lib["fwd"]),
        "flash_bwd_dq": (6 * D * pairs, 3 * qbytes + 2 * kbytes + 2 * rows
                         + pos_b, c_dq, ms4, lib["bwd"]),
        "flash_bwd_dkv": (8 * D * pairs, 2 * qbytes + 4 * kbytes + 2 * rows
                          + pos_b, {"dk": c_dk, "dv": c_dv}, ms5,
                          lib["bwd"]),
    }
    recs = {}
    for name, (flops, nbytes, c, ms, lib_ms) in work.items():
        b_ms, b_by = bound(flops, nbytes)
        checks = c if name == "flash_bwd_dkv" else {"out" if name ==
                                                    "flash_attention_lse"
                                                    else "dq": c}
        recs[name] = {"shape": shape, "checks": checks,
                      "chunked_witness": {"out": c_out} if name ==
                      "flash_attention_lse" else
                      {x: witness[x] for x in checks},
                      "max_abs_err": max(x["max_abs_err"]
                                         for x in checks.values()),
                      "ms": ms, "bound_ms": b_ms, "bound_by": b_by,
                      "library_ms": lib_ms, "flops": flops, "bytes": nbytes,
                      "library": "F.scaled_dot_product_attention "
                                 "(memory-efficient, mask, K/V repeated) "
                      + ("forward" if name == "flash_attention_lse" else
                         "backward (dQ, dK and dV in one call)")
                      if lib_ms is not None else f"none: {lib['why']}"}
        log(f"9c {name} {shape}: {json.dumps(checks)} kernel {ms:.4f} ms "
            f"sdpa {lib_ms} ms bound {b_ms:.4f} ms ({b_by})")
    rec = {"kernels": recs, "chunked_fwd_ms": chunked_ms,
           "chunked_witness": witness, "chunked_gap_by_rows": raw,
           "chunked_fwd_bwd_blocked_s": chunked_fwd_bwd_s,
           "kernels_fwd_bwd_ms": ms3 + ms4 + ms5, "unseen_row_ok": unseen_ok,
           "library": lib}
    log(f"9c chunked_attention (f32) forward {chunked_ms:.2f} ms, forward "
        f"and backward in {S // LONG_Q_BLOCK} query blocks "
        f"{chunked_fwd_bwd_s:.2f} s, against K3 + K4 + K5 "
        f"{ms3 + ms4 + ms5:.4f} ms; the row that sees no key gives out 0 "
        f"and dQ 0 from the kernels: {unseen_ok}")
    shares_ = [c_out["tol_share"], c_dq["tol_share"], c_dk["tol_share"],
               c_dv["tol_share"]] + [w["tol_share"] for w in witness.values()]
    require("9c: K3/K4/K5 against chunked_attention at S=32768",
            within_tolerance=all(x <= 1.0 for x in shares_),
            unseen_row=unseen_ok)
    del q, k, v, dout, out, lse, dsum, dq, dk, dv, qf, kf, vf, args
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def phase9_bytes(torch, model_size, export_size) -> int:
    """The bytes phase 9 writes to the temporary directory's disk, by the
    states measured on the meta device: 9a's one checkpoint of the whole
    training state, 9b's two checkpoints and its f32 HF export, and a GiB
    for the trajectories."""
    import argparse
    from streamvln_tpu_torch import weights
    from streamvln_tpu_torch.configs import build_config
    from streamvln_tpu_torch.models import lora as lora_lib
    from streamvln_tpu_torch.parallel.train import (TrainConfig,
                                                    create_train_state)

    def state(size):
        cfg = build_config(argparse.Namespace(
            model_size=size, spatial_pool_mode="bilinear", num_frames=32,
            num_future_steps=4, num_history=8))
        return create_train_state(lora_lib.add_lora(
            weights.init(cfg, torch.Generator(), device="meta",
                         dtype=torch.bfloat16), torch.Generator(), rank=16),
            TrainConfig(lora_only=True, grad_accum_steps=2))
    small = state(export_size)
    f32 = sum(2 * t.numel() * t.element_size()
              for _, t in tree_leaves(small.params))
    return state_bytes(state(model_size)) + 2 * state_bytes(small) + f32 \
        + 2**30


def train_cli(torch, np, F, va, fa, reset, train4b, card, model_size="7b",
              export_size="0.5b", device="cuda", long_s=LONG_S):
    """Phase 9: the training entry point. 9a the command at full width, 9b
    its resume and export at 0.5b, 9c the 32k step and K3/K4/K5 held
    against chunked_attention at S=32768. The trajectories and checkpoints
    live in a directory under tempfile.gettempdir() removed in every case;
    RuntimeError naming the bytes needed when its disk has less free."""
    import shutil
    import tempfile
    t_phase = time.perf_counter()
    root = tempfile.gettempdir()
    need, free = phase9_bytes(torch, model_size, export_size), \
        shutil.disk_usage(root).free
    log(f"phase 9: trajectories and checkpoints under {root}: writes "
        f"{need / 2**30:.1f} GiB, {free / 2**30:.1f} GiB free")
    if free < need:
        raise RuntimeError(f"phase 9 writes {need} bytes of trajectories and "
                           f"checkpoints under {root}, which has {free} free")
    tmp = tempfile.mkdtemp(prefix="train_cli_", dir=root)
    try:
        cli = train_command(torch, np, va, fa, reset, tmp, model_size,
                            device)
        shutil.rmtree(os.path.join(tmp, "run"))
        export = resume_and_export(torch, np, va, fa, reset, tmp,
                                   export_size, device)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    step32k = long_context_step(torch, np, va, fa, reset, model_size, device,
                                long_s)
    kernels = check_long_kernels(torch, F, fa) if device == "cuda" else None
    rec = {"command": cli, "export": export, "long_step": step32k,
           "long_kernels": kernels,
           "scratch": {"root": root, "writes": need},
           "seconds": time.perf_counter() - t_phase}
    log(f"phase 9 ({card}): 9a optimizer step median "
        f"{cli['median_step_ms']:.2f} ms, "
        f"{cli['median_valid_tokens_per_s']:.1f} valid tokens/s, peak "
        f"{cli['peak_memory_bytes'] / 2**30:.2f} GiB "
        f"(phase 4b: {train4b['median_step_ms']:.2f} ms, "
        f"{train4b['tokens_per_s']:.1f} tokens/s, "
        f"{train4b['peak_memory_bytes'] / 2**30:.2f} GiB); prefetch wait "
        f"{cli['prefetch_wait_share']:.4f} of a step; idle share "
        f"{(cli['profile'] or {}).get('device_idle_share')}; 9c "
        f"{step32k['seconds']:.2f} s at S={long_s}, peak "
        f"{step32k['peak_memory_bytes'] / 2**30:.2f} GiB; "
        f"{rec['seconds']:.1f} s")
    return rec


# phase 10: the LLM families of the registry at full width, each built by
# the entry points' own eval_cli.build_agent (random bf16 weights from seed
# 0 made on the card), in this order; Mixtral at 8 of its 32 layers: its 87
# GiB of bf16 weights exceed the card's 80 GB, and the reference's
# layer-by-layer quantized init has no MoE leaves (an int4 Mixtral would
# first hold the whole bf16 tree)
FAMILY_SIZES = ("qwen2-moe-a2.7b", "gemma-2b", "mpt-7b", "llama3-8b",
                "llama2-7b", "mistral-7b", "qwen2-14b", "mixtral-8x7b")
FAMILY_DEPTH = {"mixtral-8x7b": 8}
# 10b: the families also served under decode_kernel, one for each K8 shape
# the port's own model does not take: head dim 256 (G = 8), G = 1, G = 5
DECODE_KERNEL_FAMILIES = ("gemma-2b", "llama2-7b", "qwen2-14b")
# the three agent calls of each family: step 0, a mid-window step, and the
# first call after the 32-step window reset (<memory>, history backfill)
FAMILY_STEPS = (0, 16, 32)
# a family's device memory after its agents are freed may exceed what the
# card held before it by at most this (allocator rounding)
FAMILY_MEMORY_SLACK = 256 * 2**20


@contextlib.contextmanager
def family_depth(configs, name):
    """While open, the registry builds `name` at FAMILY_DEPTH's depth (its
    widths unchanged), so the entry point's own build_agent makes it."""
    depth = FAMILY_DEPTH.get(name)
    preset = configs.LLM_REGISTRY[name]
    if depth is not None:
        import dataclasses
        configs.LLM_REGISTRY[name] = lambda: dataclasses.replace(
            preset(), num_layers=depth)
    try:
        yield
    finally:
        configs.LLM_REGISTRY[name] = preset


def family_kernels(torch, F, fa, da):
    """Phase 10a: the kernels at the families' new shapes against their
    plain versions, at phase 2's tolerances: K2 and K3 at Gemma's head dim
    256 (8 query heads on 1 KV head) at Sq 768 and 2560 on the 4096-slot
    KV-major cache, K8 there at lengths 300, 1900, 2049 and 4096 (18
    layers' caches in turn: Gemma's depth), and K2 and K8 at group sizes 1
    (32/32 heads: Llama-2, Qwen2-MoE's 16/16 in kind) and 5 (40/8:
    Qwen2-14B). Each timed by device time beside its plain version and
    SDPA, with its bound; K8 and K2 at Sq 768 also on the settled
    yardstick."""
    recs = {"flash": [], "flash_lse": [], "decode": []}
    for Sq in (768, 2560):
        recs["flash"].append(check_flash(torch, F, fa, Sq, Hq=8, Hkv=1,
                                         D=256, seed=21, graph=Sq == 768))
        recs["flash_lse"].append(check_flash(torch, F, fa, Sq, Hq=8, Hkv=1,
                                             D=256, seed=22, lse=True))
    for Hq, Hkv in ((32, 32), (40, 8)):
        recs["flash"].append(check_flash(torch, F, fa, 768, Hq=Hq, Hkv=Hkv,
                                         seed=23, graph=True))
    recs["decode"] += check_decode(torch, F, da, (300, 1900, 2049, 4096),
                                   L=18, Hq=8, Hkv=1, D=256, seed=24)
    for Hq, Hkv, L in ((32, 32, 12), (40, 8, 28)):
        recs["decode"] += check_decode(torch, F, da, (300, 4096), L=L,
                                       Hq=Hq, Hkv=Hkv, seed=25)
    torch.cuda.empty_cache()
    return recs


def step_logits(torch, eng, impl):
    """One more decode step from the engine's cache (a copy of it) under
    `impl`: the f32 logits of its pending token."""
    from streamvln_tpu_torch.models import qwen2
    cfg = eng.cfg.llm
    c = qwen2.KVCache(eng.cache.k.clone(), eng.cache.v.clone(),
                      eng.cache.length.clone())
    ids = torch.tensor([[eng.envs[0].pending_token]], device=eng.device)
    emb = qwen2.embed_tokens(eng.params["llm"], ids, cfg).to(
        eng.compute_dtype)
    with torch.no_grad():
        logits, _ = qwen2.forward(eng.params["llm"], cfg, emb,
                                  c.length[:, None], cache=c, attn_impl=impl)
    del c
    return logits[:, 0]


def family_calls(torch, agent, ref_agent, frames, instruction, reset):
    """The three calls (FAMILY_STEPS) of `agent` ("auto") and `ref_agent`
    (the same weights under "dense") in lockstep over steps 0..32: each
    call's last-position prefill logits compared (cosine), its tokens and
    phase times recorded; after each call the dense engine takes the auto
    engine's dialogue (resync), so every call compares one input. A
    warm-up call of each (its state reset) captures the decode graphs
    first, as drive_calls does; `reset()` zeroes the launch counts after
    it."""
    eng, ref = agent.engine, ref_agent.engine
    for a in (agent, ref_agent):
        a.step(0, frames[0], instruction, run_model=True)
        a.reset_memory(0)
    torch.cuda.synchronize()
    reset()
    calls = []
    for step in range(FAMILY_STEPS[-1] + 1):
        run = step in FAMILY_STEPS
        made, restore = record_calls(torch, eng)
        t0 = time.perf_counter()
        try:
            agent.step(0, frames[step], instruction, run_model=run)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        finally:
            restore()
        ref_agent.step(0, frames[step], instruction, run_model=run)
        if not run:
            continue
        toks = made[0]["tokens"]
        agree = logits_agreement(torch, eng.last_logits, ref.last_logits)
        vis, pre, dec = made[0]["phase_ms"]
        calls.append({"step": step, "tokens": toks, "wall_ms": wall,
                      "vision_ms": vis, "prefill_ms": pre, "decode_ms": dec,
                      "decode_ms_per_token": dec / max(len(toks) - 1, 1),
                      "logits_finite": made[0]["logits_finite"],
                      "kv_length": int(eng.cache.length[0]), **agree})
        if eng.envs[0].kv_length != int(eng.cache.length[0]):
            raise AssertionError(f"step {step}: KV length bookkeeping")
        resync(ref, eng, toks)
    return calls


def serve_family(torch, np, va, name, frames, instruction, counts, reset,
                 bits=16):
    """Phase 10b for one family: build_agent(None, name, bits) on the card;
    the three calls under "auto" against the same weights under "dense"
    (int4: dequantized to bf16), cosine > REF_MIN_COSINE each; exact K2
    launches (one per layer per call; none for alibi, which the
    reference's gate sends to dense attention), K1 at every tower pass,
    K6/K7 with int4 and no K8; vision, prefill, decode ms, ms per decoded
    token, weight GiB and peak memory. Returns (record, agent, dense
    engine): the caller frees them."""
    from streamvln_tpu_torch import configs, eval_cli
    from streamvln_tpu_torch.agent import VLNAgent
    from streamvln_tpu_torch.models import quant
    from streamvln_tpu_torch.streaming.engine import StreamingEngine
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with family_depth(configs, name):
        agent = eval_cli.build_agent(None, name, bits=bits)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    eng = agent.engine
    cfg = eng.cfg
    ref_params = quant.dequantize_llm(eng.params, eng.compute_dtype) \
        if bits == 4 else eng.params
    ref = StreamingEngine(ref_params, cfg, cache_capacity=eng.cache.capacity,
                          max_new_tokens=eng.max_new, stop_ids=eng.stop_ids,
                          spec_lookup=eng.spec_lookup, attn_impl="dense",
                          compute_dtype=eng.compute_dtype, device=eng.device)
    del ref_params
    ref_agent = VLNAgent(ref, agent.tok, deterministic_conjunction=False)
    calls = family_calls(torch, agent, ref_agent, frames, instruction,
                         reset)
    got, vit_batches = counts(), by_batch(va)
    L, Lv = cfg.llm.num_layers, cfg.vision.num_layers
    alibi = cfg.llm.positional == "alibi"
    rec = {"model_size": name, "bits": bits, "layers": L,
           "layers_published": configs.LLM_REGISTRY[name]().num_layers,
           "head_dim": cfg.llm.head_dim,
           "group": cfg.llm.num_heads // cfg.llm.num_kv_heads,
           "build_s": build_s, "calls": calls, "launches": got,
           "vit_launches_by_batch": vit_batches,
           "weights_gib": tree_bytes(eng.params["llm"]) / 2**30,
           "kv_cache_bytes": eng.cache.k.numel() * eng.cache.k.element_size()
           * 2, "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    log(f"10b {name}{' int4' if bits == 4 else ''} ({L} layers, head dim "
        f"{cfg.llm.head_dim}, G={rec['group']}): built in {build_s:.2f} s, "
        f"LLM weights {rec['weights_gib']:.3f} GiB, peak "
        f"{rec['peak_memory_bytes'] / 2**30:.2f} GiB; launches {got}")
    for c in calls:
        log(f"  step {c['step']}: vision {c['vision_ms']:.2f} prefill "
            f"{c['prefill_ms']:.2f} decode {c['decode_ms']:.2f} ms "
            f"({len(c['tokens'])} tokens, {c['decode_ms_per_token']:.2f} "
            f"ms/decoded token); auto vs dense cosine {c['cosine']:.6f} "
            f"top-1 agree {c['top1_agree']}")
    require(f"10b {name} bits {bits}",
            calls_made=len(calls) == len(FAMILY_STEPS),
            tokens_emitted=all(c["tokens"] for c in calls),
            finite_logits=all(c["logits_finite"] for c in calls),
            auto_matches_dense=all(c["cosine"] > REF_MIN_COSINE
                                   for c in calls),
            k2_once_per_layer_per_call=got["flash_attention"]
            == (0 if alibi else L * len(calls)),
            k1_every_tower_layer=got["vit_attention"] > 0
            and got["vit_attention"] % Lv == 0
            and sum(vit_batches.values()) == got["vit_attention"],
            int4_kernels=(got["int4_matmul"] > 0
                          and got["int4_dequant_split"] > 0)
            if bits == 4 else got["int4_matmul"] == 0,
            no_decode_kernel=got["decode_attention"] == 0)
    return rec, agent, ref


def family_decode_kernel(torch, name, agent, frames, instruction, counts,
                         reset):
    """Phase 10b, a family under attn_impl="decode_kernel": after a
    warm-up call (graph capture), one agent call (greedy, so that every
    decode forward has one query) with K8 at the family's shape exactly
    once per layer per fed token; then one more decode step from its
    cache through K8 and through the dense path (cosine >
    REF_MIN_COSINE)."""
    from streamvln_tpu_torch.agent import VLNAgent
    from streamvln_tpu_torch.streaming.engine import StreamingEngine
    src = agent.engine
    eng = StreamingEngine(src.params, src.cfg,
                          cache_capacity=src.cache.capacity,
                          max_new_tokens=src.max_new, stop_ids=src.stop_ids,
                          attn_impl="decode_kernel",
                          compute_dtype=src.compute_dtype, device=src.device)
    dk_agent = VLNAgent(eng, agent.tok)
    dk_agent.step(0, frames[0], instruction, run_model=True)   # capture
    dk_agent.reset_memory(0)
    torch.cuda.synchronize()
    made, restore = record_calls(torch, eng)
    reset()
    try:
        dk_agent.step(0, frames[0], instruction, run_model=True)
        torch.cuda.synchronize()
    finally:
        restore()
    got = counts()
    fed = fed_tokens(made)
    L = src.cfg.llm.num_layers
    agree = logits_agreement(torch, step_logits(torch, eng, "decode_kernel"),
                             step_logits(torch, eng, "dense"))
    vis, pre, dec = made[0]["phase_ms"]
    rec = {"tokens": made[0]["tokens"], "fed_tokens": fed, "launches": got,
           "vision_ms": vis, "prefill_ms": pre, "decode_ms": dec,
           "decode_ms_per_token": dec / max(fed, 1), "reference": agree}
    log(f"10b {name} decode_kernel: {fed} fed tokens, launches {got}; "
        f"decode {dec:.2f} ms ({rec['decode_ms_per_token']:.2f} ms/token); "
        f"a decode step through K8 vs dense: cosine {agree['cosine']:.6f}")
    require(f"10b {name} decode_kernel",
            k8_once_per_layer_per_fed_token=got["decode_attention"] == L * fed
            and fed > 0, agrees_with_dense=agree["cosine"] > REF_MIN_COSINE)
    del eng, dk_agent
    return rec


def moe_graphs_and_dispatch(torch, agent, frames, instruction):
    """Phase 10c on one MoE family: every decode and verify replay of a
    greedy and a speculative engine over 3 calls bit-equal to the eager
    step (graphs_vs_eager); then moe_dispatch="capacity" at capacity factor
    E/K (no token dropped) against the dense dispatch on the step-0 call
    (cosine > REF_MIN_COSINE), each engine's prefill timed on its second
    call."""
    import dataclasses

    from streamvln_tpu_torch.agent import VLNAgent
    from streamvln_tpu_torch.streaming.engine import StreamingEngine
    src = agent.engine
    rec = {"graphs": family_graphs(torch, agent, frames, instruction)}
    lc = src.cfg.llm
    cap = dataclasses.replace(src.cfg, llm=dataclasses.replace(
        lc, moe_dispatch="capacity",
        moe_capacity_factor=lc.num_experts / lc.num_experts_per_tok))
    out = {}
    for what, cfg in (("dense", src.cfg), ("capacity", cap)):
        eng = StreamingEngine(src.params, cfg,
                              cache_capacity=src.cache.capacity,
                              max_new_tokens=src.max_new,
                              stop_ids=src.stop_ids,
                              compute_dtype=src.compute_dtype,
                              device=src.device)
        a = VLNAgent(eng, agent.tok)
        prefill = []
        for _ in range(2):
            made, restore = record_calls(torch, eng)
            try:
                a.step(0, frames[0], instruction, run_model=True)
            finally:
                restore()
            prefill.append(made[0]["phase_ms"][1])
            a.reset_memory(0)
        out[what] = {"prefill_ms": prefill, "logits": eng.last_logits.float()}
        del a, eng
    agree = logits_agreement(torch, out["capacity"]["logits"],
                             out["dense"]["logits"])
    rec["capacity"] = {"factor": cap.llm.moe_capacity_factor,
                       "prefill_ms": out["capacity"]["prefill_ms"],
                       "dense_prefill_ms": out["dense"]["prefill_ms"],
                       **agree}
    log(f"10c {lc.num_experts} experts top-{lc.num_experts_per_tok}: "
        f"capacity dispatch at factor {cap.llm.moe_capacity_factor:g} vs "
        f"dense dispatch: cosine {agree['cosine']:.6f}; prefill "
        f"{out['capacity']['prefill_ms'][1]:.2f} vs "
        f"{out['dense']['prefill_ms'][1]:.2f} ms")
    require("10c capacity dispatch", agrees=agree["cosine"] > REF_MIN_COSINE)
    return rec


def family_graphs(torch, agent, frames, instruction):
    """graphs_vs_eager on a greedy and a speculative engine over the
    agent's weights (fresh engines: their graphs are captured here)."""
    from streamvln_tpu_torch.streaming.engine import StreamingEngine
    src = agent.engine
    engines = {f"spec{spec}": StreamingEngine(
        src.params, src.cfg, cache_capacity=src.cache.capacity,
        max_new_tokens=src.max_new, stop_ids=src.stop_ids, spec_lookup=spec,
        compute_dtype=src.compute_dtype, device=src.device)
        for spec in (0, 6)}
    rec = graphs_vs_eager(torch, engines, src.cfg, agent.tok, frames,
                          instruction, what=f"10c {src.cfg.llm.num_layers}"
                          f"-layer {src.cfg.llm.positional}", n_steps=9)
    del engines
    return rec


def pool_modes(torch, np, frames, instruction, counts, reset):
    """Phase 10d (pool modes): one streamvln_7b agent call (vision,
    prefill, decode) for each strided spatial_pool_mode, "average" and
    "max", on random bf16 weights from seed 0: 169 tokens a frame in the
    feature cache, the call's tokens and finite logits, K1 and K2 on the
    path, and the prefill logits against the same mode under "dense"
    (cosine > REF_MIN_COSINE)."""
    import dataclasses

    from streamvln_tpu_torch.agent import VLNAgent
    from streamvln_tpu_torch.configs import streamvln_7b
    from streamvln_tpu_torch.data.tokenizer import ByteTokenizer
    from streamvln_tpu_torch.models.fuse import fuse_projections
    from streamvln_tpu_torch.streaming.engine import StreamingEngine
    from streamvln_tpu_torch.weights import init
    tok = ByteTokenizer()
    params = fuse_projections(init(streamvln_7b(), torch.Generator(
        device="cuda").manual_seed(0), device="cuda"))
    out = {}
    for mode in ("average", "max"):
        cfg = dataclasses.replace(streamvln_7b(), spatial_pool_mode=mode)
        logits = {}
        for impl in ("auto", "dense"):
            eng = StreamingEngine(params, cfg, cache_capacity=4096,
                                  max_new_tokens=16,
                                  stop_ids=(tok.im_end_id,), attn_impl=impl)
            made, restore = record_calls(torch, eng)
            reset()
            try:
                VLNAgent(eng, tok).step(0, frames[0], instruction,
                                        run_model=True)
                torch.cuda.synchronize()
            finally:
                restore()
            logits[impl] = eng.last_logits.float()
            if impl == "auto":
                vis, pre, dec = made[0]["phase_ms"]
                r = {"tokens_per_frame": cfg.tokens_per_frame,
                     "feature_cache_tokens": eng.feat_cache.shape[2],
                     "tokens": made[0]["tokens"], "launches": counts(),
                     "kv_length": int(eng.cache.length[0]),
                     "vision_ms": vis, "prefill_ms": pre, "decode_ms": dec,
                     "logits_finite": made[0]["logits_finite"]}
            del eng
        r.update(logits_agreement(torch, logits["auto"], logits["dense"]))
        out[mode] = r
        log(f"10d spatial_pool_mode {mode}: {r['feature_cache_tokens']} "
            f"tokens a frame, {len(r['tokens'])} tokens, KV length "
            f"{r['kv_length']}; vision {vis:.2f} prefill {pre:.2f} decode "
            f"{dec:.2f} ms; launches {r['launches']}; auto vs dense cosine "
            f"{r['cosine']:.6f}")
        require(f"10d {mode}", tokens_per_frame_169=r["tokens_per_frame"]
                == r["feature_cache_tokens"] == 169,
                tokens_emitted=bool(r["tokens"]),
                finite_logits=r["logits_finite"],
                kernels_on_the_path=r["launches"]["vit_attention"] > 0
                and r["launches"]["flash_attention"] > 0,
                auto_matches_dense=r["cosine"] > REF_MIN_COSINE)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def header_found(include: str) -> bool:
    """Whether the host compiler finds `include` on its include path."""
    import shutil
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        return False
    src = f'extern "C" {{\n#include <{include}>\n}}\n'
    return subprocess.run([cxx, "-E", "-x", "c++", "-"], input=src,
                          capture_output=True, text=True).returncode == 0


def native_loader(np, tmp):
    """Phase 10d (the native loader): where jpeglib.h is on the host
    compiler's include path the JPEG library must build, its
    resize_batch_u8 stay within one 8-bit step of PIL's bicubic on 480x640
    frames (the reference test's bound; the count of differing values is
    reported), and load_preprocess_jpegs is timed per frame against the
    PIL loader on 8 JPEGs; where the libav headers are found the video
    library must build, and with cv2 at hand a written clip is probed and
    sampled. What was absent is printed."""
    from PIL import Image

    from streamvln_tpu_torch import native
    from streamvln_tpu_torch.ops.preprocess import preprocess_frames_host
    rec = {"jpeglib_h": header_found("jpeglib.h"),
           "libav_h": header_found("libavcodec/avcodec.h")}
    if rec["jpeglib_h"]:
        rec["built"] = native.available()
        require("10d native JPEG library", builds=rec["built"])
        fr = np.random.default_rng(5).integers(0, 256, (8, 480, 640, 3),
                                               np.uint8)
        out = native.resize_batch_u8(fr, 384)
        pil = np.stack([np.asarray(Image.fromarray(f).resize(
            (384, 384), Image.BICUBIC)) for f in fr])
        diff = np.abs(out.astype(int) - pil.astype(int))
        rec.update(resize_max_diff=int(diff.max()),
                   resize_values_differing=int((diff > 0).sum()),
                   resize_values=int(diff.size))
        paths = []
        for i, f in enumerate(fr):
            paths.append(os.path.join(tmp, f"f{i}.jpg"))
            Image.fromarray(f).save(paths[-1], quality=95)

        def pil_loader():
            return preprocess_frames_host(np.stack([np.asarray(
                Image.open(p).convert("RGB"), np.uint8) for p in paths]), 384)
        # each loader twice in turns; the second (warm) time is kept
        timed = {}
        for what, fn in (("native", lambda: native.load_preprocess_jpegs(
                paths, 384)), ("pil", pil_loader)) * 2:
            t0 = time.perf_counter()
            fn()
            timed[what] = (time.perf_counter() - t0) * 1e3 / len(paths)
        rec.update(native_ms_per_frame=timed["native"],
                   pil_ms_per_frame=timed["pil"])
        log(f"10d native JPEG library built; resize_batch_u8 vs PIL on "
            f"480x640 -> 384: max diff {rec['resize_max_diff']} "
            f"({rec['resize_values_differing']} of {rec['resize_values']} "
            f"values differ); load_preprocess_jpegs "
            f"{timed['native']:.3f} ms/frame vs PIL {timed['pil']:.3f}")
        require("10d resize_batch_u8", within_one_step_of_pil=diff.max() <= 1)
    else:
        log("10d jpeglib.h not on the host compiler's include path: the JPEG "
            "library was not built; the callers take PIL")
    if rec["libav_h"]:
        rec["video_built"] = native.video_available()
        require("10d native video library", builds=rec["video_built"])
        try:
            import cv2
        except ImportError:
            cv2 = None
        if cv2 is not None:
            path = os.path.join(tmp, "clip.mp4")
            wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10,
                                 (64, 48))
            for i in range(30):
                wr.write(np.full((48, 64, 3), i * 8 % 256, np.uint8))
            wr.release()
            rec["video_info"] = native.video_info(path)
            rec["video_sampled"] = list(native.video_sample_frames(
                path, frames_upbound=8, force_sample=True).shape)
            require("10d video decode", probed=rec["video_info"][3] == 30,
                    sampled=rec["video_sampled"] == [8, 48, 64, 3])
        clip = f"present: a clip probed {rec['video_info']}" \
            if cv2 is not None else "absent: no clip written"
        log(f"10d native video library built; cv2 {clip}")
    else:
        log("10d libav headers not on the host compiler's include path: the "
            "video library was not built; the callers take cv2")
    return rec


def families(torch, np, F, fa, da, va, frames, instruction, counts, reset,
             card, sizes=FAMILY_SIZES):
    """Phase 10: 10a the kernels at the families' shapes; 10b each family
    through the entry points' build_agent (qwen2-14b also with --bits 4,
    DECODE_KERNEL_FAMILIES also under decode_kernel); 10c the MoE
    (qwen2-moe-a2.7b) and alibi (mpt-7b) graph replays against eager, and
    the capacity dispatch;
    10d the strided pool modes and the native loader. Each family's agents
    are freed before the next is built, and the card's memory must return.
    Returns the phase's record."""
    import tempfile
    t_phase = time.perf_counter()
    rec = {"kernels": family_kernels(torch, F, fa, da), "families": [],
           "graphs": {}}
    gc.collect()
    torch.cuda.empty_cache()
    for name in sizes:
        for bits in ((16, 4) if name == "qwen2-14b" else (16,)):
            base = torch.cuda.memory_allocated()
            r, agent, ref = serve_family(torch, np, va, name, frames,
                                         instruction, counts, reset, bits)
            del ref
            if name in DECODE_KERNEL_FAMILIES and bits == 16:
                r["decode_kernel"] = family_decode_kernel(
                    torch, name, agent, frames, instruction, counts, reset)
            if name == "qwen2-moe-a2.7b":
                rec["graphs"][name] = moe_graphs_and_dispatch(
                    torch, agent, frames, instruction)
            if name == "mpt-7b":
                rec["graphs"][name] = {"graphs": family_graphs(
                    torch, agent, frames, instruction)}
            del agent
            gc.collect()
            torch.cuda.empty_cache()
            r["memory_after_bytes"] = torch.cuda.memory_allocated()
            r["memory_before_bytes"] = base
            rec["families"].append(r)
            require(f"10b {name}: its memory returns",
                    freed=r["memory_after_bytes"] <= base
                    + FAMILY_MEMORY_SLACK)
    rec["pool_modes"] = pool_modes(torch, np, frames, instruction, counts,
                                   reset)
    with tempfile.TemporaryDirectory() as tmp:
        rec["native"] = native_loader(np, tmp)
    rec["seconds"] = time.perf_counter() - t_phase
    log(families_summary(rec, card))
    return rec


# phase 11: the vision tail and the offline tools. 11a holds K1 at the
# encoder zoo's and anyres's (B, S, H, D) against its plain version:
# EVA01-CLIP-g (88), CLIP/MLCD-bigG (104), CLIP-L and EVA02 (64; S2's 1, 4
# and 9 crops), anyres's SigLIP batches of thumbnail and tiles (72)
VIT_ZOO_SHAPES = ((1, 257, 16, 88), (1, 257, 16, 104), (1, 577, 16, 104),
                  (1, 577, 16, 64), (4, 577, 16, 64), (9, 577, 16, 64),
                  (1, 197, 12, 64), (3, 729, 16, 72), (4, 729, 16, 72),
                  (5, 729, 16, 72))
# 11b: each tower at its published depth and width, one frame at its
# image size; the CLIP-L weights also serve S2 (336/672/1008)
ZOO_TOWERS = ("openai/clip-vit-large-patch14-336",
              "DeepGlint-AI/mlcd-vit-bigG-patch14-336",
              "laion/CLIP-ViT-bigG-14-laion2B-39B-b160k", "EVA01-CLIP-g-14",
              "EVA02-CLIP-L-14-336", "EVA02-CLIP-B-16")
S2_SCALES = (336, 672, 1008)
# a tower's weights freed must give the card's memory back within this
ZOO_MEMORY_SLACK = 64 * 2**20
# 11c: anyres on the 7B agent, one 480x640 (2x2 tiles) and one 384x1152
# (3x1 tiles) image, and the question the offline entries ask
ANYRES_IMAGES = ((480, 640), (384, 1152))
ANYRES_QUESTION = "Describe the scene and say where the door is."
VISION_TAIL_EPISODES = {"dagger": 2, "trajectories": 4}


def padded_head_dim(D: int) -> int:
    """The head dim K1's instance computes at (csrc/vit_attention.cu)."""
    return 64 if D <= 64 else 80 if D <= 80 else 96 if D <= 96 else \
        112 if D <= 112 else 128


def check_flash_uncached(torch, F, fa, S, Hq=28, Hkv=4, D=128, seed=3):
    """K2 as anyres's uncached full recompute runs it: S queries over the
    same S keys (no cache, q_pos = k_pos = 0..S-1), Qwen2-7B's heads,
    against its plain version at phase 2's tolerance; timed with causal
    SDPA on the settled yardstick (graph_ms over operand copies past the
    L2 cache), and by device time beside the plain version."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((1, S, Hq, D), generator=g, device="cuda") \
        .to(torch.bfloat16)
    k, v = (torch.randn((1, S, Hkv, D), generator=g, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    pos = torch.arange(S, device="cuda", dtype=torch.int32)[None] \
        .contiguous()
    out = fa.flash_attention(q, k, v, pos, pos)
    torch.cuda.synchronize()
    c = compare(out, fa.flash_attention_plain(q, k, v, pos, pos), torch.where(
        (pos + 1 < FEW_KEYS)[:, :, None, None],   # query p sees p + 1 keys
        2.0 ** -8 * fa.flash_attention_plain(q, k, v.abs(), pos, pos)
        .float(), 0.0))
    c["queries_seeing_few_keys"] = min(S, FEW_KEYS - 1)

    def kernel():
        return fa.flash_attention(q, k, v, pos, pos)
    ms, event_ms = device_ms(torch, [kernel]), time_ms(torch, kernel)
    plain = time_ms(torch, lambda: fa.flash_attention_plain(q, k, v, pos,
                                                            pos), iters=3)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)
    lib = device_ms(torch, [sdpa])
    pairs = S * (S + 1) // 2
    nbytes = 2 * (2 * S * Hq * D + 2 * S * Hkv * D) + 8 * S
    b_ms, b_by = bound(4.0 * pairs * D * Hq, nbytes)
    shape = f"Sq=Sk={S} Hq={Hq} Hkv={Hkv} D={D} uncached (anyres) bf16"
    n = _copies(nbytes)
    ops = [(q, k, v)] + [tuple(x.clone() for x in (q, k, v))
                         for _ in range(n - 1)]
    lops = [(qt, kt, vt)] + [tuple(x.transpose(1, 2).contiguous()
                                   for x in o) for o in ops[1:]]
    graphs, graph_line = graph_pair(
        torch, [(lambda o=o: fa.flash_attention(*o, pos, pos)) for o in ops],
        [(lambda o=o: F.scaled_dot_product_attention(
            *o, is_causal=True, enable_gqa=True)) for o in lops],
        b_ms, f"K2 at {shape}")
    del ops, lops
    rec = {"shape": shape, "batch": 1, **c, "ms": ms, "event_ms": event_ms,
           "plain_ms": plain, "library_ms": lib, "bound_ms": b_ms,
           "bound_by": b_by, **graphs, "rotation": n}
    log(f"11c K2 flash_attention {rec['shape']}: {tol_text(c)} "
        f"{graph_line} ({n} copies); kernel "
        f"{ms:.4f} ms device ({event_ms:.4f} event-timed) plain {plain:.4f} "
        f"ms causal sdpa {lib:.4f} ms device bound {b_ms:.4f} ms ({b_by})")
    if not c["tol_share"] <= 1.0:
        raise AssertionError(f"flash_attention (uncached) disagrees: {c}")
    return rec


def clip_state_dict(params, cfg) -> dict:
    """A transformers CLIPVisionModel state dict made on the card from the
    port's CLIP tower (the inverse of convert_hf_clip_tower)."""
    pre = "vision_model."
    D, P = cfg.hidden_size, cfg.patch_size
    sd = {pre + "embeddings.patch_embedding.weight":
          params["patch_w"].t().reshape(D, 3, P, P).contiguous(),
          pre + "embeddings.class_embedding": params["cls_embed"],
          pre + "pre_layrnorm.weight": params["pre_ln_s"],
          pre + "pre_layrnorm.bias": params["pre_ln_b"]}
    if cfg.rope2d:
        sd[pre + "class_pos_emb"] = params["class_pos_emb"][None]
    else:
        sd[pre + "embeddings.position_embedding.weight"] = \
            params["pos_embed"]
    names = (("ln1", "layer_norm1"), ("q", "self_attn.q_proj"),
             ("k", "self_attn.k_proj"), ("v", "self_attn.v_proj"),
             ("o", "self_attn.out_proj"), ("ln2", "layer_norm2"),
             ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2"))
    p = params["layers"]
    for i in range(cfg.num_layers):
        lp = f"{pre}encoder.layers.{i}."
        for ours, theirs in names:
            w = p[ours + "_s"][i] if ours.startswith("ln") \
                else p[ours + "_w"][i].t().contiguous()
            sd[lp + theirs + ".weight"] = w
            sd[lp + theirs + ".bias"] = p[ours + "_b"][i]
    return sd


def eva_state_dict(params, cfg) -> dict:
    """An EVA-CLIP visual state dict made on the card from the port's EVA
    tower (the inverse of convert_eva_tower)."""
    import torch
    D, P = cfg.hidden_size, cfg.patch_size
    sd = {"patch_embed.proj.weight":
          params["patch_w"].t().reshape(D, 3, P, P).contiguous(),
          "patch_embed.proj.bias": params["patch_b"],
          "cls_token": params["cls_embed"].reshape(1, 1, D),
          "pos_embed": params["pos_embed"][None]}
    names = [("ln1_s", "norm1.weight"), ("ln1_b", "norm1.bias"),
             ("q_b", "attn.q_bias"), ("v_b", "attn.v_bias"),
             ("o_w", "attn.proj.weight"), ("o_b", "attn.proj.bias"),
             ("ln2_s", "norm2.weight"), ("ln2_b", "norm2.bias")]
    names += [("q_w", "attn.q_proj.weight"), ("k_w", "attn.k_proj.weight"),
              ("v_w", "attn.v_proj.weight"),
              ("attn_ln_s", "attn.inner_attn_ln.weight"),
              ("attn_ln_b", "attn.inner_attn_ln.bias"),
              ("ffn_ln_s", "mlp.ffn_ln.weight"),
              ("ffn_ln_b", "mlp.ffn_ln.bias")] if cfg.subln else []
    mlp = ("w1", "w2", "w3") if cfg.swiglu else ("fc1", "fc2")
    names += [(m + s, f"mlp.{m}.{t}") for m in mlp
              for s, t in (("_w", "weight"), ("_b", "bias"))]
    names += [("gamma_1", "gamma_1"), ("gamma_2", "gamma_2")] \
        if cfg.layer_scale else []
    p = params["layers"]
    for i in range(cfg.num_layers - 1):
        if not cfg.subln:       # EVA01's fused qkv
            sd[f"blocks.{i}.attn.qkv.weight"] = torch.cat(
                [p[n][i].t() for n in ("q_w", "k_w", "v_w")]).contiguous()
        for ours, theirs in names:
            w = p[ours][i]
            sd[f"blocks.{i}.{theirs}"] = w.t().contiguous() \
                if ours.endswith("_w") else w
    return sd


def tree_equal(a, b) -> bool:
    if isinstance(a, dict):
        return set(a) == set(b) and all(tree_equal(a[k], b[k]) for k in a)
    return a.dtype == b.dtype and a.shape == b.shape and bool((a == b).all())


def zoo_tower(torch, va, name, counts, reset, s2_params=None):
    """11b for one tower: built through build_vision_tower with random bf16
    weights from seed 0 on the card, one frame at its image size under
    "auto" (K1 at every block) and "dense", the selected features' cosine,
    ms per image, weight GiB and peak memory; with `s2_params` the S2
    wrapper over those weights (K1 at 1, 4 and 9 crops). Returns (record,
    params)."""
    from streamvln_tpu_torch.models import encoders
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    s2 = s2_params is not None
    cfg, init_fn, fwd = encoders.build_vision_tower(
        name, s2=s2, s2_scales=S2_SCALES)
    params = s2_params if s2 else init_fn(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda",
        dtype=torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(1)
    S = cfg.image_size
    images = torch.randn((1, S, S, 3), generator=g, device="cuda") \
        .to(torch.bfloat16)
    with torch.no_grad():
        reset()
        va.launches_by_shape = {}
        out = fwd(params, images, attn_impl="auto")
        torch.cuda.synchronize()
        got, shapes = counts(), dict(va.launches_by_shape)
        ref = fwd(params, images, attn_impl="dense")
        ms = time_ms(torch, lambda: fwd(params, images), iters=5, warmup=1)
        dev_ms = device_ms(torch, [lambda: fwd(params, images)], calls=5)
    a, b = out.float().flatten(), ref.float().flatten()
    cos = torch.nn.functional.cosine_similarity(a, b, dim=0).item()
    tok_cos = torch.nn.functional.cosine_similarity(
        out.float(), ref.float(), dim=-1).min().item()
    blocks = cfg.num_layers - 1       # select_layer -2 / EVA's skipped last
    per_fwd = blocks * (len(S2_SCALES) if s2 else 1)
    N1 = cfg.num_patches + 1
    want_shapes = {((s // S) ** 2, N1, cfg.num_heads, cfg.head_dim): blocks
                   for s in (S2_SCALES if s2 else (S,))}
    rec = {"tower": name + (" S2 " + "/".join(map(str, S2_SCALES))
                            if s2 else ""),
           "layers_run": blocks, "hidden": cfg.hidden_size,
           "heads": cfg.num_heads, "head_dim": cfg.head_dim,
           "padded_head_dim": padded_head_dim(cfg.head_dim), "tokens": N1,
           "image_size": S, "features": list(out.shape),
           "cosine_vs_dense": cos, "min_token_cosine_vs_dense": tok_cos,
           "ms_per_image": ms, "device_ms_per_image": dev_ms,
           "weights_gib": tree_bytes(params) / 2**30,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "launches": got, "vit_launches_by_shape": {
               f"B={k[0]} S={k[1]} H={k[2]} D={k[3]}": n
               for k, n in sorted(shapes.items())},
           "shapes": sorted(shapes)}
    log(f"11b {rec['tower']}: {blocks} blocks, {cfg.num_heads}x"
        f"{cfg.head_dim} (K1 at {rec['padded_head_dim']}), S={N1}, features "
        f"{rec['features']}; {ms:.3f} ms/image ({dev_ms:.3f} of it on the "
        f"device), weights "
        f"{rec['weights_gib']:.3f} GiB, peak "
        f"{rec['peak_memory_bytes'] / 2**30:.2f} GiB; auto vs dense cosine "
        f"{cos:.6f} (least token {tok_cos:.5f}); K1 {rec['vit_launches_by_shape']}")
    require(f"11b {rec['tower']}",
            finite=bool(torch.isfinite(out).all()),
            feature_shape=list(out.shape) == [
                1, cfg.num_patches, cfg.hidden_size
                * (len(S2_SCALES) if s2 else 1)],
            auto_matches_dense=cos >= REF_MIN_COSINE,
            k1_at_every_block=got["vit_attention"] == per_fwd
            and shapes == want_shapes,
            no_other_kernel=got["flash_attention"] == 0)
    return rec, params


def resampler_on_card(torch, name, **kw):
    """11b: a perceiver or qformer resampler on SigLIP's [8, 729, 1152]
    features in bf16 (dense attention, no kernel, as the reference), its
    output against the same weights and features in f32."""
    from streamvln_tpu_torch.models import resampler
    init, apply = resampler.build_resampler(name, **kw)
    g = torch.Generator(device="cuda").manual_seed(0)
    params = init(1152, g, device="cuda", dtype=torch.bfloat16)
    feats = torch.randn((8, 729, 1152), generator=g, device="cuda") \
        .to(torch.bfloat16)
    with torch.no_grad():
        out = apply(params, feats)
        ref = apply(tree_map(lambda t: t.float(), params), feats.float())
        ms = time_ms(torch, lambda: apply(params, feats), iters=5, warmup=1)
    cos = torch.nn.functional.cosine_similarity(
        out.float().flatten(), ref.flatten(), dim=0).item()
    rec = {"resampler": name, "output": list(out.shape), "ms": ms,
           "cosine_vs_f32": cos, "weights_gib": tree_bytes(params) / 2**30}
    log(f"11b {name} resampler [8, 729, 1152] -> {rec['output']}: {ms:.3f} "
        f"ms, bf16 vs f32 cosine {cos:.6f}")
    require(f"11b {name}", finite=bool(torch.isfinite(out).all()),
            bf16_matches_f32=cos >= REF_MIN_COSINE)
    return rec


def zoo(torch, va, counts, reset):
    """11b: every tower of ZOO_TOWERS (and CLIP-L under S2), each freed
    before the next is built with the card's memory back within
    ZOO_MEMORY_SLACK; the two converters round-tripped bit for bit on state
    dicts made on the card from CLIP-L's and EVA02-B's own weights; the
    perceiver and qformer resamplers."""
    from streamvln_tpu_torch.models import encoders
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    towers, shapes, conversions = [], set(), {}
    for name in ZOO_TOWERS:
        rec, params = zoo_tower(torch, va, name, counts, reset)
        towers.append(rec)
        shapes |= set(rec["shapes"])
        cfg = encoders.build_vision_tower(name)[0]
        if name.startswith("openai"):
            rec = zoo_tower(torch, va, name, counts, reset, params)[0]
            towers.append(rec)
            shapes |= set(rec["shapes"])
        if name in ("openai/clip-vit-large-patch14-336", "EVA02-CLIP-B-16"):
            eva = isinstance(cfg, encoders.EvaVisionConfig)
            sd = (eva_state_dict if eva else clip_state_dict)(params, cfg)
            conv = encoders.convert_eva_tower if eva \
                else encoders.convert_hf_clip_tower
            back = conv(sd, cfg, dtype=torch.bfloat16, device="cuda")
            conversions[conv.__name__] = {
                "tower": name, "tensors": len(sd),
                "bit_equal": tree_equal(back, params)}
            log(f"11b {conv.__name__} on {name}'s weights ({len(sd)} "
                f"tensors on the card): round trip bit-equal "
                f"{conversions[conv.__name__]['bit_equal']}")
            del sd, back
        del params
        gc.collect()
        torch.cuda.empty_cache()
        left = torch.cuda.memory_allocated() - base
        towers[-1]["memory_left_bytes"] = left
        log(f"11b {name} freed: {left / 2**20:.1f} MiB left on the card")
        require(f"11b {name}: freed", memory_back=left <= ZOO_MEMORY_SLACK)
    require("11b converters", **{k: v["bit_equal"]
                                 for k, v in conversions.items()})
    res = [resampler_on_card(torch, "perceiver"),
           resampler_on_card(torch, "qformer")]
    return {"towers": towers, "conversions": conversions,
            "resamplers": res, "vit_shapes": sorted(shapes)}


@contextlib.contextmanager
def shared_agent(eval_cli, agent, box):
    """While open, eval_cli.build_agent hands out `agent` (the entry points
    share the phase's one 7B agent) and records each request's args in
    box["builds"]."""
    build0 = eval_cli.build_agent
    box.setdefault("builds", [])

    def build_agent(*a, **k):
        box["builds"].append({"args": [str(x) for x in a],
                              **{n: str(v) for n, v in k.items()}})
        return agent
    eval_cli.build_agent = build_agent
    try:
        yield box
    finally:
        eval_cli.build_agent = build0


def anyres_on_card(torch, np, va, agent, counts, reset):
    """11c: generate_anyres on the 7B agent's weights for each image of
    ANYRES_IMAGES: the first step's logits under "auto" within cosine
    REF_MIN_COSINE of "dense", K1 once per tower layer at the tile batch and
    K2 once per layer per generated token, ms per generated token."""
    from streamvln_tpu_torch.data import chatml
    from streamvln_tpu_torch.models import anyres
    eng, cfg, tok = agent.engine, agent.cfg, agent.tok
    params = eng.params
    ids, _ = chatml.tokenize_dialogue(
        tok, [("user", "<image>\n" + ANYRES_QUESTION)], add_system=True,
        with_labels=False)
    ids = np.concatenate([ids, np.asarray(chatml.generation_prompt(tok),
                                          np.int32)])
    rng = np.random.default_rng(0)
    recs = []
    for h, w in ANYRES_IMAGES:
        image = rng.integers(0, 256, (h, w, 3), np.uint8)
        npw, nph = anyres.get_anyres_image_grid_shape(
            (w, h), anyres.DEFAULT_GRID_PINPOINTS, cfg.vision.image_size)
        n_tok = anyres.anyres_token_count(
            (w, h), anyres.DEFAULT_GRID_PINPOINTS, cfg.vision.image_size,
            cfg.vision.patches_per_side)
        with torch.no_grad():
            logits = {}
            for impl in ("auto", "dense"):
                feats = anyres.encode_anyres(params, cfg, image,
                                             attn_impl=impl)
                logits[impl] = anyres.anyres_logits(params, cfg, feats, ids,
                                                    n_tok, impl)
            del feats
            torch.cuda.synchronize()
            agree = logits_agreement(torch, logits["auto"][None],
                                     logits["dense"][None])
            t0 = time.perf_counter()
            anyres.encode_anyres(params, cfg, image)
            torch.cuda.synchronize()
            encode_s = time.perf_counter() - t0
        reset()
        va.launches_by_shape = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = anyres.generate_anyres(params, cfg, tok, image, ids,
                                     max_new=eng.max_new,
                                     stop_ids=eng.stop_ids)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        got, shapes = counts(), dict(va.launches_by_shape)
        tiles = npw * nph + 1
        Sq = len(ids) - 1 + n_tok
        rec = {"image_hw": [h, w], "tiles": [nph, npw], "tile_batch": tiles,
               "image_tokens": n_tok, "prompt_ids": len(ids),
               "first_sq": Sq, "last_sq": Sq + len(out) - 1,
               "tokens": out, "launches": got,
               "vit_shapes": sorted(shapes), "encode_ms": encode_s * 1e3,
               "generate_s": gen_s,
               "ms_per_generated_token": (gen_s - encode_s) * 1e3 / len(out),
               **{f"first_logits_{k}": v for k, v in agree.items()}}
        log(f"11c anyres {h}x{w}: {nph}x{npw} tiles + thumbnail (K1 batch "
            f"{tiles}), {n_tok} image tokens, Sq {Sq}..{rec['last_sq']}; "
            f"{len(out)} tokens in {gen_s:.2f} s ({encode_s * 1e3:.1f} ms "
            f"encode, {rec['ms_per_generated_token']:.2f} ms per generated "
            f"token); first-step logits auto vs dense cosine "
            f"{agree['cosine']:.6f} top-1 agree {agree['top1_agree']}; "
            f"launches {got}")
        require(f"11c anyres {h}x{w}",
                tokens=1 <= len(out) <= eng.max_new,
                first_logits_match_dense=agree["cosine"] >= REF_MIN_COSINE,
                k1_once_per_layer_at_the_tile_batch=got["vit_attention"]
                == cfg.vision.num_layers and set(shapes) == {
                    (tiles, cfg.vision.num_patches, cfg.vision.num_heads,
                     cfg.vision.head_dim)},
                k2_once_per_layer_per_token=got["flash_attention"]
                == cfg.llm.num_layers * len(out),
                no_other_kernel=got["decode_attention"] == 0
                and got["int4_matmul"] == 0)
        recs.append(rec)
    return recs


def write_jpegs(np, d, frames):
    from PIL import Image
    os.makedirs(d, exist_ok=True)
    for i, f in enumerate(frames):
        Image.fromarray(f).save(os.path.join(d, f"{i:03d}.jpg"))


def offline_and_benchmark(torch, np, va, agent, counts, reset, tmp):
    """11c: offline.main over 2 square video entries (3 frames each) and 2
    anyres images under --image_aspect_ratio anyres; benchmark.main in
    process over 2 tasks of 3 entries (multiple choice, contains); both on
    the shared 7B agent. Then run_external_benchmark: one task in a child
    process at --model_size 0.5b on cuda, which must report the card."""
    from streamvln_tpu_torch import eval_cli
    from streamvln_tpu_torch.eval import benchmark, offline
    rng = np.random.default_rng(1)
    media = os.path.join(tmp, "media")
    for v in ("v0", "v1"):
        write_jpegs(np, os.path.join(media, v),
                    rng.integers(0, 256, (3, 480, 640, 3), np.uint8))
    for i, (h, w) in enumerate(ANYRES_IMAGES):
        write_jpegs(np, os.path.join(media, f"img{i}"),
                    rng.integers(0, 256, (1, h, w, 3), np.uint8))
    q = {"from": "human", "value": "<image>\n" + ANYRES_QUESTION}
    entries = [{"id": "v0", "video": "v0", "conversations": [q]},
               {"id": "v1", "video": "v1", "conversations": [q]},
               {"id": "i0", "image": "img0/000.jpg", "conversations": [q]},
               {"id": "i1", "image": "img1/000.jpg", "conversations": [q]}]
    qfile = os.path.join(tmp, "questions.json")
    with open(qfile, "w") as f:
        json.dump(entries, f)
    answers_file = os.path.join(tmp, "answers.jsonl")
    box = {}
    rec = {}
    with shared_agent(eval_cli, agent, box):
        reset()
        t0 = time.perf_counter()
        answers = offline.main(["--question_file", qfile, "--media_root",
                                media, "--answers_file", answers_file,
                                "--num_frames_qa", "3",
                                "--image_aspect_ratio", "anyres"])
        torch.cuda.synchronize()
        rec["offline"] = {"seconds": time.perf_counter() - t0,
                          "answered": len(answers), "launches": counts(),
                          "answer_s": [a["answer_time"] for a in answers]}
        lines = [json.loads(x) for x in open(answers_file)]
        for t, (kind, answer) in enumerate((("multiple_choice", "B"),
                                            ("contains", "door"))):
            with open(os.path.join(tmp, f"task{t}.jsonl"), "w") as f:
                for i in range(3):
                    e = {"id": i, "question": f"{ANYRES_QUESTION} A. left "
                         f"B. right", "answer": answer, "answer_type": kind}
                    if i < 2:
                        e["image"] = f"v{i}/000.jpg"
                    f.write(json.dumps(e) + "\n")
        reset()
        t0 = time.perf_counter()
        out_dir = os.path.join(tmp, "bench")
        res = benchmark.main(["--tasks", "task0,task1", "--task_dir", tmp,
                              "--media_root", media, "--output_path",
                              out_dir])
        torch.cuda.synchronize()
        rec["benchmark"] = {"seconds": time.perf_counter() - t0,
                            "results": res, "launches": counts()}
    samples = [sum(1 for _ in open(os.path.join(out_dir,
                                                f"samples_task{t}.jsonl")))
               for t in (0, 1)]
    rec["builds"] = box["builds"]
    log(f"11c offline.main: {len(answers)} answers in "
        f"{rec['offline']['seconds']:.2f} s (per entry "
        f"{[round(x, 3) for x in rec['offline']['answer_s']]} s), launches "
        f"{rec['offline']['launches']}; benchmark.main: {res['results']} in "
        f"{rec['benchmark']['seconds']:.2f} s, launches "
        f"{rec['benchmark']['launches']}")
    require("11c offline and benchmark in process",
            every_entry_answered=len(answers) == len(lines) == 4
            and [a["question_id"] for a in lines] == [e["id"]
                                                      for e in entries],
            answers_are_text=all(isinstance(a["text"], str) for a in lines),
            results_hold_every_entry=[res["results"][f"task{t}"]["n"]
                                      for t in (0, 1)] == [3.0, 3.0]
            and samples == [3, 3] and res["device"] == "cuda",
            one_agent=len(box["builds"]) == 2,
            k1_and_k2_ran=rec["offline"]["launches"]["vit_attention"] > 0
            and rec["offline"]["launches"]["flash_attention"] > 0)
    # the child: a fresh process on the card, its own 0.5b weights
    t0 = time.perf_counter()
    child_dir = os.path.join(tmp, "child")
    flat = benchmark.run_external_benchmark(
        tasks="task0", task_dir=tmp, output_path=child_dir,
        model_size="0.5b", media_root=media, device="cuda")
    with open(os.path.join(child_dir, "results.json")) as f:
        payload = json.load(f)
    rec["external"] = {"seconds": time.perf_counter() - t0, "flat": flat,
                       "device": payload.get("device")}
    log(f"11c run_external_benchmark (child at 0.5b): {flat} on "
        f"{payload.get('device')} in {rec['external']['seconds']:.2f} s")
    require("11c run_external_benchmark",
            child_on_the_card=payload.get("device") == "cuda",
            metrics=set(flat) == {"task0_accuracy"},
            every_entry=payload["results"]["task0"]["n"] == 3.0)
    return rec


ANNOTATION_KEYS = {"id": int, "video": str, "instructions": list,
                   "actions": list}


def annotations_ok(root, anns) -> bool:
    """The reference's annotation schema: {id, video, instructions,
    actions}, a leading -1 action, one 1-based JPEG per action."""
    for a in anns:
        if set(a) != set(ANNOTATION_KEYS) or not all(
                isinstance(a[k], t) for k, t in ANNOTATION_KEYS.items()):
            return False
        jpgs = sorted(os.listdir(os.path.join(root, a["video"], "rgb")))
        if a["actions"][0] != -1 or jpgs[:1] != ["001.jpg"] \
                or len(jpgs) != len(a["actions"]):
            return False
    return True


def dagger_and_trajectories(torch, agent, counts, reset, tmp):
    """11d: dagger.main over VISION_TAIL_EPISODES["dagger"] fake-env
    episodes at data_iteration 1 on the shared 7B agent, and
    trajectory_generation.main over VISION_TAIL_EPISODES["trajectories"]
    episodes then merge; annotation schemas, the save gate's decision of
    every episode, episodes per minute."""
    from streamvln_tpu_torch import dagger, eval_cli, trajectory_generation
    box = {}
    out = os.path.join(tmp, "dagger")
    n_d = VISION_TAIL_EPISODES["dagger"]
    with shared_agent(eval_cli, agent, box):
        reset()
        t0 = time.perf_counter()
        col = dagger.main(["--output_path", out, "--model_size", "7b",
                           "--num_episodes", str(n_d), "--dagger_data_it",
                           "1", "--env_backend", "fake"])
        torch.cuda.synchronize()
        d_s = time.perf_counter() - t0
    anns = json.load(open(os.path.join(out, "annotations.json")))
    rec = {"dagger": {"seconds": d_s, "episodes_per_minute": n_d / d_s * 60,
                      "decisions": col.decisions, "saved": len(anns),
                      "launches": counts(), "builds": box["builds"]}}
    out_t = os.path.join(tmp, "trajectories")
    n_t = VISION_TAIL_EPISODES["trajectories"]
    t0 = time.perf_counter()
    trajectory_generation.main(["--output_path", out_t, "--num_episodes",
                                str(n_t), "--env_backend", "fake"])
    t_s = time.perf_counter() - t0
    merged = json.load(open(os.path.join(out_t, "annotations.json")))
    rec["trajectories"] = {"seconds": t_s,
                           "episodes_per_minute": n_t / t_s * 60,
                           "episodes": len(merged),
                           "actions": [len(a["actions"]) for a in merged]}
    log(f"11d dagger.main: {n_d} episodes in {d_s:.2f} s "
        f"({rec['dagger']['episodes_per_minute']:.2f} episodes/min), "
        f"decisions {[(d['saved'], round(d['pl'], 3)) for d in col.decisions]}"
        f", {len(anns)} saved, launches {rec['dagger']['launches']}; "
        f"trajectory_generation.main: {len(merged)} episodes in {t_s:.2f} s "
        f"({rec['trajectories']['episodes_per_minute']:.1f} episodes/min)")
    require("11d dagger and trajectories",
            gate_decided_every_episode=len(col.decisions) == n_d,
            saved_as_decided=len(anns) == sum(d["saved"]
                                              for d in col.decisions),
            dagger_schema=annotations_ok(out, anns),
            model_ran=rec["dagger"]["launches"]["vit_attention"] > 0,
            trajectories_merged=len(merged) == n_t,
            trajectory_schema=annotations_ok(out_t, merged)
            and all(0 not in a["actions"] for a in merged))
    return rec


def vision_tail(torch, np, F, va, fa, counts, reset, card):
    """Phase 11: 11a K1 at VIT_ZOO_SHAPES against its plain version, and K2
    at anyres's uncached prefill; 11b the zoo and the resamplers; 11c
    anyres, offline.main, benchmark.main and run_external_benchmark on one
    shared streamvln_7b agent; 11d dagger.main and
    trajectory_generation.main. Everything written goes under
    tempfile.gettempdir() and is removed. Returns the phase's record, with
    the K1 shapes every sub-phase sent (vit_shapes)."""
    import shutil
    import tempfile

    from streamvln_tpu_torch import eval_cli
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    vit = [check_vit(torch, F, va, B, S=S, H=H, D=D)
           for B, S, H, D in VIT_ZOO_SHAPES]
    rec = {"vit": vit, "zoo": zoo(torch, va, counts, reset)}
    shapes = set(rec["zoo"]["vit_shapes"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    agent = eval_cli.build_agent(None, "7b")
    torch.cuda.synchronize()
    rec["agent_build_s"] = time.perf_counter() - t0
    rec["anyres"] = anyres_on_card(torch, np, va, agent, counts, reset)
    shapes |= {tuple(s) for r in rec["anyres"] for s in r["vit_shapes"]}
    rec["flash"] = [check_flash_uncached(torch, F, fa, r["first_sq"])
                    for r in rec["anyres"]]
    tmp = tempfile.mkdtemp(prefix="vision_tail_",
                           dir=tempfile.gettempdir())
    try:
        va.launches_by_shape = {}
        rec["entry_points"] = offline_and_benchmark(torch, np, va, agent,
                                                    counts, reset, tmp)
        rec["tools"] = dagger_and_trajectories(torch, agent, counts, reset,
                                               tmp)
        shapes |= set(va.launches_by_shape)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec["peak_memory_bytes_7b"] = torch.cuda.max_memory_allocated()
    del agent
    gc.collect()
    torch.cuda.empty_cache()
    rec["vit_shapes"] = sorted(shapes)
    rec["seconds"] = time.perf_counter() - t_phase
    log(f"phase 11 ({card}): {rec['seconds']:.1f} s; K1 shapes sent "
        f"{rec['vit_shapes']}")
    return rec


def vision_tail_summary(rec, card) -> str:
    """Phase 11 on one line, beside the card's name and power limit."""
    towers = "; ".join(f"{t['tower']} {t['ms_per_image']:.2f} ms/image "
                       f"(cos {t['cosine_vs_dense']:.4f})"
                       for t in rec["zoo"]["towers"])
    anyres = "; ".join(f"{'x'.join(map(str, r['image_hw']))} "
                       f"{r['ms_per_generated_token']:.1f} ms/token "
                       f"({r['image_tokens']} image tokens)"
                       for r in rec["anyres"])
    tools = rec["tools"]
    return (f"phase 11 vision tail ({card}): {towers}; anyres {anyres}; "
            f"dagger {tools['dagger']['episodes_per_minute']:.2f} "
            f"episodes/min, trajectories "
            f"{tools['trajectories']['episodes_per_minute']:.1f} "
            f"episodes/min; {rec['seconds']:.1f} s")


def families_summary(rec, card) -> str:
    """Phase 10 on one line, beside the card's name and power limit."""
    parts = []
    for r in rec["families"]:
        c = r["calls"]
        dk = r.get("decode_kernel")
        dk = f" (decode_kernel {dk['decode_ms_per_token']:.2f})" if dk \
            else ""
        parts.append(
            f"{r['model_size']}{' int4' if r['bits'] == 4 else ''} prefill "
            f"{statistics.median(x['prefill_ms'] for x in c):.1f} ms, "
            f"{statistics.median(x['decode_ms_per_token'] for x in c):.2f} "
            f"ms/token{dk}, {r['weights_gib']:.1f} GiB, min cosine "
            f"{min(x['cosine'] for x in c):.4f}")
    return (f"phase 10 families ({card}): " + "; ".join(parts)
            + f"; {rec['seconds']:.1f} s")


# ---------------------------------------------------------------------------
# Phase 12: the last modules (the mesh, ring attention, DPO, reward/PPO,
# DDPO) and Gemma's training backward (K4/K5 at head dim 256)
# ---------------------------------------------------------------------------

# 12a: micro-steps of the training command on gemma-2b
GEMMA_STEPS = 3
# 12a: the loss through the kernels against attn_impl="chunked", absolute
GEMMA_LOSS_ATOL = 1e-2
# 12a: at random weights Gemma's LoRA gradients part between two f32
# attention paths already (chunked and dense agree to cosine ~0.994 on an
# H100, where streamvln_7b's through the kernels agree with dense to
# ~0.99999, phase 4b); the kernels' bf16 rounding of P (K3, K4/K5) and dS
# (K4/K5) may add at most this many times that disagreement:
# 1 - cos(auto, chunked) <= 4 (1 - cos(dense, chunked)). Carrying P and
# dS as hi + lo bf16 pairs in K4/K5 moves 1 - cos(auto, chunked) by ~1%,
# and K3's P as a pair too by a third (tools/pds_precision.py): the gap is
# the forward's and the backward's bf16 rounding together, not a fault of
# one kernel.
GEMMA_GRAD_FLOOR_FACTOR = 4.0
# 12c: preference pairs per batch, the frames each pair shares, steps
PREF_PAIRS, PREF_FRAMES, PREF_STEPS = 2, 4, 3
# 12d: Stable Diffusion's latent shape at batch 8, DDIM steps, train steps
DDPO_SHAPE, DDPO_SAMPLE_STEPS, DDPO_TRAIN_STEPS = (8, 4, 64, 64), 50, 3
TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                 "MASTER_PORT")


def gemma_training(torch, np, va, fa, reset, tmp):
    """12a: `train.main --model_size gemma-2b --lora_enable` in process at
    full depth (18 layers; head dim 256, 8/1 heads: K3 in the forward,
    K4/K5 in the backward at D = 256), GEMMA_STEPS micro-steps of 2
    windows. Its checkpoint writes are recorded and skipped (a chip run
    may write 45 GiB in all; phase 9 checks the saves). Then, on the final
    params and a fresh micro-batch, the loss and LoRA grads through the
    kernels against attn_impl="chunked" (plain PyTorch attention), with
    "dense" against "chunked" as the floor of what two f32 paths
    agree to (GEMMA_GRAD_FLOOR_FACTOR)."""
    import argparse
    from streamvln_tpu_torch import train
    from streamvln_tpu_torch.configs import build_config
    from streamvln_tpu_torch.data.tokenizer import ByteTokenizer
    from streamvln_tpu_torch.models import streamvln
    from streamvln_tpu_torch.utils import checkpoint

    traj, out = os.path.join(tmp, "traj"), os.path.join(tmp, "run")
    os.makedirs(traj)
    write_trajectories(np, traj, 3, seed=12)
    argv = ["--video_folders", traj, "--output_dir", out,
            "--model_size", "gemma-2b", "--lora_enable", "--batch_size", "2",
            "--num_steps", str(GEMMA_STEPS), "--save_steps", "1000",
            "--log_steps", "1", "--prefetch_depth", "2"]
    saves = []
    real_save = checkpoint.save_checkpoint
    checkpoint.save_checkpoint = \
        lambda d, st, step, **kw: saves.append(step) is None
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset()
    box = {}
    t0 = time.perf_counter()
    try:
        with step_probe(torch, va, fa, box, os.path.join(out,
                                                         "metrics.jsonl")):
            state = train.main(argv)
    finally:
        checkpoint.save_checkpoint = real_save
    rec = {"seconds": time.perf_counter() - t0,
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "saves_skipped": saves}
    steps = step_lines(read_log(os.path.join(out, "metrics.jsonl")))
    micro = box["micro"]
    for m, r in zip(micro, steps):
        m["valid_tokens"] = int(m.pop("valid").item())
        m["launches"] = count_diff(m.pop("after"), m.pop("before"))
        m["vit_by_batch"] = count_diff(m.pop("vit_after"),
                                       m.pop("vit_before"))
        m["ms"] = (r["ts"] - m["t_start"]) * 1e3
        m["loss"] = r["loss"]
    cfg = build_config(argparse.Namespace(
        model_size="gemma-2b", spatial_pool_mode="bilinear", num_frames=32,
        num_future_steps=4, num_history=8))
    L, Lv = cfg.llm.num_layers, cfg.vision.num_layers
    per_micro = {"vit_attention": Lv, "flash_attention_lse": 2 * L,
                 "flash_bwd_dq": L, "flash_bwd_dkv": L}
    rec.update(micro_steps=micro, layers=L, head_dim=cfg.llm.head_dim,
               heads=(cfg.llm.num_heads, cfg.llm.num_kv_heads),
               launches={k: sum(m["launches"].get(k, 0) for m in micro)
                         for k in per_micro},
               median_step_ms=float(np.median([m["ms"] for m in micro[1:]])))
    log(f"12a gemma-2b LoRA command: {len(steps)} micro-steps in "
        f"{rec['seconds']:.1f} s, ms {['%.1f' % m['ms'] for m in micro]}, "
        f"losses {[m['loss'] for m in micro]}, launches per micro-step "
        f"{[m['launches'] for m in micro]} (want {per_micro}), peak "
        f"{rec['peak_memory_bytes'] / 2**30:.2f} GiB, saves skipped "
        f"{saves}")

    batch = vln_batches(torch, np, cfg, ByteTokenizer(), 1, 2, seed=12)[0]
    ref = {impl: lora_loss_and_grads(torch, streamvln, state.params, cfg,
                                     batch, impl)
           for impl in ("auto", "chunked", "dense")}
    (la, ga), (lc, gc_), (ld, gd) = ref["auto"], ref["chunked"], \
        ref["dense"]
    cos = torch.nn.functional.cosine_similarity(ga, gc_, dim=0).item()
    floor = torch.nn.functional.cosine_similarity(gd, gc_, dim=0).item()
    rec["reference"] = {"loss_auto": la, "loss_chunked": lc,
                        "loss_dense": ld, "loss_abs_diff": abs(la - lc),
                        "lora_grad_cosine": cos,
                        "lora_grad_cosine_dense_vs_chunked": floor,
                        "bucket": int(batch["valid"].shape[1])}
    log(f"12a kernels vs chunked attention on one micro-batch (bucket "
        f"{rec['reference']['bucket']}): loss {la:.6f} vs {lc:.6f} (dense "
        f"{ld:.6f}), LoRA grad cosine {cos:.6f} (dense vs chunked "
        f"{floor:.6f})")
    del state, ref, ga, gc_, gd, batch
    gc.collect()
    torch.cuda.empty_cache()
    require("12a: gemma-2b through the training command",
            step_lines=[r["step"] for r in steps] ==
            list(range(1, GEMMA_STEPS + 1)),
            finite=all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
                       for r in steps),
            launches_per_micro_step=all(m["launches"] == per_micro
                                        for m in micro),
            loss_close=rec["reference"]["loss_abs_diff"] <= GEMMA_LOSS_ATOL,
            grads_within_the_f32_floor=1 - cos <=
            GEMMA_GRAD_FLOOR_FACTOR * (1 - floor))
    return rec


def preference_batch(torch, np, cfg, tok, seed=0):
    """PREF_PAIRS ByteTokenizer pairs, each a chosen and a rejected answer
    to one prompt over PREF_FRAMES 480x640 frames (made and preprocessed
    on the card), collated by make_dpo_batch."""
    from streamvln_tpu_torch.data import chatml
    from streamvln_tpu_torch.ops.preprocess import preprocess_frames
    from streamvln_tpu_torch.parallel.dpo import make_dpo_batch
    g = torch.Generator(device="cuda").manual_seed(seed)
    prompt = ("you can see " + "<image>" * PREF_FRAMES +
              ". walk past the sofa and stop at the kitchen door.")
    samples = []
    for chosen, rejected in (("↑↑→↑", "←←↓"), ("↑↑↑ STOP", "→→→→")):
        frames = torch.randint(0, 256, (PREF_FRAMES, 480, 640, 3),
                               generator=g, device="cuda", dtype=torch.uint8)
        s = {"images": preprocess_frames(frames, cfg.vision.image_size)
             .float().cpu().numpy()}
        for side, ans in (("chosen", chosen), ("rejected", rejected)):
            ids, labels = chatml.tokenize_dialogue(
                tok, [("user", prompt), ("assistant", ans)])
            s[f"{side}_input_ids"], s[f"{side}_labels"] = ids, labels
        samples.append(s)
    return make_dpo_batch(samples[:PREF_PAIRS], cfg)


def mesh_world_one(torch, np, va, fa, reset):
    """12b: an NCCL process group of world size 1 made from torchrun's
    variables (set here) by the training command's init_distributed, a
    (1, 1, 1) mesh, and two LoRA steps of streamvln_7b through the mesh
    route (params as DTensors) against the same steps without a group on
    the same batches (the base weights shared, the adapters copied);
    then make_ring_attention on the mesh against chunked_attention at
    S = 4096, 28/4 heads. Returns the record and the one-device state
    (12c trains on it)."""
    import socket
    import torch.distributed as dist
    from streamvln_tpu_torch import train as train_cli
    from streamvln_tpu_torch.configs import streamvln_7b
    from streamvln_tpu_torch.data.tokenizer import ByteTokenizer
    from streamvln_tpu_torch.models import lora as lora_lib
    from streamvln_tpu_torch.ops import ring_attention as ra
    from streamvln_tpu_torch.ops.attention import chunked_attention
    from streamvln_tpu_torch.parallel import mesh as mesh_lib
    from streamvln_tpu_torch.parallel.train import (
        TrainConfig, create_train_state, make_train_step)
    from streamvln_tpu_torch.weights import init

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    rec = {}
    try:
        rank, world, own = train_cli.init_distributed(torch.device("cuda"))
        rec["group"] = {"backend": dist.get_backend(), "rank": rank,
                        "world": world, "made_by_the_command": own}
        mesh = mesh_lib.make_mesh(1, 1, 1)
        cfg = streamvln_7b()
        tcfg = TrainConfig(lora_only=True, remat=True, loss_chunk_size=512,
                           total_steps=3)
        params = lora_lib.add_lora(
            init(cfg, torch.Generator(device="cuda").manual_seed(0),
                 device="cuda", dtype=torch.bfloat16),
            torch.Generator(device="cuda").manual_seed(1), rank=16)
        twin = mesh_lib.map_tree(
            lambda p, t: t.clone() if lora_lib.is_lora_path(p) else t,
            params)
        states = {"one_device": create_train_state(params, tcfg),
                  "mesh": create_train_state(
                      mesh_lib.shard_params(twin, mesh), tcfg)}
        del params, twin
        steps = {"one_device": make_train_step(cfg, tcfg, "cuda"),
                 "mesh": make_train_step(cfg, tcfg, "cuda", mesh=mesh)}
        batches = vln_batches(torch, np, cfg, ByteTokenizer(), 2, 2, seed=5)
        lora0 = {p: t.detach().clone() for p, t in
                 tree_leaves(states["one_device"].params)
                 if lora_lib.is_lora_path(p)}
        runs = {}
        for name in ("one_device", "mesh"):
            reset()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms, metrics = [], []
            for b in batches:
                t0 = time.perf_counter()
                states[name], m = steps[name](states[name], b)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                metrics.append({k: v.item() for k, v in m.items()})
            runs[name] = {"ms": ms, "metrics": metrics,
                          "launches": kernel_counts(va, fa),
                          "peak_memory_bytes":
                          torch.cuda.max_memory_allocated()}
        leaves = {n: {p: mesh_lib.full(t) for p, t in
                      tree_leaves(states[n].params)
                      if lora_lib.is_lora_path(p)} for n in states}
        delta = {n: torch.cat([(leaves[n][p].float() - lora0[p].float())
                               .flatten() for p in lora0]) for n in leaves}
        cos = torch.nn.functional.cosine_similarity(
            delta["one_device"], delta["mesh"], dim=0).item()
        m1, m2 = runs["one_device"]["metrics"], runs["mesh"]["metrics"]
        loss_rel = max(abs(a["loss"] - b["loss"]) / abs(a["loss"])
                       for a, b in zip(m1, m2))
        gn_rel = max(abs(a["grad_norm"] - b["grad_norm"]) / a["grad_norm"]
                     for a, b in zip(m1, m2))
        bit_equal = m1 == m2 and all(
            torch.equal(leaves["mesh"][p], leaves["one_device"][p])
            for p in lora0)
        dtensors = all(mesh_lib.is_dtensor(t)
                       for _, t in tree_leaves(states["mesh"].params))
        rec["step"] = {"runs": runs, "loss_rel_diff": loss_rel,
                       "grad_norm_rel_diff": gn_rel,
                       "lora_update_cosine": cos, "bit_equal": bit_equal,
                       "params_are_dtensors": dtensors}
        log(f"12b streamvln_7b LoRA steps, mesh (1,1,1) over NCCL vs no "
            f"group: ms {runs['mesh']['ms']} vs {runs['one_device']['ms']}; "
            f"loss rel diff {loss_rel:.3e}, grad_norm rel diff "
            f"{gn_rel:.3e}, LoRA update cosine {cos:.6f}, bit-equal "
            f"{bit_equal}; launches {runs['mesh']['launches']}")
        require("12b: the mesh route at world size 1",
                dtensors=dtensors, loss=loss_rel <= TRAIN_LOSS_RTOL,
                grad_norm=gn_rel <= TRAIN_LOSS_RTOL,
                update=cos >= TRAIN_GRAD_MIN_COSINE,
                same_launches=runs["mesh"]["launches"] ==
                runs["one_device"]["launches"])
        state = states["one_device"]
        del states, steps, leaves, delta, batches
        gc.collect()
        torch.cuda.empty_cache()

        g = torch.Generator(device="cuda").manual_seed(7)
        S, Hq, Hkv, D = 4096, 28, 4, 128
        q = torch.randn((1, S, Hq, D), generator=g, device="cuda") \
            .to(torch.bfloat16)
        k, v = (torch.randn((1, S, Hkv, D), generator=g, device="cuda")
                .to(torch.bfloat16) for _ in range(2))
        pos = torch.arange(S, device="cuda", dtype=torch.int32)[None]
        ring = ra.make_ring_attention(mesh, "fsdp")
        with torch.no_grad():
            out = ring(q, k, v, pos, pos)
            ref = chunked_attention(q, k, v, pos, pos)
            c = compare(out, ref)
            c["ms"] = time_ms(torch, lambda: ring(q, k, v, pos, pos),
                              iters=3, warmup=1)
            c["chunked_ms"] = time_ms(
                torch, lambda: chunked_attention(q, k, v, pos, pos),
                iters=3, warmup=1)
        c["shape"] = f"B=1 S={S} Hq={Hq} Hkv={Hkv} D={D} bf16, causal"
        rec["ring"] = c
        log(f"12b ring attention at world size 1 vs chunked_attention "
            f"({c['shape']}): {tol_text(c)}; {c['ms']:.2f} ms vs "
            f"{c['chunked_ms']:.2f} ms")
        require("12b: ring attention", within_tolerance=c["tol_share"] <= 1)
        del q, k, v, out, ref
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k_ in TORCHRUN_VARS:
            os.environ.pop(k_, None)
    return rec, cfg, state


def preference_trainers(torch, np, cfg, state, va, fa, reset):
    """12c: DPO (the reference being the policy's own base tensors), the
    reward model and PPO on streamvln_7b with LoRA, PREF_STEPS steps each,
    on preference_batch's pairs; ms per step, peak memory and K1-K5
    launches by trainer."""
    from streamvln_tpu_torch.data.tokenizer import ByteTokenizer
    from streamvln_tpu_torch.models import lora as lora_lib
    from streamvln_tpu_torch.parallel import dpo, ppo
    from streamvln_tpu_torch.parallel.train import (TrainConfig,
                                                    create_train_state)
    from streamvln_tpu_torch.utils.constants import IGNORE_INDEX
    tcfg = TrainConfig(lora_only=True, remat=True, total_steps=PREF_STEPS,
                       warmup_ratio=0.0, learning_rate=1e-4)
    batch = preference_batch(torch, np, cfg, ByteTokenizer(), seed=21)
    T = batch["chosen_token_ids"].shape[1]
    layout = {k: batch[f"chosen_{k}"] for k in ppo.LAYOUT}
    g = torch.Generator(device="cuda").manual_seed(3)
    head = ppo.init_value_head(g, cfg)

    def dpo_steps():
        st = create_train_state(state.params, tcfg)
        ref = lora_lib.split_lora(st.params)[0]
        step = dpo.make_dpo_step(cfg, tcfg, "cuda", beta=0.1)
        for _ in range(PREF_STEPS):
            st, m = step(st, ref, batch)
            yield m

    def reward_steps():
        st = create_train_state(state.params, tcfg)
        step, init_opt = ppo.make_reward_step(cfg, tcfg, "cuda")
        h = {k: v.clone() for k, v in head.items()}
        ho = init_opt(h)
        for _ in range(PREF_STEPS):
            st, h, ho, m = step(st, h, ho, batch)
            yield m

    def ppo_steps():
        st = create_train_state(state.params, tcfg)
        with torch.no_grad():
            old = ppo.token_logprobs(
                st.params, cfg, torch.as_tensor(batch["images"]).cuda()
                .to(torch.bfloat16),
                {k: torch.as_tensor(v).cuda() for k, v in layout.items()})
        old = old.float().cpu().numpy()
        mask = (batch["chosen_labels"][:, 1:] != IGNORE_INDEX) \
            .astype(np.float32)
        rng = np.random.default_rng(4)
        rewards = (rng.standard_normal(mask.shape) * mask).astype(np.float32)
        pb = ppo.rollout_batch(layout, batch["images"], mask,
                               old + (rng.standard_normal(old.shape) * 0.1)
                               .astype(np.float32),
                               np.zeros_like(old), rewards)
        step, init_opt = ppo.make_ppo_step(cfg, tcfg, "cuda", ent_coef=0.01)
        h = {k: v.clone() for k, v in head.items()}
        ho = init_opt(h)
        for _ in range(PREF_STEPS):
            st, h, ho, m = step(st, h, ho, pb)
            yield m

    rec = {"bucket": T, "pairs": PREF_PAIRS, "frames": PREF_FRAMES}
    for name, steps in (("dpo", dpo_steps), ("reward", reward_steps),
                        ("ppo", ppo_steps)):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset()
        ms, metrics = [], []
        t0 = time.perf_counter()
        for m in steps():
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            metrics.append({k: v.item() for k, v in m.items()})
            t0 = time.perf_counter()
        rec[name] = {"ms": ms, "metrics": metrics,
                     "launches": kernel_counts(va, fa),
                     "peak_memory_bytes": torch.cuda.max_memory_allocated()}
        log(f"12c {name}: ms {['%.1f' % x for x in ms]}, peak "
            f"{rec[name]['peak_memory_bytes'] / 2**30:.2f} GiB, launches "
            f"{rec[name]['launches']}, last metrics {metrics[-1]}")
    rec["dpo_accuracy"] = [m["dpo_accuracy"] for m in rec["dpo"]["metrics"]]
    finite = all(np.isfinite(v) for name in ("dpo", "reward", "ppo")
                 for m in rec[name]["metrics"] for v in m.values())
    kernels = ("vit_attention", "flash_attention", "flash_attention_lse",
               "flash_bwd_dq", "flash_bwd_dkv")
    require("12c: DPO, reward and PPO on streamvln_7b", finite=finite,
            dpo_all_five_kernels=all(rec["dpo"]["launches"][k] > 0
                                     for k in kernels),
            reward_and_ppo_k1_k3_k4_k5=all(
                rec[n]["launches"][k] > 0 for n in ("reward", "ppo")
                for k in kernels if k != "flash_attention"))
    return rec


def ddpo_on_card(torch, F):
    """12d: DDPO with a small convolutional denoiser (caller-supplied, as
    the module takes it) at Stable Diffusion's latent shape: a
    DDPO_SAMPLE_STEPS-step rollout with log-probs, per-prompt advantages,
    then DDPO_TRAIN_STEPS optimizer steps on its timesteps."""
    from streamvln_tpu_torch.parallel import ddpo
    B, C, H, W = DDPO_SHAPE
    hid, E = 64, 768
    g = torch.Generator(device="cuda").manual_seed(11)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device="cuda") * scale
    params = {"c1": rnd(hid, C, 3, 3, scale=(9 * C) ** -0.5),
              "b1": torch.zeros(hid, device="cuda"),
              "wt": rnd(1, hid), "we": rnd(E, hid, scale=E ** -0.5),
              "c2": rnd(C, hid, 3, 3, scale=(9 * hid) ** -0.5),
              "b2": torch.zeros(C, device="cuda")}

    def apply(p, x, t, emb):
        h = F.conv2d(x, p["c1"], p["b1"], padding=1)
        h = h + ((t[:, None].float() / 1000.0) @ p["wt"]
                 + emb @ p["we"])[:, :, None, None]
        return F.conv2d(F.silu(h), p["c2"], p["b2"], padding=1)
    alphas = ddpo.make_alphas_cumprod(device="cuda")
    x, emb = rnd(*DDPO_SHAPE), rnd(B, E)
    steps = torch.linspace(999, 0, DDPO_SAMPLE_STEPS).round().long()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lat, nxt, lps = ddpo.sample_with_logprob(apply, params, g, x, steps,
                                             emb, alphas)
    torch.cuda.synchronize()
    rollout_ms = (time.perf_counter() - t0) * 1e3
    rewards = -(nxt[-1].float() ** 2).mean(dim=(1, 2, 3))
    prompts = ["a cat", "a dog"] * (B // 2)
    adv = ddpo.PerPromptStatTracker(32, 16).update(prompts,
                                                   rewards.cpu().numpy())
    init_opt, step = ddpo.make_ddpo_step(apply, alphas)
    opt = init_opt(params)
    ms, metrics = [], []
    for i in range(DDPO_TRAIN_STEPS):
        j = i * (DDPO_SAMPLE_STEPS // DDPO_TRAIN_STEPS)
        b = {"latents": lat[j], "next_latents": nxt[j],
             "timesteps": steps[j].repeat(B).cuda(),
             "prev_timesteps": steps[j + 1].repeat(B).cuda(),
             "old_logps": lps[j],
             "advantages": torch.as_tensor(adv, dtype=torch.float32,
                                           device="cuda"),
             "embeds": emb}
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, b)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: v.item() for k, v in m.items()})
    rec = {"shape": list(DDPO_SHAPE), "sample_steps": DDPO_SAMPLE_STEPS,
           "rollout_ms": rollout_ms, "step_ms": ms, "metrics": metrics,
           "logp_range": [lps.min().item(), lps.max().item()]}
    log(f"12d DDPO at {DDPO_SHAPE}: {DDPO_SAMPLE_STEPS}-step rollout "
        f"{rollout_ms:.1f} ms, log-probs in {rec['logp_range']}; steps "
        f"{['%.2f' % x for x in ms]} ms, metrics {metrics}")
    require("12d: DDPO", finite_logps=bool(torch.isfinite(lps).all()),
            finite_metrics=all(math.isfinite(v) for m in metrics
                               for v in m.values()),
            first_ratio_one=metrics[0]["approx_kl"] < 1e-6)
    return rec


def library_recheck(torch, F, repeats=5, L=28):
    """12e: the two library times PR 14's kernel table marks not valid
    (below or at their bound): SDPA at K1's EVA02-B-16 shape (B=1, S=197,
    12 heads, D=64) and on K8's live prefix at G = 1 (32/32 heads, D=128,
    length 4096 of 4096). Each is taken `repeats` times by device time
    (torch.profiler over L copies in turn, so each call misses L2, as
    phases 10a and 11a time them) and once by CUDA events over the same
    rotation; a time below the bound cannot be the kernel's and is kept
    apart."""
    g = torch.Generator(device="cuda").manual_seed(9)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda") \
            .to(torch.bfloat16)
    cases = {}
    q, k, v = (rnd(L, 1, 12, 197, 64) for _ in range(3))
    cases["K1 EVA02-B-16 B=1 S=197 H=12 D=64"] = (
        [(lambda i=i: F.scaled_dot_product_attention(q[i], k[i], v[i]))
         for i in range(L)],
        bound(4.0 * 12 * 197 * 197 * 64, 4 * 12 * 197 * 64 * 2))
    qd = rnd(L, 1, 32, 1, 128)
    kd, vd = (rnd(L, 1, 32, 4096, 128) for _ in range(2))
    cases["K8 G=1 32/32 heads D=128 length 4096"] = (
        [(lambda i=i: F.scaled_dot_product_attention(
            qd[i], kd[i], vd[i], enable_gqa=True)) for i in range(L)],
        bound(4.0 * 32 * 4096 * 128,
              2 * 32 * 4096 * 128 * 2 + 2 * 32 * 128 * 2))
    rec = {}
    for name, (fns, (b_ms, b_by)) in cases.items():
        runs = [device_ms(torch, fns, 2 * L) for _ in range(repeats)]
        valid = [x for x in runs if x >= b_ms]
        rec[name] = {"device_ms_runs": runs, "bound_ms": b_ms,
                     "bound_by": b_by,
                     "event_ms": time_cold_ms(torch, fns, iters=2 * L),
                     "library_ms": statistics.median(valid) if valid
                     else None}
        log(f"12e SDPA at {name}: device ms {['%.4f' % x for x in runs]}, "
            f"events {rec[name]['event_ms']:.4f}, bound {b_ms:.4f} "
            f"({b_by}): library_ms {rec[name]['library_ms']}")
    del q, k, v, qd, kd, vd
    return rec


def last_modules(torch, np, F, va, fa, reset, card):
    """Phase 12: 12a-12d in turn; everything written goes under a
    temporary directory, removed in every case."""
    import shutil
    import tempfile
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_12_")
    try:
        rec = {"gemma": gemma_training(torch, np, va, fa, reset, tmp)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec["mesh"], cfg, state = mesh_world_one(torch, np, va, fa, reset)
    rec["preference"] = preference_trainers(torch, np, cfg, state, va, fa,
                                            reset)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    rec["ddpo"] = ddpo_on_card(torch, F)
    rec["library_recheck"] = library_recheck(torch, F)
    rec["seconds"] = time.perf_counter() - t0
    log(f"phase 12 passed in {rec['seconds']:.1f} s ({card})")
    return rec


def last_modules_summary(rec, card) -> str:
    g, m, p = rec["gemma"], rec["mesh"], rec["preference"]
    per_step = {n: round(statistics.median(p[n]["ms"][1:]), 1)
                for n in ("dpo", "reward", "ppo")}
    return (f"phase 12 ({card}): gemma-2b LoRA command median micro-step "
            f"{g['median_step_ms']:.1f} ms, peak "
            f"{g['peak_memory_bytes'] / 2**30:.2f} GiB, K3/K4/K5 "
            f"{g['launches']}; loss vs chunked "
            f"{g['reference']['loss_abs_diff']:.2e}, LoRA grad cosine "
            f"{g['reference']['lora_grad_cosine']:.5f}; mesh (1,1,1) step "
            f"bit-equal {m['step']['bit_equal']}, ring vs chunked "
            f"{m['ring']['max_abs_err']:.2e}; median ms per step after the "
            f"first {per_step}, DPO accuracy {p['dpo_accuracy']}; DDPO "
            f"rollout {rec['ddpo']['rollout_ms']:.1f} ms")


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


def cli_launches(cli, name) -> dict:
    """A kernel's launches in phase 9: 9a's micro-steps, its mid-training
    evaluation, 9b's two runs and 9c's 32k step."""
    cmd = cli["command"]
    return {"command_micro_steps": sum(m["launches"].get(name, 0)
                                       for m in cmd["micro_steps"]),
            "command_evaluation": cmd["evaluation"]["launches"].get(name, 0),
            "resume_and_export": cli["export"]["launches"].get(name, 0),
            "long_step": cli["long_step"]["launches"].get(name, 0)}


def long_entry(cli, name) -> dict:
    """K3/K4/K5 at S=32768 against chunked_attention (phase 9c), with their
    launches in the 32k step."""
    r = cli["long_kernels"]["kernels"][name]
    return {k: r[k] for k in ("shape", "max_abs_err", "checks", "ms",
                              "bound_ms", "bound_by", "library_ms",
                              "library")} | {
        "launches": cli["long_step"]["launches"][name], **shares(r)}


def train_cli_summary(cli, card) -> str:
    """Phase 9 on one line, beside the card's name and power limit."""
    c, s, k = cli["command"], cli["long_step"], cli["long_kernels"]
    return (f"phase 9 training command ({card}): optimizer step median "
            f"{c['median_step_ms']:.2f} ms, "
            f"{c['median_valid_tokens_per_s']:.1f} valid tokens/s, peak "
            f"{c['peak_memory_bytes'] / 2**30:.2f} GiB, prefetch wait "
            f"{c['prefetch_wait_share']:.4f} of a step, idle share "
            f"{(c['profile'] or {}).get('device_idle_share')}; save "
            f"{c['save']['seconds']:.2f} s of "
            f"{c['save']['bytes'] / 2**30:.2f} GiB; 32k step "
            f"{s['seconds']:.2f} s, peak {s['peak_memory_bytes'] / 2**30:.2f} "
            f"GiB; K3+K4+K5 at 32k {k['kernels_fwd_bwd_ms']:.3f} ms vs "
            f"chunked_attention forward {k['chunked_fwd_ms']:.1f} ms; "
            f"{cli['seconds']:.1f} s")


def family_launches(fam, name) -> dict:
    """A kernel's launches in phase 10b, by family (the calls under
    decode_kernel apart)."""
    out = {}
    for r in fam["families"]:
        key = r["model_size"] + (" int4" if r["bits"] == 4 else "")
        out[key] = r["launches"][name]
        if "decode_kernel" in r:
            out[key + " decode_kernel"] = r["decode_kernel"]["launches"][name]
    return out


def tail_launches(tail, name) -> dict:
    """A kernel's launches in phase 11, by sub-phase: each tower's forward
    under "auto", each anyres generation, offline.main, benchmark.main and
    dagger.main."""
    out = {t["tower"]: t["launches"][name] for t in tail["zoo"]["towers"]}
    out.update({"anyres " + "x".join(map(str, r["image_hw"])):
                r["launches"][name] for r in tail["anyres"]})
    ep = tail["entry_points"]
    out.update(offline=ep["offline"]["launches"][name],
               benchmark=ep["benchmark"]["launches"][name],
               dagger=tail["tools"]["dagger"]["launches"][name])
    return out


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
        va.launches_by_shape = {}

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
    # the head-dim-256 and -128 instances of K2/K3 and K8 (the families)
    # and K1's DP=96 and DP=112 instances (the zoo's head dims 88 and 104)
    # spill no register; ptxas's notes on serialized wgmma are printed
    for name, label in (("flash_attention", "attention_fwd_kernel<256>"),
                        ("flash_attention", "attention_fwd_kernel<128>"),
                        ("vit_attention", "attention_fwd_kernel<96>"),
                        ("vit_attention", "attention_fwd_kernel<112>"),
                        ("decode_attention",
                         "decode_attention_kernel<bf16,1,256>")):
        text = build.build_logs.get(name)
        if text is None:
            continue
        inst = [x for x in ptxas_summary(text).split("; ")
                if x.startswith(label + ":")]
        for line in text.splitlines():
            if "serialized" in line:
                log(f"  {name} ptxas: {line.strip()[:220]}")
        # K1's head dims build with and without the key split
        if not inst or not all(x.endswith(" 0 B spill") for x in inst):
            raise AssertionError(f"{label} spills registers or was not "
                                 f"built: {inst}")
    # ... and the head-dim-128 instance's products run unserialized
    text = build.build_logs.get("flash_attention", "")
    if any("serialized" in line and "attention_fwd_kernelILi128E" in line
           for line in text.splitlines()):
        raise AssertionError("ptxas serializes the wgmma of "
                             "attention_fwd_kernel<128>")
    card = card_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. kernels against their plain versions at main-path shapes
    # K1 at each batch a main path sends: one frame per model call, the
    # history backfill of num_history frames (phase 5), the training tower
    vit = [check_vit(torch, F, va, B) for B in
           (1, streamvln_7b().num_history, TRAIN_TOWER_BATCH)]
    flash = [check_flash(torch, F, fa, Sq, graph=True)
             for Sq in (768, 2560)] + \
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
    train_k = check_training_kernels(torch, F, fa, graph=True)
    # ... and at Gemma-2B's (head dim 256, 8/1 heads), where K4/K5 share
    # the score products between their two warpgroups and K5 splits a KV
    # head's 8 query heads over several blocks
    train_k256 = check_training_kernels(torch, F, fa, Hq=8, Hkv=1, D=256)
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

    # 9. the training entry point: the command at full width and its
    # resume, the export, the 32k step and K3/K4/K5 at that length
    def reset_training():
        reset_counts()
        fa.lse_launches = fa.dq_launches = fa.dkv_launches = 0
    n_captures = len(captures)
    cli = train_cli(torch, np, F, va, fa, reset_training, train, card)
    cli["captures"] = captures[n_captures:]
    log_captures("phase 9", cli["captures"])
    # phase 2's K1 check, extended to every tower batch phases 9 and 10
    # sent
    cli_batches = {f"B={b}" for b in cli["command"]["vit_batches_sent"]} | \
        set(cli["export"]["vit_launches_by_batch"]) | \
        set(cli["long_step"]["vit_launches_by_batch"])

    # 10. the LLM families at full width through the entry points, the
    # kernels at their shapes, the pool modes and the native loader
    n_captures = len(captures)
    fam = families(torch, np, F, fa, da, va, frames, instruction,
                   serving_counts, reset_counts, card)
    fam["captures"] = captures[n_captures:]
    log_captures("phase 10", fam["captures"])
    cli_batches |= {b for r in fam["families"]
                    for b in r["vit_launches_by_batch"]}

    # 11. the vision tail: K1 at the zoo's and anyres's shapes, the towers,
    # the resamplers, anyres, the offline and benchmark evaluators, DAgger
    # and trajectory generation
    n_captures = len(captures)
    tail = vision_tail(torch, np, F, va, fa, serving_counts, reset_counts,
                       card)
    tail["captures"] = captures[n_captures:]
    log_captures("phase 11", tail["captures"])
    vit += tail["vit"]

    def siglip_checked():
        return {f"B={r['batch']}" for r in vit
                if tuple(r["key"][1:]) == (729, 16, 72)}
    for b in sorted(int(x[2:]) for x in cli_batches - siglip_checked()):
        vit.append(check_vit(torch, F, va, b))

    sent = set(vit_by_batch) | set(train["vit_launches_by_batch"]) | \
        set(evaluation["vit_launches_by_batch"]) | \
        set(serving["vit_launches_by_batch"]) | \
        set(turnkey["vit_launches_by_batch"]) | \
        set(qtail["vit_batches"]) | cli_batches
    unchecked = sent - siglip_checked()
    if unchecked:
        raise AssertionError(f"the main paths sent K1 batches {unchecked} "
                             f"that phase 2 did not check")
    unchecked = {tuple(k) for k in tail["vit_shapes"]} - {
        tuple(r["key"]) for r in vit}
    if unchecked:
        raise AssertionError(f"phase 11 sent K1 shapes (B, S, H, D) "
                             f"{sorted(unchecked)} that phases 2 and 11a "
                             f"did not check")
    k7_shapes = {f"{din}x{dout} {dt}": n for (din, dout, dt), n
                 in sorted(i4.dequant_launches_by_shape.items())}
    unchecked = set(i4.dequant_launches_by_shape) - {
        tuple(k) for r in dequant_recs for k in (r["key"], r["f32_key"])}
    if unchecked:
        raise AssertionError(f"the run launched K7 at (din, dout, dtype) "
                             f"{sorted(unchecked)}, which phase 2 did not "
                             f"check")
    log(f"K7 launches by shape over the whole run: {k7_shapes}")

    # 12. the last modules: Gemma-2B LoRA through the training command
    # (K4/K5 at head dim 256), the mesh route and ring attention on an
    # NCCL group of one, DPO, reward and PPO at full width, DDPO
    n_captures = len(captures)
    last = last_modules(torch, np, F, va, fa, reset_training, card)
    log_captures("phase 12", captures[n_captures:])

    # 13. summary
    flash += fam["kernels"]["flash"] + tail["flash"]
    decode_recs += fam["kernels"]["decode"]
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
                         qtail, "vit_attention"),
                     launches_train_cli=cli_launches(cli, "vit_attention"),
                     launches_families=family_launches(fam,
                                                       "vit_attention"),
                     launches_vision_tail=tail_launches(tail,
                                                        "vit_attention")),
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
                         qtail, "flash_attention"),
                     launches_train_cli=cli_launches(cli, "flash_attention"),
                     launches_families=family_launches(fam,
                                                       "flash_attention"),
                     launches_vision_tail=tail_launches(tail,
                                                        "flash_attention"))]
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
            "launches_qlora": qtail["qlora"]["launches"][name],
            "launches_train_cli": cli_launches(cli, name),
            "long_context": long_entry(cli, name),
            "launches_gemma_train_cli": last["gemma"]["launches"][name],
            "launches_preference": {
                n: last["preference"][n]["launches"][name]
                for n in ("dpo", "reward", "ppo")},
            "training_head_dim_256": {
                k: train_k256[name][k] for k in (
                    "shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms")},
            **({"head_dim_256": fam["kernels"]["flash_lse"]}
               if name == "flash_attention_lse" else {})})
    # K4/K5's head-dim-256 instance (WIDE): its own records, with the
    # launches of phase 12a's gemma-2b command and K5's head split
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        r = train_k256[name]
        kernels.append({
            "name": f"{name}_d256", "route": "cuda",
            "source": "streamvln_tpu_torch/csrc/flash_attention_bwd.cu",
            "replaces": r["replaces"],
            "launches": last["gemma"]["launches"][name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            **shares(r), "shape": r["shape"], "library": r["library"],
            "bit_equal": r["bit_equal"],
            **({"head_splits": r["head_splits"]} if "head_splits" in r
               else {})})
    kernels += [
        kernel_entry("int4_matmul",
                     "streamvln_tpu_torch/csrc/int4_matmul.cu",
                     "streamvln_tpu/ops/int4_matmul.py:93",
                     int4["launches"]["int4_matmul"], int4_recs, head=2,
                     library=int4_recs[2]["library"],
                     launches_families=family_launches(fam, "int4_matmul")),
        kernel_entry("int4_dequant_split",
                     "streamvln_tpu_torch/csrc/int4_matmul.cu",
                     "streamvln_tpu/ops/int4_matmul.py:170",
                     int4["launches"]["int4_dequant_split"], dequant_recs,
                     head=2, launches_qlora=qtail["qlora"]["launches"][
                         "int4_dequant_split"],
                     launches_qlora_per_micro_step=qtail["qlora"][
                         "k7_per_micro_step"],
                     launches_by_shape=k7_shapes,
                     launches_families=family_launches(
                         fam, "int4_dequant_split")),
        kernel_entry("decode_attention",
                     "streamvln_tpu_torch/csrc/decode_attention.cu",
                     "streamvln_tpu/ops/decode_attention.py:31",
                     dk["launches"]["decode_attention"], decode_recs,
                     library="F.scaled_dot_product_attention (enable_gqa) "
                             "on the live prefix",
                     launches_families=family_launches(fam,
                                                       "decode_attention"))]
    seconds = time.perf_counter() - t_start
    log(serving_summary(serving))
    log(turnkey_summary(turnkey, card))
    log(quantized_tail_summary(qtail, card))
    log(train_cli_summary(cli, card))
    log(families_summary(fam, card))
    log(vision_tail_summary(tail, card))
    log(last_modules_summary(last, card))
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
                   "train_cli": cli, "families": fam,
                   "vision_tail": tail,
                   "training_kernels_head_dim_256": train_k256,
                   "last_modules": last, "seconds": seconds},
                  f, indent=1,
                  default=str)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
