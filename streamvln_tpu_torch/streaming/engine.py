"""Streaming inference engine of the PyTorch port.

Counterpart of `streamvln_tpu/streaming/engine.py::StreamingEngine`, with
the same public API: `generate`, `generate_batch(_async)` / `collect`,
`continue_decode`, `reset`, `reset_for_env`, `reset_episode`,
`backfill(_batch)`.

- **KV cache** (models/qwen2.KVCache): fixed capacity, per-row lengths; a
  window reset sets the env's length to 0.
- **Frame-feature cache**: each model call encodes one current frame and
  stores its pooled tokens in a per-env slab; at a window boundary the
  slow memory gathers `num_history` cached frames. The last slot is
  reserved scratch for inactive batch rows.
- **One call** (`_prefill_decode`): preprocess + encode the frame, splice,
  prefill into the cache at per-row offsets, then decode: one token per
  forward, greedy or sampled (temperature / top-p; `_token_step`), or
  prompt-lookup speculative (`spec_lookup > 0`, `_verify_step`).
- **Decode loops as the reference runs them**: each forward is a step
  function over device state (tokens, counters, `done`, the cache at
  offsets read on the device, the shadow) that reads nothing back to the
  host; the host reads one `more` flag per forward, where the
  reference's `lax.while_loop` tests it on the device. On the card each
  forward replays the CUDA graph captured from its step at first use
  (streaming/decode_graph.py); the CPU runs the same steps eagerly.
- **Speculative decode** drafts `spec_lookup` tokens from `ids_buf`, a
  token-id shadow of the KV slots, verifies them in one cached forward and
  keeps the longest prefix that greedy decoding would emit. The reference
  appends into a scratch cache merged once; the port appends in place, so
  rejected drafts stay written past the row's length and a rollback only
  sets the length (visibility `k_pos <= q_pos` with slot == position keeps
  them unseen, and the next write overwrites them).
- **Buckets**: prompts pad to a few lengths, as in the reference.
- **Pending token**: the last generated token of a call is not fed in
  that call; it is prepended to the next call's tokens, or fed first by
  `continue_decode`.
- **Weights**: float, or quantized by models/quant.py (int8, packed
  int4: decode streams the int4 projections through K6); q/k/v and
  gate/up are fused in the constructor (models/fuse.py), as the
  reference's default `fuse_proj=True` does. The fused stacks are copies
  of the caller's; `fuse_proj=False` serves the caller's stacks.
- **attn_impl**: "auto" (K1 tower, K2 prefill, dense decode), "dense",
  or "decode_kernel" (K1 tower, dense prefill, K8 decode over the live
  prefix; opt-in, as in the reference, where its own decode loop never
  reaches the kernel). The speculative verify forward has spec_lookup + 1
  queries, so it is dense under every impl.
- **Sampling** draws from the engine's `torch.Generator` on its device,
  reseeded from (`sample_seed`, the engine's sampled-call count): the
  support, the greedy gate and determinism by seed are the reference's,
  the bits of `jax.random` are not.

- **fused_preprocess**: the current and history frames go through the
  fused resize/normalise/patch-embed (`siglip.forward_raw`) in place of
  `ops/preprocess.py` + `siglip.forward`; the call, `backfill` and
  `backfill_batch` take the same flavour, so a feature cache never mixes
  the two encoders' outputs.
- **kv_int8**: the KV cache holds int8 values and f32 scales per (token,
  head) (models/qwen2.KVCache, quantized), about half the bytes of a bf16
  cache at head dim 128. Appends quantize after RoPE; decode and verify
  forwards attend over the int8 cache with the scales folded in (dense,
  under every attn_impl, as the reference's decode loop), prefill over the
  layer's cache dequantized (K2 under "auto"). Resets, idle rows and
  rollbacks touch lengths only, so the scales stay with their slots, and
  the decode graphs read the scale buffers as they read k and v.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from streamvln_tpu_torch.configs import StreamVLNConfig, resolve_device
from streamvln_tpu_torch.models import qwen2, siglip, streamvln
from streamvln_tpu_torch.models.fuse import fuse_projections
from streamvln_tpu_torch.models.qwen2 import KVCache
from streamvln_tpu_torch.ops.preprocess import preprocess_frames
from streamvln_tpu_torch.streaming import decode_graph

DEFAULT_BUCKETS = (256, 512, 768, 1024, 1536, 2048, 2560, 3072, 4096)


def _scratch_size(n_tokens: int) -> int:
    """KV headroom a decode loop of n_tokens needs past the prompt. The
    reference merges a sublane-padded scratch of this size; the port keeps
    the same headroom so both refuse the same requests."""
    return max(8, -(-n_tokens // 8) * 8)


class _PhaseTimer:
    """CUDA events around the phases of a call (vision, prefill, decode);
    read after the call's results are on the host. No-op on CPU."""

    def __init__(self, device: torch.device):
        self.on = device.type == "cuda"
        self.events = []

    def mark(self):
        if self.on:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append(ev)

    def ms(self):
        if not self.on or len(self.events) < 2:
            return None
        return [a.elapsed_time(b) for a, b in zip(self.events,
                                                   self.events[1:])]


def _encode(params, cfg, frames_u8, attn_impl, dtype, fused: bool):
    """[N, H, W, 3] uint8 -> pooled [N, tpf, D] in dtype: the tower on
    preprocess_frames' pixels, or with `fused` on the fused patch embed
    (the reference's two `_encode_store` flavours), then the projector and
    the 2x2 pool."""
    vision = params["vision"]
    if fused:
        feats = siglip.forward_raw(vision, cfg.vision, frames_u8, attn_impl,
                                   compute_dtype=dtype)
    else:
        feats = siglip.forward(vision, cfg.vision, preprocess_frames(
            frames_u8, cfg.vision.image_size, dtype=dtype), attn_impl)
    return streamvln.project_pool(params, cfg, feats).to(dtype)


def _is_stop(t: torch.Tensor, stop: torch.Tensor) -> torch.Tensor:
    """Elementwise: is t one of the stop ids (any shape)."""
    return (t[..., None] == stop).any(dim=-1)


def _n_out(out: torch.Tensor, stop: torch.Tensor, n_steps: torch.Tensor):
    """Tokens per row up to and including the first stop, else n_steps
    ([1] int32, the tokens the loop wrote)."""
    stop_mask = _is_stop(out, stop)
    has_stop = stop_mask.any(dim=1)
    first_stop = stop_mask.int().argmax(dim=1).to(torch.int32)
    return torch.where(has_stop, first_stop + 1, n_steps)


def _shadow_write(ids_buf: torch.Tensor, vals: torch.Tensor,
                  offsets: torch.Tensor, active: torch.Tensor) -> None:
    """Masked in-place write into the token-id shadow: row b gets vals[b]
    ([B, W]) at offsets[b]; rows with active[b] False keep what they hold.
    The start is clamped to capacity - W as the reference's
    dynamic_update_slice clamps it, so both write the same slots."""
    W = vals.shape[1]
    start = offsets.long().clamp(0, ids_buf.shape[1] - W)
    idx = start[:, None] + torch.arange(W, device=ids_buf.device)[None]
    new = torch.where(active[:, None], vals.to(ids_buf.dtype),
                      ids_buf.gather(1, idx))
    ids_buf.scatter_(1, idx, new)


def _decode_step(params, cfg, cache, fed, live, attn_impl, dtype,
                 advance=True):
    """One cached forward of `fed` [B, S] at each row's length. Rows with
    live False are not written; with `advance` the live rows' lengths
    grow by S. Returns f32 logits [B, S, V]."""
    emb = qwen2.embed_tokens(params["llm"], fed).to(dtype)
    S = fed.shape[1]
    pos = cache.length[:, None] + torch.arange(
        S, dtype=torch.int32, device=fed.device)[None]
    grow = live.to(torch.int32) * S if advance else \
        torch.zeros_like(cache.length)
    logits, _ = qwen2.forward(params["llm"], cfg.llm, emb, pos, cache=cache,
                              new_lengths=grow, attn_impl=attn_impl,
                              write_mask=live)
    return logits


def _argmax(logits: torch.Tensor) -> torch.Tensor:
    return logits.argmax(dim=-1).to(torch.int32)


def _token_state(cur, n0: int, budget: int, max_new: int, stop, force_done):
    """The token loop's state (device tensors) before its next forward:
    `cur` [B] is the token to feed; with n0 = 1 it is also the call's
    first token (from the prefill), already in out[:, 0]; with n0 = 0 the
    next forward picks out[:, 0]. The loop ends once every row is done:
    stopped, in force_done, or n has reached `budget`."""
    B, dev = cur.shape[0], cur.device
    out = torch.zeros((B, max_new), dtype=torch.int32, device=dev)
    n = torch.full((1,), n0, dtype=torch.int32, device=dev)
    bud = torch.full((1,), budget, dtype=torch.int32, device=dev)
    done = force_done | (n >= bud)
    if n0:
        out[:, 0] = cur
        done = done | _is_stop(cur, stop)
    return {"cur": cur.to(torch.int32).clone(), "done": done, "out": out,
            "n": n, "budget": bud, "stop": stop, "more": ~done.all()}


def _token_step(params, cfg, cache, st, attn_impl, dtype, pick,
                ids_buf=None) -> dict:
    """One forward of the token loop, in place on its state `st` and with
    no read back to the host: feed each live row's `cur` at its length
    (recorded in the shadow first when the engine keeps one, so that a
    later speculative call drafts from fresh context), pick the next token
    with `pick(logits [B, V], st)` (`_argmax`: the reference's
    `_greedy_loop`; `_sample_pick`: its `_sample_loop`) into out[:, n],
    advance n, and set `more` when some row still decodes. Rows done
    (stopped, forced, or at the budget) neither write KV nor advance their
    length. Returns {"logits": [B, 1, V]}."""
    live = ~st["done"]
    if ids_buf is not None:
        _shadow_write(ids_buf, st["cur"][:, None], cache.length, live)
    logits = _decode_step(params, cfg, cache, st["cur"][:, None], live,
                          attn_impl, dtype)
    nxt = pick(logits[:, 0], st)
    out = st["out"]
    col = st["n"].long().clamp(max=out.shape[1] - 1).expand(
        out.shape[0])[:, None]
    out.scatter_(1, col, torch.where(live, nxt, out.gather(1, col)[:, 0])
                 [:, None])
    st["n"].add_(1)
    done = st["done"] | _is_stop(nxt, st["stop"]) | (st["n"] >= st["budget"])
    st["cur"].copy_(torch.where(done, st["cur"], nxt))
    st["done"].copy_(done)
    st["more"].copy_(~done.all())
    return {"logits": logits}


def _greedy_pick(logits: torch.Tensor, st: dict) -> torch.Tensor:
    return _argmax(logits)


def _nucleus(logits: torch.Tensor, temp: torch.Tensor,
             top_p: torch.Tensor) -> torch.Tensor:
    """f32 logits / temp with the tokens outside the top-p nucleus at -inf,
    as the reference's `_sample_tok` cuts them: sort descending, drop a
    token once the probability before it exceeds top_p, always keep the
    best. The cut is by sorted index (a stable sort, so among logits tied
    at the cutoff the lower token ids stay). HF's TopPLogitsWarper keeps
    as many tokens but, sorting ascending, the higher ids of such a tie."""
    lg = (logits / temp.clamp(min=1e-6)[:, None]).float()
    order = torch.argsort(-lg, dim=-1, stable=True)
    pr = torch.softmax(lg.gather(-1, order), dim=-1)
    before = torch.cumsum(pr, dim=-1) - pr
    kth = ((before <= top_p[:, None]).sum(dim=-1) - 1).clamp(min=0)
    ranks = torch.empty_like(order)
    ranks.scatter_(-1, order, torch.arange(
        lg.shape[-1], device=lg.device).expand_as(order))
    return torch.where(ranks <= kth[:, None], lg,
                       torch.full_like(lg, float("-inf")))


def _sample_tok(logits: torch.Tensor, temp: torch.Tensor,
                top_p: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """Temperature + nucleus pick (`_nucleus`) drawn by Gumbel-max with
    `gen`; rows with temp <= 1e-3 take the argmax (HF's do_sample gate)."""
    greedy = _argmax(logits)
    masked = _nucleus(logits, temp, top_p)
    u = torch.rand(masked.shape, generator=gen, device=masked.device,
                   dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u.clamp(min=1e-20)))
    sampled = (masked + gumbel).argmax(dim=-1).to(torch.int32)
    return torch.where(temp > 1e-3, sampled, greedy)


def _draft(ids_buf: torch.Tensor, length: torch.Tensor, p: torch.Tensor,
           c: torch.Tensor, k: int) -> torch.Tensor:
    """Prompt-lookup drafts [B, k] for every row at once: the k shadow ids
    after the most recent trigram match of (ids[length-2], p, c) below the
    row's length, else after the most recent bigram match of (p, c), else
    the impossible id -7 (the row makes plain one-token progress). The
    window starts at most at capacity - k, as the reference's slice."""
    B, cap = ids_buf.shape
    dev = ids_buf.device
    idx = torch.arange(cap, device=dev)[None]
    fill = torch.full((B, 2), -2, dtype=ids_buf.dtype, device=dev)
    prev1 = torch.cat([fill[:, :1], ids_buf[:, :-1]], dim=1)
    prev2 = torch.cat([fill, ids_buf[:, :-2]], dim=1)
    length = length.long()
    p2 = ids_buf.gather(1, (length - 2).clamp(0, cap - 1)[:, None])
    m2 = (prev1 == p[:, None]) & (ids_buf == c[:, None]) & \
        (idx < length[:, None])
    m3 = m2 & (prev2 == p2) & (length >= 2)[:, None]
    none = torch.full_like(idx.expand(B, -1), -1)
    j3 = torch.where(m3, idx, none).max(dim=1).values
    j2 = torch.where(m2, idx, none).max(dim=1).values
    j = torch.where(j3 >= 0, j3, j2)
    start = (j + 1).clamp(0, cap - k)
    dr = ids_buf.gather(1, start[:, None] + torch.arange(k, device=dev)[None])
    return torch.where((j >= 0)[:, None], dr, torch.full_like(dr, -7))


def _spec_state(first, p0, max_new: int, k: int, stop, force_done):
    """The speculative loop's state (device tensors) after the call's
    first token: out [B, max_new + k + 1] (spill columns past max_new),
    the per-row token count n, the last two tokens (c0, p0), `done` and
    the verify forwards per row."""
    B, dev = first.shape[0], first.device
    out = torch.zeros((B, max_new + k + 1), dtype=torch.int32, device=dev)
    out[:, 0] = first
    n = torch.ones((B,), dtype=torch.int32, device=dev)
    done = _is_stop(first, stop) | force_done | (n >= max_new)
    return {"c0": first.to(torch.int32).clone(),
            "p0": p0.to(torch.int32).clone(), "n": n, "done": done,
            "iters": torch.zeros((B,), dtype=torch.int32, device=dev),
            "out": out, "stop": stop, "more": ~done.all()}


def _verify_step(params, cfg, cache, ids_buf, st, max_new: int, k: int,
                 attn_impl, dtype) -> dict:
    """One verify forward of the prompt-lookup speculative loop (the
    reference's `_spec_loop` body), in place on its state `st` and the
    cache, with no read back to the host: draft k tokens (`_draft`), feed
    [c0, d_1..d_k] through one cached forward, keep the longest prefix on
    which argmax agrees with the draft, trimmed at the first stop token
    and at the token budget (1 to k+1 tokens, each the greedy
    continuation), record the fed ids in the shadow, and roll the KV back
    to exactly the emitted entries by setting the length. Done rows write
    neither KV nor shadow. Returns {"logits": [B, k+1, V], "drafts":
    [B, k]}."""
    done, n = st["done"], st["n"]
    c0, p0 = st["c0"], st["p0"]
    live = ~done
    B = c0.shape[0]
    ar = torch.arange(k + 1, dtype=torch.int32, device=c0.device)[None]
    drafts = _draft(ids_buf, cache.length, p0, c0, k)
    fed = torch.cat([c0[:, None], drafts], dim=1)              # [B, k+1]
    old = cache.length.clone()
    logits = _decode_step(params, cfg, cache, fed, live, attn_impl, dtype,
                          advance=False)
    truth = _argmax(logits)                                    # [B, k+1]
    # longest accepted prefix: d_{i+1} must equal truth[i]
    match = (drafts == truth[:, :k]).to(torch.int32)
    raw_emit = torch.cumprod(match, dim=1).sum(dim=1).to(torch.int32) + 1
    stop_in = _is_stop(truth, st["stop"]) & (ar < raw_emit[:, None])
    has_stop = stop_in.any(dim=1)
    first_stop = stop_in.int().argmax(dim=1).to(torch.int32)
    emit = torch.where(has_stop, first_stop + 1, raw_emit)
    emit = torch.minimum(emit, max_new - n)
    emit = torch.where(done, torch.zeros_like(emit), emit)
    stopped = has_stop & (first_stop + 1 <= emit)
    # emitted tokens go to out[b, n_b : n_b + emit_b]; the rest of the
    # k+1 columns land in the spill columns past max_new
    col = torch.where(ar < emit[:, None], n[:, None] + ar,
                      torch.full_like(ar, max_new).expand(B, -1))
    st["out"].scatter_(1, col.long(), truth)
    _shadow_write(ids_buf, fed, old, live)
    cache.length.copy_(old + emit)
    last_i = (emit - 1).clamp(min=0)[:, None].long()
    last_tok = truth.gather(1, last_i)[:, 0]
    prev_tok = truth.gather(1, (last_i - 1).clamp(min=0))[:, 0]
    new_c0 = torch.where(emit > 0, last_tok, c0)
    p0.copy_(torch.where(emit > 1, prev_tok, torch.where(emit == 1, c0, p0)))
    c0.copy_(new_c0)
    st["iters"].add_(live.to(torch.int32))
    n.add_(emit)
    done = done | stopped | (n >= max_new)
    st["done"].copy_(done)
    st["more"].copy_(~done.all())
    return {"logits": logits, "drafts": drafts}


@dataclasses.dataclass
class EnvState:
    """Host-side per-env dialogue bookkeeping."""
    pending_token: Optional[int] = None   # last generated, not yet in KV
    frame_slots: dict = dataclasses.field(default_factory=dict)
    next_slot: int = 0
    kv_length: int = 0                    # host shadow of the KV length


class StreamingEngine:
    """Owns device state for n_envs parallel dialogues (batch axis)."""

    def __init__(self, params, cfg: StreamVLNConfig, *,
                 n_envs: int = 1,
                 cache_capacity: int = 4096,
                 feat_slots: int = 160,
                 max_new_tokens: int = 16,
                 stop_ids: Sequence[int] = (),
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 compute_dtype=torch.bfloat16,
                 attn_impl: str = "auto",
                 fused_preprocess: bool = False,
                 spec_lookup: int = 0,
                 cuda_graphs: bool = True,
                 kv_int8: bool = False,
                 fuse_proj: bool = True,
                 device="cuda"):
        self.device = resolve_device(device)
        qwen2.check_supported(cfg.llm)
        # one qkv and one gate/up product per layer, as the reference's
        # default fuse_proj=True; no-op for groups it cannot fuse
        # (LoRA-carrying) and for a fused tree. fuse_proj=False serves the
        # caller's stacks as they are (the mid-training evaluation: a
        # fused copy would sit beside the live training weights)
        self.params = fuse_projections(params) if fuse_proj else params
        self.cfg = cfg
        self.n_envs = n_envs
        self.max_new = max_new_tokens
        self.stop_ids = tuple(int(s) for s in stop_ids)
        self.buckets = tuple(sorted(buckets))
        self.attn_impl = attn_impl
        self.fused_preprocess = fused_preprocess
        self.compute_dtype = compute_dtype
        self.cache = KVCache.create(cfg.llm, n_envs, cache_capacity,
                                    compute_dtype, self.device,
                                    quantized=kv_int8)
        # prompt-lookup speculative decoding: verify spec_lookup drafted
        # tokens per decode forward (greedy-exact; _verify_step); 0 = one
        # token per forward. Its token-id shadow of the KV slots (-1 for
        # vision slots and never-written ones) exists only then.
        self.spec_lookup = int(spec_lookup)
        self.ids_buf = torch.full((n_envs, cache_capacity), -1,
                                  dtype=torch.int32, device=self.device) \
            if self.spec_lookup else None
        # +1 scratch slot: inactive batch rows write their dummy-frame
        # encoding there; hosts never assign it
        self.feat_slots = feat_slots
        self.feat_cache = torch.zeros(
            (n_envs, feat_slots + 1, cfg.tokens_per_frame,
             cfg.llm.hidden_size), dtype=compute_dtype, device=self.device)
        self.envs = [EnvState() for _ in range(n_envs)]
        self._inflight: set = set()
        # [vision, prefill, decode] ms of the last collected call (CUDA
        # events; None on CPU), and its prefill's last-position logits
        self.last_phase_ms = None
        self.last_logits = None
        # decode telemetry: tokens emitted by the decode loops against the
        # forwards that produced them (greedy and sampled: one each;
        # speculative: up to spec_lookup + 1)
        self.decode_tokens = 0
        self.decode_forwards = 0
        # sampling RNG stream: one generator on the engine's device,
        # reseeded per sampled call from (sample_seed, the call count), so
        # draws are deterministic given the seed and the order of calls
        self.sample_seed = 0
        self._sample_calls = 0
        self._gen = torch.Generator(device=self.device)
        # on the card each decode forward replays the CUDA graph captured
        # for its loop kind at first use (streaming/decode_graph.py);
        # cuda_graphs=False asks for the eager loop there too
        self.cuda_graphs = cuda_graphs
        self.graphs = {}

    # -- reset ----------------------------------------------------------
    def reset(self):
        """Full reset of every env, feature slots included."""
        self.cache.length.zero_()
        for e in self.envs:
            e.pending_token = None
            e.kv_length = 0
            e.frame_slots.clear()
            e.next_slot = 0
        self._inflight.clear()

    def reset_for_env(self, env: int):
        """Window reset: drop dialogue KV; the episode-scoped feature
        cache survives (it feeds the slow memory)."""
        mask = torch.zeros((self.n_envs,), dtype=torch.bool)
        mask[env] = True
        self.cache.reset_rows(mask)
        self.envs[env].pending_token = None
        self.envs[env].kv_length = 0

    def reset_episode(self, env: int):
        self.reset_for_env(env)
        self.envs[env].frame_slots.clear()
        self.envs[env].next_slot = 0

    # -- generate -------------------------------------------------------
    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"sequence length {n} exceeds largest bucket "
                         f"{self.buckets[-1]}")

    def _prepare_request(self, env: int, turn_ids, step_id, history_steps,
                         pad_to: int):
        st = self.envs[env]
        ids = list(map(int, turn_ids))
        if st.pending_token is not None:
            ids = [st.pending_token] + ids

        num_hist = len(history_steps)
        if num_hist:
            if num_hist != self.cfg.num_history:
                raise ValueError(
                    f"memory expects {self.cfg.num_history} history "
                    f"frames, got {num_hist}")
            missing = [s for s in history_steps if s not in st.frame_slots]
            if missing:
                raise ValueError(
                    f"history steps {missing} were never encoded; call "
                    f"backfill(env, frame, step) for them first")
            hist_slots = [st.frame_slots[s] for s in history_steps]
        else:
            hist_slots = [0] * self.cfg.num_history  # never referenced

        write_slot = st.next_slot
        if write_slot >= self.feat_slots:
            raise RuntimeError(
                f"env {env}: frame-feature cache full "
                f"({self.feat_slots} slots); raise feat_slots "
                f"or call reset_episode between episodes")
        st.frame_slots[step_id] = write_slot
        st.next_slot += 1

        layout = streamvln.build_splice_layout(
            np.asarray(ids, np.int32), self.cfg, pad_to=pad_to)
        # vision pool: memory slots first, current frame last; without a
        # <memory> sentinel frame 0 of the pool must be the current frame
        if not num_hist:
            layout.vision_index = layout.vision_index + np.int32(
                self.cfg.num_history * self.cfg.tokens_per_frame)
        return layout, hist_slots, write_slot

    def _sample_params(self, temperature, top_p):
        """(temp [B], top_p [B]) for a sampling call, or None for greedy
        (HF's do_sample gate: temperature <= 0.001 is greedy). Scalars
        apply to every row; dicts ({env: value}) give per-row settings,
        and rows at temperature 0 take the exact argmax. Each sampling
        call reseeds the engine's generator from (sample_seed, the count
        of sampling calls so far)."""
        B = self.n_envs

        def row_values(v, default):
            out = np.full((B,), default, np.float32)
            if isinstance(v, dict):
                for e, x in v.items():
                    out[int(e)] = float(x)
            elif v is not None:
                out[:] = float(v)
            return out

        temps = row_values(temperature, 0.0)
        if not np.any(temps > 1e-3):
            return None
        self._sample_calls += 1
        self._gen.manual_seed((int(self.sample_seed) * 1_000_003
                               + self._sample_calls) % (1 << 63))
        return (torch.from_numpy(temps).to(self.device),
                torch.from_numpy(row_values(top_p, 1.0)).to(self.device))

    def generate(self, env: int, frame_u8: np.ndarray, turn_ids: np.ndarray,
                 step_id: int, history_steps: Sequence[int] = (),
                 temperature: Optional[float] = None,
                 top_p: Optional[float] = None) -> List[int]:
        """One model call for one env; returns the generated token ids (up
        to and including the stop token)."""
        return self.generate_batch(
            [(env, frame_u8, turn_ids, step_id, history_steps)],
            temperature=temperature, top_p=top_p)[env]

    def generate_batch(self, requests, temperature=None, top_p=None) -> dict:
        """Blocking batched call: dispatch + collect."""
        return self.collect(self.generate_batch_async(
            requests, temperature=temperature, top_p=top_p))

    def generate_batch_async(self, requests, temperature=None,
                             top_p=None) -> dict:
        """Run model calls for several envs in one batch. requests:
        iterable of (env, frame_u8, turn_ids, step_id, history_steps);
        temperature / top_p: a scalar for every row or {env: value}. The
        decode loops read their stop flag on the host after each forward,
        so the work is done on return; `collect` settles bookkeeping."""
        requests = list(requests)
        envs = [r[0] for r in requests]
        if not envs or len(set(envs)) != len(envs):
            raise ValueError(f"need a non-empty batch of distinct envs, "
                             f"got {envs}")
        stale = self._inflight.intersection(envs)
        if stale:
            raise RuntimeError(
                f"envs {sorted(stale)} have an uncollected async handle; "
                f"collect() it before dispatching them again (pending "
                f"token / kv_length bookkeeping settles at collect)")

        # validate everything before mutating any engine state
        def ids_with_pending(env, turn_ids):
            ids = list(map(int, turn_ids))
            if self.envs[env].pending_token is not None:
                ids = [self.envs[env].pending_token] + ids
            return ids
        pad_to = self._bucket(max(
            self._expanded_len(ids_with_pending(r[0], r[2]))
            for r in requests))
        cap = self.cache.capacity
        scr = _scratch_size(self.max_new + self.spec_lookup)
        for env, frame_u8, turn_ids, step_id, history_steps in requests:
            length = self._expanded_len(ids_with_pending(env, turn_ids))
            worst = self.envs[env].kv_length + length + scr
            # the prefill writes the full padded bucket at this row's
            # offset, so the padded write must fit too
            worst = max(worst, self.envs[env].kv_length + pad_to)
            if worst > cap:
                raise RuntimeError(
                    f"env {env}: KV cache would overflow "
                    f"({worst} > capacity {cap}, incl. the padded "
                    f"{pad_to}-token bucket write); raise "
                    f"cache_capacity or shorten the window/prompt")

        self._inflight.update(envs)
        B = self.n_envs
        nh = self.cfg.num_history
        packed = np.zeros((B, 3, pad_to), np.int32)
        meta = np.zeros((B, nh + 3), np.int32)
        meta[:, nh + 1] = 1                   # inactive rows: 1 dummy tok
        frames = np.zeros((B,) + requests[0][1].shape, requests[0][1].dtype)

        prefill_lens = {}
        for env, frame_u8, turn_ids, step_id, history_steps in requests:
            layout, hist_slots, write_slot = self._prepare_request(
                env, turn_ids, step_id, history_steps, pad_to)
            prefill_lens[env] = layout.length
            packed[env, 0] = layout.token_ids
            packed[env, 1] = layout.is_vision
            packed[env, 2] = layout.vision_index
            meta[env, :nh] = hist_slots
            meta[env, nh] = write_slot
            meta[env, nh + 1] = layout.length
            meta[env, nh + 2] = 1             # active
            frames[env] = frame_u8

        timer = _PhaseTimer(self.device)
        result = self._prefill_decode(
            torch.from_numpy(frames).to(self.device),
            torch.from_numpy(packed).to(self.device),
            torch.from_numpy(meta).to(self.device), timer,
            self._sample_params(temperature, top_p))
        return {"result": result, "envs": envs,
                "prefill_lens": prefill_lens, "timer": timer}

    @torch.no_grad()
    def _prefill_decode(self, frames, packed, meta, timer, sample):
        """One streaming call. Returns [B, 2 + max_new] int32: n_out, the
        tokens, then the row's verify forwards. Inactive rows keep their KV
        lengths, shadow and feature slots."""
        cfg, params, dt = self.cfg, self.params, self.compute_dtype
        token_ids = packed[:, 0]
        is_vision = packed[:, 1].bool()
        vision_index = packed[:, 2]
        nh = cfg.num_history
        hist_slots = meta[:, :nh].long()
        lengths = meta[:, nh + 1]
        active = meta[:, nh + 2].bool()
        saved_length = self.cache.length.clone()
        B, T = token_ids.shape
        rows = torch.arange(B, device=self.device)

        # 1. encode the current frame; inactive rows write to the scratch
        # slot so their real step-0 features stay intact
        timer.mark()
        write_slot = torch.where(active, meta[:, nh],
                                 self.feat_cache.shape[1] - 1).long()
        pooled = _encode(params, cfg, frames, self.attn_impl, dt,
                         self.fused_preprocess)
        self.feat_cache[rows, write_slot] = pooled

        # 2. vision pool [B, (nh + 1) * tpf, D]: memory slots, then current
        mem = self.feat_cache[rows[:, None], hist_slots]
        pool = torch.cat([mem.reshape(B, -1, mem.shape[-1]), pooled], dim=1)

        # 3. splice + prefill
        timer.mark()
        embeds = streamvln.splice_embeds(params, pool, token_ids, is_vision,
                                         vision_index).to(dt)
        positions = self.cache.length[:, None] + torch.arange(
            T, dtype=torch.int32, device=self.device)[None]
        offsets = self.cache.length.clone()
        # generate_batch_async refused from the host shadow; this reads
        # the device lengths (once per call, outside any captured step)
        self.cache.check_room(T, active)
        logits, _ = qwen2.forward(
            params["llm"], cfg.llm, embeds, positions, cache=self.cache,
            new_lengths=lengths, attn_impl=self.attn_impl,
            write_mask=active, logits_positions=lengths - 1)
        self.last_logits = logits[:, 0]
        if self.ids_buf is not None:
            # the prompt's ids (vision slots -1) on every call that keeps a
            # shadow: sampled calls advance the KV too, and a stale shadow
            # would collapse later acceptance; idle rows keep theirs
            _shadow_write(self.ids_buf, torch.where(
                is_vision, torch.full_like(token_ids, -1), token_ids),
                offsets, active)

        # 4. decode; inactive rows are done from the start
        timer.mark()
        p0 = token_ids.gather(1, (lengths - 1).clamp(min=0)[:, None]
                              .long())[:, 0]
        first = _argmax(self.last_logits) if sample is None else \
            _sample_tok(self.last_logits, *sample, self._gen)
        result = self._decode(first, p0, active, sample)
        timer.mark()
        self.cache.length.copy_(torch.where(active, self.cache.length,
                                            saved_length))
        return result

    def _stop(self) -> torch.Tensor:
        return torch.tensor(self.stop_ids, dtype=torch.int32,
                            device=self.device)

    def _decode(self, first, p0, active, sample, pending=False):
        """The decode loop a call takes: sampled when `sample` is set, else
        speculative with spec_lookup > 0, else greedy. `first` [B] is the
        call's first token (picked from the prefill), or with `pending`
        the pending token, fed first (continue_decode); p0 is the token
        before `first` (the speculative drafter's context). Returns
        [B, 2 + max_new]: n_out, tokens, verify forwards; zeros in the
        counts of inactive rows."""
        spec = sample is None and self.spec_lookup
        if spec and pending:
            # one greedy forward of the pending token (a budget of one)
            # gives the first token; the verify loop goes on from there
            out, _, _ = self._token_loop(_token_state(
                first, 0, 1, self.max_new, self._stop(), ~active), None)
            p0, first = first, out[:, 0]
        if spec:
            st = self._run_loop("verify", self.spec_lookup + 1, _spec_state(
                first, p0, self.max_new, self.spec_lookup, self._stop(),
                ~active), sample)
            out, n_out, iters = st["out"][:, :self.max_new], st["n"], \
                st["iters"]
        else:
            out, n_out, iters = self._token_loop(_token_state(
                first, 0 if pending else 1, self.max_new, self.max_new,
                self._stop(), ~active), sample)
        zero = torch.zeros_like(n_out)
        return torch.cat([torch.where(active, n_out, zero)[:, None], out,
                          torch.where(active, iters, zero)[:, None]], dim=1)

    def _token_loop(self, state, sample):
        """Run the token loop from `state` (`_token_state`); returns (out
        [B, max_new], n_out [B], iters [B]: forwards that picked a token
        after out[:, 0])."""
        st = self._run_loop("token" if sample is None else "sample", 1,
                            state, sample)
        n_out = _n_out(st["out"], st["stop"], st["n"])
        return st["out"], n_out, (n_out - 1).clamp(min=0)

    def _step_fn(self, kind: str):
        """The step function of a loop kind over a state dict: "token"
        (greedy) and "sample" feed one token per forward, "verify" feeds
        spec_lookup + 1."""
        args = (self.params, self.cfg, self.cache)
        impl, dt = self.attn_impl, self.compute_dtype
        if kind == "verify":
            return lambda st: _verify_step(
                *args, self.ids_buf, st, self.max_new, self.spec_lookup,
                impl, dt)
        pick = _greedy_pick if kind == "token" else \
            (lambda lg, st: _sample_tok(lg, st["temp"], st["top_p"],
                                        self._gen))
        return lambda st: _token_step(*args, st, impl, dt, pick,
                                      self.ids_buf)

    def _run_loop(self, kind: str, S: int, st: dict, sample) -> dict:
        """Run the loop of `kind` (S queries per forward) from state `st`
        until its `more` flag is False, and return the final state. The
        host reads that flag before the first forward and after each one.
        On the CPU (or with cuda_graphs off) the step runs eagerly on `st`;
        on the card each forward replays the graph captured for (kind, B,
        S) and the engine's static settings, whose buffers take `st`'s
        values first and hold the final state after."""
        if sample is not None:
            st["temp"], st["top_p"] = sample
        if not bool(st["more"]):
            return st
        step = self._step_fn(kind)
        if self.device.type != "cuda" or not self.cuda_graphs:
            step(st)
            while bool(st["more"]):
                step(st)
            return st
        key = (kind, self.n_envs, S, self.max_new, self.stop_ids,
               self.attn_impl, self.compute_dtype)
        graph = self.graphs.get(key)
        if graph is None:
            graph = self.graphs[key] = decode_graph.StepGraph(
                step, st, self._graph_reads,
                self._gen if kind == "sample" else None)
        else:
            graph.load(st)
        graph.replay()
        while bool(graph.state["more"]):
            graph.replay()
        return graph.state

    def _graph_reads(self) -> dict:
        """The engine's tensors a captured step reads, by name: the cache
        (with the int8 cache's scales), the shadow and every weight leaf of
        the decoder."""
        reads = {"cache.k": self.cache.k, "cache.v": self.cache.v,
                 "cache.length": self.cache.length}
        if self.cache.quantized:
            reads["cache.k_scale"] = self.cache.k_scale
            reads["cache.v_scale"] = self.cache.v_scale
        if self.ids_buf is not None:
            reads["ids_buf"] = self.ids_buf

        def leaves(tree, prefix):
            for name, x in tree.items():
                if isinstance(x, dict):
                    leaves(x, f"{prefix}{name}/")
                elif isinstance(x, torch.Tensor):
                    reads[prefix + name] = x
        leaves(self.params["llm"], "llm/")
        return reads

    def collect(self, handle) -> dict:
        """Bring a call's results to the host ({env: token list}) and
        settle host-side bookkeeping."""
        res = handle["result"].cpu().numpy()
        self.last_phase_ms = handle["timer"].ms()
        out = {}
        self._inflight.difference_update(handle["envs"])
        for env in handle["envs"]:
            toks = self._settle(env, res)
            # KV grew by the prefill plus each decode token fed (the last
            # emitted token is pending, not yet in KV)
            self.envs[env].kv_length += handle["prefill_lens"][env] \
                + max(len(toks) - 1, 0)
            out[env] = toks
        return out

    def _settle(self, env: int, res: np.ndarray) -> List[int]:
        """Tokens of one env from a call's result rows; settles the pending
        token and the decode telemetry."""
        n_out = int(res[env, 0])
        toks = [int(t) for t in res[env, 1: 1 + n_out]]
        self.decode_tokens += max(n_out - 1, 0)
        self.decode_forwards += int(res[env, 1 + self.max_new])
        if toks:
            self.envs[env].pending_token = toks[-1]
        return toks

    @torch.no_grad()
    def continue_decode(self, env: int,
                        temperature: Optional[float] = None,
                        top_p: Optional[float] = None) -> List[int]:
        """Decode one more chunk (up to max_new_tokens) for `env` from its
        pending token, without a new frame or turn: feed the pending token,
        then run the same decode loop as a call. generate() followed by
        continue_decode() chunks equals one generate() with a larger
        budget, token for token."""
        st = self.envs[env]
        if st.pending_token is None:
            raise RuntimeError(
                f"env {env}: no pending token; call generate() first")
        if env in self._inflight:
            raise RuntimeError(f"env {env} has an uncollected async handle")
        worst = st.kv_length + 1 + _scratch_size(
            self.max_new + self.spec_lookup)
        if worst > self.cache.capacity:
            raise RuntimeError(
                f"env {env}: KV cache would overflow ({worst} > "
                f"capacity {self.cache.capacity})")
        B = self.n_envs
        pending = torch.zeros((B,), dtype=torch.int32, device=self.device)
        pending[env] = st.pending_token
        active = torch.zeros((B,), dtype=torch.bool, device=self.device)
        active[env] = True
        sample = self._sample_params(temperature, top_p)
        saved_length = self.cache.length.clone()
        # the pending token is fed first (and recorded in the shadow);
        # inactive rows are not written, their lengths restored below
        result = self._decode(pending, pending, active, sample, pending=True)
        self.cache.length.copy_(torch.where(active, self.cache.length,
                                            saved_length))
        toks = self._settle(env, result.cpu().numpy())
        st.kv_length += 1 + max(len(toks) - 1, 0)
        return toks

    def backfill(self, env: int, frame_u8: np.ndarray, step_id: int):
        """Encode a history frame never seen at a model call."""
        self.backfill_batch(env, [frame_u8], [step_id])

    @torch.no_grad()
    def backfill_batch(self, env: int, frames_u8, step_ids):
        """Encode all missing history frames in one tower pass; frames pad
        to num_history rows (padding writes to the scratch slot)."""
        st = self.envs[env]
        missing = [(f, s) for f, s in zip(frames_u8, step_ids)
                   if s not in st.frame_slots]
        if not missing:
            return
        if st.next_slot + len(missing) > self.feat_slots:
            raise RuntimeError(
                f"env {env}: frame-feature cache full "
                f"({self.feat_slots} slots); raise feat_slots")
        slots = []
        for _, s in missing:
            st.frame_slots[s] = st.next_slot
            slots.append(st.next_slot)
            st.next_slot += 1
        n_pad = self.cfg.num_history
        while len(slots) > n_pad:
            n_pad *= 2
        frames = np.zeros((n_pad,) + missing[0][0].shape,
                          missing[0][0].dtype)
        wslots = np.full((n_pad,), self.feat_slots, np.int64)  # scratch
        for i, (f, _) in enumerate(missing):
            frames[i] = f
            wslots[i] = slots[i]
        pooled = _encode(self.params, self.cfg,
                         torch.from_numpy(frames).to(self.device),
                         self.attn_impl, self.compute_dtype,
                         self.fused_preprocess)
        self.feat_cache[env, torch.from_numpy(wslots).to(self.device)] = \
            pooled

    def _expanded_len(self, ids) -> int:
        tpf = self.cfg.tokens_per_frame
        n = 0
        for t in ids:
            if t == -200:
                n += tpf
            elif t == -300:
                n += self.cfg.num_history * tpf
            else:
                n += 1
        return n
