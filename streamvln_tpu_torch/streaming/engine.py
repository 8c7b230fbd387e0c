"""Streaming inference engine of the PyTorch port (greedy path).

Counterpart of `streamvln_tpu/streaming/engine.py::StreamingEngine`, with
the same public API for this slice: `generate`, `generate_batch(_async)` /
`collect`, `reset`, `reset_for_env`, `reset_episode`, `backfill(_batch)`.

- **KV cache** (models/qwen2.KVCache): fixed capacity, per-row lengths; a
  window reset sets the env's length to 0.
- **Frame-feature cache**: each model call encodes one current frame and
  stores its pooled tokens in a per-env slab; at a window boundary the
  slow memory gathers `num_history` cached frames. The last slot is
  reserved scratch for inactive batch rows.
- **One call** (`_prefill_decode`): preprocess + encode the frame, splice,
  prefill into the cache at per-row offsets, then greedy decode with
  stop-token early exit, as an eager loop (one host check per token).
- **Buckets**: prompts pad to a few lengths, as in the reference.
- **Pending token**: the last generated token of a call is not fed in
  that call; it is prepended to the next call's tokens.
- **Weights**: float, or quantized by models/quant.py (int8, packed
  int4: decode streams the int4 projections through K6); q/k/v and
  gate/up are fused in the constructor (models/fuse.py), as the
  reference's default `fuse_proj=True` does. The fused stacks are copies
  of the caller's.
- **attn_impl**: "auto" (K1 tower, K2 prefill, dense decode), "dense",
  or "decode_kernel" (K1 tower, dense prefill, K8 decode over the live
  prefix; opt-in, as in the reference, where its own decode loop never
  reaches the kernel).

Sampling, speculative decode, `continue_decode`, fused preprocessing and
the int8 KV cache are later slices of the port.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from streamvln_tpu_torch.configs import StreamVLNConfig, resolve_device
from streamvln_tpu_torch.models import qwen2, streamvln
from streamvln_tpu_torch.models.fuse import fuse_projections
from streamvln_tpu_torch.models.qwen2 import KVCache
from streamvln_tpu_torch.ops.preprocess import preprocess_frames

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


def _encode(params, cfg, frames_u8, attn_impl, dtype):
    """[N, H, W, 3] uint8 -> pooled [N, tpf, D] in dtype."""
    pixels = preprocess_frames(frames_u8, cfg.vision.image_size, dtype=dtype)
    pooled = streamvln.encode_frames(params, cfg, pixels[:, None], attn_impl)
    return pooled.reshape(frames_u8.shape[0], cfg.tokens_per_frame,
                          -1).to(dtype)


def _greedy_loop(params, cfg, cache, last_logits, max_new: int,
                 stop_ids, attn_impl, dtype, force_done):
    """Greedy decode from `last_logits`. Returns (out [B, max_new],
    n_out [B]); appends the fed tokens' KV in place. Rows done (stopped,
    or in force_done) never advance their KV length and are not written."""
    B = last_logits.shape[0]
    dev = last_logits.device
    stop = torch.tensor(stop_ids, dtype=torch.int32, device=dev)

    def is_stop(t):
        return (t[:, None] == stop[None, :]).any(dim=-1) if len(stop_ids) \
            else torch.zeros_like(t, dtype=torch.bool)

    first = last_logits.argmax(dim=-1).to(torch.int32)
    out = torch.zeros((B, max_new), dtype=torch.int32, device=dev)
    out[:, 0] = first
    done = is_stop(first) | force_done
    cur = first
    n = 1
    while n < max_new and not bool(done.all()):
        emb = qwen2.embed_tokens(params["llm"], cur[:, None]).to(dtype)
        live = ~done
        logits, _ = qwen2.forward(
            params["llm"], cfg.llm, emb, cache.length[:, None], cache=cache,
            new_lengths=live.to(torch.int32), attn_impl=attn_impl,
            write_mask=live)
        nxt = logits[:, 0].argmax(dim=-1).to(torch.int32)
        out[:, n] = torch.where(done, out[:, n], nxt)
        done = done | is_stop(nxt)
        cur = torch.where(done, cur, nxt)
        n += 1
    stop_mask = (out[:, :, None] == stop[None, None, :]).any(dim=-1) \
        if len(stop_ids) else torch.zeros_like(out, dtype=torch.bool)
    has_stop = stop_mask.any(dim=1)
    first_stop = stop_mask.int().argmax(dim=1).to(torch.int32)
    n_out = torch.where(has_stop, first_stop + 1,
                        torch.full_like(first_stop, n))
    return out, n_out


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
                 device="cuda"):
        self.device = resolve_device(device)
        qwen2.check_supported(cfg.llm)
        # one qkv and one gate/up product per layer, as the reference's
        # default fuse_proj=True; no-op for groups it cannot fuse
        # (LoRA-carrying) and for a fused tree
        self.params = fuse_projections(params)
        self.cfg = cfg
        self.n_envs = n_envs
        self.max_new = max_new_tokens
        self.stop_ids = tuple(int(s) for s in stop_ids)
        self.buckets = tuple(sorted(buckets))
        self.attn_impl = attn_impl
        self.compute_dtype = compute_dtype
        self.cache = KVCache.create(cfg.llm, n_envs, cache_capacity,
                                    compute_dtype, self.device)
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

    # -- reset ----------------------------------------------------------
    def reset(self):
        """Full reset of every env, feature slots included."""
        self.cache.length = torch.zeros_like(self.cache.length)
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
        iterable of (env, frame_u8, turn_ids, step_id, history_steps).
        The decode loop checks its stop condition on the host each token,
        so the work is done on return; `collect` settles bookkeeping."""
        if temperature is not None and float(temperature) > 1e-3:
            raise NotImplementedError(
                "sampled decoding is a later slice of the PyTorch port")
        del top_p   # only read by sampled decoding
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
        scr = _scratch_size(self.max_new)
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
            torch.from_numpy(meta).to(self.device), timer)
        return {"result": result, "envs": envs,
                "prefill_lens": prefill_lens, "timer": timer}

    @torch.no_grad()
    def _prefill_decode(self, frames, packed, meta, timer):
        """One streaming call. Returns [B, 1 + max_new] int32: n_out, then
        the tokens. Inactive rows keep their KV lengths and feature
        slots."""
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
        pooled = _encode(params, cfg, frames, self.attn_impl, dt)
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
        logits, _ = qwen2.forward(
            params["llm"], cfg.llm, embeds, positions, cache=self.cache,
            new_lengths=lengths, attn_impl=self.attn_impl,
            write_mask=active, logits_positions=lengths - 1)
        self.last_logits = logits[:, 0]

        # 4. greedy decode; inactive rows are done from the start
        timer.mark()
        out, n_out = _greedy_loop(params, cfg, self.cache, logits[:, 0],
                                  self.max_new, self.stop_ids,
                                  self.attn_impl, dt, force_done=~active)
        timer.mark()
        self.cache.length = torch.where(active, self.cache.length,
                                        saved_length)
        n_out = torch.where(active, n_out, torch.zeros_like(n_out))
        return torch.cat([n_out[:, None], out], dim=1)

    def collect(self, handle) -> dict:
        """Bring a call's results to the host ({env: token list}) and
        settle host-side bookkeeping."""
        res = handle["result"].cpu().numpy()
        self.last_phase_ms = handle["timer"].ms()
        out = {}
        self._inflight.difference_update(handle["envs"])
        for env in handle["envs"]:
            n_out = int(res[env, 0])
            toks = [int(t) for t in res[env, 1: 1 + n_out]]
            if toks:
                self.envs[env].pending_token = toks[-1]
            # KV grew by the prefill plus each decode token fed (the last
            # emitted token is pending, not yet in KV)
            self.envs[env].kv_length += handle["prefill_lens"][env] \
                + max(n_out - 1, 0)
            out[env] = toks
        return out

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
                         self.attn_impl, self.compute_dtype)
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
