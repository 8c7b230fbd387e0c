"""Qwen2 decoder (RMSNorm + RoPE + GQA with qkv bias + SwiGLU), PyTorch:
inference with a KV cache, and the training forward.

Counterpart of `streamvln_tpu/models/qwen2.py` for the Qwen2 defaults.
Parameters are the reference's dict layout with per-layer weights stacked
on a leading [L] axis and matrices stored [in, out]; the layer stack runs
as an eager Python loop. Every projection keeps its f32 sum: the bias and
any LoRA delta (`<w>_lora_a/_lora_b` stacks and `lora_scale`,
models/lora.py) are added in f32 before the one cast to x's dtype, and the
lm_head returns f32 logits, as `jnp.dot(..., preferred_element_type=f32)`
does in the reference. Weights may be float, int8 with per-column scales
or packed int4 with group scales (models/quant.py), and q/k/v and gate/up
may be fused (`qkv_w`, `gu_w`; models/fuse.py). Kernel-eligible int4
projections go to K6 at up to KERNEL_MAX_ROWS rows and to K7 plus one
product above (ops/int4_matmul.py), each handed its layer's view of the
stack (contiguous, no copy). The training knobs are the reference's:
`remat` (one non-reentrant `torch.utils.checkpoint` per layer),
`remat_chunk` (nested: a checkpoint per chunk of layers around the
per-layer ones), `mlp_chunk` (token-chunked MLP, a checkpoint per chunk)
and `return_hidden`. With `cfg.act_int8`, int8 projections quantize their
activations per token and multiply int8 x int8 in int32
(`quant.int8_dynamic_matmul`). Family knobs (MoE, alibi, LayerNorm, gelu
MLPs, Gemma scalings) are later slices of the port and raise
NotImplementedError here. attn_impl="chunked" runs the reference's
chunked attention (`ops/attention.py::chunked_attention`, plain PyTorch)
where the reference does: without a cache at S >= 64.

KV cache: [L, B, Hkv, Smax, D] per tensor (KV-head-major), slot index ==
global token position, per-row fill lengths. Appends write in place at
each row's offset, read on the device (one masked scatter per layer and
tensor, as the reference's `_append_stack`), and `length` is updated in
place, so a decode step reads nothing back to the host and a captured
CUDA graph keeps reading the cache it captured. The reference's decode
loop appends into a small scratch cache merged after the loop (an XLA
loop-carry workaround); the port's decode appends in place into the big
cache. Tokens, `length` and every slot below `length` are the same.

The int8 cache (`KVCache.create(..., quantized=True)`) holds int8 k/v and
f32 scales [L, B, Hkv, Smax], one per (token, head), amax / 127 after
RoPE. A forward of fewer than 64 tokens (every decode and verify forward)
attends over the int8 cache with the scales folded into the logits and
the probabilities (`dense_attention_kvmajor`), whatever `attn_impl` is: it
stands for the reference's decode loop, whose two-source attention over
the cache and its scratch always takes that path, so K8 is not reached. A
longer forward (prefill) dequantizes the layer's cache to the compute
dtype and attends through `_attend` (K2 under "auto"/"flash").
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from streamvln_tpu_torch.configs import Qwen2Config
from streamvln_tpu_torch.models.quant import (dequant_int4,
                                              int8_dynamic_matmul)
from streamvln_tpu_torch.ops import decode_attention as da
from streamvln_tpu_torch.ops import flash_attention as fa
from streamvln_tpu_torch.ops.attention import (chunked_attention,
                                               dense_attention,
                                               dense_attention_kvmajor)
from streamvln_tpu_torch.ops.flash_attention import INVALID_POS
from streamvln_tpu_torch.ops.int4_matmul import (KERNEL_MAX_ROWS,
                                                 int4_kernel_eligible,
                                                 int4_matmul,
                                                 int4_prefill_matmul)
from streamvln_tpu_torch.ops.linear import matmul_f32

Params = dict

_LATER = "a later slice of the PyTorch port"


def check_supported(cfg: Qwen2Config) -> None:
    """Raise for decoder configurations this slice does not serve."""
    unsupported = {
        "num_experts": (cfg.num_experts, 0, "MoE MLPs"),
        "positional": (cfg.positional, "rope", "alibi positions"),
        "norm_type": (cfg.norm_type, "rmsnorm", "LayerNorm decoders"),
        "mlp_act": (cfg.mlp_act, "silu", "gelu MLPs"),
        "mlp_gated": (cfg.mlp_gated, True, "ungated MLPs"),
        "norm_offset": (cfg.norm_offset, False, "(1 + w) RMSNorm"),
        "scale_embeddings": (cfg.scale_embeddings, False,
                             "scaled embeddings"),
    }
    for field, (got, want, what) in unsupported.items():
        if got != want:
            raise NotImplementedError(
                f"{what} ({field}={got!r}) are {_LATER}")


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """HF half-rotation RoPE; x [B, S, H, D], positions [B, S]."""
    D = x.shape[-1]
    inv_freq = rope_frequencies(D, theta, x.device)
    angles = positions.float()[:, :, None] * inv_freq[None, None]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def _int4_product(x: torch.Tensor, w: torch.Tensor,
                  s: torch.Tensor) -> Optional[torch.Tensor]:
    """x @ dequant(w) as f32 through K6 (rows <= KERNEL_MAX_ROWS) or K7 +
    one product, for one layer's packed weight w [din/2, dout] and scales
    s [G, dout]; None when the shape is not kernel-eligible."""
    if not int4_kernel_eligible(w[None], s[None]):
        return None
    x2 = x.reshape(-1, x.shape[-1])
    fn = int4_matmul if x2.shape[0] <= KERNEL_MAX_ROWS \
        else int4_prefill_matmul
    return fn(x2, w[None], s[None], 0).reshape(*x.shape[:-1], w.shape[-1])


def _proj(x: torch.Tensor, p: dict, name: str, lora_scale=None,
          act_int8: bool = False) -> torch.Tensor:
    """x @ p[name] with the f32 sum kept, plus the bias `<name[:-2]>_b`
    and the LoRA delta `x @ A @ B * lora_scale` in f32, then one cast to
    x's dtype. int8 weights apply their per-column scale to the f32
    output, or with act_int8 run int8_dynamic_matmul; packed int4 weights
    take the kernels when eligible, else the reference's materialized
    dequant (`dequant_int4` in x's dtype)."""
    w = p[name]
    if w.dtype == torch.uint8:
        out = _int4_product(x, w, p[name + "_scale"])
        if out is None:
            out = matmul_f32(x, dequant_int4(w, p[name + "_scale"], x.dtype))
    elif w.dtype == torch.int8 and act_int8:
        out = int8_dynamic_matmul(x, w, p[name + "_scale"])
    elif w.dtype == torch.int8:
        out = matmul_f32(x, w.to(x.dtype)) * p[name + "_scale"].float()
    else:
        out = matmul_f32(x, w)
    b = p.get(name[:-2] + "_b")
    if b is not None:
        out = out + b.float()
    if lora_scale is not None and name + "_lora_a" in p:
        low = torch.matmul(x.float(), p[name + "_lora_a"].float())
        out = out + torch.matmul(low, p[name + "_lora_b"].float()) \
            * lora_scale
    return out.to(x.dtype)


class KVCache:
    """Fixed-capacity per-layer KV buffers with per-row fill lengths.

    k, v: [L, B, Hkv, Smax, D]; length: [B] int32 on the cache's device.
    Quantized: k, v int8 and k_scale, v_scale f32 [L, B, Hkv, Smax] (no
    trailing singleton dim), applied at read."""

    def __init__(self, k: torch.Tensor, v: torch.Tensor,
                 length: torch.Tensor, k_scale: Optional[torch.Tensor] = None,
                 v_scale: Optional[torch.Tensor] = None):
        self.k, self.v, self.length = k, v, length
        self.k_scale, self.v_scale = k_scale, v_scale

    @classmethod
    def create(cls, cfg: Qwen2Config, batch: int, capacity: int,
               dtype=torch.bfloat16, device="cuda",
               quantized: bool = False) -> "KVCache":
        shape = (cfg.num_layers, batch, cfg.num_kv_heads, capacity,
                 cfg.head_dim)
        length = torch.zeros((batch,), dtype=torch.int32, device=device)
        if quantized:
            return cls(torch.zeros(shape, dtype=torch.int8, device=device),
                       torch.zeros(shape, dtype=torch.int8, device=device),
                       length,
                       torch.ones(shape[:-1], dtype=torch.float32,
                                  device=device),
                       torch.ones(shape[:-1], dtype=torch.float32,
                                  device=device))
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device), length)

    @property
    def capacity(self) -> int:
        return self.k.shape[3]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    def reset_rows(self, row_mask: torch.Tensor) -> None:
        """Zero the lengths of selected rows in place (stale KV is never
        attended: its slots sit at positions past the row's queries); the
        values and scales stay."""
        self.length.masked_fill_(row_mask.to(self.length.device), 0)

    def check_room(self, S: int, write_mask: Optional[torch.Tensor] = None
                   ) -> None:
        """Raise if a write of S tokens at a written row's length would
        pass the capacity (the device write would clamp its start over
        live slots). Reads the lengths on the host: for callers outside a
        decode step, such as the engine's prefill, once per call."""
        rows = [True] * self.length.shape[0] if write_mask is None \
            else write_mask.tolist()
        for b, (off, on) in enumerate(zip(self.length.tolist(), rows)):
            if on and off + S > self.capacity:
                raise RuntimeError(
                    f"row {b}: KV write of {S} tokens at offset {off} "
                    f"overflows capacity {self.capacity}")


def _append(buf: torch.Tensor, new: torch.Tensor, start: torch.Tensor,
            rows: Optional[torch.Tensor]) -> None:
    """buf [B, Hkv, Smax, D] or, for the int8 cache's scales,
    [B, Hkv, Smax] (one layer, in place); new [B, S, Hkv, D] or
    [B, S, Hkv]; start [B] (int64, already clamped to Smax - S). Row b's S
    tokens go to slots start[b]..start[b]+S-1; rows with rows[b] False
    write back what those slots hold (idle batch rows), as the reference's
    `_append_stack` and `_append_stack_scale` do."""
    B, S, Hkv = new.shape[:3]
    tail = new.shape[3:]
    idx = start[:, None] + torch.arange(S, device=buf.device)[None]
    idx = idx.reshape(B, 1, S, *(1,) * len(tail)).expand(B, Hkv, S, *tail)
    upd = new.transpose(1, 2).to(buf.dtype)
    if rows is not None:
        upd = torch.where(rows.reshape(B, *(1,) * (upd.dim() - 1)), upd,
                          buf.gather(2, idx))
    buf.scatter_(2, idx, upd)


def _quantize_kv(x: torch.Tensor):
    """[B, S, H, D] -> (int8 values, f32 scales [B, S, H]): symmetric per
    (token, head), scale = amax / 127 (1 for an all-zero vector), rounded
    half to even, post-RoPE, as the reference's `_quantize_kv`."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale[..., 0]


def _dequant_kv(buf: torch.Tensor, scale: torch.Tensor, dtype):
    """[B, H, Smax, D] int8 and [B, H, Smax] f32 scales -> `dtype`."""
    return (buf.float() * scale[..., None]).to(dtype)


def _attend(cfg: Qwen2Config, attn_impl: str, q, k, v, q_pos, k_pos,
            kv_major: bool = False, kv_scales=None):
    """Visibility rule `k_pos <= q_pos`, in the reference's order:
    - on an int8 cache with its scales (`kv_scales` = (k_scale, v_scale)):
      S < 64 (every decode and verify forward) is dense attention with the
      scales folded in, before any kernel; a longer forward dequantizes
      the cache to q's dtype and goes on below (K2 under "auto"/"flash");
    - under attn_impl="decode_kernel", a single query on the cache: the
      decode kernel (K8) over the keys below q_pos + 1 (slot == position);
      its prefill is dense;
    - S >= 64 and a 128-multiple head dim under "auto"/"flash": the flash
      kernel (K2), by shape alone (its wrapper runs the plain version on
      CPU tensors and launches or raises on CUDA ones);
    - "chunked" without a cache at S >= 64: chunked_attention (the flash
      algorithm in plain PyTorch, O(block^2) memory);
    - everything else: plain dense PyTorch."""
    if kv_major and kv_scales is not None:
        if q.shape[1] < 64:
            mask = k_pos[:, None, :] <= q_pos[:, :, None]
            return dense_attention_kvmajor(
                q, k, v, mask, logits_soft_cap=cfg.attn_logits_soft_cap,
                k_scale=kv_scales[0], v_scale=kv_scales[1])
        k = _dequant_kv(k, kv_scales[0], q.dtype)
        v = _dequant_kv(v, kv_scales[1], q.dtype)
    if attn_impl == "decode_kernel" and kv_major and q.shape[1] == 1 \
            and cfg.head_dim % 128 == 0 and k.shape[2] % 512 == 0:
        return da.decode_attention(q, k, v, q_pos[:, 0] + 1)
    if attn_impl in ("auto", "flash") and cfg.head_dim % 128 == 0 \
            and q.shape[1] >= 64:
        return fa.flash_attention(q, k, v, q_pos, k_pos, kv_major=kv_major,
                                  logits_soft_cap=cfg.attn_logits_soft_cap)
    if attn_impl == "chunked" and not kv_major and q.shape[1] >= 64:
        return chunked_attention(q, k, v, q_pos, k_pos,
                                 logits_soft_cap=cfg.attn_logits_soft_cap)
    mask = k_pos[:, None, :] <= q_pos[:, :, None]
    fn = dense_attention_kvmajor if kv_major else dense_attention
    return fn(q, k, v, mask, logits_soft_cap=cfg.attn_logits_soft_cap)


def _layer(cfg: Qwen2Config, attn_impl: str, x: torch.Tensor, p: dict,
           positions, k_pos, lora_scale=None, mlp_chunk=None,
           cache_kv=None) -> torch.Tensor:
    """One decoder block on x [B, S, Dm]; p holds this layer's tensors
    under the stack names. cache_kv = (k_buf, v_buf, k_scale, v_scale,
    start, rows) appends this call's K/V into one layer of the cache (the
    scales None for a float cache) and attends over it."""
    B, S, _ = x.shape
    Hq, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def proj(h, name):
        return _proj(h, p, name, lora_scale, cfg.act_int8)

    h = rms_norm(x, p["ln1"], cfg.rms_norm_eps)
    if "qkv_w" in p:
        # fused (models/fuse.py): output columns are independent sums, so
        # the split equals the three projections
        q, k, v = proj(h, "qkv_w").split([Hq * Dh, Hkv * Dh, Hkv * Dh], -1)
    else:
        q, k, v = proj(h, "q_w"), proj(h, "k_w"), proj(h, "v_w")
    q = apply_rope(q.reshape(B, S, Hq, Dh), positions, cfg.rope_theta)
    k = apply_rope(k.reshape(B, S, Hkv, Dh), positions, cfg.rope_theta)
    v = v.reshape(B, S, Hkv, Dh)
    if cache_kv is not None:
        kbuf, vbuf, kscale, vscale, start, rows = cache_kv
        scales = None
        if kscale is None:
            _append(kbuf, k, start, rows)
            _append(vbuf, v, start, rows)
        else:
            for buf, sbuf, t in ((kbuf, kscale, k), (vbuf, vscale, v)):
                tq, ts = _quantize_kv(t)
                _append(buf, tq, start, rows)
                _append(sbuf, ts, start, rows)
            scales = (kscale, vscale)
        attn = _attend(cfg, attn_impl, q, kbuf, vbuf, positions, k_pos,
                       kv_major=True, kv_scales=scales)
    else:
        attn = _attend(cfg, attn_impl, q, k, v, positions, k_pos)
    x = x + proj(attn.reshape(B, S, Hq * Dh), "o_w")
    h = rms_norm(x, p["ln2"], cfg.rms_norm_eps)

    def mlp(hb):
        if "gu_w" in p:
            gate, up = proj(hb, "gu_w").chunk(2, dim=-1)
        else:
            gate, up = proj(hb, "gate_w"), proj(hb, "up_w")
        act = (F.silu(gate.float()) * up.float()).to(x.dtype)
        return proj(act, "down_w")

    if mlp_chunk and S > mlp_chunk and S % mlp_chunk == 0:
        # token-chunked MLP, each chunk recomputed in the backward: bounds
        # the [B, S, intermediate] temps; identical math per token
        return x + torch.cat([checkpoint(mlp, hb, use_reentrant=False)
                              for hb in h.split(mlp_chunk, dim=1)], dim=1)
    return x + mlp(h)


def forward(
    params: Params,
    cfg: Qwen2Config,
    inputs_embeds: torch.Tensor,              # [B, S, Dm]
    positions: torch.Tensor,                  # [B, S] global positions
    cache: Optional[KVCache] = None,
    new_lengths: Optional[torch.Tensor] = None,   # [B] real new tokens
    valid: Optional[torch.Tensor] = None,     # [B, S] bool (no cache)
    attn_impl: str = "auto",
    write_mask: Optional[torch.Tensor] = None,    # [B] bool
    logits_positions: Optional[torch.Tensor] = None,  # [B]
    remat: bool = False,
    remat_chunk: Optional[int] = None,
    mlp_chunk: Optional[int] = None,
    return_hidden: bool = False,
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Run the decoder stack. Returns (f32 logits [B, S, V] or [B, 1, V]
    with logits_positions, or the final-normed hidden states with
    return_hidden; the cache updated in place).

    With a cache, the S new tokens' KV are written at each row's offset
    `cache.length`, read on the device, with the start clamped to
    capacity - S as the reference's dynamic_update_slice clamps it (rows
    with write_mask False write back what they hold), keys are the cache
    slots (k_pos = slot index), and `length` grows in place by
    new_lengths (default S). Nothing is read back to the host: callers
    refuse a write past the capacity beforehand (`KVCache.check_room`, or
    the engine's guard from its host shadow). Without a cache, keys past
    `valid` get INVALID_POS. remat/remat_chunk apply to the no-cache
    (training) path: the cache path is inference and appends in place."""
    check_supported(cfg)
    B, S, _ = inputs_embeds.shape
    dev = inputs_embeds.device
    x = inputs_embeds

    if cache is not None:
        if new_lengths is None:
            new_lengths = torch.full((B,), S, dtype=torch.int32, device=dev)
        start = cache.length.long().clamp(0, cache.capacity - S)
        k_pos = torch.arange(cache.capacity, dtype=torch.int32,
                             device=dev)[None].expand(B, -1).contiguous()
    elif valid is None:
        k_pos = positions
    else:
        k_pos = torch.where(valid, positions,
                            torch.full_like(positions, INVALID_POS))

    lora_scale = params.get("lora_scale")
    stacks = {k: v.unbind(0) for k, v in params["layers"].items()}

    def one(i, y):
        cache_kv = None if cache is None else (
            cache.k[i], cache.v[i],
            None if cache.k_scale is None else cache.k_scale[i],
            None if cache.v_scale is None else cache.v_scale[i],
            start, write_mask)
        return _layer(cfg, attn_impl, y, {k: v[i] for k, v in stacks.items()},
                      positions, k_pos, lora_scale, mlp_chunk, cache_kv)

    L = cfg.num_layers
    if cache is None and remat and remat_chunk and remat_chunk > 1 \
            and L % remat_chunk == 0:
        # nested remat: the backward keeps one residual-stream input per
        # chunk of layers and recomputes the chunk (per-layer checkpoints
        # inside), at the cost of one more chunk forward
        def chunk(y, c):
            for j in range(remat_chunk):
                y = checkpoint(one, c * remat_chunk + j, y,
                               use_reentrant=False)
            return y
        for c in range(L // remat_chunk):
            x = checkpoint(chunk, x, c, use_reentrant=False)
    elif cache is None and remat:
        for i in range(L):
            x = checkpoint(one, i, x, use_reentrant=False)
    else:
        for i in range(L):
            x = one(i, x)

    if cache is not None:
        cache.length.add_(new_lengths.to(torch.int32))
    if logits_positions is not None:
        x = x[torch.arange(B, device=dev), logits_positions.long()][:, None]
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    if return_hidden:
        return x, cache
    return lm_head_logits(params, x), cache


def lm_head_logits(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Final-normed hidden states -> f32 vocabulary logits (the f32 sum,
    never rounded to x's dtype). int8 heads (or a tied int8 embed) scale
    the f32 logits per vocabulary column; a kernel-eligible packed int4
    head goes to K6 on its [1, din/2, V] view at up to KERNEL_MAX_ROWS
    rows, to K7 plus one product above."""
    head = params.get("lm_head")
    head_scale = None
    if head is None:
        head = params["embed"].t()
        if head.dtype == torch.int8:
            head_scale = params["embed_scale"].float()[:, 0]
            head = head.to(x.dtype)
    elif head.dtype == torch.int8:
        head_scale = params["lm_head_scale"].float()
        head = head.to(x.dtype)
    elif head.dtype == torch.uint8:
        logits = _int4_product(x, head, params["lm_head_scale"])
        if logits is not None:
            return logits
        head = dequant_int4(head, params["lm_head_scale"], x.dtype)
    logits = matmul_f32(x, head)
    if head_scale is not None:
        logits = logits * head_scale
    return logits


def embed_tokens(params: Params, input_ids: torch.Tensor) -> torch.Tensor:
    """Token embedding lookup; sentinel (negative) ids map to zeros. An int8
    embed is scaled per row, in the scale's dtype."""
    safe = input_ids.clamp(min=0)
    emb = params["embed"][safe]
    if emb.dtype == torch.int8:
        scale = params["embed_scale"][safe]
        emb = emb.to(scale.dtype) * scale
    return torch.where((input_ids >= 0)[..., None], emb,
                       torch.zeros((), dtype=emb.dtype, device=emb.device))
