"""Quantization: the LLM projections weight-only (int8 per output column,
packed int4 with group-64 scales), the SigLIP tower's projections to int8,
and the int8 x int8 product with per-token activation quantization that
int8 towers and `act_int8` decoders run.

Counterpart of `streamvln_tpu/models/quant.py` (`quantize_weight`,
`int8_dynamic_matmul`, `quantize_weight_int4`, `dequant_int4`,
`is_packed_int4`, `quantize_llm`, `quantize_vision`, `init_quantized_llm`,
`dequantize_llm`, `maybe_dequant`). The packed bytes and scales are bit
for bit the JAX package's: the same f32 arithmetic and round-half-to-even.

int4 layout (the contract of ops/int4_matmul.py): uint8 [..., din/2,
dout], byte r holds w[2r] in its low nibble and w[2r+1] in its high
nibble, both signed in [-7, 7]; f32 scales [..., din/64, dout], one per
64 rows of the contraction dim and output column.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from streamvln_tpu_torch.ops.int4_matmul import unpack_nibbles

QUANT_TARGETS = ("q_w", "k_w", "v_w", "o_w", "gate_w", "up_w", "down_w")
VISION_QUANT_TARGETS = ("q_w", "k_w", "v_w", "o_w", "fc1_w", "fc2_w")
INT4_GROUP = 64


def quantize_weight(w: torch.Tensor):
    """[..., din, dout] -> (int8 values, f32 scales [..., 1, dout])."""
    wf = w.float()
    amax = wf.abs().amax(dim=-2, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return q, scale


def _clip127(x: torch.Tensor) -> torch.Tensor:
    """jnp.clip(x, -127, 127) as the reference computes it, maximum then
    minimum, so a value at a bound passes half its gradient (JAX's and
    torch's max/min split the gradient of a tie evenly; torch.clamp would
    pass all of it)."""
    lo = torch.full((), -127.0, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo), -lo)


def _int_mm(xq: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """Exact int8 [M, K] x int8 [K, N] -> int32 [M, N] (torch._int_mm). On
    the card the product needs more than 16 rows and K, N multiples of 8:
    rows are padded with zeros and sliced off; other K or N raise, since an
    f32 product in its place would be inexact past 2^24 (127^2 * 4304)."""
    M, K = xq.shape
    N = w_q.shape[1]
    if xq.device.type == "cpu":
        return torch._int_mm(xq, w_q)
    if K % 8 or N % 8:
        raise ValueError(f"int8 product on {xq.device.type}: K={K} and "
                         f"N={N} must be multiples of 8")
    if M <= 16:
        xq = torch.cat([xq, xq.new_zeros((17 - M, K))])
    return torch._int_mm(xq, w_q)[:M]


class _Int8Dot(torch.autograd.Function):
    """Integer-valued f32 x_c [M, K] times int8 w_q [K, N] -> the exact
    int32 product as f32. The backward is the reference's `_int8_dot_bwd`:
    g @ w_q.T in g's dtype, and no gradient for the int8 weight."""

    @staticmethod
    def forward(ctx, x_c, w_q):
        ctx.save_for_backward(w_q)
        return _int_mm(x_c.to(torch.int8), w_q).float()

    @staticmethod
    def backward(ctx, g):
        (w_q,) = ctx.saved_tensors
        return g @ w_q.to(g.dtype).t(), None


def int8_dynamic_matmul(x: torch.Tensor, w_q: torch.Tensor,
                        w_scale: torch.Tensor) -> torch.Tensor:
    """x [..., din] float times int8 w_q [din, dout] with per-column f32
    scales w_scale [..., dout] -> f32 [..., dout]. Each row of x is
    quantized on the fly (absmax with a 1e-8 floor, / 127), rounded with a
    straight-through estimator (the forward rounds, the gradient passes),
    clipped to +-127, multiplied exactly in int32, and both scales applied
    in f32, in the reference's order."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    x_scale = absmax.clamp(min=1e-8) / 127.0
    x_n = xf / x_scale
    x_c = _clip127(x_n + (torch.round(x_n) - x_n).detach())
    acc = _Int8Dot.apply(x_c.reshape(-1, x_c.shape[-1]), w_q)
    acc = acc.reshape(*x.shape[:-1], w_q.shape[-1])
    return acc * x_scale * w_scale.float().reshape(w_scale.shape[-1])


def quantize_weight_int4(w: torch.Tensor, group: int = INT4_GROUP):
    """[..., din, dout] -> (packed uint8 [..., din/2, dout], f32 group
    scales [..., din/group, dout]); group-wise symmetric over din."""
    *lead, din, dout = w.shape
    if din % 2:
        raise ValueError(f"int4 packing needs an even din, got {din}")
    g = group if din % group == 0 else din
    wf = w.float().reshape(*lead, din // g, g, dout)
    amax = wf.abs().amax(dim=-2, keepdim=True)
    scale = torch.where(amax > 0, amax / 7.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(wf / scale), -7, 7).to(torch.int32)
    q = q.reshape(*lead, din, dout)
    packed = (q[..., 0::2, :] & 0xF) | ((q[..., 1::2, :] & 0xF) << 4)
    return packed.to(torch.uint8), scale[..., 0, :]


def dequant_int4(w: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """Packed uint8 [..., din/2, dout] and group scales [..., G, dout] ->
    `dtype` [..., din, dout]. As in the JAX package the nibble and the
    scale are cast to `dtype` first and multiplied in it (the kernels of
    ops/int4_matmul.py multiply in f32 and round once instead)."""
    *lead, half, dout = w.shape
    din = half * 2
    lo, hi = unpack_nibbles(w)
    q = torch.stack([lo, hi], dim=-2).reshape(*lead, din, dout)
    G = scale.shape[-2]
    wf = q.to(dtype).reshape(*lead, G, din // G, dout)
    wf = wf * scale[..., :, None, :].to(dtype)
    return wf.reshape(*lead, din, dout)


def is_packed_int4(w) -> bool:
    """Packed int4 leaves are the only uint8 params in the tree."""
    return getattr(w, "dtype", None) == torch.uint8


def _per_layer(fn, w: torch.Tensor):
    """fn over the leading [L] axis of a stack one layer at a time, so the
    f32 temporaries are one layer's, not the stack's."""
    if w.dim() < 3:
        return fn(w)
    outs = [fn(w[i]) for i in range(w.shape[0])]
    return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])


def _quantize_embed(emb: torch.Tensor, scale_dtype=torch.float32):
    """Per-row int8 for the embedding table (rows are gathered)."""
    e = emb.float()
    amax = e.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(e / scale), -127, 127).to(torch.int8)
    return q, scale.to(scale_dtype)


def quantize_llm(params: dict, targets: Sequence[str] = QUANT_TARGETS,
                 quantize_embed: bool = False, bits: int = 8) -> dict:
    """Quantize the LLM layer-stack projections (and the lm_head; the embed
    to per-row int8 with quantize_embed). Returns a new tree with `<name>`
    as int8 (bits=8) or packed int4 (bits=4) and `<name>_scale` beside it;
    the input tree is not changed. Stacks are quantized layer by layer."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    qfn = quantize_weight if bits == 8 else quantize_weight_int4
    llm = dict(params["llm"])
    layers = dict(llm["layers"])
    for name in targets:
        if name not in layers:
            continue
        layers[name], layers[name + "_scale"] = _per_layer(qfn, layers[name])
    llm["layers"] = layers
    if "lm_head" in llm:
        llm["lm_head"], llm["lm_head_scale"] = qfn(llm["lm_head"])
    if quantize_embed:
        llm["embed"], llm["embed_scale"] = _quantize_embed(llm["embed"])
    return dict(params, llm=llm)


def quantize_vision(vision: dict,
                    targets: Sequence[str] = VISION_QUANT_TARGETS) -> dict:
    """The SigLIP tower's layer-stack projections to int8 per output column
    (`<name>` int8 and `<name>_scale` beside it); `siglip.forward_embeddings`
    runs such projections through int8_dynamic_matmul. The patch embed,
    positions, biases and norms stay float. Returns a new tree."""
    layers = dict(vision["layers"])
    for name in targets:
        layers[name], layers[name + "_scale"] = _per_layer(quantize_weight,
                                                           layers[name])
    return dict(vision, layers=layers)


def init_quantized_llm(cfg, generator: Optional[torch.Generator] = None,
                       device="cuda", compute_dtype=torch.bfloat16,
                       quantize_embed: bool = True, bits: int = 8) -> dict:
    """Random LLM weights (the fan-in-scaled normal init) made directly in
    int8/int4 on `device`, one layer at a time, so the transient memory is
    one unstacked f32 weight. The numbers differ from the JAX init of the
    same seed; the embed scale is in compute_dtype, as in JAX."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    qfn = quantize_weight if bits == 8 else quantize_weight_int4
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    L, Dm, F = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    Hq, Hkv, Dh, V = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                      cfg.vocab_size)

    def normal(shape, fan_in):
        w = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return w.mul_(fan_in ** -0.5)

    def q_dense(shape, fan_in):
        qs, scales = zip(*(qfn(normal(shape[1:], fan_in))
                           for _ in range(shape[0])))
        return torch.stack(qs), torch.stack(scales)

    layers = {
        "ln1": torch.ones((L, Dm), dtype=compute_dtype, device=device),
        "q_b": torch.zeros((L, Hq * Dh), dtype=compute_dtype, device=device),
        "k_b": torch.zeros((L, Hkv * Dh), dtype=compute_dtype, device=device),
        "v_b": torch.zeros((L, Hkv * Dh), dtype=compute_dtype, device=device),
        "ln2": torch.ones((L, Dm), dtype=compute_dtype, device=device),
    }
    for name, shape, fan in (
            ("q_w", (L, Dm, Hq * Dh), Dm), ("k_w", (L, Dm, Hkv * Dh), Dm),
            ("v_w", (L, Dm, Hkv * Dh), Dm), ("o_w", (L, Hq * Dh, Dm), Hq * Dh),
            ("gate_w", (L, Dm, F), Dm), ("up_w", (L, Dm, F), Dm),
            ("down_w", (L, F, Dm), F)):
        layers[name], layers[name + "_scale"] = q_dense(shape, fan)
    out = {"layers": layers,
           "final_norm": torch.ones((Dm,), dtype=compute_dtype, device=device)}
    if quantize_embed:
        out["embed"], out["embed_scale"] = _quantize_embed(
            normal((V, Dm), Dm), compute_dtype)
    else:
        out["embed"] = normal((V, Dm), Dm).to(compute_dtype)
    if not cfg.tie_word_embeddings:
        out["lm_head"], out["lm_head_scale"] = qfn(normal((V, Dm), Dm).t())
    return out


def dequantize_llm(params: dict, dtype=torch.float32) -> dict:
    """Inverse of quantize_llm: every int8 leaf becomes `value * scale` and
    every packed int4 leaf `dequant_int4(...)`, in `dtype`; the `*_scale`
    companions are dropped. Stacks are dequantized layer by layer."""
    def one(name, w, group):
        if w.dtype == torch.int8:
            scale = group[name + "_scale"].to(dtype)
            return w.to(dtype) * scale
        if is_packed_int4(w):
            s = group[name + "_scale"]
            if w.dim() == 3:
                return torch.stack([dequant_int4(w[i], s[i], dtype)
                                    for i in range(w.shape[0])])
            return dequant_int4(w, s, dtype)
        return w

    def dequant_group(group: dict) -> dict:
        return {name: one(name, w, group) for name, w in group.items()
                if not name.endswith("_scale") and name != "layers"}

    llm = dequant_group(params["llm"])
    llm["layers"] = dequant_group(params["llm"]["layers"])
    return dict(params, llm=llm)


def maybe_dequant(p: dict, name: str, compute_dtype=torch.bfloat16):
    """Weight leaf for a matmul: int8 and packed int4 (uint8) -> scaled
    compute dtype, other dtypes pass through. (The JAX twin tests for
    jnp.int4, a dtype its own quantizer never makes, so it passes packed
    uint8 through; here packed leaves are dequantized.)"""
    w = p[name]
    if w.dtype == torch.int8:
        return w.to(compute_dtype) * p[name + "_scale"].to(compute_dtype)
    if is_packed_int4(w):
        return dequant_int4(w, p[name + "_scale"], compute_dtype)
    return w
