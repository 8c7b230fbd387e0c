"""Attention: plain PyTorch references and dispatch to the port's kernels.

Counterpart of `streamvln_tpu/ops/attention.py`. Layouts are [B, S, H, D]
(q) and [B, S, Hkv, D] or KV-head-major [B, Hkv, S, D] (k/v). GQA folds
query heads into groups over the kv heads; K/V are never repeated.
Decode attention is plain PyTorch here, as it is dense XLA (not a kernel)
in the reference, and so is `chunked_attention`, the reference's
long-context path in plain XLA.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from streamvln_tpu_torch.ops import flash_attention as fa
from streamvln_tpu_torch.ops import vit_attention as va
from streamvln_tpu_torch.ops.flash_attention import INVALID_POS

NEG_INF = -1e30  # large-but-finite; avoids NaN from (-inf) - (-inf) rows


def _masked_softmax(logits, mask, logits_soft_cap):
    if logits_soft_cap is not None:
        logits = torch.tanh(logits / logits_soft_cap) * logits_soft_cap
    if mask is not None:
        # a fill on the device, not a host-made scalar: a captured decode
        # step (streaming/decode_graph.py) may not copy from the host
        logits = logits.masked_fill(~mask, NEG_INF)
    return torch.softmax(logits, dim=-1)


def dense_attention(q, k, v, mask: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None,
                    logits_soft_cap: Optional[float] = None) -> torch.Tensor:
    """softmax(q k^T * scale) v with GQA, f32 math; q [B, Sq, Hq, D],
    k/v [B, Sk, Hkv, D], mask [B, Sq, Sk] or [B, 1, Sq, Sk] bool."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    qf = q.float().reshape(B, Sq, Hkv, G, D)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * scale
    if mask is not None:
        mask = mask[:, None, None] if mask.dim() == 3 else mask[:, :, None]
    probs = _masked_softmax(logits, mask, logits_soft_cap)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(B, Sq, Hq, D).to(q.dtype)


def dense_attention_kvmajor(q, k, v, mask: Optional[torch.Tensor] = None,
                            scale: Optional[float] = None,
                            logits_soft_cap: Optional[float] = None,
                            k_scale: Optional[torch.Tensor] = None,
                            v_scale: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """dense_attention over a KV-head-major cache [B, Hkv, Sk, D]: q is
    cast to the cache dtype, products accumulate in f32, probabilities are
    cast to the cache dtype before PV (the reference's mixed precision).

    int8 cache (k_scale / v_scale [B, Hkv, Sk] f32 given): q stays in its
    dtype and the int8 k and v are cast to it (exact in bf16); the f32
    logits are multiplied by k_scale along Sk after `scale`, and the
    probabilities by v_scale in f32, then cast once to q's dtype before
    the PV product, as the reference folds the scales out of both
    products."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    quant = k_scale is not None
    cdt = q.dtype if quant else k.dtype
    qf = q.to(cdt).reshape(B, Sq, Hkv, G, D)
    logits = torch.einsum("bqhgd,bhkd->bhgqk", qf.float(),
                          k.to(cdt).float()) * scale
    if quant:
        logits = logits * k_scale[:, :, None, None, :]
    probs = _masked_softmax(logits, None if mask is None
                            else mask[:, None, None], logits_soft_cap)
    if quant:
        probs = probs * v_scale[:, :, None, None, :]
    out = torch.einsum("bhgqk,bhkd->bqhgd", probs.to(cdt).float(),
                       v.to(cdt).float())
    return out.reshape(B, Sq, Hq, D).to(q.dtype)


def chunked_attention(q, k, v, q_pos, k_pos, scale: Optional[float] = None,
                      logits_soft_cap: Optional[float] = None,
                      q_block: int = 2048, k_block: int = 8192
                      ) -> torch.Tensor:
    """The flash algorithm in plain PyTorch, the reference's
    `chunked_attention`: a loop over query blocks, an inner loop over key
    blocks with an online softmax in f32, so a block's scores are
    [B, Hkv, G, q_block, k_block] instead of [.., Sq, Sk]. q [B, Sq, Hq,
    D], k/v [B, Sk, Hkv, D], positions [B, Sq] / [B, Sk]; key j is visible
    to query i iff k_pos[j] <= q_pos[i]. Padded queries get position -1,
    padded keys INVALID_POS. Masked logits are the finite NEG_INF, so a
    query that sees no key weighs every key of the padded key blocks
    alike: its output is the mean of v over them, the padding's zeros
    included (the reference's result, not the kernels' 0). Returns q's
    dtype."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    pad_q, pad_k = (-Sq) % q_block, (-Sk) % k_block
    qf = F.pad(q.float(), (0, 0, 0, 0, 0, pad_q)) \
        .reshape(B, Sq + pad_q, Hkv, G, D)
    kf, vf = (F.pad(x.float(), (0, 0, 0, 0, 0, pad_k)) for x in (k, v))
    qp = F.pad(q_pos, (0, pad_q), value=-1)
    kp = F.pad(k_pos, (0, pad_k), value=INVALID_POS)
    outs = []
    for i in range(0, Sq + pad_q, q_block):
        qi, qpi = qf[:, i:i + q_block], qp[:, i:i + q_block]
        m = qi.new_full((B, Hkv, G, q_block), NEG_INF)
        den = qi.new_zeros((B, Hkv, G, q_block))
        acc = qi.new_zeros((B, Hkv, G, q_block, D))
        for j in range(0, Sk + pad_k, k_block):
            logits = torch.einsum("bqhgd,bkhd->bhgqk", qi,
                                  kf[:, j:j + k_block]) * scale
            if logits_soft_cap is not None:
                logits = torch.tanh(logits / logits_soft_cap) \
                    * logits_soft_cap
            mask = kp[:, None, j:j + k_block] <= qpi[:, :, None]
            logits = logits.masked_fill(~mask[:, None, None], NEG_INF)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(logits - m_new[..., None])
            den = den * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p, vf[:, j:j + k_block])
            m = m_new
        out = acc / den.clamp(min=1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4))     # [B, q_block, Hkv, G, D]
    out = torch.cat(outs, dim=1).reshape(B, Sq + pad_q, Hq, D)[:, :Sq]
    return out.to(q.dtype)


def mha_attention(q, k, v, mask: Optional[torch.Tensor] = None,
                  scale: Optional[float] = None, impl: str = "auto",
                  logits_soft_cap: Optional[float] = None) -> torch.Tensor:
    """Encoder attention dispatch, branch for branch the reference's
    (`streamvln_tpu/ops/attention.py::mha_attention`):
    - "dense": dense;
    - "auto" or "vit" under the shape rule (no mask, no soft cap,
      Sq == Sk, D <= 128, equal heads, S <= 1024): the vit kernel (K1).
      The port's "auto" stands where the reference's "auto" on the TPU
      stands, whatever the tensors' device;
    - "flash" with no mask: the flash kernel (K2) with every position 0,
      i.e. full attention, the head dim zero-padded to a kernel head dim
      (exact, as the reference's wrapper pads it); shapes it does not take
      raise NotImplementedError;
    - anything else ("decode_kernel", "chunked", "flash" with a mask, ...):
      dense.
    On CPU tensors the wrappers run their plain versions, on CUDA tensors
    they launch or raise."""
    if impl == "dense":
        return dense_attention(q, k, v, mask, scale, logits_soft_cap)
    B, Sq, H, D = q.shape
    if impl in ("auto", "vit") and mask is None and logits_soft_cap is None \
            and Sq == k.shape[1] and D <= 128 and H == k.shape[2] \
            and Sq <= 1024:
        return va.vit_attention(q, k, v, scale=scale)
    if impl == "flash" and mask is None:
        if D != k.shape[3] or H % k.shape[2]:
            raise NotImplementedError(
                f"flash kernel does not support shapes q={tuple(q.shape)} "
                f"k={tuple(k.shape)}")
        dp = next((d for d in fa.KERNEL_HEAD_DIMS if d >= D), D)
        qp, kp = (torch.zeros((B, x.shape[1]), dtype=torch.int32,
                              device=q.device) for x in (q, k))
        out = fa.flash_attention(
            *(F.pad(x, (0, dp - D)) for x in (q, k, v)), qp, kp,
            scale=D ** -0.5 if scale is None else scale,
            logits_soft_cap=logits_soft_cap)
        return out[..., :D]
    return dense_attention(q, k, v, mask, scale, logits_soft_cap)
