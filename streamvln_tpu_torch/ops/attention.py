"""Attention: plain PyTorch references and dispatch to the port's kernels.

Counterpart of `streamvln_tpu/ops/attention.py`. Layouts are [B, S, H, D]
(q) and [B, S, Hkv, D] or KV-head-major [B, Hkv, S, D] (k/v). GQA folds
query heads into groups over the kv heads; K/V are never repeated.
Decode attention is plain PyTorch here, as it is dense XLA (not a kernel)
in the reference.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from streamvln_tpu_torch.ops import flash_attention as fa
from streamvln_tpu_torch.ops import vit_attention as va

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
