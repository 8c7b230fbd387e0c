"""K2: causal-by-position GQA flash attention (decoder prefill).

Replaces `streamvln_tpu/ops/flash_attention.py::_flash_kernel`. The CUDA
kernel (`csrc/flash_attention.cu` over `csrc/attention_tile.cuh`) runs one
block per (batch, q head, 64-row q tile), reads the KV-head-major cache in
place (`kv_major=True`) or the [B, Sk, Hkv, D] layout, and skips key tiles
whose smallest position exceeds the block's largest query position, so a
prefill over a 4096-slot cache costs only the live prefix. At prefill
shapes the tensor cores bound it; the simple kernel feeds them bf16
operands through mma.sync with f32 accumulation (the TPU kernel upcasts
to f32), which puts its error at bf16 rounding of P.

`flash_attention` is the wrapper: CPU tensors run `flash_attention_plain`;
CUDA tensors launch the kernel or raise. `launches` counts kernel launches.
"""
from __future__ import annotations

from typing import Optional

import torch

from streamvln_tpu_torch.kernels import build

NEG_INF = -1e30
INVALID_POS = 1 << 30

launches = 0


def _default_positions(B, S, device):
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(
        B, S)


def flash_attention_plain(q, k, v, q_positions=None, k_positions=None,
                          scale: Optional[float] = None,
                          logits_soft_cap: Optional[float] = None,
                          kv_major: bool = False) -> torch.Tensor:
    """Plain PyTorch version: f32 dense attention under the visibility
    rule k_pos <= q_pos, GQA kv head = q head // G, rows with no visible
    key give exact zeros, output in q's dtype."""
    B, Sq, Hq, D = q.shape
    if not kv_major:
        k, v = k.transpose(1, 2), v.transpose(1, 2)       # [B, Hkv, Sk, D]
    Hkv, Sk = k.shape[1], k.shape[2]
    G = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    if q_positions is None:
        q_positions = _default_positions(B, Sq, q.device)
    if k_positions is None:
        k_positions = _default_positions(B, Sk, q.device)
    qf = q.float().reshape(B, Sq, Hkv, G, D)
    logits = torch.einsum("bqhgd,bhkd->bhgqk", qf, k.float()) * scale
    if logits_soft_cap is not None:
        logits = torch.tanh(logits / logits_soft_cap) * logits_soft_cap
    mask = k_positions[:, None, :] <= q_positions[:, :, None]   # [B, Sq, Sk]
    logits = torch.where(mask[:, None, None], logits,
                         torch.tensor(NEG_INF, device=q.device))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bqhgd", probs, v.float())
    seen = mask.any(dim=-1)[:, :, None, None, None]
    out = torch.where(seen, out, torch.zeros((), device=q.device))
    return out.reshape(B, Sq, Hq, D).to(q.dtype)


def flash_attention(q, k, v, q_positions=None, k_positions=None,
                    scale: Optional[float] = None,
                    logits_soft_cap: Optional[float] = None,
                    kv_major: bool = False) -> torch.Tensor:
    """q [B, Sq, Hq, D]; k/v [B, Hkv, Sk, D] when kv_major (cache layout)
    else [B, Sk, Hkv, D]; positions [B, S] int32 (default arange)."""
    global launches
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, q_positions, k_positions,
                                     scale, logits_soft_cap, kv_major)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    B, Sq, Hq, D = q.shape
    if kv_major:
        _, Hkv, Sk, Dk = k.shape
        kst = lambda x: (x.stride(0), x.stride(2), x.stride(1))  # noqa: E731
    else:
        _, Sk, Hkv, Dk = k.shape
        kst = lambda x: (x.stride(0), x.stride(1), x.stride(2))  # noqa: E731
    if v.shape != k.shape or Dk != D or Hq % Hkv:
        raise ValueError(f"flash_attention: bad shapes q={tuple(q.shape)} "
                         f"k={tuple(k.shape)} v={tuple(v.shape)}")
    if q.dtype != torch.bfloat16 or D not in (64, 128):
        raise ValueError(f"flash_attention kernel takes bf16 with head dim "
                         f"64 or 128, got {q.dtype} and {D}; use "
                         f"attn_impl='dense' for other CUDA inputs")
    if scale is None:
        scale = D ** -0.5
    if q_positions is None:
        q_positions = _default_positions(B, Sq, q.device)
    if k_positions is None:
        k_positions = _default_positions(B, Sk, q.device)
    q_positions = q_positions.to(torch.int32).contiguous()
    k_positions = k_positions.to(torch.int32).contiguous()
    if q_positions.shape != (B, Sq) or k_positions.shape != (B, Sk):
        raise ValueError("flash_attention: positions must be [B, Sq] and "
                         "[B, Sk]")
    for x in (q, k, v, q_positions, k_positions):
        if x.device != q.device:
            raise ValueError("flash_attention: tensors on different devices")
    for x in (q, k, v):
        if x.dtype != q.dtype:
            raise TypeError("flash_attention: q/k/v dtypes differ")
        if x.stride(3) != 1 or any(st % 8 for st in x.stride()[:3]) \
                or x.data_ptr() % 16:
            raise ValueError("flash_attention: head dim must be contiguous, "
                             "strides multiples of 8, data 16-byte aligned")
    out = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=q.device)
    lib = build.load("flash_attention")
    rc = lib.svt_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        q_positions.data_ptr(), k_positions.data_ptr(),
        q.stride(0), q.stride(1), q.stride(2), *kst(k), *kst(v),
        out.stride(0), out.stride(1), out.stride(2),
        B, Sq, Sk, Hq, Hkv, D, float(scale),
        float(logits_soft_cap) if logits_soft_cap is not None else 0.0,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "flash_attention")
    launches += 1
    return out
