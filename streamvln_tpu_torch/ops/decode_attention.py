"""Single-token GQA decode attention over the KV-head-major cache: K8.

Replaces `streamvln_tpu/ops/decode_attention.py::_decode_kernel` with
`csrc/decode_attention.cu::svt_decode_attention` (its notes give the
bound on the H100 and the design: a cluster of blocks per (row, KV head)
splits the live prefix, read on the device, streams K and V through a
ring of asynchronous copies, computes on the tensor cores for bf16 and merges its
splits in a fixed order inside the one launch; `csrc/kernel_plan.cuh`
sizes the grid and the shares). q [B, 1, Hq, D] attends over keys
0..length[b]-1 of k/v [B, Hkv, Smax, D], GQA kv head = q head // G, f32
math, output in q's dtype; a row of length 0 gives zeros. Keys are
masked by index (< length), not by position: the two agree because the
cache keeps slot == position.

Opt-in, as in the JAX package: `models/qwen2.py::_attend` takes it for
S == 1 on the cache under attn_impl="decode_kernel". The wrapper runs the
plain PyTorch version on CPU tensors and launches the kernel or raises on
CUDA tensors; `launches` counts the launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from streamvln_tpu_torch.kernels import build

NEG_INF = -1e30
HEAD_DIM = 128        # the kernel's head dim
MAX_GROUP = 16        # query heads per KV head the kernel takes

launches = 0


def decode_attention_plain(q, k, v, lengths,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Plain version: dense f32 attention under the mask index < length."""
    B, _, Hq, D = q.shape
    _, Hkv, Smax, _ = k.shape
    G = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    qf = q[:, 0].float().reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bhkd->bhgk", qf, k.float()) * scale
    live = torch.arange(Smax, device=q.device)[None] \
        < lengths.to(q.device)[:, None]                       # [B, Smax]
    s = torch.where(live[:, None, None], s,
                    torch.tensor(NEG_INF, device=q.device))
    out = torch.einsum("bhgk,bhkd->bhgd", torch.softmax(s, dim=-1),
                       v.float())
    out = torch.where(live.any(dim=-1)[:, None, None, None], out,
                      torch.zeros((), device=q.device))
    return out.reshape(B, 1, Hq, D).to(q.dtype)


def _check(q, k, v, lengths):
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    B, S1, Hq, D = q.shape
    if k.dim() != 4 or v.shape != k.shape or S1 != 1 or k.shape[0] != B \
            or k.shape[3] != D or Hq % k.shape[1]:
        raise ValueError(f"decode_attention: bad shapes q={tuple(q.shape)} "
                         f"k={tuple(k.shape)} v={tuple(v.shape)}")
    if D != HEAD_DIM or Hq // k.shape[1] > MAX_GROUP:
        raise ValueError(f"decode_attention kernel takes head dim "
                         f"{HEAD_DIM} and at most {MAX_GROUP} query heads "
                         f"per KV head, got {D} and {Hq // k.shape[1]}")
    if q.dtype not in (torch.bfloat16, torch.float32) or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"decode_attention kernel takes bf16 or f32 q/k/v "
                        f"of one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    epc = 16 // q.element_size()
    for x in (k, v):
        if x.stride(3) != 1 or any(st % epc for st in x.stride()[:3]) \
                or x.data_ptr() % 16:
            raise ValueError("decode_attention: k/v head dim must be "
                             "contiguous, rows 16-byte aligned")
    if q.stride(3) != 1:
        raise ValueError("decode_attention: q's head dim must be contiguous")
    if lengths.shape != (B,):
        raise ValueError(f"decode_attention: lengths must be [B], got "
                         f"{tuple(lengths.shape)}")
    for x in (k, v, lengths):
        if x.device != q.device:
            raise ValueError("decode_attention: tensors on different devices")


def decode_attention(q, k, v, lengths,
                     scale: Optional[float] = None) -> torch.Tensor:
    """K8: q [B, 1, Hq, D], k/v [B, Hkv, Smax, D], lengths [B] (keys
    0..length-1 visible) -> [B, 1, Hq, D] in q's dtype."""
    global launches
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, lengths, scale)
    _check(q, k, v, lengths)
    B, _, Hq, D = q.shape
    _, Hkv, Smax, _ = k.shape
    if scale is None:
        scale = D ** -0.5
    lengths = lengths.to(torch.int32).contiguous()
    dev = q.device
    out = torch.empty((B, 1, Hq, D), dtype=q.dtype, device=dev)
    strides = (ctypes.c_longlong * 8)(
        q.stride(0), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2))
    rc = build.load("decode_attention").svt_decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), strides, B, Hq, Hkv, Smax, D, float(scale),
        int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "decode_attention")
    launches += 1
    return out
