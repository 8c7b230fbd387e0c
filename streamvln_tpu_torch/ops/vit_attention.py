"""K1: whole-sequence bidirectional attention for the vision tower.

Replaces `streamvln_tpu/ops/vit_attention.py::_kernel`. The CUDA kernel
(`csrc/vit_attention.cu` over `csrc/attention_fwd.cuh`) streams key
tiles through shared memory with an online softmax: the TPU kernel's
trick of holding a (batch, head)'s whole 729 x 729 score matrix on chip
does not fit a Hopper block's 227 KB. At SigLIP shapes the work is
~360 FLOP per byte of q/k/v/o, so the tensor cores bound it; the kernel
feeds them with wgmma (bf16 operands, f32 accumulation) from tiles that
a producer warp loads with TMA behind an mbarrier pipeline.

`vit_attention` is the wrapper: on CPU tensors it runs `vit_attention_plain`;
on CUDA tensors it launches the kernel or raises. `launches` counts kernel
launches, `launches_by_batch` the same launches by batch size. It is differentiable (`_VitAttentionFn`): the backward is the
dense torch-math recompute of the JAX package's custom VJP
(`streamvln_tpu/ops/vit_attention.py:95-103`), which has no Pallas
backward either, so there is no backward kernel to port.
"""
from __future__ import annotations

from typing import Optional

import torch

from streamvln_tpu_torch.kernels import build

launches = 0
launches_by_batch: dict = {}       # batch size -> kernel launches
KERNEL_HEAD_DIMS = (64, 72)        # CLIP, SigLIP


def vit_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel's function, [B, S, H, D] in and
    out: f32 scores of the (exact) bf16 products, softmax over the whole
    row, P rounded to bf16 before PV for bf16 inputs, deferred 1/rowsum."""
    D = q.shape[3]
    if scale is None:
        scale = D ** -0.5
    qf, kf, vf = (x.float().transpose(1, 2) for x in (q, k, v))
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale      # [B, H, S, S]
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    r = 1.0 / p.sum(dim=-1, keepdim=True)
    if q.dtype == torch.bfloat16:
        p = p.to(torch.bfloat16).float()
    o = torch.matmul(p, vf) * r
    return o.transpose(1, 2).to(q.dtype)


def vit_attention_reference(q, k, v, scale: float) -> torch.Tensor:
    """The JAX package's `_reference`: f32 softmax over the whole score
    matrix, output in q's dtype. The backward differentiates this."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def vit_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Full (bidirectional) MHA for encoder shapes; q/k/v [B, S, H, D]."""
    if q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"vit_attention: shapes differ {q.shape} "
                         f"{k.shape} {v.shape}")
    if scale is None:
        scale = q.shape[3] ** -0.5
    return _VitAttentionFn.apply(q, k, v, float(scale))


def _forward(q, k, v, scale: float) -> torch.Tensor:
    global launches
    if q.device.type == "cpu":
        return vit_attention_plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"vit_attention: unsupported device {q.device}")
    B, S, H, D = q.shape
    if q.dtype != torch.bfloat16 or D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"vit_attention kernel takes bf16 with head dim "
                         f"in {KERNEL_HEAD_DIMS}, got {q.dtype} and {D}; "
                         f"use impl='dense' for other CUDA inputs")
    for x in (q, k, v):
        if x.dtype != q.dtype:
            raise TypeError("vit_attention: q/k/v dtypes differ")
        if x.device != q.device:
            raise ValueError("vit_attention: tensors on different devices")
        if x.stride() != q.stride() or x.stride(3) != 1:
            raise ValueError("vit_attention: q/k/v need one layout with a "
                             "contiguous head dim")
        if any(st % 8 for st in x.stride()[:3]) or x.data_ptr() % 16:
            raise ValueError("vit_attention: strides must be multiples of "
                             "8 elements and data 16-byte aligned")
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lib = build.load("vit_attention")
    sb, ss, sh, _ = q.stride()
    osb, oss, osh, _ = out.stride()
    rc = lib.svt_vit_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        sb, ss, sh, osb, oss, osh, B, S, H, D, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "vit_attention")
    launches += 1
    launches_by_batch[B] = launches_by_batch.get(B, 0) + 1
    return out


class _VitAttentionFn(torch.autograd.Function):
    """K1 forward (the plain version on CPU tensors); backward by autograd
    of `vit_attention_reference` on the saved inputs."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return _forward(q, k, v, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            xs = [x.detach().requires_grad_() for x in (q, k, v)]
            out = vit_attention_reference(*xs, ctx.scale)
            grads = torch.autograd.grad(out, xs, g)
        return (*grads, None)
