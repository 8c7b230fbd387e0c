"""Position-masked GQA flash attention: K2 (decoder prefill) and the
training path's K3 (forward with logsumexp), K4 (dQ) and K5 (dK/dV).

K2 replaces `streamvln_tpu/ops/flash_attention.py::_flash_kernel`. The
CUDA kernel (`csrc/flash_attention.cu` over `csrc/attention_fwd.cuh`)
runs one block per (batch, q head, 128-row q tile), reads the
KV-head-major cache in place (`kv_major=True`) or the [B, Sk, Hkv, D]
layout, and skips key tiles whose smallest position exceeds the block's
largest query position, so a prefill over a 4096-slot cache costs only
the live prefix. At prefill shapes the tensor cores bound it; the
kernel feeds them bf16 operands through wgmma from TMA-loaded tiles,
with f32 accumulation (the TPU kernel upcasts to f32), which puts its
error at bf16 rounding of P.

K3, K4 and K5 replace `_flash_kernel_lse`, `_flash_bwd_dq_kernel` and
`_flash_bwd_dkv_kernel` (with the TPU wrapper's sum of the G query heads
into each KV head): `csrc/flash_attention.cu::svt_flash_attention_lse`
and `csrc/flash_attention_bwd.cu`. They run whenever `flash_attention`
is called with grad enabled on a q/k/v that requires grad, through
`_FlashAttentionFn`; without grad the wrapper launches K2 as before.

Each kernel wrapper runs its plain PyTorch version on CPU tensors and
launches its kernel or raises on CUDA tensors. Launch counts: `launches`
(K2), `lse_launches` (K3), `dq_launches` (K4), `dkv_launches` (K5).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from streamvln_tpu_torch.kernels import build

NEG_INF = -1e30
INVALID_POS = 1 << 30
KERNEL_HEAD_DIMS = (64, 128)

launches = 0
lse_launches = 0
dq_launches = 0
dkv_launches = 0


def _default_positions(B, S, device):
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(
        B, S)


def _kv_heads_major(k, v, kv_major):
    """k/v as [B, Hkv, Sk, D] views."""
    return (k, v) if kv_major else (k.transpose(1, 2), v.transpose(1, 2))


def flash_attention_plain(q, k, v, q_positions=None, k_positions=None,
                          scale: Optional[float] = None,
                          logits_soft_cap: Optional[float] = None,
                          kv_major: bool = False) -> torch.Tensor:
    """Plain PyTorch version: f32 dense attention under the visibility
    rule k_pos <= q_pos, GQA kv head = q head // G, rows with no visible
    key give exact zeros, output in q's dtype."""
    B, Sq, Hq, D = q.shape
    k, v = _kv_heads_major(k, v, kv_major)               # [B, Hkv, Sk, D]
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


def flash_attention_lse_plain(q, k, v, q_positions=None, k_positions=None,
                              scale: Optional[float] = None,
                              kv_major: bool = False):
    """Plain version of K3: (`flash_attention_plain`'s output, the f32
    logsumexp [B, Hq, Sq] of each row's scaled visible scores, -1e30 for a
    row that sees no key)."""
    B, Sq, Hq, D = q.shape
    kh, _ = _kv_heads_major(k, v, kv_major)
    Hkv, Sk = kh.shape[1], kh.shape[2]
    if scale is None:
        scale = D ** -0.5
    if q_positions is None:
        q_positions = _default_positions(B, Sq, q.device)
    if k_positions is None:
        k_positions = _default_positions(B, Sk, q.device)
    qf = q.float().reshape(B, Sq, Hkv, Hq // Hkv, D)
    logits = torch.einsum("bqhgd,bhkd->bhgqk", qf, kh.float()) * scale
    mask = (k_positions[:, None, :] <= q_positions[:, :, None])[:, None, None]
    lse = torch.logsumexp(torch.where(mask, logits, float("-inf")), dim=-1)
    lse = torch.where(mask.any(dim=-1), lse, NEG_INF).reshape(B, Hq, Sq)
    out = flash_attention_plain(q, k, v, q_positions, k_positions, scale,
                                kv_major=kv_major)
    return out, lse


def _dsum(dout, out):
    """Dsum = rowsum(dO * O), [B, Hq, Sq] f32 (the TPU wrapper's :408-411)."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def _bwd_core(q, k, v, dout, lse, dsum, q_positions, k_positions, scale,
              kv_major):
    """The kernels' formulas densely: P = exp(S - LSE) under the mask only,
    dS = P (dO V^T - Dsum), both [B, Hkv, G, Sq, Sk] f32; for bf16 inputs
    P and dS are rounded to bf16 as the kernels round them before their
    products. Also returns the f32 operands in that grouping."""
    B, Sq, Hq, D = q.shape
    kh, vh = _kv_heads_major(k, v, kv_major)
    Hkv = kh.shape[1]
    G = Hq // Hkv
    qf = q.float().reshape(B, Sq, Hkv, G, D)
    dof = dout.float().reshape(B, Sq, Hkv, G, D)
    kf = kh.float()
    s = torch.einsum("bqhgd,bhkd->bhgqk", qf, kf) * scale
    mask = (k_positions[:, None, :] <= q_positions[:, :, None])[:, None, None]
    p = torch.where(mask, s - lse.reshape(B, Hkv, G, Sq, 1), NEG_INF).exp()
    del s
    dp = torch.einsum("bqhgd,bhkd->bhgqk", dof, vh.float())
    ds = p * (dp - dsum.reshape(B, Hkv, G, Sq, 1))
    del dp
    if q.dtype == torch.bfloat16:
        p = p.to(torch.bfloat16).float()
        ds = ds.to(torch.bfloat16).float()
    return p, ds, qf, kf, dof


def flash_bwd_dq_plain(q, k, v, dout, lse, dsum, q_positions, k_positions,
                       scale: Optional[float] = None,
                       kv_major: bool = False) -> torch.Tensor:
    """Plain version of K4: dQ = dS K * scale, in q's dtype."""
    B, Sq, Hq, D = q.shape
    scale = D ** -0.5 if scale is None else scale
    _, ds, _, kf, _ = _bwd_core(q, k, v, dout, lse, dsum, q_positions,
                                k_positions, scale, kv_major)
    dq = torch.einsum("bhgqk,bhkd->bqhgd", ds, kf) * scale
    return dq.reshape(B, Sq, Hq, D).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, dout, lse, dsum, q_positions, k_positions,
                        scale: Optional[float] = None,
                        kv_major: bool = False):
    """Plain version of K5: dK = dS^T Q * scale and dV = P^T dO, the G
    query heads of a KV head summed, in k's layout and dtype."""
    D = q.shape[3]
    scale = D ** -0.5 if scale is None else scale
    p, ds, qf, _, dof = _bwd_core(q, k, v, dout, lse, dsum, q_positions,
                                  k_positions, scale, kv_major)
    dk = torch.einsum("bhgqk,bqhgd->bhkd", ds, qf) * scale
    dv = torch.einsum("bhgqk,bqhgd->bhkd", p, dof)
    if not kv_major:
        dk, dv = dk.transpose(1, 2), dv.transpose(1, 2)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_plain(q, k, v, out, lse, dout, q_positions=None,
                              k_positions=None,
                              scale: Optional[float] = None,
                              kv_major: bool = False):
    """dQ, dK, dV from (q, k, v, out, lse, dO) by the kernels' formulas
    (not by autograd of the dense version)."""
    q_positions, k_positions = _positions(q, k, q_positions, k_positions,
                                          kv_major)
    dsum = _dsum(dout, out)
    args = (q, k, v, dout, lse, dsum, q_positions, k_positions, scale,
            kv_major)
    return (flash_bwd_dq_plain(*args), *flash_bwd_dkv_plain(*args))


def _positions(q, k, q_positions, k_positions, kv_major):
    B, Sq = q.shape[:2]
    Sk = k.shape[2] if kv_major else k.shape[1]
    if q_positions is None:
        q_positions = _default_positions(B, Sq, q.device)
    if k_positions is None:
        k_positions = _default_positions(B, Sk, q.device)
    return q_positions, k_positions


def _prepare(what, q, k, v, q_positions, k_positions, kv_major):
    """Checks shared by the kernel wrappers on CUDA tensors. Returns
    (B, Sq, Sk, Hq, Hkv, D, int32 positions)."""
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    B, Sq, Hq, D = q.shape
    if kv_major:
        _, Hkv, Sk, Dk = k.shape
    else:
        _, Sk, Hkv, Dk = k.shape
    if v.shape != k.shape or Dk != D or Hq % Hkv:
        raise ValueError(f"{what}: bad shapes q={tuple(q.shape)} "
                         f"k={tuple(k.shape)} v={tuple(v.shape)}")
    if q.dtype != torch.bfloat16 or D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{what} kernel takes bf16 with head dim 64 or "
                         f"128, got {q.dtype} and {D}; use "
                         f"attn_impl='dense' for other CUDA inputs")
    q_positions, k_positions = _positions(q, k, q_positions, k_positions,
                                          kv_major)
    q_positions = q_positions.to(torch.int32).contiguous()
    k_positions = k_positions.to(torch.int32).contiguous()
    if q_positions.shape != (B, Sq) or k_positions.shape != (B, Sk):
        raise ValueError(f"{what}: positions must be [B, Sq] and [B, Sk]")
    for x in (k, v, q_positions, k_positions):
        if x.device != q.device:
            raise ValueError(f"{what}: tensors on different devices")
    for x in (k, v):
        if x.dtype != q.dtype:
            raise TypeError(f"{what}: q/k/v dtypes differ")
    _check_layout(what, q, k, v)
    return B, Sq, Sk, Hq, Hkv, D, q_positions, k_positions


def _readable(x) -> bool:
    """The kernels read x by strides: contiguous head dim, strides that
    are multiples of 8 elements, data 16-byte aligned."""
    return x.stride(3) == 1 and not any(st % 8 for st in x.stride()[:3]) \
        and x.data_ptr() % 16 == 0


def _check_layout(what, *xs):
    for x in xs:
        if not _readable(x):
            raise ValueError(f"{what}: head dim must be contiguous, strides "
                             f"multiples of 8, data 16-byte aligned")


def _qst(x):
    """(batch, seq, head) strides of a [B, S, H, D] tensor."""
    return x.stride(0), x.stride(1), x.stride(2)


def _kvst(x, kv_major):
    """(batch, seq, head) strides of k/v-shaped tensors in either layout."""
    return (x.stride(0), x.stride(2), x.stride(1)) if kv_major else _qst(x)


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def flash_attention(q, k, v, q_positions=None, k_positions=None,
                    scale: Optional[float] = None,
                    logits_soft_cap: Optional[float] = None,
                    kv_major: bool = False) -> torch.Tensor:
    """q [B, Sq, Hq, D]; k/v [B, Hkv, Sk, D] when kv_major (cache layout)
    else [B, Sk, Hkv, D]; positions [B, S] int32 (default arange).

    With grad enabled and any of q/k/v requiring grad this is the training
    path (`_FlashAttentionFn`: K3 forward, K4/K5 backward); the soft cap
    has no backward there and raises, as in the JAX package. Otherwise it
    is K2 (no residuals kept)."""
    global launches
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        if logits_soft_cap is not None:
            raise NotImplementedError(
                "flash backward does not support logits_soft_cap")
        q_positions, k_positions = _positions(q, k, q_positions,
                                              k_positions, kv_major)
        return _FlashAttentionFn.apply(q, k, v, q_positions, k_positions,
                                       scale, kv_major)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, q_positions, k_positions,
                                     scale, logits_soft_cap, kv_major)
    B, Sq, Sk, Hq, Hkv, D, q_positions, k_positions = _prepare(
        "flash_attention", q, k, v, q_positions, k_positions, kv_major)
    if scale is None:
        scale = D ** -0.5
    out = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=q.device)
    lib = build.load("flash_attention")
    rc = lib.svt_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        q_positions.data_ptr(), k_positions.data_ptr(),
        *_qst(q), *_kvst(k, kv_major), *_kvst(v, kv_major), *_qst(out),
        B, Sq, Sk, Hq, Hkv, D, float(scale),
        float(logits_soft_cap) if logits_soft_cap is not None else 0.0,
        _stream(q))
    build.check(rc, "flash_attention")
    launches += 1
    return out


def flash_attention_lse(q, k, v, q_positions=None, k_positions=None,
                        scale: Optional[float] = None,
                        kv_major: bool = False):
    """K3 wrapper: (out [B, Sq, Hq, D], lse [B, Hq, Sq] f32)."""
    global lse_launches
    if q.device.type == "cpu":
        return flash_attention_lse_plain(q, k, v, q_positions, k_positions,
                                         scale, kv_major)
    B, Sq, Sk, Hq, Hkv, D, q_positions, k_positions = _prepare(
        "flash_attention_lse", q, k, v, q_positions, k_positions, kv_major)
    if scale is None:
        scale = D ** -0.5
    out = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    lib = build.load("flash_attention")
    rc = lib.svt_flash_attention_lse(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), q_positions.data_ptr(), k_positions.data_ptr(),
        *_qst(q), *_kvst(k, kv_major), *_kvst(v, kv_major), *_qst(out),
        B, Sq, Sk, Hq, Hkv, D, float(scale), _stream(q))
    build.check(rc, "flash_attention_lse")
    lse_launches += 1
    return out, lse


def _bwd_launch(what, q, k, v, dout, lse, dsum, q_positions, k_positions,
                scale, kv_major, dq=None, dk=None, dv=None):
    B, Sq, Sk, Hq, Hkv, D, q_positions, k_positions = _prepare(
        what, q, k, v, q_positions, k_positions, kv_major)
    if dout.shape != q.shape or dout.dtype != q.dtype \
            or dout.device != q.device:
        raise ValueError(f"{what}: dO must match q in shape, dtype, device")
    for x in (lse, dsum):
        if x.shape != (B, Hq, Sq) or x.dtype != torch.float32 \
                or not x.is_contiguous() or x.device != q.device:
            raise ValueError(f"{what}: lse/dsum must be contiguous f32 "
                             f"[B, Hq, Sq] on q's device")
    _check_layout(what, dout)
    zero = (0, 0, 0)
    strides = (ctypes.c_longlong * 21)(
        *_qst(q), *_kvst(k, kv_major), *_kvst(v, kv_major), *_qst(dout),
        *(_qst(dq) if dq is not None else zero),
        *(_kvst(dk, kv_major) if dk is not None else zero),
        *(_kvst(dv, kv_major) if dv is not None else zero))
    lib = build.load("flash_attention_bwd")
    ptrs = [x.data_ptr() for x in (q, k, v, dout, lse, dsum)]
    outs = [dq.data_ptr()] if dq is not None else \
        [dk.data_ptr(), dv.data_ptr()]
    fn = lib.svt_flash_bwd_dq if dq is not None else lib.svt_flash_bwd_dkv
    rc = fn(*ptrs, *outs, q_positions.data_ptr(), k_positions.data_ptr(),
            strides, B, Sq, Sk, Hq, Hkv, D,
            float(D ** -0.5 if scale is None else scale), _stream(q))
    build.check(rc, what)


def flash_bwd_dq(q, k, v, dout, lse, dsum, q_positions=None,
                 k_positions=None, scale: Optional[float] = None,
                 kv_major: bool = False) -> torch.Tensor:
    """K4 wrapper: dQ [B, Sq, Hq, D] in q's dtype."""
    global dq_launches
    if q.device.type == "cpu":
        q_positions, k_positions = _positions(q, k, q_positions,
                                              k_positions, kv_major)
        return flash_bwd_dq_plain(q, k, v, dout, lse, dsum, q_positions,
                                  k_positions, scale, kv_major)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _bwd_launch("flash_bwd_dq", q, k, v, dout, lse, dsum, q_positions,
                k_positions, scale, kv_major, dq=dq)
    dq_launches += 1
    return dq


def flash_bwd_dkv(q, k, v, dout, lse, dsum, q_positions=None,
                  k_positions=None, scale: Optional[float] = None,
                  kv_major: bool = False):
    """K5 wrapper: (dK, dV) in k's layout and dtype."""
    global dkv_launches
    if q.device.type == "cpu":
        q_positions, k_positions = _positions(q, k, q_positions,
                                              k_positions, kv_major)
        return flash_bwd_dkv_plain(q, k, v, dout, lse, dsum, q_positions,
                                   k_positions, scale, kv_major)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _bwd_launch("flash_bwd_dkv", q, k, v, dout, lse, dsum, q_positions,
                k_positions, scale, kv_major, dk=dk, dv=dv)
    dkv_launches += 1
    return dk, dv


def flash_attention_bwd(q, k, v, out, lse, dout, q_positions=None,
                        k_positions=None, scale: Optional[float] = None,
                        kv_major: bool = False):
    """dQ, dK, dV through the K4 and K5 wrappers; Dsum is one torch
    reduction here, as the JAX package computes it outside its kernels.
    A dO that the kernels cannot read by stride is made contiguous."""
    if dout.device.type == "cuda" and not _readable(dout):
        dout = dout.contiguous()
    dsum = _dsum(dout, out)
    args = (q, k, v, dout, lse, dsum, q_positions, k_positions, scale,
            kv_major)
    return (flash_bwd_dq(*args), *flash_bwd_dkv(*args))


class _FlashAttentionFn(torch.autograd.Function):
    """Differentiable flash attention: K3 forward (output + LSE residual),
    K4/K5 backward; the plain versions on CPU tensors. Deterministic, so
    it can run under non-reentrant `torch.utils.checkpoint` (the recompute
    launches K3 again and is counted)."""

    @staticmethod
    def forward(ctx, q, k, v, q_positions, k_positions, scale, kv_major):
        out, lse = flash_attention_lse(q, k, v, q_positions, k_positions,
                                       scale, kv_major)
        ctx.save_for_backward(q, k, v, out, lse, q_positions, k_positions)
        ctx.scale, ctx.kv_major = scale, kv_major
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, q_positions, k_positions = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout,
                                         q_positions, k_positions,
                                         ctx.scale, ctx.kv_major)
        return dq, dk, dv, None, None, None, None
