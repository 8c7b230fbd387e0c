"""Matrix products whose f32 accumulation is kept: the port's counterpart
of `jnp.dot(x, w, preferred_element_type=jnp.float32)`.

A bf16 x bf16 product returned in bf16 is rounded to 8 bits of mantissa
before any bias add or cast; the JAX package keeps the f32 sum and rounds
once, after the f32 bias add (or never, for the lm_head's f32 logits).
`matmul_f32` returns that f32 sum:
- on CUDA, one cuBLAS call (`torch.mm(..., out_dtype=torch.float32)`,
  the op `aten::mm.dtype`) inside `_MmF32`, whose backward is the two
  plain products in the operands' dtype (the gradient rounded to that
  dtype first, as the bf16 product's backward did);
- on the CPU, the product of the operands upcast to f32.
"""
from __future__ import annotations

import torch


class _MmF32(torch.autograd.Function):
    """a [M, K] @ b [K, N] (same 16-bit dtype, CUDA) -> f32 [M, N]."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.mm(g.to(a.dtype), b.t())
        if ctx.needs_input_grad[1]:
            gb = torch.mm(a.t(), g.to(b.dtype))
        return ga, gb


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ w [K, N] -> f32 [..., N], accumulated in f32 and not
    rounded to x's dtype. Operands of one dtype; f32 operands give the
    plain f32 product."""
    if x.dtype != w.dtype:
        raise TypeError(f"matmul_f32: operand dtypes differ ({x.dtype}, "
                        f"{w.dtype})")
    if x.dtype == torch.float32:
        return torch.matmul(x, w)
    if x.device.type == "cuda":
        lead = x.shape[:-1]
        out = _MmF32.apply(x.reshape(-1, x.shape[-1]), w)
        return out.reshape(*lead, w.shape[-1])
    return torch.matmul(x.float(), w.float())
