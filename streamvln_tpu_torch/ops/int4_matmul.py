"""Packed-int4 weight products: K6 (fused dequant-matmul, few rows) and K7
(dequant of one layer to the split layout, for prefill rows).

K6 replaces `streamvln_tpu/ops/int4_matmul.py::_kernel` and K7 its
`_dequant_kernel`; both live in `csrc/int4_matmul.cu`
(`svt_int4_matmul`, `svt_int4_dequant_split`), whose notes give the bound
on the H100 and the design: K6 streams the packed weights through a ring
of asynchronous copies, multiplies on the tensor cores (bf16 x; f32 x takes a
CUDA-core kernel) and merges the splits of its contraction inside one
launch, in a fixed order; K7 is a pure stream, one block per SM whose
warps walk runs of 8-row units, each group's scales read once per run.
Both grids come from `csrc/kernel_plan.cuh`.
Layout (models/quant.py): packed uint8 [L, din/2, dout], byte r = w[2r]
(low nibble) | w[2r+1] (high nibble), signed in [-7, 7]; f32 scales
[L, din/64, dout]. A product is taken as `x[:, 0::2] @ lo + x[:, 1::2] @
hi` (the same sum reordered), where each weight is `nibble * scale`
computed in f32 and rounded once to x's dtype, with f32 accumulation and
an f32 [M, dout] result, as the TPU kernel does.

Dispatch, as in the JAX package (`models/qwen2.py::_proj`): at most
KERNEL_MAX_ROWS rows go to K6 (`int4_matmul`); more go to
`int4_prefill_matmul`, i.e. K7 plus one f32-accumulating product against
the column-split x (`_split_cols`). KERNEL_MAX_ROWS is the TPU's value,
kept until it is re-derived on the H100; K6 takes at most that many bf16
rows.

Gradients (QLoRA): both products are `torch.autograd.Function`s whose
backward is the reference's custom VJP (`streamvln_tpu/ops/
int4_matmul.py`): `int4_matmul` dequantizes the layer to f32 and returns
(g @ w.T) in x's dtype; `int4_prefill_matmul` unpacks the layer again
with K7 in x's dtype and returns the column merge of g @ w2.T in that
dtype, so K7 also launches in the backward. The packed weights and their
scales are frozen and get no gradient. Each wrapper runs its plain
PyTorch version on CPU tensors and launches its kernel or raises on CUDA
tensors. Launch counts: `launches` (K6), `dequant_launches` (K7, forward
and backward alike) and `dequant_launches_by_shape` (the same K7 launches
by (din, dout, output dtype)).
"""
from __future__ import annotations

import torch

from streamvln_tpu_torch.kernels import build
from streamvln_tpu_torch.ops.linear import matmul_f32

GROUP = 64            # unpacked rows per scale group (quant.INT4_GROUP)
SUB = 256             # packed rows per TPU sub-chunk: din % 512 == 0
BLOCK_N = 512         # dout multiple (the TPU kernel's column block)
KERNEL_MAX_ROWS = 128

launches = 0
dequant_launches = 0
dequant_launches_by_shape: dict = {}   # (din, dout, dtype) -> K7 launches


def unpack_nibbles(w: torch.Tensor):
    """Sign-extended (low, high) nibbles of packed uint8 as int32."""
    pi = w.to(torch.int32)
    return ((pi & 0xF) ^ 8) - 8, (((pi >> 4) & 0xF) ^ 8) - 8


def int4_kernel_eligible(w_packed, scales) -> bool:
    """Stacked [L, din/2, dout] uint8 with din % 512 == 0, dout % 512 == 0
    and GROUP=64 scales [L, din/64, dout] (the TPU kernel's rule)."""
    if getattr(w_packed, "dtype", None) != torch.uint8 or w_packed.dim() != 3:
        return False
    L, half, dout = w_packed.shape
    din = half * 2
    return (din % (2 * SUB) == 0 and dout % BLOCK_N == 0
            and tuple(scales.shape) == (L, din // GROUP, dout))


def _scaled_halves(w, s, dtype):
    """One layer's (lo, hi) weights [din/2, dout] in `dtype`: nibble times
    its f32 group scale, rounded once."""
    lo, hi = unpack_nibbles(w)
    srep = s.float().repeat_interleave(GROUP // 2, dim=0)
    return (lo.float() * srep).to(dtype), (hi.float() * srep).to(dtype)


def int4_matmul_plain(x, w_packed, scales, layer: int) -> torch.Tensor:
    """Plain version of K6: f32 [M, dout]."""
    lo, hi = _scaled_halves(w_packed[layer], scales[layer], x.dtype)
    return x[:, 0::2].float() @ lo.float() + x[:, 1::2].float() @ hi.float()


def int4_dequant_split_plain(w_packed, scales, layer: int,
                             dtype=torch.bfloat16) -> torch.Tensor:
    """Plain version of K7: [2, din/2, dout] in `dtype`, low-nibble rows
    (the even rows of the weight) then high-nibble rows (the odd ones)."""
    return torch.stack(_scaled_halves(w_packed[layer], scales[layer], dtype))


def _split_cols(x):
    """[M, din] -> even columns first, odd after (pairs with K7's
    [lo rows; hi rows])."""
    return torch.cat([x[:, 0::2], x[:, 1::2]], dim=1)


def _merge_cols(x):
    """Inverse of _split_cols."""
    M, din = x.shape
    return torch.stack([x[:, :din // 2], x[:, din // 2:]], dim=-1) \
        .reshape(M, din)


def _check(what, w_packed, scales, layer, x=None, dtype=None):
    """Checks of the kernel wrappers on CUDA tensors."""
    if w_packed.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {w_packed.device}")
    if not int4_kernel_eligible(w_packed, scales):
        raise ValueError(f"{what}: packed weight {tuple(w_packed.shape)} / "
                         f"scales {tuple(scales.shape)} are not kernel-"
                         f"eligible (din, dout multiples of 512, group 64)")
    if scales.dtype != torch.float32:
        raise TypeError(f"{what}: scales must be f32, got {scales.dtype}")
    if not (w_packed.is_contiguous() and scales.is_contiguous()):
        raise ValueError(f"{what}: weight and scales must be contiguous")
    if not 0 <= layer < w_packed.shape[0]:
        raise IndexError(f"{what}: layer {layer} of {w_packed.shape[0]}")
    dtype = x.dtype if x is not None else dtype
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{what} kernel takes bf16 or f32, got {dtype}")
    for t in (scales,) + ((x,) if x is not None else ()):
        if t.device != w_packed.device:
            raise ValueError(f"{what}: tensors on different devices")


def _int4_matmul(x, w_packed, scales, layer: int) -> torch.Tensor:
    """K6's launch (its plain version on CPU tensors)."""
    global launches
    if x.device.type == "cpu":
        return int4_matmul_plain(x, w_packed, scales, layer)
    _check("int4_matmul", w_packed, scales, layer, x=x)
    M, din = x.shape
    _, half, dout = w_packed.shape
    if din != 2 * half:
        raise ValueError(f"int4_matmul: x {tuple(x.shape)} does not match "
                         f"weight {tuple(w_packed.shape)}")
    if x.dtype == torch.bfloat16 and M > KERNEL_MAX_ROWS:
        raise ValueError(f"int4_matmul kernel takes at most "
                         f"{KERNEL_MAX_ROWS} bf16 rows, got {M} (more go "
                         f"to int4_prefill_matmul)")
    x = x.contiguous()
    w, s = w_packed[layer], scales[layer]
    if any(t.data_ptr() % 16 for t in (x, w, s)):
        raise ValueError("int4_matmul: x, weight and scales must be 16-byte "
                         "aligned (the kernel copies 16-byte chunks)")
    out = torch.empty((M, dout), dtype=torch.float32, device=x.device)
    rc = build.load("int4_matmul").svt_int4_matmul(
        x.data_ptr(), w.data_ptr(), s.data_ptr(), out.data_ptr(), M, din,
        dout, int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(rc, "int4_matmul")
    launches += 1
    return out


def int4_dequant_split(w_packed, scales, layer: int,
                       dtype=torch.bfloat16) -> torch.Tensor:
    """K7: [2, din/2, dout] in `dtype` (low-nibble rows, then high)."""
    global dequant_launches
    if w_packed.device.type == "cpu":
        return int4_dequant_split_plain(w_packed, scales, layer, dtype)
    _check("int4_dequant_split", w_packed, scales, layer, dtype=dtype)
    _, half, dout = w_packed.shape
    out = torch.empty((2, half, dout), dtype=dtype, device=w_packed.device)
    rc = build.load("int4_matmul").svt_int4_dequant_split(
        w_packed[layer].data_ptr(), scales[layer].data_ptr(), out.data_ptr(),
        half, dout, int(dtype == torch.bfloat16),
        torch.cuda.current_stream(w_packed.device).cuda_stream)
    build.check(rc, "int4_dequant_split")
    dequant_launches += 1
    key = (2 * half, dout, str(dtype).removeprefix("torch."))
    dequant_launches_by_shape[key] = dequant_launches_by_shape.get(key, 0) + 1
    return out


class _Int4Matmul(torch.autograd.Function):
    """K6 forward; the reference's `_bwd`: dx = (g @ w_f32.T) in x's
    dtype, no gradient for the packed weight or its scales."""

    @staticmethod
    def forward(ctx, x, w_packed, scales, layer):
        ctx.save_for_backward(w_packed, scales)
        ctx.layer, ctx.dtype = layer, x.dtype
        return _int4_matmul(x, w_packed, scales, layer)

    @staticmethod
    def backward(ctx, g):
        # models.quant imports this module, hence the import here
        from streamvln_tpu_torch.models.quant import dequant_int4
        w_packed, scales = ctx.saved_tensors
        w = dequant_int4(w_packed[ctx.layer], scales[ctx.layer],
                         torch.float32)
        return (g @ w.t()).to(ctx.dtype), None, None, None


class _Int4PrefillMatmul(torch.autograd.Function):
    """K7 + one f32-accumulating product; the reference's `_pf_bwd`: K7
    again in x's dtype, dxs = g.to(dtype) @ w2.T in that dtype, merged
    back to the interleaved columns; no gradient for the packed weight or
    its scales."""

    @staticmethod
    def forward(ctx, x, w_packed, scales, layer):
        ctx.save_for_backward(w_packed, scales)
        ctx.layer, ctx.dtype = layer, x.dtype
        _, half, dout = w_packed.shape
        w2 = int4_dequant_split(w_packed, scales, layer, x.dtype)
        return matmul_f32(_split_cols(x), w2.reshape(2 * half, dout))

    @staticmethod
    def backward(ctx, g):
        w_packed, scales = ctx.saved_tensors
        _, half, dout = w_packed.shape
        w2 = int4_dequant_split(w_packed, scales, ctx.layer, ctx.dtype)
        dxs = g.to(ctx.dtype) @ w2.reshape(2 * half, dout).t()
        return _merge_cols(dxs).to(ctx.dtype), None, None, None


def int4_matmul(x, w_packed, scales, layer: int) -> torch.Tensor:
    """K6: x [M, din] @ dequant(w_packed[layer]) -> f32 [M, dout];
    differentiable in x."""
    return _Int4Matmul.apply(x, w_packed, scales, layer)


def int4_prefill_matmul(x, w_packed, scales, layer: int) -> torch.Tensor:
    """x [M, din] @ dequant(w_packed[layer]) -> f32 [M, dout] for many
    rows: K7 into the split layout, then one f32-accumulating product with
    the column-split x (the TPU path leaves that product to XLA);
    differentiable in x."""
    return _Int4PrefillMatmul.apply(x, w_packed, scales, layer)
