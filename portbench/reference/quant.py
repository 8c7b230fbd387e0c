"""Symmetric weight quantization, worked out by the reference itself.

`fake_quant(w, bits, group)` returns the f32 matrix that a weight-only
quantizer of that width holds: per output column and per `group` rows of
the contraction dim (the whole column when `group` is None), scale =
absmax / qmax in f32, codes = round-half-to-even(w / scale) clipped to
[-qmax, qmax], value = code * scale. qmax = 2^(bits-1) - 1: 7 at 4 bits,
3 at 3 bits, 127 at 8 bits. A group of zeros takes the scale 1.
"""
from __future__ import annotations

from typing import Optional

import torch

# the decoder's projections that a weight-only LLM quantizer covers; the
# embedding, norms and biases stay as they are
TARGETS = ("q_w", "k_w", "v_w", "o_w", "gate_w", "up_w", "down_w")


def fake_quant(w: torch.Tensor, bits: int,
               group: Optional[int]) -> torch.Tensor:
    """[din, dout] -> f32 [din, dout] after quantization to `bits`."""
    qmax = float(2 ** (bits - 1) - 1)
    din, dout = w.shape
    g = din if group is None or din % group else group
    wf = w.float().reshape(din // g, g, dout)
    amax = wf.abs().amax(dim=1, keepdim=True)
    scale = torch.where(amax > 0, amax / qmax, torch.ones_like(amax))
    q = torch.clamp(torch.round(wf / scale), -qmax, qmax)
    return (q * scale).reshape(din, dout)
