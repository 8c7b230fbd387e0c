"""Inference-time projection fusion: qkv and gate/up as single products.

Counterpart of `streamvln_tpu/models/fuse.py::fuse_projections`. Q, K and
V share their input (as do gate and up), so their weights concatenated
along the output dim give the same columns in one product: 7 projections
per layer become 4 (at decode, 4 K6 launches instead of 7 with int4
weights). Every quantization of models/quant.py is per output column, so
the scales (int8 [L, 1, dout], int4 [L, G, dout]) and the biases
concatenate the same way.

A group is left unfused when a member is missing, the members' dtypes or
satellites (`_scale`, `_b`) differ, or any carries a LoRA adapter. The
vision tower stays unfused, as in the JAX package. The fused stacks are
copies: a caller that keeps the unfused tree keeps both in memory.
"""
from __future__ import annotations

from typing import Dict

import torch

_QKV = ("q_w", "k_w", "v_w")
_GU = ("gate_w", "up_w")


def _concat_group(layers: Dict, names, out_name: str) -> bool:
    """Concatenate `names` (and their `_scale` / `_b` satellites) along the
    output dim into `out_name`, in place. Returns False (no change) unless
    every member exists with one dtype and one satellite structure and no
    LoRA adapter."""
    ws = [layers.get(n) for n in names]
    if any(w is None for w in ws) or len({w.dtype for w in ws}) != 1:
        return False
    if any(n + "_lora_a" in layers for n in names):
        return False
    scales = [layers.get(n + "_scale") for n in names]
    if any((s is None) != (scales[0] is None) for s in scales):
        return False
    biases = [layers.get(n[:-2] + "_b") for n in names]
    if any((b is None) != (biases[0] is None) for b in biases):
        return False

    layers[out_name] = torch.cat(ws, dim=-1)
    if scales[0] is not None:
        layers[out_name + "_scale"] = torch.cat(scales, dim=-1)
    if biases[0] is not None:
        layers[out_name[:-2] + "_b"] = torch.cat(biases, dim=-1)
    for n in names:
        del layers[n]
        layers.pop(n + "_scale", None)
        layers.pop(n[:-2] + "_b", None)
    return True


def fuse_projections(params: Dict) -> Dict:
    """params (the full tree, or its "llm" part) with q/k/v fused into
    `qkv_w` (+ `qkv_b`, `qkv_w_scale`) and gate/up into `gu_w` where
    possible. The input tree is not changed; a tree fused already passes
    through."""
    out = dict(params)
    llm = dict(out.get("llm", out))
    layers = dict(llm["layers"])
    _concat_group(layers, _QKV, "qkv_w")
    _concat_group(layers, _GU, "gu_w")
    llm["layers"] = layers
    if "llm" in out:
        out["llm"] = llm
        return out
    return llm
