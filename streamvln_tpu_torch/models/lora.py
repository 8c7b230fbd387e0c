"""LoRA adapters for the Qwen2 stack, PyTorch.

Counterpart of `streamvln_tpu/models/lora.py` (reference capability: PEFT
LoRA fine-tuning with adapter-only checkpoints, streamvln_train.py:
1613-1632). Adapters live inside the layer stacks as
`params["llm"]["layers"]["<w>_lora_a" / "_lora_b"]`, stacked on the [L]
axis, with `params["llm"]["lora_scale"] = alpha / rank`; `qwen2._proj` adds
`x @ A @ B * lora_scale` in f32 wherever the keys are present. Training
only the adapters is the optimizer's concern (`parallel.train.TrainConfig.
lora_only`). As in the JAX package, `lora_scale` is a leaf like the
adapters, so `lora_only` trains it too.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from streamvln_tpu_torch.models import quant

DEFAULT_TARGETS = ("q_w", "k_w", "v_w", "o_w", "gate_w", "up_w", "down_w")


def add_lora(params: dict, generator: torch.Generator, rank: int = 16,
             alpha: float = 32.0, targets: Sequence[str] = DEFAULT_TARGETS,
             dtype=torch.float32) -> dict:
    """Insert adapters that leave the model unchanged: A ~ N(0, 1/din),
    B = 0, on the base weights' device. Returns a new tree that shares
    every base tensor with `params` (no copy). Targets a family lacks are
    skipped, as in the reference: an ungated MLP has no gate_w, and MoE
    layers (expert stacks, no gate/up/down) take adapters on attention
    only. A packed-int4 base [L, din/2, dout] gets adapters of its
    unpacked width din (the reference reads din off the packed shape,
    ROADMAP §3.5)."""
    layers = dict(params["llm"]["layers"])
    for name in targets:
        if name not in layers:
            continue
        w = layers[name]                          # [L, din, dout]
        L, din, dout = w.shape
        if quant.is_packed_int4(w):
            din *= 2
        a = torch.randn((L, din, rank), generator=generator,
                        device=w.device, dtype=torch.float32)
        layers[f"{name}_lora_a"] = (a * din ** -0.5).to(dtype)
        layers[f"{name}_lora_b"] = torch.zeros((L, rank, dout),
                                               device=w.device, dtype=dtype)
    out = dict(params)
    out["llm"] = dict(params["llm"])
    out["llm"]["layers"] = layers
    out["llm"]["lora_scale"] = torch.tensor(alpha / rank,
                                            dtype=torch.float32,
                                            device=w.device)
    return out


def merge_lora(params: dict) -> dict:
    """Fold the adapters into the base weights (inference/export). An int8
    or packed-int4 base is dequantized in f32, the delta added and the sum
    requantized with the same quantizer (a raw cast would truncate the
    merged weights), as in the reference."""
    llm = params["llm"]
    if "lora_scale" not in llm:
        return params
    scale = llm["lora_scale"].float()
    layers = dict(llm["layers"])
    for name in list(layers):
        if not name.endswith("_lora_a"):
            continue
        base = name[: -len("_lora_a")]
        a = layers.pop(name)
        b = layers.pop(base + "_lora_b")
        w = layers[base]
        if w.dtype in (torch.int8, torch.uint8):
            layers[base], layers[base + "_scale"] = _merge_quantized(
                w, layers[base + "_scale"], a, b, scale)
            continue
        delta = torch.einsum("lir,lro->lio", a.float(), b.float()) * scale
        layers[base] = (w.float() + delta).to(w.dtype)
    out = dict(params)
    out["llm"] = {k: v for k, v in llm.items() if k != "lora_scale"}
    out["llm"]["layers"] = layers
    return out


def _merge_quantized(w, w_scale, a, b, scale):
    """(w, scales) of an int8 or packed-int4 stack with the adapters folded
    in, one layer at a time (the f32 temporaries are one layer's): the
    layer dequantized in f32, the f32 delta added, the sum requantized by
    the stack's own quantizer. Per layer and column, as over the stack."""
    if w.dtype == torch.int8:
        def requant(i, delta):
            return quant.quantize_weight(w[i].float() * w_scale[i] + delta)
    else:
        def requant(i, delta):
            return quant.quantize_weight_int4(
                quant.dequant_int4(w[i], w_scale[i], torch.float32) + delta)
    out = [requant(i, torch.einsum("ir,ro->io", a[i].float(), b[i].float())
                   * scale) for i in range(w.shape[0])]
    return torch.stack([q for q, _ in out]), torch.stack([s for _, s in out])


def split_lora(params: dict) -> Tuple[dict, dict]:
    """(base_params, adapter_only) for adapter-only checkpointing."""
    llm = params["llm"]
    layers = llm["layers"]
    adapters = {k: v for k, v in layers.items() if "_lora_" in k}
    base = dict(params)
    base["llm"] = {k: v for k, v in llm.items() if k != "lora_scale"}
    base["llm"]["layers"] = {k: v for k, v in layers.items()
                             if "_lora_" not in k}
    return base, {"layers": adapters, "lora_scale": llm.get("lora_scale")}


def apply_adapters_npz(params: dict, path: str) -> dict:
    """Attach adapters exported as an npz (`<w>_lora_a/_lora_b` stacks and
    `lora_scale`, the JAX trainer's lora_adapters.npz) onto a base tree,
    on its device; call merge_lora() afterwards to fold them for
    serving."""
    device = params["llm"]["layers"]["q_w"].device
    layers = dict(params["llm"]["layers"])
    with np.load(path) as data:
        for k in data.files:
            if k != "lora_scale":
                layers[k] = torch.from_numpy(np.array(data[k])).to(device)
        scale = torch.tensor(np.asarray(data["lora_scale"]),
                             dtype=torch.float32, device=device)
    out = dict(params)
    out["llm"] = dict(params["llm"])
    out["llm"]["layers"] = layers
    out["llm"]["lora_scale"] = scale
    return out


def is_lora_path(path_str: str) -> bool:
    return "_lora_" in path_str or path_str.endswith("lora_scale")
