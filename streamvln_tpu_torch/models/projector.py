"""Multimodal projector (vision hidden -> LLM hidden), PyTorch.

Counterpart of `streamvln_tpu/models/projector.py`: `mlp2x_gelu` is two
linear layers with an exact (erf) GELU between them, unlike the vision
tower's tanh GELU.
"""
from __future__ import annotations

import re

import torch
import torch.nn.functional as F

from streamvln_tpu_torch.ops.linear import matmul_f32

Params = dict


def parse_type(projector_type: str) -> int:
    """Return mlp depth (1 == linear)."""
    if projector_type == "linear":
        return 1
    m = re.match(r"^mlp(\d+)x_gelu$", projector_type)
    if m:
        return int(m.group(1))
    raise ValueError(f"unsupported projector type: {projector_type}")


def forward(params: Params, x: torch.Tensor) -> torch.Tensor:
    """x [..., in_dim] -> [..., out_dim]."""
    for i, p in enumerate(params["layers"]):
        if i > 0:
            x = F.gelu(x, approximate="none")
        x = (matmul_f32(x, p["w"]) + p["b"].float()).to(x.dtype)
    return x
