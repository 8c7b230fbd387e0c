"""The system under test: the port's agent over its streaming engine,
built as the evaluation command builds it (`eval_cli.build_agent`):
weights (here the benchmark's, from the seed), the LLM quantized when the
configuration serves it so (`models/quant.py::quantize_llm`), q/k/v and
gate/up fused, the engine with the configuration's serving settings, and
one VLNAgent over it."""
from __future__ import annotations

from typing import Callable, Optional

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def program_config(cfg: dict):
    """The port's StreamVLNConfig of a configuration file."""
    from streamvln_tpu_torch.configs import (Qwen2Config, SigLIPConfig,
                                             StreamVLNConfig)
    return StreamVLNConfig(
        vision=SigLIPConfig(**cfg["vision"]), llm=Qwen2Config(**cfg["llm"]),
        projector_type=cfg["projector_type"],
        spatial_pool_mode=cfg["spatial_pool_mode"],
        spatial_pool_stride=cfg["spatial_pool_stride"],
        num_frames=cfg["num_frames"],
        num_future_steps=cfg["num_future_steps"],
        num_history=cfg["num_history"])


def build_kernels(device: torch.device) -> None:
    """Compile the port's CUDA kernels that are not built yet, all at once
    (into the checkout's `streamvln_tpu_torch/_build/`)."""
    if device.type == "cuda":
        from streamvln_tpu_torch.kernels import build
        build.build_all()


def build_agent(cfg: dict, make_params: Callable[[], dict], tok,
                n_envs: int, device: torch.device,
                bits: Optional[int] = None):
    """The agent, with weights from `make_params()` (dropped here once the
    program has made its own from them). `bits` overrides the
    configuration's serving width (the control's int8 path)."""
    from streamvln_tpu_torch.agent import VLNAgent
    from streamvln_tpu_torch.models import quant
    from streamvln_tpu_torch.models.fuse import fuse_projections
    from streamvln_tpu_torch.streaming.engine import StreamingEngine
    serving = cfg["serving"]
    bits = serving["bits"] if bits is None else bits
    params = make_params()
    if bits in (4, 8):
        params = quant.quantize_llm(params, bits=bits)
    params = fuse_projections(params)
    engine = StreamingEngine(
        params, program_config(cfg), n_envs=n_envs,
        cache_capacity=serving["cache_capacity"],
        max_new_tokens=serving["max_new_tokens"],
        stop_ids=tuple(dict.fromkeys((tok.im_end_id, tok.eos_id))),
        compute_dtype=DTYPES[cfg["dtype"]],
        attn_impl=serving["attn_impl"], spec_lookup=serving["spec_lookup"],
        device=device)
    return VLNAgent(engine, tok)
