"""Configuration dataclasses and presets for the PyTorch port.

A twin of `streamvln_tpu/configs.py` (SigLIPConfig, Qwen2Config,
StreamVLNConfig and the presets this slice serves): the same field names
and defaults, so a config built on one side can be rebuilt on the other
with `dataclasses.asdict`. Shapes follow SigLIP-so400m-patch14-384 and
Qwen2-7B.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class SigLIPConfig:
    """SigLIP vision tower. `num_layers` is the number of layers run: the
    checkpoint's last encoder layer and pooling head are dropped."""
    hidden_size: int = 1152
    intermediate_size: int = 4304
    num_layers: int = 26
    num_heads: int = 16
    image_size: int = 384
    patch_size: int = 14
    layer_norm_eps: float = 1e-6

    @property
    def patches_per_side(self) -> int:
        return self.image_size // self.patch_size  # 27

    @property
    def num_patches(self) -> int:
        return self.patches_per_side ** 2  # 729

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads  # 72


@dataclasses.dataclass(frozen=True)
class Qwen2Config:
    """Qwen2 decoder config (RMSNorm + RoPE + GQA + SwiGLU).

    The family and quantization knobs are kept so configs round-trip with
    the reference; the port's decoder serves only the Qwen2 defaults and
    raises NotImplementedError for the others (models/qwen2.py)."""
    vocab_size: int = 152064
    hidden_size: int = 3584
    intermediate_size: int = 18944
    num_layers: int = 28
    num_heads: int = 28
    num_kv_heads: int = 4
    head_dim: int = 128
    rope_theta: float = 1_000_000.0
    rms_norm_eps: float = 1e-6
    max_position_embeddings: int = 32768
    tie_word_embeddings: bool = False
    attn_logits_soft_cap: Optional[float] = None
    qkv_bias: bool = True
    act_int8: bool = False
    mlp_act: str = "silu"
    norm_offset: bool = False
    scale_embeddings: bool = False
    positional: str = "rope"
    norm_type: str = "rmsnorm"
    mlp_gated: bool = True
    num_experts: int = 0
    num_experts_per_tok: int = 2
    moe_intermediate_size: Optional[int] = None
    norm_topk_prob: bool = True
    shared_expert_intermediate_size: Optional[int] = None
    moe_dispatch: str = "dense"
    moe_capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class StreamVLNConfig:
    """Full multimodal stack + streaming parameters."""
    vision: SigLIPConfig = dataclasses.field(default_factory=SigLIPConfig)
    llm: Qwen2Config = dataclasses.field(default_factory=Qwen2Config)
    projector_type: str = "mlp2x_gelu"
    spatial_pool_mode: str = "bilinear"
    spatial_pool_stride: int = 2
    num_frames: int = 32          # sliding window length in env steps
    num_future_steps: int = 4     # actions emitted per model call
    num_history: int = 8          # pooled history frames in slow memory

    @property
    def tokens_per_frame(self) -> int:
        side = -(-self.vision.patches_per_side // self.spatial_pool_stride)
        return side * side  # ceil(27/2)^2 = 196

    @property
    def memory_tokens(self) -> int:
        return self.num_history * self.tokens_per_frame  # 1568


def qwen2_7b() -> Qwen2Config:
    return Qwen2Config()


def qwen2_1_5b() -> Qwen2Config:
    return Qwen2Config(
        vocab_size=151936, hidden_size=1536, intermediate_size=8960,
        num_layers=28, num_heads=12, num_kv_heads=2, head_dim=128,
        tie_word_embeddings=True)


def qwen2_0_5b() -> Qwen2Config:
    return Qwen2Config(
        vocab_size=151936, hidden_size=896, intermediate_size=4864,
        num_layers=24, num_heads=14, num_kv_heads=2, head_dim=64,
        tie_word_embeddings=True)


def siglip_so400m() -> SigLIPConfig:
    return SigLIPConfig()


def streamvln_7b() -> StreamVLNConfig:
    return StreamVLNConfig(vision=siglip_so400m(), llm=qwen2_7b())


def tiny_vision(image_size: int = 56, patch_size: int = 14) -> SigLIPConfig:
    """Small vision tower for tests: 4x4 = 16 patches."""
    return SigLIPConfig(
        hidden_size=32, intermediate_size=64, num_layers=2, num_heads=4,
        image_size=image_size, patch_size=patch_size)


def tiny_llm(vocab_size: int = 512) -> Qwen2Config:
    return Qwen2Config(
        vocab_size=vocab_size, hidden_size=64, intermediate_size=128,
        num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
        rope_theta=10000.0, max_position_embeddings=2048)


def tiny_streamvln(vocab_size: int = 512) -> StreamVLNConfig:
    """End-to-end tiny stack: 16 patches -> 2x2 pool -> 4 tokens/frame."""
    return StreamVLNConfig(
        vision=tiny_vision(), llm=tiny_llm(vocab_size),
        num_frames=8, num_future_steps=2, num_history=2)


def build_config(args) -> StreamVLNConfig:
    """The stack a CLI's arguments name (a twin of the reference's
    `train.py::build_config`): `args.model_size` is "7b", "1.5b", "0.5b" or
    "tiny" (tiny tower too), with `spatial_pool_mode`, `num_frames`,
    `num_future_steps` and `num_history`. The reference's other LLM
    families (its `llm_config` registry) are a later slice of the port."""
    short = {"7b": qwen2_7b, "1.5b": qwen2_1_5b, "0.5b": qwen2_0_5b,
             "tiny": tiny_llm}
    if args.model_size not in short:
        raise NotImplementedError(
            f"model_size {args.model_size!r}: the LLM family registry is "
            f"ROADMAP queue 1 item 10 of the PyTorch port; choose one of "
            f"{sorted(short)}")
    vision = tiny_vision() if args.model_size == "tiny" else siglip_so400m()
    return StreamVLNConfig(
        vision=vision, llm=short[args.model_size](),
        spatial_pool_mode=args.spatial_pool_mode,
        num_frames=args.num_frames,
        num_future_steps=args.num_future_steps,
        num_history=args.num_history)


DTYPE_MAP = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "fp32": torch.float32,
    "bf16": torch.bfloat16,
}


def resolve_device(device) -> torch.device:
    """The port's entry points run on the card unless the caller asks for
    the CPU. Asking for CUDA without a card raises; nothing falls back."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but no CUDA device is available; "
            "pass device='cpu' to run on the CPU")
    return device
