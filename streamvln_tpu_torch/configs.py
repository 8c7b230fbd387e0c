"""Configuration dataclasses and presets for the PyTorch port.

A twin of `streamvln_tpu/configs.py` (SigLIPConfig, Qwen2Config,
StreamVLNConfig, the presets and the LLM family registry): the same field
names and defaults, so a config built on one side can be rebuilt on the
other with `dataclasses.asdict`. Shapes follow SigLIP-so400m-patch14-384
and Qwen2-7B.

One difference: `StreamVLNConfig.tokens_per_frame` follows the pool mode.
The reference always counts ceil(side / stride)^2, while its strided pools
("average", "max") trim the grid to floor(side / stride) * stride and give
floor(side / stride)^2 tokens (13^2 = 169 at 27 patches a side), so its
`encode_frames` raises at an odd side (ROADMAP §3.8). The port counts
what the pool gives.
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
    """Decoder config: Qwen2 by default (RMSNorm + RoPE + GQA + SwiGLU),
    and through the family knobs Llama, Mistral, Gemma ((1 + w) norms,
    scaled embeddings, gelu_tanh), MPT (alibi, weight-only LayerNorm,
    ungated gelu MLP) and the MoE families (Mixtral, Qwen2-MoE with its
    shared expert; `moe_dispatch` "dense" or "capacity")."""
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
        """Tokens a frame pools to: ceil(27/2)^2 = 196 under "bilinear",
        floor(27/2)^2 = 169 under the strided "average" and "max"."""
        side, stride = self.vision.patches_per_side, self.spatial_pool_stride
        out = side // stride if self.spatial_pool_mode in ("average", "max") \
            else -(-side // stride)
        return out * out

    @property
    def memory_tokens(self) -> int:
        return self.num_history * self.tokens_per_frame  # 1568


def qwen2_7b() -> Qwen2Config:
    return Qwen2Config()


def qwen2_14b() -> Qwen2Config:
    """Qwen2.5-14B-class decoder, the reference's int4 capacity target:
    every projection dim is a multiple of 512."""
    return Qwen2Config(
        vocab_size=152064, hidden_size=5120, intermediate_size=13824,
        num_layers=48, num_heads=40, num_kv_heads=8, head_dim=128)


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


def llama2_7b() -> Qwen2Config:
    """Llama-2-7B (the reference's llava_llama family)."""
    return Qwen2Config(
        vocab_size=32000, hidden_size=4096, intermediate_size=11008,
        num_layers=32, num_heads=32, num_kv_heads=32, head_dim=128,
        rope_theta=10000.0, rms_norm_eps=1e-5,
        max_position_embeddings=4096, qkv_bias=False)


def llama3_8b() -> Qwen2Config:
    return Qwen2Config(
        vocab_size=128256, hidden_size=4096, intermediate_size=14336,
        num_layers=32, num_heads=32, num_kv_heads=8, head_dim=128,
        rope_theta=500000.0, rms_norm_eps=1e-5,
        max_position_embeddings=8192, qkv_bias=False)


def mistral_7b() -> Qwen2Config:
    """Mistral-7B-v0.1 (the llava_mistral family)."""
    return Qwen2Config(
        vocab_size=32000, hidden_size=4096, intermediate_size=14336,
        num_layers=32, num_heads=32, num_kv_heads=8, head_dim=128,
        rope_theta=10000.0, rms_norm_eps=1e-5,
        max_position_embeddings=32768, qkv_bias=False)


def gemma_2b() -> Qwen2Config:
    """Gemma-2B (the llava_gemma family): gelu_tanh MLP, (1 + w) RMSNorm,
    sqrt(hidden) embedding scale, tied head, head dim 256."""
    return Qwen2Config(
        vocab_size=256000, hidden_size=2048, intermediate_size=16384,
        num_layers=18, num_heads=8, num_kv_heads=1, head_dim=256,
        rope_theta=10000.0, rms_norm_eps=1e-6,
        max_position_embeddings=8192, qkv_bias=False,
        tie_word_embeddings=True, mlp_act="gelu_tanh",
        norm_offset=True, scale_embeddings=True)


def mpt_7b() -> Qwen2Config:
    """MPT-7B (the llava_mpt family): alibi attention, weight-only
    LayerNorm, ungated gelu MLP, tied head."""
    return Qwen2Config(
        vocab_size=50432, hidden_size=4096, intermediate_size=16384,
        num_layers=32, num_heads=32, num_kv_heads=32, head_dim=128,
        rms_norm_eps=1e-5, max_position_embeddings=2048,
        qkv_bias=False, tie_word_embeddings=True, mlp_act="gelu",
        positional="alibi", norm_type="layernorm", mlp_gated=False)


def mixtral_8x7b() -> Qwen2Config:
    """Mixtral-8x7B (the llava_mixtral family): 8 experts, top-2."""
    return Qwen2Config(
        vocab_size=32000, hidden_size=4096, intermediate_size=14336,
        num_layers=32, num_heads=32, num_kv_heads=8, head_dim=128,
        rope_theta=1e6, rms_norm_eps=1e-5,
        max_position_embeddings=32768, qkv_bias=False,
        num_experts=8, num_experts_per_tok=2, norm_topk_prob=True)


def qwen2_moe_a2_7b() -> Qwen2Config:
    """Qwen1.5-MoE-A2.7B-style (the llava_qwen_moe family): 60 experts,
    top-4, plus a sigmoid-gated shared expert."""
    return Qwen2Config(
        vocab_size=151936, hidden_size=2048, intermediate_size=5632,
        num_layers=24, num_heads=16, num_kv_heads=16, head_dim=128,
        rope_theta=1e6, rms_norm_eps=1e-6,
        max_position_embeddings=8192, qkv_bias=True,
        num_experts=60, num_experts_per_tok=4, norm_topk_prob=False,
        moe_intermediate_size=1408,
        shared_expert_intermediate_size=5632)


LLM_REGISTRY = {
    "qwen2-7b": qwen2_7b, "qwen2-14b": qwen2_14b,
    "qwen2-1.5b": qwen2_1_5b,
    "qwen2-0.5b": qwen2_0_5b, "llama2-7b": llama2_7b,
    "llama3-8b": llama3_8b, "mistral-7b": mistral_7b,
    "gemma-2b": gemma_2b, "mixtral-8x7b": mixtral_8x7b,
    "qwen2-moe-a2.7b": qwen2_moe_a2_7b, "mpt-7b": mpt_7b,
}


def llm_config(name: str) -> Qwen2Config:
    """The registry's decoder of that name; an unknown name raises
    ValueError with the reference's message."""
    if name not in LLM_REGISTRY:
        raise ValueError(
            f"unknown LLM {name!r}; known: {sorted(LLM_REGISTRY)}")
    return LLM_REGISTRY[name]()


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
    "tiny" (tiny tower too), or any `LLM_REGISTRY` name (an unknown one
    raises ValueError), with `spatial_pool_mode`, `num_frames`,
    `num_future_steps` and `num_history`."""
    short = {"7b": qwen2_7b, "1.5b": qwen2_1_5b, "0.5b": qwen2_0_5b,
             "tiny": tiny_llm}
    if args.model_size in short:
        llm = short[args.model_size]()
    else:
        llm = llm_config(args.model_size)
    vision = tiny_vision() if args.model_size == "tiny" else siglip_so400m()
    return StreamVLNConfig(
        vision=vision, llm=llm,
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
