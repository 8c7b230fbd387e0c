"""SigLIP vision tower (so400m-patch14-384), PyTorch.

Counterpart of `streamvln_tpu/models/siglip.py`: patch embed as one
matmul over channel-major flattened patches, learned position embeddings,
pre-LN blocks with tanh-GELU MLPs, no post-LayerNorm. Per-layer weights
are stacked [L, ...] and stored [in, out]; the blocks run as a Python
loop (`remat`: one non-reentrant `torch.utils.checkpoint` per block).
Attention dispatches through ops.attention.mha_attention, which takes the
vit kernel (K1) on the card. A tower quantized by
`models/quant.quantize_vision` carries `<name>_w_scale` beside each int8
projection, which then runs as an int8 x int8 product with per-token
activation quantization (`quant.int8_dynamic_matmul`), as the reference's
tower does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from streamvln_tpu_torch.configs import SigLIPConfig
from streamvln_tpu_torch.models.quant import int8_dynamic_matmul
from streamvln_tpu_torch.ops.attention import mha_attention
from streamvln_tpu_torch.ops.fused_patch_embed import fused_patch_embed
from streamvln_tpu_torch.ops.linear import matmul_f32

Params = dict


def layer_norm(x, scale, bias, eps):
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    normed = (xf - mean) * torch.rsqrt(var + eps)
    return (normed * scale.float() + bias.float()).to(x.dtype)


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, H, W, 3] -> [B, N, 3*patch*patch], row-major patches, channel-
    major inside a patch (Conv2d weight order). Trailing pixels that do
    not fill a patch are dropped (384 = 27*14 + 6)."""
    B, H, W, C = images.shape
    gh, gw = H // patch, W // patch
    x = images[:, :gh * patch, :gw * patch]
    x = x.reshape(B, gh, patch, gw, patch, C).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(B, gh * gw, C * patch * patch)


def forward(params: Params, cfg: SigLIPConfig, images: torch.Tensor,
            attn_impl: str = "auto", remat: bool = False) -> torch.Tensor:
    """images [B, H, W, 3] preprocessed pixels -> [B, 729, hidden]."""
    x = patchify(images, cfg.patch_size)
    x = (matmul_f32(x, params["patch_w"])
         + params["patch_b"].float()).to(images.dtype)
    return forward_embeddings(params, cfg, x, attn_impl, remat)


def forward_raw(params: Params, cfg: SigLIPConfig, frames_u8: torch.Tensor,
                attn_impl: str = "auto", remat: bool = False,
                compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Raw [B, H, W, 3] uint8 frames -> [B, 729, hidden] through the fused
    resize/normalise/patch-embed (ops/fused_patch_embed.py)."""
    x = fused_patch_embed(frames_u8, params["patch_w"], params["patch_b"],
                          image_size=cfg.image_size,
                          patch_size=cfg.patch_size,
                          compute_dtype=compute_dtype)
    return forward_embeddings(params, cfg, x, attn_impl, remat)


def forward_embeddings(params: Params, cfg: SigLIPConfig,
                       embeds: torch.Tensor, attn_impl: str = "auto",
                       remat: bool = False) -> torch.Tensor:
    """Patch embeddings [B, N, hidden] -> encoder output."""
    B, N, _ = embeds.shape
    H, Dh = cfg.num_heads, cfg.head_dim
    x = embeds + params["pos_embed"].to(embeds.dtype)[None]
    p = params["layers"]

    def dense(h, name, i):
        if name + "_w_scale" in p:
            out = int8_dynamic_matmul(h, p[name + "_w"][i],
                                      p[name + "_w_scale"][i])
            return out.to(h.dtype) + p[name + "_b"][i]
        return torch.matmul(h, p[name + "_w"][i]) + p[name + "_b"][i]

    def block(x, i):
        h = layer_norm(x, p["ln1_s"][i], p["ln1_b"][i], cfg.layer_norm_eps)
        q = dense(h, "q", i).reshape(B, N, H, Dh)
        k = dense(h, "k", i).reshape(B, N, H, Dh)
        v = dense(h, "v", i).reshape(B, N, H, Dh)
        attn = mha_attention(q, k, v, impl=attn_impl).reshape(B, N, H * Dh)
        x = x + dense(attn, "o", i)
        h = layer_norm(x, p["ln2_s"][i], p["ln2_b"][i], cfg.layer_norm_eps)
        h = F.gelu(dense(h, "fc1", i), approximate="tanh")
        return x + dense(h, "fc2", i)

    for i in range(cfg.num_layers):
        x = checkpoint(block, x, i, use_reentrant=False) if remat \
            else block(x, i)
    return x
