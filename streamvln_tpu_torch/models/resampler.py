"""Vision-token resamplers of the PyTorch port (reference zoo:
llava/model/multimodal_resampler/builder.py: masked_drop, spatial_pool,
perceiver, qformer, identity; the reference default and the StreamVLN path
use identity, with pooling done downstream).

Counterpart of `streamvln_tpu/models/resampler.py`, with its surface:
build_resampler(name, **kw) -> (init_fn, apply_fn), where
init_fn(dim, generator=None, device=..., dtype=...) makes the parameters
and apply_fn(params, feats [B, N, D], generator=None, train=False) ->
[B, M, D']. Attention inside the perceiver and the qformer is the plain
`dense_attention`, as the reference's (no kernel). masked_drop draws its
tokens from the `torch.Generator` it is given: the kept count, the kept
rows (original rows in their original order) and determinism by seed are
the reference's, the draws are not.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from streamvln_tpu_torch.configs import resolve_device
from streamvln_tpu_torch.models.siglip import layer_norm
from streamvln_tpu_torch.ops.attention import dense_attention
from streamvln_tpu_torch.weights import leaf_makers


def _makers_for(generator, device, dtype):
    return leaf_makers(generator, resolve_device(device), dtype)


def _dot(x, w):
    return torch.matmul(x, w.to(x.dtype))


def identity_resampler():
    def init(dim, generator=None, device="cuda", dtype=torch.bfloat16):
        return {}

    def apply(params, feats, generator=None, train=False):
        return feats
    return init, apply


def masked_drop_resampler(ratio: float = 0.5):
    """Drop tokens at random at train time (reference: masked_drop.py):
    keeps ceil(N * (1 - ratio)) of each row's tokens in their order;
    eval (or no generator) keeps them all."""
    def init(dim, generator=None, device="cuda", dtype=torch.bfloat16):
        return {}

    def apply(params, feats, generator=None, train=False):
        if not train or generator is None:
            return feats
        B, N, D = feats.shape
        keep = max(1, int(math.ceil(N * (1.0 - ratio))))
        noise = torch.rand((B, N), generator=generator,
                           device=generator.device)
        idx = torch.argsort(noise, dim=1)[:, :keep].sort(dim=1).values
        idx = idx.to(feats.device)
        return torch.gather(feats, 1, idx[..., None].expand(-1, -1, D))
    return init, apply


def spatial_pool_resampler(stride: int = 2, mode: str = "average"):
    """Strided 2D pooling over the token grid (reference:
    spatial_pool.py)."""
    def init(dim, generator=None, device="cuda", dtype=torch.bfloat16):
        return {}

    def apply(params, feats, generator=None, train=False):
        B, N, D = feats.shape
        side = math.isqrt(N)
        if side * side != N:
            raise ValueError(f"{N} tokens is not a square grid")
        out_side = side // stride
        blocks = feats.reshape(B, side, side, D)[
            :, :out_side * stride, :out_side * stride].reshape(
            B, out_side, stride, out_side, stride, D)
        pooled = blocks.mean(dim=(2, 4)) if mode == "average" \
            else blocks.amax(dim=(2, 4))
        return pooled.reshape(B, out_side * out_side, D)
    return init, apply


def perceiver_resampler(num_latents: int = 64, num_layers: int = 2,
                        num_heads: int = 8):
    """Latent cross-attention resampler (reference: perceiver.py,
    PerceiverResampler): learned latents attend over [tokens; latents]."""
    def init(dim, generator=None, device="cuda", dtype=torch.bfloat16):
        dense, zeros, ones = _makers_for(generator, device, dtype)
        latents = dense((num_latents, dim), dim)
        layers = [{
            "ln_s": ones((dim,)), "ln_b": zeros((dim,)),
            "q_w": dense((dim, dim), dim),
            "kv_w": dense((dim, 2 * dim), dim),
            "o_w": dense((dim, dim), dim),
            "ff1": dense((dim, 4 * dim), dim),
            "ff2": dense((4 * dim, dim), 4 * dim),
        } for _ in range(num_layers)]
        return {"latents": latents, "layers": layers,
                "out_ln_s": ones((dim,)), "out_ln_b": zeros((dim,))}

    def apply(params, feats, generator=None, train=False):
        B, N, D = feats.shape
        Dh = D // num_heads
        lat = params["latents"].to(feats.dtype)[None].expand(
            B, num_latents, D)
        for p in params["layers"]:
            h = layer_norm(lat, p["ln_s"], p["ln_b"], 1e-6)
            ctx = torch.cat([feats, lat], dim=1)
            q = _dot(h, p["q_w"]).reshape(B, num_latents, num_heads, Dh)
            kk, vv = _dot(ctx, p["kv_w"]).chunk(2, dim=-1)
            attn = dense_attention(q, kk.reshape(B, -1, num_heads, Dh),
                                   vv.reshape(B, -1, num_heads, Dh))
            lat = lat + _dot(attn.reshape(B, num_latents, D), p["o_w"])
            h = layer_norm(lat, p["ln_s"], p["ln_b"], 1e-6)
            lat = lat + _dot(F.gelu(_dot(h, p["ff1"]), approximate="tanh"),
                             p["ff2"])
        return layer_norm(lat, params["out_ln_s"], params["out_ln_b"], 1e-6)
    return init, apply


def qformer_resampler(num_latents: int = 32, hidden_size: int = 768,
                      num_layers: int = 12, num_heads: int = 12,
                      cross_attention_freq: int = 2,
                      intermediate_size: int = 3072):
    """BLIP-2-style Q-Former (reference:
    multimodal_resampler/qformer.py:1102-1160): a BERT-base query encoder
    with cross-attention to the image features every
    `cross_attention_freq` layers and a query FFN (no word/position
    embeddings, no text-branch FFN). The features keep their own width
    (`dim`); the output is [B, num_latents, hidden_size]. BERT layers are
    post-LN: x = LN(x + sublayer(x))."""
    def init(dim, generator=None, device="cuda", dtype=torch.bfloat16):
        dense, zeros, ones = _makers_for(generator, device, dtype)
        H = hidden_size
        queries = dense((num_latents, H), 1.0).mul_(0.02)

        def ln():
            return {"s": ones((H,)), "b": zeros((H,))}

        def attn(din):
            return {"q_w": dense((H, H), H), "k_w": dense((din, H), din),
                    "v_w": dense((din, H), din), "o_w": dense((H, H), H),
                    "ln": ln()}
        layers = []
        for i in range(num_layers):
            layer = {"self": attn(H),
                     "ffn": {"w1": dense((H, intermediate_size), H),
                             "w2": dense((intermediate_size, H),
                                         intermediate_size),
                             "ln": ln()}}
            if i % cross_attention_freq == 0:
                layer["cross"] = attn(dim)
            layers.append(layer)
        return {"queries": queries, "ln_vision_s": ones((dim,)),
                "ln_vision_b": zeros((dim,)), "layers": layers}

    def _mha(p, q_in, kv_in):
        B, M, H = q_in.shape
        Dh = H // num_heads
        q = _dot(q_in, p["q_w"]).reshape(B, M, num_heads, Dh)
        k = _dot(kv_in, p["k_w"]).reshape(B, -1, num_heads, Dh)
        v = _dot(kv_in, p["v_w"]).reshape(B, -1, num_heads, Dh)
        return _dot(dense_attention(q, k, v).reshape(B, M, H), p["o_w"])

    def apply(params, feats, generator=None, train=False):
        B = feats.shape[0]
        x = layer_norm(feats, params["ln_vision_s"], params["ln_vision_b"],
                       1e-12)
        h = params["queries"].to(feats.dtype)[None].expand(
            B, num_latents, hidden_size)
        for p in params["layers"]:
            sa = p["self"]
            h = layer_norm(h + _mha(sa, h, h), sa["ln"]["s"], sa["ln"]["b"],
                           1e-12)
            if "cross" in p:
                ca = p["cross"]
                h = layer_norm(h + _mha(ca, h, x), ca["ln"]["s"],
                               ca["ln"]["b"], 1e-12)
            ff = p["ffn"]
            y = _dot(F.gelu(_dot(h, ff["w1"]), approximate="tanh"),
                     ff["w2"])
            h = layer_norm(h + y, ff["ln"]["s"], ff["ln"]["b"], 1e-12)
        return h
    return init, apply


def build_resampler(name: Optional[str], **kwargs):
    """Dispatch of the reference builder
    (multimodal_resampler/builder.py:21-34)."""
    if name in (None, "identity", "none"):
        return identity_resampler()
    if name == "masked_drop":
        return masked_drop_resampler(**kwargs)
    if name == "spatial_pool":
        return spatial_pool_resampler(**kwargs)
    if name == "perceiver":
        return perceiver_resampler(**kwargs)
    if name == "qformer":
        return qformer_resampler(**kwargs)
    raise ValueError(f"unknown resampler: {name}")
