"""Vision-encoder zoo of the PyTorch port: CLIP / OpenCLIP / MLCD (2D
RoPE) and EVA-CLIP towers, the S2 multi-scale wrapper and the
name-dispatch builder.

Counterpart of `streamvln_tpu/models/encoders.py` (reference surface:
llava/model/multimodal_encoder/builder.py:13-42, clip_encoder.py,
open_clip_encoder.py, mlcd/vit_rope2d_hf.py, eva_clip/eva_vit.py). The
SigLIP tower StreamVLN ships with is models/siglip.py, whose `layer_norm`
and `patchify` these towers reuse. Per-layer weights are stacked
[L, ...] and stored [in, out]; the blocks run as a Python loop. Attention
goes through ops.attention.mha_attention: under "auto" every zoo shape
(S <= 1024, head dim 64, 88 or 104) takes the vit kernel (K1) on the card
or raises, never dense attention.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from streamvln_tpu_torch.configs import resolve_device
from streamvln_tpu_torch.models.siglip import layer_norm, patchify
from streamvln_tpu_torch.ops.attention import mha_attention
from streamvln_tpu_torch.ops.linear import matmul_f32
from streamvln_tpu_torch.weights import leaf_makers, siglip_init

Params = dict


@dataclasses.dataclass(frozen=True)
class ClipVisionConfig:
    """CLIP-family ViT (OpenAI CLIP, OpenCLIP, MLCD). `select_layer`
    follows the reference's hidden_states indexing (clip_encoder.py:58):
    -2 is the output of the penultimate block; only the blocks that feed
    it run."""
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 24
    num_heads: int = 16
    image_size: int = 336
    patch_size: int = 14
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"   # OpenAI CLIP; "gelu" for OpenCLIP
    rope2d: bool = False             # MLCD vit_rope2d towers
    select_layer: int = -2
    select_feature: str = "patch"    # "patch" | "cls_patch"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid * self.grid

    @property
    def feature_dim(self) -> int:
        return self.hidden_size


def _act(name: str):
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="none")
    if name == "gelu_tanh":
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation: {name}")


def init(cfg: ClipVisionConfig, generator: Optional[torch.Generator] = None,
         device="cuda", dtype=torch.bfloat16) -> Params:
    """Random CLIP-tower weights made on `device` in the reference's
    fan-in-scaled form (the numbers differ from the JAX init of the same
    seed; `weights.from_jax_tower` carries a JAX tree across)."""
    device = resolve_device(device)
    dense, zeros, ones = leaf_makers(generator, device, dtype)
    L, D, Fi = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    P, N = cfg.patch_size, cfg.num_patches
    params = {
        # CLIP's patch conv has no bias (CLIPVisionEmbeddings)
        "patch_w": dense((P * P * 3, D), P * P * 3),
        "cls_embed": dense((D,), D),
        "pre_ln_s": ones((D,)), "pre_ln_b": zeros((D,)),
        "layers": {
            "ln1_s": ones((L, D)), "ln1_b": zeros((L, D)),
            "q_w": dense((L, D, D), D), "q_b": zeros((L, D)),
            "k_w": dense((L, D, D), D), "k_b": zeros((L, D)),
            "v_w": dense((L, D, D), D), "v_b": zeros((L, D)),
            "o_w": dense((L, D, D), D), "o_b": zeros((L, D)),
            "ln2_s": ones((L, D)), "ln2_b": zeros((L, D)),
            "fc1_w": dense((L, D, Fi), D), "fc1_b": zeros((L, Fi)),
            "fc2_w": dense((L, Fi, D), Fi), "fc2_b": zeros((L, D)),
        },
    }
    if cfg.rope2d:
        # learned class-token rotary phase (vit_rope2d_hf.py:287)
        params["class_pos_emb"] = dense((cfg.head_dim // 2,),
                                        cfg.head_dim // 2)
    else:
        params["pos_embed"] = dense((N + 1, D), D)
    return params


def _rope2d_freqs(cfg: ClipVisionConfig,
                  class_pos_emb: torch.Tensor) -> torch.Tensor:
    """Per-token rotary phase [N+1, head_dim/2] over the 2D patch grid
    (vit_rope2d_hf.py:290-307): row and column phases from a head_dim/4
    inverse-frequency bank side by side; the class token takes a learned
    phase."""
    dim = cfg.head_dim // 2          # rotary bank width
    g, dev = cfg.grid, class_pos_emb.device
    inv_freq = 1.0 / (10000.0 ** (torch.arange(
        0, dim, 2, dtype=torch.float32, device=dev) / dim))
    ar = torch.arange(g, dtype=torch.float32, device=dev)
    hpos = ar.repeat_interleave(g)   # row-major
    wpos = ar.repeat(g)
    freqs = torch.cat([hpos[:, None] * inv_freq[None],
                       wpos[:, None] * inv_freq[None]], dim=-1)
    return torch.cat([class_pos_emb.float()[None], freqs], dim=0)


def _apply_rope2d(x: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """x [B, N, H, Dh]; freqs [N, Dh/2] (cos/sin repeated over the two
    halves, rotate-half convention, vit_rope2d_hf.py:19-28), in f32."""
    xf = x.float()
    cos = torch.cos(freqs).repeat(1, 2)[None, :, None, :]
    sin = torch.sin(freqs).repeat(1, 2)[None, :, None, :]
    half = xf.shape[-1] // 2
    rot = torch.cat([-xf[..., half:], xf[..., :half]], dim=-1)
    return (xf * cos + rot * sin).to(x.dtype)


def forward(params: Params, cfg: ClipVisionConfig, images: torch.Tensor,
            attn_impl: str = "auto", remat: bool = False) -> torch.Tensor:
    """images [B, H, W, 3] preprocessed pixels -> the selected features
    ([B, N, D] for "patch", [B, N+1, D] for "cls_patch")."""
    if cfg.select_feature not in ("patch", "cls_patch"):
        raise ValueError(f"unknown select_feature: {cfg.select_feature}")
    B = images.shape[0]
    x = matmul_f32(patchify(images, cfg.patch_size),
                   params["patch_w"]).to(images.dtype)
    cls = params["cls_embed"].to(x.dtype)[None, None].expand(
        B, 1, cfg.hidden_size)
    x = torch.cat([cls, x], dim=1)               # [B, N+1, D]
    if "pos_embed" in params:
        x = x + params["pos_embed"].to(x.dtype)[None]
    x = layer_norm(x, params["pre_ln_s"], params["pre_ln_b"],
                   cfg.layer_norm_eps)
    freqs = _rope2d_freqs(cfg, params["class_pos_emb"]) if cfg.rope2d \
        else None

    H, Dh = cfg.num_heads, cfg.head_dim
    N1 = cfg.num_patches + 1
    act = _act(cfg.hidden_act)
    p = params["layers"]

    def block(x, i):
        h = layer_norm(x, p["ln1_s"][i], p["ln1_b"][i], cfg.layer_norm_eps)
        q, k, v = ((torch.matmul(h, p[n + "_w"][i]) + p[n + "_b"][i])
                   .reshape(B, N1, H, Dh) for n in ("q", "k", "v"))
        if freqs is not None:
            q, k = _apply_rope2d(q, freqs), _apply_rope2d(k, freqs)
        attn = mha_attention(q, k, v, impl=attn_impl)
        x = x + torch.matmul(attn.reshape(B, N1, H * Dh), p["o_w"][i]) \
            + p["o_b"][i]
        h = layer_norm(x, p["ln2_s"][i], p["ln2_b"][i], cfg.layer_norm_eps)
        h = act(torch.matmul(h, p["fc1_w"][i]) + p["fc1_b"][i])
        return x + torch.matmul(h, p["fc2_w"][i]) + p["fc2_b"][i]

    # select_layer=-2 is the hidden state entering the last block (HF
    # hidden_states[-2]): only the blocks that feed it run
    n_run = cfg.num_layers + cfg.select_layer + 1
    if not 0 < n_run <= cfg.num_layers:
        raise ValueError(f"select_layer {cfg.select_layer} outside a "
                         f"{cfg.num_layers}-layer tower")
    for i in range(n_run):
        x = checkpoint(block, x, i, use_reentrant=False) if remat \
            else block(x, i)
    return x[:, 1:] if cfg.select_feature == "patch" else x


# ---------------------------------------------------------------------------
# EVA-CLIP towers (reference: multimodal_encoder/eva_clip/eva_vit.py,
# EVAVisionTransformer + EVAEncoderWrapper). The wrapper runs
# forward_features(return_all_features=True): the LAST block is skipped
# (eva_vit.py:692-693), no final norm is applied and the cls token is
# dropped (:846). EVA01: fused qkv with q/v bias, plain gelu MLP. EVA02:
# subln (split q/k/v, inner attention LN, ffn LN), SwiGLU, interleaved 2D
# rope with interpolated frequencies. The EVA-CLIP-8B/18B configs pass
# `use_rms_norm`, which the reference's own CLIPVisionCfg rejects
# (eva_vit.py:767-793), so they are refused here as there.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EvaVisionConfig:
    hidden_size: int = 1024
    intermediate_size: int = 2730     # int(width * mlp_ratio)
    num_layers: int = 24              # reference depth; the last block is
    # built but skipped at inference (eva_vit.py:692-693)
    num_heads: int = 16
    image_size: int = 336
    patch_size: int = 14
    layer_norm_eps: float = 1e-6
    qkv_bias: bool = True             # q/v bias, k zero (eva_vit.py:261)
    subln: bool = False               # split q/k/v + inner_attn_ln +
    # ffn_ln (sub-LayerNorm, EVA02)
    swiglu: bool = False              # naive SwiGLU MLP (EVA02)
    rope2d: bool = False              # interleaved 2D rotary (EVA02)
    pt_hw_seq_len: int = 16           # rope pretrain grid
    intp_freq: bool = False           # interpolate rope to the ft grid
    postnorm: bool = False
    layer_scale: bool = False         # ls_init_value (gamma_1/2)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid * self.grid

    @property
    def feature_dim(self) -> int:
        return self.hidden_size


def eva_init(cfg: EvaVisionConfig,
             generator: Optional[torch.Generator] = None, device="cuda",
             dtype=torch.bfloat16) -> Params:
    """Random EVA-tower weights on `device` (the skipped last block holds
    none)."""
    device = resolve_device(device)
    dense, zeros, ones = leaf_makers(generator, device, dtype)
    L = cfg.num_layers - 1
    D, Fi, P = cfg.hidden_size, cfg.intermediate_size, cfg.patch_size
    out = {
        # EVA's PatchEmbed conv carries a bias (eva_vit.py:446-460)
        "patch_w": dense((P * P * 3, D), P * P * 3),
        "patch_b": zeros((D,)),
        "cls_embed": dense((D,), D),
        "pos_embed": dense((cfg.num_patches + 1, D), D),
    }
    layers = {
        "ln1_s": ones((L, D)), "ln1_b": zeros((L, D)),
        "q_w": dense((L, D, D), D), "k_w": dense((L, D, D), D),
        "v_w": dense((L, D, D), D),
        "q_b": zeros((L, D)), "v_b": zeros((L, D)),
        "o_w": dense((L, D, D), D), "o_b": zeros((L, D)),
        "ln2_s": ones((L, D)), "ln2_b": zeros((L, D)),
    }
    if cfg.subln:
        layers.update(attn_ln_s=ones((L, D)), attn_ln_b=zeros((L, D)))
    if cfg.swiglu:
        layers.update(w1_w=dense((L, D, Fi), D), w1_b=zeros((L, Fi)),
                      w2_w=dense((L, D, Fi), D), w2_b=zeros((L, Fi)),
                      w3_w=dense((L, Fi, D), Fi), w3_b=zeros((L, D)))
    else:
        layers.update(fc1_w=dense((L, D, Fi), D), fc1_b=zeros((L, Fi)),
                      fc2_w=dense((L, Fi, D), Fi), fc2_b=zeros((L, D)))
    if cfg.subln:
        layers.update(ffn_ln_s=ones((L, Fi)), ffn_ln_b=zeros((L, Fi)))
    if cfg.layer_scale:
        layers.update(gamma_1=ones((L, D)), gamma_2=ones((L, D)))
    out["layers"] = layers
    return out


def _eva_rope_freqs(cfg: EvaVisionConfig, device) -> torch.Tensor:
    """Interleaved 2D rotary phases [N, head_dim] of the patch tokens
    (VisionRotaryEmbeddingFast, eva_vit.py:37-67): a head_dim/4
    inverse-frequency bank, each frequency on an adjacent pair, row phases
    in the first head_dim/2 lanes and column phases in the second;
    intp_freq rescales positions onto the pretrain grid."""
    dim = cfg.head_dim // 2
    g = cfg.grid
    inv = 1.0 / (10000.0 ** (torch.arange(
        0, dim, 2, dtype=torch.float32, device=device) / dim))
    t = torch.arange(g, dtype=torch.float32, device=device)
    if cfg.intp_freq:
        t = t / g * cfg.pt_hw_seq_len
    f1 = (t[:, None] * inv[None]).repeat_interleave(2, dim=-1)  # [g, dim]
    rows = f1.repeat_interleave(g, dim=0)          # row-major grid
    cols = f1.repeat(g, 1)
    return torch.cat([rows, cols], dim=-1)         # [N, head_dim]


def _rotate_pairs(x: torch.Tensor) -> torch.Tensor:
    """EVA rotate_half: adjacent pairs (x1, x2) -> (-x2, x1)
    (eva_vit.py:30-35)."""
    return torch.stack([-x[..., 1::2], x[..., 0::2]], dim=-1) \
        .reshape(x.shape)


def _apply_eva_rope(x: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """x [B, N, H, Dh] patch tokens (no cls); freqs [N, Dh]; in f32."""
    xf = x.float()
    cos = torch.cos(freqs)[None, :, None, :]
    sin = torch.sin(freqs)[None, :, None, :]
    return (xf * cos + _rotate_pairs(xf) * sin).to(x.dtype)


def eva_forward(params: Params, cfg: EvaVisionConfig, images: torch.Tensor,
                attn_impl: str = "auto",
                remat: bool = False) -> torch.Tensor:
    """images [B, H, W, 3] -> [B, N, D] patch features (cls dropped, no
    final norm: EVAEncoderWrapper, eva_vit.py:839-846)."""
    B = images.shape[0]
    x = matmul_f32(patchify(images, cfg.patch_size),
                   params["patch_w"]).to(images.dtype) \
        + params["patch_b"].to(images.dtype)
    cls = params["cls_embed"].to(x.dtype)[None, None].expand(
        B, 1, cfg.hidden_size)
    x = torch.cat([cls, x], dim=1) + params["pos_embed"].to(x.dtype)[None]

    freqs = _eva_rope_freqs(cfg, x.device) if cfg.rope2d else None
    H, Dh = cfg.num_heads, cfg.head_dim
    N1 = cfg.num_patches + 1
    eps = cfg.layer_norm_eps
    p = params["layers"]

    def attn_fn(h, i):
        q = (torch.matmul(h, p["q_w"][i]) + p["q_b"][i]).reshape(
            B, N1, H, Dh)
        k = torch.matmul(h, p["k_w"][i]).reshape(B, N1, H, Dh)  # no bias
        v = (torch.matmul(h, p["v_w"][i]) + p["v_b"][i]).reshape(
            B, N1, H, Dh)
        if freqs is not None:             # rope skips the cls token
            q = torch.cat([q[:, :1], _apply_eva_rope(q[:, 1:], freqs)], 1)
            k = torch.cat([k[:, :1], _apply_eva_rope(k[:, 1:], freqs)], 1)
        a = mha_attention(q, k, v, impl=attn_impl).reshape(B, N1, H * Dh)
        if cfg.subln:
            a = layer_norm(a, p["attn_ln_s"][i], p["attn_ln_b"][i], eps)
        return torch.matmul(a, p["o_w"][i]) + p["o_b"][i]

    def mlp_fn(h, i):
        if cfg.swiglu:
            x1 = torch.matmul(h, p["w1_w"][i]) + p["w1_b"][i]
            x2 = torch.matmul(h, p["w2_w"][i]) + p["w2_b"][i]
            hid = F.silu(x1.float()).to(h.dtype) * x2
            if cfg.subln:
                hid = layer_norm(hid, p["ffn_ln_s"][i], p["ffn_ln_b"][i],
                                 eps)
            return torch.matmul(hid, p["w3_w"][i]) + p["w3_b"][i]
        hid = F.gelu((torch.matmul(h, p["fc1_w"][i]) + p["fc1_b"][i])
                     .float(), approximate="none").to(h.dtype)
        if cfg.subln:
            hid = layer_norm(hid, p["ffn_ln_s"][i], p["ffn_ln_b"][i], eps)
        return torch.matmul(hid, p["fc2_w"][i]) + p["fc2_b"][i]

    def block(x, i):
        g1 = p["gamma_1"][i] if cfg.layer_scale else None
        g2 = p["gamma_2"][i] if cfg.layer_scale else None
        if cfg.postnorm:
            a = layer_norm(attn_fn(x, i), p["ln1_s"][i], p["ln1_b"][i], eps)
            x = x + (a * g1 if g1 is not None else a)
            m = layer_norm(mlp_fn(x, i), p["ln2_s"][i], p["ln2_b"][i], eps)
            return x + (m * g2 if g2 is not None else m)
        a = attn_fn(layer_norm(x, p["ln1_s"][i], p["ln1_b"][i], eps), i)
        x = x + (a * g1 if g1 is not None else a)
        m = mlp_fn(layer_norm(x, p["ln2_s"][i], p["ln2_b"][i], eps), i)
        return x + (m * g2 if g2 is not None else m)

    for i in range(cfg.num_layers - 1):
        x = checkpoint(block, x, i, use_reentrant=False) if remat \
            else block(x, i)
    return x[:, 1:]                       # drop cls; no final norm


# ---------------------------------------------------------------------------
# HF / EVA weight conversion
# ---------------------------------------------------------------------------

def _reader(state_dict):
    def t(name):
        a = state_dict[name]
        a = a if isinstance(a, torch.Tensor) else torch.as_tensor(a)
        return a.detach().float()
    return t


def _stacked(stack: dict, dtype, device) -> dict:
    return {k: torch.stack(v).to(device=device, dtype=dtype)
            for k, v in stack.items()}


def convert_eva_tower(state_dict, cfg: EvaVisionConfig,
                      dtype=torch.float32, device="cpu") -> Params:
    """An EVA-CLIP visual state dict (visual.* keys stripped, the
    reference's load_clip_visual_state_dict convention; torch tensors or
    numpy arrays) in the port's stacked layout on `device`. Only the first
    num_layers - 1 blocks are mapped: the last is skipped at inference."""
    t = _reader(state_dict)
    D = cfg.hidden_size
    conv = t("patch_embed.proj.weight")          # [D, 3, P, P]
    out = {
        "patch_w": conv.reshape(D, -1).t(),
        "patch_b": t("patch_embed.proj.bias"),
        "cls_embed": t("cls_token").reshape(-1),
        "pos_embed": t("pos_embed")[0],
    }
    out = {k: v.to(device=device, dtype=dtype) for k, v in out.items()}
    stack: dict = {}

    def put(k, v):
        stack.setdefault(k, []).append(v)

    for i in range(cfg.num_layers - 1):
        b = f"blocks.{i}."
        put("ln1_s", t(b + "norm1.weight"))
        put("ln1_b", t(b + "norm1.bias"))
        if cfg.subln:
            put("q_w", t(b + "attn.q_proj.weight").t())
            put("k_w", t(b + "attn.k_proj.weight").t())
            put("v_w", t(b + "attn.v_proj.weight").t())
            put("attn_ln_s", t(b + "attn.inner_attn_ln.weight"))
            put("attn_ln_b", t(b + "attn.inner_attn_ln.bias"))
        else:
            qkv = t(b + "attn.qkv.weight")       # [3D, D]
            put("q_w", qkv[:D].t())
            put("k_w", qkv[D:2 * D].t())
            put("v_w", qkv[2 * D:].t())
        put("q_b", t(b + "attn.q_bias"))
        put("v_b", t(b + "attn.v_bias"))
        put("o_w", t(b + "attn.proj.weight").t())
        put("o_b", t(b + "attn.proj.bias"))
        put("ln2_s", t(b + "norm2.weight"))
        put("ln2_b", t(b + "norm2.bias"))
        names = (("w1", "w1"), ("w2", "w2"), ("w3", "w3")) if cfg.swiglu \
            else (("fc1", "fc1"), ("fc2", "fc2"))
        for ours, theirs in names:
            put(ours + "_w", t(b + f"mlp.{theirs}.weight").t())
            put(ours + "_b", t(b + f"mlp.{theirs}.bias"))
        if cfg.subln:
            put("ffn_ln_s", t(b + "mlp.ffn_ln.weight"))
            put("ffn_ln_b", t(b + "mlp.ffn_ln.bias"))
        if cfg.layer_scale:
            put("gamma_1", t(b + "gamma_1"))
            put("gamma_2", t(b + "gamma_2"))
    out["layers"] = _stacked(stack, dtype, device)
    return out


def convert_hf_clip_tower(state_dict, cfg: ClipVisionConfig,
                          dtype=torch.float32, device="cpu") -> Params:
    """A transformers CLIPVisionModel state dict (torch tensors or numpy
    arrays) in the port's layout on `device`. The conv weight [D, 3, P, P]
    flattens to the channel-major [3*P*P, D] of siglip.patchify."""
    t = _reader(state_dict)
    pre = "vision_model."
    D = cfg.hidden_size
    conv = t(pre + "embeddings.patch_embedding.weight")  # [D, 3, P, P]
    names = (("ln1", "layer_norm1", None), ("q", "self_attn.q_proj", "w"),
             ("k", "self_attn.k_proj", "w"), ("v", "self_attn.v_proj", "w"),
             ("o", "self_attn.out_proj", "w"), ("ln2", "layer_norm2", None),
             ("fc1", "mlp.fc1", "w"), ("fc2", "mlp.fc2", "w"))
    stack: dict = {}
    for i in range(cfg.num_layers):
        lp = f"{pre}encoder.layers.{i}."
        for ours, theirs, kind in names:
            w = t(lp + theirs + ".weight")
            if kind is None:       # a LayerNorm's scale and bias
                stack.setdefault(ours + "_s", []).append(w)
            else:
                stack.setdefault(ours + "_w", []).append(w.t())
            stack.setdefault(ours + "_b", []).append(t(lp + theirs + ".bias"))
    params = {
        "patch_w": conv.reshape(D, -1).t(),
        "cls_embed": t(pre + "embeddings.class_embedding"),
        "pre_ln_s": t(pre + "pre_layrnorm.weight"),
        "pre_ln_b": t(pre + "pre_layrnorm.bias"),
    }
    if cfg.rope2d:
        # MLCD towers carry a learned class-token rotary phase instead of
        # learned position embeddings (vit_rope2d_hf.py:287, 324)
        key = next((k for k in state_dict if k.endswith("class_pos_emb")),
                   None)
        if key is None:
            raise KeyError("rope2d tower state dict has no class_pos_emb")
        params["class_pos_emb"] = t(key).reshape(-1)
    else:
        params["pos_embed"] = t(pre + "embeddings.position_embedding.weight")
    params = {k: v.to(device=device, dtype=dtype) for k, v in params.items()}
    params["layers"] = _stacked(stack, dtype, device)
    return params


# ---------------------------------------------------------------------------
# S2 multi-scale wrapper (reference: CLIPVisionTowerS2 / MLCDVisionTowerS2
# through the s2wrapper package: split each scale into base-size crops,
# forward, merge the grids, pool to the base grid, concatenate channels)
# ---------------------------------------------------------------------------

def s2_forward(forward_fn, images: torch.Tensor, base_size: int,
               scales: Sequence[int]) -> torch.Tensor:
    """images [B, base, base, 3] -> [B, N_base, D * len(scales)].

    For each scale s = k * base: resize the image to s bilinearly
    (half-pixel centres, no antialias: the reference's jax.image.resize
    "bilinear" when upscaling, edge samples clamped as its renormalised
    edge weights give), split it into k^2 base-size crops, run the tower
    on all crops in one batch, reassemble the k*g x k*g feature grid,
    average-pool it back to g x g, and concatenate the scales' features
    channel-wise."""
    B = images.shape[0]
    outs = []
    for s in scales:
        k = s // base_size
        if k * base_size != s:
            raise ValueError(f"S2 scale {s} is not a multiple of the base "
                             f"size {base_size}")
        if k == 1:
            outs.append(forward_fn(images))      # [B, g*g, D]
            continue
        big = F.interpolate(images.permute(0, 3, 1, 2).float(),
                            size=(s, s), mode="bilinear",
                            align_corners=False, antialias=False)
        big = big.permute(0, 2, 3, 1).to(images.dtype)
        crops = big.reshape(B, k, base_size, k, base_size, -1).permute(
            0, 1, 3, 2, 4, 5).reshape(B * k * k, base_size, base_size, -1)
        feats = forward_fn(crops.contiguous())   # [B*k*k, g*g, D]
        g = math.isqrt(feats.shape[1])
        D = feats.shape[-1]
        grid = feats.reshape(B, k, k, g, g, D).permute(
            0, 1, 3, 2, 4, 5).reshape(B, k * g, k * g, D)
        pooled = grid.reshape(B, g, k, g, k, D).mean(dim=(2, 4))
        outs.append(pooled.reshape(B, g * g, D))
    return torch.cat(outs, dim=-1)


# ---------------------------------------------------------------------------
# Builder (reference: multimodal_encoder/builder.py:13-42)
# ---------------------------------------------------------------------------

_PRESETS = {
    "openai/clip-vit-large-patch14": ClipVisionConfig(image_size=224),
    "openai/clip-vit-large-patch14-336": ClipVisionConfig(image_size=336),
    "laion/CLIP-ViT-bigG-14-laion2B-39B-b160k": ClipVisionConfig(
        hidden_size=1664, intermediate_size=8192, num_layers=48,
        num_heads=16, image_size=224, hidden_act="gelu"),
    "open_clip_hub:ViT-L-14": ClipVisionConfig(image_size=224,
                                               hidden_act="gelu"),
    "DeepGlint-AI/mlcd-vit-bigG-patch14-336": ClipVisionConfig(
        hidden_size=1664, intermediate_size=8192, num_layers=48,
        num_heads=16, image_size=336, hidden_act="gelu", rope2d=True),
}

# the EVA model_configs the reference can construct
# (eva_clip/model_configs/*.json; intermediate = int(width * mlp_ratio),
# heads = width // head_width)
_EVA_PRESETS = {
    "EVA01-CLIP-g-14": EvaVisionConfig(
        hidden_size=1408, intermediate_size=6144, num_layers=40,
        num_heads=16, image_size=224, patch_size=14),
    "EVA01-CLIP-g-14-plus": EvaVisionConfig(
        hidden_size=1408, intermediate_size=6144, num_layers=40,
        num_heads=16, image_size=224, patch_size=14),
    "EVA02-CLIP-B-16": EvaVisionConfig(
        hidden_size=768, intermediate_size=2048, num_layers=12,
        num_heads=12, image_size=224, patch_size=16, subln=True,
        swiglu=True, rope2d=True, intp_freq=True, pt_hw_seq_len=16),
    "EVA02-CLIP-L-14": EvaVisionConfig(
        hidden_size=1024, intermediate_size=2730, num_layers=24,
        num_heads=16, image_size=224, patch_size=14, subln=True,
        swiglu=True, rope2d=True, intp_freq=True, pt_hw_seq_len=16),
    "EVA02-CLIP-L-14-336": EvaVisionConfig(
        hidden_size=1024, intermediate_size=2730, num_layers=24,
        num_heads=16, image_size=336, patch_size=14, subln=True,
        swiglu=True, rope2d=True, intp_freq=True, pt_hw_seq_len=16),
}


def build_vision_tower(name: str, *, s2: bool = False,
                       s2_scales: Sequence[int] = (336, 672, 1008),
                       **overrides):
    """Name-dispatch tower builder (builder.py:13-42 semantics).

    Returns (cfg, init_fn, forward_fn): init_fn(cfg, generator=None,
    device=..., dtype=...) makes random weights, forward_fn(params,
    images, **kw) yields [B, N, feature_dim] (feature_dim times
    len(s2_scales) under s2). SigLIP names give the models/siglip.py
    tower."""
    if "siglip" in name:
        from streamvln_tpu_torch.configs import SigLIPConfig
        from streamvln_tpu_torch.models import siglip
        cfg = SigLIPConfig(**overrides) if overrides else SigLIPConfig()
        return cfg, siglip_init, \
            lambda p, imgs, **kw: siglip.forward(p, cfg, imgs, **kw)
    if name in ("imagebind_huge",):
        raise ValueError(
            "imagebind towers need the external imagebind package "
            "(reference builder.py:28 has the same external "
            "dependency); use a CLIP/SigLIP tower instead")
    if "eva" in name.lower():
        base = name.split("/")[-1]
        ecfg = _EVA_PRESETS.get(base)
        if ecfg is None and base.startswith(("EVA-CLIP-8B",
                                             "EVA-CLIP-18B")):
            raise ValueError(
                f"{base}: this config passes use_rms_norm, which the "
                "reference's own CLIPVisionCfg rejects "
                "(eva_vit.py:767-793) — not constructible there either")
        if ecfg is None:
            raise ValueError(f"Unknown EVA tower: {name}")
        if overrides:
            ecfg = dataclasses.replace(ecfg, **overrides)
        return ecfg, eva_init, \
            lambda p, imgs, **kw: eva_forward(p, ecfg, imgs, **kw)
    cfg = None
    if name in _PRESETS:
        cfg = _PRESETS[name]
    elif name.startswith(("openai", "laion")) or "ShareGPT4V" in name:
        cfg = ClipVisionConfig()
    elif name.startswith("open_clip_hub"):
        cfg = ClipVisionConfig(hidden_act="gelu")
    elif "mlcd-vit-bigG-patch14" in name:
        cfg = _PRESETS["DeepGlint-AI/mlcd-vit-bigG-patch14-336"]
    elif name.startswith("hf:"):
        # a generic HF tower: CLIP architecture, the overrides give dims
        cfg = ClipVisionConfig()
    if cfg is None:
        raise ValueError(f"Unknown vision tower: {name}")
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    if not s2:
        return cfg, init, lambda p, imgs, **kw: forward(p, cfg, imgs, **kw)

    def fwd_s2(p, imgs, **kw):
        return s2_forward(lambda im: forward(p, cfg, im, **kw), imgs,
                          cfg.image_size, s2_scales)
    return cfg, init, fwd_s2
