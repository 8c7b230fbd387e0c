"""The plain reference of the StreamVLN stack, in f32 PyTorch with TF32
off: frame preprocessing, the SigLIP tower, the mlp2x_gelu projector, the
2x2 bilinear pool, and the Qwen2 decoder over whole dialogues.

It follows the published models (SigLIP-so400m-patch14-384 with its last
encoder layer and head dropped, as LLaVA-Video reads the penultimate
layer; LLaVA's mlp2x_gelu; LLaVA-Video's bilinear 2D pool; Qwen2 with
RMSNorm, half-rotation RoPE, grouped-query attention with q/k/v biases
and a SwiGLU MLP). No cache, no batching across dialogues, no kernels:
every dialogue is one causal pass from its first position, and weight
stacks are cast to f32 one layer at a time, so it fits beside nothing
else on the card. Departures: none known.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from portbench.reference.quant import TARGETS, fake_quant


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def preprocess(frames_u8: torch.Tensor, size: int) -> torch.Tensor:
    """[N, H, W, 3] uint8 -> [N, size, size, 3] f32: the SigLIP processor's
    antialiased bicubic resize (Keys a = -0.5, as PIL's BICUBIC), clipped
    to the byte range, rescaled by 1/255 and normalised by mean = std =
    0.5."""
    x = frames_u8.float().permute(0, 3, 1, 2)
    if tuple(x.shape[2:]) != (size, size):
        x = F.interpolate(x, size=(size, size), mode="bicubic",
                          align_corners=False, antialias=True)
        x = x.clamp(0.0, 255.0)
    x = x.permute(0, 2, 3, 1) / 255.0
    return (x - 0.5) / 0.5


def _f(t: torch.Tensor) -> torch.Tensor:
    return t.float()


def layer_norm(x, s, b, eps):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * _f(s) + _f(b)


def siglip(vp: dict, vc: dict, pixels: torch.Tensor) -> torch.Tensor:
    """[N, S, S, 3] pixels -> [N, patches, hidden]: Conv2d patch embedding
    (stride = patch), learned positions, pre-LN blocks with exact softmax
    attention and a tanh-GELU MLP, no post-LayerNorm."""
    P, D, H = vc["patch_size"], vc["hidden_size"], vc["num_heads"]
    eps = vc["layer_norm_eps"]
    N = pixels.shape[0]
    # patch_w's rows are the Conv2d weight's (channel, row, column) order
    weight = _f(vp["patch_w"]).t().reshape(D, 3, P, P)
    x = F.conv2d(pixels.permute(0, 3, 1, 2), weight, _f(vp["patch_b"]),
                 stride=P)
    x = x.flatten(2).transpose(1, 2) + _f(vp["pos_embed"])[None]
    p = vp["layers"]
    Dh = D // H
    for i in range(vc["num_layers"]):
        h = layer_norm(x, p["ln1_s"][i], p["ln1_b"][i], eps)
        q, k, v = (
            (h @ _f(p[f"{n}_w"][i]) + _f(p[f"{n}_b"][i]))
            .reshape(N, -1, H, Dh).transpose(1, 2) for n in "qkv")
        a = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(Dh), dim=-1)
        o = (a @ v).transpose(1, 2).reshape(N, -1, D)
        x = x + o @ _f(p["o_w"][i]) + _f(p["o_b"][i])
        h = layer_norm(x, p["ln2_s"][i], p["ln2_b"][i], eps)
        h = F.gelu(h @ _f(p["fc1_w"][i]) + _f(p["fc1_b"][i]),
                   approximate="tanh")
        x = x + h @ _f(p["fc2_w"][i]) + _f(p["fc2_b"][i])
    return x


def project_pool(proj: dict, feats: torch.Tensor, side: int,
                 stride: int) -> torch.Tensor:
    """mlp2x_gelu (Linear, exact GELU, Linear), then the bilinear resize of
    the side x side grid to ceil(side / stride) a side (half-pixel
    centres, no antialias) -> [N, tokens_per_frame, llm_hidden]."""
    l0, l1 = proj["layers"]
    x = F.gelu(feats @ _f(l0["w"]) + _f(l0["b"]))
    x = x @ _f(l1["w"]) + _f(l1["b"])
    N, _, D = x.shape
    out = -(-side // stride)
    grid = x.reshape(N, side, side, D).permute(0, 3, 1, 2)
    pooled = F.interpolate(grid, size=(out, out), mode="bilinear",
                           align_corners=False)
    return pooled.permute(0, 2, 3, 1).reshape(N, out * out, D)


def encode_frames(params: dict, cfg: dict, frames_u8: torch.Tensor,
                  block: int = 8) -> torch.Tensor:
    """[N, H, W, 3] uint8 frames -> [N, tokens_per_frame, llm_hidden] f32,
    `block` frames at a time."""
    vc = cfg["vision"]
    side = vc["image_size"] // vc["patch_size"]
    outs = []
    for i in range(0, frames_u8.shape[0], block):
        pix = preprocess(frames_u8[i:i + block], vc["image_size"])
        outs.append(project_pool(params["projector"],
                                 siglip(params["vision"], vc, pix),
                                 side, cfg["spatial_pool_stride"]))
    return torch.cat(outs)


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * _f(w)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-rotation RoPE over positions 0..T-1; x [H, T, Dh]."""
    Dh, T = x.shape[-1], x.shape[-2]
    inv = 1.0 / theta ** (torch.arange(0, Dh, 2, device=x.device,
                                       dtype=torch.float32) / Dh)
    ang = torch.arange(T, device=x.device, dtype=torch.float32)[:, None] \
        * inv[None]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :Dh // 2], x[..., Dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v, block: int = 1024) -> torch.Tensor:
    """q [Hq, T, Dh], k/v [Hkv, T, Dh] -> [T, Hq * Dh]; each query attends
    to keys at its position and before; query rows in blocks."""
    Hq, T, Dh = q.shape
    G = Hq // k.shape[0]
    k = k.repeat_interleave(G, dim=0)
    v = v.repeat_interleave(G, dim=0)
    out = torch.empty((Hq, T, Dh), device=q.device, dtype=torch.float32)
    kpos = torch.arange(T, device=q.device)
    for s in range(0, T, block):
        e = min(T, s + block)
        sc = q[:, s:e] @ k[:, :e].transpose(-1, -2) / math.sqrt(Dh)
        mask = kpos[None, :e] > torch.arange(s, e, device=q.device)[:, None]
        sc = sc.masked_fill(mask[None], float("-inf"))
        out[:, s:e] = torch.softmax(sc, dim=-1) @ v[:, :e]
    return out.transpose(0, 1).reshape(T, Hq * Dh)


def weight_view(bits: Optional[int], group: Optional[int]) -> Callable:
    """How a decoder weight reads: as drawn (f32 of the stored values), or
    through `fake_quant` at `bits` when the name is a quantized target."""
    def view(name: str, w: torch.Tensor) -> torch.Tensor:
        if bits is None or name not in TARGETS + ("lm_head",):
            return w.float()
        return fake_quant(w, bits, group if bits < 8 else None)
    return view


def decoder_logits(llm: dict, lc: dict, embeds: Sequence[torch.Tensor],
                   positions: Sequence[torch.Tensor],
                   views: Sequence[Callable]) -> List[List[torch.Tensor]]:
    """Qwen2 over each dialogue's f32 embeddings [T, D] from position 0
    (one causal pass each). Layers run one at a time over all dialogues,
    every weight read once per layer for each view in `views` (several
    views: the same dialogues through differently quantized weights, e.g.
    a judge and a control). Returns logits [len(positions[i]), V] f32 at
    the requested positions, per view and dialogue."""
    L, Hq, Hkv, Dh = (lc["num_layers"], lc["num_heads"], lc["num_kv_heads"],
                      lc["head_dim"])
    eps, theta = lc["rms_norm_eps"], lc["rope_theta"]
    p = llm["layers"]
    xs = [[e.clone() for e in embeds] for _ in views]
    for i in range(L):
        for vi, view in enumerate(views):
            w = {n: view(n, p[n][i]) for n in TARGETS}
            for d, x in enumerate(xs[vi]):
                T = x.shape[0]
                h = rms_norm(x, p["ln1"][i], eps)
                q = (h @ w["q_w"] + _f(p["q_b"][i])).reshape(T, Hq, Dh)
                k = (h @ w["k_w"] + _f(p["k_b"][i])).reshape(T, Hkv, Dh)
                v = (h @ w["v_w"] + _f(p["v_b"][i])).reshape(T, Hkv, Dh)
                q = rope(q.transpose(0, 1), theta)
                k = rope(k.transpose(0, 1), theta)
                a = causal_attention(q, k, v.transpose(0, 1))
                x = x + a @ w["o_w"]
                h = rms_norm(x, p["ln2"][i], eps)
                x = x + (F.silu(h @ w["gate_w"]) * (h @ w["up_w"])) \
                    @ w["down_w"]
                xs[vi][d] = x
            del w
    out = []
    for vi, view in enumerate(views):
        head = view("lm_head", llm["lm_head"])
        out.append([rms_norm(x[pos], llm["final_norm"], eps) @ head
                    for x, pos in zip(xs[vi], positions)])
        del head
    return out


def dialogue_embeds(llm: dict, segs, feats: Dict[int, torch.Tensor],
                    device) -> torch.Tensor:
    """The expanded sequence [T, D] f32: text ids through the embedding
    table, each frame's pooled tokens from `feats` (frame index -> [tpf,
    D])."""
    parts = []
    for kind, items in segs:
        if kind == "text":
            ids = torch.tensor(items, dtype=torch.long, device=device)
            parts.append(llm["embed"][ids].float())
        else:
            parts.extend(feats[f] for f in items)
    return torch.cat(parts)
