"""HF checkpoint -> the port's param tree.

Counterpart of `streamvln_tpu/models/convert_hf.py`. It maps the weights
of the reference stack (StreamVLNForCausalLM = HF Qwen2 + the LLaVA
multimodal head + the SigLIP tower) into the tree `weights.init` and
`weights.from_jax_params` make (unfused):

- torch Linear weights [out, in] are transposed to [in, out];
- per-layer weights are stacked on a leading [L] axis;
- SigLIP: only the first `cfg.vision.num_layers` (26) encoder layers are
  read, so the checkpoint's 27th is dropped; the patch conv [D, 3, P, P]
  flattens to [(C, ph, pw), D] (`models/siglip.patchify`'s order);
- lm_head [V, D] -> [D, V]; `image_newline` is zeros when absent.

Checkpoints are read from a directory of `*.safetensors` (one file, or
shards beside a `model.safetensors.index.json`) through the port's own
reader (`utils/safetensors_io.py`, which has bfloat16), else from
`pytorch_model*.bin` through `torch.load(weights_only=True)`. Every
tensor keeps its stored dtype until it is cast to `dtype` once, in place
in its stack on `device`: each layer is uploaded in its stored dtype and
transposed there, so the device never holds a second copy of a stack
(on the H100, 9x faster than transposing the stacks on the host first:
PERF.md §6, PR 10). A missing key raises KeyError; nothing is made up in
its place.
"""
from __future__ import annotations

import glob
import json
import os
import time
from typing import Dict, Optional

import torch

from streamvln_tpu_torch.configs import (Qwen2Config, SigLIPConfig,
                                         StreamVLNConfig, resolve_device)
from streamvln_tpu_torch.models.projector import parse_type
from streamvln_tpu_torch.utils import safetensors_io

State = Dict[str, torch.Tensor]


class _Builder:
    """Makes the tree's leaves from `state` on `device` in `dtype`; with
    `stats`, adds the seconds of uploads ("upload_s") and of transposes
    and casts ("convert_s") and the bytes read ("bytes")."""

    def __init__(self, state: State, device, dtype,
                 stats: Optional[dict] = None):
        self.state, self.dtype = state, dtype
        self.device = resolve_device(device)
        self.stats = stats
        if stats is not None:
            for k in ("upload_s", "convert_s", "bytes"):
                stats.setdefault(k, 0)

    def src(self, name: str) -> torch.Tensor:
        try:
            t = self.state[name]
        except KeyError:
            raise KeyError(f"{name!r} is not in the checkpoint") from None
        if self.stats is not None:
            self.stats["bytes"] += t.numel() * t.element_size()
        return t

    def _timed(self, key: str, fn):
        if self.stats is None:
            return fn()
        t0 = time.perf_counter()
        out = fn()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.stats[key] += time.perf_counter() - t0
        return out

    def stack(self, fmt: str, n: int, transpose: bool = False,
              shape=None, rows: Optional[slice] = None) -> torch.Tensor:
        """[n, ...] from the tensors fmt.format(0..n-1), each cut to `rows`
        (a slice of its first dim), reshaped to `shape`, then transposed
        (2-D) as asked."""
        srcs = [self.src(fmt.format(i)) for i in range(n)]

        def view(t):
            t = t[rows] if rows is not None else t
            t = t.reshape(shape) if shape is not None else t
            return t.T if transpose else t
        out = torch.empty((n, *view(srcs[0]).shape), dtype=self.dtype,
                          device=self.device)
        for i, s in enumerate(srcs):
            up = self._timed("upload_s", lambda: s.to(self.device))
            self._timed("convert_s", lambda: out[i].copy_(view(up)))
        return out

    def one(self, name: str, transpose: bool = False,
            shape=None) -> torch.Tensor:
        return self.stack(name, 1, transpose, shape)[0]

    def experts(self, fmt: str, layers: int, n: int) -> torch.Tensor:
        """[layers, n, in, out] from the Linear weights fmt.format(layer,
        expert), each transposed, built in place layer by layer."""
        return torch.stack([self.stack(fmt.format(i, "{}"), n, True)
                            for i in range(layers)])


def _qwen2(b: _Builder, cfg: Qwen2Config, prefix: str,
           include_mlp: bool = True) -> dict:
    L, p = cfg.num_layers, prefix + "layers.{}."
    layers = {
        "ln1": b.stack(p + "input_layernorm.weight", L),
        "q_w": b.stack(p + "self_attn.q_proj.weight", L, True),
        "k_w": b.stack(p + "self_attn.k_proj.weight", L, True),
        "v_w": b.stack(p + "self_attn.v_proj.weight", L, True),
        "o_w": b.stack(p + "self_attn.o_proj.weight", L, True),
        "ln2": b.stack(p + "post_attention_layernorm.weight", L),
    }
    if include_mlp:
        for n in ("gate", "up", "down"):
            layers[f"{n}_w"] = b.stack(p + f"mlp.{n}_proj.weight", L, True)
    if cfg.qkv_bias:
        for n in ("q", "k", "v"):
            layers[f"{n}_b"] = b.stack(p + f"self_attn.{n}_proj.bias", L)
    params = {"embed": b.one(prefix + "embed_tokens.weight"),
              "layers": layers,
              "final_norm": b.one(prefix + "norm.weight")}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = b.one("lm_head.weight", transpose=True)
    return params


def _siglip(b: _Builder, cfg: SigLIPConfig, prefix: str) -> dict:
    L, D, P = cfg.num_layers, cfg.hidden_size, cfg.patch_size
    lp = prefix + "encoder.layers.{}."
    names = [("ln1_s", "layer_norm1.weight", False),
             ("ln1_b", "layer_norm1.bias", False),
             ("q_w", "self_attn.q_proj.weight", True),
             ("q_b", "self_attn.q_proj.bias", False),
             ("k_w", "self_attn.k_proj.weight", True),
             ("k_b", "self_attn.k_proj.bias", False),
             ("v_w", "self_attn.v_proj.weight", True),
             ("v_b", "self_attn.v_proj.bias", False),
             ("o_w", "self_attn.out_proj.weight", True),
             ("o_b", "self_attn.out_proj.bias", False),
             ("ln2_s", "layer_norm2.weight", False),
             ("ln2_b", "layer_norm2.bias", False),
             ("fc1_w", "mlp.fc1.weight", True),
             ("fc1_b", "mlp.fc1.bias", False),
             ("fc2_w", "mlp.fc2.weight", True),
             ("fc2_b", "mlp.fc2.bias", False)]
    return {
        # [D, 3, P, P] -> [(C, ph, pw), D]
        "patch_w": b.one(prefix + "embeddings.patch_embedding.weight",
                         transpose=True, shape=(D, 3 * P * P)),
        "patch_b": b.one(prefix + "embeddings.patch_embedding.bias"),
        "pos_embed": b.one(prefix + "embeddings.position_embedding.weight"),
        "layers": {ours: b.stack(lp + theirs, L, t)
                   for ours, theirs, t in names},
    }


def _projector(b: _Builder, projector_type: str, prefix: str) -> dict:
    """mlpNx_gelu: the torch Sequential's Linears sit at 0, 2, 4, ..."""
    return {"layers": [
        {"w": b.one(f"{prefix}{2 * i}.weight", transpose=True),
         "b": b.one(f"{prefix}{2 * i}.bias")}
        for i in range(parse_type(projector_type))]}


def convert_qwen2(state: State, cfg: Qwen2Config, prefix: str = "model.",
                  dtype=torch.bfloat16, include_mlp: bool = True,
                  device="cuda") -> dict:
    """The decoder's tree from a Qwen2 state dict."""
    return _qwen2(_Builder(state, device, dtype), cfg, prefix, include_mlp)


# Llama, Mistral and Gemma name their modules as Qwen2 does (the bias-free
# families have no qkv biases, which `cfg.qkv_bias` skips): one converter
# serves them all, as in the reference.
convert_llm = convert_qwen2


def convert_moe_llm(state: State, cfg: Qwen2Config, prefix: str = "model.",
                    dtype=torch.bfloat16, device="cuda") -> dict:
    """A Mixtral or Qwen2-MoE state dict -> the tree with the router and
    the stacked experts [L, E, in, out]. Mixtral names the block
    `block_sparse_moe` with experts w1/w3/w2; Qwen2-MoE names it `mlp`
    with gate_proj/up_proj/down_proj and adds the shared expert and its
    gate; which one is read off the state dict, as the reference does."""
    b = _Builder(state, device, dtype)
    params = _qwen2(b, cfg, prefix, include_mlp=False)
    L, E = cfg.num_layers, cfg.num_experts
    mixtral = any("block_sparse_moe" in k for k in state)
    blk = f"{prefix}layers.{{}}.{'block_sparse_moe' if mixtral else 'mlp'}."
    names = ("w1", "w3", "w2") if mixtral else \
        ("gate_proj", "up_proj", "down_proj")
    layers = params["layers"]
    layers["router_w"] = b.stack(blk + "gate.weight", L, True)
    for ours, theirs in zip(("e_gate", "e_up", "e_down"), names):
        layers[ours] = b.experts(blk + "experts.{}." + theirs + ".weight",
                                 L, E)
    if cfg.shared_expert_intermediate_size:
        sp = f"{prefix}layers.{{}}.mlp."
        for ours, theirs in (("s_gate_w", "shared_expert.gate_proj"),
                             ("s_up_w", "shared_expert.up_proj"),
                             ("s_down_w", "shared_expert.down_proj"),
                             ("s_route_w", "shared_expert_gate")):
            layers[ours] = b.stack(sp + theirs + ".weight", L, True)
    return params


def convert_mpt(state: State, cfg: Qwen2Config,
                prefix: str = "transformer.", dtype=torch.bfloat16,
                device="cuda") -> dict:
    """An MptForCausalLM state dict -> the tree: the fused Wqkv [3D, D]
    split into q/k/v, weight-only LayerNorms, the ungated up/down MLP, the
    head tied to wte unless the config unties it."""
    b = _Builder(state, device, dtype)
    L, D, p = cfg.num_layers, cfg.hidden_size, prefix + "blocks.{}."
    layers = {
        "ln1": b.stack(p + "norm_1.weight", L),
        "q_w": b.stack(p + "attn.Wqkv.weight", L, True, rows=slice(0, D)),
        "k_w": b.stack(p + "attn.Wqkv.weight", L, True,
                       rows=slice(D, 2 * D)),
        "v_w": b.stack(p + "attn.Wqkv.weight", L, True,
                       rows=slice(2 * D, 3 * D)),
        "o_w": b.stack(p + "attn.out_proj.weight", L, True),
        "ln2": b.stack(p + "norm_2.weight", L),
        "up_w": b.stack(p + "ffn.up_proj.weight", L, True),
        "down_w": b.stack(p + "ffn.down_proj.weight", L, True),
    }
    params = {"embed": b.one(prefix + "wte.weight"), "layers": layers,
              "final_norm": b.one(prefix + "norm_f.weight")}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = b.one("lm_head.weight", transpose=True)
    return params


def convert_siglip(state: State, cfg: SigLIPConfig,
                   prefix: str = "vision_model.", dtype=torch.bfloat16,
                   device="cuda") -> dict:
    """The tower's tree from a SigLIP state dict (first cfg.num_layers
    encoder layers)."""
    return _siglip(_Builder(state, device, dtype), cfg, prefix)


def convert_projector(state: State, projector_type: str,
                      prefix: str = "mm_projector.", dtype=torch.bfloat16,
                      device="cuda") -> dict:
    return _projector(_Builder(state, device, dtype), projector_type,
                      prefix)


def convert_streamvln(state: State, cfg: StreamVLNConfig,
                      dtype=torch.bfloat16, device="cuda",
                      stats: Optional[dict] = None) -> dict:
    """A full StreamVLN checkpoint (the HF save of StreamVLNForCausalLM):
    the LLM under 'model.', the tower under
    'model.vision_tower.vision_tower.vision_model.', the projector under
    'model.mm_projector.'. `stats`: see _Builder."""
    b = _Builder(state, device, dtype, stats)
    out = {
        "llm": _qwen2(b, cfg.llm, "model."),
        "vision": _siglip(b, cfg.vision,
                          "model.vision_tower.vision_tower.vision_model."),
        "projector": _projector(b, cfg.projector_type,
                                "model.mm_projector."),
    }
    # the anyres row separator; checkpoints saved without the spatial_unpad
    # merge lack it, and zeros keep that merge harmless
    if "model.image_newline" in state:
        out["image_newline"] = b.one("model.image_newline")
    else:
        out["image_newline"] = torch.zeros(cfg.llm.hidden_size, dtype=dtype,
                                           device=b.device)
    return out


# ---------------------------------------------------------------------------
# File loading
# ---------------------------------------------------------------------------

def _check_index(path: str, files, kind: str) -> None:
    """Every shard that an index (`*<kind>.index.json`) names must be in
    the directory."""
    have = {os.path.basename(f) for f in files}
    for index in sorted(glob.glob(os.path.join(path,
                                               f"*{kind}.index.json"))):
        with open(index) as f:
            missing = sorted(set(json.load(f)["weight_map"].values())
                             - have)
        if missing:
            raise FileNotFoundError(
                f"{index} names shards that are not in {path}: {missing}")


def load_state_dict(path: str) -> State:
    """Every tensor of an HF checkpoint directory, in its stored dtype:
    the `*.safetensors` files (memory-mapped), else the
    `pytorch_model*.bin` files. Raises FileNotFoundError when there are
    neither, or when an index names a shard that is missing."""
    state: State = {}
    st_files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    if st_files:
        _check_index(path, st_files, ".safetensors")
        for f in st_files:
            state.update(safetensors_io.load_file(f))
        return state
    bin_files = sorted(glob.glob(os.path.join(path, "pytorch_model*.bin")))
    if bin_files:
        _check_index(path, bin_files, ".bin")
        for f in bin_files:
            state.update(torch.load(f, map_location="cpu",
                                    weights_only=True, mmap=True))
        return state
    raise FileNotFoundError(f"no checkpoint shards in {path}")


def load_streamvln_checkpoint(path: str, cfg: StreamVLNConfig,
                              dtype=torch.bfloat16, device="cuda",
                              stats: Optional[dict] = None) -> dict:
    """The unfused tree of the checkpoint in `path` on `device`, cast to
    `dtype`. With `stats`, adds "read_s" (headers parsed and files
    mapped) to convert_streamvln's upload and convert seconds."""
    t0 = time.perf_counter()
    state = load_state_dict(path)
    if stats is not None:
        stats["read_s"] = stats.get("read_s", 0) + time.perf_counter() - t0
    return convert_streamvln(state, cfg, dtype, device, stats)
