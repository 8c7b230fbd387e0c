"""Parameters of the port: carried across from the JAX package's pytree,
or made at random on the device; and a JAX training state carried across.
The encoder zoo's towers and the resamplers are carried across too
(`from_jax_tower`, `from_jax_resampler`).

Both give the reference's dict layout: {"vision", "projector", "llm",
"image_newline"}, with per-layer weights stacked [L, ...] and matrices
stored [in, out].
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from streamvln_tpu_torch.configs import (SigLIPConfig, StreamVLNConfig,
                                         resolve_device)
from streamvln_tpu_torch.models.lora import is_lora_path
from streamvln_tpu_torch.models.projector import parse_type

_FUSED = {"qkv_w": ("q_w", "k_w", "v_w"), "gu_w": ("gate_w", "up_w")}


def from_jax_params(tree, cfg: StreamVLNConfig, device="cuda",
                    dtype: Optional[torch.dtype] = None, mesh=None) -> dict:
    """Convert the pytree of `streamvln_tpu.models.streamvln.init` (leaves
    as numpy arrays, e.g. after `jax.tree.map(np.asarray, params)`) into
    torch tensors on `device`, float leaves cast to `dtype` when given.
    The stacked layer weights are taken as they are, fused projections
    (`qkv_w`, `gu_w`; models/fuse.py) included; a tree that holds a fused
    stack beside one of its unfused members is refused. Quantized leaves
    (int8, packed-int4 uint8) keep their dtype, and so do every `*_scale`
    (f32 from models/quant.py), the LoRA adapter stacks
    (`*_lora_a/_lora_b`) and `lora_scale` (f32 adapters stay f32 over
    bf16 base weights). With a mesh the tree comes back sharded
    (mesh.shard_params)."""
    layers = tree["llm"]["layers"]
    for fused, members in _FUSED.items():
        both = [m for m in members if m in layers]
        if fused in layers and both:
            raise ValueError(
                f"fused stack {fused!r} beside its unfused members {both}; "
                f"pass a tree from before or after fuse_projections")

    for part, want in (("llm", cfg.llm.num_layers),
                       ("vision", cfg.vision.num_layers)):
        stack = tree[part]["layers"]
        got = np.shape(stack["ln1" if part == "llm" else "ln1_s"])[0]
        if got != want:
            raise ValueError(f"{part} stack has {got} layers, config "
                             f"says {want}")
    return tree_from_numpy(
        tree, device, dtype, mesh,
        keep=lambda key: is_lora_path(key) or key.endswith("_scale"))


def tree_from_numpy(tree, device="cuda", dtype: Optional[torch.dtype] = None,
                    mesh=None, keep=lambda key: False):
    """A nested dict/list tree of numpy arrays (a JAX pytree after
    `jax.tree.map(np.asarray, ...)`: params, a value head, a DDPO
    denoiser) as torch tensors on `device`, float leaves cast to `dtype`
    unless keep(leaf key); on a mesh, sharded by mesh.shard_params."""
    device = resolve_device(device)

    def conv(x, key):
        t = torch.from_numpy(np.array(x, copy=True))
        if dtype is not None and t.is_floating_point() and not keep(key):
            t = t.to(dtype)
        return t.to(device)

    def walk(node, key=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return conv(node, key)
    out = walk(tree)
    if mesh is not None:
        from streamvln_tpu_torch.parallel import mesh as mesh_lib
        out = mesh_lib.shard_params(out, mesh)
    return out


def _at(tree, path: str):
    """The leaf of a nested dict/list tree at a 'a/b/0/c' path."""
    for key in path.split("/"):
        tree = tree[int(key)] if isinstance(tree, (list, tuple)) \
            else tree[key]
    return tree


def from_jax_train_state(state, cfg: StreamVLNConfig, tcfg, device="cuda",
                         dtype: Optional[torch.dtype] = None):
    """The port's `parallel.train.TrainState` from the JAX package's
    (`streamvln_tpu/parallel/train.py::create_train_state`, its leaves as
    numpy arrays, e.g. `jax.tree.map(np.asarray, state)` after JAX's own
    `restore_checkpoint`), made for the same `tcfg`: the step, the params
    (`from_jax_params`), and per trainable group the AdamW count and f32
    moments from the optax chain (clip, scale_by_adam, decayed weights,
    schedule) inside `multi_transform`, and under grad_accum_steps > 1
    `MultiSteps`' micro-step count and accumulator. The optax states are
    read by their field names, so optax is not imported."""
    from streamvln_tpu_torch.parallel.train import (TrainState,
                                                    create_train_state)
    device = resolve_device(device)
    params = from_jax_params(state.params, cfg, device, dtype)
    port = create_train_state(params, tcfg)
    opt = state.opt_state
    mini_step = 0
    if tcfg.grad_accum_steps > 1:
        mini_step = int(opt.mini_step)
        for path, acc in port.opt_state["acc"].items():
            acc.copy_(torch.from_numpy(np.asarray(_at(opt.acc_grads, path),
                                                  np.float32)))
        opt = opt.inner_opt_state
    for name, g in port.opt_state["groups"].items():
        # MaskedState(inner_state=(clip, (adam, decay, schedule)))
        adam = opt.inner_states[name].inner_state[1][0]
        g["count"] = int(adam.count)
        for moment in ("mu", "nu"):
            for path, t in g[moment].items():
                t.copy_(torch.from_numpy(np.asarray(
                    _at(getattr(adam, moment), path), np.float32)))
    port.opt_state["mini_step"] = mini_step
    return TrainState(step=int(state.step), params=port.params,
                      opt_state=port.opt_state)


def _siglip_leaves(vc, dense, zeros, ones) -> dict:
    """The SigLIP tower's leaves, drawn in the order `init` draws them."""
    L, D, Fv, P = vc.num_layers, vc.hidden_size, vc.intermediate_size, \
        vc.patch_size
    return {
        "patch_w": dense((P * P * 3, D), P * P * 3),
        "patch_b": zeros((D,)),
        "pos_embed": dense((vc.num_patches, D), D),
        "layers": {
            "ln1_s": ones((L, D)), "ln1_b": zeros((L, D)),
            "q_w": dense((L, D, D), D), "q_b": zeros((L, D)),
            "k_w": dense((L, D, D), D), "k_b": zeros((L, D)),
            "v_w": dense((L, D, D), D), "v_b": zeros((L, D)),
            "o_w": dense((L, D, D), D), "o_b": zeros((L, D)),
            "ln2_s": ones((L, D)), "ln2_b": zeros((L, D)),
            "fc1_w": dense((L, D, Fv), D), "fc1_b": zeros((L, Fv)),
            "fc2_w": dense((L, Fv, D), Fv), "fc2_b": zeros((L, D)),
        },
    }


def leaf_makers(generator: Optional[torch.Generator], device, dtype):
    """dense(shape, fan_in), zeros(shape), ones(shape) leaf makers on
    `device` in `dtype`: dense weights ~ N(0, 1/fan_in), drawn in f32 from
    `generator` (seed 0 on `device` when None)."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return w.mul_(fan_in ** -0.5).to(dtype)

    def zeros(shape):
        return torch.zeros(shape, device=device, dtype=dtype)

    def ones(shape):
        return torch.ones(shape, device=device, dtype=dtype)
    return dense, zeros, ones


def siglip_init(cfg: SigLIPConfig,
                generator: Optional[torch.Generator] = None, device="cuda",
                dtype=torch.bfloat16) -> dict:
    """Random SigLIP-tower weights on `device`, as `init` makes its
    "vision" part (the tower the encoder builder gives for SigLIP
    names)."""
    device = resolve_device(device)
    return _siglip_leaves(cfg, *leaf_makers(generator, device, dtype))


def _to_torch(tree, device, dtype: Optional[torch.dtype]):
    """A nested dict/list tree of numpy arrays as torch tensors on
    `device`, float leaves cast to `dtype` when given."""
    if isinstance(tree, dict):
        return {k: _to_torch(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_torch(v, device, dtype) for v in tree]
    t = torch.from_numpy(np.array(tree, copy=True))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def from_jax_tower(tree, cfg, device="cuda",
                   dtype: Optional[torch.dtype] = None) -> dict:
    """A tower tree of `streamvln_tpu.models.encoders` (`init`,
    `eva_init`, `convert_hf_clip_tower`, `convert_eva_tower`; leaves as
    numpy arrays) as the port's tree for `models/encoders.py`'s
    ClipVisionConfig or EvaVisionConfig `cfg`: the same keys, per-layer
    stacks [L, ...] (an EVA tree holds num_layers - 1 blocks)."""
    from streamvln_tpu_torch.models.encoders import EvaVisionConfig
    want = cfg.num_layers - 1 if isinstance(cfg, EvaVisionConfig) \
        else cfg.num_layers
    got = np.shape(tree["layers"]["ln1_s"])[0]
    if got != want:
        raise ValueError(f"tower stack has {got} layers, config says {want}")
    return _to_torch(tree, resolve_device(device), dtype)


def from_jax_resampler(tree, device="cuda",
                       dtype: Optional[torch.dtype] = None) -> dict:
    """A perceiver or qformer tree of `streamvln_tpu.models.resampler`
    (leaves as numpy arrays; per-layer dicts in a list) as the port's tree
    for `models/resampler.py`."""
    if not isinstance(tree, dict) or (tree and not isinstance(
            tree.get("layers", []), (list, tuple))):
        raise ValueError("a resampler tree is a dict whose 'layers' is a "
                         "list of per-layer dicts")
    return _to_torch(tree, resolve_device(device), dtype)


def init(cfg: StreamVLNConfig, generator: Optional[torch.Generator] = None,
         device="cuda", dtype=torch.bfloat16) -> dict:
    """Random weights made directly on `device`, in the reference's
    fan-in-scaled normal form (weights ~ N(0, 1/fan_in), biases 0,
    norms 1), with the leaves of the config's family (an ungated MLP has
    no gate_w; an MoE layer has router_w and the expert stacks e_gate,
    e_up, e_down [L, E, ...], and the shared expert's s_* leaves where the
    config has one). The numbers differ from the JAX init of the same
    seed."""
    device = resolve_device(device)
    dense, zeros, ones = leaf_makers(generator, device, dtype)

    vc, lc = cfg.vision, cfg.llm
    vision = _siglip_leaves(vc, dense, zeros, ones)
    proj, d = [], vc.hidden_size
    for _ in range(parse_type(cfg.projector_type)):
        proj.append({"w": dense((d, lc.hidden_size), d),
                     "b": zeros((lc.hidden_size,))})
        d = lc.hidden_size

    L, Dm, F = lc.num_layers, lc.hidden_size, lc.intermediate_size
    Hq, Hkv, Dh = lc.num_heads, lc.num_kv_heads, lc.head_dim
    embed = dense((lc.vocab_size, Dm), Dm)    # first: the stream's order
    layers = {
        "ln1": ones((L, Dm)),
        "q_w": dense((L, Dm, Hq * Dh), Dm), "q_b": zeros((L, Hq * Dh)),
        "k_w": dense((L, Dm, Hkv * Dh), Dm), "k_b": zeros((L, Hkv * Dh)),
        "v_w": dense((L, Dm, Hkv * Dh), Dm), "v_b": zeros((L, Hkv * Dh)),
        "o_w": dense((L, Hq * Dh, Dm), Hq * Dh),
        "ln2": ones((L, Dm)),
    }
    if lc.num_experts:
        # the reference's MoE leaves: router, expert stacks [L, E, ...],
        # and Qwen2-MoE's shared expert with its sigmoid route
        E, Fe = lc.num_experts, lc.moe_intermediate_size or F
        layers.update({
            "router_w": dense((L, Dm, E), Dm),
            "e_gate": dense((L, E, Dm, Fe), Dm),
            "e_up": dense((L, E, Dm, Fe), Dm),
            "e_down": dense((L, E, Fe, Dm), Fe)})
        if lc.shared_expert_intermediate_size:
            Fs = lc.shared_expert_intermediate_size
            layers.update({
                "s_gate_w": dense((L, Dm, Fs), Dm),
                "s_up_w": dense((L, Dm, Fs), Dm),
                "s_down_w": dense((L, Fs, Dm), Fs),
                "s_route_w": dense((L, Dm, 1), Dm)})
    else:
        if lc.mlp_gated:
            layers["gate_w"] = dense((L, Dm, F), Dm)
        layers["up_w"] = dense((L, Dm, F), Dm)
        layers["down_w"] = dense((L, F, Dm), F)
    llm = {"embed": embed, "layers": layers, "final_norm": ones((Dm,))}
    if not lc.tie_word_embeddings:
        llm["lm_head"] = dense((Dm, lc.vocab_size), Dm)
    return {"vision": vision, "projector": {"layers": proj}, "llm": llm,
            "image_newline": dense((Dm,), Dm)}
