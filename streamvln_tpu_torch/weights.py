"""Parameters of the port: carried across from the JAX package's pytree,
or made at random on the device; and a JAX training state carried across.

Both give the reference's dict layout: {"vision", "projector", "llm",
"image_newline"}, with per-layer weights stacked [L, ...] and matrices
stored [in, out].
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from streamvln_tpu_torch.configs import StreamVLNConfig, resolve_device
from streamvln_tpu_torch.models.lora import is_lora_path
from streamvln_tpu_torch.models.projector import parse_type

_FUSED = {"qkv_w": ("q_w", "k_w", "v_w"), "gu_w": ("gate_w", "up_w")}


def from_jax_params(tree, cfg: StreamVLNConfig, device="cuda",
                    dtype: Optional[torch.dtype] = None) -> dict:
    """Convert the pytree of `streamvln_tpu.models.streamvln.init` (leaves
    as numpy arrays, e.g. after `jax.tree.map(np.asarray, params)`) into
    torch tensors on `device`, float leaves cast to `dtype` when given.
    The stacked layer weights are taken as they are, fused projections
    (`qkv_w`, `gu_w`; models/fuse.py) included; a tree that holds a fused
    stack beside one of its unfused members is refused. Quantized leaves
    (int8, packed-int4 uint8) keep their dtype, and so do every `*_scale`
    (f32 from models/quant.py), the LoRA adapter stacks
    (`*_lora_a/_lora_b`) and `lora_scale` (f32 adapters stay f32 over
    bf16 base weights)."""
    device = resolve_device(device)
    layers = tree["llm"]["layers"]
    for fused, members in _FUSED.items():
        both = [m for m in members if m in layers]
        if fused in layers and both:
            raise ValueError(
                f"fused stack {fused!r} beside its unfused members {both}; "
                f"pass a tree from before or after fuse_projections")

    def conv(x, keep_dtype):
        t = torch.from_numpy(np.array(x, copy=True))
        if dtype is not None and t.is_floating_point() and not keep_dtype:
            t = t.to(dtype)
        return t.to(device)

    def walk(node, key=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return conv(node, is_lora_path(key) or key.endswith("_scale"))
    for part, want in (("llm", cfg.llm.num_layers),
                       ("vision", cfg.vision.num_layers)):
        stack = tree[part]["layers"]
        got = np.shape(stack["ln1" if part == "llm" else "ln1_s"])[0]
        if got != want:
            raise ValueError(f"{part} stack has {got} layers, config "
                             f"says {want}")
    return walk(tree)


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


def init(cfg: StreamVLNConfig, generator: Optional[torch.Generator] = None,
         device="cuda", dtype=torch.bfloat16) -> dict:
    """Random weights made directly on `device`, in the reference's
    fan-in-scaled normal form (weights ~ N(0, 1/fan_in), biases 0,
    norms 1). The numbers differ from the JAX init of the same seed."""
    device = resolve_device(device)
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

    vc, lc = cfg.vision, cfg.llm
    L, D, Fv, P = vc.num_layers, vc.hidden_size, vc.intermediate_size, \
        vc.patch_size
    vision = {
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
    proj, d = [], D
    for _ in range(parse_type(cfg.projector_type)):
        proj.append({"w": dense((d, lc.hidden_size), d),
                     "b": zeros((lc.hidden_size,))})
        d = lc.hidden_size

    L, Dm, F = lc.num_layers, lc.hidden_size, lc.intermediate_size
    Hq, Hkv, Dh = lc.num_heads, lc.num_kv_heads, lc.head_dim
    llm = {
        "embed": dense((lc.vocab_size, Dm), Dm),
        "layers": {
            "ln1": ones((L, Dm)),
            "q_w": dense((L, Dm, Hq * Dh), Dm), "q_b": zeros((L, Hq * Dh)),
            "k_w": dense((L, Dm, Hkv * Dh), Dm), "k_b": zeros((L, Hkv * Dh)),
            "v_w": dense((L, Dm, Hkv * Dh), Dm), "v_b": zeros((L, Hkv * Dh)),
            "o_w": dense((L, Hq * Dh, Dm), Hq * Dh),
            "ln2": ones((L, Dm)),
            "gate_w": dense((L, Dm, F), Dm),
            "up_w": dense((L, Dm, F), Dm),
            "down_w": dense((L, F, Dm), F),
        },
        "final_norm": ones((Dm,)),
    }
    if not lc.tie_word_embeddings:
        llm["lm_head"] = dense((Dm, lc.vocab_size), Dm)
    return {"vision": vision, "projector": {"layers": proj}, "llm": llm,
            "image_newline": dense((Dm,), Dm)}
