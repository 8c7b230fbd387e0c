"""The training state's checkpoints, and the HF-format export of the port's
params (the inverse of models/convert_hf).

Counterpart of `streamvln_tpu/utils/checkpoint.py`:
- `save_checkpoint` / `latest_step` / `restore_checkpoint` /
  `resume_latest` keep the reference's signatures and rules, in a
  torch-native format in place of orbax: one directory per step under
  `directory/<step>/` holding `state.pt` (`torch.save` of the flattened
  TrainState: the step, every param leaf in its stored dtype, int8 and
  packed int4 included, and the optimizer state: per group its count and
  f32 moments, the accumulator and its micro-step count). A save writes a
  temporary directory (a name that is not all digits, which no reader
  takes for a step) and renames it, so a cut save leaves no step behind.
  As orbax's CheckpointManager does, a save of a step at or below the
  newest one on disk is skipped (False), and the newest `max_to_keep`
  steps are kept.
- `export_hf` / `save_hf`: the reference stack's StreamVLNForCausalLM
  names, matrices back to torch's [out, in], one tensor per layer, f32
  values by default. Quantized leaves are dequantized first
  (`quant.dequantize_llm`), so an exported checkpoint never carries raw
  int8 or packed int4 bytes without their scales.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Dict, List, Optional

import torch

from streamvln_tpu_torch.models.quant import dequantize_llm, is_packed_int4
from streamvln_tpu_torch.utils import safetensors_io

STATE_FILE = "state.pt"


def _map_leaves(fn, tree, prefix: str = ""):
    """`tree` rebuilt with fn(path, leaf) at each leaf (a tensor or a
    scalar); dicts, lists and tuples are walked, paths joined by "/"."""
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v, f"{prefix}/{k}")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v, f"{prefix}/{i}")
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def _flatten(tree):
    """({path: tensor}, {path: scalar}) of `tree`'s leaves."""
    tensors, scalars = {}, {}

    def put(path, leaf):
        (tensors if isinstance(leaf, torch.Tensor) else scalars)[path] = leaf
    _map_leaves(put, tree)
    return tensors, scalars


def _state_tree(state) -> dict:
    return {"step": state.step, "params": state.params,
            "opt_state": state.opt_state}


def _steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(n) for n in os.listdir(directory)
                  if re.fullmatch(r"\d+", n))


def save_checkpoint(directory: str, state, step: int,
                    max_to_keep: int = 3, wait: bool = False) -> bool:
    """Write `state` (parallel.train.TrainState) as step `step` under
    `directory`; False (and nothing written) when a step >= `step` is
    already there. Keeps the newest `max_to_keep` steps. The write is
    synchronous; `wait` keeps the reference's signature."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    steps = _steps(directory)
    if steps and steps[-1] >= step:
        return False
    tensors, scalars = _flatten(_state_tree(state))
    # leftovers of cut saves are never steps; clear them before writing
    for name in os.listdir(directory):
        if name.startswith(".tmp-"):
            shutil.rmtree(os.path.join(directory, name))
    tmp = os.path.join(directory, f".tmp-{step}")
    os.makedirs(tmp)
    torch.save({"tensors": {k: t.detach() for k, t in tensors.items()},
                "scalars": scalars}, os.path.join(tmp, STATE_FILE))
    os.replace(tmp, os.path.join(directory, str(step)))
    for old in (steps + [step])[:-max_to_keep]:
        shutil.rmtree(os.path.join(directory, str(old)))
    return True


def latest_step(directory: str) -> Optional[int]:
    """The newest step under `directory` (all-digit names only), or None."""
    steps = _steps(os.path.abspath(directory))
    return steps[-1] if steps else None


@torch.no_grad()
def restore_checkpoint(directory: str, target, step: Optional[int] = None):
    """The TrainState saved at `step` (the newest when None), restored into
    `target`'s tensors in place, bit for bit, on their devices; its scalars
    (step, counts, micro-step) come from the checkpoint. The checkpoint
    must hold exactly `target`'s tensors, each of the same shape and
    dtype."""
    from streamvln_tpu_torch.parallel.train import TrainState
    directory = os.path.abspath(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    saved = torch.load(os.path.join(directory, str(step), STATE_FILE),
                       map_location="cpu", mmap=True, weights_only=True)
    tensors, scalars = _flatten(_state_tree(target))
    if set(tensors) != set(saved["tensors"]) or \
            set(scalars) != set(saved["scalars"]):
        raise ValueError(
            f"checkpoint {directory}/{step} does not hold the target's "
            f"state: missing "
            f"{sorted(set(tensors) - set(saved['tensors']))[:5]}, extra "
            f"{sorted(set(saved['tensors']) - set(tensors))[:5]}")
    for path, t in tensors.items():
        src = saved["tensors"][path]
        if src.shape != t.shape or src.dtype != t.dtype:
            raise ValueError(f"{path}: checkpoint holds {src.dtype} "
                             f"{tuple(src.shape)}, target {t.dtype} "
                             f"{tuple(t.shape)}")
        t.copy_(src)

    tree = _map_leaves(lambda path, leaf: leaf if isinstance(
        leaf, torch.Tensor) else saved["scalars"][path], _state_tree(target))
    return TrainState(step=tree["step"], params=tree["params"],
                      opt_state=tree["opt_state"])


def resume_latest(directory: str, state):
    """(state, step): restored from the newest checkpoint under `directory`
    if there is one, else the given fresh state at step 0."""
    step = latest_step(directory)
    if step is None:
        return state, 0
    return restore_checkpoint(directory, state, step), step


_VISION = [("ln1_s", "layer_norm1.weight", False),
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
_LLM = [("ln1", "input_layernorm.weight", False),
        ("q_w", "self_attn.q_proj.weight", True),
        ("q_b", "self_attn.q_proj.bias", False),
        ("k_w", "self_attn.k_proj.weight", True),
        ("k_b", "self_attn.k_proj.bias", False),
        ("v_w", "self_attn.v_proj.weight", True),
        ("v_b", "self_attn.v_proj.bias", False),
        ("o_w", "self_attn.o_proj.weight", True),
        ("ln2", "post_attention_layernorm.weight", False),
        ("gate_w", "mlp.gate_proj.weight", True),
        ("up_w", "mlp.up_proj.weight", True),
        ("down_w", "mlp.down_proj.weight", True)]


def _quantized(llm: dict) -> bool:
    leaves = list(llm.values()) + list(llm["layers"].values())
    return any(isinstance(w, torch.Tensor)
               and (w.dtype == torch.int8 or is_packed_int4(w))
               for w in leaves)


def export_hf(params: dict, cfg, dtype=torch.float32
              ) -> Dict[str, torch.Tensor]:
    """The port's (unfused) params -> the HF StreamVLNForCausalLM state
    dict, {name: host tensor in `dtype`}. Each tensor is transposed and
    cast where its leaf lies (the card, for a model being served) and then
    copied to the host."""
    if _quantized(params["llm"]):
        params = dequantize_llm(params)
    out: Dict[str, torch.Tensor] = {}

    def put(name, t, transpose=False):
        t = t.T if transpose else t
        out[name] = t.to(dtype).contiguous().cpu()

    if "image_newline" in params:
        put("model.image_newline", params["image_newline"])
    llm = params["llm"]
    put("model.embed_tokens.weight", llm["embed"])
    put("model.norm.weight", llm["final_norm"])
    if "lm_head" in llm:
        put("lm_head.weight", llm["lm_head"], transpose=True)
    lay = llm["layers"]
    for i in range(lay["ln1"].shape[0]):
        for ours, theirs, transpose in _LLM:
            put(f"model.layers.{i}.{theirs}", lay[ours][i], transpose)

    vis = params["vision"]
    vp = "model.vision_tower.vision_tower.vision_model."
    D, P = cfg.vision.hidden_size, cfg.vision.patch_size
    put(vp + "embeddings.patch_embedding.weight",
        vis["patch_w"].T.reshape(D, 3, P, P))
    put(vp + "embeddings.patch_embedding.bias", vis["patch_b"])
    put(vp + "embeddings.position_embedding.weight", vis["pos_embed"])
    vl = vis["layers"]
    for i in range(vl["ln1_s"].shape[0]):
        for ours, theirs, transpose in _VISION:
            put(vp + f"encoder.layers.{i}.{theirs}", vl[ours][i], transpose)

    for i, lp in enumerate(params["projector"]["layers"]):
        put(f"model.mm_projector.{i * 2}.weight", lp["w"], transpose=True)
        put(f"model.mm_projector.{i * 2}.bias", lp["b"])
    return out


def save_hf(params: dict, cfg, directory: str, dtype=torch.float32,
            max_shard_bytes: Optional[int] = None) -> List[str]:
    """Write export_hf(params, cfg, dtype) as `model.safetensors`, or, when
    it holds more than `max_shard_bytes`, as shards
    `model-0000k-of-0000n.safetensors` (tensors in name order) with a
    `model.safetensors.index.json`, as HF's save_pretrained lays them
    out. Returns the paths written."""
    os.makedirs(directory, exist_ok=True)
    tensors = export_hf(params, cfg, dtype)
    sizes = {k: t.numel() * t.element_size() for k, t in tensors.items()}
    total = sum(sizes.values())
    meta = {"format": "pt"}
    if max_shard_bytes is None or total <= max_shard_bytes:
        path = os.path.join(directory, "model.safetensors")
        safetensors_io.save_file(tensors, path, meta)
        return [path]
    shards, size = [[]], 0
    for name in sorted(tensors):
        if shards[-1] and size + sizes[name] > max_shard_bytes:
            shards.append([])
            size = 0
        shards[-1].append(name)
        size += sizes[name]
    paths, weight_map = [], {}
    for k, names in enumerate(shards):
        fname = f"model-{k + 1:05d}-of-{len(shards):05d}.safetensors"
        path = os.path.join(directory, fname)
        safetensors_io.save_file({n: tensors.pop(n) for n in names}, path,
                                 meta)
        weight_map.update({n: fname for n in names})
        paths.append(path)
    with open(os.path.join(directory, "model.safetensors.index.json"),
              "w") as f:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": weight_map}, f, indent=1)
    return paths
