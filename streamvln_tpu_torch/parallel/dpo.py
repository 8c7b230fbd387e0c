"""DPO (Direct Preference Optimization) training step of the port.

Counterpart of `streamvln_tpu/parallel/dpo.py` (reference capability:
llava/train/train_dpo.py and LLaVADPOTrainer over TRL's DPOTrainer).
The chosen and rejected completions share the prompt and its images;
each side's log-probability is the sum of log p(label) over its
supervised positions, and

    loss = -log sigmoid(beta * ((pi_c - ref_c) - (pi_r - ref_r))).

The reference policy is a frozen second tree. With LoRA it can be the
policy's own base tensors without the adapters (`lora.split_lora(params)
[0]`): the same storage, not a second copy. Its forward runs under
no_grad, where the attention wrappers launch K2; the policy's forward
runs with grad (K3 forward, K4/K5 backward).

The step is the train step's (parallel/train.py: per-group clipping,
AdamW, accumulation; on a mesh the ZeRO-3 gather and reduce-scatter,
the loss a mean over the global batch's pairs). One divergence from the
JAX step, which differentiates every leaf: grad_norm here is the norm of
the trained leaves' grads (a LoRA step computes no grads of the frozen
base).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from streamvln_tpu_torch.configs import StreamVLNConfig, resolve_device
from streamvln_tpu_torch.data.collate import (DEFAULT_LENGTH_BUCKETS,
                                              pick_bucket)
from streamvln_tpu_torch.models import qwen2, streamvln
from streamvln_tpu_torch.parallel import mesh as mesh_lib
from streamvln_tpu_torch.parallel.train import (
    TrainConfig, TrainState, apply_grads, grad_norm, to_device,
    value_and_grads)
from streamvln_tpu_torch.utils.constants import (
    IGNORE_INDEX, IMAGE_TOKEN_INDEX, MEMORY_TOKEN_INDEX)

SIDE_KEYS = ("token_ids", "is_vision", "vision_index", "labels", "valid")


def layout_positions(valid: torch.Tensor) -> torch.Tensor:
    """Positions of a padded layout: 0..n-1 on real tokens, 0 on pads."""
    return torch.where(valid, torch.cumsum(valid.int(), dim=1) - 1,
                       0).to(torch.int32)


def sequence_logprob(params, cfg: StreamVLNConfig, images, layout,
                     attn_impl: str = "auto", remat: bool = False):
    """Sum of per-token log p(label) over supervised positions, [B] f32."""
    vision_flat = streamvln.encode_frames(params, cfg, images, attn_impl,
                                          remat=remat)
    embeds = streamvln.splice_embeds(
        params, vision_flat, layout["token_ids"], layout["is_vision"],
        layout["vision_index"], cfg.llm)
    valid = layout["valid"]
    logits, _ = qwen2.forward(params["llm"], cfg.llm, embeds,
                              layout_positions(valid), valid=valid,
                              attn_impl=attn_impl, remat=remat)
    labels = layout["labels"][:, 1:].long()
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    mask = labels != IGNORE_INDEX
    tok = torch.gather(logp, -1, labels.clamp(min=0)[..., None])[..., 0]
    return (tok * mask).sum(dim=1)


def _side(batch, side):
    return {k: batch[f"{side}_{k}"] for k in SIDE_KEYS}


def dpo_loss(policy_params, ref_params, cfg: StreamVLNConfig, batch,
             beta: float = 0.1, attn_impl: str = "auto",
             remat: bool = False):
    """(loss, {"dpo_accuracy", "reward_margin"}): means over the pairs."""
    def lp(params, side):
        return sequence_logprob(params, cfg, batch["images"],
                                _side(batch, side), attn_impl, remat)

    pi_c, pi_r = lp(policy_params, "chosen"), lp(policy_params, "rejected")
    with torch.no_grad():
        ref_c, ref_r = lp(ref_params, "chosen"), lp(ref_params, "rejected")
    logits = beta * ((pi_c - ref_c) - (pi_r - ref_r))
    loss = -torch.nn.functional.logsigmoid(logits).mean()
    acc = (logits > 0).float().mean()
    margin = (beta * (pi_c - ref_c) - beta * (pi_r - ref_r)).mean()
    return loss, {"dpo_accuracy": acc, "reward_margin": margin}


def make_dpo_step(cfg: StreamVLNConfig, tcfg: TrainConfig, device="cuda",
                  beta: float = 0.1, mesh=None):
    """Returns step(state, ref_params, batch) -> (state, metrics) with
    metrics loss, dpo_accuracy, reward_margin and grad_norm. The batch is
    `make_dpo_batch`'s (numpy or tensors; on a mesh the global batch,
    each rank taking its rows); ref_params as the state's params (plain
    or, on a mesh, DTensors, gathered under no_grad)."""
    device = resolve_device(device)
    keys = ("images",) + tuple(f"{s}_{k}" for s in ("chosen", "rejected")
                               for k in SIDE_KEYS)

    def step(state: TrainState, ref_params, batch):
        batch = to_device(batch, keys, device, mesh)
        batch["images"] = batch["images"].to(
            state.params["vision"]["patch_w"].dtype)
        if mesh is not None:
            with torch.no_grad():
                ref_params = mesh_lib.gather_tree(ref_params)

        def loss_of(params, b):
            return dpo_loss(params, ref_params, cfg, b, beta,
                            tcfg.attn_impl, tcfg.remat)
        n = float(batch["images"].shape[0])
        loss, aux, grads, _ = value_and_grads(state, loss_of, batch, n,
                                              mesh)
        gnorm = grad_norm(state, grads, mesh)
        return (apply_grads(state, grads, tcfg, mesh),
                {"loss": loss, **aux, "grad_norm": gnorm})

    return step


def make_dpo_batch(samples, cfg: StreamVLNConfig,
                   length_buckets: Optional[Sequence[int]] = None) -> dict:
    """Collate DPO samples: each has chosen/rejected (input_ids, labels)
    sharing `images` [V, S, S, 3]; both sides padded to one length
    bucket, images zero-padded to the batch's most frames."""
    length_buckets = length_buckets or DEFAULT_LENGTH_BUCKETS
    tpf = cfg.tokens_per_frame

    def expanded(ids):
        return sum(tpf if t == IMAGE_TOKEN_INDEX else
                   cfg.num_history * tpf if t == MEMORY_TOKEN_INDEX else 1
                   for t in np.asarray(ids).tolist())

    bucket = pick_bucket(max(expanded(s[f"{side}_input_ids"])
                             for s in samples
                             for side in ("chosen", "rejected")),
                         length_buckets)
    batch = {}
    for side in ("chosen", "rejected"):
        stacked = streamvln.stack_layouts([streamvln.build_splice_layout(
            s[f"{side}_input_ids"], cfg, labels=s[f"{side}_labels"],
            pad_to=bucket, max_frames=len(s["images"])) for s in samples])
        del stacked["lengths"]
        batch.update({f"{side}_{k}": v for k, v in stacked.items()})
    V_max = max(len(s["images"]) for s in samples)
    S = samples[0]["images"].shape[1]
    images = np.zeros((len(samples), V_max, S, S, 3), np.float32)
    for i, s in enumerate(samples):
        images[i, :len(s["images"])] = s["images"]
    batch["images"] = images
    return batch
