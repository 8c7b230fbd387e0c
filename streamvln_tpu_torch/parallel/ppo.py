"""PPO and reward-model training steps of the port.

Counterpart of `streamvln_tpu/parallel/ppo.py` (reference capability: the
TRL subset the reference vendors, trl/trainer/ppo_trainer.py and
reward_trainer.py), on the train step's optimizer and mesh
(parallel/train.py):

- Reward model: a scalar value head over the final-normed hidden state
  of the last real token; the pairwise Bradley-Terry loss
  -log sigmoid(r_chosen - r_rejected) over `make_dpo_batch`'s pairs.
- PPO: the clipped surrogate over per-token log-prob ratios, the clipped
  value loss and an entropy bonus, with GAE advantages (`compute_gae`,
  numpy, whitened over the response tokens). Rollouts are generated
  outside the step; it consumes the layout, response_mask, old_logp,
  old_values, advantages and returns, as TRL's PPOTrainer.step does.

The value head {"w": [D, 1], "b": [1]} trains with optax's plain
`adamw(learning_rate)` (b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-4,
no clipping, constant rate), written out in `_head_adamw`; the policy
with the train step's optimizer. As in the DPO step, grad_norm is the
norm of the trained leaves' grads.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from streamvln_tpu_torch.configs import StreamVLNConfig, resolve_device
from streamvln_tpu_torch.models import qwen2, streamvln
from streamvln_tpu_torch.parallel.dpo import layout_positions
from streamvln_tpu_torch.parallel.train import (
    TrainConfig, TrainState, adamw_, adamw_state, apply_grads, grad_norm,
    to_device, value_and_grads)

LAYOUT = ("token_ids", "is_vision", "vision_index", "valid")


def _forward_hidden(params, cfg: StreamVLNConfig, images, layout,
                    attn_impl: str = "auto", remat: bool = False):
    """Final-normed hidden states [B, T, D] of a splice layout."""
    vision_flat = streamvln.encode_frames(params, cfg, images, attn_impl,
                                          remat=remat)
    embeds = streamvln.splice_embeds(
        params, vision_flat, layout["token_ids"], layout["is_vision"],
        layout["vision_index"], cfg.llm)
    valid = layout["valid"]
    hidden, _ = qwen2.forward(params["llm"], cfg.llm, embeds,
                              layout_positions(valid), valid=valid,
                              attn_impl=attn_impl, remat=remat,
                              return_hidden=True)
    return hidden


def _token_logp(params, hidden, token_ids):
    """(log p of token_ids[t] at every t >= 1 [B, T-1], the full f32
    log-softmax [B, T-1, V])."""
    logits = qwen2.lm_head_logits(params["llm"], hidden)[:, :-1]
    logp_all = torch.log_softmax(logits.float(), dim=-1)
    nxt = token_ids[:, 1:].long().clamp(min=0)
    return torch.gather(logp_all, -1, nxt[..., None])[..., 0], logp_all


def token_logprobs(params, cfg: StreamVLNConfig, images, layout,
                   attn_impl: str = "auto", remat: bool = False):
    """log p(token_ids[t] | <t) at every position t >= 1, [B, T-1]."""
    hidden = _forward_hidden(params, cfg, images, layout, attn_impl, remat)
    return _token_logp(params, hidden, layout["token_ids"])[0]


# ---------------------------------------------------------------------------
# The value head
# ---------------------------------------------------------------------------

def init_value_head(generator: torch.Generator, cfg: StreamVLNConfig,
                    dtype=torch.float32, device=None) -> dict:
    """{"w": N(0, 1/D) [D, 1], "b": zeros [1]} on the generator's
    device (or `device`)."""
    D = cfg.llm.hidden_size
    device = device or generator.device
    w = torch.randn((D, 1), generator=generator, device=device,
                    dtype=torch.float32) * D ** -0.5
    return {"w": w.to(dtype), "b": torch.zeros((1,), dtype=dtype,
                                              device=device)}


def _head(hidden, head):
    return hidden.float() @ head["w"].float() + head["b"].float()


def sequence_reward(params, head, cfg: StreamVLNConfig, images, layout,
                    attn_impl: str = "auto", remat: bool = False):
    """Scalar reward per sequence [B]: the value head at the last real
    token."""
    hidden = _forward_hidden(params, cfg, images, layout, attn_impl, remat)
    last = layout["valid"].long().sum(dim=1) - 1
    rows = torch.arange(hidden.shape[0], device=hidden.device)
    return _head(hidden[rows, last], head)[:, 0]


def _head_adamw(head: dict, grads: dict, opt: dict, lr: float) -> None:
    """optax.adamw(lr) on the head, in place."""
    opt["count"] += 1
    for k, w in head.items():
        adamw_(w, grads[k].float(), opt["mu"][k], opt["nu"][k],
               opt["count"], lr, weight_decay=1e-4)


def _head_step(state, head, head_opt, loss_of, batch, count, tcfg, mesh):
    """One policy + head update; returns (state, head, head_opt, loss,
    aux, grad_norm)."""
    hs = [head[k].detach().requires_grad_() for k in ("w", "b")]
    live = dict(zip(("w", "b"), hs))
    loss, aux, grads, (gw, gb) = value_and_grads(
        state, lambda p, b: loss_of(p, live, b), batch, count, mesh,
        extra=hs)
    gnorm = grad_norm(state, grads, mesh)
    state = apply_grads(state, grads, tcfg, mesh)
    _head_adamw(head, {"w": gw, "b": gb}, head_opt, tcfg.learning_rate)
    return state, head, head_opt, loss, aux, gnorm


def make_reward_step(cfg: StreamVLNConfig, tcfg: TrainConfig,
                     device="cuda", mesh=None):
    """Returns (step, init_head_opt) (train.adamw_state): step(state,
    head, head_opt, batch)
    -> (state, head, head_opt, metrics) over `make_dpo_batch`'s pairs
    (the `*_labels` are not read); metrics loss, reward_accuracy,
    reward_margin, grad_norm. The head is updated in place."""
    device = resolve_device(device)
    keys = ("images",) + tuple(f"{s}_{k}" for s in ("chosen", "rejected")
                               for k in LAYOUT)

    def loss_of(params, head, batch):
        def r(side):
            layout = {k: batch[f"{side}_{k}"] for k in LAYOUT}
            return sequence_reward(params, head, cfg, batch["images"],
                                   layout, tcfg.attn_impl, tcfg.remat)
        rc, rr = r("chosen"), r("rejected")
        loss = -torch.nn.functional.logsigmoid(rc - rr).mean()
        return loss, {"reward_accuracy": (rc > rr).float().mean(),
                      "reward_margin": (rc - rr).mean()}

    def step(state: TrainState, head: dict, head_opt: dict, batch: dict):
        batch = to_device(batch, keys, device, mesh)
        batch["images"] = batch["images"].to(
            state.params["vision"]["patch_w"].dtype)
        state, head, head_opt, loss, aux, gnorm = _head_step(
            state, head, head_opt, loss_of, batch,
            float(batch["images"].shape[0]), tcfg, mesh)
        return state, head, head_opt, {"loss": loss, **aux,
                                       "grad_norm": gnorm}

    return step, adamw_state


# ---------------------------------------------------------------------------
# PPO
# ---------------------------------------------------------------------------

def compute_gae(rewards: np.ndarray, values: np.ndarray, mask: np.ndarray,
                gamma: float = 1.0,
                lam: float = 0.95) -> Tuple[np.ndarray, np.ndarray]:
    """Generalized advantage estimation over response tokens
    (trl/trainer/ppo_trainer.py compute_advantages). rewards/values/mask
    [B, T]; positions with mask 0 contribute nothing. Returns
    (advantages, returns), advantages whitened over masked positions."""
    B, T = rewards.shape
    adv = np.zeros_like(rewards, np.float32)
    last = np.zeros((B,), np.float32)
    for t in range(T - 1, -1, -1):
        next_v = values[:, t + 1] if t + 1 < T else 0.0
        delta = rewards[:, t] + gamma * next_v - values[:, t]
        last = delta + gamma * lam * last
        adv[:, t] = last
        last = last * mask[:, t]
    adv = adv * mask
    returns = adv + values
    m = mask.sum() or 1.0
    mean = (adv * mask).sum() / m
    var = (((adv - mean) ** 2) * mask).sum() / m
    adv = (adv - mean) / np.sqrt(var + 1e-8) * mask
    return adv, returns


PPO_KEYS = LAYOUT + ("images", "response_mask", "old_logp", "old_values",
                     "advantages", "returns")


def make_ppo_step(cfg: StreamVLNConfig, tcfg: TrainConfig, device="cuda",
                  clip_ratio: float = 0.2, value_clip: float = 0.2,
                  vf_coef: float = 0.1, ent_coef: float = 0.0, mesh=None):
    """Returns (step, init_head_opt) (train.adamw_state): step(state,
    head, head_opt, batch)
    -> (state, head, head_opt, metrics). Batch: the layout arrays
    (token_ids/is_vision/vision_index/valid [B, T]), images, and
    response_mask (1 on generated tokens, in the t >= 1 frame), old_logp,
    old_values, advantages, returns, all [B, T-1]. Metrics: loss,
    pg_loss, vf_loss, entropy, approx_kl, clip_frac (means over the
    response tokens of the global batch), grad_norm."""
    device = resolve_device(device)

    def loss_of(params, head, b):
        mask = b["response_mask"].float()
        n = mask.sum().clamp(min=1.0)
        hidden = _forward_hidden(params, cfg, b["images"],
                                 {k: b[k] for k in LAYOUT}, tcfg.attn_impl,
                                 tcfg.remat)
        logp, logp_all = _token_logp(params, hidden, b["token_ids"])
        ratio = torch.exp(logp - b["old_logp"])
        adv = b["advantages"]
        pg = -torch.minimum(ratio * adv, torch.clamp(
            ratio, 1 - clip_ratio, 1 + clip_ratio) * adv)
        pg_loss = (pg * mask).sum() / n
        values = _head(hidden[:, :-1], head)[..., 0]
        old_v = b["old_values"]
        v_clip = old_v + torch.clamp(values - old_v, -value_clip,
                                     value_clip)
        vf = torch.maximum((values - b["returns"]) ** 2,
                           (v_clip - b["returns"]) ** 2)
        vf_loss = 0.5 * (vf * mask).sum() / n
        ent = -(torch.exp(logp_all) * logp_all).sum(-1)
        ent_mean = (ent * mask).sum() / n
        loss = pg_loss + vf_coef * vf_loss - ent_coef * ent_mean
        with torch.no_grad():
            aux = {"pg_loss": pg_loss, "vf_loss": vf_loss,
                   "entropy": ent_mean,
                   "approx_kl": ((b["old_logp"] - logp) * mask).sum() / n,
                   "clip_frac": (((ratio - 1).abs() > clip_ratio).float()
                                 * mask).sum() / n}
        return loss, aux

    def step(state: TrainState, head: dict, head_opt: dict, batch: dict):
        batch = to_device(batch, PPO_KEYS, device, mesh)
        batch["images"] = batch["images"].to(
            state.params["vision"]["patch_w"].dtype)
        for k in ("old_logp", "old_values", "advantages", "returns"):
            batch[k] = batch[k].float()
        state, head, head_opt, loss, aux, gnorm = _head_step(
            state, head, head_opt, loss_of, batch,
            batch["response_mask"].float().sum(), tcfg, mesh)
        return state, head, head_opt, {"loss": loss, **aux,
                                       "grad_norm": gnorm}

    return step, adamw_state


def rollout_batch(layout: Dict[str, np.ndarray], images: np.ndarray,
                  response_mask: np.ndarray, old_logp: np.ndarray,
                  old_values: np.ndarray, rewards: np.ndarray,
                  gamma: float = 1.0, lam: float = 0.95) -> dict:
    """A PPO batch from a rollout: GAE over the response tokens."""
    adv, ret = compute_gae(rewards, old_values, response_mask, gamma, lam)
    return {**{k: layout[k] for k in LAYOUT}, "images": images,
            "response_mask": response_mask, "old_logp": old_logp,
            "old_values": old_values, "advantages": adv, "returns": ret}
