"""DDPO: denoising-diffusion policy optimization, in the port.

Counterpart of `streamvln_tpu/parallel/ddpo.py` (reference capability:
TRL's DDPOTrainer, trl/trainer/ddpo_trainer.py):

- a DDIM step with the Gaussian log-prob of the chosen prev_sample
  (epsilon prediction, eta-scaled DDIM variance, the diagonal-Gaussian
  log-density averaged over latent dims);
- the clipped importance-ratio surrogate, the advantage clamp, approx-KL
  and clipfrac;
- PerPromptStatTracker's advantage normalization.

The denoiser is the caller's `apply(params, latents, t, embeds) ->
noise_pred`, params a dict of tensors; no kernel of this repository is
on this path. Sampling is a Python loop where JAX scans; its noise comes
from a `torch.Generator`, so a rollout has the same distribution as
JAX's, not its bits. The optimizer is optax's chain
`clip_by_global_norm(max_grad_norm)` then `adamw(learning_rate)` (b1
0.9, b2 0.999, eps 1e-8, weight decay 1e-4), written out: torch's AdamW
defaults to weight decay 1e-2.
"""
from __future__ import annotations

import math
from collections import deque
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from streamvln_tpu_torch.parallel.train import adamw_, adamw_state

# the eta-scaled DDIM variance is exactly 0 at the last step
# (alpha_prod_prev == 1); the floor keeps its log-prob finite
_STD_FLOOR = 1e-5


def make_alphas_cumprod(num_timesteps: int = 1000,
                        beta_start: float = 8.5e-4,
                        beta_end: float = 1.2e-2,
                        device=None) -> torch.Tensor:
    """The linear-beta DDPM schedule's cumulative alpha products (f32,
    accumulated in f32 as jnp.cumprod does)."""
    betas = torch.linspace(beta_start, beta_end, num_timesteps,
                           dtype=torch.float32, device=device)
    return torch.cumprod(1.0 - betas, dim=0)


def ddim_step_logprob(noise_pred, t, t_prev, sample, alphas_cumprod,
                      eta: float = 1.0, prev_sample=None,
                      generator: Optional[torch.Generator] = None):
    """One DDIM step: (prev_sample, log-prob per sample [B]). With
    `prev_sample` given it is scored under the current posterior
    (training); else it is drawn with `generator` (rollout). t and t_prev
    are ints or [B] tensors; t_prev < 0 is the final step (alpha 1)."""
    t = torch.as_tensor(t, device=sample.device)
    t_prev = torch.as_tensor(t_prev, device=sample.device)
    a_t = alphas_cumprod[t]
    a_prev = torch.where(t_prev >= 0, alphas_cumprod[t_prev.clamp(min=0)],
                         torch.ones_like(a_t))
    shape = a_t.shape + (1,) * (sample.dim() - a_t.dim())
    a_t, a_prev = a_t.reshape(shape), a_prev.reshape(shape)
    beta_t, beta_prev = 1.0 - a_t, 1.0 - a_prev

    pred_x0 = (sample - torch.sqrt(beta_t) * noise_pred) / torch.sqrt(a_t)
    variance = (beta_prev / beta_t) * (1.0 - a_t / a_prev)
    std = torch.clamp(eta * torch.sqrt(variance.clamp(min=0.0)),
                      min=_STD_FLOOR)
    dir_xt = torch.sqrt((beta_prev - std ** 2).clamp(min=0.0)) * noise_pred
    mean = torch.sqrt(a_prev) * pred_x0 + dir_xt

    if prev_sample is None:
        noise = torch.randn(sample.shape, generator=generator,
                            dtype=sample.dtype, device=sample.device)
        prev_sample = mean + std * noise
    logp = (-((prev_sample.detach() - mean) ** 2) / (2.0 * std ** 2)
            - torch.log(std) - 0.5 * math.log(2.0 * math.pi))
    return prev_sample, logp.reshape(logp.shape[0], -1).mean(dim=1)


@torch.no_grad()
def sample_with_logprob(apply: Callable, params, generator, x_t,
                        timesteps, embeds, alphas_cumprod,
                        eta: float = 1.0):
    """A full DDIM rollout: (latents [S, B, ...], the input of each step;
    next_latents [S, B, ...]; logps [S, B]), the tuple DDPOTrainer
    collects per sample."""
    timesteps = [int(t) for t in timesteps]
    prevs = timesteps[1:] + [-1]
    x = x_t
    lat, nxt, logps = [], [], []
    for t, t_prev in zip(timesteps, prevs):
        eps = apply(params, x, torch.full((x.shape[0],), t,
                                          device=x.device), embeds)
        x_next, logp = ddim_step_logprob(eps, t, t_prev, x, alphas_cumprod,
                                         eta, generator=generator)
        lat.append(x)
        nxt.append(x_next)
        logps.append(logp)
        x = x_next
    return torch.stack(lat), torch.stack(nxt), torch.stack(logps)


class PerPromptStatTracker:
    """Per-prompt running reward statistics -> normalized advantages
    (trl/trainer/utils.py, the same semantics)."""

    def __init__(self, buffer_size: int = 32, min_count: int = 16):
        self.buffer_size = buffer_size
        self.min_count = min_count
        self.stats: Dict[str, deque] = {}

    def update(self, prompts, rewards) -> np.ndarray:
        prompts = np.asarray(prompts)
        rewards = np.asarray(rewards, dtype=np.float64)
        advantages = np.empty_like(rewards)
        for prompt in np.unique(prompts):
            sel = prompts == prompt
            buf = self.stats.setdefault(str(prompt),
                                        deque(maxlen=self.buffer_size))
            buf.extend(rewards[sel])
            if len(buf) < self.min_count:
                mean, std = rewards.mean(), rewards.std() + 1e-6
            else:
                mean, std = np.mean(buf), np.std(buf) + 1e-6
            advantages[sel] = (rewards[sel] - mean) / std
        return advantages


def ddpo_loss(advantages, clip_range, ratio):
    """The clipped surrogate (ddpo_trainer.py)."""
    unclipped = -advantages * ratio
    clipped = -advantages * torch.clamp(ratio, 1.0 - clip_range,
                                        1.0 + clip_range)
    return torch.maximum(unclipped, clipped).mean()


class DDPOConfig(NamedTuple):
    clip_range: float = 1e-4
    adv_clip_max: float = 5.0
    eta: float = 1.0
    learning_rate: float = 3e-4
    max_grad_norm: float = 1.0


def make_ddpo_step(apply: Callable, alphas_cumprod,
                   cfg: DDPOConfig = DDPOConfig()):
    """Returns (init_opt, step), init_opt = train.adamw_state (the
    chain's state is adamw's): step(params, opt_state, batch) ->
    (params, opt_state, metrics), params a flat dict of tensors updated
    in place. The batch is one timestep of unpacked rollouts, as
    DDPOTrainer trains them: latents, next_latents, timesteps,
    prev_timesteps, old_logps, advantages, embeds."""
    def loss_fn(params, batch):
        eps = apply(params, batch["latents"], batch["timesteps"],
                    batch["embeds"])
        _, logp = ddim_step_logprob(
            eps, batch["timesteps"], batch["prev_timesteps"],
            batch["latents"], alphas_cumprod, cfg.eta,
            prev_sample=batch["next_latents"])
        adv = torch.clamp(batch["advantages"], -cfg.adv_clip_max,
                          cfg.adv_clip_max)
        ratio = torch.exp(logp - batch["old_logps"])
        loss = ddpo_loss(adv, cfg.clip_range, ratio)
        with torch.no_grad():
            metrics = {"loss": loss.detach(),
                       "approx_kl": 0.5 * ((logp - batch["old_logps"])
                                           ** 2).mean(),
                       "clipfrac": ((ratio - 1.0).abs() > cfg.clip_range)
                       .float().mean()}
        return loss, metrics

    def step(params: dict, opt_state: dict, batch: dict):
        names = list(params)
        live = {k: params[k].detach().requires_grad_() for k in names}
        loss, metrics = loss_fn(live, batch)
        grads = torch.autograd.grad(loss, [live[k] for k in names])
        with torch.no_grad():
            gn = torch.sqrt(sum(g.float().square().sum() for g in grads))
            keep = gn < cfg.max_grad_norm
            opt_state["count"] += 1
            for k, g in zip(names, grads):
                g = torch.where(keep, g.float(),
                                g.float() / gn * cfg.max_grad_norm)
                adamw_(params[k], g, opt_state["mu"][k],
                       opt_state["nu"][k], opt_state["count"],
                       cfg.learning_rate, weight_decay=1e-4)
        return params, opt_state, metrics

    return adamw_state, step
