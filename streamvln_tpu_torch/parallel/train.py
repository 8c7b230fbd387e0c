"""Training runtime of the port on one device: the optimizer with
per-module learning-rate groups, freezing, LoRA-only training, gradient
accumulation and remat, and the train step.

Counterpart of `streamvln_tpu/parallel/train.py` without the mesh (FSDP
is the parallelism slice). The optimizer is the JAX package's optax
chain written out:
- each trainable group runs `clip_by_global_norm` over its own grads
  (the clipping norm is per group, not global), then decoupled AdamW
  with the warmup-cosine schedule `warmup_cosine_decay_schedule(0, peak,
  warmup, max(total, warmup + 1))` evaluated at the group's count before
  the increment, so the first update has lr 0;
- frozen groups get no update (`set_to_zero`), and their params are set
  `requires_grad=False`, the counterpart of `stop_gradient`, so their
  grads are never computed;
- `grad_accum_steps = k > 1` is `optax.MultiSteps`: the running mean of
  k micro-step grads, and one inner update on every k-th call.
Params are updated in place (the JAX step returns new arrays); the
moments and the accumulator are f32.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, NamedTuple, Optional, Tuple

import torch

from streamvln_tpu_torch.configs import StreamVLNConfig, resolve_device
from streamvln_tpu_torch.models import streamvln
from streamvln_tpu_torch.models.lora import is_lora_path

LAYOUT_KEYS = ("token_ids", "is_vision", "vision_index", "labels", "valid")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Defaults mirror the reference run (scripts/streamvln_train_slurm.sh:
    55-68: lr 2e-5, tower lr 5e-6, cosine schedule, warmup 0.03)."""
    learning_rate: float = 2e-5
    vision_lr: Optional[float] = 5e-6
    projector_lr: Optional[float] = None   # None -> base lr
    weight_decay: float = 0.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    grad_clip: float = 1.0
    warmup_ratio: float = 0.03
    total_steps: int = 1000
    freeze_vision: bool = False
    freeze_projector: bool = False
    freeze_llm: bool = False
    lora_only: bool = False    # train only LoRA adapters (PEFT parity)
    # micro-batch accumulation (reference: bs 2 x grad-accum 2 per GPU)
    grad_accum_steps: int = 1
    # sequence-chunked cross-entropy (None = full-seq logits)
    loss_chunk_size: Optional[int] = 512
    remat: bool = True
    # nested remat: layers per outer checkpoint chunk (None = per layer)
    remat_chunk: Optional[int] = None
    # token-chunked MLP with per-chunk recompute
    mlp_chunk: Optional[int] = None
    attn_impl: str = "auto"


class TrainState(NamedTuple):
    step: int
    params: Any
    opt_state: Any


def tree_leaves(params, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, tensor) for every leaf of a params tree, with the JAX
    package's path strings ('llm/layers/q_w', 'projector/layers/0/w')."""
    if isinstance(params, dict):
        for k, v in params.items():
            yield from tree_leaves(v, f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(params, (list, tuple)):
        for i, v in enumerate(params):
            yield from tree_leaves(v, f"{prefix}/{i}" if prefix else str(i))
    else:
        yield prefix, params


def _label_params(params, lora_only: bool = False) -> Dict[str, str]:
    """{path: group}: 'lora'/'frozen' with lora_only, else the top-level
    module ('vision', 'projector', 'llm'; anything else counts as llm)."""
    def one(s):
        if lora_only:
            return "lora" if is_lora_path(s) else "frozen"
        top = s.split("/")[0]
        return top if top in ("vision", "projector", "llm") else "llm"
    return {path: one(path) for path, _ in tree_leaves(params)}


def _group_lrs(tcfg: TrainConfig) -> Dict[str, Optional[float]]:
    """Peak learning rate of each group; None for a frozen group."""
    if tcfg.lora_only:
        return {"lora": tcfg.learning_rate, "frozen": None}
    return {
        "vision": None if tcfg.freeze_vision
        else (tcfg.vision_lr or tcfg.learning_rate),
        "projector": None if tcfg.freeze_projector
        else (tcfg.projector_lr or tcfg.learning_rate),
        "llm": None if tcfg.freeze_llm else tcfg.learning_rate,
    }


def schedule(tcfg: TrainConfig, peak: float, count: int) -> float:
    """optax.warmup_cosine_decay_schedule(0, peak, warmup, max(total,
    warmup + 1)) at `count`: linear from 0 over the warmup, then a cosine
    to 0."""
    warmup = max(int(tcfg.total_steps * tcfg.warmup_ratio), 1)
    decay = max(tcfg.total_steps, warmup + 1) - warmup
    if count < warmup:
        return peak * count / warmup
    c = min(count - warmup, decay)
    return peak * 0.5 * (1.0 + math.cos(math.pi * c / decay))


def create_train_state(params, tcfg: TrainConfig) -> TrainState:
    """Mark each float leaf trainable or frozen (requires_grad) and make
    the optimizer state: per trainable group its count and f32 moments,
    and the grad accumulator when grad_accum_steps > 1."""
    labels = _label_params(params, tcfg.lora_only)
    lrs = _group_lrs(tcfg)
    groups: Dict[str, Any] = {}
    acc: Dict[str, torch.Tensor] = {}
    for path, t in tree_leaves(params):
        peak = lrs.get(labels[path])
        if not t.is_floating_point():
            continue
        t.requires_grad_(peak is not None)
        if peak is None:
            continue
        g = groups.setdefault(labels[path], {"count": 0, "peak": peak,
                                             "mu": {}, "nu": {}})
        g["mu"][path] = torch.zeros_like(t, dtype=torch.float32)
        g["nu"][path] = torch.zeros_like(t, dtype=torch.float32)
        if tcfg.grad_accum_steps > 1:
            acc[path] = torch.zeros_like(t, dtype=torch.float32)
    return TrainState(step=0, params=params,
                      opt_state={"mini_step": 0, "acc": acc,
                                 "groups": groups})


def _global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum(g.float().square().sum() for g in tensors))


@torch.no_grad()
def _apply_updates(params: Dict[str, torch.Tensor],
                   grads: Dict[str, torch.Tensor], groups: dict,
                   tcfg: TrainConfig) -> None:
    """One inner optimizer update, in place: per group clip by the group's
    global norm, Adam moments, decoupled weight decay, -lr(count)."""
    for g in groups.values():
        paths = list(g["mu"])
        gs = [grads[p].float() for p in paths]
        gn = _global_norm(gs)
        keep = gn < tcfg.grad_clip
        gs = [torch.where(keep, x, x / gn * tcfg.grad_clip) for x in gs]
        count = g["count"] + 1
        bc1, bc2 = 1.0 - tcfg.b1 ** count, 1.0 - tcfg.b2 ** count
        lr = schedule(tcfg, g["peak"], g["count"])
        for p, x in zip(paths, gs):
            mu, nu = g["mu"][p], g["nu"][p]
            mu.mul_(tcfg.b1).add_(x, alpha=1.0 - tcfg.b1)
            nu.mul_(tcfg.b2).addcmul_(x, x, value=1.0 - tcfg.b2)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + tcfg.eps)
            w = params[p]
            if tcfg.weight_decay:
                u = u + tcfg.weight_decay * w.float()
            w.copy_(w.float() + (-lr) * u)
        g["count"] = count


def make_train_step(cfg: StreamVLNConfig, tcfg: TrainConfig,
                    device="cuda"):
    """Returns step(state, batch) -> (state, {"loss", "grad_norm"}).

    batch: images [B, V, S, S, 3] (preprocessed) and the layout arrays
    token_ids/is_vision/vision_index/labels/valid [B, T] (numpy or
    tensors; moved to `device`). grad_norm is the global norm of this
    micro-step's grads over all leaves, frozen ones counting as 0."""
    device = resolve_device(device)

    def loss_fn(params, batch):
        T = batch["token_ids"].shape[1]
        chunk = tcfg.loss_chunk_size
        if chunk is not None and T % chunk != 0:
            chunk = None   # odd bucket: full-sequence loss
        loss, _ = streamvln.forward_train(
            params, cfg, batch["images"],
            {k: batch[k] for k in LAYOUT_KEYS}, attn_impl=tcfg.attn_impl,
            remat=tcfg.remat, loss_chunk_size=chunk,
            remat_chunk=tcfg.remat_chunk, mlp_chunk=tcfg.mlp_chunk)
        return loss

    def step(state: TrainState, batch: dict):
        batch = {k: torch.as_tensor(batch[k]).to(device)
                 for k in LAYOUT_KEYS + ("images",)}
        # pixels in the tower's compute dtype
        batch["images"] = batch["images"].to(
            state.params["vision"]["patch_w"].dtype)
        leaves = dict(tree_leaves(state.params))
        train = [p for p, t in leaves.items() if t.requires_grad]
        loss = loss_fn(state.params, batch)
        # leaves the loss does not reach (image_newline) get zero grads
        grads = {p: torch.zeros_like(leaves[p]) if g is None else g
                 for p, g in zip(train, torch.autograd.grad(
                     loss, [leaves[p] for p in train], allow_unused=True))}
        gnorm = _global_norm(grads.values())
        opt = state.opt_state
        k = tcfg.grad_accum_steps
        if k > 1:
            n = opt["mini_step"]
            with torch.no_grad():
                for p, g in grads.items():
                    acc = opt["acc"][p]
                    acc.add_((g.float() - acc) / (n + 1))
            if n < k - 1:
                opt["mini_step"] = n + 1
                return (TrainState(state.step + 1, state.params, opt),
                        {"loss": loss.detach(), "grad_norm": gnorm})
            grads = opt["acc"]
        _apply_updates(leaves, grads, opt["groups"], tcfg)
        if k > 1:
            opt["mini_step"] = 0
            for acc in opt["acc"].values():
                acc.zero_()
        return (TrainState(state.step + 1, state.params, opt),
                {"loss": loss.detach(), "grad_norm": gnorm})

    return step
