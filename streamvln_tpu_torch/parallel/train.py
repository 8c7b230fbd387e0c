"""Training runtime of the port: the optimizer with per-module
learning-rate groups, freezing, LoRA-only training, gradient accumulation
and remat, and the train step, on one device or on a ("dp", "fsdp",
"tp") mesh (parallel/mesh.py).

Counterpart of `streamvln_tpu/parallel/train.py`. The optimizer is the
JAX package's optax chain written out:
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

On a mesh the params and moments are DTensors (mesh.shard_params), and a
step is the ZeRO-3 pattern: every leaf is all-gathered (frozen ones
under no_grad), each rank runs forward and backward on its rows of the
global batch, and each trainable leaf's gradient is summed over the data
ranks and cut to the leaf's shard (reduce-scatter). The kernels only
ever see the gathered plain tensors. The loss is normalized by the
global count of its items (valid labels for SFT), all-reduced before the
backward, so the mesh computes JAX's sum over the global batch divided
by the global count and not a mean of per-rank means. Clipping norms
are reduced over the shards; AdamW runs on the local shards, where each
moment lives with its parameter.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, NamedTuple, Optional, Tuple

import torch

from streamvln_tpu_torch.configs import StreamVLNConfig, resolve_device
from streamvln_tpu_torch.models import streamvln
from streamvln_tpu_torch.models.lora import is_lora_path
from streamvln_tpu_torch.parallel import mesh as mesh_lib
from streamvln_tpu_torch.utils.constants import IGNORE_INDEX

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


def _norm_fn(mesh):
    """norm(tensors, likes): the global norm of gradients (local shards on
    a mesh, where `likes` are their DTensor params: each element is
    counted once however many ranks hold it)."""
    if mesh is None:
        return lambda gs, likes: _global_norm(gs)

    def norm(gs, likes):
        sq = sum(g.float().square().sum() / mesh_lib.replication(t)
                 for g, t in zip(gs, likes))
        return torch.sqrt(mesh_lib.mesh_sum(
            torch.as_tensor(sq, dtype=torch.float32), mesh, mesh_lib.AXES))
    return norm


@torch.no_grad()
def adamw_(w: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
           nu: torch.Tensor, count: int, lr: float, b1: float = 0.9,
           b2: float = 0.999, eps: float = 1e-8,
           weight_decay: float = 0.0) -> None:
    """optax's adamw update of one leaf, in place: f32 moments mu/nu
    after `count` updates (this one included), bias-corrected, decoupled
    weight decay, w -= lr * u."""
    bc1, bc2 = 1.0 - b1 ** count, 1.0 - b2 ** count
    mu.mul_(b1).add_(g, alpha=1.0 - b1)
    nu.mul_(b2).addcmul_(g, g, value=1.0 - b2)
    u = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
    if weight_decay:
        u = u + weight_decay * w.float()
    w.copy_(w.float() + (-lr) * u)


@torch.no_grad()
def _apply_updates(params: Dict[str, torch.Tensor],
                   grads: Dict[str, torch.Tensor], groups: dict,
                   tcfg: TrainConfig, norm=None) -> None:
    """One inner optimizer update, in place: per group clip by the group's
    global norm, Adam moments, decoupled weight decay, -lr(count). On a
    mesh, grads are local shards and params/moments DTensors."""
    norm = norm or _norm_fn(None)
    local = mesh_lib.local
    for g in groups.values():
        paths = list(g["mu"])
        gs = [grads[p].float() for p in paths]
        gn = norm(gs, [params[p] for p in paths])
        keep = gn < tcfg.grad_clip
        gs = [torch.where(keep, x, x / gn * tcfg.grad_clip) for x in gs]
        lr = schedule(tcfg, g["peak"], g["count"])
        g["count"] += 1
        for p, x in zip(paths, gs):
            adamw_(local(params[p]), x, local(g["mu"][p]),
                   local(g["nu"][p]), g["count"], lr, tcfg.b1, tcfg.b2,
                   tcfg.eps, tcfg.weight_decay)


def adamw_state(params: dict) -> dict:
    """optax.adamw's state for a flat dict of tensors: the update count
    and f32 moments."""
    return {"count": 0,
            "mu": {k: torch.zeros_like(v, dtype=torch.float32)
                   for k, v in params.items()},
            "nu": {k: torch.zeros_like(v, dtype=torch.float32)
                   for k, v in params.items()}}


def to_device(batch: dict, keys, device, mesh=None) -> dict:
    """The batch's `keys` as tensors on `device`; on a mesh only this
    rank's rows (mesh.local_rows)."""
    batch = {k: torch.as_tensor(batch[k]) for k in keys}
    if mesh is not None:
        batch = mesh_lib.local_rows(batch, mesh)
    return {k: v.to(device) for k, v in batch.items()}


def value_and_grads(state: TrainState, loss_of, batch: dict, count,
                    mesh=None, extra=()):
    """Loss, metrics and gradients of the trainable leaves.

    loss_of(params, batch) -> (loss, {name: metric}) is this rank's mean
    over `count` items (a scalar tensor). On one device that is the
    result. On a mesh the leaves are gathered first, and the loss and
    metrics are weighted by count over the global count, so their sums
    over the data ranks are the global batch's means; each trainable
    leaf's grad is reduced to its shard (mesh.reduce_grad). `extra`
    tensors (a value head) are differentiated too, their grads summed
    over the data ranks. Returns (loss, metrics, {path: grad},
    [extra grads]); leaves the loss does not reach get zero grads."""
    leaves = dict(tree_leaves(state.params))
    train = [p for p, t in leaves.items() if t.requires_grad]
    params = state.params
    if mesh is not None:
        trainable = set(train)
        with torch.no_grad():
            params = mesh_lib.map_tree(
                lambda p, t: mesh_lib.full(t).detach().requires_grad_(
                    p in trainable) if isinstance(t, torch.Tensor) else t,
                params)
    use = dict(tree_leaves(params))
    loss, aux = loss_of(params, batch)
    if mesh is not None:
        total = mesh_lib.mesh_sum(torch.as_tensor(count, dtype=torch.float32,
                                                 device=loss.device), mesh)
        w = count / total.clamp(min=1)
        loss, aux = loss * w, {k: v * w for k, v in aux.items()}
    targets = [use[p] for p in train] + list(extra)
    got = torch.autograd.grad(loss, targets, allow_unused=True)
    got = [torch.zeros_like(t) if g is None else g
           for t, g in zip(targets, got)]
    grads = dict(zip(train, got[:len(train)]))
    extra_grads = got[len(train):]
    loss, aux = loss.detach(), {k: v.detach() for k, v in aux.items()}
    if mesh is not None:
        grads = {p: mesh_lib.reduce_grad(g, leaves[p])
                 for p, g in grads.items()}
        extra_grads = [mesh_lib.mesh_sum(g, mesh) for g in extra_grads]
        loss = mesh_lib.mesh_sum(loss, mesh)
        aux = {k: mesh_lib.mesh_sum(v, mesh) for k, v in aux.items()}
    return loss, aux, grads, extra_grads


def grad_norm(state: TrainState, grads: dict, mesh=None) -> torch.Tensor:
    """Global norm of one micro-step's grads (frozen leaves count 0)."""
    leaves = dict(tree_leaves(state.params))
    return _norm_fn(mesh)(list(grads.values()),
                          [leaves[p] for p in grads])


def apply_grads(state: TrainState, grads: dict, tcfg: TrainConfig,
                mesh=None) -> TrainState:
    """The optimizer's part of a step: with grad_accum_steps k > 1 the
    grads join the running mean and only every k-th call updates; else
    one update (_apply_updates). Returns the state a step later."""
    opt = state.opt_state
    k = tcfg.grad_accum_steps
    if k > 1:
        n = opt["mini_step"]
        with torch.no_grad():
            for p, g in grads.items():
                acc = mesh_lib.local(opt["acc"][p])
                acc.add_((g.float() - acc) / (n + 1))
        if n < k - 1:
            opt["mini_step"] = n + 1
            return TrainState(state.step + 1, state.params, opt)
        grads = {p: mesh_lib.local(a) for p, a in opt["acc"].items()}
    _apply_updates(dict(tree_leaves(state.params)), grads, opt["groups"],
                   tcfg, _norm_fn(mesh))
    if k > 1:
        opt["mini_step"] = 0
        for acc in opt["acc"].values():
            mesh_lib.local(acc).zero_()
    return TrainState(state.step + 1, state.params, opt)


def make_train_step(cfg: StreamVLNConfig, tcfg: TrainConfig,
                    device="cuda", mesh=None):
    """Returns step(state, batch) -> (state, {"loss", "grad_norm"}).

    batch: images [B, V, S, S, 3] (preprocessed) and the layout arrays
    token_ids/is_vision/vision_index/labels/valid [B, T] (numpy or
    tensors; moved to `device`). grad_norm is the global norm of this
    micro-step's grads over all leaves, frozen ones counting as 0. With a
    mesh, `batch` is the global batch, B divisible by dp*fsdp, and each
    rank takes its rows."""
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
        return loss, {}

    def step(state: TrainState, batch: dict):
        batch = to_device(batch, LAYOUT_KEYS + ("images",), device, mesh)
        # pixels in the tower's compute dtype
        batch["images"] = batch["images"].to(
            state.params["vision"]["patch_w"].dtype)
        # the loss is a mean over the supervised positions
        count = (batch["labels"][:, 1:] != IGNORE_INDEX).sum().float()
        loss, _, grads, _ = value_and_grads(state, loss_fn, batch, count,
                                            mesh)
        gnorm = grad_norm(state, grads, mesh)
        return (apply_grads(state, grads, tcfg, mesh),
                {"loss": loss, "grad_norm": gnorm})

    return step
