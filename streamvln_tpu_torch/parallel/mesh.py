"""Device mesh and parameter sharding of the port.

Counterpart of `streamvln_tpu/parallel/mesh.py`: a ("dp", "fsdp", "tp")
`DeviceMesh` over the ranks of the default process group, the same
per-leaf rules, and params stored as DTensors:

- "dp": pure data parallelism;
- "fsdp": ZeRO-3 storage of params and moments, and a data axis for the
  batch (rows over ("dp", "fsdp"), dp major, as JAX shards them);
- "tp": a storage axis for the largest matrices. Compute uses the
  gathered weights, so every "tp" rank of a data group computes the same
  rows (splitting the products over "tp" is ROADMAP §1b).

`param_specs` is a pure function of (leaf path, shape, mesh shape): each
leaf's spec is a tuple of axis names or None, padded to the leaf's rank
where a rule matched and () where none did, exactly JAX's PartitionSpec
as a tuple. A dimension is only sharded where the axis size divides it,
so every shard has the same shape.
"""
from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import torch

AXES = ("dp", "fsdp", "tp")

# (path regex, spec): the first match wins. Layer stacks carry a leading
# [L] axis that is never sharded.
_RULES: Tuple[Tuple[str, tuple], ...] = (
    # LLM stacks; int8/int4 storage keeps the names and the [L, din(/2),
    # dout] order, fused qkv_w/gu_w come from models/fuse.py
    (r"llm/layers/(q_w|k_w|v_w|gate_w|up_w|qkv_w|gu_w)$",
     (None, "fsdp", "tp")),
    (r"llm/layers/(o_w|down_w)$", (None, "tp", "fsdp")),
    (r"llm/layers/(q_b|k_b|v_b|qkv_b)$", (None, "tp")),
    # quantization scales follow their weight's output-dim sharding
    (r"llm/layers/(q_w|k_w|v_w|gate_w|up_w|qkv_w|gu_w)_scale$",
     (None, None, "tp")),
    (r"llm/layers/(o_w|down_w)_scale$", (None, None, "fsdp")),
    # MoE: experts on "tp", the products' dims on "fsdp"
    (r"llm/layers/(e_gate|e_up)$", (None, "tp", "fsdp", None)),
    (r"llm/layers/e_down$", (None, "tp", None, "fsdp")),
    (r"llm/layers/router_w$", (None, "fsdp", None)),
    (r"llm/layers/(s_gate_w|s_up_w)$", (None, "fsdp", "tp")),
    (r"llm/layers/s_down_w$", (None, "tp", "fsdp")),
    (r"llm/layers/s_route_w$", (None, "fsdp", None)),
    (r"llm/layers/", (None, None)),          # norms, LoRA stacks
    (r"llm/embed$", ("fsdp", "tp")),
    (r"llm/embed_scale$", ("fsdp", None)),
    (r"llm/lm_head$", ("fsdp", "tp")),
    (r"llm/lm_head_scale$", (None, "tp")),
    (r"llm/final_norm$", ()),
    # vision tower
    (r"vision/layers/(q_w|k_w|v_w|fc1_w)$", (None, None, "fsdp")),
    (r"vision/layers/(o_w|fc2_w)$", (None, "fsdp", None)),
    (r"vision/layers/", (None, None)),
    (r"vision/(patch_w|pos_embed)$", (None, "fsdp")),
    (r"vision/patch_b$", ()),
    # projector
    (r"projector/.*w$", (None, "fsdp")),
    (r"projector/", ()),
)


def map_tree(fn, tree, prefix: str = ""):
    """`tree` rebuilt with fn(path, leaf) at each leaf; dicts, lists and
    tuples are walked, paths joined by "/" as the JAX package joins
    them."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v, f"{prefix}/{i}" if prefix
                                   else str(i)) for i, v in enumerate(tree))
    return fn(prefix, tree)


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis: size} of a DeviceMesh, or of such a dict itself."""
    if isinstance(mesh, dict):
        return {a: int(mesh.get(a, 1)) for a in AXES}
    return {a: mesh.size(mesh.mesh_dim_names.index(a)) for a in AXES}


def make_mesh(dp: int = 1, fsdp: Optional[int] = None, tp: int = 1,
              device_type: Optional[str] = None):
    """A ("dp", "fsdp", "tp") DeviceMesh over the first dp*fsdp*tp ranks
    of the default process group; fsdp=None takes the rest of the world.
    Raises when the mesh needs more ranks than the world has (JAX asserts
    the same of its devices). device_type defaults to "cuda" under NCCL,
    else "cpu"."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    n = dist.get_world_size() if dist.is_initialized() else 1
    if fsdp is None:
        if n % (dp * tp):
            raise ValueError(f"world size {n} is not a multiple of "
                             f"dp*tp = {dp * tp}")
        fsdp = n // (dp * tp)
    need = dp * fsdp * tp
    if need > n:
        raise RuntimeError(f"a mesh of dp*fsdp*tp = {need} ranks "
                           f"(dp {dp}, fsdp {fsdp}, tp {tp}) needs more "
                           f"than the world size {n}")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(need).reshape(dp, fsdp, tp),
                      mesh_dim_names=AXES)


def _fit_spec(spec: tuple, shape, sizes: Dict[str, int]) -> tuple:
    """Drop sharding on dims the axis size does not divide (or of size 1
    axes), padding the spec to the leaf's rank."""
    out = []
    for i, axis in enumerate(tuple(spec) + (None,) * (len(shape) -
                                                      len(spec))):
        if axis is None:
            out.append(None)
            continue
        axes = axis if isinstance(axis, tuple) else (axis,)
        total = 1
        for a in axes:
            total *= sizes[a]
        out.append(axis if shape[i] % total == 0 and total > 1 else None)
    return tuple(out)


def leaf_spec(path: str, shape, mesh) -> tuple:
    """The spec of one leaf (see the module docstring)."""
    sizes = mesh_shape(mesh)
    for pat, spec in _RULES:
        if re.search(pat, path):
            return _fit_spec(spec, tuple(shape), sizes)
    return ()


def param_specs(params, mesh):
    """Tree of specs matching `params` (tensors or anything with a
    .shape); `mesh` a DeviceMesh or {axis: size}."""
    return map_tree(lambda path, leaf: leaf_spec(path, leaf.shape, mesh),
                    params)


def batch_spec() -> tuple:
    """Batch dims shard over the combined data axes."""
    return (("dp", "fsdp"),)


def placements(spec: tuple):
    """DTensor placements (one per mesh dim) of a spec: Shard(d) on the
    axis that names tensor dim d, Replicate elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate() for _ in AXES]
    for d, axis in enumerate(spec):
        if axis is not None:
            out[AXES.index(axis)] = Shard(d)
    return out


def _local_chunk(full: torch.Tensor, mesh, place) -> torch.Tensor:
    """This rank's shard of a full tensor that every rank holds (no
    communication): even chunks, as every sharded dim divides."""
    coord = mesh.get_coordinate()
    x = full
    for m, p in enumerate(place):
        if p.is_shard():
            x = x.chunk(mesh.size(m), dim=p.dim)[coord[m]]
    return x.contiguous()


def shard_params(params, mesh):
    """The params as DTensors on `mesh`, each placed by its spec. Every
    rank must hold the same full tree (made from one seed or one
    checkpoint); each keeps its own shard and the full tensors can be
    freed."""
    from torch.distributed.tensor import DTensor

    def one(path, t):
        if not isinstance(t, torch.Tensor):
            return t
        if isinstance(t, DTensor):
            t = t.full_tensor()
        place = placements(leaf_spec(path, t.shape, mesh))
        local = _local_chunk(t.detach(), mesh, place)
        return DTensor.from_local(local, mesh, place, run_check=False)
    return map_tree(one, params)


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def local(t):
    """The local shard of a DTensor (its storage), or t itself."""
    return t.to_local() if is_dtensor(t) else t


def full(t):
    """The whole tensor (all-gathered on every rank), or t itself."""
    return t.full_tensor() if is_dtensor(t) else t


def gather_tree(params):
    """A tree with every DTensor leaf gathered (collective: every rank of
    the mesh calls it); plain leaves as they are."""
    return map_tree(lambda p, t: full(t) if isinstance(t, torch.Tensor)
                    else t, params)


def scatter_into(t, src: torch.Tensor) -> None:
    """Copy a full tensor into a DTensor's local shard (or into t)."""
    if is_dtensor(t):
        local(t).copy_(_local_chunk(src, t.device_mesh, t.placements))
    else:
        t.copy_(src)


def replication(t) -> int:
    """How many ranks hold each element of t (1 for a plain tensor)."""
    if not is_dtensor(t):
        return 1
    n = 1
    for m, p in enumerate(t.placements):
        if not p.is_shard():
            n *= t.device_mesh.size(m)
    return n


def reduce_grad(g: torch.Tensor, like) -> torch.Tensor:
    """A full-shape gradient of this rank's rows, summed over the data
    ranks ("dp", "fsdp") and cut to `like`'s local shard: a
    reduce-scatter over an axis that shards `like`, an all-reduce over
    one that does not. The "tp" ranks of a data group computed the same
    rows and are not summed; where "tp" shards `like`, its chunk is
    taken."""
    import torch.distributed as dist
    mesh = like.device_mesh
    coord = mesh.get_coordinate()
    for m, (axis, p) in enumerate(zip(AXES, like.placements)):
        n = mesh.size(m)
        if n == 1:
            continue
        if axis == "tp":
            if p.is_shard():
                g = g.chunk(n, dim=p.dim)[coord[m]]
            continue
        group = mesh.get_group(axis)
        if not p.is_shard():
            g = g.contiguous()
            dist.all_reduce(g, group=group)
            continue
        front = g.movedim(p.dim, 0).contiguous()
        out = front.new_empty((front.shape[0] // n,) + front.shape[1:])
        dist.reduce_scatter_tensor(out, front, group=group)
        g = out.movedim(0, p.dim)
    return g.contiguous()


def local_rows(batch: dict, mesh) -> dict:
    """This rank's rows of a global batch (every value [B, ...]), rows over
    ("dp", "fsdp") dp major; B must divide by dp*fsdp, with the JAX
    step's error otherwise."""
    coord, sizes = mesh.get_coordinate(), mesh_shape(mesh)
    i, n = coord[0] * sizes["fsdp"] + coord[1], sizes["dp"] * sizes["fsdp"]
    B = next(iter(batch.values())).shape[0]
    if B % n != 0:
        raise ValueError(f"global batch size {B} must be divisible by "
                         f"dp*fsdp = {n}")
    r = B // n
    return {k: v[i * r:(i + 1) * r] for k, v in batch.items()}


def mesh_sum(x: torch.Tensor, mesh, axes=("dp", "fsdp")) -> torch.Tensor:
    """x summed over the mesh's `axes` (default the data ranks: the "tp"
    ranks of a data group hold the same value and count once)."""
    import torch.distributed as dist
    y = x.detach().clone()
    sizes = mesh_shape(mesh)
    for a in axes:
        if sizes[a] > 1:
            dist.all_reduce(y, group=mesh.get_group(a))
    return y
