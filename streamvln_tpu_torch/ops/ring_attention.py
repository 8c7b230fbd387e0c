"""Ring attention: sequence-parallel attention over a mesh axis.

Counterpart of `streamvln_tpu/ops/ring_attention.py`. The sequence is
sharded over a process group (the mesh's "fsdp" axis by default). Each
rank keeps its queries and, for as many steps as the group has ranks,
merges the online-softmax partial attention of its queries against the
visiting key/value chunk into f32 running (max, sum, value sum), then
passes the chunk (k, v and key positions) to the next rank of the ring
with `batch_isend_irecv`. After the last step every query has seen every
key once.

Visibility is the framework's position rule (key j visible to query i
iff k_pos[j] <= q_pos[i]; padded keys carry INVALID_POS). The block is
the JAX block's dense f32 math, kept as plain PyTorch: the JAX package
reaches no Pallas kernel here either (running the blocks through K3/K4/
K5 is ROADMAP §1b). A query row that sees no key gets the JAX block's
answer: its masked scores all equal -1e30, so p = 1 on every key and the
row's output is the mean of v over all keys.

Gradients flow as `jax.grad` flows through `fori_loop` + `ppermute`: the
rotation is an autograd Function whose backward sends the cotangent the
other way round the ring.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

NEG_INF = -1e30


def _block_attend(q, k, v, q_pos, k_pos, scale):
    """One query shard x key chunk: (row max [B, Hkv, G, Sq, 1], exp-weighted
    value sum [B, Hkv, G, Sq, D], exp sum [B, Hkv, G, Sq, 1]), f32."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    qf = q.float().reshape(B, Sq, Hkv, Hq // Hkv, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * scale
    mask = k_pos[:, None, None, None, :] <= q_pos[:, None, None, :, None]
    s = torch.where(mask, s, torch.full((), NEG_INF, device=s.device))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    return m, torch.einsum("bhgqk,bkhd->bhgqd", p, v.float()), \
        p.sum(dim=-1, keepdim=True)


def _ring_peers(group):
    """(global rank to send to, global rank to receive from, group size):
    the next and the previous rank of the ring."""
    import torch.distributed as dist
    n = dist.get_world_size(group)
    i = dist.get_rank(group)
    return (dist.get_global_rank(group, (i + 1) % n),
            dist.get_global_rank(group, (i - 1) % n), n)


def _exchange(x: torch.Tensor, send_to: int, recv_from: int, group):
    """Send x to `send_to` and return what `recv_from` sent, waiting on
    both requests (a ring that waits on its receive alone can hang at
    teardown)."""
    import torch.distributed as dist
    x = x.contiguous()
    out = torch.empty_like(x)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, x, send_to, group),
        dist.P2POp(dist.irecv, out, recv_from, group)])
    for r in reqs:
        r.wait()
    return out


class _Rotate(torch.autograd.Function):
    """A chunk to the next rank of the ring; its cotangent goes back to
    the previous one."""

    @staticmethod
    def forward(ctx, x, send_to, recv_from, group):
        ctx.peers = (send_to, recv_from, group)
        return _exchange(x, send_to, recv_from, group)

    @staticmethod
    def backward(ctx, g):
        send_to, recv_from, group = ctx.peers
        return _exchange(g, recv_from, send_to, group), None, None, None


def ring_attention(q, k, v, q_positions, k_positions, group=None,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Attention of this rank's shards over the whole ring.

    q [B, Sq_local, Hq, D]; k/v [B, Sk_local, Hkv, D]; q_positions
    [B, Sq_local], k_positions [B, Sk_local] (global ids); `group` the
    ring (default: the world). Returns [B, Sq_local, Hq, D] in q's
    dtype."""
    send_to, recv_from, n = _ring_peers(group)
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    m = torch.full((B, Hkv, G, Sq, 1), NEG_INF, device=q.device)
    l = torch.zeros((B, Hkv, G, Sq, 1), device=q.device)
    acc = torch.zeros((B, Hkv, G, Sq, D), device=q.device)
    kc, vc, kp = k, v, k_positions
    for i in range(n):
        bm, pv, bl = _block_attend(q, kc, vc, q_positions, kp, scale)
        m_new = torch.maximum(m, bm)
        a_old, a_blk = torch.exp(m - m_new), torch.exp(bm - m_new)
        l = l * a_old + bl * a_blk
        acc = acc * a_old + pv * a_blk
        m = m_new
        if i < n - 1:    # the last rotation would go unused
            kc = _Rotate.apply(kc, send_to, recv_from, group)
            vc = _Rotate.apply(vc, send_to, recv_from, group)
            kp = _exchange(kp, send_to, recv_from, group)
    out = acc / torch.where(l == 0.0, torch.ones_like(l), l)
    return torch.einsum("bhgqd->bqhgd", out).reshape(B, Sq, Hq, D) \
        .to(q.dtype)


def zigzag_permutation(S: int, n: int):
    """Zigzag sequence order: rank i holds chunks i and 2n-1-i, so the
    causal work balances across the ring. Returns (perm, inv_perm) index
    arrays of length S."""
    assert S % (2 * n) == 0, (S, n)
    c = S // (2 * n)
    order = []
    for i in range(n):
        order.append(np.arange(i * c, (i + 1) * c))
        j = 2 * n - 1 - i
        order.append(np.arange(j * c, (j + 1) * c))
    perm = np.concatenate(order)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(S)
    return perm, inv


def make_ring_attention(mesh, axis_name: str = "fsdp", zigzag: bool = False):
    """fn(q, k, v, q_pos, k_pos) on full tensors ([B, S, H, D], positions
    [B, S], S divisible by the axis size, every rank of the axis holding
    the same inputs): the sequence is sharded over the mesh axis, the
    shards attend over the ring and the output is all-gathered. zigzag
    reorders the sequence first (a pure permutation under position
    masking: the same result, balanced work). Forward only: gradients
    are ring_attention's on the shards."""
    import torch.distributed as dist
    group = mesh.get_group(axis_name)
    n = mesh.size(mesh.mesh_dim_names.index(axis_name))
    idx = dist.get_rank(group)

    def fn(q, k, v, q_pos, k_pos):
        S = q.shape[1]
        if zigzag:
            perm = torch.as_tensor(zigzag_permutation(S, n)[0],
                                   device=q.device)
            q, k, v, q_pos, k_pos = (x[:, perm] for x in
                                     (q, k, v, q_pos, k_pos))
        c = S // n
        sl = slice(idx * c, (idx + 1) * c)
        local = ring_attention(q[:, sl], k[:, sl], v[:, sl], q_pos[:, sl],
                               k_pos[:, sl], group).contiguous()
        parts = [torch.empty_like(local) for _ in range(n)]
        dist.all_gather(parts, local, group=group)
        out = torch.cat(parts, dim=1)
        if zigzag:
            inv = torch.as_tensor(zigzag_permutation(S, n)[1],
                                  device=q.device)
            out = out[:, inv]
        return out

    return fn


def ring_attention_dryrun(mesh) -> bool:
    """One zigzag ring attention over the mesh's "fsdp" axis against
    dense attention (2e-4); False when that axis has one rank."""
    from streamvln_tpu_torch.ops.attention import dense_attention
    n = mesh.size(mesh.mesh_dim_names.index("fsdp"))
    if n < 2:
        return False
    rng = np.random.RandomState(0)
    B, S, H, D = 1, 8 * n, 2, 8
    q, k, v = (torch.from_numpy(rng.randn(B, S, H, D).astype(np.float32))
               for _ in range(3))
    pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S)
    out = make_ring_attention(mesh, "fsdp", zigzag=True)(q, k, v, pos, pos)
    mask = pos[:, None, :] <= pos[:, :, None]
    torch.testing.assert_close(out, dense_attention(q, k, v, mask),
                               rtol=2e-4, atol=2e-4)
    return True
