"""The port's `chunked_attention` (ops/attention.py) against the JAX
package's on the CPU: forward and gradients on the same seeded inputs,
small blocks (q_block 16, k_block 32) at lengths that are not multiples of
them, G = 1 and 4, the soft cap on and off, INVALID_POS keys, a query that
sees no key (it gets the mean of v over the padded key blocks, as in the
reference), f32 and bf16; and one train step of the reference's 32k
configuration (tests/test_train_32k.py: attn_impl="chunked", remat, chunked
cross-entropy and MLP), port against JAX, at S = 4096 here and at 32768 in
the slow lane, as the reference marks its own.

Tolerances: f32 forward rtol 1e-5 / atol 1e-6 (f32 sums in another
order); f32 gradients and the train step the repo's gradient gate rtol
2e-4 / atol 2e-5 (tests/test_parallel.py:100-101); bf16 one bf16 ulp
(rtol 2^-7) + 1e-5: both sides round the same f32 value once.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamvln_tpu import configs as jcfg
from streamvln_tpu.models import streamvln as jsv
from streamvln_tpu.ops import attention as jattn
from streamvln_tpu.parallel import mesh as jmesh
from streamvln_tpu.parallel import train as jtrain
from streamvln_tpu_torch import configs as tcfg
from streamvln_tpu_torch.ops import attention as tattn
from streamvln_tpu_torch.ops.flash_attention import INVALID_POS
from streamvln_tpu_torch.parallel import train as ttrain
from streamvln_tpu_torch.weights import from_jax_params

ATOL, RTOL = 2e-5, 2e-4
TOL = {"float32": (1e-6, 1e-5), "bfloat16": (1e-5, 2.0 ** -7)}
IMAGE, IGNORE = -200, -100


def _inputs(seed, B, Sq, Sk, Hkv, G, D):
    """q/k/v/dout as f32 numpy; queries at positions Sk - Sq .. Sk - 1
    (a suffix, as a prefill over a prefix would be), keys at 0..Sk-1 with
    the last 5 of row 1 at INVALID_POS; query 3 of row 0 at -5, so it sees
    no key."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, Hkv * G, D), np.float32)
    k, v = (rng.standard_normal((B, Sk, Hkv, D), np.float32)
            for _ in range(2))
    dout = rng.standard_normal((B, Sq, Hkv * G, D), np.float32)
    q_pos = np.tile(np.arange(Sk - Sq, Sk, dtype=np.int32), (B, 1))
    q_pos[0, 3] = -5
    k_pos = np.tile(np.arange(Sk, dtype=np.int32), (B, 1))
    k_pos[1, -5:] = INVALID_POS
    return q, k, v, dout, q_pos, k_pos


def _jax(q, k, v, dout, q_pos, k_pos, dtype, **kw):
    jd = jnp.dtype(dtype)

    def f(q, k, v):
        return jattn.chunked_attention(q, k, v, jnp.asarray(q_pos),
                                       jnp.asarray(k_pos), **kw)
    args = tuple(jnp.asarray(x, jd) for x in (q, k, v))
    out, vjp = jax.vjp(f, *args)
    grads = vjp(jnp.asarray(dout, jd))
    return [np.asarray(x, np.float32) for x in (out, *grads)]


def _torch(q, k, v, dout, q_pos, k_pos, dtype, **kw):
    td = getattr(torch, dtype)
    args = [torch.from_numpy(x).to(td).requires_grad_() for x in (q, k, v)]
    out = tattn.chunked_attention(*args, torch.from_numpy(q_pos),
                                  torch.from_numpy(k_pos), **kw)
    grads = torch.autograd.grad(out, args, torch.from_numpy(dout).to(td))
    return [x.detach().float().numpy() for x in (out, *grads)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G,cap", [(1, None), (4, None), (4, 5.0)])
def test_chunked_attention_matches_jax(G, cap, dtype):
    data = _inputs(11, B=2, Sq=37, Sk=70, Hkv=2, G=G, D=8)
    kw = dict(logits_soft_cap=cap, q_block=16, k_block=32)
    want = _jax(*data, dtype, **kw)
    got = _torch(*data, dtype, **kw)
    atol, rtol = TOL[dtype] if dtype == "bfloat16" else (ATOL, RTOL)
    fwd_atol, fwd_rtol = TOL[dtype]
    np.testing.assert_allclose(got[0], want[0], atol=fwd_atol, rtol=fwd_rtol)
    for name, g, w in zip(("dq", "dk", "dv"), got[1:], want[1:]):
        np.testing.assert_allclose(g, w, atol=atol, rtol=rtol, err_msg=name)


def test_row_that_sees_no_key_is_the_mean_of_v():
    """Masked logits are the finite -1e30, so a query that sees no key
    weighs every key of the padded key blocks by 1: the mean of v over
    k_block slots, the padding's zeros included. Against dense attention
    where it sees keys."""
    q, k, v, _, q_pos, k_pos = _inputs(5, B=2, Sq=37, Sk=70, Hkv=2, G=2, D=8)
    t = [torch.from_numpy(x) for x in (q, k, v, q_pos, k_pos)]
    out = tattn.chunked_attention(*t, q_block=16, k_block=32).numpy()
    padded = 96                                # 70 keys in 3 blocks of 32
    mean = np.broadcast_to((v[0].sum(0) / padded)[:, None], (2, 2, 8))
    np.testing.assert_allclose(out[0, 3].reshape(2, 2, 8), mean,
                               rtol=1e-5, atol=1e-6)
    mask = torch.from_numpy(k_pos[:, None, :] <= q_pos[:, :, None])
    dense = tattn.dense_attention(*t[:3], mask).numpy()
    seen = mask.any(-1).numpy()
    np.testing.assert_allclose(out[seen], dense[seen], rtol=1e-5, atol=1e-6)
    # the reference's result on the same query
    want = _jax(q, k, v, np.zeros_like(q), q_pos, k_pos, "float32",
                q_block=16, k_block=32)[0]
    np.testing.assert_allclose(out[0, 3], want[0, 3], rtol=1e-5, atol=1e-6)


def _cfgs_32k():
    """tests/test_train_32k.py's configuration: the tiny tower and a
    one-head decoder of head dim 16 (no kernel takes it, so both packages
    run their chunked attention)."""
    jc = jcfg.StreamVLNConfig(
        vision=jcfg.tiny_vision(),
        llm=jcfg.Qwen2Config(
            vocab_size=128, hidden_size=16, intermediate_size=32,
            num_layers=1, num_heads=1, num_kv_heads=1, head_dim=16,
            rope_theta=1e6, max_position_embeddings=65536),
        num_frames=8, num_future_steps=2, num_history=2)
    tc = tcfg.StreamVLNConfig(
        vision=tcfg.SigLIPConfig(**dataclasses.asdict(jc.vision)),
        llm=tcfg.Qwen2Config(**dataclasses.asdict(jc.llm)),
        num_frames=8, num_future_steps=2, num_history=2)
    return jc, tc


def _steps_32k(S):
    """Two train steps of the 32k recipe on the reference test's layout
    (one image, labels on the second half of 400 tokens, padded to S),
    port against JAX: loss, grad norm and every param after each step."""
    jc, tc = _cfgs_32k()
    kw = dict(total_steps=2, remat=True, attn_impl="chunked",
              loss_chunk_size=2048, warmup_ratio=0.0, mlp_chunk=4096)
    jt, tt = jtrain.TrainConfig(**kw), ttrain.TrainConfig(**kw)
    mesh = jmesh.make_mesh(dp=1, fsdp=1, tp=1, devices=jax.devices()[:1])
    jp = jsv.init(jax.random.PRNGKey(0), jc)
    tstate = ttrain.create_train_state(
        from_jax_params(jax.tree.map(np.asarray, jp), tc, device="cpu"), tt)
    jstate = jtrain.create_train_state(jp, jt)
    jstep = jtrain.make_train_step(jc, jt, mesh)
    tstep = ttrain.make_train_step(tc, tt, device="cpu")

    ids = np.full((400,), 5, np.int32)
    ids[1] = IMAGE
    labels = np.where(np.arange(400) > 200, ids, IGNORE).astype(np.int32)
    layout = jsv.build_splice_layout(ids, jc, labels=labels, pad_to=S)
    batch = {k: v for k, v in jsv.stack_layouts([layout]).items()
             if k != "lengths"}
    IS = jc.vision.image_size
    batch["images"] = np.zeros((1, 1, IS, IS, 3), np.float32)
    for _ in range(2):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        tstate, tm = tstep(tstate, batch)
        assert np.isfinite(tm["loss"].item()) and tm["loss"].item() > 0
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=RTOL,
                                   atol=ATOL)
    want = {jmesh._path_str(p): np.asarray(x) for p, x in
            jax.tree_util.tree_flatten_with_path(jstate.params)[0]}
    for p, t in ttrain.tree_leaves(tstate.params):
        np.testing.assert_allclose(t.detach().numpy(), want[p], atol=ATOL,
                                   rtol=RTOL, err_msg=p)


def test_train_step_long_context_matches_jax():
    _steps_32k(4096)


@pytest.mark.slow
def test_train_step_32k_context_matches_jax():
    _steps_32k(32768)
