"""int4 weight-only serving in the port against the JAX package, on the
CPU in float32: the decoder forward (prefill and cached decode steps,
fused and unfused projections) and the streaming engine token for token
across a window reset and the <memory> call.

The config is kernel-eligible (every din and dout a multiple of 512), so
both sides take their int4 kernel paths: the JAX package's Pallas
kernels in interpret mode, the port's plain versions of K6 and K7.
Tolerance for logits: atol = rtol = 1e-4 (f32 summation order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamvln_tpu import configs as jcfg
from streamvln_tpu.models import fuse as jfuse
from streamvln_tpu.models import quant as jquant
from streamvln_tpu.models import qwen2 as jqwen2
from streamvln_tpu.models import streamvln as jsv
from streamvln_tpu.streaming.engine import StreamingEngine as JaxEngine
from streamvln_tpu_torch import configs as tcfg
from streamvln_tpu_torch.data import chatml
from streamvln_tpu_torch.data.tokenizer import ByteTokenizer
from streamvln_tpu_torch.models import qwen2 as tqwen2
from streamvln_tpu_torch.ops import int4_matmul as tint4
from streamvln_tpu_torch.streaming.engine import StreamingEngine
from streamvln_tpu_torch.weights import from_jax_params

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
ATOL = 1e-4


def eligible_llm():
    return jcfg.Qwen2Config(
        vocab_size=512, hidden_size=512, intermediate_size=512,
        num_layers=2, num_heads=4, num_kv_heads=4, head_dim=128,
        rope_theta=1e4, max_position_embeddings=4096)


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True))


@pytest.mark.parametrize("bits,fused", [(4, False), (4, True), (8, True)])
def test_qwen2_quantized_prefill_and_decode_match_jax(bits, fused):
    """A 136-token prefill (int4: rows > KERNEL_MAX_ROWS, the K7 path), an
    8-token chunk and two single-token steps (int4: the K6 path) into a KV
    cache: logits and the cache agree with JAX. int8 weights (and an int8
    embed) take the per-column-scale products."""
    jc = eligible_llm()
    tc = tcfg.Qwen2Config(**dataclasses.asdict(jc))
    q4 = jquant.quantize_llm({"llm": jqwen2.init(jax.random.PRNGKey(1), jc,
                                                 jnp.float32)},
                             bits=bits, quantize_embed=bits == 8)["llm"]
    if fused:
        q4 = jfuse.fuse_projections(q4)
    q4 = jax.tree.map(np.asarray, q4)
    tp = _t(q4)
    assert tp["lm_head"].dtype == (torch.uint8 if bits == 4 else torch.int8)
    assert ("qkv_w" in tp["layers"]) == fused
    rng = np.random.default_rng(2)
    B, cap = 1, 512
    emb = rng.standard_normal((B, 146, jc.hidden_size)).astype(np.float32)
    jcache = jqwen2.KVCache.create(jc, B, cap, jnp.float32)
    tcache = tqwen2.KVCache.create(tc, B, cap, torch.float32, "cpu")
    n6, n7 = tint4.launches, tint4.dequant_launches
    for lo, hi in ((0, 136), (136, 144), (144, 145), (145, 146)):
        pos = np.arange(lo, hi, dtype=np.int32)[None]
        jl, jcache = jqwen2.forward(q4, jc, jnp.asarray(emb[:, lo:hi]),
                                    jnp.asarray(pos), cache=jcache,
                                    attn_impl="dense")
        tl, _ = tqwen2.forward(tp, tc, torch.from_numpy(emb[:, lo:hi]),
                               torch.from_numpy(pos), cache=tcache,
                               attn_impl="dense")
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=1e-4)
    assert (tint4.launches, tint4.dequant_launches) == (n6, n7)
    np.testing.assert_allclose(tcache.k[:, :, :, :146].numpy(),
                               np.asarray(jcache.k[:, :, :, :146]),
                               atol=ATOL)


def _turn(tok, text, add_system):
    ids, _ = chatml.tokenize_dialogue(tok, [("user", text)],
                                      add_system=add_system,
                                      with_labels=False)
    return np.concatenate([ids, np.asarray(chatml.generation_prompt(tok),
                                           np.int32)])


def _assert_same_state(je, te):
    np.testing.assert_array_equal(te.cache.length.numpy(),
                                  np.asarray(je.cache.length))
    for a, b in zip(je.envs, te.envs):
        assert (a.kv_length, a.pending_token, a.next_slot, a.frame_slots) \
            == (b.kv_length, b.pending_token, b.next_slot, b.frame_slots)


def test_int4_engine_matches_jax_across_window_and_memory():
    """quantize_llm(bits=4) weights, fused by both engines (their
    default): one window of calls, the window reset, then the <memory>
    call, token for token with the same bookkeeping."""
    jc = dataclasses.replace(jcfg.tiny_streamvln(), llm=eligible_llm())
    tc = tcfg.StreamVLNConfig(
        vision=tcfg.SigLIPConfig(**dataclasses.asdict(jc.vision)),
        llm=tcfg.Qwen2Config(**dataclasses.asdict(jc.llm)),
        num_frames=jc.num_frames, num_future_steps=jc.num_future_steps,
        num_history=jc.num_history)
    jp = jax.tree.map(np.asarray, jquant.quantize_llm(
        jsv.init(jax.random.PRNGKey(0), jc), bits=4))
    tp = from_jax_params(jp, tc, device="cpu")
    tok = ByteTokenizer()
    kw = dict(stop_ids=(tok.im_end_id,), max_new_tokens=6,
              cache_capacity=2048, buckets=(128, 512, 768, 1024))
    je = JaxEngine(jp, jc, compute_dtype=jnp.float32, **kw)
    te = StreamingEngine(tp, tc, compute_dtype=torch.float32, device="cpu",
                         **kw)
    assert te.params["llm"]["layers"]["qkv_w"].dtype == torch.uint8
    assert "q_w" in tp["llm"]["layers"]           # the caller's tree
    rng = np.random.RandomState(0)
    nf, nfs, nh = tc.num_frames, tc.num_future_steps, tc.num_history
    for call in range(nf // nfs):
        frame = rng.randint(0, 255, (48, 64, 3), np.uint8)
        ids = _turn(tok, chatml.observation_prompt(
            None, "go to the red door" if call == 0 else ""), call == 0)
        got = te.generate(0, frame, ids, step_id=call * nfs)
        assert got == je.generate(0, frame, ids, step_id=call * nfs)
        _assert_same_state(je, te)
    je.reset_for_env(0)
    te.reset_for_env(0)
    frame = rng.randint(0, 255, (48, 64, 3), np.uint8)
    hist = list(range(0, nf, nf // nh))
    ids = _turn(tok, chatml.observation_prompt(
        None, "go to the red door You have visited these areas <memory>."),
        True)
    got = te.generate(0, frame, ids, step_id=nf, history_steps=hist)
    assert got and got == je.generate(0, frame, ids, step_id=nf,
                                      history_steps=hist)
    _assert_same_state(je, te)
