"""Prompt-lookup speculative decode and `continue_decode` in the port
against the JAX engine, on tiny_streamvln in float32 on the CPU, with the
JAX init's weights carried across: tokens, KV lengths, verify-forward
counts and the token-id shadow agree after every call, across multi-turn
calls, continue_decode chunks, a window reset and the <memory> call. Also
the port's speculative engine against its own greedy engine, an idle
capacity-full row, the overflow guard and int4 weights (K6's plain version
at spec_lookup + 1 rows).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamvln_tpu import configs as jcfg
from streamvln_tpu.models import quant as jquant
from streamvln_tpu.models import streamvln as jsv
from streamvln_tpu.streaming.engine import StreamingEngine as JaxEngine
from streamvln_tpu_torch import configs as tcfg
from streamvln_tpu_torch.data import chatml
from streamvln_tpu_torch.data.tokenizer import ByteTokenizer
from streamvln_tpu_torch.ops import int4_matmul as tint4
from streamvln_tpu_torch.streaming.engine import StreamingEngine, _draft
from streamvln_tpu_torch.weights import from_jax_params

torch.backends.cuda.matmul.allow_tf32 = False
BUCKETS = (128, 512, 768, 1024)


@pytest.fixture(scope="module")
def params():
    jp = jax.tree.map(np.asarray, jsv.init(jax.random.PRNGKey(0),
                                           jcfg.tiny_streamvln()))
    return jp, from_jax_params(jp, tcfg.tiny_streamvln(), device="cpu")


def _engines(jp, tp, jc, tc, **kw):
    tok = ByteTokenizer()
    kw = dict(dict(stop_ids=(tok.im_end_id,), max_new_tokens=8,
                   cache_capacity=2048, buckets=BUCKETS), **kw)
    je = JaxEngine(jp, jc, compute_dtype=jnp.float32, **kw)
    te = StreamingEngine(tp, tc, compute_dtype=torch.float32, device="cpu",
                         **kw)
    return je, te, tok


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
    assert (te.decode_tokens, te.decode_forwards) == \
        (je.decode_tokens, je.decode_forwards)
    if te.ids_buf is not None:
        jb = np.asarray(je.ids_buf)
        for row, n in enumerate(te.cache.length.tolist()):
            np.testing.assert_array_equal(te.ids_buf[row, :n].numpy(),
                                          jb[row, :n])


def _drive(je, te, tok, cfg, seed, chunks=2):
    """One window of calls with continue_decode chunks after the first,
    the window reset and the <memory> call; both engines in lockstep."""
    rng = np.random.RandomState(seed)
    nf, nfs, nh = cfg.num_frames, cfg.num_future_steps, cfg.num_history
    for call in range(nf // nfs):
        frame = rng.randint(0, 255, (48, 64, 3), np.uint8)
        ids = _turn(tok, chatml.observation_prompt(
            None, "walk to the window" if call == 0 else ""), call == 0)
        got = te.generate(0, frame, ids, step_id=call * nfs)
        assert got == je.generate(0, frame, ids, step_id=call * nfs), call
        _assert_same_state(je, te)
        for _ in range(chunks if call == 0 else 0):
            assert te.continue_decode(0) == je.continue_decode(0)
            _assert_same_state(je, te)
    je.reset_for_env(0)
    te.reset_for_env(0)
    frame = rng.randint(0, 255, (48, 64, 3), np.uint8)
    hist = list(range(0, nf, nf // nh))
    ids = _turn(tok, chatml.observation_prompt(
        None, "walk to the window These are your historical observations "
        "<memory>."), True)
    got = te.generate(0, frame, ids, step_id=nf, history_steps=hist)
    assert got and got == je.generate(0, frame, ids, step_id=nf,
                                      history_steps=hist)
    _assert_same_state(je, te)
    assert te.continue_decode(0) == je.continue_decode(0)
    _assert_same_state(je, te)


@pytest.mark.parametrize("spec", [4, 6])
def test_spec_engine_matches_jax(params, spec):
    je, te, tok = _engines(*params, jcfg.tiny_streamvln(),
                           tcfg.tiny_streamvln(), spec_lookup=spec)
    _drive(je, te, tok, te.cfg, seed=spec)
    # speculation ran: more tokens than verify forwards
    assert te.decode_tokens > te.decode_forwards > 0


def test_spec_engine_matches_own_greedy_and_chunks(params):
    """Speculation is greedy-exact, and generate + continue_decode chunks
    equal one generate with the larger budget."""
    tp = params[1]
    tok = ByteTokenizer()
    kw = dict(stop_ids=(tok.im_end_id,), cache_capacity=2048,
              buckets=BUCKETS, compute_dtype=torch.float32, device="cpu")
    cfg = tcfg.tiny_streamvln()
    greedy = StreamingEngine(tp, cfg, max_new_tokens=12, **kw)
    spec = StreamingEngine(tp, cfg, max_new_tokens=12, spec_lookup=6, **kw)
    chunked = StreamingEngine(tp, cfg, max_new_tokens=4, spec_lookup=6, **kw)
    rng = np.random.RandomState(9)
    for call in range(3):
        frame = rng.randint(0, 255, (48, 64, 3), np.uint8)
        ids = _turn(tok, chatml.observation_prompt(
            None, "turn left" if call == 0 else ""), call == 0)
        want = greedy.generate(0, frame, ids, step_id=2 * call)
        assert spec.generate(0, frame, ids, step_id=2 * call) == want
        got = chunked.generate(0, frame, ids, step_id=2 * call)
        while len(got) < len(want):
            got += chunked.continue_decode(0)
        assert got[:len(want)] == want
        for e in (spec, chunked):
            assert e.envs[0].kv_length == int(e.cache.length[0])
        if len(got) != len(want):
            break           # the chunked engine ran past the budget
    assert greedy.decode_forwards == greedy.decode_tokens


def _draft_loop(ids, length, p, c, k, trigram=True):
    """The drafting rule written as a loop over one row: the k ids after
    the most recent trigram match (ids[length-2], p, c) below length, else
    after the most recent bigram match (p, c), else -7s."""
    cap = len(ids)
    p2 = ids[min(max(length - 2, 0), cap - 1)]
    j2 = j3 = -1
    for i in range(min(length, cap)):
        prev1 = ids[i - 1] if i >= 1 else -2
        prev2 = ids[i - 2] if i >= 2 else -2
        if prev1 == p and ids[i] == c:
            j2 = i
            if trigram and prev2 == p2 and length >= 2:
                j3 = i
    j = j3 if j3 >= 0 else j2
    if j < 0:
        return [-7] * k
    start = min(max(j + 1, 0), cap - k)
    return list(ids[start:start + k])


def test_draft_matches_a_loop_reference():
    """The vectorized drafter equals the loop on shadows of a 3-symbol
    alphabet (many bigram matches whose trigram contexts differ), vision
    slots (-1), and lengths 0, 1, full and in between."""
    rng = np.random.default_rng(0)
    B, cap, k = 64, 48, 6
    ids = rng.integers(0, 3, (B, cap)).astype(np.int32)
    ids[rng.random((B, cap)) < 0.1] = -1
    length = rng.integers(0, cap + 1, B).astype(np.int32)
    length[:3] = (0, 1, cap)
    p = rng.integers(0, 3, B).astype(np.int32)
    c = rng.integers(0, 3, B).astype(np.int32)
    got = _draft(torch.from_numpy(ids), torch.from_numpy(length),
                 torch.from_numpy(p), torch.from_numpy(c), k).numpy()
    want = [_draft_loop(ids[b], int(length[b]), p[b], c[b], k)
            for b in range(B)]
    np.testing.assert_array_equal(got, np.asarray(want, np.int32))
    # the trigram preference decides some rows here
    assert any(want[b] != _draft_loop(ids[b], int(length[b]), p[b], c[b], k,
                                      trigram=False) for b in range(B))


def test_capacity_full_idle_row_shadow_survives_spec_loop(params):
    """A capacity-full idle row's token-id shadow (and length) come through
    another env's speculative call bit-identical (copy of the JAX
    package's test of the same name), and the active row's tokens, shadow
    and verify forwards equal the JAX engine's in the same state."""
    je, te, tok = _engines(*params, jcfg.tiny_streamvln(),
                           tcfg.tiny_streamvln(), n_envs=2,
                           max_new_tokens=4, cache_capacity=1024,
                           buckets=(512, 768), spec_lookup=3)
    rng = np.random.RandomState(4)
    frame = rng.randint(0, 255, (48, 64, 3), np.uint8)
    t0 = _turn(tok, chatml.observation_prompt(None, "hello"), True)
    reqs = [(e, frame, t0, 0, ()) for e in range(2)]
    assert te.generate_batch(reqs) == je.generate_batch(reqs)
    cap = te.cache.capacity
    marker = np.arange(cap, dtype=np.int32) % 7 + 100
    te.ids_buf[1] = torch.from_numpy(marker)
    te.cache.length[1] = cap
    je.ids_buf = je.ids_buf.at[1].set(jnp.asarray(marker))
    je.cache = type(je.cache)(je.cache.k, je.cache.v,
                              je.cache.length.at[1].set(cap),
                              je.cache.k_scale, je.cache.v_scale)
    t1 = _turn(tok, chatml.observation_prompt(None, ""), False)
    reqs = [(0, frame, t1, 1, ())]                        # env 1 idle
    assert te.generate_batch(reqs) == je.generate_batch(reqs)
    np.testing.assert_array_equal(te.ids_buf[1].numpy(), marker)
    assert int(te.cache.length[1]) == cap
    _assert_same_state(je, te)
    assert te.decode_forwards > 0


def _outcome(fn):
    try:
        return fn()
    except RuntimeError as err:
        assert "overflow" in str(err)
        return "refused"


def test_overflow_guard_refuses_where_jax_does(params):
    """The speculative headroom (max_new + spec_lookup) enters the overflow
    guard of calls and of continue_decode: on a cache sized so that only
    that headroom binds, both speculative engines refuse the same call
    that a greedy engine (same tokens, same lengths) still takes, and then
    the same continue_decode chunk."""
    jp, tp = params
    tok = ByteTokenizer()
    cfg = tcfg.tiny_streamvln()
    kw = dict(stop_ids=(tok.im_end_id,), max_new_tokens=24,
              buckets=(64, 128, 512), compute_dtype=torch.float32,
              device="cpu")
    turns = [_turn(tok, chatml.observation_prompt(
        None, "go" if c == 0 else ""), c == 0) for c in range(4)]
    frames = np.random.RandomState(5).randint(0, 255, (4, 48, 64, 3),
                                              np.uint8)
    probe = StreamingEngine(tp, cfg, cache_capacity=2048, **kw)
    for c in range(3):
        probe.generate(0, frames[c], turns[c], step_id=c)
    kv = probe.envs[0].kv_length
    n = probe._expanded_len([probe.envs[0].pending_token] + list(turns[3]))
    cap = kv + n + 31          # the spec scratch (24 + 6 -> 32) overflows
    assert cap >= kv + 64 and cap >= kv + n + 24    # bucket and greedy fit
    je, te, _ = _engines(jp, tp, jcfg.tiny_streamvln(), cfg, spec_lookup=6,
                         cache_capacity=cap, max_new_tokens=24,
                         buckets=(64, 128, 512))
    greedy = StreamingEngine(tp, cfg, cache_capacity=cap, **kw)
    for c in range(4):
        outs = [_outcome(lambda e=e: e.generate(0, frames[c], turns[c],
                                                step_id=c))
                for e in (je, te, greedy)]
        assert outs[0] == outs[1], c
        assert outs[1] == ("refused" if c == 3 else outs[2]), c
        _assert_same_state(je, te)
    assert outs[2] != "refused"
    for chunk in range(16):
        outs = [_outcome(lambda e=e: e.continue_decode(0))
                for e in (je, te)]
        assert outs[0] == outs[1], chunk
        _assert_same_state(je, te)
        if outs[0] == "refused":
            break
    assert outs[0] == "refused"


def test_int4_spec_engine_matches_jax():
    """quantize_llm(bits=4) weights on the kernel-eligible hidden-512
    config with spec_lookup=6: each verify forward sends 7 rows through
    every int4 projection (K6's plain version here, the Pallas kernel in
    interpret mode on the JAX side), token for token with JAX."""
    llm = jcfg.Qwen2Config(
        vocab_size=512, hidden_size=512, intermediate_size=512,
        num_layers=2, num_heads=4, num_kv_heads=4, head_dim=128,
        rope_theta=1e4, max_position_embeddings=4096)
    jc = dataclasses.replace(jcfg.tiny_streamvln(), llm=llm)
    tc = tcfg.StreamVLNConfig(
        vision=tcfg.SigLIPConfig(**dataclasses.asdict(jc.vision)),
        llm=tcfg.Qwen2Config(**dataclasses.asdict(jc.llm)),
        num_frames=jc.num_frames, num_future_steps=jc.num_future_steps,
        num_history=jc.num_history)
    jp = jax.tree.map(np.asarray, jquant.quantize_llm(
        jsv.init(jax.random.PRNGKey(0), jc), bits=4))
    tp = from_jax_params(jp, tc, device="cpu")
    je, te, tok = _engines(jp, tp, jc, tc, spec_lookup=6)
    n6 = tint4.launches
    _drive(je, te, tok, tc, seed=11, chunks=1)
    assert te.decode_forwards > 0 and tint4.launches == n6
