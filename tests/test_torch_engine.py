"""The port's StreamingEngine and VLNAgent against the JAX ones, token for
token, on tiny_streamvln in float32 on the CPU (JAX attn_impl "auto",
dense on the CPU), with the JAX init's weights carried across. After every
call the KV lengths and the per-env bookkeeping must agree too.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamvln_tpu.agent import VLNAgent as JaxAgent
from streamvln_tpu.configs import tiny_streamvln as jax_tiny
from streamvln_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from streamvln_tpu.models import streamvln as jsv
from streamvln_tpu.streaming.engine import StreamingEngine as JaxEngine
from streamvln_tpu_torch.agent import VLNAgent
from streamvln_tpu_torch.configs import tiny_streamvln
from streamvln_tpu_torch.data import chatml
from streamvln_tpu_torch.data.tokenizer import ByteTokenizer
from streamvln_tpu_torch.streaming.engine import StreamingEngine
from streamvln_tpu_torch.weights import from_jax_params

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
BUCKETS = (128, 512, 768, 1024)


@pytest.fixture(scope="module")
def params():
    jp = jsv.init(jax.random.PRNGKey(0), jax_tiny())
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tiny_streamvln(),
                         device="cpu")
    return jp, tp


def _engines(params, n_envs=1, max_new=6):
    jp, tp = params
    tok = ByteTokenizer()
    kw = dict(n_envs=n_envs, stop_ids=(tok.im_end_id,), max_new_tokens=max_new,
              cache_capacity=2048, buckets=BUCKETS)
    je = JaxEngine(jp, jax_tiny(), compute_dtype=jnp.float32, **kw)
    te = StreamingEngine(tp, tiny_streamvln(), compute_dtype=torch.float32,
                         device="cpu", **kw)
    return je, te, tok


def _assert_same_state(je, te):
    np.testing.assert_array_equal(te.cache.length.numpy(),
                                  np.asarray(je.cache.length))
    for a, b in zip(je.envs, te.envs):
        assert (a.kv_length, a.pending_token, a.next_slot, a.frame_slots) \
            == (b.kv_length, b.pending_token, b.next_slot, b.frame_slots)


def _turn(tok, text, add_system):
    ids, _ = chatml.tokenize_dialogue(tok, [("user", text)],
                                      add_system=add_system,
                                      with_labels=False)
    return np.concatenate([ids, np.asarray(chatml.generation_prompt(tok),
                                           np.int32)])


def test_engine_window_reset_and_memory_call_match_jax(params):
    """One window of calls, the window reset, then the <memory> boundary
    call (the reference's own engine trace pattern)."""
    je, te, tok = _engines(params)
    cfg = te.cfg
    rng = np.random.RandomState(0)
    nf, nfs, nh = cfg.num_frames, cfg.num_future_steps, cfg.num_history
    for call in range(nf // nfs):
        step = call * nfs
        frame = rng.randint(0, 255, (48, 64, 3), np.uint8)
        ids = _turn(tok, chatml.observation_prompt(
            None, "go to the red door" if call == 0 else ""), call == 0)
        assert te.generate(0, frame, ids, step_id=step) == \
            je.generate(0, frame, ids, step_id=step)
        _assert_same_state(je, te)
    je.reset_for_env(0)
    te.reset_for_env(0)
    _assert_same_state(je, te)
    frame = rng.randint(0, 255, (48, 64, 3), np.uint8)
    hist = list(range(0, nf, nf // nh))
    ids = _turn(tok, chatml.observation_prompt(
        None, "go to the red door You have visited these areas <memory>."),
        True)
    got = te.generate(0, frame, ids, step_id=nf, history_steps=hist)
    assert got == je.generate(0, frame, ids, step_id=nf, history_steps=hist)
    assert got
    _assert_same_state(je, te)


def test_agent_steps_match_jax_across_window_and_memory(params):
    """VLNAgent.step over 2 * num_frames + 1 steps: actions, text and the
    engine bookkeeping agree at every step, across both window resets and
    the <memory> calls (with history backfill)."""
    je, te, tok = _engines(params)
    ja = JaxAgent(je, JaxByteTokenizer())
    ta = VLNAgent(te, tok)
    cfg = te.cfg
    rng = np.random.RandomState(2)
    queue, calls = [], 0
    for step in range(2 * cfg.num_frames + 1):
        frame = rng.randint(0, 255, (48, 64, 3), np.uint8)
        run = not queue
        want = ja.step(0, frame, "move forward", run_model=run)
        got = ta.step(0, frame, "move forward", run_model=run)
        assert (got[0], got[2]) == (want[0], want[2]), step
        _assert_same_state(je, te)
        assert ta.step_id == ja.step_id and ta.in_dialogue == ja.in_dialogue
        if run:
            calls += 1
            queue = list(got[0])[:cfg.num_future_steps]
        if queue:
            queue.pop(0)
    assert calls > cfg.num_frames // cfg.num_future_steps


def test_idle_row_matches_jax(params):
    """2 envs, only env 0 active after both ran once: tokens, KV lengths
    and the idle env's feature-cache slot match JAX, and the idle row's
    KV length is untouched."""
    je, te, tok = _engines(params, n_envs=2)
    rng = np.random.RandomState(1)
    frames = [rng.randint(0, 255, (48, 64, 3), np.uint8) for _ in range(2)]
    t0 = _turn(tok, chatml.observation_prompt(None, "hello"), True)
    reqs = [(e, frames[e], t0, 0, ()) for e in range(2)]
    assert te.generate_batch(reqs) == je.generate_batch(reqs)
    _assert_same_state(je, te)
    idle_len = int(te.cache.length[1])
    slot = te.feat_cache[1, 0].clone()
    t1 = _turn(tok, chatml.observation_prompt(None, ""), False)
    reqs = [(0, frames[0], t1, 1, ())]
    assert te.generate_batch(reqs) == je.generate_batch(reqs)
    _assert_same_state(je, te)
    assert int(te.cache.length[1]) == idle_len
    assert torch.equal(te.feat_cache[1, 0], slot)
    np.testing.assert_allclose(te.feat_cache[:, :2].numpy(),
                               np.asarray(je.feat_cache[:, :2]), atol=1e-4)


def test_engine_refuses_overflow_and_sampling(params):
    _, te, tok = _engines(params)
    frame = np.zeros((48, 64, 3), np.uint8)
    with pytest.raises(ValueError, match="exceeds largest bucket"):
        te.generate(0, frame, np.asarray(tok.encode("x" * 1100), np.int32),
                    step_id=0)
    # sampled decoding is served now: a sampled call returns in-vocabulary
    # tokens and settles the same bookkeeping as a greedy one
    toks = te.generate(0, frame, _turn(tok, "hi", True), step_id=0,
                       temperature=0.7)
    assert toks and all(0 <= t < te.cfg.llm.vocab_size for t in toks)
    assert te.envs[0].kv_length == int(te.cache.length[0])


def test_cuda_entry_points_raise_without_a_card(params):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamingEngine(params[1], tiny_streamvln())
