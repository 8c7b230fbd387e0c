"""Temperature / top-p sampling in the port's engine, on tiny_streamvln in
float32 on the CPU. The port draws from a torch.Generator, so its samples
are not jax.random's: its contract with the JAX package is the support of
the draw, the greedy gate (temperature <= 1e-3, or top_p = 0, is exact
greedy) and determinism by seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamvln_tpu.streaming.engine import _sample_tok as jax_sample_tok
from streamvln_tpu_torch.configs import tiny_streamvln
from streamvln_tpu_torch.data import chatml
from streamvln_tpu_torch.data.tokenizer import ByteTokenizer
from streamvln_tpu_torch.streaming.engine import (StreamingEngine, _nucleus,
                                                  _sample_tok)
from streamvln_tpu_torch.weights import init


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_streamvln()
    params = init(cfg, torch.Generator().manual_seed(0), device="cpu",
                  dtype=torch.float32)
    return cfg, params, ByteTokenizer()


def make_engine(cfg, params, tok, **kw):
    kw = dict(dict(compute_dtype=torch.float32, max_new_tokens=6,
                   cache_capacity=2048, buckets=(128, 256, 512, 768, 1024),
                   n_envs=1, device="cpu"), **kw)
    return StreamingEngine(params, cfg, stop_ids=(tok.im_end_id,), **kw)


def _turn(tok, text, add_system=True):
    ids, _ = chatml.tokenize_dialogue(tok, [("user", text)],
                                      add_system=add_system,
                                      with_labels=False)
    return np.concatenate([ids, np.asarray(chatml.generation_prompt(tok),
                                           np.int32)])


def _frame(seed=0):
    return np.random.RandomState(seed).randint(0, 255, (48, 64, 3), np.uint8)


@pytest.mark.parametrize("temperature,top_p", [(1e-4, 0.9), (1.0, 0.0)])
def test_greedy_gate_and_top_p_zero_equal_greedy(setup, temperature, top_p):
    """temperature <= 1e-3 takes the greedy path (HF's do_sample gate), and
    top_p = 0 keeps only the best token at any temperature: both equal a
    greedy call token for token, and for the speculative engine too."""
    cfg, params, tok = setup
    ids = _turn(tok, chatml.observation_prompt(None, "go forward"))
    for spec in (0, 6):
        greedy = make_engine(cfg, params, tok, spec_lookup=spec).generate(
            0, _frame(1), ids, step_id=0)
        got = make_engine(cfg, params, tok, spec_lookup=spec).generate(
            0, _frame(1), ids, step_id=0, temperature=temperature,
            top_p=top_p)
        assert got == greedy


def test_sampling_deterministic_by_seed(setup):
    """Same sample_seed and call order -> the same tokens; across seeds at
    high temperature the draws differ."""
    cfg, params, tok = setup
    ids = _turn(tok, chatml.observation_prompt(None, "explore"))

    def run(seed):
        eng = make_engine(cfg, params, tok)
        eng.sample_seed = seed
        return [eng.generate(0, _frame(2), ids, step_id=0, temperature=3.0,
                             top_p=1.0),
                eng.generate(0, _frame(3), _turn(tok, "", False), step_id=1,
                             temperature=3.0, top_p=1.0)]

    a = run(7)
    assert a == run(7)
    assert a[0] != a[1] or len(a[0]) > 1
    assert any(run(s) != a for s in (0, 1, 2))
    assert all(0 <= t < cfg.llm.vocab_size for call in a for t in call)


def test_per_env_rows_mix_greedy_and_sampled(setup):
    """{env: temperature} in one batch: the temperature-0 row equals a
    greedy engine's row exactly, the sampled row draws in-vocabulary."""
    cfg, params, tok = setup
    ids = _turn(tok, chatml.observation_prompt(None, "go to the door"))
    reqs = [(0, _frame(3), ids, 0, ()), (1, _frame(4), ids, 0, ())]
    g = make_engine(cfg, params, tok, n_envs=2).generate_batch(reqs)
    mixed = make_engine(cfg, params, tok, n_envs=2)
    m = mixed.generate_batch(reqs, temperature={0: 0.0, 1: 3.0},
                             top_p={1: 1.0})
    assert m[0] == g[0]
    assert all(0 <= t < cfg.llm.vocab_size for t in m[1])
    assert [e.kv_length for e in mixed.envs] == \
        mixed.cache.length.tolist()


def test_continue_decode_sampling_keeps_bookkeeping(setup):
    """generate + continue_decode chunks under sampling: deterministic by
    seed, KV lengths and the host shadow agree after each chunk, and a
    speculative engine's token-id shadow records every fed token."""
    cfg, params, tok = setup

    def run(seed, spec):
        eng = make_engine(cfg, params, tok, max_new_tokens=2,
                          buckets=(512, 768), spec_lookup=spec)
        eng.stop_ids = ()           # keep decoding past im_end
        eng.sample_seed = seed
        ids = _turn(tok, chatml.observation_prompt(None, "go on"))
        toks = list(eng.generate(0, _frame(5), ids, step_id=0,
                                 temperature=2.0, top_p=0.95))
        for _ in range(2):
            toks += eng.continue_decode(0, temperature=2.0, top_p=0.95)
            assert eng.envs[0].kv_length == int(eng.cache.length[0])
        assert eng.decode_tokens == eng.decode_forwards == 3
        if spec:
            # every fed token (all but the pending last one) is in the
            # shadow, right below the row's length
            n = int(eng.cache.length[0])
            assert eng.ids_buf[0, n - len(toks) + 1:n].tolist() == toks[:-1]
        return toks

    for spec in (0, 4):
        a = run(11, spec)
        assert a == run(11, spec) and len(a) == 6
        assert all(0 <= t < cfg.llm.vocab_size for t in a)


def _hf_top_p_keep(logits, top_p):
    """numpy HF TopPLogitsWarper: sort ascending (stable, as torch's sort
    orders these ties), drop the prefix whose cumulative probability is
    <= 1 - top_p, always keep the best."""
    order = np.argsort(logits, axis=-1, kind="stable")
    srt = np.take_along_axis(logits, order, -1).astype(np.float64)
    pr = np.exp(srt - srt.max(-1, keepdims=True))
    pr /= pr.sum(-1, keepdims=True)
    drop = np.cumsum(pr, -1) <= 1 - top_p
    drop[..., -1] = False
    keep = np.zeros_like(drop)
    np.put_along_axis(keep, order, ~drop, -1)
    return keep


def test_top_p_support_matches_hf_and_contains_every_jax_draw():
    """On fixed logits the port's nucleus keeps as many tokens as HF's
    TopPLogitsWarper, the very same ones where the cutoff splits no tie;
    where it splits a tie both the port and the JAX package keep the lower
    token ids of it (HF the higher ones). Every draw of the JAX
    `_sample_tok` over 64 keys, and of the port's sampler over 64 seeds,
    falls inside the port's support."""
    rng = np.random.RandomState(0)
    free = rng.randn(4, 64).astype(np.float32) * 3.0
    tied = np.round(rng.randn(4, 64) * 1.5).astype(np.float32)  # ties
    splits = 0
    for logits, has_ties in ((free, False), (tied, True)):
        for top_p in (0.1, 0.5, 0.9, 0.999):
            tp = torch.full((4,), top_p)
            keep = torch.isfinite(_nucleus(torch.from_numpy(logits),
                                           torch.ones(4), tp)).numpy()
            hf = _hf_top_p_keep(logits, top_p)
            np.testing.assert_array_equal(keep.sum(-1), hf.sum(-1))
            if not has_ties:
                np.testing.assert_array_equal(keep, hf)
            for row in range(4):
                split = keep[row] != hf[row]
                if split.any():     # one tie group, cut at its id order
                    splits += 1
                    vals = logits[row][split]
                    assert np.all(vals == vals[0])
                    ids = np.nonzero(split)[0]
                    assert ids[keep[row][split]].max() < \
                        ids[hf[row][split]].min()
            for key in range(64):
                t = np.asarray(jax_sample_tok(
                    jnp.asarray(logits), jnp.ones((4,), jnp.float32),
                    jnp.full((4,), top_p, jnp.float32),
                    jax.random.PRNGKey(key)))
                assert keep[np.arange(4), t].all(), (top_p, key)
            for seed in range(64):
                t = _sample_tok(torch.from_numpy(logits), torch.ones(4), tp,
                                torch.Generator().manual_seed(seed)).numpy()
                assert keep[np.arange(4), t].all(), (top_p, seed)
    assert splits > 0
