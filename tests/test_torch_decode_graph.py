"""The port's decode loop as the reference runs it, on the CPU: state the
decode steps read stays in place (so a CUDA graph captured from a step
keeps reading it), the step functions read nothing back to the host, and
the decoder's cache writes at offsets read on the device equal the JAX
package's (`streamvln_tpu/models/qwen2.py::_append_stack`).

Tolerances: logits and written cache slots atol 1e-4 (f32 summation
order, as tests/test_torch_modules.py); lengths, and slots a write must
leave as they were, exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamvln_tpu import configs as jcfg
from streamvln_tpu.models import qwen2 as jqwen2
from streamvln_tpu_torch import configs as tcfg
from streamvln_tpu_torch.data import chatml
from streamvln_tpu_torch.data.tokenizer import ByteTokenizer
from streamvln_tpu_torch.models import qwen2 as tqwen2
from streamvln_tpu_torch.streaming import engine as teng
from streamvln_tpu_torch.weights import init as init_weights

ATOL = 1e-4


@pytest.fixture(scope="module")
def tparams():
    return init_weights(tcfg.tiny_streamvln(),
                        torch.Generator().manual_seed(0), device="cpu",
                        dtype=torch.float32)


def _engine(tp, **kw):
    tok = ByteTokenizer()
    kw = dict(dict(stop_ids=(tok.im_end_id,), max_new_tokens=6,
                   cache_capacity=1024, buckets=(128, 512, 768),
                   compute_dtype=torch.float32, device="cpu"), **kw)
    return teng.StreamingEngine(tp, tcfg.tiny_streamvln(), **kw), tok


def _turn(tok, text, add_system):
    ids, _ = chatml.tokenize_dialogue(tok, [("user", text)],
                                      add_system=add_system,
                                      with_labels=False)
    return np.concatenate([ids, np.asarray(chatml.generation_prompt(tok),
                                           np.int32)])


def _storage(eng):
    t = [eng.cache.k, eng.cache.v, eng.cache.length]
    if eng.ids_buf is not None:
        t.append(eng.ids_buf)
    return [x.data_ptr() for x in t]


@pytest.mark.parametrize("spec", [0, 3])
def test_engine_state_keeps_its_storage(tparams, spec):
    """The cache's k, v and length and the token-id shadow keep their
    storage across greedy (or speculative) calls, a sampled call,
    continue_decode, the step-32-style window reset with its <memory>
    call, reset_episode and reset."""
    eng, tok = _engine(tparams, spec_lookup=spec)
    cfg = eng.cfg
    want = _storage(eng)
    rng = np.random.RandomState(spec)
    nf, nfs, nh = cfg.num_frames, cfg.num_future_steps, cfg.num_history
    for call in range(nf // nfs):
        frame = rng.randint(0, 255, (48, 64, 3), np.uint8)
        ids = _turn(tok, chatml.observation_prompt(
            None, "walk to the window" if call == 0 else ""), call == 0)
        temp = 0.7 if call == 1 else None
        assert eng.generate(0, frame, ids, step_id=call * nfs,
                            temperature=temp, top_p=0.9)
        assert _storage(eng) == want, f"call {call}"
        if call == 0:
            eng.continue_decode(0)
            eng.continue_decode(0, temperature=0.7, top_p=0.9)
            assert _storage(eng) == want, "continue_decode"
    eng.reset_for_env(0)
    assert _storage(eng) == want, "window reset"
    ids = _turn(tok, chatml.observation_prompt(
        None, "walk to the window These are your historical observations "
        "<memory>."), True)
    frame = rng.randint(0, 255, (48, 64, 3), np.uint8)
    assert eng.generate(0, frame, ids, step_id=nf,
                        history_steps=list(range(0, nf, nf // nh)))
    assert _storage(eng) == want, "<memory> call"
    assert eng.envs[0].kv_length == int(eng.cache.length[0])
    eng.reset_episode(0)
    assert _storage(eng) == want and int(eng.cache.length[0]) == 0
    eng.reset()
    assert _storage(eng) == want, "reset"


def _no_host_reads(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a decode step read a tensor back to the host")
    for name in ("item", "tolist", "cpu", "numpy", "__bool__", "__int__",
                 "__float__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)


@pytest.mark.parametrize("kind", ["token", "sample", "verify"])
def test_step_functions_read_nothing_back(tparams, monkeypatch, kind):
    """One greedy, one sampled and one speculative verify step run with
    every host read of a tensor patched to raise; each writes its state
    and the cache in place: the fed tokens' KV lands at the live row's
    length and the length advances (verify: by the emitted tokens)."""
    eng, tok = _engine(tparams, n_envs=2, spec_lookup=3)
    frame = np.random.RandomState(1).randint(0, 255, (48, 64, 3), np.uint8)
    ids = _turn(tok, chatml.observation_prompt(None, "go"), True)
    eng.generate(0, frame, ids, step_id=0)
    first = torch.tensor([7, 9], dtype=torch.int32)
    active = torch.tensor([True, False])
    stop = eng._stop()
    if kind == "verify":
        st = teng._spec_state(first, torch.tensor([5, 5]), eng.max_new, 3,
                              stop, ~active)
    else:
        st = teng._token_state(first, 1, eng.max_new, eng.max_new, stop,
                               ~active)
        if kind == "sample":
            st["temp"] = torch.tensor([0.7, 0.0])
            st["top_p"] = torch.tensor([0.9, 1.0])
    length0 = eng.cache.length.clone()
    k0 = eng.cache.k.clone()
    step = eng._step_fn(kind)
    with monkeypatch.context() as m:
        _no_host_reads(m)
        outs = step(st)
    S = 4 if kind == "verify" else 1
    assert outs["logits"].shape == (2, S, eng.cfg.llm.vocab_size)
    grew = eng.cache.length - length0
    if kind == "verify":
        assert grew[0] == st["n"][0] - 1 >= 1 and st["iters"].tolist() \
            == [1, 0]
    else:
        assert grew.tolist() == [1, 0] and st["n"].tolist() == [2]
    assert grew[1] == 0
    n0 = int(length0[0])
    assert not torch.equal(eng.cache.k[:, 0, :, n0], k0[:, 0, :, n0])
    torch.testing.assert_close(eng.cache.k[:, 1], k0[:, 1], rtol=0, atol=0)


@pytest.mark.parametrize("S", [1, 7, 128])
def test_device_offset_writes_match_jax(S):
    """qwen2.forward with a cache at uneven per-row lengths (B = 3), one
    idle row (write_mask False) whose length sits within S of the
    capacity, so its clamped write must hand back what it holds, for a
    decode step (S = 1), a speculative verify (S = 7) and a prefill
    bucket (S = 128): logits and the cache against the reference's
    forward, and the host-side guard refuses an active row that would
    overflow."""
    jc = jcfg.tiny_llm()
    tc = tcfg.tiny_llm()
    jp = jqwen2.init(jax.random.PRNGKey(2), jc)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a, copy=True)),
                      jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(S)
    B, cap = 3, 256
    shape = (jc.num_layers, B, jc.num_kv_heads, cap, jc.head_dim)
    k0 = rng.standard_normal(shape).astype(np.float32)
    v0 = rng.standard_normal(shape).astype(np.float32)
    lengths = np.asarray([3, min(cap - S, 90), cap - S // 2], np.int32)
    mask = np.asarray([True, True, False])
    new_len = np.where(mask, S, 0).astype(np.int32)
    emb = rng.standard_normal((B, S, jc.hidden_size)).astype(np.float32)
    pos = (lengths[:, None] + np.arange(S, dtype=np.int32)[None])

    jcache = jqwen2.KVCache(jnp.asarray(k0), jnp.asarray(v0),
                            jnp.asarray(lengths), None, None)
    jl, jcache = jqwen2.forward(
        jp, jc, jnp.asarray(emb), jnp.asarray(pos), cache=jcache,
        new_lengths=jnp.asarray(new_len), write_mask=jnp.asarray(mask))
    tcache = tqwen2.KVCache(torch.from_numpy(k0.copy()),
                            torch.from_numpy(v0.copy()),
                            torch.from_numpy(lengths.copy()))
    length_ptr = tcache.length.data_ptr()
    tcache.check_room(S, torch.from_numpy(mask))
    tl, _ = tqwen2.forward(tp, tc, torch.from_numpy(emb),
                           torch.from_numpy(pos), cache=tcache,
                           new_lengths=torch.from_numpy(new_len),
                           write_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=1e-4)
    assert tcache.length.data_ptr() == length_ptr
    np.testing.assert_array_equal(tcache.length.numpy(),
                                  np.asarray(jcache.length))
    for name, t0 in (("k", k0), ("v", v0)):
        tb, jb = getattr(tcache, name).numpy(), np.asarray(
            getattr(jcache, name))
        for b in range(B):
            lo, hi = int(lengths[b]), int(tcache.length[b])
            # untouched slots below the old length, exactly
            np.testing.assert_array_equal(tb[:, b, :, :lo], t0[:, b, :, :lo])
            np.testing.assert_array_equal(jb[:, b, :, :lo], t0[:, b, :, :lo])
            np.testing.assert_allclose(tb[:, b, :, lo:hi], jb[:, b, :, lo:hi],
                                       atol=ATOL, rtol=1e-4)
        # the idle row hands back every slot as it was
        np.testing.assert_array_equal(tb[:, 2], t0[:, 2])
    tcache.length.copy_(torch.from_numpy(lengths))
    tcache.length[1] = cap - S + 1
    with pytest.raises(RuntimeError, match="overflows capacity"):
        tcache.check_room(S, torch.from_numpy(mask))
    tcache.check_room(S, torch.from_numpy(np.asarray([True, False, False])))
