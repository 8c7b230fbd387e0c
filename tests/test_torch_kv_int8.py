"""The int8 KV cache of the port against the JAX package's, on the CPU:
`_quantize_kv` / `_dequant_kv` bit for bit, the scale-folded
`dense_attention_kvmajor` (and, on a split of the same keys, the
reference decode loop's two-source form), the cache's layout and bytes,
`reset_rows`, the decoder's prefill and decode steps into an int8 cache,
the `kv_int8` engine token for token across a window reset and the
<memory> call (greedy and speculative), and `eval_cli --kv_int8
--vision_int8` result lines against the JAX `eval_cli` on one checkpoint
of steered tiny weights.

Tolerances: the quantizer is bit-equal (the same f32 arithmetic, round
half to even). Attention in f32 is held to 1e-5 |ref| + 1e-6 (f32 sums
in another order); the port's bf16 call against JAX's f32 call on the
same bf16 queries to 2^-8 (|ref| + sum_k p_k |v_k|) (the port rounds
each p * v_scale and its output to bf16 once). Decoder logits: atol = rtol =
1e-4; the scales rtol 1e-4, and the int8 codes at most one step apart
in at most 1e-3 of the entries (a K or V value an f32 ulp from a
rounding boundary, summed in another order, can round the other way).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamvln_tpu import configs as jcfg
from streamvln_tpu.models import qwen2 as jqwen2
from streamvln_tpu.models import streamvln as jsv
from streamvln_tpu.ops import attention as jattn
from streamvln_tpu.streaming.engine import StreamingEngine as JaxEngine
from streamvln_tpu_torch import configs as tcfg
from streamvln_tpu_torch.data import chatml
from streamvln_tpu_torch.data.tokenizer import ByteTokenizer
from streamvln_tpu_torch.models import qwen2 as tqwen2
from streamvln_tpu_torch.ops import attention as tattn
from streamvln_tpu_torch.streaming.engine import StreamingEngine
from streamvln_tpu_torch.weights import from_jax_params

torch.backends.cuda.matmul.allow_tf32 = False
BUCKETS = (128, 512, 768, 1024)


def test_quantize_and_dequant_kv_bit_equal_to_jax():
    """Per (token, head) amax / 127 scales, round half to even, the clip,
    an all-zero head (scale 1) and values exactly halfway between two
    codes; the inverse in f32 and bf16."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    x[0, 1, 2] = 0.0
    x[1, 0, 0] = np.arange(16, dtype=np.float32) - 7.5   # halfway codes
    x[1, 0, 0, 0] = 127.0 / 2 * 0.5                    # amax 31.75
    for dt in (np.float32, jnp.bfloat16):
        xj = jnp.asarray(x).astype(dt)
        jq, js = jqwen2._quantize_kv(xj)
        tq, ts = tqwen2._quantize_kv(torch.from_numpy(
            np.asarray(xj.astype(jnp.float32))).to(
                torch.float32 if dt is np.float32 else torch.bfloat16))
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    buf = np.asarray(jq).transpose(0, 2, 1, 3)       # [B, H, S, D]
    sc = np.asarray(js).transpose(0, 2, 1)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        want = jqwen2._dequant_kv(jnp.asarray(buf), jnp.asarray(sc), jdt)
        got = tqwen2._dequant_kv(torch.from_numpy(buf), torch.from_numpy(sc),
                                 tdt)
        np.testing.assert_array_equal(
            got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def _int8_kv(rng, B, H, S, D):
    x = rng.standard_normal((B, S, H, D)).astype(np.float32)
    q, s = jqwen2._quantize_kv(jnp.asarray(x))
    return (np.asarray(q).transpose(0, 2, 1, 3),
            np.asarray(s).transpose(0, 2, 1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scale_folded_attention_matches_jax(dtype):
    """dense_attention_kvmajor with k_scale / v_scale against JAX's over a
    GQA cache with masked slots and a soft cap, and against JAX's
    dense_attention_kvmajor_2src over the same keys split into a cache
    and a scratch part: the port's single-source call over its in-place
    cache stands for the reference loop's two sources. XLA on the CPU has
    no bf16 x bf16 -> f32 product, so the bf16 case holds the port's bf16
    call against JAX's f32 call on the same bf16-valued queries."""
    rng = np.random.default_rng(1)
    B, Hq, Hkv, Sq, Sk, D = 2, 4, 2, 3, 40, 16
    k, ks = _int8_kv(rng, B, Hkv, Sk, D)
    v, vs = _int8_kv(rng, B, Hkv, Sk, D)
    q = rng.standard_normal((B, Sq, Hq, D)).astype(np.float32)
    q_pos = np.array([[30, 31, 32], [10, 11, 12]], np.int32)
    mask = np.arange(Sk)[None, None, :] <= q_pos[:, :, None]
    tdt = getattr(torch, dtype)
    qt = torch.from_numpy(q).to(tdt)
    qj = jnp.asarray(qt.float().numpy())
    for cap in (None, 5.0):
        want = jattn.dense_attention_kvmajor(
            qj, jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
            logits_soft_cap=cap, k_scale=jnp.asarray(ks),
            v_scale=jnp.asarray(vs))
        got = tattn.dense_attention_kvmajor(
            qt, torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(mask), logits_soft_cap=cap,
            k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
        assert got.dtype == tdt
        if dtype == "float32":
            tol = 1e-6 + 1e-5 * np.abs(np.asarray(want))
        else:
            # sum_k p_k |v_k|: what one bf16 rounding of each p * v_scale
            # can move the output by, 2^-8 of it, plus the output's own
            # rounding
            spv = tattn.dense_attention_kvmajor(
                qt.float(), torch.from_numpy(k), torch.from_numpy(v).abs(),
                torch.from_numpy(mask), logits_soft_cap=cap,
                k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
            tol = 2.0 ** -8 * (spv.numpy() + np.abs(np.asarray(want)))
        for ref in (want, None):
            if ref is None:
                cut = 24
                ref = jattn.dense_attention_kvmajor_2src(
                    qj, jnp.asarray(k[:, :, :cut]),
                    jnp.asarray(v[:, :, :cut]),
                    jnp.asarray(mask[..., :cut]), jnp.asarray(k[:, :, cut:]),
                    jnp.asarray(v[:, :, cut:]), jnp.asarray(mask[..., cut:]),
                    logits_soft_cap=cap,
                    kv_scales1=(jnp.asarray(ks[..., :cut]),
                                jnp.asarray(vs[..., :cut])),
                    kv_scales2=(jnp.asarray(ks[..., cut:]),
                                jnp.asarray(vs[..., cut:])))
            err = np.abs(got.float().numpy() - np.asarray(ref))
            assert (err <= tol).all(), (err - tol).max()


def test_quantized_cache_layout_bytes_and_reset():
    """int8 k/v, f32 scales [L, B, Hkv, Smax] of ones (no trailing
    singleton), the quantized flag; at head dim 128 the cache takes
    (128 + 4) / 256 of a bf16 cache's bytes; reset_rows keeps the values
    and scales and zeroes only the selected lengths."""
    cfg = tcfg.tiny_llm()
    c = tqwen2.KVCache.create(cfg, 2, 64, torch.float32, "cpu",
                              quantized=True)
    j = jqwen2.KVCache.create(jcfg.tiny_llm(), 2, 64, jnp.float32,
                              quantized=True)
    assert c.quantized and c.k.dtype == c.v.dtype == torch.int8
    for t, jt in ((c.k, j.k), (c.v, j.v), (c.k_scale, j.k_scale),
                  (c.v_scale, j.v_scale)):
        assert tuple(t.shape) == jt.shape
        np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    assert c.k_scale.shape == c.k.shape[:-1]
    assert c.k_scale.dtype == torch.float32 and bool((c.v_scale == 1).all())
    assert not tqwen2.KVCache.create(cfg, 2, 64, torch.float32,
                                     "cpu").quantized
    wide = tcfg.Qwen2Config(**{**tcfg.tiny_llm().__dict__, "head_dim": 128})
    q8 = tqwen2.KVCache.create(wide, 1, 512, torch.bfloat16, "cpu",
                               quantized=True)
    bf = tqwen2.KVCache.create(wide, 1, 512, torch.bfloat16, "cpu")

    def nbytes(cache):
        return sum(t.numel() * t.element_size() for t in
                   (cache.k, cache.v, cache.k_scale, cache.v_scale)
                   if t is not None)
    assert nbytes(q8) / nbytes(bf) == (128 + 4) / 256
    c.k.fill_(3)
    c.k_scale.fill_(0.5)
    c.length.copy_(torch.tensor([9, 5], dtype=torch.int32))
    c.reset_rows(torch.tensor([True, False]))
    assert c.length.tolist() == [0, 5] and c.quantized
    assert bool((c.k == 3).all()) and bool((c.k_scale == 0.5).all())


def test_int8_cache_decoder_matches_jax():
    """tiny_llm in f32: a 72-token prefill (S >= 64: the layer's cache
    dequantized, then dense attention), a 7-token chunk and two
    single-token steps (S < 64: the scale-folded attention) into an int8
    cache at B = 2 with uneven lengths and an idle row (write_mask):
    logits, lengths, the int8 codes and the scales against JAX."""
    jc = jcfg.tiny_llm()
    tc = tcfg.tiny_llm()
    jp = jax.tree.map(np.asarray, jqwen2.init(jax.random.PRNGKey(3), jc,
                                              jnp.float32))
    tp = {k: ({kk: torch.from_numpy(np.array(vv)) for kk, vv in v.items()}
              if isinstance(v, dict) else torch.from_numpy(np.array(v)))
          for k, v in jp.items()}
    rng = np.random.default_rng(4)
    B, cap = 2, 128
    jcache = jqwen2.KVCache.create(jc, B, cap, jnp.float32, quantized=True)
    tcache = tqwen2.KVCache.create(tc, B, cap, torch.float32, "cpu",
                                   quantized=True)
    start = np.array([0, 3], np.int32)
    jcache = jqwen2.KVCache(jcache.k, jcache.v, jnp.asarray(start),
                            jcache.k_scale, jcache.v_scale)
    tcache.length.copy_(torch.from_numpy(start))
    steps = [(72, None), (7, None), (1, np.array([True, False])),
             (1, None)]
    for S, wm in steps:
        emb = rng.standard_normal((B, S, jc.hidden_size)).astype(np.float32)
        pos = np.asarray(tcache.length)[:, None] + np.arange(S)[None]
        pos = pos.astype(np.int32)
        jl, jcache = jqwen2.forward(
            jp, jc, jnp.asarray(emb), jnp.asarray(pos), cache=jcache,
            write_mask=None if wm is None else jnp.asarray(wm),
            new_lengths=None if wm is None else jnp.asarray(wm * S,
                                                           jnp.int32))
        tl, _ = tqwen2.forward(
            tp, tc, torch.from_numpy(emb), torch.from_numpy(pos),
            cache=tcache,
            write_mask=None if wm is None else torch.from_numpy(wm),
            new_lengths=None if wm is None else torch.from_numpy(
                (wm * S).astype(np.int32)))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)
        np.testing.assert_array_equal(tcache.length.numpy(),
                                      np.asarray(jcache.length))
    n = int(tcache.length.max())
    for name in ("k_scale", "v_scale"):
        np.testing.assert_allclose(
            getattr(tcache, name)[..., :n].numpy(),
            np.asarray(getattr(jcache, name))[..., :n], rtol=1e-4)
    for name in ("k", "v"):
        got = getattr(tcache, name)[:, :, :, :n].numpy().astype(np.int32)
        want = np.asarray(getattr(jcache, name))[:, :, :, :n].astype(
            np.int32)
        assert np.abs(got - want).max() <= 1
        assert (got != want).mean() <= 1e-3, name


def _jax_and_port_engines(jp, tp, **kw):
    tok = ByteTokenizer()
    kw = dict(dict(stop_ids=(tok.im_end_id,), max_new_tokens=8,
                   cache_capacity=2048, buckets=BUCKETS, kv_int8=True), **kw)
    je = JaxEngine(jp, jcfg.tiny_streamvln(), compute_dtype=jnp.float32, **kw)
    te = StreamingEngine(tp, tcfg.tiny_streamvln(),
                         compute_dtype=torch.float32, device="cpu", **kw)
    return je, te, tok


def _turn(tok, text, add_system):
    ids, _ = chatml.tokenize_dialogue(tok, [("user", text)],
                                      add_system=add_system,
                                      with_labels=False)
    return np.concatenate([ids, np.asarray(chatml.generation_prompt(tok),
                                           np.int32)])


@pytest.fixture(scope="module")
def params():
    from test_torch_eval import steer
    jp = jax.tree.map(np.asarray, jsv.init(jax.random.PRNGKey(0),
                                           jcfg.tiny_streamvln()))
    jp = steer(jp, ByteTokenizer())
    return jp, from_jax_params(jp, tcfg.tiny_streamvln(), device="cpu")


@pytest.mark.parametrize("spec", [0, 6])
def test_kv_int8_engine_matches_jax_across_window_and_memory(params, spec):
    """The kv_int8 engine against the JAX kv_int8 engine, greedy and with
    spec_lookup 6 (whose rollbacks set lengths only), on the steered tiny
    weights: one window of calls with a continue_decode chunk, the window
    reset, the <memory> call and one more chunk; tokens, lengths, the KV
    bookkeeping and the verify forwards agree after every call, and the
    cache stays int8 with its scales."""
    je, te, tok = _jax_and_port_engines(*params, spec_lookup=spec)
    assert te.cache.quantized and te.cache.k.dtype == torch.int8
    scales = (te.cache.k_scale.data_ptr(), te.cache.v_scale.data_ptr())
    cfg = te.cfg
    rng = np.random.RandomState(spec)
    nf, nfs, nh = cfg.num_frames, cfg.num_future_steps, cfg.num_history

    def same():
        np.testing.assert_array_equal(te.cache.length.numpy(),
                                      np.asarray(je.cache.length))
        for a, b in zip(je.envs, te.envs):
            assert (a.kv_length, a.pending_token) == \
                (b.kv_length, b.pending_token)
        assert (te.decode_tokens, te.decode_forwards) == \
            (je.decode_tokens, je.decode_forwards)
    for call in range(nf // nfs):
        frame = rng.randint(0, 255, (48, 64, 3), np.uint8)
        ids = _turn(tok, chatml.observation_prompt(
            None, "walk to the window" if call == 0 else ""), call == 0)
        got = te.generate(0, frame, ids, step_id=call * nfs)
        assert got == je.generate(0, frame, ids, step_id=call * nfs), call
        same()
        if call == 0:
            assert te.continue_decode(0) == je.continue_decode(0)
            same()
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
    same()
    assert te.continue_decode(0) == je.continue_decode(0)
    same()
    assert (te.cache.k_scale.data_ptr(), te.cache.v_scale.data_ptr()) \
        == scales
    assert te.decode_tokens > 0


def test_eval_cli_kv_int8_vision_int8_matches_jax(params, tmp_path):
    """eval_cli.main --kv_int8 --vision_int8 of both packages on one
    checkpoint of the steered tiny weights (ByteTokenizer: no tokenizer
    files), two fake-env episodes of up to 12 steps at 8-step windows (a
    model call every 2 steps, 2 history frames: window resets and <memory>
    calls): the same result.json episode lines and aggregate metrics."""
    from safetensors.numpy import save_file

    from streamvln_tpu import eval_cli as jcli
    from streamvln_tpu.utils.checkpoint import export_hf
    from streamvln_tpu_torch import eval_cli

    ckpt = tmp_path / "weights"
    ckpt.mkdir()
    save_file({k: np.ascontiguousarray(v) for k, v in
               export_hf(params[0], jcfg.tiny_streamvln()).items()},
              str(ckpt / "model.safetensors"))
    argv = ["--model_path", str(ckpt), "--model_size", "tiny",
            "--num_frames", "8", "--num_future_steps", "2",
            "--num_history", "2", "--env_backend", "fake",
            "--num_episodes", "2", "--max_steps_per_episode", "12",
            "--kv_int8", "--vision_int8"]
    lines, finals = {}, {}
    for name, main, extra in (("jax", jcli.main, []),
                              ("port", eval_cli.main, ["--device", "cpu"])):
        out = str(tmp_path / name)
        finals[name] = main(argv + ["--output_path", out] + extra)
        with open(os.path.join(out, "result.json")) as f:
            lines[name] = [json.loads(x) for x in f if x.strip()]
    episodes = [r for r in lines["port"] if "episode_id" in r]
    assert len(episodes) == 2 and max(r["steps"] for r in episodes) == 12
    assert episodes == [r for r in lines["jax"] if "episode_id" in r]
    keys = ("sucs_all", "spls_all", "oss_all", "ones_all", "length")
    assert {k: finals["port"][k] for k in keys} == \
        {k: finals["jax"][k] for k in keys}
