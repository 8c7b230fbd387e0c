"""The strided pool modes ("average", "max") of `models/streamvln.pool_2d`
against the JAX package's, and the count of tokens a frame takes.

The reference's `tokens_per_frame` is ceil(side / stride)^2 whatever the
mode, while its strided pools give floor(side / stride)^2 tokens, so its
`encode_frames` raises at an odd side (27 patches a side at full width:
169 tokens into 196 slots; ROADMAP §3.8). The port's `tokens_per_frame`
follows the mode; the test pins the reference's raise beside the port's
run at that side. f32 on the CPU: the max pool is bit-equal, the mean
and the bilinear resize within 1e-5 (the order of an f32 sum), the
engine token for token.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamvln_tpu import configs as jcfg
from streamvln_tpu.models import streamvln as jsv
from streamvln_tpu.streaming.engine import StreamingEngine as JaxEngine
from streamvln_tpu_torch import configs as tcfg
from streamvln_tpu_torch.data import chatml
from streamvln_tpu_torch.data.tokenizer import ByteTokenizer
from streamvln_tpu_torch.models import streamvln as tsv
from streamvln_tpu_torch.streaming.engine import StreamingEngine
from streamvln_tpu_torch.weights import from_jax_params

MODES = ("bilinear", "average", "max")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("side", [4, 5, 27])
def test_pool_2d_matches_jax(mode, side):
    feats = np.random.default_rng(side).standard_normal(
        (3, side * side, 16)).astype(np.float32)
    want = np.asarray(jsv.pool_2d(jnp.asarray(feats), side, 2, mode))
    got = tsv.pool_2d(torch.from_numpy(feats), side, 2, mode).numpy()
    assert got.shape == want.shape
    if mode == "max":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError):
        tsv.pool_2d(torch.from_numpy(feats), side, 2, "nearest")


def test_tokens_per_frame_follows_the_mode():
    """Full width: 196 bilinear, 169 for the strided pools (the reference
    counts 196 for every mode); the tiny tower's even side agrees with the
    reference in every mode."""
    for mode, want in zip(MODES, (196, 169, 169)):
        cfg = dataclasses.replace(tcfg.streamvln_7b(), spatial_pool_mode=mode)
        assert cfg.tokens_per_frame == want
        assert cfg.memory_tokens == cfg.num_history * want
        jc = dataclasses.replace(jcfg.streamvln_7b(), spatial_pool_mode=mode)
        assert jc.tokens_per_frame == 196
        feats = torch.zeros((1, 27 * 27, 8))
        pooled = tsv.pool_2d(feats, 27, 2, mode)
        assert pooled.shape[1] == cfg.tokens_per_frame
        small = dataclasses.replace(tcfg.tiny_streamvln(),
                                    spatial_pool_mode=mode)
        jsmall = dataclasses.replace(jcfg.tiny_streamvln(),
                                     spatial_pool_mode=mode)
        assert small.tokens_per_frame == jsmall.tokens_per_frame == 4


def _odd(mod, mode):
    """tiny_streamvln with a 70-pixel tower: 5 patches a side."""
    base = mod.tiny_streamvln()
    return dataclasses.replace(base, vision=mod.tiny_vision(image_size=70),
                               spatial_pool_mode=mode)


@pytest.mark.parametrize("mode", ["average", "max"])
def test_reference_encode_frames_raises_at_an_odd_side(mode):
    """The reference fault: at 5 patches a side its strided pool gives 4
    tokens a frame, its tokens_per_frame says 9, and the reshape raises.
    The port encodes the same frames into 4 tokens each, the tower,
    projector and pool equal to the reference's own functions."""
    jc, tc = _odd(jcfg, mode), _odd(tcfg, mode)
    jp = jsv.init(jax.random.PRNGKey(0), jc)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tc, device="cpu")
    images = np.random.default_rng(1).standard_normal(
        (1, 2, 70, 70, 3)).astype(np.float32)
    with pytest.raises(TypeError, match="reshape"):
        jsv.encode_frames(jp, jc, jnp.asarray(images))
    got = tsv.encode_frames(tp, tc, torch.from_numpy(images)).numpy()
    assert tc.tokens_per_frame == 4 and got.shape[1] == 2 * 4
    from streamvln_tpu.models import projector as jproj
    from streamvln_tpu.models import siglip as jsiglip
    feats = jsiglip.forward(jp["vision"], jc.vision,
                            jnp.asarray(images.reshape(2, 70, 70, 3)))
    want = jsv.pool_2d(jproj.forward(jp["projector"], feats), 5, 2, mode)
    np.testing.assert_allclose(got.reshape(2, 4, -1), np.asarray(want),
                               atol=1e-4, rtol=1e-4)


def _turn(tok, text, add_system):
    ids, _ = chatml.tokenize_dialogue(tok, [("user", text)],
                                      add_system=add_system,
                                      with_labels=False)
    return np.concatenate([ids, np.asarray(chatml.generation_prompt(tok),
                                           np.int32)])


@pytest.mark.parametrize("mode", ["average", "max"])
def test_engine_with_a_strided_pool(mode):
    """The engine's feature cache and splice take the pool's token count:
    token for token with the JAX engine at the tiny tower's even side
    (window calls, the reset, the <memory> call), and at an odd side,
    where the reference cannot run, the port serves the same calls."""
    jc = dataclasses.replace(jcfg.tiny_streamvln(), spatial_pool_mode=mode)
    tc = dataclasses.replace(tcfg.tiny_streamvln(), spatial_pool_mode=mode)
    jp = jsv.init(jax.random.PRNGKey(0), jc)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tc, device="cpu")
    tok = ByteTokenizer()
    kw = dict(n_envs=1, stop_ids=(tok.im_end_id,), max_new_tokens=6,
              cache_capacity=2048, buckets=(128, 512, 768, 1024))
    je = JaxEngine(jp, jc, compute_dtype=jnp.float32, **kw)
    te = StreamingEngine(tp, tc, compute_dtype=torch.float32, device="cpu",
                         **kw)
    odd = StreamingEngine(from_jax_params(
        jax.tree.map(np.asarray, jsv.init(jax.random.PRNGKey(0),
                                          _odd(jcfg, mode))),
        _odd(tcfg, mode), device="cpu"), _odd(tcfg, mode),
        compute_dtype=torch.float32, device="cpu", **kw)
    assert te.feat_cache.shape[2] == 4 and odd.feat_cache.shape[2] == 4
    rng = np.random.RandomState(0)
    nf, nfs, nh = tc.num_frames, tc.num_future_steps, tc.num_history
    for call in range(nf // nfs):
        frame = rng.randint(0, 255, (48, 64, 3), np.uint8)
        ids = _turn(tok, chatml.observation_prompt(
            None, "go to the red door" if call == 0 else ""), call == 0)
        assert te.generate(0, frame, ids, step_id=call * nfs) == \
            je.generate(0, frame, ids, step_id=call * nfs)
        odd.generate(0, frame, ids, step_id=call * nfs)
    for e in (je, te, odd):
        e.reset_for_env(0)
    frame = rng.randint(0, 255, (48, 64, 3), np.uint8)
    ids = _turn(tok, chatml.observation_prompt(
        None, "These are your historical observations <memory>."), True)
    hist = list(range(0, nf, nf // nh))
    assert te.generate(0, frame, ids, step_id=nf, history_steps=hist) == \
        je.generate(0, frame, ids, step_id=nf, history_steps=hist)
    np.testing.assert_array_equal(te.cache.length.numpy(),
                                  np.asarray(je.cache.length))
    odd.generate(0, frame, ids, step_id=nf, history_steps=hist)
    assert int(odd.cache.length[0]) > 0
