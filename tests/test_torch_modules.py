"""The port's modules against their JAX counterparts at tiny sizes, on the
CPU in float32, with the same numpy-made inputs and the JAX init's
weights carried across by `weights.from_jax_params`.

Tolerances: pixels atol 1e-4 (two bicubic implementations in f32);
network outputs and logits atol 1e-4 (f32 summation order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamvln_tpu import configs as jcfg
from streamvln_tpu.models import projector as jproj
from streamvln_tpu.models import qwen2 as jqwen2
from streamvln_tpu.models import siglip as jsiglip
from streamvln_tpu.models import streamvln as jsv
from streamvln_tpu.ops.preprocess import preprocess_frames as jax_pre
from streamvln_tpu_torch import configs as tcfg
from streamvln_tpu_torch.models import projector as tproj
from streamvln_tpu_torch.models import qwen2 as tqwen2
from streamvln_tpu_torch.models import siglip as tsiglip
from streamvln_tpu_torch.models import streamvln as tsv
from streamvln_tpu_torch.ops import flash_attention as tfa
from streamvln_tpu_torch.ops.preprocess import preprocess_frames as t_pre
from streamvln_tpu_torch.weights import from_jax_params
from streamvln_tpu_torch.weights import init as init_weights

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
ATOL = 1e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    """numpy pytree -> torch CPU tensors (lists and dicts kept)."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_t(v) for v in tree]
    return torch.from_numpy(np.array(tree, copy=True))


@pytest.fixture(scope="module")
def stack():
    cfg = jcfg.tiny_streamvln()
    jp = jsv.init(jax.random.PRNGKey(0), cfg)
    tp = from_jax_params(_np(jp), tcfg.tiny_streamvln(), device="cpu")
    return cfg, jp, tp


@pytest.mark.parametrize("shape,size", [((2, 48, 64, 3), 56),
                                        ((1, 480, 640, 3), 384),
                                        ((1, 56, 56, 3), 56)])
def test_preprocess_matches_jax(shape, size):
    frames = np.random.default_rng(0).integers(0, 256, shape, np.uint8)
    want = np.asarray(jax_pre(jnp.asarray(frames), size, jnp.float32))
    got = t_pre(torch.from_numpy(frames), size, torch.float32).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_siglip_forward_matches_jax(stack):
    cfg, jp, tp = stack
    x = np.random.default_rng(1).standard_normal(
        (2, 56, 56, 3)).astype(np.float32)
    want = np.asarray(jsiglip.forward(jp["vision"], cfg.vision,
                                      jnp.asarray(x)))
    got = tsiglip.forward(tp["vision"], tcfg.tiny_vision(),
                          torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-4)


def test_projector_pool_encode_match_jax(stack):
    cfg, jp, tp = stack
    rng = np.random.default_rng(2)
    feats = rng.standard_normal((3, 16, 32)).astype(np.float32)
    want = np.asarray(jproj.forward(jp["projector"], jnp.asarray(feats)))
    got = tproj.forward(tp["projector"], torch.from_numpy(feats)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)

    grid = rng.standard_normal((2, 27 * 27, 8)).astype(np.float32)
    np.testing.assert_allclose(
        tsv.pool_2d(torch.from_numpy(grid), 27, 2).numpy(),
        np.asarray(jsv.pool_2d(jnp.asarray(grid), 27, 2)), atol=1e-5)

    images = rng.standard_normal((1, 2, 56, 56, 3)).astype(np.float32)
    want = np.asarray(jsv.encode_frames(jp, cfg, jnp.asarray(images)))
    got = tsv.encode_frames(tp, tcfg.tiny_streamvln(),
                            torch.from_numpy(images)).numpy()
    assert got.shape == (1, 2 * cfg.tokens_per_frame, cfg.llm.hidden_size)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-4)


def test_splice_matches_jax(stack):
    cfg, jp, tp = stack
    ids = np.asarray([5, 6, -300, 7, -200, 8, 9], np.int32)
    jl = jsv.build_splice_layout(ids, cfg, pad_to=40)
    tl = tsv.build_splice_layout(ids, tcfg.tiny_streamvln(), pad_to=40)
    for f in ("token_ids", "is_vision", "vision_index", "labels", "valid"):
        np.testing.assert_array_equal(getattr(tl, f), getattr(jl, f))
    assert tl.length == jl.length
    vision = np.random.default_rng(3).standard_normal(
        (1, 3 * cfg.tokens_per_frame, cfg.llm.hidden_size)).astype(np.float32)
    want = np.asarray(jsv.splice_embeds(
        jp, jnp.asarray(vision), jnp.asarray(jl.token_ids[None]),
        jnp.asarray(jl.is_vision[None]), jnp.asarray(jl.vision_index[None])))
    got = tsv.splice_embeds(
        tp, torch.from_numpy(vision), torch.from_numpy(tl.token_ids[None]),
        torch.from_numpy(tl.is_vision[None]),
        torch.from_numpy(tl.vision_index[None])).numpy()
    np.testing.assert_array_equal(got, want)


def _llm_cfgs():
    tiny = jcfg.tiny_llm()
    wide = dataclasses.replace(tiny, num_heads=2, num_kv_heads=1,
                               head_dim=128)
    return [("tiny_llm", tiny, 20), ("head_dim_128", wide, 72)]


@pytest.mark.parametrize("name,jc,S", _llm_cfgs(), ids=lambda v: v
                         if isinstance(v, str) else "")
def test_qwen2_cache_prefill_and_decode_match_jax(name, jc, S):
    """Prefill into a KVCache at a nonzero offset with write_mask and
    logits_positions, then single-token decode steps; logits and the cache
    agree with JAX, and incremental decode equals full recompute. The
    head_dim_128 variant's prefill (S >= 64) runs the port's flash
    dispatch through its plain version."""
    tc = tcfg.Qwen2Config(**dataclasses.asdict(jc))
    jp = jqwen2.init(jax.random.PRNGKey(1), jc)
    tp = _t(_np(jp))
    rng = np.random.default_rng(4)
    B, cap, S0, steps = 2, 256, 9, 3
    emb = rng.standard_normal((B, S0 + S + steps, jc.hidden_size)) \
        .astype(np.float32)
    jcache = jqwen2.KVCache.create(jc, B, cap, jnp.float32)
    tcache = tqwen2.KVCache.create(tc, B, cap, torch.float32, "cpu")

    def run(lo, hi, **kw):
        pos = np.broadcast_to(np.arange(lo, hi, dtype=np.int32),
                              (B, hi - lo)).copy()
        jkw = {k: jnp.asarray(v) for k, v in kw.items()}
        tkw = {k: torch.from_numpy(v) for k, v in kw.items()}
        jl, c = jqwen2.forward(jp, jc, jnp.asarray(emb[:, lo:hi]),
                               jnp.asarray(pos), cache=jcache, **jkw)
        tl, _ = tqwen2.forward(tp, tc, torch.from_numpy(emb[:, lo:hi]),
                               torch.from_numpy(pos), cache=tcache, **tkw)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=1e-4)
        return c, tl

    jcache, _ = run(0, S0)
    n_flash = tfa.launches
    jcache, _ = run(S0, S0 + S, write_mask=np.asarray([True, False]),
                    logits_positions=np.asarray([S - 1, S - 3], np.int32))
    assert tfa.launches == n_flash          # CPU: plain version only
    # row 1's write was masked: its slots past S0 keep zeros in both
    inc = []
    for t in range(S0 + S, S0 + S + steps):
        jcache, tl = run(t, t + 1)
        inc.append(tl[:, 0].numpy())
    np.testing.assert_array_equal(tcache.length.numpy(),
                                  np.asarray(jcache.length))
    n = int(tcache.length[0])
    np.testing.assert_allclose(tcache.k[:, 0, :, :n].numpy(),
                               np.asarray(jcache.k[:, 0, :, :n]), atol=ATOL)
    np.testing.assert_allclose(tcache.v[:, 1].numpy(),
                               np.asarray(jcache.v[:, 1]), atol=ATOL)

    # incremental decode == full recompute (row 0 wrote every token)
    total = S0 + S + steps
    pos = torch.arange(total, dtype=torch.int32)[None]
    full, _ = tqwen2.forward(tp, tc, torch.from_numpy(emb[:1]), pos)
    np.testing.assert_allclose(
        np.stack(inc)[:, 0], full[0, S0 + S:].numpy(), atol=ATOL, rtol=1e-4)


def test_unsupported_decoder_configs_raise():
    """Every family of the registry is served; what the reference itself
    rejects, an unknown mlp_act, raises ValueError as its `_mlp_act_fn`
    does."""
    for name in tcfg.LLM_REGISTRY:
        tqwen2.check_supported(tcfg.llm_config(name))
    cfg = dataclasses.replace(tcfg.tiny_llm(), mlp_act="relu")
    with pytest.raises(ValueError, match="unknown mlp_act: relu"):
        tqwen2.check_supported(cfg)
    with pytest.raises(ValueError, match="unknown mlp_act: relu"):
        jqwen2._mlp_act_fn("relu")


def test_init_matches_jax_layout_and_fused_params_are_refused(stack):
    """`weights.init` gives the JAX init's tree (keys and shapes) with
    fan-in-scaled weights; `from_jax_params` refuses fused stacks."""
    cfg, jp, tp = stack
    got = init_weights(tcfg.tiny_streamvln(),
                       torch.Generator().manual_seed(0), device="cpu",
                       dtype=torch.float32)
    want = jax.tree_util.tree_flatten_with_path(_np(jp))[0]
    flat = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), got))[0]
    assert [(p, a.shape) for p, a in flat] == \
        [(p, a.shape) for p, a in want]
    q_w = got["llm"]["layers"]["q_w"]
    assert abs(q_w.std().item() - cfg.llm.hidden_size ** -0.5) < 0.02
    fused = _np(jp)
    fused["llm"]["layers"]["qkv_w"] = fused["llm"]["layers"].pop("q_w")
    with pytest.raises(ValueError, match="fused"):
        from_jax_params(fused, tcfg.tiny_streamvln(), device="cpu")
