"""The port's fused preprocessing against the JAX package on the CPU:
`resize_matrix` and `fold_normalize` exactly, `fused_patch_embed` and
`siglip.forward_raw` in float32 (and the patch embed in bfloat16, where the
order of the roundings matters), and a StreamingEngine with
`fused_preprocess=True` token for token with the JAX engine over window
resets, <memory> calls and `backfill_batch`, its feature cache included.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamvln_tpu.agent import VLNAgent as JaxAgent
from streamvln_tpu.configs import tiny_streamvln as jax_tiny
from streamvln_tpu.configs import tiny_vision as jax_tiny_vision
from streamvln_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from streamvln_tpu.models import siglip as jsiglip
from streamvln_tpu.models import streamvln as jsv
from streamvln_tpu.ops import fused_patch_embed as jfpe
from streamvln_tpu.streaming.engine import StreamingEngine as JaxEngine
from streamvln_tpu_torch.agent import VLNAgent
from streamvln_tpu_torch.configs import tiny_streamvln, tiny_vision
from streamvln_tpu_torch.data.tokenizer import ByteTokenizer
from streamvln_tpu_torch.models import siglip
from streamvln_tpu_torch.ops import fused_patch_embed as fpe
from streamvln_tpu_torch.streaming.engine import StreamingEngine
from streamvln_tpu_torch.weights import from_jax_params

# f32: both sides sum the same products in another order
RTOL, ATOL = 1e-5, 1e-5


def _torch_tree(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.mark.parametrize("sizes", [(48, 32), (64, 32), (56, 56),
                                   (480, 384), (640, 384), (20, 56)])
def test_resize_matrix_is_the_reference_copy(sizes):
    np.testing.assert_array_equal(fpe.resize_matrix(*sizes),
                                  jfpe.resize_matrix(*sizes))


def test_fold_normalize_equals_jax():
    rng = np.random.default_rng(1)
    w = rng.standard_normal((588, 24)).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    jw, jb = jfpe.fold_normalize(jnp.asarray(w), jnp.asarray(b))
    tw, tb = fpe.fold_normalize(torch.from_numpy(w), torch.from_numpy(b))
    assert tw.dtype == tb.dtype == torch.float32
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    # the column sums may add in another order: one f32 ulp of the sum
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=2e-7,
                               atol=np.abs(w).sum(0).max() * 2 ** -23)


@pytest.fixture(scope="module")
def tower():
    jp = jsiglip.init(jax.random.PRNGKey(0), jax_tiny_vision())
    return jp, _torch_tree(jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("hw", [(48, 64), (56, 56), (30, 40)])
def test_fused_patch_embed_and_forward_raw_match_jax(tower, hw):
    """f32: the fused patch embed and the whole tower from raw frames, at a
    downsize, the identity size and an upsize."""
    jp, tp = tower
    frames = np.random.default_rng(2).integers(0, 256, (2, *hw, 3),
                                               np.uint8)
    cfg, jcfg = tiny_vision(), jax_tiny_vision()
    kw = dict(image_size=cfg.image_size, patch_size=cfg.patch_size)
    want = jfpe.fused_patch_embed(jnp.asarray(frames), jp["patch_w"],
                                  jp["patch_b"], compute_dtype=jnp.float32,
                                  **kw)
    got = fpe.fused_patch_embed(torch.from_numpy(frames), tp["patch_w"],
                                tp["patch_b"], compute_dtype=torch.float32,
                                **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    want = jsiglip.forward_raw(jp, jcfg, jnp.asarray(frames),
                               attn_impl="dense", compute_dtype=jnp.float32)
    got = siglip.forward_raw(tp, cfg, torch.from_numpy(frames),
                             attn_impl="dense", compute_dtype=torch.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_fused_patch_embed_bf16_rounds_as_jax(tower):
    """bf16: the port rounds after each resize product and clips before the
    embed product, as the reference does; a different order would leave
    f32 parity intact and move bf16 elements by many ulps (dropping the
    rounding between the two resize products, or the clip, moves ~40% of
    them past the bar). Bar: one bf16 ulp of each element (2^-7 of its
    magnitude): both sides sum exact products of bf16 values in f32."""
    jp, tp = tower
    frames = np.random.default_rng(3).integers(0, 256, (2, 48, 64, 3),
                                               np.uint8)
    cfg = tiny_vision()
    kw = dict(image_size=cfg.image_size, patch_size=cfg.patch_size)
    want = np.asarray(jfpe.fused_patch_embed(
        jnp.asarray(frames), jp["patch_w"].astype(jnp.bfloat16),
        jp["patch_b"].astype(jnp.bfloat16), compute_dtype=jnp.bfloat16,
        **kw).astype(jnp.float32))
    got = fpe.fused_patch_embed(
        torch.from_numpy(frames), tp["patch_w"].bfloat16(),
        tp["patch_b"].bfloat16(), compute_dtype=torch.bfloat16,
        **kw).float().numpy()
    assert np.all(np.abs(got - want) <= 2 ** -7 * np.abs(want))


def test_fused_matches_two_stage_by_the_reference_bar(tower):
    """The reference's own bar between the fused and the two-stage tower
    (tests/test_fused_patch_embed.py::test_fused_matches_two_stage)."""
    from streamvln_tpu_torch.ops.preprocess import preprocess_frames
    _, tp = tower
    cfg = tiny_vision()
    frames = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (2, 48, 64, 3), np.uint8))
    ref = siglip.forward(tp, cfg, preprocess_frames(
        frames, cfg.image_size, torch.float32), attn_impl="dense")
    got = siglip.forward_raw(tp, cfg, frames, attn_impl="dense",
                             compute_dtype=torch.float32)
    assert (got - ref).abs().max() / ref.abs().max() < 0.02


def test_engine_fused_preprocess_matches_jax():
    """Both engines with fused_preprocess=True, agents stepping a model call
    every 3rd of 20 steps: window resets at 8 and 16 with <memory> calls
    whose history frames (steps 4, 8) never saw a model call, so each
    boundary backfills them (backfill_batch). Tokens of every call equal,
    the feature caches within f32 tolerance."""
    jp = jax.tree.map(np.asarray, jsv.init(jax.random.PRNGKey(0),
                                           jax_tiny()))
    tp = from_jax_params(jp, tiny_streamvln(), device="cpu")
    tok = ByteTokenizer()
    kw = dict(stop_ids=(tok.im_end_id,), max_new_tokens=4,
              cache_capacity=2048, buckets=(512, 768, 1024),
              fused_preprocess=True)
    je = JaxEngine(jp, jax_tiny(), compute_dtype=jnp.float32, **kw)
    te = StreamingEngine(tp, tiny_streamvln(), compute_dtype=torch.float32,
                         device="cpu", **kw)
    agents = (JaxAgent(je, JaxByteTokenizer()), VLNAgent(te, tok))
    backfills = []
    backfill = te.backfill_batch

    def counted(env, frames_u8, step_ids):
        backfills.append([s for s in step_ids
                          if s not in te.envs[env].frame_slots])
        return backfill(env, frames_u8, step_ids)
    te.backfill_batch = counted
    rng = np.random.default_rng(5)
    n_calls = 0
    for step in range(20):
        frame = rng.integers(0, 256, (48, 64, 3), np.uint8)
        run = step % 3 == 0
        (ja, _, jt), (ta, _, tt) = (a.step(0, frame, "walk to the door",
                                           run_model=run) for a in agents)
        assert (ta, tt) == (ja, jt), step
        n_calls += run
    assert n_calls == 7
    assert [b for b in backfills if b] == [[4], [8]]
    np.testing.assert_array_equal(te.cache.length.numpy(),
                                  np.asarray(je.cache.length))
    np.testing.assert_allclose(te.feat_cache.numpy(),
                               np.asarray(je.feat_cache), rtol=1e-4,
                               atol=1e-5)
