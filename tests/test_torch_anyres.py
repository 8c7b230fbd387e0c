"""The port's anyres path (models/anyres.py, utils/mm_utils.py) against the
JAX package's on the CPU: the three subjects of tests/test_anyres.py (the
merge against the reference algorithm, the token count and the layout's
expansion, generate end to end) and the tiling and best-resolution
subjects of tests/test_aux_components.py.

Tolerances: host functions, tiles and the merge bit-equal; the encoded
features atol 1e-4 (f32, the tiny tower and projector); generate_anyres
token for token with JAX on the same weights.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamvln_tpu.configs import tiny_streamvln as jax_tiny
from streamvln_tpu.data import chatml as jchatml
from streamvln_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from streamvln_tpu.models import anyres as janyres
from streamvln_tpu.models import streamvln as jsv
from streamvln_tpu.utils import mm_utils as jmm
from streamvln_tpu_torch.configs import tiny_streamvln
from streamvln_tpu_torch.data import chatml
from streamvln_tpu_torch.data.tokenizer import ByteTokenizer
from streamvln_tpu_torch.models import anyres
from streamvln_tpu_torch.models import streamvln as tsv
from streamvln_tpu_torch.utils import mm_utils
from streamvln_tpu_torch.utils.constants import IMAGE_TOKEN_INDEX
from streamvln_tpu_torch.weights import from_jax_params

from test_anyres import _reference_merge


@pytest.mark.parametrize("grid_hw,osize", [
    ((1, 2), (800, 340)),    # wide image
    ((2, 1), (340, 800)),    # tall image
    ((2, 2), (500, 460)),    # near-square
    ((3, 1), (300, 1100)),
])
def test_merge_matches_reference_algorithm(grid_hw, osize):
    pps, D = 6, 16
    nph, npw = grid_hw
    rng = np.random.default_rng(0)
    feats = rng.standard_normal(
        (nph * npw + 1, pps * pps, D)).astype(np.float32)
    newline = rng.standard_normal(D).astype(np.float32)
    want = _reference_merge(feats, newline, grid_hw, pps, osize)
    got = anyres.merge_anyres_features(
        torch.from_numpy(feats), torch.from_numpy(newline), grid_hw, pps,
        osize).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(
        janyres.merge_anyres_features(jnp.asarray(feats),
                                      jnp.asarray(newline), grid_hw, pps,
                                      osize)))
    assert anyres.unpad_bounds(grid_hw, pps, osize) == \
        janyres.unpad_bounds(grid_hw, pps, osize)
    _, h, _, w = anyres.unpad_bounds(grid_hw, pps, osize)
    assert want.shape[0] == pps * pps + h * (w + 1)


def test_token_count_and_layout_expansion():
    cfg = tiny_streamvln()
    S, pps = cfg.vision.image_size, cfg.vision.patches_per_side
    pins = ((S, 2 * S), (2 * S, S))
    for osize in ((200, 90), (90, 200), (130, 60), (640, 480)):
        n = anyres.anyres_token_count(osize, pins, S, pps)
        assert n == janyres.anyres_token_count(osize, pins, S, pps)
        assert n > pps ** 2
    # the card's images on the 7B's defaults: 2x2 tiles (2929 tokens) and
    # 3x1 tiles (2943)
    for osize, want in (((640, 480), 2929), ((1152, 384), 2943)):
        n = anyres.anyres_token_count(osize, anyres.DEFAULT_GRID_PINPOINTS,
                                      384, 27)
        assert n == want == janyres.anyres_token_count(
            osize, janyres.DEFAULT_GRID_PINPOINTS, 384, 27)
    n = anyres.anyres_token_count((200, 90), pins, S, pps)
    ids = np.asarray([7, IMAGE_TOKEN_INDEX, 5, 6], np.int32)
    layout = tsv.build_splice_layout(ids, cfg, image_token_counts=[n])
    jl = jsv.build_splice_layout(ids, jax_tiny(), image_token_counts=[n])
    assert layout.length == jl.length == 3 + n
    assert int(layout.is_vision.sum()) == n
    np.testing.assert_array_equal(
        layout.vision_index[layout.is_vision], np.arange(n))
    for name in ("token_ids", "is_vision", "vision_index", "valid"):
        np.testing.assert_array_equal(getattr(layout, name),
                                      getattr(jl, name))


_SIZES = [(300, 600), (600, 300), (123, 457), (384, 1152), (480, 640),
          (97, 101)]


def test_select_best_resolution():
    grids = [(336, 672), (672, 336), (672, 672), (1008, 336), (336, 1008)]
    assert mm_utils.select_best_resolution((600, 300), grids) == (672, 336)
    assert mm_utils.select_best_resolution((300, 600), grids) == (336, 672)
    for pins in (grids, anyres.DEFAULT_GRID_PINPOINTS):
        for h, w in _SIZES:
            assert mm_utils.select_best_resolution((w, h), pins) == \
                jmm.select_best_resolution((w, h), pins)
            assert mm_utils.get_anyres_image_grid_shape((w, h), pins, 336) \
                == jmm.get_anyres_image_grid_shape((w, h), pins, 336)


@pytest.mark.parametrize("hw", _SIZES[:4])
def test_anyres_tiling(hw):
    img = np.random.RandomState(0).randint(0, 255, hw + (3,), np.uint8)
    grids = [(672, 336), (336, 672), (672, 672)]
    tiles = mm_utils.process_anyres_image(img, grids, tile_size=336)
    np.testing.assert_array_equal(
        tiles, jmm.process_anyres_image(img, grids, tile_size=336))
    npw, nph = mm_utils.get_anyres_image_grid_shape(hw[::-1], grids, 336)
    assert tiles.shape == (npw * nph + 1, 336, 336, 3)
    if hw == (300, 600):   # the reference test's case: thumbnail + 2x1
        assert tiles.shape == (3, 336, 336, 3) and (npw, nph) == (2, 1)
    parts = mm_utils.divide_to_patches(img, 100)
    want = jmm.divide_to_patches(img, 100)
    assert len(parts) == len(want)
    for a, b in zip(parts, want):
        np.testing.assert_array_equal(a, b)


def test_keywords_stopping_criteria():
    tok = ByteTokenizer()
    ids = tok.encode("the answer is done###")
    for kws, lookback in ((["###"], 24), (["done"], 24), (["done"], 3),
                          (["absent"], 24)):
        port = mm_utils.KeywordsStoppingCriteria(kws, tok)
        ref = jmm.KeywordsStoppingCriteria(kws, JaxByteTokenizer())
        assert port.should_stop(ids, lookback) == \
            ref.should_stop(ids, lookback)
    assert mm_utils.KeywordsStoppingCriteria(["###"], tok).should_stop(ids)


def test_generate_anyres_end_to_end():
    """encode_anyres's features and generate_anyres's tokens against the
    JAX package's on one tiny tree (the JAX init carried across)."""
    jcfg, cfg = jax_tiny(), tiny_streamvln()
    jp = jsv.init(jax.random.PRNGKey(0), jcfg)
    params = from_jax_params(jax.tree.map(np.asarray, jp), cfg,
                             device="cpu")
    # the bridge carries the learned newline the merge appends to each row
    np.testing.assert_array_equal(params["image_newline"].numpy(),
                                  np.asarray(jp["image_newline"]))
    S = cfg.vision.image_size
    pins = ((S, 2 * S), (2 * S, S), (2 * S, 2 * S))
    image = np.random.default_rng(1).integers(0, 255, (60, 130, 3),
                                              dtype=np.uint8)
    feats = anyres.encode_anyres(params, cfg, image, pins)
    n = anyres.anyres_token_count((130, 60), pins, S,
                                  cfg.vision.patches_per_side)
    assert feats.shape == (n, cfg.llm.hidden_size)
    np.testing.assert_allclose(
        feats.numpy(), np.asarray(janyres.encode_anyres(jp, jcfg, image,
                                                        pins)),
        atol=1e-4, rtol=1e-4)

    tok = ByteTokenizer()
    ids, _ = chatml.tokenize_dialogue(
        tok, [("user", "<image> what do you see?")], add_system=True,
        with_labels=False)
    ids = np.concatenate([ids, np.asarray(chatml.generation_prompt(tok),
                                          np.int32)])
    jtok = JaxByteTokenizer()
    jids, _ = jchatml.tokenize_dialogue(
        jtok, [("user", "<image> what do you see?")], add_system=True,
        with_labels=False)
    jids = np.concatenate([jids, np.asarray(
        jchatml.generation_prompt(jtok), np.int32)])
    np.testing.assert_array_equal(ids, jids)
    out = anyres.generate_anyres(params, cfg, tok, image, ids, max_new=3,
                                 stop_ids=(tok.im_end_id,),
                                 grid_pinpoints=pins)
    want = janyres.generate_anyres(jp, jcfg, jtok, image, jids, max_new=3,
                                   stop_ids=(jtok.im_end_id,),
                                   grid_pinpoints=pins)
    assert 1 <= len(out) <= 3 and all(isinstance(t, int) for t in out)
    assert out == want
