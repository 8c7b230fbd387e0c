"""The port's resamplers (models/resampler.py), weight tools
(utils/weight_tools.py) and offline evaluator (eval/offline.py) against
the JAX package's on the CPU in float32.

- The five resampler subjects of tests/test_aux_components.py. The
  perceiver and the qformer run on the JAX init's trees carried across by
  `weights.from_jax_resampler` (atol 1e-5 rtol 1e-4: f32 summation order);
  identity and spatial_pool's max are exact, its average within 1e-6.
  masked_drop draws from a
  torch.Generator, so its contract with the reference is the kept count,
  the support (original rows in their original order) and determinism by
  seed, not the same draws.
- weight_tools: the delta round trip and consolidate, bit-equal with the
  JAX functions on the same arrays.
- run_offline_eval: the answers equal to the JAX evaluator's, text for
  text, on one tiny tree, for a video entry (the square path) and for a
  single image under anyres. A video's frames reach the agent as
  non-model steps before its one model call, which then has no history
  frames: the JAX agent still adds the memory clause and its splice reads
  NaN rows past the vision pool (ROADMAP §3, item 9); the port adds no
  clause. The JAX agent is compared with that fault repaired on the
  instance (`repair_memory_clause`), and the fault is pinned beside it.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamvln_tpu.models import resampler as jres
from streamvln_tpu.utils import weight_tools as jwt
from streamvln_tpu_torch.models import resampler as tres
from streamvln_tpu_torch.utils import weight_tools as twt
from streamvln_tpu_torch.weights import from_jax_resampler

ATOL, RTOL = 1e-5, 1e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# -- resamplers ----------------------------------------------------------

def test_identity_resampler():
    init, apply = tres.build_resampler(None)
    assert init(8, device="cpu") == {}
    x = torch.ones((2, 16, 8))
    assert apply({}, x) is x
    for name in ("identity", "none"):
        assert tres.build_resampler(name)[1]({}, x) is x
    with pytest.raises(ValueError, match="unknown resampler"):
        tres.build_resampler("nope")


def test_masked_drop_resampler():
    _, apply = tres.build_resampler("masked_drop", ratio=0.5)
    _, japply = jres.build_resampler("masked_drop", ratio=0.5)
    x = torch.arange(2 * 16 * 4, dtype=torch.float32).reshape(2, 16, 4)
    out = apply({}, x, generator=torch.Generator().manual_seed(0),
                train=True)
    want = japply({}, jnp.asarray(x.numpy()), rng=jax.random.PRNGKey(0),
                  train=True)
    assert out.shape == want.shape == (2, 8, 4)
    for b in range(2):
        # kept tokens are original rows, in their original order
        rows = out[b, :, 0].long().tolist()
        assert all(r % 4 == 0 for r in rows) and rows == sorted(rows)
        for r in out[b]:
            assert any(torch.equal(r, y) for y in x[b])
    # determinism by seed; another seed draws other rows
    again = apply({}, x, generator=torch.Generator().manual_seed(0),
                  train=True)
    assert torch.equal(out, again)
    other = apply({}, x, generator=torch.Generator().manual_seed(1),
                  train=True)
    assert not torch.equal(out, other)
    # ceil(N * (1 - ratio)), at least one
    for ratio, n in ((0.3, 12), (0.99, 1), (0.0, 16)):
        _, ap = tres.build_resampler("masked_drop", ratio=ratio)
        _, jap = jres.build_resampler("masked_drop", ratio=ratio)
        got = ap({}, x, generator=torch.Generator().manual_seed(0),
                 train=True)
        assert got.shape[1] == n == jap({}, jnp.asarray(x.numpy()),
                                        rng=jax.random.PRNGKey(0),
                                        train=True).shape[1]
    # eval mode, or no generator, keeps everything
    assert apply({}, x, train=False) is x
    assert apply({}, x, train=True) is x


@pytest.mark.parametrize("mode", ["average", "max"])
def test_spatial_pool_resampler(mode):
    _, apply = tres.build_resampler("spatial_pool", stride=2, mode=mode)
    _, japply = jres.build_resampler("spatial_pool", stride=2, mode=mode)
    x = torch.arange(16, dtype=torch.float32).reshape(1, 16, 1)
    out = apply({}, x)
    if mode == "average":
        np.testing.assert_allclose(out.squeeze().numpy(),
                                   [2.5, 4.5, 10.5, 12.5])
    y = np.random.RandomState(0).randn(2, 25, 3).astype(np.float32)
    # the max is exact; the mean's f32 summation order may differ by an ulp
    np.testing.assert_allclose(
        apply({}, torch.from_numpy(y)).numpy(),
        np.asarray(japply({}, jnp.asarray(y))), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="square grid"):
        apply({}, torch.zeros((1, 15, 2)))


def test_perceiver_resampler():
    kw = dict(num_latents=8, num_layers=2, num_heads=2)
    init, apply = tres.build_resampler("perceiver", **kw)
    jinit, japply = jres.build_resampler("perceiver", **kw)
    jp = jinit(jax.random.PRNGKey(0), 16)
    tp = from_jax_resampler(_np(jp), device="cpu")
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (2, 32, 16)))
    out = apply(tp, torch.from_numpy(x))
    assert out.shape == (2, 8, 16) and torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(
        japply(jp, jnp.asarray(x))), atol=ATOL, rtol=RTOL)
    own = init(16, torch.Generator().manual_seed(0), device="cpu",
               dtype=torch.float32)
    assert jax.tree.structure(jax.tree.map(lambda a: 0, own)) == \
        jax.tree.structure(jax.tree.map(lambda a: 0, _np(jp)))
    assert apply(own, torch.from_numpy(x)).shape == (2, 8, 16)


def test_qformer_resampler():
    # tiny config: 4 layers, cross-attention every 2nd, 8 latents,
    # hidden 32 independent of the 16-dim input features
    kw = dict(num_latents=8, hidden_size=32, num_layers=4, num_heads=4,
              cross_attention_freq=2, intermediate_size=64)
    init, apply = tres.build_resampler("qformer", **kw)
    jinit, japply = jres.build_resampler("qformer", **kw)
    jp = jinit(jax.random.PRNGKey(0), 16)
    tp = from_jax_resampler(_np(jp), device="cpu")
    assert ["cross" in lp for lp in tp["layers"]] == [True, False, True,
                                                      False]
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (2, 32, 16)))
    out = apply(tp, torch.from_numpy(x))
    assert out.shape == (2, 8, 32) and torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(
        japply(jp, jnp.asarray(x))), atol=ATOL, rtol=RTOL)
    # the output depends on the image features through cross-attention
    assert not torch.allclose(out, apply(tp, torch.from_numpy(x + 1.0)))
    own = init(16, torch.Generator().manual_seed(0), device="cpu",
               dtype=torch.float32)
    assert jax.tree.structure(jax.tree.map(lambda a: 0, own)) == \
        jax.tree.structure(jax.tree.map(lambda a: 0, _np(jp)))
    with pytest.raises(ValueError, match="resampler tree"):
        from_jax_resampler({"layers": {"a": 1}}, device="cpu")


# -- weight tools ----------------------------------------------------------

def test_delta_roundtrip():
    rng = np.random.RandomState(0)
    base = {"a": rng.randn(2, 2).astype(np.float32),
            "b": {"c": rng.randn(3).astype(np.float32)},
            "l": [rng.randn(4).astype(np.float32)]}
    target = jax.tree.map(lambda x: x * 3.0 + 1.0, base)
    tb, tt = (jax.tree.map(torch.from_numpy, t) for t in (base, target))
    delta = twt.make_delta(tb, tt)
    jdelta = jwt.make_delta(base, target)
    for d, jd in zip(jax.tree_util.tree_leaves(delta),
                     jax.tree_util.tree_leaves(jdelta)):
        np.testing.assert_array_equal(d.numpy(), jd)
    back = twt.apply_delta(tb, delta)
    jback = jwt.apply_delta(base, jdelta)
    for x, y, z in zip(jax.tree_util.tree_leaves(back),
                       jax.tree_util.tree_leaves(jback),
                       jax.tree_util.tree_leaves(target)):
        np.testing.assert_array_equal(x.numpy(), y)
        np.testing.assert_allclose(x.numpy(), z, rtol=1e-6)
    # bf16 bases come back in bf16
    bf = {"w": torch.ones((2, 2), dtype=torch.bfloat16)}
    out = twt.apply_delta(bf, twt.make_delta(bf, {"w": bf["w"] * 2}))
    assert out["w"].dtype == torch.bfloat16
    assert torch.equal(out["w"], bf["w"] * 2)


def test_consolidate():
    tree = {"x": torch.ones((4,), requires_grad=True),
            "y": [torch.arange(6).reshape(2, 3).t()]}
    out = twt.consolidate(tree)
    assert out["x"].device.type == "cpu" and not out["x"].requires_grad
    assert out["y"][0].is_contiguous()
    np.testing.assert_array_equal(out["y"][0].numpy(),
                                  jwt.consolidate({"y": np.arange(6).reshape(
                                      2, 3).T})["y"])


# -- offline eval ------------------------------------------------------------

def repair_memory_clause(jagent):
    """The JAX agent instance with ROADMAP §3 item 9 repaired as in the
    port: a window's first model call adds the memory clause only when it
    has history frames to show."""
    build = jagent._build_turn

    def turn(idx, instruction, with_memory):
        return build(idx, instruction,
                     with_memory and bool(jagent._history_steps(idx)))
    jagent._build_turn = turn
    return jagent


@pytest.fixture(scope="module")
def agents():
    return make_agents()


def make_agents(params_seed=0, **engine_kw):
    """A JAX and a port agent on one tiny tree (the JAX init of
    `params_seed` carried across), f32 on the CPU, engines built with
    `engine_kw` over the defaults below, the JAX agent with item 9
    repaired."""
    from streamvln_tpu.agent import VLNAgent as JaxAgent
    from streamvln_tpu.configs import tiny_streamvln as jax_tiny
    from streamvln_tpu.data.tokenizer import ByteTokenizer as JaxTok
    from streamvln_tpu.models import streamvln as jsv
    from streamvln_tpu.streaming.engine import StreamingEngine as JaxEngine
    from streamvln_tpu_torch.agent import VLNAgent
    from streamvln_tpu_torch.configs import tiny_streamvln
    from streamvln_tpu_torch.data.tokenizer import ByteTokenizer
    from streamvln_tpu_torch.streaming.engine import StreamingEngine
    from streamvln_tpu_torch.weights import from_jax_params

    jp = jsv.init(jax.random.PRNGKey(params_seed), jax_tiny())
    tp = from_jax_params(_np(jp), tiny_streamvln(), device="cpu")
    kw = dict(max_new_tokens=4, cache_capacity=1024,
              buckets=(512, 768, 1024))
    kw.update(engine_kw)
    jtok, tok = JaxTok(), ByteTokenizer()
    je = JaxEngine(jp, jax_tiny(), stop_ids=(jtok.im_end_id,),
                   compute_dtype=jnp.float32, **kw)
    te = StreamingEngine(tp, tiny_streamvln(), stop_ids=(tok.im_end_id,),
                         compute_dtype=torch.float32, device="cpu", **kw)
    return repair_memory_clause(JaxAgent(je, jtok)), VLNAgent(te, tok)


def test_memory_clause_needs_history_frames():
    """The reference fault the offline and DAgger comparisons repair: a
    model call at step 2 after two non-model steps from step 0. The JAX
    agent sends <memory> with no history, and its splice reads the memory
    rows past the one-frame vision pool, which jnp.take_along_axis fills
    with NaN; the port sends no <memory>."""
    from streamvln_tpu.agent import VLNAgent as JaxAgent
    from streamvln_tpu.configs import tiny_streamvln as jax_tiny
    from streamvln_tpu.data.tokenizer import ByteTokenizer as JaxTok
    from streamvln_tpu.models import streamvln as jsv
    from streamvln_tpu_torch.agent import VLNAgent
    from streamvln_tpu_torch.configs import tiny_streamvln
    from streamvln_tpu_torch.data.tokenizer import ByteTokenizer
    from streamvln_tpu_torch.utils.constants import MEMORY_TOKEN_INDEX

    class _Engine:
        def __init__(self, cfg):
            self.cfg, self.n_envs = cfg, 1

        def reset_episode(self, idx):
            pass

    frame = np.zeros((8, 8, 3), np.uint8)
    reqs = []
    for agent in (JaxAgent(_Engine(jax_tiny()), JaxTok()),
                  VLNAgent(_Engine(tiny_streamvln()), ByteTokenizer())):
        agent.reset_memory(0)
        for _ in range(2):
            agent.step(0, frame, "go", run_model=False)
        reqs.append(agent.prepare_model_step(0, frame, "go")["request"])
    (_, _, jids, jstep, jhist), (_, _, ids, step, hist) = reqs
    assert jstep == step == 2 and jhist == hist == ()
    assert MEMORY_TOKEN_INDEX in list(jids)
    assert MEMORY_TOKEN_INDEX not in list(ids)
    layout = jsv.build_splice_layout(np.asarray(jids), jax_tiny())
    cfg = jax_tiny()
    pool = (cfg.num_history + 1) * cfg.tokens_per_frame
    shifted = layout.vision_index + cfg.num_history * cfg.tokens_per_frame
    assert shifted[layout.is_vision].max() >= pool
    vis = jnp.take_along_axis(jnp.zeros((1, pool, 2)),
                              jnp.asarray(shifted)[None, :, None], axis=1)
    assert bool(jnp.isnan(vis[0][layout.is_vision]).any())


def _media(tmp_path):
    from PIL import Image
    media = tmp_path / "media"
    (media / "clip").mkdir(parents=True)
    rng = np.random.RandomState(0)
    Image.fromarray(rng.randint(0, 255, (48, 64, 3), np.uint8)).save(
        str(media / "img.jpg"))
    for i in range(3):
        Image.fromarray(rng.randint(0, 255, (40, 40, 3), np.uint8)).save(
            str(media / "clip" / f"{i:03d}.jpg"))
    return str(media), [
        {"id": 7, "image": "img.jpg", "conversations": [
            {"from": "human", "value": "<image>\nWhat is shown?"},
            {"from": "gpt", "value": "noise"}]},
        {"id": "v1", "video": "clip", "conversations": [
            {"from": "human", "value": "<image>\nWhere to go?"}]}]


@pytest.mark.parametrize("ratio", ["square", "anyres"])
def test_offline_eval_matches_jax(agents, tmp_path, ratio, monkeypatch):
    import functools

    from streamvln_tpu.eval.offline import run_offline_eval as jax_run
    from streamvln_tpu.models import anyres as janyres
    from streamvln_tpu_torch.eval.offline import run_offline_eval
    from streamvln_tpu_torch.models import anyres

    media, entries = _media(tmp_path)
    jagent, agent = agents
    # the default pinpoints are multiples of SigLIP's 384-pixel tiles; the
    # tiny tower's tiles are 56 pixels, in both packages
    S = agent.cfg.vision.image_size
    pins = ((S, 2 * S), (2 * S, S), (2 * S, 2 * S))
    for mod in (anyres, janyres):
        monkeypatch.setattr(mod, "generate_anyres", functools.partial(
            mod.generate_anyres, grid_pinpoints=pins))
    out_file = str(tmp_path / "port" / "answers.jsonl")
    answers = run_offline_eval(agent, entries, media, out_file,
                               num_frames_qa=3, image_aspect_ratio=ratio)
    want = jax_run(jagent, entries, media, str(tmp_path / "jax.jsonl"),
                   num_frames_qa=3, image_aspect_ratio=ratio)
    assert [a["question_id"] for a in answers] == [7, "v1"]
    for a, w in zip(answers, want):
        assert (a["question_id"], a["prompt"], a["text"]) == \
            (w["question_id"], w["prompt"], w["text"])
    recs = [json.loads(line) for line in open(out_file)]
    assert [r["text"] for r in recs] == [a["text"] for a in answers]
    assert os.path.getsize(out_file) > 0
