"""The port's encoder zoo (models/encoders.py) against the JAX package's on
the CPU in float32: the eight subjects of tests/test_encoders.py, each
port against JAX on the same numpy-made inputs and the JAX trees carried
across by `weights.from_jax_tower`; the CLIP tower against a tiny
transformers CLIPVisionModel; the vit kernel's plain version at the zoo's
head dims 88 and 104 against the Pallas kernel in interpret mode; and the
kernel path's refusal of a head dim that is not a multiple of 8.

Tolerances: tower features atol 1e-4 rtol 1e-4 against JAX (f32
summation order over 3 blocks), 2e-4 / 2e-3 against transformers (the
reference test's); weight conversion bit-equal; S2 2e-5 (two bilinear
resizes in f32); the vit plain version 2e-5 against Pallas (f32).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamvln_tpu.models import encoders as jenc
from streamvln_tpu.ops.vit_attention import vit_attention as jax_vit
from streamvln_tpu_torch.models import encoders as tenc
from streamvln_tpu_torch.ops import vit_attention as va
from streamvln_tpu_torch.ops.attention import mha_attention
from streamvln_tpu_torch.weights import from_jax_tower

from test_encoders import _rand_eva_state, _torch_eva

torch.backends.cuda.matmul.allow_tf32 = False
ATOL = RTOL = 1e-4
TINY = dict(hidden_size=32, intermediate_size=64, num_layers=3,
            num_heads=4, image_size=32, patch_size=8)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(jcfg_obj, tcfg_obj, seed=0):
    """A JAX tower init'd from `seed` and the same tree in the port."""
    init = jenc.eva_init if isinstance(jcfg_obj, jenc.EvaVisionConfig) \
        else jenc.init
    jp = init(jax.random.PRNGKey(seed), jcfg_obj)
    return jp, from_jax_tower(_np(jp), tcfg_obj, device="cpu")


def _images(B=2, S=32, seed=1):
    return np.random.RandomState(seed).randn(B, S, S, 3).astype(np.float32)


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=atol, rtol=rtol)


def test_clip_parity_vs_transformers():
    from transformers import CLIPVisionConfig as HFCfg
    from transformers import CLIPVisionModel

    hf_cfg = HFCfg(hidden_size=32, intermediate_size=64,
                   num_hidden_layers=3, num_attention_heads=4,
                   image_size=32, patch_size=8, hidden_act="quick_gelu")
    torch.manual_seed(0)
    hf = CLIPVisionModel(hf_cfg).eval()
    pix = np.random.RandomState(0).randn(2, 3, 32, 32).astype(np.float32)
    with torch.no_grad():
        want = hf(torch.from_numpy(pix),
                  output_hidden_states=True).hidden_states[-2].numpy()
    imgs = pix.transpose(0, 2, 3, 1)
    for sel, ref in (("cls_patch", want), ("patch", want[:, 1:])):
        tcfg = tenc.ClipVisionConfig(**TINY, select_feature=sel)
        jcfg = jenc.ClipVisionConfig(**TINY, select_feature=sel)
        tp = tenc.convert_hf_clip_tower(hf.state_dict(), tcfg)
        jp = jenc.convert_hf_clip_tower(hf.state_dict(), jcfg)
        for name in ("patch_w", "pos_embed", "cls_embed"):
            np.testing.assert_array_equal(tp[name].numpy(),
                                          np.asarray(jp[name]))
        for impl in ("dense", "auto"):
            got = tenc.forward(tp, tcfg, torch.from_numpy(imgs),
                               attn_impl=impl).numpy()
            _close(got, ref, atol=2e-4, rtol=2e-3)
        _close(got, jenc.forward(jp, jcfg, jnp.asarray(imgs),
                                 attn_impl="dense"))


def test_mlcd_rope2d_tower():
    jcfg = jenc.ClipVisionConfig(**TINY, hidden_act="gelu", rope2d=True)
    tcfg = tenc.ClipVisionConfig(**TINY, hidden_act="gelu", rope2d=True)
    jp, tp = _pair(jcfg, tcfg)
    assert "pos_embed" not in tp and "class_pos_emb" in tp
    imgs = _images()
    out = tenc.forward(tp, tcfg, torch.from_numpy(imgs), attn_impl="dense")
    assert out.shape == (2, 16, 32)
    _close(out, jenc.forward(jp, jcfg, jnp.asarray(imgs),
                             attn_impl="dense"))
    # the rotary phases make the tower position-sensitive
    out2 = tenc.forward(tp, tcfg, torch.from_numpy(imgs[:, ::-1].copy()),
                        attn_impl="dense")
    assert not np.allclose(out.numpy(), out2.numpy())
    np.testing.assert_allclose(
        tenc._rope2d_freqs(tcfg, tp["class_pos_emb"]).numpy(),
        np.asarray(jenc._rope2d_freqs(jcfg, jp["class_pos_emb"])),
        rtol=1e-6, atol=1e-6)


def test_s2_wrapper():
    jcfg, tcfg = jenc.ClipVisionConfig(**TINY), tenc.ClipVisionConfig(**TINY)
    jp, tp = _pair(jcfg, tcfg)
    imgs = _images()

    def tf(im):
        return tenc.forward(tp, tcfg, im, attn_impl="dense")

    out = tenc.s2_forward(tf, torch.from_numpy(imgs), 32, (32, 64, 96))
    assert out.shape == (2, 16, 96)    # 3 scales x hidden 32
    # the scale-1 channels are exactly the plain forward
    np.testing.assert_array_equal(out[..., :32].numpy(),
                                  tf(torch.from_numpy(imgs)).numpy())
    want = jenc.s2_forward(
        lambda im: jenc.forward(jp, jcfg, im, attn_impl="dense"),
        jnp.asarray(imgs), 32, (32, 64, 96))
    _close(out, want)
    # the resize alone: jax.image.resize "bilinear" when upscaling
    big = torch.nn.functional.interpolate(
        torch.from_numpy(imgs).permute(0, 3, 1, 2), size=(96, 96),
        mode="bilinear", align_corners=False).permute(0, 2, 3, 1)
    np.testing.assert_allclose(
        big.numpy(), np.asarray(jax.image.resize(
            jnp.asarray(imgs), (2, 96, 96, 3), method="bilinear")),
        atol=2e-5, rtol=2e-5)


def test_builder_dispatch():
    kw = dict(num_layers=2, hidden_size=32, intermediate_size=64,
              num_heads=4, image_size=32, patch_size=8)
    name = "openai/clip-vit-large-patch14-336"
    cfg, init_fn, fwd = tenc.build_vision_tower(name, **kw)
    jcfg, _, jfwd = jenc.build_vision_tower(name, **kw)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.hidden_act == "quick_gelu"
    p = init_fn(cfg, torch.Generator().manual_seed(0), device="cpu",
                dtype=torch.float32)
    assert fwd(p, torch.zeros((1, 32, 32, 3)), attn_impl="dense").shape \
        == (1, 16, 32)
    jp, tp = _pair(jcfg, cfg)
    imgs = _images(1)
    _close(fwd(tp, torch.from_numpy(imgs)),
           jfwd(jp, jnp.asarray(imgs), attn_impl="dense"))

    for n in ("DeepGlint-AI/mlcd-vit-bigG-patch14-336",
              "laion/CLIP-ViT-bigG-14-laion2B-39B-b160k", "openai/other",
              "open_clip_hub:ViT-B", "x/mlcd-vit-bigG-patch14-448",
              "hf:some/tower", "ShareGPT4V-7B"):
        assert dataclasses.asdict(tenc.build_vision_tower(n)[0]) == \
            dataclasses.asdict(jenc.build_vision_tower(n)[0])
    cfg2 = tenc.build_vision_tower("DeepGlint-AI/mlcd-vit-bigG-patch14-336")[0]
    assert cfg2.rope2d and cfg2.hidden_size == 1664 and cfg2.head_dim == 104

    sig_cfg, sig_init, sig_fwd = tenc.build_vision_tower(
        "google/siglip-so400m-patch14-384")
    assert sig_cfg.hidden_size == 1152
    sc, si, sf = tenc.build_vision_tower(
        "google/siglip-tiny", hidden_size=32, intermediate_size=64,
        num_layers=2, num_heads=4, image_size=28, patch_size=14)
    sp = si(sc, device="cpu", dtype=torch.float32)
    assert sf(sp, torch.zeros((1, 28, 28, 3))).shape == (1, 4, 32)

    for bad, msg in (("imagebind_huge", "imagebind"),
                     ("not-a-tower", "Unknown vision tower")):
        for build in (tenc.build_vision_tower, jenc.build_vision_tower):
            with pytest.raises(ValueError, match=msg):
                build(bad)


def test_builder_s2_dispatch():
    kw = dict(s2=True, s2_scales=(32, 64), num_layers=2, hidden_size=32,
              intermediate_size=64, num_heads=4, image_size=32, patch_size=8)
    name = "openai/clip-vit-large-patch14-336"
    cfg, _, fwd = tenc.build_vision_tower(name, **kw)
    jcfg, _, jfwd = jenc.build_vision_tower(name, **kw)
    jp, tp = _pair(jcfg, cfg)
    imgs = _images(1)
    out = fwd(tp, torch.from_numpy(imgs), attn_impl="dense")
    assert out.shape == (1, 16, 64)
    _close(out, jfwd(jp, jnp.asarray(imgs), attn_impl="dense"))


def _mlcd_state(cfg, seed=3):
    rng = np.random.RandomState(seed)
    D, F, P = cfg.hidden_size, cfg.intermediate_size, cfg.patch_size
    state = {"vision_model.embeddings.patch_embedding.weight":
             rng.randn(D, 3, P, P).astype(np.float32),
             "vision_model.embeddings.class_embedding":
             rng.randn(D).astype(np.float32),
             "vision_model.pre_layrnorm.weight": np.ones(D, np.float32),
             "vision_model.pre_layrnorm.bias": np.zeros(D, np.float32),
             "vision_model.class_pos_emb":
             rng.randn(1, cfg.head_dim // 2).astype(np.float32)}
    for i in range(cfg.num_layers):
        lp = f"vision_model.encoder.layers.{i}."
        for nm in ("layer_norm1", "layer_norm2"):
            state[lp + nm + ".weight"] = 1 + 0.1 * rng.randn(D).astype(
                np.float32)
            state[lp + nm + ".bias"] = 0.1 * rng.randn(D).astype(np.float32)
        for nm in ("q_proj", "k_proj", "v_proj", "out_proj"):
            state[lp + f"self_attn.{nm}.weight"] = \
                rng.randn(D, D).astype(np.float32) * 0.05
            state[lp + f"self_attn.{nm}.bias"] = \
                rng.randn(D).astype(np.float32) * 0.05
        state[lp + "mlp.fc1.weight"] = rng.randn(F, D).astype(np.float32) \
            * 0.05
        state[lp + "mlp.fc1.bias"] = rng.randn(F).astype(np.float32) * 0.05
        state[lp + "mlp.fc2.weight"] = rng.randn(D, F).astype(np.float32) \
            * 0.05
        state[lp + "mlp.fc2.bias"] = rng.randn(D).astype(np.float32) * 0.05
    return state


def _assert_trees_equal(tp, jp):
    assert set(tp) == set(jp)
    for k in tp:
        if isinstance(tp[k], dict):
            _assert_trees_equal(tp[k], jp[k])
        else:
            np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))


def test_convert_rope2d_tower():
    """MLCD-style state: no position embeddings, a class_pos_emb; the two
    converters give one tree, bit for bit, and one forward."""
    tcfg = tenc.ClipVisionConfig(**TINY, hidden_act="gelu", rope2d=True)
    jcfg = jenc.ClipVisionConfig(**TINY, hidden_act="gelu", rope2d=True)
    state = _mlcd_state(tcfg)
    tp = tenc.convert_hf_clip_tower(state, tcfg)
    jp = jenc.convert_hf_clip_tower(state, jcfg)
    assert "class_pos_emb" in tp and "pos_embed" not in tp
    _assert_trees_equal(tp, jp)
    imgs = _images(1)
    out = tenc.forward(tp, tcfg, torch.from_numpy(imgs), attn_impl="dense")
    assert out.shape == (1, 16, 32) and torch.isfinite(out).all()
    _close(out, jenc.forward(jp, jcfg, jnp.asarray(imgs),
                             attn_impl="dense"))
    with pytest.raises(KeyError, match="class_pos_emb"):
        tenc.convert_hf_clip_tower(
            {k: v for k, v in state.items() if "class_pos" not in k}, tcfg)


_EVA = {
    "eva01": dict(hidden_size=32, intermediate_size=64, num_layers=3,
                  num_heads=2, image_size=32, patch_size=8),
    "eva02": dict(hidden_size=32, intermediate_size=48, num_layers=3,
                  num_heads=2, image_size=32, patch_size=8, subln=True,
                  swiglu=True, rope2d=True, intp_freq=True,
                  pt_hw_seq_len=8),
    "postnorm_layer_scale": dict(hidden_size=32, intermediate_size=64,
                                 num_layers=3, num_heads=2, image_size=32,
                                 patch_size=8, postnorm=True,
                                 layer_scale=True),
}


@pytest.mark.parametrize("variant", sorted(_EVA))
def test_eva_tower_parity(variant):
    tcfg = tenc.EvaVisionConfig(**_EVA[variant])
    jcfg = jenc.EvaVisionConfig(**_EVA[variant])
    state = _rand_eva_state(jcfg)
    if tcfg.layer_scale:
        rng = np.random.RandomState(5)
        for i in range(tcfg.num_layers - 1):
            for g in ("gamma_1", "gamma_2"):
                state[f"blocks.{i}.{g}"] = (1 + 0.1 * rng.randn(32)).astype(
                    np.float32)
    pix = np.random.RandomState(1).randn(2, 3, 32, 32).astype(np.float32)
    imgs = pix.transpose(0, 2, 3, 1)
    tp = tenc.convert_eva_tower(state, tcfg)
    jp = jenc.convert_eva_tower(state, jcfg)
    _assert_trees_equal(tp, jp)
    got = tenc.eva_forward(tp, tcfg, torch.from_numpy(imgs),
                           attn_impl="dense")
    assert got.shape == (2, tcfg.num_patches, tcfg.hidden_size)
    _close(got, jenc.eva_forward(jp, jcfg, jnp.asarray(imgs),
                                 attn_impl="dense"))
    if not tcfg.postnorm:   # the reference-semantics torch oracle
        with torch.no_grad():
            want = _torch_eva(jcfg, state, torch.from_numpy(pix)).numpy()
        _close(got, want, atol=2e-5, rtol=2e-5)
    # the plain vit path ("auto" on the CPU) is the same function
    _close(tenc.eva_forward(tp, tcfg, torch.from_numpy(imgs)), got)
    if tcfg.rope2d:
        np.testing.assert_allclose(
            tenc._eva_rope_freqs(tcfg, "cpu").numpy(),
            np.asarray(jenc._eva_rope_freqs(jcfg)), rtol=1e-6, atol=1e-6)


def test_eva_builder_dispatch():
    kw = dict(hidden_size=32, intermediate_size=48, num_layers=3,
              num_heads=2, image_size=32, patch_size=8, pt_hw_seq_len=8)
    cfg, init_fn, fwd = tenc.build_vision_tower("EVA02-CLIP-L-14-336", **kw)
    jcfg, _, jfwd = jenc.build_vision_tower("EVA02-CLIP-L-14-336", **kw)
    assert isinstance(cfg, tenc.EvaVisionConfig) and cfg.swiglu \
        and cfg.subln
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    p = init_fn(cfg, torch.Generator().manual_seed(0), device="cpu",
                dtype=torch.float32)
    assert fwd(p, torch.zeros((1, 32, 32, 3)), attn_impl="dense").shape \
        == (1, cfg.num_patches, 32)
    jp, tp = _pair(jcfg, cfg)
    imgs = _images(1)
    _close(fwd(tp, torch.from_numpy(imgs)),
           jfwd(jp, jnp.asarray(imgs), attn_impl="dense"))
    for name in ("EVA01-CLIP-g-14", "EVA01-CLIP-g-14-plus",
                 "EVA02-CLIP-B-16", "EVA02-CLIP-L-14", "org/EVA02-CLIP-L-14"):
        assert dataclasses.asdict(tenc.build_vision_tower(name)[0]) == \
            dataclasses.asdict(jenc.build_vision_tower(name)[0])
    assert tenc.build_vision_tower("EVA01-CLIP-g-14")[0].head_dim == 88
    for bad, msg in (("EVA-CLIP-8B", "use_rms_norm"),
                     ("EVA-CLIP-18B-plus", "use_rms_norm"),
                     ("EVA03-nothing", "Unknown EVA tower")):
        for build in (tenc.build_vision_tower, jenc.build_vision_tower):
            with pytest.raises(ValueError, match=msg):
                build(bad)


@pytest.mark.parametrize("S,D", [(40, 88), (57, 104)])
def test_vit_plain_at_zoo_head_dims_matches_pallas(S, D):
    """K1's plain version at EVA01-g's (88) and the bigG towers' (104)
    head dims against the JAX package's Pallas kernel in interpret mode,
    which pads D to 128 lanes."""
    rng = np.random.RandomState(0)
    q, k, v = (rng.randn(2, S, 3, D).astype(np.float32) for _ in range(3))
    want = np.asarray(jax_vit(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), interpret=True))
    got = va.vit_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        va.vit_attention(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v)).numpy(), want,
        rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("D", [88, 104, 64])
def test_zoo_head_dims_reach_the_kernel_path(D):
    """Off the CPU, "auto" sends the zoo's shapes to K1, which takes these
    head dims: meta tensors stand in for device tensors, so the call
    reaches the wrapper's device check (a kernel head dim) and never the
    dense path."""
    assert D in va.KERNEL_HEAD_DIMS
    x = torch.zeros((1, 257, 16, D), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        mha_attention(x, x, x)
    assert mha_attention(x, x, x, impl="dense").device.type == "meta"


@pytest.mark.parametrize("D", [100, 60, 36])
def test_kernel_path_refuses_head_dims_not_a_multiple_of_8(D):
    """TMA needs 16-byte strides: the kernel path refuses a head dim that
    is not a multiple of 8 before anything else, on any non-CPU tensor;
    the CPU's plain version takes it."""
    x = torch.zeros((1, 16, 2, D), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="not a multiple of 8"):
        va.vit_attention(x, x, x)
    with pytest.raises(ValueError, match="not a multiple of 8"):
        mha_attention(x, x, x)
    y = torch.randn((1, 16, 2, D))
    assert va.vit_attention(y, y, y).shape == y.shape
