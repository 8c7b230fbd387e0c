"""The port's quantization, int4 products, projection fusion and f32
products against the JAX package, on the CPU.

Inputs are made with numpy from fixed seeds and fed to both sides; the
JAX int4 kernels run as Pallas in interpret mode. Tolerances: packed
bytes and scales bit for bit (the same f32 arithmetic and rounding);
int4 products in f32 rtol = atol = 2e-5 (f32 summation order: the Pallas
kernels sum 256-row chunks, the plain versions densely); the bf16
products |err| <= 1e-5 |ref| + 1e-6 (the f32 sum kept on both sides).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamvln_tpu import configs as jcfg
from streamvln_tpu.models import fuse as jfuse
from streamvln_tpu.models import qwen2 as jqwen2
from streamvln_tpu.models import quant as jquant
from streamvln_tpu.models import streamvln as jsv
from streamvln_tpu.ops import int4_matmul as jint4
from streamvln_tpu_torch import configs as tcfg
from streamvln_tpu_torch.models import fuse as tfuse
from streamvln_tpu_torch.models import qwen2 as tqwen2
from streamvln_tpu_torch.models import quant as tquant
from streamvln_tpu_torch.ops import int4_matmul as tint4
from streamvln_tpu_torch.weights import from_jax_params

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _w(shape, seed=0, scale=0.02):
    return (np.random.RandomState(seed).randn(*shape) * scale) \
        .astype(np.float32)


@pytest.mark.parametrize("shape", [(2, 512, 384), (3, 96, 40), (70, 8)])
def test_quantize_weights_bit_equal_to_jax(shape):
    """int8 per-column and packed int4 (a din that 64 does not divide takes
    one group, as in JAX); an all-zero column gets scale 1."""
    w = _w(shape, 1)
    w[..., 3] = 0.0
    for jfn, tfn in ((jquant.quantize_weight, tquant.quantize_weight),
                     (jquant.quantize_weight_int4,
                      tquant.quantize_weight_int4)):
        jq, js = jfn(jnp.asarray(w))
        tq, ts = tfn(torch.from_numpy(w))
        assert tq.dtype == getattr(torch, str(jq.dtype))
        assert ts.dtype == torch.float32
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequant_int4_matches_jax(dtype):
    jp, js = jquant.quantize_weight_int4(jnp.asarray(_w((2, 256, 64), 2)))
    want = np.asarray(jquant.dequant_int4(jp, js, getattr(jnp, dtype))
                      .astype(jnp.float32))
    got = tquant.dequant_int4(torch.from_numpy(np.asarray(jp)),
                              torch.from_numpy(np.asarray(js)),
                              getattr(torch, dtype)).float().numpy()
    np.testing.assert_array_equal(got, want)


def _packed(l=2, din=512, dout=512, seed=0):
    jp, js = jquant.quantize_weight_int4(jnp.asarray(_w((l, din, dout), seed)))
    return jp, js, torch.from_numpy(np.asarray(jp)), \
        torch.from_numpy(np.asarray(js))


@pytest.mark.parametrize("m", [1, 8, 20])
def test_int4_matmul_plain_matches_pallas(m):
    jp, js, tp, ts = _packed()
    x = np.random.RandomState(1).randn(m, 512).astype(np.float32)
    n0 = tint4.launches
    for layer in (0, 1):
        want = jint4.int4_matmul(jnp.asarray(x), jp, js, jnp.int32(layer),
                                 True)
        got = tint4.int4_matmul(torch.from_numpy(x), tp, ts, layer)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-5, atol=2e-5)
    assert tint4.launches == n0          # CPU: the plain version only


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int4_dequant_split_plain_matches_pallas(dtype):
    """K7's split layout: [low-nibble rows; high-nibble rows], each value
    nibble * scale in f32 rounded once, bit for bit."""
    jp, js, tp, ts = _packed(din=1024, dout=1024, seed=3)
    for layer in (0, 1):
        want = jint4.int4_dequant_split(jp, js, jnp.int32(layer),
                                        getattr(jnp, dtype), True)
        got = tint4.int4_dequant_split(tp, ts, layer, getattr(torch, dtype))
        assert got.shape == (2, 512, 1024)
        np.testing.assert_array_equal(
            got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_int4_prefill_matmul_plain_matches_pallas():
    jp, js, tp, ts = _packed(seed=4)
    x = np.random.RandomState(5).randn(192, 512).astype(np.float32)
    want = jint4.int4_prefill_matmul(jnp.asarray(x), jp, js, jnp.int32(1),
                                     True)
    got = tint4.int4_prefill_matmul(torch.from_numpy(x), tp, ts, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    xs = torch.from_numpy(x)
    assert torch.equal(tint4._merge_cols(tint4._split_cols(xs)), xs)


def test_int4_kernel_eligibility_and_forward_only():
    _, _, tp, ts = _packed()
    assert tint4.int4_kernel_eligible(tp, ts)
    assert not tint4.int4_kernel_eligible(tp[0], ts[0])        # unstacked
    _, _, tp2, ts2 = _packed(din=256)
    assert not tint4.int4_kernel_eligible(tp2, ts2)
    _, _, tp3, ts3 = _packed(dout=384)
    assert not tint4.int4_kernel_eligible(tp3, ts3)
    # both products take a gradient in x (QLoRA; before the quantized tail
    # they refused one): dx = g @ w.T of the layer's f32 dequant, and no
    # gradient for the packed weight or its scales
    x = torch.randn((4, 512), generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    g = torch.randn((4, 512), generator=torch.Generator().manual_seed(1))
    w = tquant.dequant_int4(tp[0], ts[0], torch.float32)
    for fn in (tint4.int4_matmul, tint4.int4_prefill_matmul):
        (dx,) = torch.autograd.grad(fn(x, tp, ts, 0), x, g)
        torch.testing.assert_close(dx, g @ w.t(), rtol=2e-5, atol=2e-5)
    assert tp.grad is None and ts.grad is None
    with torch.no_grad():
        assert tint4.int4_matmul(x, tp, ts, 0).shape == (4, 512)


@functools.lru_cache(maxsize=1)
def _jax_tiny_init():
    return jax.tree.map(np.asarray,
                        jsv.init(jax.random.PRNGKey(0), jcfg.tiny_streamvln()))


def _jax_tiny_tree():
    """A fresh tree structure over the shared (read-only) leaves."""
    return jax.tree.map(lambda a: a, _jax_tiny_init())


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(a) for p, a in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _to_np(tree):
    return jax.tree.map(lambda t: t.numpy(), tree)


@pytest.mark.parametrize("bits", [None, 8, 4])
def test_fuse_projections_matches_jax(bits):
    tree = _jax_tiny_tree()
    if bits:
        tree = jax.tree.map(np.asarray, jquant.quantize_llm(tree, bits=bits))
    want = _flat(jfuse.fuse_projections(tree))
    ttree = from_jax_params(tree, tcfg.tiny_streamvln(), device="cpu")
    fused = tfuse.fuse_projections(ttree)
    got = _flat(_to_np(fused))
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    assert "q_w" in ttree["llm"]["layers"]             # input not changed
    assert tfuse.fuse_projections(fused)["llm"]["layers"].keys() == \
        fused["llm"]["layers"].keys()                  # fused: no-op


def test_fuse_skips_lora_and_mixed_groups():
    layers = {"q_w": torch.zeros(2, 8, 8), "k_w": torch.zeros(2, 8, 4),
              "v_w": torch.zeros(2, 8, 4), "q_w_lora_a": torch.zeros(2, 8, 1),
              "gate_w": torch.zeros(2, 8, 8),
              "up_w": torch.zeros(2, 8, 8, dtype=torch.int8)}
    out = tfuse.fuse_projections({"layers": layers})["layers"]
    assert "qkv_w" not in out and "gu_w" not in out
    jl = {k: jnp.asarray(v.numpy()) for k, v in layers.items()}
    assert sorted(jfuse.fuse_projections({"layers": jl})["layers"]) == \
        sorted(out)


def test_from_jax_params_quantized_fused_tree():
    """A tree quantized to int4 (int8 embed) and fused: uint8/int8 leaves
    keep their dtype and bytes, every scale stays f32, float leaves take
    the requested dtype; a fused stack beside its unfused members is
    refused."""
    tree = jax.tree.map(np.asarray, jfuse.fuse_projections(
        jquant.quantize_llm(_jax_tiny_tree(), bits=4, quantize_embed=True)))
    got = from_jax_params(tree, tcfg.tiny_streamvln(), device="cpu",
                          dtype=torch.bfloat16)
    llm, layers = got["llm"], got["llm"]["layers"]
    assert layers["qkv_w"].dtype == torch.uint8
    assert layers["gu_w"].dtype == torch.uint8
    assert llm["embed"].dtype == torch.int8
    for key in ("qkv_w_scale", "gu_w_scale", "o_w_scale", "down_w_scale"):
        assert layers[key].dtype == torch.float32
    assert llm["embed_scale"].dtype == torch.float32
    assert layers["qkv_b"].dtype == torch.bfloat16
    assert got["vision"]["layers"]["q_w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(layers["gu_w"].numpy(),
                                  tree["llm"]["layers"]["gu_w"])
    np.testing.assert_array_equal(layers["qkv_w_scale"].numpy(),
                                  tree["llm"]["layers"]["qkv_w_scale"])
    bad = jax.tree.map(np.asarray, _jax_tiny_tree())
    bad["llm"]["layers"]["gu_w"] = bad["llm"]["layers"]["up_w"]
    with pytest.raises(ValueError, match="fused"):
        from_jax_params(bad, tcfg.tiny_streamvln(), device="cpu")


def test_dequantize_llm_and_embed_match_jax():
    tree = jax.tree.map(np.asarray, jquant.quantize_llm(
        _jax_tiny_tree(), bits=4, quantize_embed=True))
    ttree = from_jax_params(tree, tcfg.tiny_streamvln(), device="cpu")
    want = _flat(jquant.dequantize_llm(tree)["llm"])
    got = _flat(_to_np(tquant.dequantize_llm(ttree)["llm"]))
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    ids = np.asarray([[3, -1, 7, 500]], np.int32)
    np.testing.assert_array_equal(
        tqwen2.embed_tokens(ttree["llm"], torch.from_numpy(ids)).numpy(),
        np.asarray(jqwen2.embed_tokens(tree["llm"], jnp.asarray(ids))))


def _grid(rng, shape, den):
    """bf16-exact values k/den, |k| <= 4: products and their f32 sums over
    a few hundred terms are exact, whatever the summation order."""
    return (rng.integers(-4, 5, shape) / den).astype(np.float32)


def _close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = np.abs(got - want)
    assert (err <= 1e-5 * np.abs(want) + 1e-6).all(), err.max()


def test_bf16_products_keep_f32_sum_like_jax():
    """bf16 `_proj` (float weights with a bias, int8 weights) and
    `lm_head_logits`: the port keeps the f32 sum and rounds once, after
    the f32 bias add (the lm_head's logits stay f32), as JAX's
    preferred_element_type=f32 products do. A product rounded to bf16
    before the bias add, or bf16 logits, are off by up to 2^-9 |ref|."""
    rng = np.random.default_rng(7)
    x = _grid(rng, (3, 5, 256), 8)
    p = {"q_w": _grid(rng, (256, 384), 64),
         "q_b": rng.standard_normal(384).astype(np.float32),
         "o_w": _w((256, 128), 8, 0.05)}
    p["o_w"], p["o_w_scale"] = (np.asarray(a) for a in
                                jquant.quantize_weight(jnp.asarray(p["o_w"])))
    tb = {k: torch.from_numpy(v).to(torch.bfloat16)
          if v.dtype == np.float32 and not k.endswith("_scale")
          else torch.from_numpy(v) for k, v in p.items()}
    jb = {k: jnp.asarray(v.float().numpy(), jnp.bfloat16)
          if v.dtype == torch.bfloat16 else jnp.asarray(v.numpy())
          for k, v in tb.items()}
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    for name in ("q_w", "o_w"):
        want = jqwen2._proj(jx, jb, name).astype(jnp.float32)
        got = tqwen2._proj(tx, tb, name)
        assert got.dtype == torch.bfloat16
        _close(got.float().numpy(), want)

    h = rng.standard_normal((2, 1, 256)).astype(np.float32)
    head = (rng.standard_normal((256, 1000)) * 0.06).astype(np.float32)
    jh = {"lm_head": jnp.asarray(head, jnp.bfloat16)}
    th = {"lm_head": torch.from_numpy(head).to(torch.bfloat16)}
    want = jqwen2.lm_head_logits(jh, jnp.asarray(h, jnp.bfloat16))
    got = tqwen2.lm_head_logits(th, torch.from_numpy(h).to(torch.bfloat16))
    assert got.dtype == torch.float32
    _close(got.numpy(), want)


def test_init_quantized_llm_layout_matches_jax():
    """Random init straight into int4: the JAX init's tree (keys, shapes,
    dtypes), nibbles within [-7, 7], fan-in-scaled weights; bits=8 gives
    int8 stacks with [L, 1, dout] scales."""
    tc = tcfg.tiny_llm()
    want = _flat(jax.tree.map(np.asarray, jquant.init_quantized_llm(
        jax.random.PRNGKey(0), jcfg.tiny_llm(), jnp.float32, bits=4)))
    got4 = tquant.init_quantized_llm(tc, torch.Generator().manual_seed(0),
                                     "cpu", torch.float32, bits=4)
    got = _flat(_to_np(got4))
    assert sorted(got) == sorted(want)
    for key in want:
        assert (got[key].shape, got[key].dtype) == (want[key].shape,
                                                     want[key].dtype), key
    lo, hi = tint4.unpack_nibbles(got4["layers"]["q_w"])
    assert int(lo.abs().max()) <= 7 and int(hi.abs().max()) <= 7
    q = tquant.dequant_int4(got4["layers"]["q_w"],
                            got4["layers"]["q_w_scale"], torch.float32)
    assert abs(q.std().item() - tc.hidden_size ** -0.5) < 0.03
    got8 = tquant.init_quantized_llm(tc, torch.Generator().manual_seed(0),
                                     "cpu", torch.float32, bits=8)
    assert got8["layers"]["down_w"].dtype == torch.int8
    assert got8["layers"]["down_w_scale"].shape == (
        tc.num_layers, 1, tc.hidden_size)


def test_maybe_dequant():
    p = {k: torch.from_numpy(np.asarray(v)) for k, v in zip(
        ("w", "w_scale"), jquant.quantize_weight(jnp.asarray(_w((64, 8)))))}
    want = jquant.maybe_dequant({k: jnp.asarray(v.numpy())
                                 for k, v in p.items()}, "w", jnp.float32)
    np.testing.assert_array_equal(
        tquant.maybe_dequant(p, "w", torch.float32).numpy(), np.asarray(want))
    w4, s4 = tquant.quantize_weight_int4(torch.from_numpy(_w((64, 8))))
    p4 = {"w": w4, "w_scale": s4, "f": torch.ones(2)}
    assert torch.equal(tquant.maybe_dequant(p4, "w", torch.float32),
                       tquant.dequant_int4(w4, s4, torch.float32))
    assert tquant.maybe_dequant(p4, "f") is p4["f"]
