"""int8 activations in the port against the JAX package, on the CPU:
`int8_dynamic_matmul` (its int32 product exact, its forward and its
straight-through gradient against `jax.grad`), `quantize_vision`, the
int8 tower (`siglip.forward` on a `quantize_vision` tree), and an
`act_int8` decoder (quantize_llm(bits=8), cfg.act_int8) in its logits, a
LoRA gradient and a `make_train_step` trajectory.

Tolerances: the quantizers are bit-equal. int8_dynamic_matmul's forward
rtol 1e-6 (the same f32 arithmetic on an exact int32 product) and its
gradient rtol 1e-5 / atol 1e-6 (one f32 product per side). Through a
stack of int8 products an activation an f32 ulp from a rounding boundary
can round to the neighbouring code on the other side, moving that
product by up to one code step (absmax / 127 of its row): the tower is
held to 2e-3 of its output's largest magnitude, the decoder's logits and
LoRA gradients to atol 2e-3 / rtol 2e-3, and the train step's parameters
to atol 2e-5 / rtol 2e-4 (tests/test_parallel.py:100-101).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamvln_tpu import configs as jcfg
from streamvln_tpu.models import lora as jlora
from streamvln_tpu.models import quant as jquant
from streamvln_tpu.models import qwen2 as jqwen2
from streamvln_tpu.models import siglip as jsiglip
from streamvln_tpu_torch import configs as tcfg
from streamvln_tpu_torch.models import quant as tquant
from streamvln_tpu_torch.models import qwen2 as tqwen2
from streamvln_tpu_torch.models import siglip as tsiglip

torch.backends.cuda.matmul.allow_tf32 = False


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True))


@pytest.mark.parametrize("shape", [(4, 64), (2, 3, 64)])
def test_int8_dynamic_matmul_exact_and_its_ste_gradient(shape):
    """The int32 product equals the integer product of the quantized rows
    and weights; the f32 result equals JAX's; d(sum(out * c))/dx equals
    jax.grad, including the rows' absmax entries, which sit exactly at the
    +-127 clip and pass half their gradient there in both packages."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32)
    x[0, ..., 5] = 0.0
    w = (rng.standard_normal((64, 32)) * 0.05).astype(np.float32)
    c = rng.standard_normal(shape[:-1] + (32,)).astype(np.float32)
    jq, js = jquant.quantize_weight(jnp.asarray(w))
    tq, ts = tquant.quantize_weight(torch.from_numpy(w))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))

    want, vjp = jax.vjp(lambda a: jquant.int8_dynamic_matmul(a, jq, js),
                        jnp.asarray(x))
    (jg,) = vjp(jnp.asarray(c))
    xt = torch.from_numpy(x).requires_grad_()
    got = tquant.int8_dynamic_matmul(xt, tq, ts)
    (tg,) = torch.autograd.grad(got, xt, torch.from_numpy(c))
    assert got.dtype == torch.float32 and got.shape == shape[:-1] + (32,)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-6)

    # the int32 product is exact: the quantized rows times the weights
    x2 = x.reshape(-1, 64)
    amax = np.maximum(np.abs(x2).max(-1, keepdims=True), 1e-8) / 127
    xq = np.clip(np.round(x2 / amax), -127, 127).astype(np.int8)
    acc = tquant._int_mm(torch.from_numpy(xq), tq)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(
        acc.numpy(), xq.astype(np.int64) @ np.asarray(jq).astype(np.int64))


def test_int8_product_refuses_what_the_card_cannot_take():
    """Off the CPU the int32 product needs K and N multiples of 8; other
    shapes raise instead of switching to an inexact f32 product (meta
    tensors stand in for device tensors)."""
    a = torch.zeros((4, 12), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="multiples of 8"):
        tquant._int_mm(a, torch.zeros((12, 16), dtype=torch.int8,
                                      device="meta"))
    with pytest.raises(ValueError, match="multiples of 8"):
        tquant._int_mm(a[:, :8], torch.zeros((8, 12), dtype=torch.int8,
                                             device="meta"))


@pytest.fixture(scope="module")
def tower():
    cfg = jcfg.tiny_vision()
    jp = jax.tree.map(np.asarray, jsiglip.init(jax.random.PRNGKey(5), cfg))
    imgs = np.asarray(jax.random.uniform(
        jax.random.PRNGKey(6), (2, cfg.image_size, cfg.image_size, 3)))
    return cfg, jp, imgs


def test_quantize_vision_and_the_int8_tower_match_jax(tower):
    """quantize_vision bit for bit (q/k/v/o, fc1/fc2 int8 with per-column
    scales; everything else untouched); the int8 tower's output against
    JAX's int8 tower, and within the reference test's bounds of the float
    tower (tests/test_siglip.py: relative error < 0.05, per-token cosine
    > 0.999)."""
    cfg, jp, imgs = tower
    jq = jax.tree.map(np.asarray, jquant.quantize_vision(jp))
    tq = tquant.quantize_vision(_t(jp))
    assert set(tq["layers"]) == set(jq["layers"])
    for k, v in jq["layers"].items():
        assert tq["layers"][k].dtype == torch.from_numpy(v).dtype, k
        np.testing.assert_array_equal(tq["layers"][k].numpy(), v, err_msg=k)
    assert tq["layers"]["fc1_w"].dtype == torch.int8
    assert tq["patch_w"].dtype == torch.float32
    tcf = tcfg.SigLIPConfig(**dataclasses.asdict(cfg))
    want = np.asarray(jsiglip.forward(jq, cfg, jnp.asarray(imgs)))
    got = tsiglip.forward(tq, tcf, torch.from_numpy(imgs)).numpy()
    assert np.abs(got - want).max() <= 2e-3 * np.abs(want).max()
    ref = np.asarray(jsiglip.forward(jp, cfg, jnp.asarray(imgs)))
    assert np.abs(got - ref).max() / np.abs(ref).max() < 0.05
    cos = (got * ref).sum(-1) / (np.linalg.norm(got, axis=-1)
                                 * np.linalg.norm(ref, axis=-1))
    assert cos.min() > 0.999


@pytest.fixture(scope="module")
def llm8():
    jc = dataclasses.replace(jcfg.tiny_llm(), act_int8=True)
    tc = tcfg.Qwen2Config(**dataclasses.asdict(jc))
    jp = jlora.add_lora({"llm": jqwen2.init(jax.random.PRNGKey(0), jc,
                                            jnp.float32)},
                        jax.random.PRNGKey(1), jc, rank=4)
    rng = np.random.default_rng(2)
    jp = jquant.quantize_llm(jp, bits=8)
    layers = dict(jp["llm"]["layers"])
    for k in list(layers):
        if k.endswith("_lora_b"):
            layers[k] = jnp.asarray(rng.standard_normal(layers[k].shape)
                                    * 0.05, jnp.float32)
    jp = dict(jp, llm=dict(jp["llm"], layers=layers))
    return jc, tc, jax.tree.map(np.asarray, jp)


def test_act_int8_decoder_logits_and_lora_grads_match_jax(llm8):
    """quantize_llm(bits=8) with cfg.act_int8 on a LoRA-carrying tiny
    decoder: the full forward's logits, and the gradient of a weighted
    sum of them with respect to every adapter, against JAX (whose int8
    projections run int8_dynamic_matmul); the act_int8 logits also stay
    within the reference test's bound of the weight-only int8 logits
    (tests/test_quant.py::test_act_int8_forward_close)."""
    jc, tc, jp = llm8
    rng = np.random.default_rng(3)
    B, S = 2, 10
    emb = rng.standard_normal((B, S, jc.hidden_size)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    c = rng.standard_normal((B, S, jc.vocab_size)).astype(np.float32)
    names = sorted(k for k in jp["llm"]["layers"] if "_lora_" in k)

    def jloss(ad):
        llm = dict(jp["llm"], layers=dict(jp["llm"]["layers"], **ad))
        out, _ = jqwen2.forward(llm, jc, jnp.asarray(emb), jnp.asarray(pos),
                                attn_impl="dense")
        return (out * c).sum(), out
    (_, jl), jg = jax.value_and_grad(jloss, has_aux=True)(
        {k: jnp.asarray(jp["llm"]["layers"][k]) for k in names})

    tp = _t(jp["llm"])
    leaves = [tp["layers"][k].requires_grad_() for k in names]
    tl, _ = tqwen2.forward(tp, tc, torch.from_numpy(emb),
                           torch.from_numpy(pos), attn_impl="dense")
    tg = torch.autograd.grad((tl * torch.from_numpy(c)).sum(), leaves)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               atol=2e-3, rtol=2e-3)
    for k, g in zip(names, tg):
        assert np.abs(g.numpy()).max() > 0, k
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[k]), atol=2e-3,
                                   rtol=2e-3, err_msg=k)
    with torch.no_grad():
        w8, _ = tqwen2.forward(tp, dataclasses.replace(tc, act_int8=False),
                               torch.from_numpy(emb), torch.from_numpy(pos),
                               attn_impl="dense")
    pr, po = torch.softmax(w8, -1), torch.softmax(tl.detach(), -1)
    assert (pr - po).abs().max() < 0.08


def test_act_int8_train_step_matches_jax():
    """Two optimizer steps of make_train_step (lora_only) on tiny_streamvln
    with quantize_llm(bits=8) and cfg.llm.act_int8, against the JAX step
    on a one-device mesh: loss, grad norm and every parameter after each
    step; the int8 weights and their scales stay bit-exact. (The JAX step
    takes no gradient accumulation here: optax.MultiSteps subtracts the
    int8 leaves' float0 gradients and raises.)"""
    from streamvln_tpu.models import streamvln as jsv
    from streamvln_tpu.parallel import mesh as jmesh
    from streamvln_tpu.parallel import train as jtrain
    from streamvln_tpu_torch.parallel import train as ttrain
    from streamvln_tpu_torch.weights import from_jax_params
    from test_torch_train import _batch, _flat

    jc = jcfg.tiny_streamvln()
    jc = dataclasses.replace(jc, llm=dataclasses.replace(jc.llm,
                                                         act_int8=True))
    tc = tcfg.StreamVLNConfig(
        vision=tcfg.SigLIPConfig(**dataclasses.asdict(jc.vision)),
        llm=tcfg.Qwen2Config(**dataclasses.asdict(jc.llm)),
        **{f.name: getattr(jc, f.name) for f in dataclasses.fields(jc)
           if f.name not in ("vision", "llm")})
    jp = jquant.quantize_llm(jsv.init(jax.random.PRNGKey(0), jc), bits=8)
    jp = jlora.add_lora(jp, jax.random.PRNGKey(6), jc.llm, rank=4)
    jp = jax.tree.map(np.asarray, jp)
    kw = dict(learning_rate=1e-3, total_steps=4, warmup_ratio=0.2,
              loss_chunk_size=64, lora_only=True)
    jt, tt = jtrain.TrainConfig(**kw), ttrain.TrainConfig(**kw)
    mesh = jmesh.make_mesh(dp=1, fsdp=1, tp=1, devices=jax.devices()[:1])
    jstate = jtrain.create_train_state(jax.tree.map(jnp.array, jp), jt)
    jstep = jtrain.make_train_step(jc, jt, mesh)
    tstate = ttrain.create_train_state(from_jax_params(jp, tc, device="cpu"),
                                       tt)
    tstep = ttrain.make_train_step(tc, tt, device="cpu")
    frozen = {p: t.clone() for p, t in ttrain.tree_leaves(tstate.params)
              if not t.is_floating_point() or p.endswith("_scale")}
    assert any(t.dtype == torch.int8 for t in frozen.values())
    for i in range(2):
        b = _batch(jc, 11 + i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tm = tstep(tstate, b)
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=2e-3)
        want = _flat(jstate.params)
        for p, t in ttrain.tree_leaves(tstate.params):
            if p in frozen:
                assert torch.equal(t, frozen[p]), p
            np.testing.assert_allclose(t.detach().numpy(), want[p],
                                       atol=2e-5, rtol=2e-4,
                                       err_msg=f"step {i} {p}")
