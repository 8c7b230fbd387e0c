"""QLoRA in the port against the JAX package, on the CPU: the gradients of
the two packed-int4 products against the reference's custom VJPs (the
Pallas kernels in interpret mode), `merge_lora` into int8 and packed-int4
weights, and a two-step QLoRA trajectory through `make_train_step` on a
kernel-eligible decoder, with the frozen packed leaves bit-exact.

Tolerances: gradients rtol 2e-4 / atol 2e-5 (f32 sums in another order);
the merged weights and scales bit for bit (the same f32 arithmetic and
rounding); the trajectory's loss rtol 1e-5 and parameters rtol 2e-4 /
atol 2e-5.
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
from streamvln_tpu.models import streamvln as jsv
from streamvln_tpu.ops import int4_matmul as jint4
from streamvln_tpu_torch import configs as tcfg
from streamvln_tpu_torch.models import lora as tlora
from streamvln_tpu_torch.models import quant as tquant
from streamvln_tpu_torch.ops import int4_matmul as tint4

torch.backends.cuda.matmul.allow_tf32 = False
ATOL, RTOL = 2e-5, 2e-4


def _packed(din=512, dout=512, seed=0, L=2):
    w = (np.random.RandomState(seed).randn(L, din, dout) * 0.02).astype(
        np.float32)
    jp, js = jquant.quantize_weight_int4(jnp.asarray(w))
    return jp, js, torch.from_numpy(np.asarray(jp)), \
        torch.from_numpy(np.asarray(js))


@pytest.mark.parametrize("fn,rows", [("int4_matmul", 7),
                                     ("int4_matmul", 128),
                                     ("int4_prefill_matmul", 192)])
def test_int4_product_grads_match_the_reference_vjp(fn, rows):
    """d<out, g>/dx of K6's product (<= KERNEL_MAX_ROWS rows: the f32
    dequant of the layer, dx = g @ w.T) and of K7's (above: K7 again in
    x's dtype, g @ w2.T, the columns merged back) against jax.vjp of the
    reference's custom VJPs, on layer 1 of a two-layer stack; the packed
    weights and scales get no gradient, and on the CPU nothing launches."""
    jp, js, tp, ts = _packed(seed=rows)
    rng = np.random.default_rng(rows)
    x = rng.standard_normal((rows, 512)).astype(np.float32)
    g = rng.standard_normal((rows, 512)).astype(np.float32)
    want, vjp = jax.vjp(lambda a: getattr(jint4, fn)(
        a, jp, js, jnp.int32(1), True), jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    n = (tint4.launches, tint4.dequant_launches)
    out = getattr(tint4, fn)(xt, tp, ts, 1)
    (dx,) = torch.autograd.grad(out, xt, torch.from_numpy(g))
    assert (tint4.launches, tint4.dequant_launches) == n
    assert not tp.requires_grad and tp.grad is None and ts.grad is None
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)
    assert dx.dtype == torch.float32
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), atol=ATOL,
                               rtol=RTOL)


def test_int4_backward_rounds_as_the_reference_in_bf16():
    """In bf16 the two backwards round differently, as the reference's do:
    K6's computes g @ w in f32 from the unrounded f32 dequant and casts
    once; K7's casts g to bf16 and multiplies by the bf16 unpack. Both
    against float64 products of the same operands, within one bf16
    rounding of the result (2^-8 |ref|) and f32 accumulation
    (2^-16 sum |g| |w|)."""
    _, _, tp, ts = _packed(seed=5)
    rng = np.random.default_rng(5)
    for fn, rows in (("int4_matmul", 7), ("int4_prefill_matmul", 192)):
        x = torch.from_numpy(rng.standard_normal((rows, 512)).astype(
            np.float32)).bfloat16().requires_grad_()
        g = torch.from_numpy(rng.standard_normal((rows, 512)).astype(
            np.float32))
        (dx,) = torch.autograd.grad(getattr(tint4, fn)(x, tp, ts, 0), x, g)
        assert dx.dtype == torch.bfloat16
        if fn == "int4_matmul":
            w = tquant.dequant_int4(tp[0], ts[0], torch.float32).double()
            gd = g.double()
        else:
            w2 = tint4.int4_dequant_split_plain(tp, ts, 0, torch.bfloat16)
            w = tint4._merge_cols(w2.reshape(512, 512).t().double()).t()
            gd = g.bfloat16().double()
        want = gd @ w.t()
        term = gd.abs() @ w.abs().t()
        err = (dx.double() - want).abs()
        assert bool((err <= 2.0 ** -8 * want.abs() + 2.0 ** -16 * term)
                    .all())


def test_merge_lora_into_int8_and_int4_bit_equal_to_jax():
    """Adapters folded into int8 and packed-int4 stacks: dequantized in
    f32, the delta added, requantized with the same quantizer; the merged
    weights and their new scales equal the reference's bit for bit, and
    float bases merge as before."""
    jc = jcfg.tiny_llm()
    from streamvln_tpu.models import qwen2 as jqwen2
    base = jqwen2.init(jax.random.PRNGKey(0), jc, jnp.float32)
    rng = np.random.default_rng(1)
    for bits in (8, 4):
        # adapters first: the reference's add_lora reads din off a packed
        # int4 shape (ROADMAP §3.5)
        jp = jlora.add_lora({"llm": base}, jax.random.PRNGKey(2), jc, rank=4,
                            targets=("q_w", "o_w", "down_w"))
        jp = jquant.quantize_llm(jp, bits=bits)
        layers = dict(jp["llm"]["layers"])
        for k in list(layers):
            if k.endswith("_lora_b"):
                layers[k] = jnp.asarray(rng.standard_normal(
                    layers[k].shape) * 0.05, jnp.float32)
        jp = jax.tree.map(np.asarray, dict(jp, llm=dict(jp["llm"],
                                                        layers=layers)))
        tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
        want = jax.tree.map(np.asarray, jlora.merge_lora(jp))["llm"]
        got = tlora.merge_lora(tp)["llm"]
        assert set(got) == set(want) and set(got["layers"]) == \
            set(want["layers"])
        for k, v in want["layers"].items():
            t = got["layers"][k]
            assert t.dtype == torch.from_numpy(v).dtype, (bits, k)
            np.testing.assert_array_equal(t.numpy(), v, err_msg=f"{bits} {k}")
        assert got["layers"]["q_w"].dtype == (torch.int8 if bits == 8
                                              else torch.uint8)


def _eligible():
    """tiny_streamvln with a kernel-eligible decoder (every din and dout a
    multiple of 512), so quantize_llm(bits=4) stacks take K6/K7 on both
    sides."""
    from test_torch_quant_model import eligible_llm
    jc = dataclasses.replace(jcfg.tiny_streamvln(), llm=eligible_llm())
    tc = tcfg.StreamVLNConfig(
        vision=tcfg.SigLIPConfig(**dataclasses.asdict(jc.vision)),
        llm=tcfg.Qwen2Config(**dataclasses.asdict(jc.llm)),
        **{f.name: getattr(jc, f.name) for f in dataclasses.fields(jc)
           if f.name not in ("vision", "llm")})
    return jc, tc


def test_qlora_trajectory_matches_jax_with_frozen_packed_leaves():
    """Two optimizer steps of make_train_step (lora_only, remat, chunked
    CE) on quantize_llm(bits=4) + add_lora over the kernel-eligible decoder:
    256 decoder rows per projection (the K7 route and its backward) and a
    128-row lm_head chunk (the K6 route and its backward), against JAX's
    step on a one-device mesh (loss, grad norm, every parameter after each
    step); the packed weights and their scales stay bit-exact and the
    adapters move."""
    from streamvln_tpu.parallel import mesh as jmesh
    from streamvln_tpu.parallel import train as jtrain
    from streamvln_tpu_torch.parallel import train as ttrain
    from streamvln_tpu_torch.weights import from_jax_params
    from test_torch_train import _batch, _flat

    jc, tc = _eligible()
    # adapters before the quantizer on the JAX side: its add_lora reads din
    # off a packed int4 shape (ROADMAP §3.5); the port's, run after
    # quantize_llm as a QLoRA user runs it, makes the same shapes
    jp = jlora.add_lora(jsv.init(jax.random.PRNGKey(0), jc),
                        jax.random.PRNGKey(6), jc.llm, rank=4)
    jp = jax.tree.map(np.asarray, jquant.quantize_llm(jp, bits=4))
    assert jp["llm"]["layers"]["q_w"].dtype == np.uint8
    tq = tlora.add_lora(tquant.quantize_llm(from_jax_params(
        jax.tree.map(np.asarray, jsv.init(jax.random.PRNGKey(0), jc)), tc,
        device="cpu"), bits=4), torch.Generator().manual_seed(6), rank=4)
    assert {k: tuple(v.shape) for k, v in tq["llm"]["layers"].items()} == \
        {k: v.shape for k, v in jp["llm"]["layers"].items()}
    kw = dict(learning_rate=1e-3, total_steps=4, warmup_ratio=0.2,
              loss_chunk_size=64, lora_only=True)
    jt, tt = jtrain.TrainConfig(**kw), ttrain.TrainConfig(**kw)
    mesh = jmesh.make_mesh(dp=1, fsdp=1, tp=1, devices=jax.devices()[:1])
    jstate = jtrain.create_train_state(jax.tree.map(jnp.array, jp), jt)
    jstep = jtrain.make_train_step(jc, jt, mesh)
    tstate = ttrain.create_train_state(from_jax_params(jp, tc, device="cpu"),
                                       tt)
    tstep = ttrain.make_train_step(tc, tt, device="cpu")
    start = {p: t.clone() for p, t in ttrain.tree_leaves(tstate.params)}
    packed = [p for p, t in start.items() if t.dtype == torch.uint8]
    assert len(packed) == 8          # 7 layer stacks and the lm_head
    for i in range(2):
        b = _batch(jc, 21 + i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tm = tstep(tstate, b)
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=RTOL)
        want = _flat(jstate.params)
        for p, t in ttrain.tree_leaves(tstate.params):
            np.testing.assert_allclose(t.detach().numpy(), want[p],
                                       atol=ATOL, rtol=RTOL,
                                       err_msg=f"step {i} {p}")
    now = dict(ttrain.tree_leaves(tstate.params))
    for p, t in start.items():
        if tlora.is_lora_path(p):
            continue
        assert torch.equal(now[p], t), p
    assert not torch.equal(now["llm/layers/down_w_lora_b"],
                           start["llm/layers/down_w_lora_b"])
