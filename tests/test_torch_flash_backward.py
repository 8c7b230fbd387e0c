"""The port's differentiable attention wrappers on the CPU against the JAX
package: the flash training path (`_FlashAttentionFn`: K3's plain forward
with its logsumexp, K4/K5's plain backward) against JAX `flash_attention`
in interpret mode and its custom VJP, and the K1 wrapper's backward
against JAX `vit_attention`'s.

Inputs are made with numpy from a fixed seed and fed to both sides, in
float32. Tolerance atol 2e-5, rtol 2e-4, as tests/test_flash_backward.py
holds the Pallas backward to dense autodiff (f32 sums in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamvln_tpu.ops import flash_attention as jfa
from streamvln_tpu.ops.vit_attention import vit_attention as jax_vit
from streamvln_tpu_torch.ops import flash_attention as fa
from streamvln_tpu_torch.ops import vit_attention as va

ATOL, RTOL = 2e-5, 2e-4


def _inputs(seed, B, S, Hq, Hkv, D, kv_major):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, S, Hq, D)) * 0.3).astype(np.float32)
    kshape = (B, Hkv, S, D) if kv_major else (B, S, Hkv, D)
    k = (rng.standard_normal(kshape) * 0.3).astype(np.float32)
    v = (rng.standard_normal(kshape) * 0.3).astype(np.float32)
    g = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    # training layout: 90 valid tokens, padded keys at INVALID_POS, padded
    # queries at position 0; query 5 of the last row sees no key
    q_pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    k_pos = q_pos.copy()
    q_pos[:, 90:] = 0
    k_pos[:, 90:] = jfa.INVALID_POS
    q_pos[B - 1, 5] = -1
    return q, k, v, g, q_pos, k_pos


def _jax_lse(q, k, v, q_pos, k_pos, kv_major):
    """Per-row LSE of the Pallas forward (`_fwd_call(..., with_lse=True)`,
    interpret mode), with the wrapper's padding to 128-row blocks."""
    B, S, Hq, D = q.shape
    Sp = -(-S // 128) * 128
    pad = ((0, 0), (0, Sp - S))
    qt = jnp.pad(jnp.asarray(q), pad + ((0, 0), (0, 0))).transpose(0, 2, 1, 3)
    kv_pad = ((0, 0), (0, 0), (0, Sp - S), (0, 0)) if kv_major \
        else pad + ((0, 0), (0, 0))
    kt, vt = (jnp.pad(jnp.asarray(x), kv_pad) for x in (k, v))
    if not kv_major:
        kt, vt = kt.transpose(0, 2, 1, 3), vt.transpose(0, 2, 1, 3)
    qp = jnp.pad(jnp.asarray(q_pos), pad)
    kp = jnp.pad(jnp.asarray(k_pos), pad, constant_values=jfa.INVALID_POS)
    _, lse = jfa._fwd_call(
        qt, kt, vt, jnp.broadcast_to(qp[:, None], (B, 8, Sp)),
        jnp.broadcast_to(kp[:, None], (B, 8, Sp)), float(D ** -0.5), None,
        (128, 128, True), with_lse=True)
    return np.asarray(lse[:, :, 0, :S])


@pytest.mark.parametrize("Hq,Hkv,kv_major", [(4, 4, False), (4, 2, False),
                                             (7, 1, False), (4, 2, True)])
def test_flash_function_matches_jax_forward_lse_and_grads(Hq, Hkv,
                                                          kv_major):
    B, S, D = 2, 100, 128
    q, k, v, g, q_pos, k_pos = _inputs(0, B, S, Hq, Hkv, D, kv_major)

    def f_jax(q, k, v):
        out = jfa.flash_attention(q, k, v, jnp.asarray(q_pos),
                                  jnp.asarray(k_pos), interpret=True,
                                  kv_major=kv_major)
        return jnp.vdot(out, jnp.asarray(g)), out

    (_, want), jgrads = jax.value_and_grad(f_jax, argnums=(0, 1, 2),
                                           has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))

    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    counts = (fa.launches, fa.lse_launches, fa.dq_launches, fa.dkv_launches)
    out = fa.flash_attention(tq, tk, tv, torch.from_numpy(q_pos),
                             torch.from_numpy(k_pos), kv_major=kv_major)
    assert type(out.grad_fn).__name__ == "_FlashAttentionFnBackward"
    (out * torch.from_numpy(g)).sum().backward()
    # CPU tensors: the plain versions ran, no kernel counted
    assert counts == (fa.launches, fa.lse_launches, fa.dq_launches,
                      fa.dkv_launches)

    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(out.detach().numpy()[1, 5], 0.0)
    for name, t, jg in zip("qkv", (tq, tk, tv), jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg),
                                   atol=ATOL, rtol=RTOL, err_msg=f"d{name}")
    np.testing.assert_array_equal(tq.grad.numpy()[1, 5], 0.0)

    _, lse = fa.flash_attention_lse(*(torch.from_numpy(x) for x in (
        q, k, v, q_pos, k_pos)), kv_major=kv_major)
    jlse = _jax_lse(q, k, v, q_pos, k_pos, kv_major)
    assert lse.shape == (B, Hq, S)
    np.testing.assert_array_equal(jlse[1, :, 5], np.float32(jfa.NEG_INF))
    np.testing.assert_array_equal(lse.numpy()[1, :, 5], np.float32(fa.NEG_INF))
    np.testing.assert_allclose(lse.numpy(), jlse, atol=ATOL, rtol=RTOL)


def test_flash_backward_plain_is_the_kernels_formulas():
    """flash_attention_bwd_plain (Dsum, P from the LSE, dS) gives the
    grads of dense attention under autograd, on the same inputs."""
    q, k, v, g, q_pos, k_pos = _inputs(1, 2, 100, 4, 2, 128, False)
    t = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    qp, kp = torch.from_numpy(q_pos), torch.from_numpy(k_pos)
    dense = fa.flash_attention_plain(*t, qp, kp)
    dense.backward(torch.from_numpy(g))
    with torch.no_grad():
        out, lse = fa.flash_attention_lse_plain(*t, qp, kp)
        got = fa.flash_attention_bwd_plain(*t, out, lse, torch.from_numpy(g),
                                           qp, kp)
    for a, b in zip(got, t):
        np.testing.assert_allclose(a.numpy(), b.grad.numpy(), atol=ATOL,
                                   rtol=RTOL)


def test_flash_grad_path_refuses_soft_cap_and_keeps_no_grad_path():
    q, k, v, _, q_pos, k_pos = _inputs(2, 1, 64, 2, 1, 128, False)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    with pytest.raises(NotImplementedError, match="soft_cap"):
        fa.flash_attention(tq.requires_grad_(), tk, tv,
                           logits_soft_cap=30.0)
    with torch.no_grad():   # inference: K2's path, no autograd node
        out = fa.flash_attention(tq, tk, tv, logits_soft_cap=30.0)
    assert out.grad_fn is None


@pytest.mark.parametrize("S,D", [(16, 64), (50, 72)])
def test_vit_wrapper_grads_match_jax(S, D):
    rng = np.random.default_rng(3)
    B, H = 2, 3
    x = [rng.standard_normal((B, S, H, D)).astype(np.float32)
         for _ in range(3)]
    g = rng.standard_normal((B, S, H, D)).astype(np.float32)

    def f_jax(q, k, v):
        return jnp.vdot(jax_vit(q, k, v, interpret=True), jnp.asarray(g))

    jgrads = jax.grad(f_jax, argnums=(0, 1, 2))(*map(jnp.asarray, x))
    t = [torch.from_numpy(a).requires_grad_() for a in x]
    out = va.vit_attention(*t)
    assert type(out.grad_fn).__name__ == "_VitAttentionFnBackward"
    (out * torch.from_numpy(g)).sum().backward()
    for name, a, jg in zip("qkv", t, jgrads):
        assert np.abs(a.grad.numpy()).max() > 0
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(jg),
                                   atol=ATOL, rtol=RTOL, err_msg=f"d{name}")
