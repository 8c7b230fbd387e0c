"""The port's plain kernel versions (what its wrappers run on CPU tensors)
against the JAX package's Pallas kernels in interpret mode.

Inputs are made with numpy from a fixed seed and fed to both sides.
Tolerance: f32 inputs atol = rtol = 1e-5 (f32 summation order: the Pallas
kernels sum blockwise, the plain versions densely); bf16 inputs atol 2e-2
(the bf16 output rounding).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamvln_tpu.ops.attention import mha_attention as jax_mha
from streamvln_tpu.ops.flash_attention import flash_attention as jax_flash
from streamvln_tpu.ops.vit_attention import vit_attention as jax_vit
from streamvln_tpu_torch.ops import flash_attention as fa
from streamvln_tpu_torch.ops import vit_attention as va
from streamvln_tpu_torch.ops.attention import mha_attention

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@pytest.mark.parametrize("S,D", [(16, 64), (50, 72)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vit_plain_matches_pallas(S, D, dtype):
    rng = np.random.default_rng(0)
    B, H = 2, 3
    x = [rng.standard_normal((B, S, H, D)).astype(np.float32)
         for _ in range(3)]
    want = np.asarray(jax_vit(*(jnp.asarray(a, dtype) for a in x),
                              interpret=True).astype(jnp.float32))
    tdt = getattr(torch, dtype)
    n0 = va.launches
    got = va.vit_attention(*(torch.from_numpy(a).to(tdt) for a in x))
    assert got.dtype == tdt and va.launches == n0   # plain path, no launch
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2)


@pytest.mark.parametrize("kv_major", [True, False])
@pytest.mark.parametrize("soft_cap", [None, 5.0])
def test_flash_plain_matches_pallas(kv_major, soft_cap):
    """GQA with G = 7, D = 128, a prefill at a nonzero offset into a larger
    cache, an INVALID_POS key tail and a row with no visible key."""
    rng = np.random.default_rng(1)
    B, Sq, Hq, Hkv, D, cap, off = 2, 80, 7, 1, 128, 192, 40
    q = rng.standard_normal((B, Sq, Hq, D)).astype(np.float32)
    kshape = (B, Hkv, cap, D) if kv_major else (B, cap, Hkv, D)
    k = rng.standard_normal(kshape).astype(np.float32)
    v = rng.standard_normal(kshape).astype(np.float32)
    q_pos = np.broadcast_to(off + np.arange(Sq, dtype=np.int32),
                            (B, Sq)).copy()
    q_pos[1, 5] = -1                               # sees no key
    k_pos = np.broadcast_to(np.arange(cap, dtype=np.int32), (B, cap)).copy()
    k_pos[:, -24:] = fa.INVALID_POS

    want = np.asarray(jax_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(q_pos),
        jnp.asarray(k_pos), logits_soft_cap=soft_cap, block_q=64,
        block_k=64, interpret=True, kv_major=kv_major))
    got = fa.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(q_pos), torch.from_numpy(k_pos),
        logits_soft_cap=soft_cap, kv_major=kv_major).numpy()
    np.testing.assert_array_equal(got[1, 5], 0.0)
    np.testing.assert_array_equal(want[1, 5], 0.0)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_wrappers_refuse_non_cpu_non_cuda_devices():
    q = torch.zeros((1, 4, 1, 64), device="meta")
    with pytest.raises(ValueError, match="device"):
        va.vit_attention(q, q, q)
    with pytest.raises(ValueError, match="device"):
        fa.flash_attention(q, q, q)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dispatch_by_shape_alone_reaches_wrappers(dtype):
    """Off the CPU, a call that qualifies by shape goes to the kernel
    wrapper whatever its dtype (which launches or raises); it never slips
    to the dense path. Meta tensors stand in for device tensors: the
    wrappers refuse them, the dense path would run on them."""
    import dataclasses

    from streamvln_tpu_torch.configs import tiny_llm
    from streamvln_tpu_torch.models import qwen2
    from streamvln_tpu_torch.ops.attention import mha_attention

    x = torch.zeros((1, 16, 2, 72), dtype=dtype, device="meta")
    assert mha_attention(x, x, x, impl="dense").device.type == "meta"
    with pytest.raises(ValueError, match="device"):
        mha_attention(x, x, x)

    cfg = dataclasses.replace(tiny_llm(), head_dim=128)
    q = torch.zeros((1, 64, 2, 128), dtype=dtype, device="meta")
    kv = torch.zeros((1, 1, 128, 128), dtype=dtype, device="meta")
    qp = torch.zeros((1, 64), dtype=torch.int32, device="meta")
    kp = torch.zeros((1, 128), dtype=torch.int32, device="meta")
    out = qwen2._attend(cfg, "dense", q, kv, kv, qp, kp, kv_major=True)
    assert out.device.type == "meta"
    with pytest.raises(ValueError, match="device"):
        qwen2._attend(cfg, "auto", q, kv, kv, qp, kp, kv_major=True)


@pytest.mark.parametrize("head_dim", [64, 128])
def test_decoder_chunked_without_a_cache_runs_chunked_attention(head_dim):
    """attn_impl="chunked" on a forward without a cache at S >= 64 runs the
    reference's chunked attention (streamvln_tpu/models/qwen2.py::_attend):
    `chunked_attention` with the config's soft cap, never dense attention
    with O(S^2) memory (dense_attention is patched to raise, so a fallback
    fails). Below 64 queries and on a cache, "chunked" is dense in both
    packages."""
    import dataclasses

    from streamvln_tpu_torch.configs import tiny_llm
    from streamvln_tpu_torch.models import qwen2

    cfg = dataclasses.replace(tiny_llm(), head_dim=head_dim,
                              attn_logits_soft_cap=30.0)

    def qkv(S):
        x = torch.zeros((1, S, 2, head_dim), device="meta")
        pos = torch.zeros((1, S), dtype=torch.int32, device="meta")
        return x, pos
    q, pos = qkv(64)

    def refuse(*a, **k):
        raise AssertionError("chunked fell back to dense attention")
    seen = []
    chunked = qwen2.chunked_attention

    def record(*a, **k):
        seen.append((a[0].shape, k))
        return chunked(*a, **k)
    dense = qwen2.dense_attention
    qwen2.dense_attention, qwen2.chunked_attention = refuse, record
    try:
        out = qwen2._attend(cfg, "chunked", q, q, q, pos, pos)
    finally:
        qwen2.dense_attention, qwen2.chunked_attention = dense, chunked
    assert out.shape == q.shape and out.device.type == "meta"
    assert seen == [(q.shape, {"logits_soft_cap": 30.0})]
    q63, pos63 = qkv(63)
    qwen2.chunked_attention = refuse
    try:
        assert qwen2._attend(cfg, "chunked", q63, q63, q63, pos63,
                             pos63).device.type == "meta"
        kv = torch.zeros((1, 2, 128, head_dim), device="meta")
        kp = torch.zeros((1, 128), dtype=torch.int32, device="meta")
        assert qwen2._attend(cfg, "chunked", q, kv, kv, pos, kp,
                             kv_major=True).device.type == "meta"
    finally:
        qwen2.chunked_attention = chunked


# The encoder dispatch, branch for branch the reference's
# (streamvln_tpu/ops/attention.py::mha_attention): "vit" (and "auto") take
# K1, "flash" takes K2 with every position 0, every other impl is dense.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("impl,wrapper", [
    ("vit", "vit_attention"), ("flash", "flash_attention"),
    ("decode_kernel", None), ("chunked", None)])
def test_encoder_dispatch_follows_the_reference(impl, wrapper, dtype):
    """Meta tensors stand in for device tensors: a kernel wrapper refuses
    them (so a call that reaches one raises), the dense path runs on
    them. SigLIP's head dim 72 reaches K2 zero-padded."""
    x = torch.zeros((1, 16, 2, 72), dtype=dtype, device="meta")
    if wrapper is None:
        assert mha_attention(x, x, x, impl=impl).device.type == "meta"
    else:
        with pytest.raises(ValueError, match=f"{wrapper}: unsupported"):
            mha_attention(x, x, x, impl=impl)


def test_flash_dispatch_with_a_mask_or_unsupported_shapes():
    """As the reference: "flash" with a mask runs dense; without one, a
    shape the flash kernel does not take raises NotImplementedError."""
    x = torch.zeros((1, 16, 2, 72), device="meta")
    mask = torch.ones((1, 16, 16), dtype=torch.bool, device="meta")
    assert mha_attention(x, x, x, mask, impl="flash").device.type == "meta"
    k = torch.zeros((1, 16, 2, 64), device="meta")
    with pytest.raises(NotImplementedError, match="flash kernel"):
        mha_attention(x, k, k, impl="flash")
    with pytest.raises(NotImplementedError, match="flash kernel"):
        mha_attention(torch.zeros((1, 16, 3, 72), device="meta"), x, x,
                      impl="flash")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["vit", "flash", "decode_kernel",
                                  "chunked"])
def test_encoder_dispatch_matches_jax(impl, dtype):
    """The port's mha_attention against the JAX package's on the same
    inputs at SigLIP's head dim (72), the Pallas kernels in interpret mode;
    tolerances as above."""
    rng = np.random.default_rng(2)
    B, S, H, D = 2, 24, 3, 72
    x = [rng.standard_normal((B, S, H, D)).astype(np.float32)
         for _ in range(3)]
    want = np.asarray(jax_mha(*(jnp.asarray(a, dtype) for a in x),
                              impl=impl, interpret=True).astype(jnp.float32))
    got = mha_attention(*(torch.from_numpy(a).to(getattr(torch, dtype))
                          for a in x), impl=impl)
    assert got.shape == (B, S, H, D)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2)
