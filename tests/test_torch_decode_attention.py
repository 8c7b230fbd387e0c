"""The port's decode attention (K8's plain version) against the JAX
package's Pallas decode kernel in interpret mode, and the decoder and
engine under attn_impl="decode_kernel" against JAX, on the CPU.

The JAX package's own `qwen2.forward` reaches its decode kernel only on a
TPU (on the CPU, Pallas runs in interpret mode only when asked), and its
engine never reaches it (its decode loop appends into a scratch cache),
so the decoder and the engine are held against JAX's dense path on the
same cache: the same function. Tolerance: f32 atol = rtol = 2e-5
(summation order); logits atol = rtol = 1e-4; bf16 atol 2e-2 (the bf16
output rounding).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamvln_tpu import configs as jcfg
from streamvln_tpu.models import qwen2 as jqwen2
from streamvln_tpu.models import streamvln as jsv
from streamvln_tpu.ops.decode_attention import decode_attention as jax_decode
from streamvln_tpu.streaming.engine import StreamingEngine as JaxEngine
from streamvln_tpu_torch import configs as tcfg
from streamvln_tpu_torch.agent import VLNAgent
from streamvln_tpu_torch.data.tokenizer import ByteTokenizer
from streamvln_tpu_torch.models import qwen2 as tqwen2
from streamvln_tpu_torch.ops import decode_attention as da
from streamvln_tpu_torch.streaming.engine import StreamingEngine
from streamvln_tpu_torch.weights import from_jax_params

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@pytest.mark.parametrize("Hq,Hkv", [(28, 4), (8, 8), (12, 2)])
def test_decode_plain_matches_pallas(Hq, Hkv):
    """Lengths 0 (zeros), 1, 511, 513 and the full capacity."""
    rng = np.random.RandomState(0)
    lengths = np.asarray([0, 1, 511, 513, 1024], np.int32)
    B, Smax, D = len(lengths), 1024, 128
    q = rng.randn(B, 1, Hq, D).astype(np.float32)
    k = rng.randn(B, Hkv, Smax, D).astype(np.float32)
    v = rng.randn(B, Hkv, Smax, D).astype(np.float32)
    want = np.asarray(jax_decode(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(lengths),
                                 block_k=512, interpret=True))
    n0 = da.launches
    got = da.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), torch.from_numpy(lengths))
    assert da.launches == n0                 # CPU: the plain version only
    np.testing.assert_array_equal(got[0].numpy(), 0.0)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


def test_decode_plain_matches_pallas_bf16():
    rng = np.random.RandomState(1)
    lengths = np.asarray([700, 3], np.int32)
    q = rng.randn(2, 1, 28, 128).astype(np.float32)
    k = rng.randn(2, 4, 1024, 128).astype(np.float32)
    v = rng.randn(2, 4, 1024, 128).astype(np.float32)
    want = jax_decode(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                      jnp.asarray(lengths), block_k=512, interpret=True)
    got = da.decode_attention(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
        torch.from_numpy(lengths))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=2e-2)


def decode_llm():
    return jcfg.Qwen2Config(
        vocab_size=512, hidden_size=512, intermediate_size=512,
        num_layers=2, num_heads=4, num_kv_heads=2, head_dim=128,
        rope_theta=1e4, max_position_embeddings=4096)


def test_qwen2_decode_kernel_step_matches_jax():
    """Prefill (dense under decode_kernel) then single-token steps through
    the decode attention, against JAX's forward on the same cache; the
    written cache agrees too."""
    jc = decode_llm()
    tc = tcfg.Qwen2Config(**dataclasses.asdict(jc))
    jp = jax.tree.map(np.asarray, jqwen2.init(jax.random.PRNGKey(3), jc,
                                              jnp.float32))
    tp = {k: ({kk: torch.from_numpy(np.array(vv)) for kk, vv in v.items()}
              if isinstance(v, dict) else torch.from_numpy(np.array(v)))
          for k, v in jp.items()}
    rng = np.random.default_rng(4)
    B, cap = 2, 512
    emb = rng.standard_normal((B, 23, jc.hidden_size)).astype(np.float32)
    jcache = jqwen2.KVCache.create(jc, B, cap, jnp.float32)
    tcache = tqwen2.KVCache.create(tc, B, cap, torch.float32, "cpu")
    calls = []
    real = da.decode_attention

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)
    da.decode_attention = spy
    try:
        for lo, hi in ((0, 20), (20, 21), (21, 22), (22, 23)):
            pos = np.broadcast_to(np.arange(lo, hi, dtype=np.int32),
                                  (B, hi - lo)).copy()
            jl, jcache = jqwen2.forward(jp, jc, jnp.asarray(emb[:, lo:hi]),
                                        jnp.asarray(pos), cache=jcache,
                                        attn_impl="dense")
            tl, _ = tqwen2.forward(tp, tc, torch.from_numpy(emb[:, lo:hi]),
                                   torch.from_numpy(pos), cache=tcache,
                                   attn_impl="decode_kernel")
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       atol=1e-4, rtol=1e-4)
    finally:
        da.decode_attention = real
    assert calls == [(B, 1, 4, 128)] * (3 * jc.num_layers)
    np.testing.assert_allclose(tcache.v[:, :, :, :23].numpy(),
                               np.asarray(jcache.v[:, :, :, :23]), atol=1e-4)


def test_decode_kernel_engine_matches_jax_engine():
    """The port's agent under attn_impl="decode_kernel" (K8 at every
    decode step) against the JAX agent under the same setting (whose
    decode runs dense): actions and text agree at every step across the
    window reset and the <memory> call."""
    from streamvln_tpu.agent import VLNAgent as JaxAgent
    from streamvln_tpu.data.tokenizer import ByteTokenizer as JaxTok

    jc = dataclasses.replace(jcfg.tiny_streamvln(), llm=decode_llm())
    tc = tcfg.StreamVLNConfig(
        vision=tcfg.SigLIPConfig(**dataclasses.asdict(jc.vision)),
        llm=tcfg.Qwen2Config(**dataclasses.asdict(jc.llm)),
        num_frames=jc.num_frames, num_future_steps=jc.num_future_steps,
        num_history=jc.num_history)
    jp = jax.tree.map(np.asarray, jsv.init(jax.random.PRNGKey(0), jc))
    tp = from_jax_params(jp, tc, device="cpu")
    tok = ByteTokenizer()
    kw = dict(stop_ids=(tok.im_end_id,), max_new_tokens=6,
              cache_capacity=2048, buckets=(128, 512, 768, 1024),
              attn_impl="decode_kernel")
    ja = JaxAgent(JaxEngine(jp, jc, compute_dtype=jnp.float32, **kw),
                  JaxTok())
    ta = VLNAgent(StreamingEngine(tp, tc, compute_dtype=torch.float32,
                                  device="cpu", **kw), tok)
    rng = np.random.RandomState(5)
    queue, calls = [], 0
    for step in range(tc.num_frames + 1):
        frame = rng.randint(0, 255, (48, 64, 3), np.uint8)
        run = not queue
        want = ja.step(0, frame, "walk to the sofa", run_model=run)
        got = ta.step(0, frame, "walk to the sofa", run_model=run)
        assert (got[0], got[2]) == (want[0], want[2]), step
        assert ta.engine.envs[0].kv_length == ja.engine.envs[0].kv_length
        if run:
            calls += 1
            queue = list(got[0])[:tc.num_future_steps]
        if queue:
            queue.pop(0)
    assert calls > tc.num_frames // tc.num_future_steps
