"""The LLM family registry of the port against the JAX package's, on the
CPU in float32: the subjects of tests/test_llm_families.py (Llama,
Mistral, Gemma, Mixtral, Qwen2-MoE and MPT logits on `transformers` models
built from configs, the registry, decode with a cache, the capacity
dispatch), the engine token for token on a tiny MoE and a tiny alibi
config (greedy and speculative), the K2 and K8 plain versions at head dim
256 against the Pallas kernels in interpret mode, the MoE quantizer, the
weight bridge on MoE trees and a LoRA train step on a tiny Mixtral.

Tolerances: port against JAX atol 1e-4 (f32 summation order; 2e-4 rtol
for the train step's grads); port against transformers atol = rtol =
2e-3, the reference test's own bound; quantized leaves bit-equal; the
plain kernels against Pallas interpret atol = rtol = 2e-5 in f32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamvln_tpu import configs as jcfg
from streamvln_tpu import train as jtrain_cli
from streamvln_tpu.models import convert_hf as jconvert
from streamvln_tpu.models import lora as jlora
from streamvln_tpu.models import quant as jquant
from streamvln_tpu.models import qwen2 as jq
from streamvln_tpu.models import streamvln as jsv
from streamvln_tpu.ops.decode_attention import decode_attention as jax_decode
from streamvln_tpu.ops.flash_attention import flash_attention as jax_flash
from streamvln_tpu.parallel import mesh as jmesh
from streamvln_tpu.parallel import train as jtrain
from streamvln_tpu.streaming.engine import StreamingEngine as JaxEngine
from streamvln_tpu_torch import configs as tcfg
from streamvln_tpu_torch.data import chatml
from streamvln_tpu_torch.data.tokenizer import ByteTokenizer
from streamvln_tpu_torch.models import convert_hf
from streamvln_tpu_torch.models import qwen2 as tq
from streamvln_tpu_torch.models import quant as tquant
from streamvln_tpu_torch.ops import decode_attention as da
from streamvln_tpu_torch.ops import flash_attention as fa
from streamvln_tpu_torch.parallel import train as ttrain
from streamvln_tpu_torch.streaming.engine import StreamingEngine
from streamvln_tpu_torch.weights import from_jax_params

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
ATOL = 1e-4
HF_TOL = 2e-3
SMALL = dict(vocab_size=128, hidden_size=32, intermediate_size=64,
             num_layers=2, num_heads=4, num_kv_heads=2, head_dim=8,
             rope_theta=10000.0)
# the families' knobs (on SMALL, or on tiny_llm's widths)
FAMILIES = {
    "llama": dict(qkv_bias=False, rms_norm_eps=1e-5),
    "gemma": dict(qkv_bias=False, tie_word_embeddings=True,
                  mlp_act="gelu_tanh", norm_offset=True,
                  scale_embeddings=True),
    "mpt": dict(qkv_bias=False, tie_word_embeddings=True, mlp_act="gelu",
                positional="alibi", norm_type="layernorm", mlp_gated=False,
                num_kv_heads=4, intermediate_size=128),
    "mixtral": dict(qkv_bias=False, num_experts=4, num_experts_per_tok=2),
    "qwen2_moe": dict(num_experts=4, num_experts_per_tok=2,
                      norm_topk_prob=False, moe_intermediate_size=48,
                      shared_expert_intermediate_size=64),
}


def _cfgs(**kw):
    return jcfg.Qwen2Config(**kw), tcfg.Qwen2Config(**kw)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True))


def _jax_logits(params, cfg, ids, attn_impl="dense"):
    x = jq.embed_tokens(params, jnp.asarray(ids), cfg)
    pos = jnp.broadcast_to(jnp.arange(ids.shape[1]), ids.shape)
    return np.asarray(jq.forward(params, cfg, x, pos,
                                 attn_impl=attn_impl)[0])


def _port_logits(params, cfg, ids):
    ids = torch.from_numpy(np.asarray(ids))
    x = tq.embed_tokens(params, ids, cfg)
    pos = torch.arange(ids.shape[1], dtype=torch.int32)[None].expand(
        ids.shape[0], -1)
    return tq.forward(params, cfg, x, pos)[0].numpy()


def _hf_parity(hf, kind, kw, ids):
    """The HF model's logits against the port's on its converted weights
    (HF_TOL, the reference test's bound) and against the JAX package's on
    the same conversion (ATOL)."""
    state = {k: v.detach().numpy() for k, v in hf.state_dict().items()}
    jc, tc = _cfgs(**kw)
    jfn, tfn = {"llm": (jconvert.convert_llm, convert_hf.convert_llm),
                "moe": (jconvert.convert_moe_llm, convert_hf.convert_moe_llm),
                "mpt": (jconvert.convert_mpt, convert_hf.convert_mpt)}[kind]
    jp = jfn(state, jc, dtype=jnp.float32)
    tp = tfn({k: torch.from_numpy(v) for k, v in state.items()}, tc,
             dtype=torch.float32, device="cpu")
    with torch.no_grad():
        want = hf(torch.from_numpy(ids)).logits.numpy()
    got = _port_logits(tp, tc, ids)
    np.testing.assert_allclose(got, want, atol=HF_TOL, rtol=HF_TOL)
    np.testing.assert_allclose(got, _jax_logits(jp, jc, ids), atol=ATOL,
                               rtol=ATOL)


def test_llama_parity():
    from transformers import LlamaConfig, LlamaForCausalLM
    torch.manual_seed(0)
    hf = LlamaForCausalLM(LlamaConfig(
        vocab_size=128, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        rope_theta=10000.0, rms_norm_eps=1e-5, max_position_embeddings=128,
        tie_word_embeddings=False, attention_bias=False)).eval()
    ids = np.random.RandomState(0).randint(0, 128, (2, 9))
    _hf_parity(hf, "llm", dict(SMALL, **FAMILIES["llama"]), ids)


def test_mistral_parity():
    from transformers import MistralConfig, MistralForCausalLM
    torch.manual_seed(1)
    hf = MistralForCausalLM(MistralConfig(
        vocab_size=128, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        rope_theta=10000.0, rms_norm_eps=1e-5, max_position_embeddings=128,
        sliding_window=None)).eval()
    ids = np.random.RandomState(1).randint(0, 128, (2, 7))
    _hf_parity(hf, "llm", dict(SMALL, **FAMILIES["llama"]), ids)


def test_gemma_parity():
    from transformers import GemmaConfig, GemmaForCausalLM
    torch.manual_seed(2)
    hf = GemmaForCausalLM(GemmaConfig(
        vocab_size=128, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        head_dim=8, rope_theta=10000.0, rms_norm_eps=1e-6,
        max_position_embeddings=128, hidden_act="gelu_pytorch_tanh",
        hidden_activation="gelu_pytorch_tanh")).eval()
    ids = np.random.RandomState(2).randint(0, 128, (2, 8))
    _hf_parity(hf, "llm", dict(SMALL, **FAMILIES["gemma"],
                               rms_norm_eps=1e-6), ids)


def test_family_registry():
    """Every registry name builds through the port's build_config as
    through the reference's train.build_config, field for field; an
    unknown name raises the reference's ValueError."""
    assert sorted(tcfg.LLM_REGISTRY) == sorted(jcfg.LLM_REGISTRY)
    for name in jcfg.LLM_REGISTRY:
        assert dataclasses.asdict(tcfg.llm_config(name)) == \
            dataclasses.asdict(jcfg.llm_config(name)), name
        args = jtrain_cli.build_argparser().parse_args(
            ["--video_folders", "x", "--output_dir", "y", "--model_size",
             name, "--spatial_pool_mode", "average"])
        got, want = tcfg.build_config(args), jtrain_cli.build_config(args)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name
    assert tcfg.llm_config("gemma-2b").head_dim == 256
    for mod in (tcfg, jcfg):
        with pytest.raises(ValueError) as e:
            mod.llm_config("gpt-j")
        assert "unknown LLM 'gpt-j'" in str(e.value)


def _decode_with_cache(family):
    """JAX init carried across; the port's incremental decode against its
    full forward and against JAX's."""
    jc, tc = _cfgs(**dict(SMALL, vocab_size=64, **FAMILIES[family]))
    jp = jq.init(jax.random.PRNGKey(0), jc)
    tp = _t(_np(jp))
    ids = np.asarray([[3, 5, 7, 11, 13, 2]])
    full = _port_logits(tp, tc, ids)
    np.testing.assert_allclose(full, _jax_logits(jp, jc, ids), atol=ATOL,
                               rtol=ATOL)
    cache = tq.KVCache.create(tc, 1, 64, torch.float32, device="cpu")
    inc = []
    for i in range(ids.shape[1]):
        x = tq.embed_tokens(tp, torch.from_numpy(ids[:, i:i + 1]), tc)
        logits, _ = tq.forward(tp, tc, x, torch.tensor([[i]]), cache=cache)
        inc.append(logits[0, 0].numpy())
    np.testing.assert_allclose(np.stack(inc), full[0], atol=ATOL, rtol=ATOL)
    return tp


def test_family_decode_with_cache():
    tp = _decode_with_cache("llama")
    assert "q_b" in tp["layers"]            # the JAX init keeps zero biases


def test_mixtral_parity():
    from transformers import MixtralConfig, MixtralForCausalLM
    torch.manual_seed(3)
    hf = MixtralForCausalLM(MixtralConfig(
        vocab_size=128, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        rope_theta=10000.0, rms_norm_eps=1e-5, max_position_embeddings=128,
        num_local_experts=4, num_experts_per_tok=2,
        sliding_window=None)).eval()
    ids = np.random.RandomState(3).randint(0, 128, (2, 6))
    _hf_parity(hf, "moe", dict(SMALL, **FAMILIES["mixtral"],
                               rms_norm_eps=1e-5), ids)


def test_qwen2_moe_parity():
    from transformers import Qwen2MoeConfig, Qwen2MoeForCausalLM
    torch.manual_seed(4)
    hf = Qwen2MoeForCausalLM(Qwen2MoeConfig(
        vocab_size=128, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        rope_theta=10000.0, rms_norm_eps=1e-6, max_position_embeddings=128,
        num_experts=4, num_experts_per_tok=2, moe_intermediate_size=48,
        shared_expert_intermediate_size=64, norm_topk_prob=False,
        decoder_sparse_step=1, mlp_only_layers=[], sliding_window=None,
        use_sliding_window=False)).eval()
    ids = np.random.RandomState(4).randint(0, 128, (2, 6))
    _hf_parity(hf, "moe", dict(SMALL, **FAMILIES["qwen2_moe"]), ids)


def test_moe_decode_with_cache():
    tp = _decode_with_cache("qwen2_moe")
    assert "e_gate" in tp["layers"] and "gate_w" not in tp["layers"]


def test_mpt_parity():
    from transformers import MptConfig, MptForCausalLM
    torch.manual_seed(5)
    hf = MptForCausalLM(MptConfig(
        d_model=32, n_heads=4, n_layers=2, vocab_size=128, max_seq_len=128,
        layer_norm_epsilon=1e-5)).eval()
    ids = np.random.RandomState(5).randint(0, 128, (2, 10))
    _hf_parity(hf, "mpt", dict(SMALL, **FAMILIES["mpt"], rms_norm_eps=1e-5),
               ids)


def test_mpt_decode_with_cache():
    tp = _decode_with_cache("mpt")
    assert "gate_w" not in tp["layers"]
    # the alibi slopes are made on the device from no host data, equal to
    # the reference's numpy bank (interleaved for a head count that is no
    # power of two)
    for n in (4, 12, 32):
        np.testing.assert_array_equal(tq.alibi_slopes(n).numpy(),
                                      np.asarray(jq.alibi_slopes(n)))


def test_moe_capacity_dispatch_matches_dense():
    """Capacity at factor 8 (nothing dropped) equals the dense dispatch;
    at factor 1 (tokens dropped) the port drops what JAX drops."""
    base = dict(SMALL, vocab_size=64, qkv_bias=False, num_experts=4,
                num_experts_per_tok=2, shared_expert_intermediate_size=48)
    jc, tc = _cfgs(**base)
    jp = jq.init(jax.random.PRNGKey(0), jc)
    tp = _t(_np(jp))
    ids = np.random.RandomState(1).randint(0, 64, (2, 12))
    dense = _port_logits(tp, tc, ids)
    for factor in (8.0, 1.0):
        kw = dict(base, moe_dispatch="capacity", moe_capacity_factor=factor)
        jcc, tcc = _cfgs(**kw)
        got = _port_logits(tp, tcc, ids)
        np.testing.assert_allclose(got, _jax_logits(jp, jcc, ids),
                                   atol=ATOL, rtol=ATOL)
        if factor > 1:
            np.testing.assert_allclose(got, dense, atol=2e-4, rtol=2e-4)
        assert np.isfinite(got).all()


# -- the engine ------------------------------------------------------------

def _stacks(family):
    jsc = dataclasses.replace(jcfg.tiny_streamvln(), llm=dataclasses.replace(
        jcfg.tiny_llm(), **FAMILIES[family]))
    tsc = dataclasses.replace(tcfg.tiny_streamvln(), llm=dataclasses.replace(
        tcfg.tiny_llm(), **FAMILIES[family]))
    return jsc, tsc


def _turn(tok, text, add_system):
    ids, _ = chatml.tokenize_dialogue(tok, [("user", text)],
                                      add_system=add_system,
                                      with_labels=False)
    return np.concatenate([ids, np.asarray(chatml.generation_prompt(tok),
                                           np.int32)])


@pytest.mark.parametrize("spec", [0, 6])
@pytest.mark.parametrize("family", ["qwen2_moe", "mpt"])
def test_engine_matches_jax(family, spec):
    """A window of calls, the window reset and the <memory> call on a tiny
    MoE (with its shared expert) and a tiny alibi stack, greedy and with
    prompt-lookup speculation: the same tokens and KV lengths as the JAX
    engine on the JAX init's weights."""
    jsc, tsc = _stacks(family)
    jp = jsv.init(jax.random.PRNGKey(0), jsc)
    tp = from_jax_params(_np(jp), tsc, device="cpu")
    tok = ByteTokenizer()
    kw = dict(n_envs=1, stop_ids=(tok.im_end_id,), max_new_tokens=8,
              cache_capacity=2048, buckets=(128, 512, 768, 1024),
              spec_lookup=spec)
    je = JaxEngine(jp, jsc, compute_dtype=jnp.float32, **kw)
    te = StreamingEngine(tp, tsc, compute_dtype=torch.float32, device="cpu",
                         **kw)
    rng = np.random.RandomState(0)
    nf, nfs, nh = tsc.num_frames, tsc.num_future_steps, tsc.num_history
    emitted = 0
    for call in range(nf // nfs):
        frame = rng.randint(0, 255, (48, 64, 3), np.uint8)
        ids = _turn(tok, chatml.observation_prompt(
            None, "go to the red door" if call == 0 else ""), call == 0)
        got = te.generate(0, frame, ids, step_id=call * nfs)
        assert got == je.generate(0, frame, ids, step_id=call * nfs)
        emitted += len(got)
        np.testing.assert_array_equal(te.cache.length.numpy(),
                                      np.asarray(je.cache.length))
    je.reset_for_env(0)
    te.reset_for_env(0)
    frame = rng.randint(0, 255, (48, 64, 3), np.uint8)
    ids = _turn(tok, chatml.observation_prompt(
        None, "go to the red door These are your historical observations "
        "<memory>."), True)
    hist = list(range(0, nf, nf // nh))
    got = te.generate(0, frame, ids, step_id=nf, history_steps=hist)
    assert got == je.generate(0, frame, ids, step_id=nf,
                              history_steps=hist)
    np.testing.assert_array_equal(te.cache.length.numpy(),
                                  np.asarray(je.cache.length))
    assert emitted + len(got) > nf // nfs


# -- the kernels' plain versions at head dim 256 -----------------------------

@pytest.mark.parametrize("kv_major", [True, False])
def test_flash_plain_matches_pallas_at_head_dim_256(kv_major):
    """Gemma's shape class (8 query heads on one KV head, D = 256) at a
    prefill offset into a larger cache, an INVALID_POS tail and a row that
    sees no key."""
    rng = np.random.default_rng(3)
    B, Sq, Hq, Hkv, D, cap, off = 2, 70, 8, 1, 256, 192, 40
    q = rng.standard_normal((B, Sq, Hq, D)).astype(np.float32)
    kshape = (B, Hkv, cap, D) if kv_major else (B, cap, Hkv, D)
    k = rng.standard_normal(kshape).astype(np.float32)
    v = rng.standard_normal(kshape).astype(np.float32)
    q_pos = np.broadcast_to(off + np.arange(Sq, dtype=np.int32),
                            (B, Sq)).copy()
    q_pos[1, 5] = -1
    k_pos = np.broadcast_to(np.arange(cap, dtype=np.int32), (B, cap)).copy()
    k_pos[:, -24:] = fa.INVALID_POS
    want = np.asarray(jax_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(q_pos),
        jnp.asarray(k_pos), block_q=64, block_k=64, interpret=True,
        kv_major=kv_major))
    n0 = fa.launches
    got = fa.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(q_pos), torch.from_numpy(k_pos),
        kv_major=kv_major).numpy()
    assert fa.launches == n0                 # the CPU runs the plain version
    np.testing.assert_array_equal(got[1, 5], 0.0)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("Hq,Hkv,D", [(8, 1, 256), (32, 32, 128),
                                      (40, 8, 128)])
def test_decode_plain_matches_pallas_at_the_family_shapes(Hq, Hkv, D):
    """K8's plain version at Gemma's head dim 256 (G = 8) and at group
    sizes 1 and 5, lengths 0, 1, 511, 513 and the capacity."""
    rng = np.random.RandomState(2)
    lengths = np.asarray([0, 1, 511, 513, 1024], np.int32)
    B, Smax = len(lengths), 1024
    q = rng.randn(B, 1, Hq, D).astype(np.float32)
    k = rng.randn(B, Hkv, Smax, D).astype(np.float32)
    v = rng.randn(B, Hkv, Smax, D).astype(np.float32)
    want = np.asarray(jax_decode(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(lengths),
                                 block_k=512, interpret=True))
    got = da.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), torch.from_numpy(lengths))
    np.testing.assert_array_equal(got[0].numpy(), 0.0)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


# -- quantization, the weight bridge, LoRA -----------------------------------

@pytest.mark.parametrize("bits", [8, 4])
def test_moe_quantize_llm_matches_jax(bits):
    """quantize_llm over an MoE tree with a shared expert: the expert stacks
    and the shared expert quantized bit for bit as JAX does them, the router
    left in full precision; the quantized decoder's logits as JAX's."""
    jsc, tsc = _stacks("qwen2_moe")
    jsc = dataclasses.replace(jsc, llm=dataclasses.replace(
        jsc.llm, hidden_size=128, moe_intermediate_size=128,
        shared_expert_intermediate_size=128))
    tsc = dataclasses.replace(tsc, llm=tcfg.Qwen2Config(
        **dataclasses.asdict(jsc.llm)))
    jp = jsv.init(jax.random.PRNGKey(0), jsc)
    want = _np(jquant.quantize_llm(jp, bits=bits))
    tp = from_jax_params(_np(jp), tsc, device="cpu")
    got = tquant.quantize_llm(tp, bits=bits)
    gl, wl = got["llm"]["layers"], want["llm"]["layers"]
    assert set(gl) == set(wl)
    for name in tquant.MOE_QUANT_TARGETS:
        for leaf in (name, name + "_scale"):
            np.testing.assert_array_equal(gl[leaf].numpy(), wl[leaf],
                                          err_msg=leaf)
    assert gl["router_w"].dtype == torch.float32
    assert gl["e_gate"].dtype == (torch.int8 if bits == 8 else torch.uint8)
    ids = np.random.RandomState(0).randint(0, 512, (1, 9))
    np.testing.assert_allclose(
        _port_logits(got["llm"], tsc.llm, ids),
        _jax_logits(jquant.quantize_llm(jp, bits=bits)["llm"], jsc.llm, ids),
        atol=ATOL, rtol=ATOL)


def test_from_jax_params_on_moe_trees():
    """The JAX init of an MoE stack with its shared expert, and its int8
    form, carried across leaf for leaf: router_w, e_gate / e_up / e_down,
    the s_* leaves and their scales, dtypes kept."""
    jsc, tsc = _stacks("qwen2_moe")
    jp = _np(jsv.init(jax.random.PRNGKey(0), jsc))
    for tree in (jp, _np(jquant.quantize_llm(jp, bits=8))):
        got = from_jax_params(tree, tsc, device="cpu")["llm"]["layers"]
        want = tree["llm"]["layers"]
        assert set(got) == set(want)
        for k, w in want.items():
            assert str(got[k].dtype).split(".")[-1] == str(w.dtype), k
            np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
    assert {"router_w", "e_gate", "e_up", "e_down", "s_gate_w", "s_up_w",
            "s_down_w", "s_route_w", "e_gate_scale"} <= set(got)


def _batch(cfg, seed, B=2, T=128):
    """Two samples with <image> frames and labels on their answers, padded
    to T; images [B, 2, S, S, 3]."""
    rng = np.random.default_rng(seed)
    layouts = []
    for n in (40, 70)[:B]:
        ids = np.concatenate([[7, -200, 9, -200],
                              rng.integers(3, 500, n)]).astype(np.int32)
        labels = np.where(np.arange(len(ids)) > len(ids) // 2, ids, -100)
        layouts.append(jsv.build_splice_layout(ids, cfg, labels=labels,
                                               pad_to=T))
    batch = jsv.stack_layouts(layouts)
    del batch["lengths"]
    S = cfg.vision.image_size
    batch["images"] = rng.standard_normal((B, 2, S, S, 3)).astype(np.float32)
    return batch


def test_lora_train_step_on_tiny_mixtral_matches_jax():
    """add_lora on a Mixtral tree puts adapters on attention only (no
    gate/up/down stacks), and one lora_only optimizer step moves the same
    adapters by the same amounts as JAX's."""
    jsc, tsc = _stacks("mixtral")
    jp = jlora.add_lora(jsv.init(jax.random.PRNGKey(0), jsc),
                        jax.random.PRNGKey(1), jsc.llm, rank=4)
    adapters = {n for n in jp["llm"]["layers"] if n.endswith("_lora_a")}
    assert adapters == {"q_w_lora_a", "k_w_lora_a", "v_w_lora_a",
                        "o_w_lora_a"}
    kw = dict(learning_rate=1e-3, total_steps=2, warmup_ratio=0.0,
              lora_only=True, loss_chunk_size=64)
    jt, tt = jtrain.TrainConfig(**kw), ttrain.TrainConfig(**kw)
    mesh = jmesh.make_mesh(dp=1, fsdp=1, tp=1, devices=jax.devices()[:1])
    jstate = jtrain.create_train_state(jax.tree.map(jnp.array, jp), jt)
    jstep = jtrain.make_train_step(jsc, jt, mesh)
    tstate = ttrain.create_train_state(
        from_jax_params(_np(jp), tsc, device="cpu"), tt)
    tstep = ttrain.make_train_step(tsc, tt, device="cpu")
    b = _batch(jsc, 7)
    for _ in range(2):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tm = tstep(tstate, b)
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=2e-4)
    want = {jmesh._path_str(p): np.asarray(x) for p, x in
            jax.tree_util.tree_flatten_with_path(jstate.params)[0]}
    for p, t in ttrain.tree_leaves(tstate.params):
        np.testing.assert_allclose(t.detach().numpy(), want[p], atol=2e-5,
                                   rtol=2e-4, err_msg=p)

