"""The port's HF checkpoint path against the JAX package's, on the CPU:
`convert_streamvln` leaf for leaf, `load_state_dict` on a directory the
JAX `save_hf` wrote, `export_hf` / `save_hf` name, shape and value for
value (plain and int8-quantized trees), the port's safetensors reader and
writer against the `safetensors` package for every dtype (BF16 included)
on single-file and index-sharded directories, `.bin` shards in their
stored dtype, missing keys and shards, and the port's qwen2 logits and
siglip features on converted `transformers` models against transformers'
own (f32, rtol = atol = 2e-4 as in tests/test_convert_hf.py: summation
order only).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamvln_tpu import configs as jcfg
from streamvln_tpu.models import convert_hf as jconvert
from streamvln_tpu.models import quant as jquant
from streamvln_tpu.models import streamvln as jsv
from streamvln_tpu.utils import checkpoint as jckpt
from streamvln_tpu_torch import configs as tcfg
from streamvln_tpu_torch.models import convert_hf, quant
from streamvln_tpu_torch.utils import checkpoint, safetensors_io
from streamvln_tpu_torch.weights import from_jax_params

torch.backends.cuda.matmul.allow_tf32 = False
ST_DTYPES = [torch.float64, torch.float32, torch.float16, torch.bfloat16,
             torch.int64, torch.int32, torch.int16, torch.int8, torch.uint8,
             torch.bool]


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def assert_trees_equal(a, b):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert la.keys() == lb.keys()
    for k in la:
        assert la[k].dtype == lb[k].dtype, k
        assert torch.equal(la[k], lb[k]), k


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree.map(np.asarray,
                        jsv.init(jax.random.PRNGKey(0), jcfg.tiny_streamvln()))


@pytest.fixture(scope="module")
def hf_state(jax_params):
    """A seeded HF state dict (the JAX export of the JAX init) with one
    more tower layer than the config runs, as the published checkpoint
    carries."""
    state = jckpt.export_hf(jax_params, jcfg.tiny_streamvln())
    vp = "model.vision_tower.vision_tower.vision_model.encoder.layers."
    n = jcfg.tiny_streamvln().vision.num_layers
    rng = np.random.default_rng(3)
    for k in [k for k in state if k.startswith(f"{vp}0.")]:
        state[k.replace(f"{vp}0.", f"{vp}{n}.")] = rng.standard_normal(
            state[k].shape).astype(np.float32)
    return state


def _torch_state(state):
    return {k: torch.from_numpy(np.array(v)) for k, v in state.items()}


@pytest.mark.parametrize("newline", [True, False])
def test_convert_streamvln_matches_jax(hf_state, newline):
    state = dict(hf_state)
    if not newline:
        del state["model.image_newline"]       # zeros in both packages
    jt = jax.tree.map(np.asarray, jconvert.convert_streamvln(
        state, jcfg.tiny_streamvln(), jnp.float32))
    want = from_jax_params(jt, tcfg.tiny_streamvln(), device="cpu")
    got = convert_hf.convert_streamvln(_torch_state(state),
                                       tcfg.tiny_streamvln(), torch.float32,
                                       device="cpu")
    assert_trees_equal(got, want)
    # the cast to bf16 happens once, from the stored values
    stats = {}
    bf = convert_hf.convert_streamvln(_torch_state(state),
                                      tcfg.tiny_streamvln(), torch.bfloat16,
                                      device="cpu", stats=stats)
    assert stats["bytes"] > 0 and {"upload_s", "convert_s"} <= stats.keys()
    for (k, a), (_, b) in zip(_leaves(bf), _leaves(want)):
        assert torch.equal(a, b.to(torch.bfloat16)), k


def test_load_state_dict_reads_what_jax_save_hf_wrote(tmp_path, jax_params):
    jckpt.save_hf(jax_params, jcfg.tiny_streamvln(), str(tmp_path))
    want = jconvert.load_state_dict(str(tmp_path))
    got = convert_hf.load_state_dict(str(tmp_path))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    # the whole checkpoint, as eval_cli loads it
    jt = jax.tree.map(np.asarray, jconvert.load_streamvln_checkpoint(
        str(tmp_path), jcfg.tiny_streamvln(), jnp.float32))
    assert_trees_equal(
        convert_hf.load_streamvln_checkpoint(
            str(tmp_path), tcfg.tiny_streamvln(), torch.float32, "cpu"),
        from_jax_params(jt, tcfg.tiny_streamvln(), device="cpu"))


@pytest.mark.parametrize("bits", [16, 8])
def test_export_and_save_hf_match_jax(tmp_path, jax_params, bits):
    tp = from_jax_params(jax_params, tcfg.tiny_streamvln(), device="cpu")
    jp = jax_params
    if bits == 8:               # quantized leaves are dequantized first
        jp = jax.tree.map(np.asarray, jquant.quantize_llm(jp, bits=8))
        tp = quant.quantize_llm(tp, bits=8)
    want = jckpt.export_hf(jp, jcfg.tiny_streamvln())
    got = checkpoint.export_hf(tp, tcfg.tiny_streamvln())
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    jckpt.save_hf(jp, jcfg.tiny_streamvln(), str(tmp_path / "jax"))
    checkpoint.save_hf(tp, tcfg.tiny_streamvln(), str(tmp_path / "port"))
    from safetensors.numpy import load_file
    a = load_file(str(tmp_path / "jax" / "model.safetensors"))
    b = load_file(str(tmp_path / "port" / "model.safetensors"))
    assert a.keys() == b.keys() == want.keys()
    for k in a:
        # the port's file holds the export's values
        np.testing.assert_array_equal(b[k], want[k], err_msg=k)
        # the JAX file holds each array's memory in its own order:
        # safetensors.numpy.save_file writes a transposed (Fortran-order)
        # matrix's buffer as if it were C-order (ROADMAP §3)
        mem = want[k].ravel(order="K").reshape(want[k].shape)
        np.testing.assert_array_equal(a[k], mem, err_msg=k)


def _every_dtype(seed=0):
    g = torch.Generator().manual_seed(seed)
    out = {}
    for i, dt in enumerate(ST_DTYPES):
        shape = (3, 5) if i % 2 else (7,)
        if dt.is_floating_point:
            t = torch.randn(shape, generator=g).to(dt)
        elif dt == torch.bool:
            t = torch.randint(0, 2, shape, generator=g).bool()
        else:
            info = torch.iinfo(dt)
            t = torch.randint(max(info.min, -2**20), min(info.max, 2**20),
                              shape, generator=g, dtype=torch.int64).to(dt)
        out[f"t.{str(dt).split('.')[-1]}"] = t
    out["scalar"] = torch.tensor(2.5, dtype=torch.bfloat16)
    out["empty"] = torch.zeros((0, 4), dtype=torch.float32)
    return out


def test_safetensors_io_against_the_package_every_dtype(tmp_path):
    st = pytest.importorskip("safetensors.torch")
    tensors = _every_dtype()
    ours, theirs = tmp_path / "ours.safetensors", tmp_path / "theirs.st"
    safetensors_io.save_file(tensors, str(ours), {"format": "pt"})
    st.save_file(tensors, str(theirs), metadata={"format": "pt"})
    for path in (ours, theirs):
        for got in (st.load_file(str(path)),
                    safetensors_io.load_file(str(path))):
            assert got.keys() == tensors.keys()
            for k, t in tensors.items():
                assert got[k].dtype == t.dtype and got[k].shape == t.shape, k
                assert torch.equal(got[k], t), k
    header, start = safetensors_io.read_header(str(ours))
    assert start % 8 == 0 and header["__metadata__"] == {"format": "pt"}


def test_sharded_directories_both_ways(tmp_path, jax_params):
    st = pytest.importorskip("safetensors.torch")
    cfg = tcfg.tiny_streamvln()
    tp = from_jax_params(jax_params, cfg, device="cpu")
    want = checkpoint.export_hf(tp, cfg, torch.bfloat16)
    # the port's shards, read by the package and by the port
    paths = checkpoint.save_hf(tp, cfg, str(tmp_path / "ours"),
                               torch.bfloat16, max_shard_bytes=40_000)
    assert len(paths) > 2
    with open(tmp_path / "ours" / "model.safetensors.index.json") as f:
        index = json.load(f)
    assert set(index["weight_map"]) == set(want)
    theirs = {}
    for p in paths:
        theirs.update(st.load_file(p))
    for got in (theirs, convert_hf.load_state_dict(str(tmp_path / "ours"))):
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == torch.bfloat16 and torch.equal(
                got[k], want[k]), k
    # the package's shards beside an index, read by the port
    d = tmp_path / "theirs"
    d.mkdir()
    names = sorted(want)
    files = {n: f"model-{i % 3 + 1:05d}-of-00003.safetensors"
             for i, n in enumerate(names)}
    for fname in sorted(set(files.values())):
        st.save_file({n: want[n] for n in names if files[n] == fname},
                     str(d / fname), metadata={"format": "pt"})
    with open(d / "model.safetensors.index.json", "w") as f:
        json.dump({"metadata": {}, "weight_map": files}, f)
    got = convert_hf.load_state_dict(str(d))
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert_trees_equal(
        convert_hf.load_streamvln_checkpoint(str(d), cfg, torch.bfloat16,
                                             "cpu"),
        convert_hf.convert_streamvln(want, cfg, torch.bfloat16, "cpu"))
    # a shard the index names is missing: refused, never filled in
    os.remove(d / "model-00002-of-00003.safetensors")
    with pytest.raises(FileNotFoundError, match="00002-of-00003"):
        convert_hf.load_state_dict(str(d))


def test_bin_shards_keep_their_dtype(tmp_path, hf_state):
    state = {k: torch.from_numpy(np.array(v)) for k, v in hf_state.items()}
    names = sorted(state)
    half = len(names) // 2
    parts = [{n: state[n].to(torch.bfloat16) for n in names[:half]},
             {n: state[n].to(torch.float16) for n in names[half:]}]
    for i, part in enumerate(parts):
        torch.save(part, tmp_path / f"pytorch_model-0000{i + 1}-of-00002.bin")
    got = convert_hf.load_state_dict(str(tmp_path))
    assert got.keys() == state.keys()
    for part in parts:
        for k, t in part.items():
            assert got[k].dtype == t.dtype and torch.equal(got[k], t), k
    # converted from the stored dtype, cast once
    cfg = tcfg.tiny_streamvln()
    tree = convert_hf.load_streamvln_checkpoint(str(tmp_path), cfg,
                                                torch.float32, "cpu")
    ref = convert_hf.convert_streamvln(
        {k: t.float() for p in parts for k, t in p.items()}, cfg,
        torch.float32, "cpu")
    assert_trees_equal(tree, ref)


def test_missing_key_or_shard_raises(tmp_path, hf_state):
    state = _torch_state(hf_state)
    del state["model.layers.1.mlp.down_proj.weight"]
    with pytest.raises(KeyError, match="model.layers.1.mlp.down_proj"):
        convert_hf.convert_streamvln(state, tcfg.tiny_streamvln(),
                                     torch.float32, "cpu")
    with pytest.raises(FileNotFoundError, match="no checkpoint shards"):
        convert_hf.load_state_dict(str(tmp_path))
    for fn in (convert_hf.convert_moe_llm, convert_hf.convert_mpt):
        with pytest.raises(NotImplementedError, match="item 10"):
            fn(state, tcfg.tiny_llm())


def test_projector_matches_torch_sequential():
    from streamvln_tpu_torch.models import projector
    torch.manual_seed(2)
    seq = torch.nn.Sequential(torch.nn.Linear(32, 64), torch.nn.GELU(),
                              torch.nn.Linear(64, 64)).eval()
    state = {f"mm_projector.{k}": v.detach()
             for k, v in seq.state_dict().items()}
    params = convert_hf.convert_projector(state, "mlp2x_gelu",
                                          dtype=torch.float32, device="cpu")
    x = torch.randn(5, 32)
    with torch.no_grad():
        np.testing.assert_allclose(projector.forward(params, x).numpy(),
                                   seq(x).numpy(), rtol=1e-4, atol=1e-5)


def test_qwen2_logits_match_transformers():
    transformers = pytest.importorskip("transformers")
    from streamvln_tpu_torch.models import qwen2
    torch.manual_seed(0)
    hf_cfg = transformers.Qwen2Config(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=256, rope_theta=10000.0, rms_norm_eps=1e-6,
        tie_word_embeddings=False, attn_implementation="eager")
    model = transformers.Qwen2ForCausalLM(hf_cfg).eval().float()
    cfg = tcfg.Qwen2Config(
        vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=2,
        num_heads=4, num_kv_heads=2, head_dim=16, rope_theta=10000.0,
        tie_word_embeddings=False)
    params = convert_hf.convert_qwen2(
        {k: v.detach() for k, v in model.state_dict().items()}, cfg,
        dtype=torch.float32, device="cpu")
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, 128, (2, 12)))
    with torch.no_grad():
        ref = model(ids).logits
        pos = torch.arange(12).expand(2, 12)
        ours, _ = qwen2.forward(params, cfg, qwen2.embed_tokens(params, ids),
                                pos, attn_impl="dense")
    np.testing.assert_allclose(ours.numpy(), ref.numpy(), rtol=2e-4,
                               atol=2e-4)


def test_siglip_features_match_transformers():
    transformers = pytest.importorskip("transformers")
    from streamvln_tpu_torch.models import siglip
    torch.manual_seed(0)
    # a 3-layer checkpoint; the port drops the last -> num_layers=2
    hf_cfg = transformers.SiglipVisionConfig(
        hidden_size=32, intermediate_size=64, num_hidden_layers=3,
        num_attention_heads=4, image_size=28, patch_size=14,
        hidden_act="gelu_pytorch_tanh", layer_norm_eps=1e-6,
        attn_implementation="eager")
    model = transformers.SiglipVisionModel(hf_cfg).eval().float()
    cfg = tcfg.SigLIPConfig(hidden_size=32, intermediate_size=64,
                            num_layers=2, num_heads=4, image_size=28,
                            patch_size=14)
    params = convert_hf.convert_siglip(
        {k: v.detach() for k, v in model.state_dict().items()}, cfg,
        dtype=torch.float32, device="cpu")
    imgs = torch.from_numpy(
        np.random.RandomState(1).randn(2, 28, 28, 3).astype(np.float32))
    with torch.no_grad():
        out = model(imgs.permute(0, 3, 1, 2), output_hidden_states=True)
        # the truncated stack's last hidden state, before the post-norm
        ref = out.hidden_states[-2]
        ours = siglip.forward(params, cfg, imgs, attn_impl="dense")
    np.testing.assert_allclose(ours.numpy(), ref.numpy(), rtol=2e-4,
                               atol=2e-4)


def test_a_bf16_checkpoint_loads_as_in_the_reference(tmp_path, jax_params):
    """Published checkpoints ship in bf16. The port reads them in their
    stored dtype; the reference reads them through numpy, whose bfloat16
    comes from ml_dtypes (registered when jax is imported; ROADMAP §3).
    Both give the same tree."""
    cfg = tcfg.tiny_streamvln()
    tp = from_jax_params(jax_params, cfg, device="cpu")
    checkpoint.save_hf(tp, cfg, str(tmp_path), torch.bfloat16)
    state = convert_hf.load_state_dict(str(tmp_path))
    assert {t.dtype for t in state.values()} == {torch.bfloat16}
    jt = jax.tree.map(np.asarray, jconvert.load_streamvln_checkpoint(
        str(tmp_path), jcfg.tiny_streamvln(), jnp.float32))
    tree = convert_hf.load_streamvln_checkpoint(str(tmp_path), cfg,
                                                torch.float32, "cpu")
    assert_trees_equal(tree, from_jax_params(jt, cfg, device="cpu"))
    for (k, a), (_, b) in zip(_leaves(tree), _leaves(tp)):
        assert torch.equal(a, b.to(torch.bfloat16).float()), k
