"""The port's train step on a mesh (4-rank gloo group, params as DTensors)
against the JAX package's `make_train_step` on the same mesh shapes over
the 8 virtual CPU devices: the tiny model's full SFT on (2, 2, 1) and on
(1, 2, 2) for two steps (loss, grad_norm, every param after the last
step), a tiny MoE step on (1, 2, 2), and a LoRA step over int8 frozen
leaves on (2, 2, 1); and one DPO step on (1, 2, 1) (the other two ranks
outside the mesh) against the port's one-device DPO step.

The batches' rows hold different numbers of supervised tokens, so a mean
of per-rank means would differ from JAX's loss (the sum over the global
batch divided by the global count). Weights are the JAX init's; f32;
tolerance rtol 2e-4, atol 2e-5 (f32 sums in another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_ranks
from streamvln_tpu import configs as jcfg
from streamvln_tpu.models import lora as jlora
from streamvln_tpu.models import quant as jquant
from streamvln_tpu.models import streamvln as jsv
from streamvln_tpu.parallel import mesh as jmesh
from streamvln_tpu.parallel import train as jtrain
from streamvln_tpu_torch import configs as tcfg
from streamvln_tpu_torch.parallel import dpo as tdpo
from streamvln_tpu_torch.parallel import train as ttrain
from streamvln_tpu_torch.weights import from_jax_params

ATOL, RTOL = 2e-5, 2e-4
IMAGE, IGNORE = -200, -100
WORLD = 4


def _port_cfg(jc):
    return tcfg.StreamVLNConfig(
        vision=tcfg.SigLIPConfig(**dataclasses.asdict(jc.vision)),
        llm=tcfg.Qwen2Config(**dataclasses.asdict(jc.llm)),
        **{f.name: getattr(jc, f.name) for f in dataclasses.fields(jc)
           if f.name not in ("vision", "llm")})


def _jc(**llm):
    """tiny_streamvln with a head_dim-128 decoder (the flash training
    path's plain versions) and any other decoder knobs."""
    jc = jcfg.tiny_streamvln()
    return dataclasses.replace(jc, llm=dataclasses.replace(
        jc.llm, num_heads=2, num_kv_heads=1, head_dim=128, **llm))


def _rows(cfg, rng, lengths, T):
    out = []
    for n in lengths:
        ids = np.concatenate([[7, IMAGE, 9, IMAGE],
                              rng.integers(3, 500, n)]).astype(np.int32)
        # a different share of supervised tokens in every row
        labels = np.where(np.arange(len(ids)) > len(ids) // 2 + n // 3,
                          ids, IGNORE)
        out.append((ids, labels))
    return out


def _batch(cfg, seed, lengths=(40, 70, 25, 55), T=128):
    rng = np.random.default_rng(seed)
    layouts = [jsv.build_splice_layout(ids, cfg, labels=lab, pad_to=T)
               for ids, lab in _rows(cfg, rng, lengths, T)]
    batch = jsv.stack_layouts(layouts)
    del batch["lengths"]
    S = cfg.vision.image_size
    batch["images"] = rng.standard_normal(
        (len(lengths), 2, S, S, 3)).astype(np.float32)
    return batch


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree):
    return {jmesh._path_str(p): np.asarray(x) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


# eps 1e-6: Adam divides each gradient by its own size, so at eps 1e-8 the
# last-bit noise of a near-zero gradient (a rare token's embedding row;
# the mesh sums the ranks' rows in another order than JAX) moves that
# element's update by a sizeable share of the learning rate
KW = dict(learning_rate=1e-3, projector_lr=3e-4, total_steps=4,
          warmup_ratio=0.25, grad_clip=0.5, weight_decay=0.01,
          loss_chunk_size=64, eps=1e-6)


def _cases():
    """(name, mesh shape, JAX config, params, train kwargs, steps)."""
    key = jax.random.PRNGKey(0)
    dense = _jc()
    moe = _jc(num_experts=4, num_experts_per_tok=2, qkv_bias=False)
    p = jsv.init(key, dense)
    p8 = jlora.add_lora(jquant.quantize_llm(p, bits=8),
                        jax.random.PRNGKey(3), dense.llm, rank=4)
    return [
        ("sft_2x2x1", (2, 2, 1), dense, p, dict(KW), 2),
        ("sft_1x2x2", (1, 2, 2), dense, p, dict(KW, freeze_vision=True), 2),
        ("moe_1x2x2", (1, 2, 2), moe, jsv.init(key, moe), dict(KW), 1),
        ("lora_int8_2x2x1", (2, 2, 1), dense, p8,
         dict(KW, lora_only=True), 1),
    ]


def _dpo_case():
    jc = _jc()
    rng = np.random.default_rng(11)
    S = jc.vision.image_size
    samples = []
    for n in (30, 50):
        ids = np.concatenate([[7, IMAGE, 9, IMAGE],
                              rng.integers(3, 500, n)]).astype(np.int32)
        lab = np.where(np.arange(len(ids)) > 10, ids, IGNORE)
        alt = ids.copy()
        alt[-n // 2:] = rng.integers(3, 500, n // 2)
        samples.append({"chosen_input_ids": ids, "chosen_labels": lab,
                        "rejected_input_ids": alt,
                        "rejected_labels": np.where(lab == IGNORE, IGNORE,
                                                    alt),
                        "images": rng.standard_normal(
                            (2, S, S, 3)).astype(np.float32)})
    batch = tdpo.make_dpo_batch(samples, _port_cfg(jc), length_buckets=(128,))
    params = _np(jsv.init(jax.random.PRNGKey(5), jc))
    return jc, params, batch


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cases = []
    for name, shape, jc, p, kw, steps in _cases():
        cases.append({"mesh": shape, "cfg": _port_cfg(jc),
                      "tcfg": ttrain.TrainConfig(**kw), "params": _np(p),
                      "batches": [_batch(jc, 7 + i) for i in range(steps)]})
    jc, params, batch = _dpo_case()
    cases.append({"mesh": (1, 2, 1), "cfg": _port_cfg(jc),
                  "tcfg": ttrain.TrainConfig(**KW), "params": params,
                  "batches": [batch], "dpo": (params, 0.1)})
    return torch_ranks.run(torch_ranks.train_rank, WORLD,
                           tmp_path_factory.mktemp("mesh"), cases,
                           timeout=240)


@pytest.mark.parametrize("i", range(4), ids=["sft_2x2x1", "sft_1x2x2",
                                              "moe_1x2x2",
                                              "lora_int8_2x2x1"])
def test_mesh_train_step_matches_jax(ranks, i):
    name, shape, jc, p, kw, steps = _cases()[i]
    mesh = jmesh.make_mesh(*shape, devices=jax.devices()[:np.prod(shape)])
    jt = jtrain.TrainConfig(**kw)
    state = jtrain.create_train_state(jmesh.shard_params(p, mesh), jt)
    step = jtrain.make_train_step(jc, jt, mesh)
    want = []
    for s in range(steps):
        state, m = step(state, {k: jnp.asarray(v) for k, v in
                                _batch(jc, 7 + s).items()})
        want.append({k: float(v) for k, v in m.items()})
    for r in range(WORLD):
        got = ranks[r][i]
        assert got["dtensor"], "params must stay DTensors on the mesh"
        for g, w in zip(got["metrics"], want):
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=RTOL)
            np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                       rtol=RTOL)
    flat = _flat(state.params)
    got = ranks[0][i]["params"]
    assert set(got) == set(flat)
    for path, x in flat.items():
        np.testing.assert_allclose(got[path], x, atol=ATOL, rtol=RTOL,
                                   err_msg=path)


def test_mesh_dpo_step_matches_one_device(ranks):
    jc, params, batch = _dpo_case()
    tc = _port_cfg(jc)
    tt = ttrain.TrainConfig(**KW)
    state = ttrain.create_train_state(from_jax_params(params, tc, "cpu"),
                                      tt)
    ref = from_jax_params(params, tc, "cpu")
    state, m = tdpo.make_dpo_step(tc, tt, "cpu", 0.1)(state, ref, batch)
    for r in (0, 1):
        got = ranks[r][4]
        for k, v in m.items():
            np.testing.assert_allclose(got["metrics"][0][k], float(v),
                                       rtol=RTOL, atol=ATOL, err_msg=k)
    assert ranks[2][4] is None and ranks[3][4] is None
    for path, t in ttrain.tree_leaves(state.params):
        np.testing.assert_allclose(ranks[0][4]["params"][path],
                                   t.detach().numpy(), atol=ATOL,
                                   rtol=RTOL, err_msg=path)
    assert float(m["dpo_accuracy"]) in (0.0, 0.5, 1.0)
