"""The port's DPO (`parallel/dpo.py`) against the JAX package's on the
CPU: `make_dpo_batch` array for array on ByteTokenizer pairs that share
their frames, `sequence_logprob` and `dpo_loss` with its metrics on
shared weights (a LoRA policy with nonzero adapters against its base as
the reference, the same storage in the port), and a 2-step LoRA DPO
trajectory (loss, accuracy, margin, every LoRA leaf) against JAX's
`make_dpo_step` on a one-device mesh.

The decoder runs at head_dim 128 so that the port's flash training path
(K3/K4/K5's plain versions) and the no-grad reference path (K2's) are
reached; f32; tolerance rtol 2e-4, atol 2e-5 (f32 sums in another
order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamvln_tpu import configs as jcfg
from streamvln_tpu.data import chatml as jchatml
from streamvln_tpu.data.tokenizer import ByteTokenizer as JByteTokenizer
from streamvln_tpu.models import lora as jlora
from streamvln_tpu.models import streamvln as jsv
from streamvln_tpu.parallel import dpo as jdpo
from streamvln_tpu.parallel import mesh as jmesh
from streamvln_tpu.parallel import train as jtrain
from streamvln_tpu_torch import configs as tcfg
from streamvln_tpu_torch.data import chatml
from streamvln_tpu_torch.data.tokenizer import ByteTokenizer
from streamvln_tpu_torch.models import lora as tlora
from streamvln_tpu_torch.parallel import dpo as tdpo
from streamvln_tpu_torch.parallel import train as ttrain
from streamvln_tpu_torch.weights import from_jax_params

ATOL, RTOL = 2e-5, 2e-4
BUCKETS = (128, 256)
ANSWERS = [("↑↑→", "←←"), ("STOP", "↑↑↑↑")]


def _cfgs():
    jc = jcfg.tiny_streamvln()
    jc = dataclasses.replace(jc, llm=dataclasses.replace(
        jc.llm, num_heads=2, num_kv_heads=1, head_dim=128))
    tc = tcfg.StreamVLNConfig(
        vision=tcfg.SigLIPConfig(**dataclasses.asdict(jc.vision)),
        llm=tcfg.Qwen2Config(**dataclasses.asdict(jc.llm)),
        **{f.name: getattr(jc, f.name) for f in dataclasses.fields(jc)
           if f.name not in ("vision", "llm")})
    return jc, tc


def samples(chat, tok, S, seed=0):
    """Preference pairs sharing one prompt's frames: chosen and rejected
    answers to 'go forward you can see <image><image>.'."""
    rng = np.random.default_rng(seed)
    out = []
    for chosen, rejected in ANSWERS:
        s = {"images": rng.random((2, S, S, 3)).astype(np.float32)}
        for side, ans in (("chosen", chosen), ("rejected", rejected)):
            turns = [("user", "go forward you can see <image><image>."),
                     ("assistant", ans)]
            ids, labels = chat.tokenize_dialogue(tok, turns,
                                                 add_system=False)
            s[f"{side}_input_ids"] = np.asarray(ids)
            s[f"{side}_labels"] = np.asarray(labels)
        out.append(s)
    return out


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree):
    return {jmesh._path_str(p): np.asarray(x) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def setup():
    jc, tc = _cfgs()
    base = jsv.init(jax.random.PRNGKey(0), jc)
    policy = jlora.add_lora(base, jax.random.PRNGKey(1), jc.llm, rank=4)
    rng = np.random.default_rng(2)
    # nonzero adapters: the policy differs from its base
    policy = jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.asarray(rng.standard_normal(x.shape) * 0.05,
                                 x.dtype)
        if "_lora_b" in jmesh._path_str(p) else x, policy)
    S = jc.vision.image_size
    jbatch = jdpo.make_dpo_batch(samples(jchatml, JByteTokenizer(), S), jc,
                                 length_buckets=BUCKETS)
    tbatch = tdpo.make_dpo_batch(samples(chatml, ByteTokenizer(), S), tc,
                                 length_buckets=BUCKETS)
    return jc, tc, _np(policy), jbatch, tbatch


def test_make_dpo_batch_matches_jax(setup):
    _, _, _, jbatch, tbatch = setup
    assert set(jbatch) == set(tbatch)
    for k in jbatch:
        np.testing.assert_array_equal(tbatch[k], np.asarray(jbatch[k]),
                                      err_msg=k)
    assert tbatch["chosen_token_ids"].shape[1] in BUCKETS


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def test_sequence_logprob_and_dpo_loss_match_jax(setup):
    jc, tc, policy, jbatch, tbatch = setup
    jp = jax.tree.map(jnp.asarray, policy)
    jref = jlora.split_lora(jp)[0]
    tp = from_jax_params(policy, tc, device="cpu")
    tref = tlora.split_lora(tp)[0]
    assert tref["llm"]["layers"]["q_w"] is tp["llm"]["layers"]["q_w"]
    tb = _t(tbatch)
    layout = {k: tb[f"chosen_{k}"] for k in tdpo.SIDE_KEYS}
    want = jax.jit(jdpo.sequence_logprob, static_argnums=1)(
        jp, jc, jnp.asarray(jbatch["images"]),
        {k: jnp.asarray(jbatch[f"chosen_{k}"]) for k in tdpo.SIDE_KEYS})
    with torch.no_grad():
        got = tdpo.sequence_logprob(tp, tc, tb["images"], layout)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)

    jl, jaux = jax.jit(jdpo.dpo_loss, static_argnums=(2, 4))(
        jp, jref, jc, {k: jnp.asarray(v) for k, v in jbatch.items()}, 0.5)
    tl, taux = tdpo.dpo_loss(tp, tref, tc, tb, beta=0.5)
    np.testing.assert_allclose(tl.item(), float(jl), atol=ATOL, rtol=RTOL)
    assert set(taux) == set(jaux)
    for k in jaux:
        np.testing.assert_allclose(taux[k].item(), float(jaux[k]),
                                   atol=ATOL, rtol=RTOL, err_msg=k)


def test_dpo_trajectory_matches_jax(setup):
    """Two LoRA DPO steps; the reference is the policy's frozen base
    (split_lora: the same tensors in the port)."""
    jc, tc, policy, jbatch, tbatch = setup
    kw = dict(learning_rate=1e-2, total_steps=4, warmup_ratio=0.25,
              lora_only=True)
    jt, tt = jtrain.TrainConfig(**kw), ttrain.TrainConfig(**kw)
    mesh = jmesh.make_mesh(dp=1, fsdp=1, tp=1, devices=jax.devices()[:1])
    jstate = jtrain.create_train_state(jax.tree.map(jnp.array, policy), jt)
    jref = jlora.split_lora(jax.tree.map(jnp.array, policy))[0]
    jstep = jdpo.make_dpo_step(jc, jt, mesh, beta=0.5)
    tstate = ttrain.create_train_state(
        from_jax_params(policy, tc, device="cpu"), tt)
    tref = tlora.split_lora(tstate.params)[0]
    tstep = tdpo.make_dpo_step(tc, tt, "cpu", beta=0.5)
    base = {p: t.clone() for p, t in ttrain.tree_leaves(tstate.params)
            if not tlora.is_lora_path(p)}
    for i in range(2):
        jstate, jm = jstep(jstate, jref, {k: jnp.asarray(v) for k, v in
                                          jbatch.items()})
        tstate, tm = tstep(tstate, tref, tbatch)
        for k in ("loss", "dpo_accuracy", "reward_margin"):
            np.testing.assert_allclose(tm[k].item(), float(jm[k]),
                                       atol=ATOL, rtol=RTOL,
                                       err_msg=f"step {i} {k}")
        want = _flat(jstate.params)
        for p, t in ttrain.tree_leaves(tstate.params):
            if tlora.is_lora_path(p):
                np.testing.assert_allclose(t.detach().numpy(), want[p],
                                           atol=ATOL, rtol=RTOL,
                                           err_msg=f"step {i} {p}")
    assert np.isfinite(tm["grad_norm"].item())
    # the base (and so the reference) never moved
    for p, t in base.items():
        assert torch.equal(dict(ttrain.tree_leaves(tstate.params))[p], t), p
