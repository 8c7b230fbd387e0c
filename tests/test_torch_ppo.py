"""The port's reward model and PPO (`parallel/ppo.py`) against the JAX
package's on the CPU: `compute_gae` array for array, `token_logprobs`
and `sequence_reward` on shared weights and a shared value head, a
2-step reward-model trajectory over DPO pairs (loss, accuracy, margin,
the head and every LoRA leaf) and a 2-step PPO trajectory (every metric,
the head and every LoRA leaf) against JAX's steps on a one-device mesh.

The decoder runs at head_dim 128 (the flash training path's plain
versions); f32; tolerance rtol 2e-4, atol 2e-5 (f32 sums in another
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
from streamvln_tpu.parallel import ppo as jppo
from streamvln_tpu.parallel import train as jtrain
from streamvln_tpu_torch import configs as tcfg
from streamvln_tpu_torch.parallel import ppo as tppo
from streamvln_tpu_torch.parallel import train as ttrain
from streamvln_tpu_torch.weights import from_jax_params, tree_from_numpy

ATOL, RTOL = 2e-5, 2e-4
IMAGE = -200
LAYOUT = ("token_ids", "is_vision", "vision_index", "valid")
KW = dict(learning_rate=1e-2, total_steps=4, warmup_ratio=0.25,
          lora_only=True)


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


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree):
    return {jmesh._path_str(p): np.asarray(x) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def setup():
    jc, tc = _cfgs()
    params = jlora.add_lora(jsv.init(jax.random.PRNGKey(0), jc),
                            jax.random.PRNGKey(1), jc.llm, rank=4)
    head = jppo.init_value_head(jax.random.PRNGKey(2), jc)
    return jc, tc, _np(params), _np(head)


def _ppo_batch(jc, params):
    """Two rollouts: layouts, frames, response mask on the last real
    positions, old log-probs from JAX's token_logprobs, old values and
    rewards from numpy, advantages and returns by GAE."""
    rng = np.random.default_rng(3)
    layouts = [jsv.build_splice_layout(np.asarray(
        [7, IMAGE, 5, 6] + list(rng.integers(3, 400, n)), np.int32), jc,
        pad_to=96) for n in (40, 60)]
    layout = jsv.stack_layouts(layouts)
    S = jc.vision.image_size
    images = rng.random((2, 1, S, S, 3)).astype(np.float32)
    old = np.asarray(jax.jit(jppo.token_logprobs, static_argnums=1)(
        jax.tree.map(jnp.asarray, params), jc, jnp.asarray(images),
        {k: jnp.asarray(layout[k]) for k in LAYOUT}))
    mask = np.zeros_like(old)
    for b, n in enumerate(layout["lengths"]):
        mask[b, n - 12:n - 1] = 1.0
    values = (rng.standard_normal(old.shape) * 0.1).astype(np.float32)
    rewards = (rng.standard_normal(old.shape) * mask).astype(np.float32)
    # a rollout from a slightly older policy: ratios away from 1
    old = old + (rng.standard_normal(old.shape) * 0.3).astype(np.float32)
    return tppo.rollout_batch(layout, images, mask, old, values, rewards)


def test_compute_gae_matches_jax():
    rng = np.random.default_rng(4)
    r = rng.standard_normal((3, 9)).astype(np.float32)
    v = rng.standard_normal((3, 9)).astype(np.float32)
    m = (rng.random((3, 9)) > 0.3).astype(np.float32)
    for gamma, lam in ((1.0, 0.95), (0.9, 0.8)):
        for a, b in zip(tppo.compute_gae(r, v, m, gamma, lam),
                        jppo.compute_gae(r, v, m, gamma, lam)):
            np.testing.assert_array_equal(a, b)


def test_token_logprobs_and_reward_match_jax(setup):
    jc, tc, params, head = setup
    batch = _ppo_batch(jc, params)
    jp = jax.tree.map(jnp.asarray, params)
    tp = from_jax_params(params, tc, device="cpu")
    th = tree_from_numpy(head, device="cpu")
    jl = {k: jnp.asarray(batch[k]) for k in LAYOUT}
    tl = {k: torch.from_numpy(batch[k]) for k in LAYOUT}
    img = batch["images"]
    with torch.no_grad():
        np.testing.assert_allclose(
            tppo.token_logprobs(tp, tc, torch.from_numpy(img), tl).numpy(),
            np.asarray(jax.jit(jppo.token_logprobs, static_argnums=1)(
                jp, jc, jnp.asarray(img), jl)),
            atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(
            tppo.sequence_reward(tp, th, tc, torch.from_numpy(img),
                                 tl).numpy(),
            np.asarray(jax.jit(jppo.sequence_reward, static_argnums=2)(
                jp, jax.tree.map(jnp.asarray, head), jc, jnp.asarray(img),
                jl)),
            atol=ATOL, rtol=RTOL)
    g = torch.Generator().manual_seed(0)
    h = tppo.init_value_head(g, tc)
    assert h["w"].shape == (tc.llm.hidden_size, 1) and not h["b"].any()
    assert abs(h["w"].std().item() * tc.llm.hidden_size ** 0.5 - 1) < 0.3


def _compare(i, tstate, th, tm, jstate, jh, jm, keys):
    for k in keys:
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), atol=ATOL,
                                   rtol=RTOL, err_msg=f"step {i} {k}")
    for k in ("w", "b"):
        np.testing.assert_allclose(th[k].numpy(), np.asarray(jh[k]),
                                   atol=ATOL, rtol=RTOL,
                                   err_msg=f"step {i} head {k}")
    want = _flat(jstate.params)
    for p, t in ttrain.tree_leaves(tstate.params):
        np.testing.assert_allclose(t.detach().numpy(), want[p], atol=ATOL,
                                   rtol=RTOL, err_msg=f"step {i} {p}")


def test_reward_trajectory_matches_jax(setup):
    from test_torch_dpo import samples
    from streamvln_tpu_torch.data import chatml
    from streamvln_tpu_torch.data.tokenizer import ByteTokenizer
    from streamvln_tpu_torch.parallel import dpo as tdpo
    jc, tc, params, head = setup
    S = jc.vision.image_size
    jbatch = jdpo.make_dpo_batch(samples(jchatml, JByteTokenizer(), S), jc,
                                 length_buckets=(128,))
    tbatch = tdpo.make_dpo_batch(samples(chatml, ByteTokenizer(), S), tc,
                                 length_buckets=(128,))
    jt, tt = jtrain.TrainConfig(**KW), ttrain.TrainConfig(**KW)
    mesh = jmesh.make_mesh(dp=1, fsdp=1, tp=1, devices=jax.devices()[:1])
    jstate = jtrain.create_train_state(jax.tree.map(jnp.array, params), jt)
    jh = jax.tree.map(jnp.array, head)
    jstep, jopt = jppo.make_reward_step(jc, jt, mesh)
    jho = jopt.init(jh)
    tstate = ttrain.create_train_state(
        from_jax_params(params, tc, device="cpu"), tt)
    th = tree_from_numpy(head, device="cpu")
    tstep, init_opt = tppo.make_reward_step(tc, tt, "cpu")
    tho = init_opt(th)
    for i in range(2):
        jstate, jh, jho, jm = jstep(jstate, jh, jho, {
            k: jnp.asarray(v) for k, v in jbatch.items()})
        tstate, th, tho, tm = tstep(tstate, th, tho, tbatch)
        _compare(i, tstate, th, tm, jstate, jh, jm,
                 ("loss", "reward_accuracy", "reward_margin"))


def test_ppo_trajectory_matches_jax(setup):
    jc, tc, params, head = setup
    batch = _ppo_batch(jc, params)
    jt, tt = jtrain.TrainConfig(**KW), ttrain.TrainConfig(**KW)
    mesh = jmesh.make_mesh(dp=1, fsdp=1, tp=1, devices=jax.devices()[:1])
    jstate = jtrain.create_train_state(jax.tree.map(jnp.array, params), jt)
    jh = jax.tree.map(jnp.array, head)
    jstep, jopt = jppo.make_ppo_step(jc, jt, mesh, ent_coef=0.01)
    jho = jopt.init(jh)
    tstate = ttrain.create_train_state(
        from_jax_params(params, tc, device="cpu"), tt)
    th = tree_from_numpy(head, device="cpu")
    tstep, init_opt = tppo.make_ppo_step(tc, tt, "cpu", ent_coef=0.01)
    tho = init_opt(th)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    for i in range(2):
        jstate, jh, jho, jm = jstep(jstate, jh, jho, jbatch)
        tstate, th, tho, tm = tstep(tstate, th, tho, batch)
        _compare(i, tstate, th, tm, jstate, jh, jm,
                 ("loss", "pg_loss", "vf_loss", "entropy", "approx_kl",
                  "clip_frac"))
    assert 0.0 < tm["clip_frac"].item() < 1.0
