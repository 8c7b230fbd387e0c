"""The port's DDPO (`parallel/ddpo.py`) against the JAX package's on the
CPU: the alpha schedule, `ddim_step_logprob` scoring a given
prev_sample (per-sample and scalar timesteps, the final step),
`PerPromptStatTracker` array for array, a 3-step DDPO trajectory with a
two-layer MLP denoiser written in both frameworks (loss, approx-KL,
clipfrac, every param), and `sample_with_logprob` by its support: the
shapes, determinism by seed, and each drawn step's log-prob equal to
JAX's density of the same draw (the two generators' bits differ).

f32; tolerance rtol 2e-4, atol 2e-5 (f32 sums in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamvln_tpu.parallel import ddpo as jddpo
from streamvln_tpu_torch.parallel import ddpo as tddpo
from streamvln_tpu_torch.weights import tree_from_numpy

ATOL, RTOL = 2e-5, 2e-4
SHAPE = (4, 4, 8, 8)          # B, C, H, W latents
E, H = 6, 32                  # prompt embedding and hidden widths


def _mlp_np(seed=0):
    rng = np.random.default_rng(seed)
    D = int(np.prod(SHAPE[1:]))
    return {"w1": (rng.standard_normal((D, H)) * D ** -0.5).astype(
                np.float32),
            "b1": np.zeros((H,), np.float32),
            "wt": (rng.standard_normal((1, H)) * 0.5).astype(np.float32),
            "we": (rng.standard_normal((E, H)) * E ** -0.5).astype(
                np.float32),
            "w2": (rng.standard_normal((H, D)) * H ** -0.5).astype(
                np.float32),
            "b2": np.zeros((D,), np.float32)}


def jax_apply(p, x, t, emb):
    h = jnp.tanh(x.reshape(x.shape[0], -1) @ p["w1"] + p["b1"]
                 + (t[:, None].astype(jnp.float32) / 1000.0) @ p["wt"]
                 + emb @ p["we"])
    return (h @ p["w2"] + p["b2"]).reshape(x.shape)


def torch_apply(p, x, t, emb):
    h = torch.tanh(x.reshape(x.shape[0], -1) @ p["w1"] + p["b1"]
                   + (t[:, None].float() / 1000.0) @ p["wt"]
                   + emb @ p["we"])
    return (h @ p["w2"] + p["b2"]).reshape(x.shape)


@pytest.fixture(scope="module")
def alphas():
    """JAX's schedule, fed to both sides (the port's own is checked in
    test_alphas_cumprod_matches_jax)."""
    a_j = jddpo.make_alphas_cumprod()
    return torch.from_numpy(np.array(a_j)), a_j


def test_alphas_cumprod_matches_jax():
    # f32 linspace rounds differently in the two frameworks: 1 ulp
    np.testing.assert_allclose(tddpo.make_alphas_cumprod().numpy(),
                               np.asarray(jddpo.make_alphas_cumprod()),
                               rtol=2e-6)


@pytest.mark.parametrize("t,t_prev", [(500, 480), (20, -1),
                                      ([900, 600, 40, 20], [880, 580, 20,
                                                            -1])])
def test_ddim_step_logprob_scores_a_given_sample(alphas, t, t_prev):
    a_t, a_j = alphas
    rng = np.random.default_rng(1)
    x, eps, prev = (rng.standard_normal(SHAPE).astype(np.float32)
                    for _ in range(3))
    jt, jtp = jnp.asarray(t), jnp.asarray(t_prev)
    want_prev, want = jddpo.ddim_step_logprob(
        jnp.asarray(eps), jt, jtp, jnp.asarray(x), a_j, 1.0,
        prev_sample=jnp.asarray(prev))
    got_prev, got = tddpo.ddim_step_logprob(
        torch.from_numpy(eps), torch.as_tensor(t), torch.as_tensor(t_prev),
        torch.from_numpy(x), a_t, 1.0, prev_sample=torch.from_numpy(prev))
    np.testing.assert_array_equal(got_prev.numpy(), np.asarray(want_prev))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    assert np.isfinite(got.numpy()).all()


def test_per_prompt_stat_tracker_matches_jax():
    rng = np.random.default_rng(2)
    mine, ref = tddpo.PerPromptStatTracker(8, 4), \
        jddpo.PerPromptStatTracker(8, 4)
    for _ in range(4):
        prompts = rng.choice(["a cat", "a dog", "a ship"], 6)
        rewards = rng.standard_normal(6)
        np.testing.assert_array_equal(mine.update(prompts, rewards),
                                      ref.update(prompts, rewards))


def _batch(alphas_j, params, seed):
    """One unpacked timestep of rollouts: latents, next_latents, the
    timesteps, old log-probs (JAX's density under the initial denoiser,
    nudged so that ratios leave 1), advantages and prompt embeddings."""
    rng = np.random.default_rng(seed)
    B = SHAPE[0]
    b = {"latents": rng.standard_normal(SHAPE).astype(np.float32),
         "next_latents": rng.standard_normal(SHAPE).astype(np.float32),
         "timesteps": np.full((B,), 500, np.int32),
         "prev_timesteps": np.full((B,), 480, np.int32),
         "advantages": (rng.standard_normal(B) * 3).astype(np.float32),
         "embeds": rng.standard_normal((B, E)).astype(np.float32)}
    jp = jax.tree.map(jnp.asarray, params)
    eps = jax_apply(jp, jnp.asarray(b["latents"]),
                    jnp.asarray(b["timesteps"]), jnp.asarray(b["embeds"]))
    _, lp = jddpo.ddim_step_logprob(
        eps, jnp.asarray(b["timesteps"]), jnp.asarray(b["prev_timesteps"]),
        jnp.asarray(b["latents"]), alphas_j, 1.0,
        prev_sample=jnp.asarray(b["next_latents"]))
    b["old_logps"] = (np.asarray(lp) + rng.standard_normal(B) * 1e-4) \
        .astype(np.float32)
    return b


def test_ddpo_trajectory_matches_jax(alphas):
    a_t, a_j = alphas
    params = _mlp_np()
    cfg = jddpo.DDPOConfig(learning_rate=1e-2, max_grad_norm=0.5)
    tx, jstep = jddpo.make_ddpo_step(jax_apply, a_j, cfg)
    jp = jax.tree.map(jnp.asarray, params)
    jopt = tx.init(jp)
    init_opt, tstep = tddpo.make_ddpo_step(
        torch_apply, a_t, tddpo.DDPOConfig(learning_rate=1e-2,
                                           max_grad_norm=0.5))
    tp = tree_from_numpy(params, device="cpu")
    topt = init_opt(tp)
    for i in range(3):
        b = _batch(a_j, params, 10 + i)
        jp, jopt, jm = jstep(jp, jopt, {k: jnp.asarray(v) for k, v in
                                        b.items()})
        tp, topt, tm = tstep(tp, topt, {k: torch.from_numpy(v) for k, v in
                                        b.items()})
        for k in ("loss", "approx_kl", "clipfrac"):
            np.testing.assert_allclose(tm[k].item(), float(jm[k]),
                                       atol=ATOL, rtol=RTOL,
                                       err_msg=f"step {i} {k}")
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       atol=ATOL, rtol=RTOL,
                                       err_msg=f"step {i} {k}")
    assert 0.0 < tm["clipfrac"].item()


def test_sample_with_logprob_support_and_seed(alphas):
    a_t, a_j = alphas
    params = _mlp_np(3)
    tp = tree_from_numpy(params, device="cpu")
    rng = np.random.default_rng(4)
    x0 = torch.from_numpy(rng.standard_normal(SHAPE).astype(np.float32))
    emb = torch.from_numpy(rng.standard_normal((SHAPE[0], E)).astype(
        np.float32))
    steps = torch.linspace(980, 0, 8).long()

    def roll(seed):
        return tddpo.sample_with_logprob(
            torch_apply, tp, torch.Generator().manual_seed(seed), x0, steps,
            emb, a_t)
    lat, nxt, lps = roll(0)
    assert lat.shape == nxt.shape == (8,) + SHAPE and lps.shape == (8, 4)
    assert torch.equal(lat[0], x0) and torch.equal(lat[1:], nxt[:-1])
    again = roll(0)
    assert all(torch.equal(a, b) for a, b in zip((lat, nxt, lps), again))
    assert not torch.equal(roll(1)[1], nxt)
    assert torch.isfinite(lps).all()
    # each draw's log-prob is JAX's density of the same draw
    jp = jax.tree.map(jnp.asarray, params)
    prevs = list(steps.tolist()[1:]) + [-1]
    for s, (t, tpv) in enumerate(zip(steps.tolist(), prevs)):
        x = jnp.asarray(lat[s].numpy())
        eps = jax_apply(jp, x, jnp.full((SHAPE[0],), t), jnp.asarray(
            emb.numpy()))
        _, want = jddpo.ddim_step_logprob(
            eps, jnp.asarray(t), jnp.asarray(tpv), x, a_j, 1.0,
            prev_sample=jnp.asarray(nxt[s].numpy()))
        np.testing.assert_allclose(lps[s].numpy(), np.asarray(want),
                                   atol=1e-4, rtol=RTOL, err_msg=f"step {s}")
