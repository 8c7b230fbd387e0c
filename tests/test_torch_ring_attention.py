"""The port's ring attention on a 4-rank gloo group against the JAX
package's `make_ring_attention` on 4 of the 8 virtual CPU devices: the
output for (Hq, Hkv) = (4, 4) and (8, 2), with padded keys at
INVALID_POS, padded queries at position 0 and a query row that sees no
key (the mean of v over all keys, as the JAX block gives it); zigzag
against plain; and the q/k/v gradients of each rank's shard against
`jax.grad` through the shard_map. The ranks' dry run
(`ring_attention_dryrun`) checks zigzag against dense attention too.

Inputs are made with numpy from fixed seeds, f32; tolerance rtol 2e-4,
atol 2e-5 (f32 sums in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_ranks
from streamvln_tpu.ops import ring_attention as jra
from streamvln_tpu.parallel import mesh as jmesh
from streamvln_tpu_torch.ops import ring_attention as tra

ATOL, RTOL = 2e-5, 2e-4
WORLD = 4
INVALID_POS = 1 << 30


def _case(seed, Hq, Hkv, B=2, S=32, D=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    g = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    q_pos, k_pos = pos.copy(), pos.copy()
    q_pos[1, 26:] = 0                 # padded queries
    k_pos[1, 26:] = INVALID_POS       # padded keys
    q_pos[0, 5] = -1                  # a row that sees no key
    return q, k, v, q_pos, k_pos, g


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cases = {"mha": _case(0, 4, 4), "gqa": _case(1, 8, 2)}
    got = torch_ranks.run(torch_ranks.ring_rank, WORLD,
                          tmp_path_factory.mktemp("ring"), cases)
    return cases, got


def _jax(case, zigzag=False):
    mesh = jmesh.make_mesh(dp=1, fsdp=WORLD, tp=1,
                           devices=jax.devices()[:WORLD])
    fn = jra.make_ring_attention(mesh, "fsdp", zigzag=zigzag)
    q, k, v, qp, kp, g = (jnp.asarray(x) for x in case)
    return fn, (q, k, v, qp, kp, g)


@pytest.mark.parametrize("name", ["mha", "gqa"])
def test_ring_forward_matches_jax(ranks, name):
    cases, got = ranks
    fn, (q, k, v, qp, kp, _) = _jax(cases[name])
    want = np.asarray(fn(q, k, v, qp, kp))
    for r in range(WORLD):
        np.testing.assert_allclose(got[r][name]["plain"], want, atol=ATOL,
                                   rtol=RTOL, err_msg=f"rank {r}")
    # the row that sees no key: the mean of v over all keys (the JAX
    # block's p = 1 on every masked score)
    vb = cases[name][2][0]                                 # [S, Hkv, D]
    G = q.shape[2] // vb.shape[1]
    np.testing.assert_allclose(want[0, 5], np.repeat(vb.mean(0), G, 0),
                               atol=1e-5)


@pytest.mark.parametrize("name", ["mha", "gqa"])
def test_ring_zigzag_matches_plain_and_jax(ranks, name):
    cases, got = ranks
    fn, (q, k, v, qp, kp, _) = _jax(cases[name], zigzag=True)
    want = np.asarray(fn(q, k, v, qp, kp))
    for r in range(WORLD):
        np.testing.assert_allclose(got[r][name]["zigzag"], want, atol=ATOL,
                                   rtol=RTOL)
        np.testing.assert_allclose(got[r][name]["zigzag"],
                                   got[r][name]["plain"], atol=ATOL,
                                   rtol=RTOL)
        assert got[r]["dryrun"] is True


@pytest.mark.parametrize("name", ["mha", "gqa"])
def test_ring_grads_match_jax(ranks, name):
    """Each rank's ring_attention on its shard and its q/k/v grads, the
    ranks' shards put together, against jax.grad of vdot(out, g)."""
    cases, got = ranks
    fn, (q, k, v, qp, kp, g) = _jax(cases[name])

    def loss(q, k, v):
        return jnp.vdot(fn(q, k, v, qp, kp), g)
    jgrads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    local = np.concatenate([got[r][name]["local"] for r in range(WORLD)], 1)
    np.testing.assert_allclose(local, np.asarray(fn(q, k, v, qp, kp)),
                               atol=ATOL, rtol=RTOL)
    for i, n in enumerate("qkv"):
        mine = np.concatenate([got[r][name]["grads"][i]
                               for r in range(WORLD)], 1)
        np.testing.assert_allclose(mine, np.asarray(jgrads[i]), atol=ATOL,
                                   rtol=RTOL, err_msg=f"d{n}")


def test_make_mesh_sizes_on_four_ranks(ranks):
    """fsdp=None takes the rest of the world; a smaller mesh covers the
    first ranks, as JAX's takes the first devices."""
    _, got = ranks
    want = [dict(dp=1, fsdp=4, tp=1), dict(dp=2, fsdp=2, tp=1),
            dict(dp=1, fsdp=1, tp=2), dict(dp=2, fsdp=1, tp=2)]
    for r in range(WORLD):
        assert got[r]["sizes"] == want
        assert list(got[r]["coord"]) == [0, r, 0]
    for kw, w in zip((dict(), dict(dp=2), dict(tp=2, fsdp=1),
                      dict(dp=2, tp=2)), want):
        mesh = jmesh.make_mesh(**kw, devices=jax.devices()[:WORLD])
        assert dict(mesh.shape) == w


def test_zigzag_permutation_matches_jax():
    for S, n in ((32, 4), (24, 2), (8, 1)):
        for a, b in zip(jra.zigzag_permutation(S, n),
                        tra.zigzag_permutation(S, n)):
            np.testing.assert_array_equal(a, b)
