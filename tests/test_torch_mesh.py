"""The port's sharding rules (`parallel/mesh.py`) against the JAX
package's, leaf for leaf: `param_specs` on the tiny, tiny-MoE (with and
without a shared expert), int8, int4, fused and LoRA trees at mesh
shapes (2, 4, 1), (1, 8, 1), (1, 4, 2) and (2, 2, 2) of the 8 virtual
CPU devices; and `make_mesh`'s refusal of a mesh larger than the world.
The rules are a pure function of (path, shape, mesh shape), so no
process group is needed; meshes on real groups are built in
test_torch_ring_attention.py and test_torch_mesh_train.py.
"""
import dataclasses

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from streamvln_tpu import configs as jcfg
from streamvln_tpu.models import fuse as jfuse
from streamvln_tpu.models import lora as jlora
from streamvln_tpu.models import quant as jquant
from streamvln_tpu.models import streamvln as jsv
from streamvln_tpu.parallel import mesh as jmesh
from streamvln_tpu_torch.parallel import mesh as tmesh

SHAPES = [(2, 4, 1), (1, 8, 1), (1, 4, 2), (2, 2, 2)]


def _llm(**kw):
    c = jcfg.tiny_streamvln()
    return dataclasses.replace(c, llm=dataclasses.replace(c.llm, **kw))


@pytest.fixture(scope="module")
def trees():
    key = jax.random.PRNGKey(0)
    tiny = jsv.init(key, jcfg.tiny_streamvln())
    moe = jsv.init(key, _llm(num_experts=4, num_experts_per_tok=2,
                             qkv_bias=False))
    moe_shared = jsv.init(key, _llm(num_experts=4, num_experts_per_tok=2,
                                    moe_intermediate_size=48,
                                    shared_expert_intermediate_size=64))
    out = {"tiny": tiny, "moe": moe, "moe_shared": moe_shared,
           "int8": jquant.quantize_llm(tiny, bits=8),
           "int4": jquant.quantize_llm(tiny, bits=4),
           "fused": jfuse.fuse_projections(tiny),
           "lora": jlora.add_lora(tiny, jax.random.PRNGKey(1),
                                  jcfg.tiny_streamvln().llm, rank=4)}
    return {k: jax.tree.map(np.asarray, v) for k, v in out.items()}


def _jax_specs(tree, shape):
    mesh = jmesh.make_mesh(*shape, devices=jax.devices()[:8])
    specs = jmesh.param_specs(tree, mesh)
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))[0]
    return {jmesh._path_str(p): tuple(s) for p, s in flat}


def _port_specs(tree, shape):
    specs = tmesh.param_specs(tree, dict(zip(tmesh.AXES, shape)))
    out = {}
    _collect(specs, "", out)
    return out


def _collect(tree, prefix, out):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _collect(v, f"{prefix}/{k}" if prefix else k, out)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            _collect(v, f"{prefix}/{i}" if prefix else str(i), out)
    else:
        out[prefix] = tree


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", ["tiny", "moe", "moe_shared", "int8",
                                  "int4", "fused", "lora"])
def test_param_specs_match_jax(trees, name, shape):
    want = _jax_specs(trees[name], shape)
    got = _port_specs(trees[name], shape)
    assert got == want
    # the rules do shard something on every mesh with a data axis > 1
    assert any(any(a is not None for a in s) for s in got.values())


def test_batch_spec_and_placements():
    assert tmesh.batch_spec() == tuple(jmesh.batch_spec())
    from torch.distributed.tensor import Replicate, Shard
    assert tmesh.placements((None, "fsdp", "tp")) == \
        [Replicate(), Shard(1), Shard(2)]
    assert tmesh.placements(()) == [Replicate()] * 3


@pytest.mark.parametrize("kw,match", [
    (dict(fsdp=2), "needs more than the world size 1"),
    (dict(dp=2, fsdp=1), "needs more than the world size 1"),
    (dict(tp=2, fsdp=None), "not a multiple of dp\\*tp = 2"),
])
def test_make_mesh_refuses_more_ranks_than_the_world(kw, match):
    """Without a process group the world is one rank: a bigger mesh is
    refused, as JAX's make_mesh asserts `need <= n`."""
    with pytest.raises((RuntimeError, ValueError), match=match):
        tmesh.make_mesh(**kw)
    with pytest.raises(AssertionError):
        jmesh.make_mesh(**kw, devices=jax.devices()[:1])
