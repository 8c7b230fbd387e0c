"""The turnkey command of the port against the JAX package's, on the CPU:

    python -m streamvln_tpu_torch.eval_cli --model_path <weights_dir> \\
        --env_backend habitat --habitat_config_path config/vln_r2r.yaml \\
        --eval_split val_unseen --output_path <out> --device cpu

over the in-tree habitat stub (tests/habitat_stub.py: 4 episodes), as
tests/test_turnkey_eval.py runs the JAX one. The weights directory holds
what a published checkpoint holds: HF-named safetensors and the BPE
tokenizer fixture. Its tensors are the JAX package's `export_hf` of a
tiny seeded init, steered (with the BPE tokenizer's ids) so that episodes
walk instead of stopping at their first step. They are written
C-ordered through `safetensors.numpy`: the JAX `save_hf` hands that
function transposed (Fortran-order) views, which it writes in memory order
(ROADMAP §3), and the steered lm_head would not survive that.

Both commands must write the same result.json episode lines and take the
same actions, on a full run, a full resume (no model call) and a partial
one; the agent built with --bits 4 must hold the JAX package's int4
quantization of the loaded tree.
"""
import json
import os
import shutil
import sys

import jax
import numpy as np
import pytest
import torch

import habitat_stub

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "bpe_tokenizer")
ARROWS = (279, 280, 281)          # ←, ↑, → in the fixture's vocabulary
MODULES = ("streamvln_tpu_torch.habitat_extensions.measures",
           "streamvln_tpu_torch.habitat_extensions",
           "streamvln_tpu_torch.eval.habitat_backend",
           "streamvln_tpu.habitat_extensions.measures",
           "streamvln_tpu.habitat_extensions",
           "streamvln_tpu.eval.habitat_backend")


def _forget():
    for m in MODULES:
        sys.modules.pop(m, None)
        parent, _, child = m.rpartition(".")
        if parent in sys.modules and hasattr(sys.modules[parent], child):
            delattr(sys.modules[parent], child)


@pytest.fixture()
def actions(monkeypatch):
    """The stub installed; every action any stub env takes, in order."""
    mods, _ = habitat_stub.install()
    _forget()
    taken = []
    step0 = habitat_stub.StubEnv.step

    def step(self, action):
        taken.append((self.current_episode.episode_id, int(action)))
        return step0(self, action)
    monkeypatch.setattr(habitat_stub.StubEnv, "step", step)
    yield taken
    habitat_stub.uninstall(mods)
    _forget()


def steer_bpe(tree, tok, alpha=30.0):
    """lm_head[:, next] += alpha * w * e_cur / |e_cur|^2 along the chain
    newline -> ↑ -> {↑ (w 1), ←, → (w .9), <|im_end|> (w .95)}: the
    logit of `next` grows by alpha * w wherever the final hidden state
    still points along the current token's embedding."""
    llm = dict(tree["llm"])
    emb = np.asarray(llm["embed"], np.float64)
    head = np.array(llm["lm_head"], np.float64)
    chain = {tok.newline_id: ((280, 1.0),)}
    for a in ARROWS:
        chain[a] = ((280, 1.0), (279, 0.9), (281, 0.9),
                    (tok.im_end_id, 0.95))
    for cur, nxts in chain.items():
        d = emb[cur] / emb[cur].dot(emb[cur])
        for nxt, w in nxts:
            head[:, nxt] += alpha * w * d
    llm["lm_head"] = head.astype(np.float32)
    return dict(tree, llm=llm)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    from safetensors.numpy import save_file

    from streamvln_tpu.configs import tiny_streamvln
    from streamvln_tpu.data.tokenizer import load_tokenizer
    from streamvln_tpu.models import streamvln
    from streamvln_tpu.utils.checkpoint import export_hf

    cfg = tiny_streamvln()
    tree = jax.tree.map(np.asarray,
                        streamvln.init(jax.random.PRNGKey(0), cfg))
    tree = steer_bpe(tree, load_tokenizer(FIXTURE))
    ckpt = tmp_path_factory.mktemp("turnkey") / "weights"
    ckpt.mkdir()
    save_file({k: np.ascontiguousarray(v)
               for k, v in export_hf(tree, cfg).items()},
              str(ckpt / "model.safetensors"))
    for f in os.listdir(FIXTURE):
        shutil.copy(os.path.join(FIXTURE, f), ckpt / f)
    return str(ckpt)


def _argv(ckpt, out):
    return ["--model_path", ckpt, "--model_size", "tiny",
            "--num_frames", "8", "--num_future_steps", "2",
            "--num_history", "2", "--env_backend", "habitat",
            "--habitat_config_path", "config/vln_r2r.yaml",
            "--eval_split", "val_unseen", "--output_path", out,
            "--max_steps_per_episode", "12"]


def _episodes(out):
    with open(os.path.join(out, "result.json")) as f:
        recs = [json.loads(x) for x in f if x.strip()]
    return [r for r in recs if "episode_id" in r]


def _run(main, ckpt, out, actions, port):
    n = len(actions)
    final = main(_argv(ckpt, out) + (["--device", "cpu"] if port else []))
    return final, actions[n:]


def test_turnkey_command_matches_jax_and_resumes(actions, checkpoint,
                                                 tmp_path):
    from streamvln_tpu import eval_cli as jcli
    from streamvln_tpu_torch import eval_cli
    runs = {}
    for name, main, port in (("jax", jcli.main, False),
                             ("port", eval_cli.main, True)):
        out = str(tmp_path / name)
        final, acts = _run(main, checkpoint, out, actions, port)
        recs = _episodes(out)
        # resume: the same command again runs no episode
        final2, acts2 = _run(main, checkpoint, out, actions, port)
        assert acts2 == [] and _episodes(out) == recs
        for k in ("sucs_all", "spls_all", "oss_all", "ones_all", "length"):
            assert final2[k] == final[k], k
        runs[name] = final, acts, recs
    (jf, ja, jr), (pf, pa, pr) = runs["jax"], runs["port"]
    assert pr == jr                   # metric for metric
    assert pa == ja                   # action for action
    assert len(pr) == 4 and {r["episode_id"] for r in pr} == {"0", "1",
                                                              "2", "3"}
    for k in ("sucs_all", "spls_all", "oss_all", "ones_all", "length"):
        assert pf[k] == jf[k] and np.isfinite(pf[k]), k
    assert "model_call_p50_ms" in pf
    # the steered weights walk, across window resets (8 steps)
    assert {a for _, a in pa} >= {1}
    assert max(r["steps"] for r in pr) > 8


def test_turnkey_command_resumes_partial_as_jax(actions, checkpoint,
                                                tmp_path):
    """A result.json cut after two episodes (a killed run) resumes with
    the two missing ones, in both packages alike."""
    from streamvln_tpu import eval_cli as jcli
    from streamvln_tpu_torch import eval_cli
    got = {}
    for name, main, port in (("jax", jcli.main, False),
                             ("port", eval_cli.main, True)):
        out = str(tmp_path / name)
        _run(main, checkpoint, out, actions, port)
        path = os.path.join(out, "result.json")
        with open(path) as f:
            lines = [x for x in f.read().splitlines()
                     if x.strip() and "episode_id" in json.loads(x)]
        with open(path, "w") as f:
            f.write("\n".join(lines[:2]) + "\n")
        final, acts = _run(main, checkpoint, out, actions, port)
        recs = _episodes(out)
        assert len(recs) == 4 and final["length"] == 4
        assert [json.dumps(r) for r in recs[:2]] == lines[:2]
        assert {e for e, _ in acts} == {r["episode_id"] for r in recs[2:]}
        got[name] = recs, acts, final
    assert got["port"][0] == got["jax"][0]
    assert got["port"][1] == got["jax"][1]
    assert got["port"][2]["sucs_all"] == got["jax"][2]["sucs_all"]


def test_build_agent_bits4_holds_jax_quantization(checkpoint):
    from streamvln_tpu.configs import tiny_streamvln as jtiny
    from streamvln_tpu.models import convert_hf as jconvert
    from streamvln_tpu.models import quant as jquant
    from streamvln_tpu.models.fuse import fuse_projections
    from streamvln_tpu_torch import eval_cli
    from streamvln_tpu_torch.configs import tiny_streamvln
    from streamvln_tpu_torch.data.tokenizer import HFTokenizerAdapter
    from streamvln_tpu_torch.weights import from_jax_params

    agent = eval_cli.build_agent(checkpoint, "tiny", num_frames=8,
                                 num_future_steps=2, num_history=2, bits=4,
                                 device="cpu")
    assert isinstance(agent.tok, HFTokenizerAdapter)
    assert agent.engine.stop_ids == (agent.tok.im_end_id,)
    jt = jconvert.load_streamvln_checkpoint(checkpoint, jtiny(),
                                            jax.numpy.float32)
    jt = jax.tree.map(np.asarray,
                      fuse_projections(jquant.quantize_llm(jt, bits=4)))
    want = from_jax_params(jt, tiny_streamvln(), device="cpu")

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k], f"{prefix}/{k}")
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                yield from leaves(v, f"{prefix}/{i}")
        else:
            yield prefix, tree
    got, ref = dict(leaves(agent.engine.params)), dict(leaves(want))
    assert got.keys() == ref.keys()
    assert got["/llm/layers/qkv_w"].dtype == torch.uint8
    for k in ref:
        assert got[k].dtype == ref[k].dtype and torch.equal(got[k], ref[k]), k
