"""The port's evaluation entry point against the JAX package's, on the CPU:
episode metrics and FakeNavEnv observations bit for bit, VLNEvaluator and
BatchedVLNEvaluator result lines and aggregates exactly (tiny_streamvln in
float32, the JAX init's weights carried across, spec_lookup=6, random
conjunctions), resume and rank sharding, the RemoteEnv worker proxy,
save_video, the observability helpers, and `eval_cli.main` in its single,
batched and --bits 4 modes and its refusals.

Random weights emit no action glyph, so every episode would STOP at its
first step. `steer` adds a bigram chain to the lm_head (newline -> the
UTF-8 bytes of an arrow -> another arrow or <|im_end|>), so episodes walk
and turn for all 36 steps and cross their window resets and <memory>
calls; the layers' own (random) contribution decides between the chain's
branches.
"""
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamvln_tpu.agent import VLNAgent as JaxAgent
from streamvln_tpu.configs import tiny_streamvln as jax_tiny
from streamvln_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from streamvln_tpu.eval import fake_env as jfake
from streamvln_tpu.eval import metrics as jmetrics
from streamvln_tpu.eval.batched_evaluator import (
    BatchedVLNEvaluator as JaxBatchedEvaluator)
from streamvln_tpu.eval.evaluator import VLNEvaluator as JaxEvaluator
from streamvln_tpu.models import streamvln as jsv
from streamvln_tpu.streaming.engine import StreamingEngine as JaxEngine
from streamvln_tpu_torch import eval_cli
from streamvln_tpu_torch.agent import VLNAgent
from streamvln_tpu_torch.configs import tiny_streamvln
from streamvln_tpu_torch.data.tokenizer import ByteTokenizer
from streamvln_tpu_torch.eval import fake_env, metrics
from streamvln_tpu_torch.eval.batched_evaluator import BatchedVLNEvaluator
from streamvln_tpu_torch.eval.env_workers import (RemoteEnv,
                                                  resize_rgb_transform)
from streamvln_tpu_torch.eval.evaluator import VLNEvaluator
from streamvln_tpu_torch.streaming.engine import StreamingEngine
from streamvln_tpu_torch.utils import observability
from streamvln_tpu_torch.weights import from_jax_params

RGB = (48, 64, 3)
ARROWS = (0x90, 0x91, 0x92)          # last bytes of the UTF-8 arrows


def steer(tree, tok, alpha=10.0):
    """lm_head[:, next] += alpha * w * e_cur / |e_cur|^2 along the chain
    "\\n" -> e2 -> 86 -> {91 (w 1), 90, 92 (w .9)} -> {e2 (w 1), <|im_end|>
    (w .9)}, so the logit of `next` grows by alpha * w wherever the final
    hidden state still points along the current token's embedding."""
    llm = dict(tree["llm"])
    emb = np.asarray(llm["embed"], np.float64)
    head = np.array(llm["lm_head"], np.float64)
    chain = {10: ((0xE2, 1.0),), 0xE2: ((0x86, 1.0),),
             0x86: ((0x91, 1.0), (0x90, 0.9), (0x92, 0.9))}
    for a in ARROWS:
        chain[a] = ((0xE2, 1.0), (tok.im_end_id, 0.9))
    for cur, nxts in chain.items():
        d = emb[cur] / emb[cur].dot(emb[cur])
        for nxt, w in nxts:
            head[:, nxt] += alpha * w * d
    llm["lm_head"] = head.astype(np.float32)
    return dict(tree, llm=llm)


@pytest.fixture(scope="module")
def params():
    jp = jax.tree.map(np.asarray, jsv.init(jax.random.PRNGKey(0), jax_tiny()))
    jp = steer(jp, ByteTokenizer())
    return jp, from_jax_params(jp, tiny_streamvln(), device="cpu")


def _agents(params, n_envs=1, spec=6):
    jp, tp = params
    tok = ByteTokenizer()
    kw = dict(n_envs=n_envs, stop_ids=(tok.im_end_id, tok.eos_id),
              max_new_tokens=16, cache_capacity=4096, spec_lookup=spec)
    je = JaxEngine(jp, jax_tiny(), compute_dtype=jnp.float32, **kw)
    te = StreamingEngine(tp, tiny_streamvln(), compute_dtype=torch.float32,
                         device="cpu", **kw)
    return (JaxAgent(je, JaxByteTokenizer(), deterministic_conjunction=False),
            VLNAgent(te, tok, deterministic_conjunction=False))


def _lines(path):
    with open(os.path.join(path, "result.json")) as f:
        return [json.loads(x) for x in f]


# -- metrics and the fake env ------------------------------------------

def test_metrics_and_fake_env_match_jax():
    """EpisodeTracker metrics (nDTW, oracle and path terms) on random walks
    and FakeNavEnv observations and metrics over random action sequences,
    both renderings, bit-equal to the JAX package's."""
    rng = np.random.default_rng(0)
    for _ in range(4):
        goal = rng.uniform(-3, 3, 2)
        ref = np.linspace([0, 0], goal, 5)
        trackers = [m.EpisodeTracker(goal=goal, reference_path=ref)
                    for m in (jmetrics, metrics)]
        start = rng.uniform(-1, 1, 2)
        steps = rng.normal(0, 0.5, (12, 2)).cumsum(0) + start
        for t in trackers:
            t.reset(start)
            for i, p in enumerate(steps):
                t.update(p, stop_called=i == len(steps) - 1)
        assert trackers[0].metrics() == trackers[1].metrics()
        assert jmetrics.ndtw(steps, ref) == metrics.ndtw(steps, ref)
    for goal_obs in (False, True):
        eps = [fake_env.make_episodes(3, seed=4), jfake.make_episodes(3,
                                                                      seed=4)]
        envs = [fake_env.FakeNavEnv(eps[0], rgb_shape=RGB,
                                    observable_goal=goal_obs),
                jfake.FakeNavEnv(eps[1], rgb_shape=RGB,
                                 observable_goal=goal_obs)]
        for k in range(3):
            obs = []
            for env, e in zip(envs, eps):
                env.current_episode = e[k]
                obs.append([env.reset()])
            for a in list(rng.integers(1, 4, 20)) + [0]:
                for env, o in zip(envs, obs):
                    o.append(env.step(int(a)))
            for a, b in zip(*obs):
                assert a.keys() == b.keys()
                for key in a:
                    np.testing.assert_array_equal(a[key], b[key])
            assert envs[0].get_metrics() == envs[1].get_metrics()


# -- evaluators against JAX ------------------------------------------------

def test_evaluator_matches_jax(params, tmp_path):
    """3 episodes of 36 steps (window resets and <memory> calls at 8, 16,
    ...): every result.json episode line and the aggregate's SR / SPL / OS
    / NE / nDTW equal the JAX evaluator's; the latency fields are timings
    and are only checked to be there."""
    ja, ta = _agents(params)
    out = {}
    for name, agent, ev_cls, fake in (("jax", ja, JaxEvaluator, jfake),
                                      ("port", ta, VLNEvaluator, fake_env)):
        env = fake.FakeNavEnv(fake.make_episodes(3, seed=0), rgb_shape=RGB)
        ev = ev_cls(env, agent, str(tmp_path / name),
                    max_steps_per_episode=36)
        out[name] = ev.aggregate([ev.eval_action()])
    jl, tl = _lines(tmp_path / "jax"), _lines(tmp_path / "port")
    assert len(tl) == 4
    assert tl[:3] == jl[:3]
    assert all(r["steps"] == 36 for r in tl[:3])
    keys = ("sucs_all", "spls_all", "oss_all", "ones_all", "ndtw_all",
            "length")
    assert {k: out["port"][k] for k in keys} == \
        {k: out["jax"][k] for k in keys}
    assert {k: tl[3][k] for k in keys} == {k: out["port"][k] for k in keys}
    assert tl[3]["model_call_p50_ms"] > 0 and "model_call_p90_ms" in tl[3]
    te, je = ta.engine, ja.engine
    assert (te.decode_tokens, te.decode_forwards) == \
        (je.decode_tokens, je.decode_forwards)
    assert te.decode_tokens > te.decode_forwards


def test_batched_evaluator_matches_jax(params, tmp_path):
    """BatchedVLNEvaluator at n_envs=2, envs in-process, 3 episodes pulled
    from the shared queue: the same result lines in the same order as the
    JAX package's batched evaluator."""
    ja, ta = _agents(params, n_envs=2)
    lines = {}
    for name, agent, ev_cls, fake in (
            ("jax", ja, JaxBatchedEvaluator, jfake),
            ("port", ta, BatchedVLNEvaluator, fake_env)):
        ev = ev_cls(functools.partial(fake.FakeNavEnv, [], rgb_shape=RGB),
                    agent, str(tmp_path / name), max_steps_per_episode=12)
        results = ev.run(fake.make_episodes(3, seed=1))
        ev.close()
        assert _lines(tmp_path / name) == results
        lines[name] = results
    assert len(lines["port"]) == 3
    assert lines["port"] == lines["jax"]
    assert any(r["steps"] == 12 for r in lines["port"])


# -- evaluator features ------------------------------------------------------

def _tiny_agent(params, spec=0, max_new=4):
    tok = ByteTokenizer()
    eng = StreamingEngine(params[1], tiny_streamvln(),
                          stop_ids=(tok.im_end_id,),
                          compute_dtype=torch.float32, max_new_tokens=max_new,
                          cache_capacity=2048, spec_lookup=spec,
                          buckets=(256, 512, 768, 1024), device="cpu")
    return VLNAgent(eng, tok)


def test_resume_and_rank_sharding(params, tmp_path):
    agent = _tiny_agent(params)
    env = fake_env.FakeNavEnv(fake_env.make_episodes(4, seed=0),
                              rgb_shape=RGB)
    ev = VLNEvaluator(env, agent, str(tmp_path / "a"),
                      max_steps_per_episode=6)
    partial = ev.eval_action()
    final = ev.aggregate([partial])
    assert len(partial["sucs"]) == final["length"] == 4
    assert "ndtw_all" in final and "model_call_p50_ms" in final
    assert len(_lines(tmp_path / "a")) == 5       # 4 episodes + aggregate
    # resume: every episode is on file, nothing runs again
    ev2 = VLNEvaluator(env, agent, str(tmp_path / "a"),
                       max_steps_per_episode=6)
    partial2 = ev2.eval_action()
    assert partial2["sucs"] == partial["sucs"]
    assert ev2.latency.summary("model_call") == {}
    # rank sharding: each rank takes its slice of every scene's episodes
    env = fake_env.FakeNavEnv(fake_env.make_episodes(5, seed=1, scenes=1),
                              rgb_shape=RGB)
    ids = []
    for rank in range(2):
        p = VLNEvaluator(env, agent, str(tmp_path / f"r{rank}"), rank=rank,
                         world_size=2, max_steps_per_episode=4).eval_action()
        ids.append([r["episode_id"] for r in _lines(tmp_path / f"r{rank}")])
        assert len(p["sucs"]) == len(ids[-1])
    assert ids == [["0", "2", "4"], ["1", "3"]]


def test_save_video_writes_the_episode_and_its_map(params, tmp_path):
    agent = _tiny_agent(params)
    env = fake_env.FakeNavEnv(fake_env.make_episodes(1, seed=0),
                              max_episode_steps=4, rgb_shape=RGB)
    VLNEvaluator(env, agent, str(tmp_path), save_video=True,
                 max_steps_per_episode=4).eval_action()
    vis = os.listdir(tmp_path / "vis_0")
    assert any(f.endswith((".gif", ".mp4")) for f in vis)
    assert any(f.endswith("_map.png") for f in vis)


def test_remote_env_proxy_matches_local():
    """RemoteEnv (a spawned worker process) against a local env: the same
    observations through the blocking and the asynchronous protocol, the
    same metrics; the worker-side resize gives the PIL bicubic frame."""
    factory = functools.partial(fake_env.FakeNavEnv, [], rgb_shape=RGB)
    episodes = fake_env.make_episodes(2, seed=3)
    local = factory()
    remote = RemoteEnv(factory, obs_transform=resize_rgb_transform(32))
    try:
        for env in (local, remote):
            env.current_episode = episodes[0]
        resize = resize_rgb_transform(32)
        o_l, o_r = resize(local.reset()), remote.reset()
        assert o_r["rgb"].shape == (32, 32, 3)
        np.testing.assert_array_equal(o_l["rgb"], o_r["rgb"])
        o_l, o_r = resize(local.step(1)), remote.step(1)
        np.testing.assert_array_equal(o_l["rgb"], o_r["rgb"])
        assert local.episode_over == remote.episode_over
        remote.step_async(2)
        o_r = remote.step_wait()
        np.testing.assert_array_equal(resize(local.step(2))["rgb"],
                                      o_r["rgb"])
        assert local.get_metrics() == remote.get_metrics()
        assert remote.current_episode.episode_id == "0"
    finally:
        remote.close()
    assert not remote._proc.is_alive()


# -- observability -----------------------------------------------------------

def _meter_worker(rank, port, out):
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=2, rank=rank)
    try:
        m = observability.AverageMeter()
        m.update(float(rank + 1), n=rank + 1)         # 1*1, then 2*2
        m.all_reduce()
        out.put((rank, m.sum, m.count))
    finally:
        dist.destroy_process_group()


def test_observability_trace_and_meters(tmp_path):
    """trace() writes a torch.profiler trace into log_dir; an AverageMeter
    sums across a 2-process gloo group and is untouched without one; the
    latency tracker's percentiles; the JSONL logger."""
    with observability.trace(str(tmp_path / "trace")):
        torch.ones(8).sum()
    assert any(f.endswith(".json") for f in os.listdir(tmp_path / "trace"))
    m = observability.AverageMeter()
    m.update(3.0, n=2)
    assert m.all_reduce().avg == 3.0 and m.count == 2
    import socket
    import torch.multiprocessing as tmp
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = tmp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_meter_worker, args=(r, port, q))
             for r in range(2)]
    for p in procs:
        p.start()
    got = sorted(q.get(timeout=120) for _ in procs)
    for p in procs:
        p.join(timeout=60)
        assert not p.is_alive() and p.exitcode == 0
    assert got == [(0, 5.0, 3), (1, 5.0, 3)]
    lt = observability.LatencyTracker()
    for ms in (10, 20, 30):
        lt.record("call", ms / 1e3)
    s = lt.summary("call")
    assert s["count"] == 3 and abs(s["p50_ms"] - 20.0) < 1e-9
    log = observability.MetricsLogger(str(tmp_path / "log"))
    log.log({"loss": 1.5}, step=3)
    with open(tmp_path / "log" / "metrics.jsonl") as f:
        rec = json.loads(f.read())
    assert rec["loss"] == 1.5 and rec["step"] == 3


# -- eval_cli ---------------------------------------------------------------

@pytest.mark.parametrize("extra,mode", [
    ([], "single"), (["--n_envs", "2"], "batched"),
    (["--bits", "4"], "bits4")])
def test_eval_cli_main_on_the_cpu(tmp_path, extra, mode):
    """eval_cli.main with --model_size tiny --device cpu: one env, two envs
    in worker processes (the default for --n_envs > 1) and int4 weights.
    Random weights STOP at the first step, so each episode is one call."""
    out = tmp_path / mode
    final = eval_cli.main([
        "--model_size", "tiny", "--device", "cpu", "--env_backend", "fake",
        "--num_episodes", "2", "--max_steps_per_episode", "6",
        "--output_path", str(out)] + extra)
    assert final["length"] == 2
    lines = _lines(out)
    assert len(lines) == (2 if mode == "batched" else 3)
    assert sorted(r["episode_id"] for r in lines[:2]) == ["0", "1"]


def test_eval_cli_builds_the_requested_agent():
    agent = eval_cli.build_agent(None, "tiny", n_envs=1, bits=4,
                                 spec_lookup=3, device="cpu")
    eng = agent.engine
    assert eng.spec_lookup == 3 and eng.ids_buf is not None
    assert eng.params["llm"]["layers"]["qkv_w"].dtype == torch.uint8
    assert eng.compute_dtype == torch.float32
    assert set(eng.stop_ids) == {agent.tok.im_end_id, agent.tok.eos_id}
    assert agent.rng is not None            # random conjunctions


@pytest.mark.parametrize("flags,error,match", [
    # served since the quantized tail was ported (ROADMAP item 5): the run
    # goes through and builds what the flag asks for
    pytest.param(["--kv_int8"], None, "kv_int8", id="flags0-item 5"),
    pytest.param(["--vision_int8"], None, "vision_int8",
                 id="flags1-item 5"),
    # without habitat-sim the habitat backend exits, as the reference's does
    pytest.param(["--env_backend", "habitat"], SystemExit,
                 "habitat backend requested but unavailable",
                 id="flags2-item 3"),
    # a shard that cannot be read raises: no random weights in its place
    pytest.param(["--model_path", "CKPT"], ValueError,
                 "not a safetensors file", id="flags3-item 6"),
    # the registry is served (item 10): a name outside it raises the
    # reference's ValueError (its names take a hyphen: "llama2-7b")
    pytest.param(["--model_size", "llama2_7b"], ValueError,
                 "unknown LLM 'llama2_7b'", id="flags4-item 10")])
def test_eval_cli_refuses_what_the_port_lacks(tmp_path, monkeypatch, flags,
                                              error, match):
    """What the port still lacks raises; --kv_int8 and --vision_int8 (its
    first two cases, which raised before the quantized tail) now run to
    the end, with an int8 KV cache or an int8 tower built; an unknown
    --model_size raises as in the reference."""
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    (ckpt / "model.safetensors").write_bytes(b"")
    flags = [str(ckpt) if f == "CKPT" else f for f in flags]
    argv = ["--device", "cpu", "--model_size", "tiny", "--output_path",
            str(tmp_path / "out")] + flags
    if error is not None:
        with pytest.raises(error, match=match):
            eval_cli.main(argv)
        return
    built = []
    build = eval_cli.build_agent
    monkeypatch.setattr(eval_cli, "build_agent",
                        lambda *a, **k: built.append(build(*a, **k))
                        or built[-1])
    final = eval_cli.main(argv + ["--num_episodes", "1",
                                  "--max_steps_per_episode", "2"])
    assert final["length"] == 1 and len(built) == 1
    eng = built[0].engine
    layers = eng.params["vision"]["layers"]
    assert eng.cache.quantized == (match == "kv_int8")
    assert (layers["fc1_w"].dtype == torch.int8) == (match == "vision_int8")
    assert ("fc1_w_scale" in layers) == (match == "vision_int8")


# tiny variants of the families (their knobs on tiny_llm's widths)
TINY_FAMILIES = {
    "gemma": dict(qkv_bias=False, tie_word_embeddings=True,
                  mlp_act="gelu_tanh", norm_offset=True,
                  scale_embeddings=True),
    "mpt": dict(qkv_bias=False, tie_word_embeddings=True, mlp_act="gelu",
                positional="alibi", norm_type="layernorm", mlp_gated=False,
                num_kv_heads=4),
    "mixtral": dict(qkv_bias=False, num_experts=4, num_experts_per_tok=2)}


@pytest.mark.parametrize("family", sorted(TINY_FAMILIES))
def test_eval_cli_serves_a_tiny_family(tmp_path, monkeypatch, family):
    """eval_cli.main --model_size tiny with the tiny decoder swapped for a
    family's (the registry's full-width presets take the same path):
    the episodes run to the end on the CPU and the engine holds that
    family's leaves."""
    import dataclasses

    from streamvln_tpu_torch import configs as tcfgs
    tiny = tcfgs.tiny_llm
    monkeypatch.setattr(tcfgs, "tiny_llm", lambda vocab_size=512:
                        dataclasses.replace(tiny(vocab_size),
                                            **TINY_FAMILIES[family]))
    built = []
    build = eval_cli.build_agent
    monkeypatch.setattr(eval_cli, "build_agent",
                        lambda *a, **k: built.append(build(*a, **k))
                        or built[-1])
    final = eval_cli.main([
        "--model_size", "tiny", "--device", "cpu", "--env_backend", "fake",
        "--num_episodes", "1", "--max_steps_per_episode", "4",
        "--output_path", str(tmp_path / family)])
    assert final["length"] == 1
    layers = built[0].engine.params["llm"]["layers"]
    assert ("e_gate" in layers) == (family == "mixtral")
    assert ("gate_w" in layers or "gu_w" in layers) == (family == "gemma")
