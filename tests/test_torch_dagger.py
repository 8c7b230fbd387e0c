"""The port's trajectory generation (trajectory_generation.py), expert
(eval/shortest_path.py) and DAgger collector (dagger.py) against the JAX
package's on the CPU: the four subjects of tests/test_dagger_trajgen.py
and the two of tests/test_closed_loop_dagger.py, each port run against the
JAX run on the same episodes and seed, episode for episode and action for
action (annotations equal, frames byte-equal), the habitat backend through
`build_env` under the in-tree stub, and the two CLIs.

Both collectors draw the expert schedule (beta = p ** data_iteration)
from Python's `random` with the same seed, so they make the same
expert/model choices. The model-driven comparisons run agents over one
tiny tree (the JAX init carried across), with the reference fault of
ROADMAP §3 item 9 repaired on the JAX agent instance
(`test_torch_aux.repair_memory_clause`): a rollout the expert begins
reaches its first model call with no history frames.
"""
import dataclasses
import filecmp
import json
import os
import sys

import numpy as np
import pytest

from streamvln_tpu import dagger as jdagger
from streamvln_tpu import trajectory_generation as jtg
from streamvln_tpu.eval import fake_env as jfake
from streamvln_tpu.eval.shortest_path import \
    PlaneShortestPathFollower as JaxFollower
from streamvln_tpu_torch import dagger
from streamvln_tpu_torch import trajectory_generation as tg
from streamvln_tpu_torch.eval.fake_env import (FakeEpisode, FakeNavEnv,
                                               make_episodes)
from streamvln_tpu_torch.eval.shortest_path import PlaneShortestPathFollower

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "scripts"))


def _both_envs(n, seed, **kw):
    """The port's and the JAX package's fake env over the same episodes."""
    return (FakeNavEnv(make_episodes(n, seed=seed), **kw),
            jfake.FakeNavEnv(jfake.make_episodes(n, seed=seed), **kw))


def _same_tree(a, b, names):
    """The annotations of two output dirs equal, and their frames
    byte-equal."""
    assert names
    for e in names:
        ra, rb = (os.path.join(d, e["video"], "rgb") for d in (a, b))
        files = sorted(os.listdir(ra))
        assert files == sorted(os.listdir(rb))
        _, mismatch, errors = filecmp.cmpfiles(ra, rb, files, shallow=False)
        assert not mismatch and not errors


def test_follower_reaches_goal():
    for seed in (3, 4):
        ep = make_episodes(1, seed=seed)[0]
        jep = jfake.make_episodes(1, seed=seed)[0]
        env, jenv = FakeNavEnv([ep]), jfake.FakeNavEnv([jep])
        env.current_episode, jenv.current_episode = ep, jep
        env.reset()
        jenv.reset()
        f = PlaneShortestPathFollower(env, goal_radius=0.25)
        jf = JaxFollower(jenv, goal_radius=0.25)
        acts = []
        for _ in range(300):
            a = f.get_next_action(ep.goal_position)
            assert a == jf.get_next_action(jep.goal_position)
            acts.append(a)
            if a == 0:
                break
            env.step(a)
            jenv.step(a)
        assert a == 0 and len(acts) > 3
        assert env._tracker.distance_to_goal < 0.25
        np.testing.assert_array_equal(env._pose, jenv._pose)


def test_trajectory_generation_roundtrip(tmp_path):
    """Generated trajectories equal the JAX generator's and load back
    through the port's VLNActionDataset."""
    from streamvln_tpu_torch.configs import tiny_streamvln
    from streamvln_tpu_torch.data.tokenizer import ByteTokenizer
    from streamvln_tpu_torch.data.vln_dataset import VLNActionDataset

    out, jout = str(tmp_path / "gen"), str(tmp_path / "jgen")
    env, jenv = _both_envs(4, 0, rgb_shape=(48, 64, 3))
    for rank in (0, 1):
        tg.run(env, out, dataset="fake", rank=rank, world_size=2)
        jtg.run(jenv, jout, dataset="fake", rank=rank, world_size=2)
    merged = tg.merge(out, world_size=2)
    assert merged == jtg.merge(jout, world_size=2)
    assert len(merged) == 4
    for e in merged:
        assert e["actions"][0] == -1   # leading placeholder
        assert 0 not in e["actions"]   # episode ends by waypoint
        n_frames = len(os.listdir(os.path.join(out, e["video"], "rgb")))
        assert n_frames == len(e["actions"])
    _same_tree(out, jout, merged)
    ds = VLNActionDataset(ByteTokenizer(), tiny_streamvln(), [out])
    assert len(ds) > 0 and len(ds[0]["images"]) >= 1


def test_trajectory_generation_cli(tmp_path, capsys):
    out, jout = str(tmp_path / "cli"), str(tmp_path / "jcli")
    args = ["--num_episodes", "2", "--env_backend", "fake", "--rgb_height",
            "48", "--rgb_width", "64", "--seed", "5", "--observable_goal"]
    tg.main(["--output_path", out] + args)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == \
        {"episodes": 2}
    jtg.main(["--output_path", jout] + args)
    anns = json.load(open(os.path.join(out, "annotations.json")))
    assert anns == json.load(open(os.path.join(jout, "annotations.json")))
    _same_tree(out, jout, anns)


@pytest.fixture(scope="module")
def agents():
    from test_torch_aux import make_agents
    return make_agents()


def test_dagger_pure_expert_reaches_goal_but_not_saved(agents, tmp_path):
    """beta = 1 (pure expert): rollouts reach the goal, but the save gate
    keeps only detour/recovery episodes (pl below the relative path
    length thresholds; reference: streamvln_dagger.py:405), so near-optimal
    expert paths (pl ~ 1.0) are rejected, in both packages."""
    jagent, agent = agents
    env, jenv = _both_envs(2, 1, rgb_shape=(48, 64, 3))
    kw = dict(p=1.0, data_iteration=0, num_future_steps=2, max_steps=300)
    col = dagger.DAggerCollector(agent, str(tmp_path / "d"), **kw)
    jcol = jdagger.DAggerCollector(jagent, str(tmp_path / "j"), **kw)
    for ep, jep in zip(env.episodes, jenv.episodes):
        assert col.collect_episode(env, ep) is None
        assert env._tracker.distance_to_goal < 0.5   # the expert arrived
        assert jcol.collect_episode(jenv, jep) is None
        np.testing.assert_array_equal(env._pose, jenv._pose)
    assert [d["saved"] for d in col.decisions] == [False, False]
    assert all(d["distance_to_goal"] < 0.5 for d in col.decisions)


class _WanderingAgent:
    """Scripted stand-in emitting wrong moves, so the expert takeover and
    the detour save are exercised deterministically."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.in_dialogue = [False]
        self.time_ids = [[]]
        self.calls = 0

        class _E:
            def reset_for_env(self, i):
                pass
        self.engine = _E()

    def reset_memory(self, idx):
        pass

    def step(self, idx, rgb, instruction, run_model=False):
        if not run_model:
            return None, 0.0, None
        self.calls += 1
        # turn, then stride off course: real path length for the pl gate
        return [2, 1, 1, 1], 0.0, "←↑↑↑"


def test_dagger_model_recovery_saved(tmp_path):
    """beta = 0 with a wandering model: the expert takeover recovers the
    episode and the detour is saved, the same episodes and actions as the
    JAX collector's."""
    from streamvln_tpu_torch.configs import tiny_streamvln

    out, jout = str(tmp_path / "dagger0"), str(tmp_path / "jdagger0")
    env, jenv = _both_envs(3, 2, rgb_shape=(48, 64, 3))
    kw = dict(p=0.0, data_iteration=1, num_future_steps=2, max_steps=250)
    wander = _WanderingAgent(tiny_streamvln())
    col = dagger.DAggerCollector(wander, out, **kw)
    col.update_dataset(env)
    jdagger.DAggerCollector(_WanderingAgent(tiny_streamvln()), jout,
                            **kw).update_dataset(jenv)
    merged = dagger.merge_annotations(out, 1)
    assert merged == jdagger.merge_annotations(jout, 1)
    assert len(merged) >= 1 and wander.calls > 0
    for e in merged:
        assert e["actions"][0] == -1
        n_frames = len(os.listdir(os.path.join(out, e["video"], "rgb")))
        assert n_frames == len(e["actions"])
    _same_tree(out, jout, merged)
    assert sum(d["saved"] for d in col.decisions) == len(merged)


def _closed_loop(agent, collector_cls, out, episodes, env_cls, seed,
                 max_steps=90):
    """scripts/closed_loop_dagger.py::collect_dagger's collection with the
    given agent: bent (or straight) episodes on the observable-goal env,
    p 0.75 at data_iteration 1."""
    env = env_cls(episodes, max_episode_steps=max_steps,
                  rgb_shape=(48, 64, 3), observable_goal=True)
    col = collector_cls(agent, out, p=0.75, data_iteration=1,
                        num_future_steps=agent.cfg.num_future_steps,
                        seed=seed, max_steps=max_steps)
    col.update_dataset(env)
    return col


def _episode_pair(make, n, seed):
    jeps = make(n, seed=seed)
    return [FakeEpisode(**dataclasses.asdict(e)) for e in jeps], jeps


@pytest.fixture(scope="module")
def closed_loop_agents():
    """Agents over the tree of test_closed_loop_dagger.py's fixture
    (streamvln.init at PRNGKey(1)), engines as collect_dagger builds
    them."""
    from test_torch_aux import make_agents
    return make_agents(1, max_new_tokens=10, cache_capacity=4096,
                       feat_slots=80, buckets=(256, 512, 768, 1024))


def test_collection_encoding_and_gate(closed_loop_agents, tmp_path):
    """A random (wandering) learner on bent far-goal episodes: the
    expert-corrected rollouts pass the save gate, the annotations are the
    JAX collector's action for action, and they train through the port's
    VLNActionDataset (leading -1 action, 1-based jpgs, frame count ==
    action count)."""
    import closed_loop_dagger as cld

    from streamvln_tpu_torch.configs import tiny_streamvln
    from streamvln_tpu_torch.data.tokenizer import ByteTokenizer
    from streamvln_tpu_torch.data.vln_dataset import VLNActionDataset

    jagent, agent = closed_loop_agents
    eps, jeps = _episode_pair(cld.bent_episodes, 3, 9)
    out, jout = str(tmp_path / "dagger"), str(tmp_path / "jdagger")
    col = _closed_loop(agent, dagger.DAggerCollector, out, eps, FakeNavEnv,
                       seed=9)
    _closed_loop(jagent, jdagger.DAggerCollector, jout, jeps,
                 jfake.FakeNavEnv, seed=9)
    anns = dagger.merge_annotations(out, 1)
    assert anns == jdagger.merge_annotations(jout, 1)
    assert len(col.decisions) == 3
    assert 1 <= len(anns) == sum(d["saved"] for d in col.decisions)
    for a in anns:
        assert a["actions"][0] == -1
        jpgs = sorted(os.listdir(os.path.join(out, a["video"], "rgb")))
        assert jpgs[0] == "001.jpg" and len(jpgs) == len(a["actions"])
        assert a["actions"][-1] in (0, 1, 2, 3)
    _same_tree(out, jout, anns)
    s = VLNActionDataset(ByteTokenizer(), tiny_streamvln(), [out])[0]
    assert (s["labels"] != -100).sum() > 0


def test_gate_rejects_near_optimal_paths(closed_loop_agents, tmp_path):
    """On straight paths even a wandering learner's rollouts stay at
    pl ~ 1 (turning adds steps, not meters), so the gate rejects them in
    both packages (streamvln_dagger.py:52-55, 405)."""
    from closed_loop_validation import far_episodes

    jagent, agent = closed_loop_agents
    eps, jeps = _episode_pair(far_episodes, 2, 11)
    col = _closed_loop(agent, dagger.DAggerCollector,
                       str(tmp_path / "d0"), eps, FakeNavEnv, seed=11)
    jcol = _closed_loop(jagent, jdagger.DAggerCollector,
                        str(tmp_path / "j0"), jeps, jfake.FakeNavEnv,
                        seed=11)
    assert dagger.merge_annotations(str(tmp_path / "d0"), 1) == []
    assert jdagger.merge_annotations(str(tmp_path / "j0"), 1) == []
    assert [d["saved"] for d in col.decisions] == [False, False]
    assert len(col.decisions) == 2 and jcol.rng.random() == col.rng.random()
    assert (dagger.MIDGOAL_RADIUS, dagger.GOAL_RADIUS,
            dagger.RELATIVE_PATH_LENGTH_THRESHOLD,
            dagger.SUCCESS_RELATIVE_PATH_LENGTH_THRESHOLD) == \
        (jdagger.MIDGOAL_RADIUS, jdagger.GOAL_RADIUS,
         jdagger.RELATIVE_PATH_LENGTH_THRESHOLD,
         jdagger.SUCCESS_RELATIVE_PATH_LENGTH_THRESHOLD) == \
        (0.5, 0.25, 0.93, 0.85)


def test_dagger_cli_and_habitat_backend(tmp_path, capsys):
    """dagger.main on the CPU (its own random tiny weights, the fake env),
    and build_env: "habitat" takes the port's habitat backend (the in-tree
    stub here), with its geodesic follower, as the reference's does;
    "auto" falls back to the fake env where habitat does not import."""
    import habitat_stub

    col = dagger.main(["--output_path", str(tmp_path / "cli"),
                       "--model_size", "tiny", "--device", "cpu",
                       "--num_episodes", "2", "--env_backend", "fake",
                       "--dagger_data_it", "1", "--num_future_steps", "2"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == {"collected": sum(d["saved"] for d in col.decisions)}
    assert len(col.decisions) == 2
    assert os.path.exists(tmp_path / "cli" / "annotations.json")
    assert col.agent.engine.device.type == "cpu"

    assert isinstance(dagger.build_env("auto", "config/vln_dagger.yaml",
                                       "train", 2, 0), FakeNavEnv)
    mods, _ = habitat_stub.install()
    names = [m for m in sys.modules if m.startswith((
        "streamvln_tpu_torch.eval.habitat_backend",
        "streamvln_tpu_torch.habitat_extensions",
        "streamvln_tpu.eval.habitat_backend",
        "streamvln_tpu.habitat_extensions"))]
    for m in names:
        sys.modules.pop(m)
    try:
        env = dagger.build_env("habitat", "config/vln_r2r.yaml", "train",
                               2, 0)
        jenv = jdagger.build_env("habitat", "config/vln_r2r.yaml", "train",
                                 2, 0)
        assert type(env).__name__ == "HabitatEnvAdapter"
        assert type(env).__module__.startswith("streamvln_tpu_torch.")
        out, jout = str(tmp_path / "hab"), str(tmp_path / "jhab")
        tg.run(env, out, dataset="r2r")
        jtg.run(jenv, jout, dataset="r2r")
        anns = tg.merge(out, 1)
        assert anns and anns == jtg.merge(jout, 1)
        assert type(env.make_follower(0.5)).__name__ == "HabitatFollower"
    finally:
        habitat_stub.uninstall(mods)
        for m in list(sys.modules):
            if m.startswith(tuple(names)):
                sys.modules.pop(m)
