"""The port's habitat tail against the JAX package's, under the in-tree
habitat stub (tests/habitat_stub.py, as tests/test_habitat_extensions.py
runs it): the measures register and compute the JAX measures' values,
NDTW equals the port's `metrics.ndtw`, the env adapter and the follower
behave as the reference's, the occupancy-grid maps (`colorize_top_down_map`,
`static_to_grid`, `render_episode_map`) are array-equal to JAX's, and the
evaluator draws the navmesh map with save_video."""
import importlib
import os
import sys

import numpy as np
import pytest

import habitat_stub

PORT = ("streamvln_tpu_torch.habitat_extensions.measures",
        "streamvln_tpu_torch.habitat_extensions.maps",
        "streamvln_tpu_torch.habitat_extensions",
        "streamvln_tpu_torch.eval.habitat_backend")
JAX = ("streamvln_tpu.habitat_extensions.measures",
       "streamvln_tpu.habitat_extensions",
       "streamvln_tpu.eval.habitat_backend")
MEASURES = ("PathLength", "OracleNavigationError", "OracleSuccess",
            "OracleSPL", "PL", "StepsTaken", "NDTW")


def _forget(names):
    for m in names:
        sys.modules.pop(m, None)
        parent, _, child = m.rpartition(".")
        if parent in sys.modules and hasattr(sys.modules[parent], child):
            delattr(sys.modules[parent], child)


@pytest.fixture()
def registry():
    """The stub installed, and both packages' habitat modules imported
    anew (they cache habitat's classes and their registration)."""
    mods, registry = habitat_stub.install()
    _forget(PORT + JAX)
    yield registry
    habitat_stub.uninstall(mods)
    _forget(PORT + JAX)


def _port(name):
    return importlib.import_module(name)


class _Measurements:
    def __init__(self, measures):
        self.measures = measures

    def check_measure_dependencies(self, uuid, deps):
        for d in deps:
            assert d in self.measures, (uuid, d)


class _Task:
    def __init__(self, measures):
        self.measurements = _Measurements(measures)


class _Scripted:
    """Stands in for habitat's own measures (distance_to_goal, spl, ...)."""

    def __init__(self, value):
        self.value = value

    def get_metric(self):
        return self.value


def _run_measures(classes, seed):
    """Every measure over one scripted episode of random positions,
    distances and SPLs; their metrics after each step."""
    rng = np.random.default_rng(seed)
    sim = habitat_stub.StubSim(start=(0.0, 0.0, 0.0))
    d2g, spl = _Scripted(5.0), _Scripted(0.0)
    task = _Task({"distance_to_goal": d2g, "spl": spl,
                  "success": _Scripted(0.0)})
    ref = np.cumsum(rng.uniform(0, 1, (6, 3)), 0).tolist()
    ep = habitat_stub.StubEpisode("0", "s", "t", (0, 0, 0), ref[-1], ref)
    ms = [classes["PathLength"](sim=sim),
          classes["OracleNavigationError"](),
          classes["OracleSuccess"](),
          classes["OracleSPL"](),
          classes["PL"](sim=sim),
          classes["StepsTaken"](),
          classes["NDTW"](sim=sim)]
    for m in ms:
        m.reset_metric(task=task, episode=ep)
    trace = [[m.get_metric() for m in ms]]
    for _ in range(12):
        sim.position = sim.position + rng.normal(0, 0.5, 3)
        d2g.value = float(rng.uniform(0.5, 6.0))
        spl.value = float(rng.uniform(0, 1))
        for m in ms:
            m.update_metric(task=task, episode=ep)
        trace.append([m.get_metric() for m in ms])
    return trace


def test_measures_register_and_match_jax(registry):
    port = _port("streamvln_tpu_torch.habitat_extensions")
    classes = port.register_measures().register_all()
    assert set(MEASURES) <= set(registry.measures)
    assert all(registry.measures[n] is classes[n] for n in MEASURES)
    assert port.register_measures().register_all() is classes  # once
    assert port.habitat_available()
    from streamvln_tpu import habitat_extensions as jext
    jclasses = jext.register_measures().register_all()
    for seed in range(3):
        assert _run_measures(classes, seed) == _run_measures(jclasses, seed)


def test_ndtw_measure_matches_the_ports_metric(registry):
    from streamvln_tpu_torch.eval.metrics import ndtw
    classes = _port("streamvln_tpu_torch.habitat_extensions"
                    ).register_measures().register_all()
    sim = habitat_stub.StubSim(start=(0.0, 0.0, 0.0))
    ref = [[0, 0, 0], [1, 0, 0], [2, 0, 0], [3, 0, 0]]
    ep = habitat_stub.StubEpisode("0", "s", "t", (0, 0, 0), (3, 0, 0), ref)
    m = classes["NDTW"](sim=sim)
    m.reset_metric(task=None, episode=ep)
    path = [(0.0, 0.0, 0.0)]
    for pos in [(0.5, 0.2, 0.0), (1.5, 0.1, 0.0), (2.8, 0.0, 0.0)]:
        sim.position = np.asarray(pos)
        m.update_metric()
        path.append(pos)
        assert m.get_metric() == ndtw(np.asarray(path),
                                      np.asarray(ref, np.float64),
                                      threshold=3.0)


def test_backend_adapter_and_follower_match_jax(registry):
    hb = _port("streamvln_tpu_torch.eval.habitat_backend")
    from streamvln_tpu.eval import habitat_backend as jhb
    assert hb.REQUIRED_MEASUREMENTS == jhb.REQUIRED_MEASUREMENTS
    envs = [m.make_habitat_env("config/vln_r2r.yaml", "val_unseen")
            for m in (hb, jhb)]
    assert envs[0].config == envs[1].config
    cfg = envs[0].config.habitat
    assert cfg.dataset.split == "val_unseen"
    assert cfg.simulator.forward_step_size == 0.25
    assert cfg.simulator.turn_angle == 15
    sensors = cfg.simulator.agents["main_agent"].sim_sensors
    assert sensors["rgb_sensor"]["width"] == 640
    assert sensors["depth_sensor"]["max_depth"] == 10.0
    assert cfg.environment.max_episode_steps == 500

    env = envs[0]
    eps = env.episodes
    assert eps is env.episodes                    # views are cached
    for a, b in zip(eps, envs[1].episodes):
        for k in ("episode_id", "scene_id", "instruction_text",
                  "reference_path", "start_position", "goal_position"):
            assert getattr(a, k) == getattr(b, k), k
    env.current_episode = eps[1]
    assert env.reset()["rgb"].shape == (480, 640, 3)
    assert env.distance_to_goal() == pytest.approx(4.0)
    follower = env.make_follower(0.5)
    goal = eps[1].goal_position
    n = 0
    while not env.episode_over and n < 50:
        act = follower.get_next_action(goal)
        if act == 0:
            break
        env.step(act)
        n += 1
    assert env.distance_to_goal() < 0.5
    assert follower.get_next_action(goal) == 0     # None -> STOP
    follower.goal_radius = 0.1                     # DAgger tightens it
    assert follower.get_next_action(goal) == 1
    # episode_ids keeps only the named episodes
    kept = hb.make_habitat_env("config/vln_r2r.yaml", "val_seen",
                               episode_ids=["2", 3])
    assert [e.episode_id for e in kept.episodes] == ["2", "3"]


def test_maps_match_jax(registry):
    hmaps = _port("streamvln_tpu_torch.habitat_extensions.maps")
    from streamvln_tpu.habitat_extensions import maps as jmaps
    np.testing.assert_array_equal(hmaps.TOP_DOWN_MAP_COLORS,
                                  jmaps.TOP_DOWN_MAP_COLORS)
    rng = np.random.default_rng(0)
    grid = rng.integers(0, 256, (32, 48)).astype(np.uint8)
    fog = rng.integers(0, 2, (32, 48)).astype(np.uint8)
    for f in (None, fog):
        np.testing.assert_array_equal(
            hmaps.colorize_top_down_map(grid.copy(), f),
            jmaps.colorize_top_down_map(grid.copy(), f))
    bounds = {"lower": [-1.0, 0.0, -1.0], "upper": [9.0, 3.0, 9.0]}
    for x, y in rng.uniform(-1, 9, (50, 2)):
        for res in ((100, 100), (128, 64)):
            assert hmaps.static_to_grid(x, y, res, bounds) == \
                jmaps.static_to_grid(x, y, res, bounds)
    sim = habitat_stub.StubSim(start=(0.0, 0.5, 0.0))
    ep = habitat_stub.StubEpisode(
        "0", "scenes/sX/sX.glb", "walk", (0.0, 0.5, 0.0), (6.0, 0.5, 6.0),
        [[0.0, 0.5, 0.0], [3.0, 0.5, 2.0], [6.0, 0.5, 6.0]])
    path = np.cumsum(rng.uniform(-0.2, 0.6, (20, 3)), 0).tolist()
    for res in (64, 128):
        a = hmaps.render_episode_map(sim, ep, path, map_resolution=res)
        b = jmaps.render_episode_map(sim, ep, path, map_resolution=res)
        assert a.shape == (res, res, 3) and a.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
    occ = rng.integers(0, 2, (40, 40)).astype(np.uint8)
    np.testing.assert_array_equal(
        hmaps.render_episode_map(sim, ep, path, occupancy=occ),
        jmaps.render_episode_map(sim, ep, path, occupancy=occ))


def test_evaluator_draws_the_occupancy_map(registry, tmp_path):
    """save_video over the habitat backend: the video and the navmesh map
    of the positions the simulator took. The map is drawn from the raw
    habitat episode (the reference's evaluator passes the EpisodeView,
    which has no `goals`, and fails here; ROADMAP §3)."""
    from PIL import Image

    from streamvln_tpu.habitat_extensions import maps as jmaps
    from streamvln_tpu_torch import eval_cli
    from streamvln_tpu_torch.eval.evaluator import VLNEvaluator
    hb = _port("streamvln_tpu_torch.eval.habitat_backend")
    env = hb.make_habitat_env("config/vln_r2r.yaml", "val_unseen")
    env._env.episodes = env._env.episodes[:2]
    env._episode_views = None
    positions = {}
    step0, reset0 = env._env.step, env._env.reset

    def reset():
        obs = reset0()
        positions[env._env.current_episode.episode_id] = [
            env.sim.position.copy()]
        return obs

    def step(action):
        obs = step0(action)
        positions[env._env.current_episode.episode_id].append(
            env.sim.position.copy())
        return obs
    env._env.reset, env._env.step = reset, step
    agent = eval_cli.build_agent(None, "tiny", num_frames=8,
                                 num_future_steps=2, num_history=2,
                                 device="cpu")
    ev = VLNEvaluator(env, agent, str(tmp_path), save_video=True,
                      max_steps_per_episode=6)
    assert ev.aggregate([ev.eval_action()])["length"] == 2
    vis = tmp_path / "vis_0"
    for raw in env._env.episodes:
        scene = raw.scene_id.split("/")[-2]
        png = vis / f"{scene}_{raw.episode_id}_map.png"
        assert png.exists()
        assert any(f.startswith(f"{scene}_{raw.episode_id}")
                   and not f.endswith("_map.png") for f in os.listdir(vis))
        want = jmaps.render_episode_map(env.sim, raw,
                                        positions[raw.episode_id])
        np.testing.assert_array_equal(np.asarray(Image.open(png)), want)
    # the reference's evaluator over the same backend cannot draw it
    from streamvln_tpu.eval import habitat_backend as jhb
    jenv = jhb.make_habitat_env("config/vln_r2r.yaml", "val_unseen")
    view = jenv.episodes[0]
    with pytest.raises(AttributeError, match="goals"):
        jmaps.render_episode_map(jenv.sim, view, [[0, 0, 0], [1, 0, 1]])
