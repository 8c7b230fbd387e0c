"""habitat-sim env adapter of the port (a twin of
`streamvln_tpu/eval/habitat_backend.py`): config load + benchmark
sensor/agent setup + measure registration + episode caching +
shortest-path expert.

The simulator stays a host-side C++ process (reference:
streamvln_eval.py:24-35, 187-190); this module makes the benchmark
reproducible on habitat hosts:

- registers the VLN-CE measure extensions before env construction
  (reference registers via import side effect,
  streamvln/habitat_extensions/measures.py:36-219)
- loads the hydra config (config/vln_r2r.yaml parity: 640x480 RGB-D,
  HFOV 79, fwd 0.25 m, turn 15 deg, 500 steps — reference
  config/vln_r2r.yaml:1-57) and force-injects the benchmark sensor /
  agent parameters plus any missing extension measurements
- exposes the evaluator-facing surface (reset/step/episode_over/
  get_metrics/episodes/current_episode), cached FakeEpisode-shaped
  episode views, `distance_to_goal()` for DAgger's takeover gate, and
  `make_follower()` wrapping habitat's geodesic ShortestPathFollower
  (reference expert: streamvln_dagger.py:330-357)
"""
from __future__ import annotations

from typing import Optional, Sequence

BENCH_SENSOR = {"width": 640, "height": 480, "hfov": 79}
BENCH_DEPTH = {"min_depth": 0.0, "max_depth": 10.0}
BENCH_FORWARD_STEP = 0.25
BENCH_TURN_ANGLE = 15
BENCH_MAX_STEPS = 500
# evaluator-consumed measures that must exist in task.measurements
REQUIRED_MEASUREMENTS = {
    "oracle_success": "OracleSuccess",
    "oracle_navigation_error": "OracleNavigationError",
    "path_length": "PathLength",
    "oracle_spl": "OracleSPL",
    "pl": "PL",
    "steps_taken": "StepsTaken",
    "ndtw": "NDTW",
}


def _load_config(config_path: str):
    import habitat
    get_config = getattr(habitat, "get_config", None)
    if get_config is None:     # older habitat-lab layouts
        from habitat.config.default import get_config
    return get_config(config_path)


def _inject_benchmark_config(config, split: str,
                             max_steps: Optional[int],
                             enforce_sensors: bool):
    """Apply split + benchmark sensor/agent/measure settings in-place
    (requires an open read_write context)."""
    hab = config.habitat
    hab.dataset.split = split
    if max_steps is not None:
        hab.environment.max_episode_steps = max_steps

    if enforce_sensors:
        agents = hab.simulator.agents
        agent = agents.get("main_agent", None) if hasattr(agents, "get") \
            else getattr(agents, "main_agent", None)
        if agent is not None:
            sensors = agent.sim_sensors
            for name, extra in (("rgb_sensor", {}),
                                ("depth_sensor", BENCH_DEPTH)):
                sensor = sensors.get(name, None) if hasattr(
                    sensors, "get") else getattr(sensors, name, None)
                if sensor is None:
                    continue
                for k, v in {**BENCH_SENSOR, **extra}.items():
                    setattr(sensor, k, v)
        hab.simulator.forward_step_size = BENCH_FORWARD_STEP
        hab.simulator.turn_angle = BENCH_TURN_ANGLE

    # any evaluator-required measurement missing from the yaml gets
    # injected so get_metrics() carries oracle_success / ndtw / pl
    try:
        from hydra.core.config_store import ConfigStore
        repo = ConfigStore.instance().repo
        nodes = repo.get("habitat", {}).get("task", {}).get(
            "measurements", {})
        measurements = hab.task.measurements
        for name in REQUIRED_MEASUREMENTS:
            if name in measurements:
                continue
            node = nodes.get(f"{name}.yaml")
            if node is not None:
                measurements[name] = node.node
    except Exception:
        pass    # schemas unavailable: the shipped yaml carries them


class EpisodeView:
    """FakeEpisode-shaped view over a habitat VLN episode."""

    __slots__ = ("raw", "episode_id", "scene_id", "instruction_text",
                 "reference_path", "start_position", "goal_position")

    def __init__(self, ep):
        self.raw = ep
        self.episode_id = ep.episode_id
        self.scene_id = ep.scene_id
        instr = getattr(ep, "instruction", None)
        self.instruction_text = getattr(instr, "instruction_text", None) \
            if instr is not None else getattr(ep, "instruction_text", "")
        self.reference_path = getattr(ep, "reference_path", None)
        self.start_position = getattr(ep, "start_position", None)
        goals = getattr(ep, "goals", None)
        self.goal_position = goals[0].position if goals else None


class HabitatFollower:
    """habitat ShortestPathFollower with the PlaneShortestPathFollower
    surface: get_next_action(goal) -> 0 STOP / 1 fwd / 2 left / 3 right,
    mutable goal_radius (the DAgger loop tightens it on the final
    waypoint, streamvln_dagger.py:334-345)."""

    def __init__(self, sim, goal_radius: float):
        self._sim = sim
        self._goal_radius = goal_radius
        self._follower = self._make(goal_radius)

    def _make(self, radius: float):
        from habitat.tasks.nav.shortest_path_follower import (
            ShortestPathFollower)
        return ShortestPathFollower(self._sim, radius,
                                    return_one_hot=False)

    @property
    def goal_radius(self) -> float:
        return self._goal_radius

    @goal_radius.setter
    def goal_radius(self, radius: float):
        if radius != self._goal_radius:
            self._goal_radius = radius
            self._follower = self._make(radius)

    def get_next_action(self, goal) -> int:
        import numpy as np
        act = self._follower.get_next_action(
            np.asarray(goal, dtype=np.float32))
        return 0 if act is None else int(act)


class HabitatEnvAdapter:
    """Evaluator-facing wrapper over habitat.Env (episodes cached)."""

    def __init__(self, env, config):
        self._env = env
        self.config = config
        self._episode_views = None

    # -- episodes -------------------------------------------------------
    @property
    def episodes(self):
        if self._episode_views is None:
            self._episode_views = [EpisodeView(ep)
                                   for ep in self._env.episodes]
        return self._episode_views

    @property
    def current_episode(self):
        return EpisodeView(self._env.current_episode)

    @current_episode.setter
    def current_episode(self, ep):
        self._env.current_episode = getattr(ep, "raw", ep)

    # -- env surface ------------------------------------------------------
    def reset(self):
        return self._env.reset()

    def step(self, action: int):
        return self._env.step(int(action))

    @property
    def episode_over(self) -> bool:
        return self._env.episode_over

    def get_metrics(self) -> dict:
        return self._env.get_metrics()

    def distance_to_goal(self) -> float:
        """Mid-episode geodesic distance to goal (DAgger takeover gate,
        streamvln_dagger.py:350-357)."""
        return float(self.get_metrics()["distance_to_goal"])

    def close(self):
        self._env.close()

    # -- expert -----------------------------------------------------------
    @property
    def sim(self):
        return self._env.sim

    def make_follower(self, goal_radius: float) -> HabitatFollower:
        return HabitatFollower(self._env.sim, goal_radius)


def make_habitat_env(config_path: str, split: str, *,
                     max_steps: Optional[int] = BENCH_MAX_STEPS,
                     enforce_sensors: bool = True,
                     episode_ids: Optional[Sequence[str]] = None
                     ) -> HabitatEnvAdapter:
    """Build a benchmark-configured habitat env. Raises ImportError on
    hosts without habitat."""
    from streamvln_tpu_torch import habitat_extensions
    habitat_extensions.register_measures()

    import habitat
    config = _load_config(config_path)
    with habitat.config.read_write(config):
        _inject_benchmark_config(config, split, max_steps,
                                 enforce_sensors)
    env = habitat.Env(config=config)
    adapter = HabitatEnvAdapter(env, config)
    if episode_ids is not None:
        keep = set(map(str, episode_ids))
        env.episodes = [ep for ep in env.episodes
                        if str(ep.episode_id) in keep]
        adapter._episode_views = None
    return adapter
