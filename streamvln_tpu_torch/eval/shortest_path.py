"""Shortest-path expert for the plane geometry of the port's FakeNavEnv
(habitat's ShortestPathFollower surface: get_next_action(goal) -> 0 STOP
/ 1 forward / 2 left / 3 right).

Counterpart of `streamvln_tpu/eval/shortest_path.py`. On the fake env's
obstacle-free plane the geodesic is the straight line, so the expert turns
to face the goal within half a turn step, else moves forward, and STOPs
inside goal_radius. A habitat env supplies the real geodesic follower
(eval/habitat_backend.py).
"""
from __future__ import annotations

import numpy as np

from streamvln_tpu_torch.eval.fake_env import TURN_ANGLE_DEG, FakeNavEnv


def make_follower(env, goal_radius: float):
    """The expert of any backend: a habitat env's own geodesic follower
    (`HabitatEnvAdapter.make_follower`), else the straight-line one."""
    if hasattr(env, "make_follower"):
        return env.make_follower(goal_radius)
    return PlaneShortestPathFollower(env, goal_radius)


class PlaneShortestPathFollower:
    def __init__(self, env: FakeNavEnv, goal_radius: float = 0.25):
        self.env = env
        self.goal_radius = goal_radius

    def get_next_action(self, goal_xy) -> int:
        x, y, th = self.env._pose
        goal = np.asarray(goal_xy, np.float64)[:2]
        delta = goal - np.array([x, y])
        dist = float(np.linalg.norm(delta))
        if dist < self.goal_radius:
            return 0
        target_heading = np.arctan2(delta[1], delta[0])
        err = (target_heading - th + np.pi) % (2 * np.pi) - np.pi
        half_turn = np.deg2rad(TURN_ANGLE_DEG) / 2
        if err > half_turn:
            return 2   # left (+heading)
        if err < -half_turn:
            return 3   # right
        return 1
