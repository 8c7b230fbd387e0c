"""Discrete-action -> goal-pose integration (ROS-free core of the robot
client; reference: realworld/go2_vln_client.py:166-198
incremental_change_goal): ↑ advances the goal 0.25 m along its own
heading, ←/→ pre-rotate the goal orientation by ±15°, STOP is a no-op.
A copy of `streamvln_tpu/realworld/goal_integrator.py`.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np

FORWARD_M = 0.25
TURN_DEG = 15.0


def _rot_z(angle_rad: float) -> np.ndarray:
    c, s = math.cos(angle_rad), math.sin(angle_rad)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def incremental_change_goal(homo_goal: np.ndarray,
                            actions: Sequence[int]) -> np.ndarray:
    """Integrate actions into the 4x4 goal pose (in place, returned)."""
    if homo_goal is None:
        raise ValueError("initialize homo_goal before changing it")
    for action in actions:
        if action == 0:
            continue
        if action == 1:
            yaw = math.atan2(homo_goal[1, 0], homo_goal[0, 0])
            homo_goal[0, 3] += FORWARD_M * np.cos(yaw)
            homo_goal[1, 3] += FORWARD_M * np.sin(yaw)
        elif action == 2:
            homo_goal[:3, :3] = _rot_z(math.radians(TURN_DEG)) \
                @ homo_goal[:3, :3]
        elif action == 3:
            homo_goal[:3, :3] = _rot_z(-math.radians(TURN_DEG)) \
                @ homo_goal[:3, :3]
        else:
            raise ValueError(f"unknown action {action}")
    return homo_goal
