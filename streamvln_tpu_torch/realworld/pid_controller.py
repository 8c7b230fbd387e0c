"""PD velocity controller for goal-pose tracking.

Behavioral parity with the reference controller (reference:
realworld/pid_controller.py:4-41): clamped P-D law on the body-frame
forward translation error and wrapped yaw error. A copy of
`streamvln_tpu/realworld/pid_controller.py`.
"""
from __future__ import annotations

import math

import numpy as np


class PIDController:
    def __init__(self, kp_trans: float = 1.0, kd_trans: float = 0.1,
                 kp_yaw: float = 1.0, kd_yaw: float = 1.0,
                 max_v: float = 1.0, max_w: float = 1.2):
        self.kp_trans = kp_trans
        self.kd_trans = kd_trans
        self.kp_yaw = kp_yaw
        self.kd_yaw = kd_yaw
        self.max_v = max_v
        self.max_w = max_w

    def solve(self, odom: np.ndarray, target: np.ndarray,
              vel=(0.0, 0.0)):
        """odom/target: 4x4 SE(2)-embedded homogeneous poses.
        Returns (v, w, translation_error, yaw_error)."""
        translation_error, yaw_error = self.calculate_errors(odom, target)
        v, w = self.pd_step(translation_error, yaw_error, vel[0], vel[1])
        return v, w, translation_error, yaw_error

    def pd_step(self, translation_error: float, yaw_error: float,
                linear_vel: float, angular_vel: float):
        translation_error = max(-1.0, min(1.0, translation_error))
        yaw_error = max(-1.0, min(1.0, yaw_error))
        v = self.kp_trans * translation_error - self.kd_trans * linear_vel
        w = self.kp_yaw * yaw_error - self.kd_yaw * angular_vel
        v = max(-self.max_v, min(self.max_v, v))
        w = max(-self.max_w, min(self.max_w, w))
        return v, w

    @staticmethod
    def calculate_errors(odom: np.ndarray, target: np.ndarray):
        dx = target[0, 3] - odom[0, 3]
        dy = target[1, 3] - odom[1, 3]
        odom_yaw = math.atan2(odom[1, 0], odom[0, 0])
        target_yaw = math.atan2(target[1, 0], target[0, 0])
        # body-frame forward component only (lateral handled by yaw)
        translation_error = dx * np.cos(odom_yaw) + dy * np.sin(odom_yaw)
        yaw_error = (target_yaw - odom_yaw + math.pi) % (2 * math.pi) \
            - math.pi
        return float(translation_error), float(yaw_error)
