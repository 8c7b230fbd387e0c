"""Deterministic fake VLN-CE environment of the PyTorch port.

Own copy of `streamvln_tpu/eval/fake_env.py` over the port's metrics: a
full env with the habitat episode API surface the eval loop uses
(reset()/step()/episode_over/get_metrics()/episodes), the VLN-CE action
space (0 STOP, 1 forward 25 cm, 2 left 15 deg, 3 right 15 deg) and
observations {rgb, depth, gps, compass}.

Geometry: 2D plane, pose (x, y, heading). Observations are generated from
the pose (deterministic), so models see changing inputs; `observable_goal`
renders the goal-relative bearing and distance instead. Episodes carry
goals and reference paths, so every metric is computable.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from streamvln_tpu_torch.eval.metrics import EpisodeTracker

FORWARD_STEP = 0.25
TURN_ANGLE_DEG = 15.0


@dataclasses.dataclass
class FakeEpisode:
    episode_id: str
    scene_id: str
    instruction_text: str
    start_position: Sequence[float]        # (x, y)
    start_heading: float
    goal_position: Sequence[float]         # (x, y)
    reference_path: Optional[np.ndarray] = None


def make_episodes(n: int, seed: int = 0, scenes: int = 2,
                  max_goal_dist: float = 5.0) -> List[FakeEpisode]:
    rng = np.random.RandomState(seed)
    eps = []
    for i in range(n):
        start = rng.uniform(-5, 5, 2)
        angle = rng.uniform(-np.pi, np.pi)
        dist = rng.uniform(1.5, max_goal_dist)
        goal = start + dist * np.array([np.cos(angle), np.sin(angle)])
        ref = np.linspace(start, goal, 6)
        eps.append(FakeEpisode(
            episode_id=str(i),
            scene_id=f"scenes/scene{i % scenes}/scene{i % scenes}.glb",
            instruction_text=f"Walk {dist:.1f} meters towards the "
                             f"{'red' if i % 2 else 'blue'} marker.",
            start_position=start,
            start_heading=float(rng.uniform(-np.pi, np.pi)),
            goal_position=goal,
            reference_path=ref,
        ))
    return eps


class FakeNavEnv:
    """habitat.Env-compatible surface for the episode loop."""

    def __init__(self, episodes: List[FakeEpisode],
                 max_episode_steps: int = 500,
                 rgb_shape=(480, 640, 3),
                 step_time_s: float = 0.0,
                 observable_goal: bool = False):
        self.episodes = episodes
        self.max_episode_steps = max_episode_steps
        self.rgb_shape = rgb_shape
        # simulate habitat's host-side C++ step cost (10-30 ms; SURVEY
        # §7 hard part 5) for overlap benchmarks
        self.step_time_s = step_time_s
        # observable_goal renders a LEARNABLE observation: the frame
        # encodes the goal-relative bearing (red/blue split column) and
        # distance (green level), so the shortest-path expert's policy
        # is a function of the pixels and closed-loop learning
        # (oracle data -> SFT -> higher eval SR) is testable without a
        # real simulator. Default off keeps the legacy procedural
        # pattern (pose-dependent but goal-blind).
        self.observable_goal = observable_goal
        self.current_episode: Optional[FakeEpisode] = None
        self._tracker: Optional[EpisodeTracker] = None
        self._pose = np.zeros(3)
        self._steps = 0
        self._over = True

    # -- episode control ------------------------------------------------
    def reset(self) -> Dict[str, np.ndarray]:
        ep = self.current_episode or self.episodes[0]
        self.current_episode = ep
        self._pose = np.array([ep.start_position[0], ep.start_position[1],
                               ep.start_heading])
        self._steps = 0
        self._over = False
        self._tracker = EpisodeTracker(
            goal=np.asarray(ep.goal_position),
            reference_path=ep.reference_path)
        self._tracker.reset(self._pose[:2])
        self._wp = 1   # steering sub-goal: next reference waypoint
        return self._observe()

    @property
    def episode_over(self) -> bool:
        return self._over

    def step(self, action: int) -> Dict[str, np.ndarray]:
        assert not self._over, "step() after episode end"
        if self.step_time_s:
            import time
            time.sleep(self.step_time_s)
        if action == 0:
            self._over = True
            self._tracker.update(self._pose[:2], stop_called=True)
        else:
            if action == 1:
                self._pose[0] += FORWARD_STEP * np.cos(self._pose[2])
                self._pose[1] += FORWARD_STEP * np.sin(self._pose[2])
            elif action == 2:
                self._pose[2] += np.deg2rad(TURN_ANGLE_DEG)
            elif action == 3:
                self._pose[2] -= np.deg2rad(TURN_ANGLE_DEG)
            else:
                raise ValueError(f"unknown action {action}")
            self._tracker.update(self._pose[:2])
        self._steps += 1
        if self._steps >= self.max_episode_steps:
            self._over = True
        return self._observe()

    def get_metrics(self) -> dict:
        return self._tracker.metrics()

    def distance_to_goal(self) -> float:
        """Mid-episode distance to goal (same surface as
        HabitatEnvAdapter.distance_to_goal)."""
        return float(self._tracker.distance_to_goal)

    def close(self):
        pass

    # -- observations ---------------------------------------------------
    def _observe(self) -> Dict[str, np.ndarray]:
        H, W, _ = self.rgb_shape
        x, y, th = self._pose
        if self.observable_goal:
            rgb = self._observe_goal(H, W)
        else:
            # procedural pose-dependent pattern (cheap, deterministic)
            u = np.linspace(0, 4 * np.pi, W, dtype=np.float32)
            v = np.linspace(0, 3 * np.pi, H, dtype=np.float32)
            uu, vv = np.meshgrid(u, v)
            phase = np.float32(x * 2.1 + y * 3.3)
            r = np.sin(uu + th) * np.cos(vv + phase)
            g = np.sin(uu * 0.5 + phase) * np.sin(vv + th)
            b = np.cos(uu + vv + x - y)
            rgb = np.stack([r, g, b], -1)
            rgb = ((rgb + 1) * 127.5).astype(np.uint8)
        return self._finish_obs(rgb, H, W)

    def _observe_goal(self, H: int, W: int) -> np.ndarray:
        """Goal-observable rendering, robust to aggressive spatial
        pooling: the red/blue split column position encodes the
        goal-relative bearing (all-red = goal hard left, all-blue =
        hard right, split centered = dead ahead), and the green channel
        level encodes distance-to-goal. Channel MEANS are linear in
        (bearing, distance), so even a 2x2-pooled tiny tower can read
        the expert's decision variables."""
        x, y, th = self._pose
        goal = np.asarray(self.current_episode.goal_position, np.float64)
        # steering target: the next REFERENCE WAYPOINT (advance within
        # 0.5 m, the expert's mid-goal radius), falling back to the
        # goal on the last leg. On straight (linspace) reference paths
        # the waypoint bearing equals the goal bearing, so this is
        # behavior-preserving there; on bent paths it keeps the
        # rendered bearing CONSISTENT with the shortest-path expert's
        # actions (required for DAgger collection on curvy episodes —
        # goal-bearing pixels paired with waypoint-following expert
        # actions poison the policy).
        ref = self.current_episode.reference_path
        ref = None if ref is None else np.asarray(ref, np.float64)
        target = goal
        if ref is not None and len(ref) > 1:
            while (self._wp < len(ref) - 1
                   and np.hypot(ref[self._wp][0] - x,
                                ref[self._wp][1] - y) < 0.5):
                self._wp += 1
            target = ref[self._wp] if self._wp < len(ref) - 1 else goal
        bearing = np.arctan2(target[1] - y, target[0] - x) - th
        bearing = (bearing + np.pi) % (2 * np.pi) - np.pi   # [-pi, pi)
        # distance channel stays distance-to-GOAL: it is the STOP
        # signal, not the steering signal
        dist = float(np.hypot(goal[0] - x, goal[1] - y))
        # split column sweeps the full screen over bearing in [-45deg,
        # +45deg] (saturating beyond): goal to the left (positive
        # bearing, expert turns left) puts MORE red on screen. The
        # +-45deg full scale puts the expert's turn/forward decision
        # boundary (+-7.5deg) a full pooled-patch-mean step away from
        # center, so coarse towers can resolve it.
        swing = float(np.clip(bearing / (np.pi / 4), -1.0, 1.0))
        col = int(round((swing * 0.5 + 0.5) * W))
        rgb = np.zeros((H, W, 3), np.uint8)
        rgb[:, :col, 0] = 230
        rgb[:, :col, 2] = 25
        rgb[:, col:, 0] = 25
        rgb[:, col:, 2] = 230
        # distance on a 3 m full scale: one 25 cm forward step moves
        # the green level by ~19/255, so the STOP boundary (0.25 m) is
        # well-separated from the last approach steps
        rgb[:, :, 1] = np.uint8(
            np.clip(dist / 3.0, 0.0, 1.0) * 230 + 25)
        return rgb

    def _finish_obs(self, rgb: np.ndarray, H: int,
                    W: int) -> Dict[str, np.ndarray]:
        x, y, th = self._pose
        depth = np.full((H, W, 1), 2.5, np.float32)
        return {
            "rgb": rgb,
            "depth": depth,
            "gps": np.array([x, -y], np.float32),   # habitat flips west
            "compass": np.array([th], np.float32),
        }
