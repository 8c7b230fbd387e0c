"""VLN-CE episode metrics (numpy, host-side) of the PyTorch port.

Own copy of `streamvln_tpu/eval/metrics.py` (the port imports nothing of
the JAX package), with the same semantics, from habitat's nav measures and
the reference's extensions (streamvln/habitat_extensions/measures.py):
- distance_to_goal (NE), success = stop_called & d < 3.0, SPL
- oracle variants: ONE = min d over path, OS = I(min d < 3.0), OracleSPL =
  max SPL over path
- path_length = summed euclidean step distances
- PL = shortest / max(shortest, walked) relative path length
- steps_taken
- nDTW (RxR): exp(-DTW(path, ref) / (|ref| * d_th)), d_th = 3.0
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

SUCCESS_DISTANCE = 3.0
NDTW_THRESHOLD = 3.0


def euclidean(a, b) -> float:
    return float(np.linalg.norm(np.asarray(b, np.float64)
                                - np.asarray(a, np.float64)))


def dtw_distance(path: np.ndarray, ref: np.ndarray) -> float:
    """Classic DTW with euclidean local cost."""
    n, m = len(path), len(ref)
    acc = np.full((n + 1, m + 1), np.inf)
    acc[0, 0] = 0.0
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            d = np.linalg.norm(path[i - 1] - ref[j - 1])
            acc[i, j] = d + min(acc[i - 1, j], acc[i, j - 1],
                                acc[i - 1, j - 1])
    return float(acc[n, m])


def ndtw(path: Sequence, ref: Sequence,
         threshold: float = NDTW_THRESHOLD) -> float:
    path = np.asarray(path, np.float64)
    ref = np.asarray(ref, np.float64)
    if len(ref) == 0 or len(path) == 0:
        return 0.0
    return float(np.exp(-dtw_distance(path, ref) / (len(ref) * threshold)))


@dataclasses.dataclass
class EpisodeTracker:
    """Accumulates per-step state; finalizes to the metric dict the
    reference's eval loop reads (streamvln_eval.py:360-374)."""
    goal: np.ndarray
    reference_path: Optional[np.ndarray] = None
    success_distance: float = SUCCESS_DISTANCE

    def __post_init__(self):
        self.goal = np.asarray(self.goal, np.float64)
        self.positions: List[np.ndarray] = []
        self.path_length = 0.0
        self.steps_taken = 0
        self.min_distance = np.inf
        self.oracle_spl = 0.0
        self.stop_called = False
        self.shortest_dist: Optional[float] = None

    def reset(self, start_position):
        start = np.array(start_position, np.float64)  # copy: callers may
        # pass views of a live pose buffer
        self.positions = [start]
        self.shortest_dist = euclidean(start, self.goal)
        self.min_distance = self.shortest_dist

    def update(self, position, stop_called: bool = False):
        pos = np.array(position, np.float64)  # copy (see reset)
        self.path_length += euclidean(self.positions[-1], pos)
        self.positions.append(pos)
        self.steps_taken += 1
        d = euclidean(pos, self.goal)
        self.min_distance = min(self.min_distance, d)
        self.stop_called = self.stop_called or stop_called
        self.oracle_spl = max(self.oracle_spl, self._spl(success=d <
                                                         self.success_distance))

    def _spl(self, success: bool) -> float:
        if not success or self.shortest_dist is None:
            return 0.0
        denom = max(self.shortest_dist, self.path_length)
        return self.shortest_dist / denom if denom > 0 else 1.0

    @property
    def distance_to_goal(self) -> float:
        return euclidean(self.positions[-1], self.goal)

    def metrics(self) -> dict:
        d = self.distance_to_goal
        success = float(self.stop_called and d < self.success_distance)
        out = {
            "distance_to_goal": d,
            "success": success,
            "spl": success * self._spl(success=True),
            "oracle_success": float(self.min_distance <
                                    self.success_distance),
            "oracle_navigation_error": float(self.min_distance),
            "oracle_spl": self.oracle_spl,
            "path_length": self.path_length,
            "steps_taken": float(self.steps_taken),
            "pl": (self.shortest_dist
                   / max(self.shortest_dist, self.path_length)
                   if self.shortest_dist and max(self.shortest_dist,
                                                 self.path_length) > 0
                   else 0.0),
        }
        if self.reference_path is not None:
            out["ndtw"] = ndtw(np.asarray(self.positions),
                               self.reference_path)
        return out
