"""VLN-CE measure extensions for habitat's task registry (the port's
twin of `streamvln_tpu/habitat_extensions/measures.py`; NDTW over the
port's `eval/metrics.ndtw`).

Semantics-parity rebuild of the reference's registered measures
(reference: streamvln/habitat_extensions/measures.py:36-219) plus NDTW
(commented out there, :222-280, but consumed by the RxR benchmark
numbers) — written against habitat-lab's Measure API:

- path_length              sum of euclidean agent displacements
- oracle_navigation_error  min distance_to_goal over the path
- oracle_success           1 iff distance_to_goal ever < success_distance
- oracle_spl               max SPL over the path
- pl                       relative path length: d_start / max(d_start, walked)
- steps_taken              number of actions (STOP included)
- ndtw                     normalized DTW of the path vs reference_path

Registration is lazy (`register_all()`), so this module can be imported
for its pure helpers without habitat; class construction happens inside
so the habitat imports stay guarded.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

# uuids of the stock habitat measures we depend on
# (habitat.tasks.nav.nav.DistanceToGoal / Success / SPL)
DISTANCE_TO_GOAL_UUID = "distance_to_goal"
SUCCESS_UUID = "success"
SPL_UUID = "spl"

DEFAULT_SUCCESS_DISTANCE = 3.0   # VLN-CE convention (config/vln_r2r.yaml)

_measure_classes: Optional[Dict[str, type]] = None


def _euclid(a, b) -> float:
    return float(np.linalg.norm(np.asarray(b, np.float64)
                                - np.asarray(a, np.float64)))


def _build_classes():
    """Define + return the Measure subclasses (requires habitat)."""
    from habitat.core.embodied_task import Measure
    from habitat.core.registry import registry

    @registry.register_measure
    class PathLength(Measure):
        """Walked euclidean path length (reference: measures.py:36-60)."""

        cls_uuid = "path_length"

        def __init__(self, sim=None, config=None, *args: Any,
                     **kwargs: Any):
            self._sim = sim
            super().__init__()

        def _get_uuid(self, *args: Any, **kwargs: Any) -> str:
            return self.cls_uuid

        def reset_metric(self, *args: Any, **kwargs: Any):
            self._prev = self._sim.get_agent_state().position
            self._metric = 0.0

        def update_metric(self, *args: Any, **kwargs: Any):
            pos = self._sim.get_agent_state().position
            self._metric += _euclid(self._prev, pos)
            self._prev = pos

    class _DependsOnD2G(Measure):
        """Shared base: tracks task.measurements[distance_to_goal]."""

        def __init__(self, sim=None, config=None, *args: Any,
                     **kwargs: Any):
            self._config = config
            super().__init__()

        def _get_uuid(self, *args: Any, **kwargs: Any) -> str:
            return self.cls_uuid

        def _d2g(self, task) -> float:
            return task.measurements.measures[
                DISTANCE_TO_GOAL_UUID].get_metric()

    @registry.register_measure
    class OracleNavigationError(_DependsOnD2G):
        """min distance-to-goal over the path (measures.py:63-86)."""

        cls_uuid = "oracle_navigation_error"

        def reset_metric(self, *args: Any, task=None, **kwargs: Any):
            task.measurements.check_measure_dependencies(
                self.uuid, [DISTANCE_TO_GOAL_UUID])
            self._metric = float("inf")
            self.update_metric(task=task)

        def update_metric(self, *args: Any, task=None, **kwargs: Any):
            self._metric = min(self._metric, self._d2g(task))

    @registry.register_measure
    class OracleSuccess(_DependsOnD2G):
        """1 iff d2g ever dipped below success_distance
        (measures.py:89-119; the reference hardcodes 3.0 — here the
        config's success_distance wins, defaulting to 3.0)."""

        cls_uuid = "oracle_success"

        def reset_metric(self, *args: Any, task=None, **kwargs: Any):
            task.measurements.check_measure_dependencies(
                self.uuid, [DISTANCE_TO_GOAL_UUID])
            self._metric = 0.0
            self.update_metric(task=task)

        def update_metric(self, *args: Any, task=None, **kwargs: Any):
            thresh = getattr(self._config, "success_distance",
                             DEFAULT_SUCCESS_DISTANCE) \
                if self._config is not None else DEFAULT_SUCCESS_DISTANCE
            self._metric = float(self._metric
                                 or self._d2g(task) < thresh)

    @registry.register_measure
    class OracleSPL(Measure):
        """max SPL over the path (measures.py:122-139)."""

        cls_uuid = "oracle_spl"

        def __init__(self, sim=None, config=None, *args: Any,
                     **kwargs: Any):
            super().__init__()

        def _get_uuid(self, *args: Any, **kwargs: Any) -> str:
            return self.cls_uuid

        def reset_metric(self, *args: Any, task=None, **kwargs: Any):
            task.measurements.check_measure_dependencies(
                self.uuid, [SPL_UUID])
            self._metric = 0.0

        def update_metric(self, *args: Any, task=None, **kwargs: Any):
            spl = task.measurements.measures[SPL_UUID].get_metric()
            self._metric = max(self._metric, spl)

    @registry.register_measure
    class PL(Measure):
        """Relative path length d_start / max(d_start, walked); the
        DAgger save gate reads it (measures.py:141-200,
        streamvln_dagger.py:405)."""

        cls_uuid = "pl"

        def __init__(self, sim=None, config=None, *args: Any,
                     **kwargs: Any):
            self._sim = sim
            super().__init__()

        def _get_uuid(self, *args: Any, **kwargs: Any) -> str:
            return self.cls_uuid

        def reset_metric(self, *args: Any, task=None, **kwargs: Any):
            task.measurements.check_measure_dependencies(
                self.uuid, [DISTANCE_TO_GOAL_UUID, SUCCESS_UUID])
            self._prev = self._sim.get_agent_state().position
            self._walked = 0.0
            self._d_start = task.measurements.measures[
                DISTANCE_TO_GOAL_UUID].get_metric()
            self.update_metric(task=task, *args, **kwargs)

        def update_metric(self, *args: Any, task=None, **kwargs: Any):
            pos = self._sim.get_agent_state().position
            self._walked += _euclid(self._prev, pos)
            self._prev = pos
            self._metric = self._d_start / max(self._d_start,
                                               self._walked)

    @registry.register_measure
    class StepsTaken(Measure):
        """Action count, STOP included (measures.py:203-219)."""

        cls_uuid = "steps_taken"

        def __init__(self, sim=None, config=None, *args: Any,
                     **kwargs: Any):
            super().__init__()

        def _get_uuid(self, *args: Any, **kwargs: Any) -> str:
            return self.cls_uuid

        def reset_metric(self, *args: Any, **kwargs: Any):
            self._metric = 0.0

        def update_metric(self, *args: Any, **kwargs: Any):
            self._metric += 1.0

    @registry.register_measure
    class NDTW(Measure):
        """Normalized dynamic time warping vs the episode's
        reference_path (the reference keeps this commented,
        measures.py:222-280; the RxR table reports it). Uses the
        episode's own reference_path instead of external gt files."""

        cls_uuid = "ndtw"

        def __init__(self, sim=None, config=None, *args: Any,
                     **kwargs: Any):
            self._sim = sim
            self._config = config
            super().__init__()

        def _get_uuid(self, *args: Any, **kwargs: Any) -> str:
            return self.cls_uuid

        def reset_metric(self, *args: Any, episode=None, **kwargs: Any):
            self._positions = [np.asarray(
                self._sim.get_agent_state().position, np.float64)]
            self._ref = np.asarray(
                getattr(episode, "reference_path", None), np.float64) \
                if getattr(episode, "reference_path", None) is not None \
                else None
            self._metric = 0.0
            self._refresh()

        def update_metric(self, *args: Any, **kwargs: Any):
            self._positions.append(np.asarray(
                self._sim.get_agent_state().position, np.float64))
            self._refresh()

        def _refresh(self):
            if self._ref is None or not len(self._ref):
                self._metric = 0.0
                return
            from streamvln_tpu_torch.eval.metrics import ndtw
            thresh = getattr(self._config, "success_distance",
                             DEFAULT_SUCCESS_DISTANCE) \
                if self._config is not None else DEFAULT_SUCCESS_DISTANCE
            self._metric = ndtw(np.stack(self._positions), self._ref,
                                threshold=thresh)

    return {
        "PathLength": PathLength,
        "OracleNavigationError": OracleNavigationError,
        "OracleSuccess": OracleSuccess,
        "OracleSPL": OracleSPL,
        "PL": PL,
        "StepsTaken": StepsTaken,
        "NDTW": NDTW,
    }


def _register_config_schemas():
    """Expose the measures to habitat's hydra config composition, so
    YAML entries like `oracle_success: {type: OracleSuccess}` validate.
    Best-effort: habitat builds without hydra (or older habitat-lab)
    skip this and rely on runtime injection (eval/habitat_backend.py)."""
    try:
        from dataclasses import dataclass, field

        from habitat.config.default_structured_configs import (
            MeasurementConfig)
        from hydra.core.config_store import ConfigStore
    except ImportError:
        return

    cs = ConfigStore.instance()

    specs = [
        ("path_length", "PathLength", {}),
        ("oracle_navigation_error", "OracleNavigationError", {}),
        ("oracle_success", "OracleSuccess",
         {"success_distance": DEFAULT_SUCCESS_DISTANCE}),
        ("oracle_spl", "OracleSPL", {}),
        ("pl", "PL", {}),
        ("steps_taken", "StepsTaken", {}),
        ("ndtw", "NDTW",
         {"success_distance": DEFAULT_SUCCESS_DISTANCE}),
    ]
    for name, type_name, extra in specs:
        fields = {"type": field(default=type_name)}
        annotations = {"type": str}
        for k, v in extra.items():
            fields[k] = field(default=v)
            annotations[k] = type(v)
        node = dataclass(type(
            f"{type_name}MeasurementConfig", (MeasurementConfig,),
            {"__annotations__": annotations, **fields}))
        cs.store(package=f"habitat.task.measurements.{name}",
                 group="habitat/task/measurements", name=name,
                 node=node)


def register_all() -> Dict[str, type]:
    """Build + register the measure classes (idempotent per-process:
    habitat's registry keeps the first registration)."""
    global _measure_classes
    if _measure_classes is None:
        _measure_classes = _build_classes()
        _register_config_schemas()
    return _measure_classes
