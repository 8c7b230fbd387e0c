"""Finding a cell's pieces by name.

- `BENCHMARK.json` (the repository root): the cells and metrics.
- `portbench/workloads/<cell>.json`: configuration, traffic mix, the
  mix's parameter overrides, chips, why, and the correctness check's
  settings.
- `portbench/configs/<config>.json`: the configuration's sizes and how it
  is served.
- `portbench/traffic/<mix>.json`: the mix's parameters, among them the
  `loop` that drives it.
- `portbench/loops/<loop>.py`: one module per way of driving the program
  (its `System`: set-up, the loop, the window's fields, the check).
- `portbench/metrics/<metric>.py`: one reader per metric, `read(ctx)`
  returning a number or None (nothing to read).

A later cell, mix, loop, configuration or metric is new files and new
entries in `BENCHMARK.json`; nothing here names one.
"""
from __future__ import annotations

import importlib.util
import json
import os
from typing import Dict, List, Optional

PORTBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PORTBENCH)


def _load(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _load(os.path.join(root, "BENCHMARK.json"))


def workload(name: str, base: str = PORTBENCH) -> dict:
    return _load(os.path.join(base, "workloads", f"{name}.json"))


def config(name: str, base: str = PORTBENCH) -> dict:
    return _load(os.path.join(base, "configs", f"{name}.json"))


def mix(name: str, overrides: Optional[dict] = None,
        base: str = PORTBENCH) -> dict:
    out = _load(os.path.join(base, "traffic", f"{name}.json"))
    out.update(overrides or {})
    return out


def cell_metrics(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a run of `cell` reports: with trace off the end-to-end
    ones, with trace on the per-layer ones, each where its `workloads`
    (when given) names the cell."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def _module(kind: str, name: str, base: str):
    path = os.path.join(base, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str, base: str = PORTBENCH):
    """The reader module of metric `name` (portbench/metrics/<name>.py)."""
    return _module("metrics", name, base)


def loop(name: str, base: str = PORTBENCH):
    """The loop module `name` (portbench/loops/<name>.py)."""
    return _module("loops", name, base)


def read_metrics(metrics: List[dict], ctx: dict,
                 base: str = PORTBENCH) -> Dict[str, dict]:
    """{name: {"value", "unit"}} of each metric whose reader finds
    something to read."""
    out = {}
    for m in metrics:
        value = reader(m["name"], base).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
