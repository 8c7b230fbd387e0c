"""BENCHMARK.json against the contract's shape, and every piece of a cell
found by its name; a workload, a mix with a loop of its own and a metric,
each added as files, are picked up with no edit."""
import json
import os
import re
import shutil
import time

import pytest
import torch

from portbench.harness import cell, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    return spec.benchmark()


def test_top_level_keys_and_command(bench):
    assert set(bench) == TOP
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json")) \
        < 64 * 1024


def test_names_and_units(bench):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for item in bench[group]:
            assert NAME.match(item["name"]), item["name"]
            names.append((group, item["name"]))
            if "unit" in item:
                assert UNIT.match(item["unit"]), item["unit"]
            for key in ("why", "layer", "source"):
                if key in item:
                    assert 1 <= len(item[key]) <= 200
                    assert "\n" not in item[key] and "\t" not in item[key]
    assert len(names) == len(set(names))
    for c in bench["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])


def test_entries_have_the_contract_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])


def test_every_piece_is_found_by_name(bench):
    cells = {w["name"] for w in bench["workloads"]}
    for c in bench["configs"]:
        cfg = spec.config(c["name"])
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert cfg["reduced"] == c["reduced"]
    for w in bench["workloads"]:
        wl = spec.workload(w["name"])
        assert {k: wl[k] for k in ("name", "config", "traffic", "chips",
                                   "why")} == w
        spec.config(wl["config"])
        mix = spec.mix(wl["traffic"], wl.get("traffic_params"))
        assert hasattr(spec.loop(mix["loop"]), "System")
        assert wl["check"]["max_gap"] > 0
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        mod = spec.reader(m["name"])
        assert (mod.UNIT, mod.SOURCE) == (m["unit"], m["source"])
        assert set(m.get("workloads", cells)) <= cells
        if m in bench["per_layer"]:
            assert (mod.LAYER, mod.MOVES) == (m["layer"], m["moves"])
            assert m["moves"] in e2e
    for cell in cells:
        assert spec.cell_metrics(bench, cell, False)
        assert spec.cell_metrics(bench, cell, True)


def test_a_workload_added_as_a_file_is_picked_up(tmp_path, bench):
    base = tmp_path / "portbench"
    for sub in ("configs", "traffic", "workloads", "metrics", "loops"):
        shutil.copytree(os.path.join(spec.PORTBENCH, sub), base / sub)
    tiny = os.path.join(spec.PORTBENCH, "tests", "tiny")
    for sub in ("configs", "traffic"):
        for f in os.listdir(os.path.join(tiny, sub)):
            shutil.copy(os.path.join(tiny, sub, f), base / sub / f)
    added = {"name": "tiny_added", "config": "tiny_streamvln",
             "traffic": "robot_tiny", "traffic_params": {"frames": 4},
             "chips": 1, "why": "added by a test",
             "check": {"windows": 1, "max_gap": 0.001}}
    (base / "workloads" / "tiny_added.json").write_text(json.dumps(added))
    wl = spec.workload("tiny_added", str(base))
    assert wl == added
    assert spec.mix(wl["traffic"], wl["traffic_params"],
                    str(base))["frames"] == 4
    assert spec.config(wl["config"], str(base))["name"] == "tiny_streamvln"
    bench = dict(bench, workloads=bench["workloads"] + [
        {k: added[k] for k in ("name", "config", "traffic", "chips",
                               "why")}])
    names = [m["name"] for m in spec.cell_metrics(bench, "tiny_added",
                                                  False)]
    assert "setup_s" in names


# a later PR's loop: the robot's, with a field of its own in the window
ECHO_LOOP = """
from portbench.harness import spec

_robot = spec.loop("robot")


class System(_robot.System):
    def window(self, calls, t_w0, t_w1):
        out = super().window(calls, t_w0, t_w1)
        out["echo_calls"] = len(out["calls"])
        return out
"""

ECHO_METRIC = """
LAYER, UNIT, SOURCE, MOVES = "agent", "calls", "host_clock", "echo_calls"


def read(ctx):
    return ctx.get("echo_calls")
"""


def test_a_mix_with_its_own_loop_and_a_metric_are_files(tmp_path,
                                                       compose):
    """In a copy: a loop module, a mix that names it, a cell and a metric
    reader, each a new file, run end to end at tiny_streamvln on the CPU
    with nothing of portbench/ edited."""
    mix = json.load(open(os.path.join(spec.PORTBENCH, "tests", "tiny",
                                      "traffic", "robot_tiny.json")))
    wl = {"name": "tiny_echo", "config": "tiny_streamvln",
          "traffic": "echo_tiny", "traffic_params": {}, "chips": 1,
          "why": "added by a test", "check": {"windows": 2,
                                              "max_gap": 0.001}}
    base = compose(tmp_path / "portbench", {
        "loops/echo.py": ECHO_LOOP,
        "metrics/echo_calls.py": ECHO_METRIC,
        "traffic/echo_tiny.json": json.dumps(dict(mix, loop="echo")),
        "workloads/tiny_echo.json": json.dumps(wl)})
    bench = {"end_to_end": [
        {"name": "echo_calls", "unit": "calls", "better": "higher",
         "bound": 0.25, "source": "host_clock"},
        {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25,
         "source": "host_clock"}], "per_layer": []}
    out = cell.run("tiny_echo", 3, 1.0, False, torch.device("cpu"),
                   time.perf_counter(), bench=bench, base=base)
    assert out["correct"], out["checks"]
    assert out["metrics"]["echo_calls"]["value"] == out["attempted"] > 0
    assert set(out["metrics"]) == {"echo_calls", "setup_s"}
