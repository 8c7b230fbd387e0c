"""On the card (marked `cuda`; they skip elsewhere): each cell's control
comes out not correct, and a sound run of each cell comes out correct, at
the cell's own size and load, through the benchmark's command."""
import json
import subprocess
import sys

import pytest

from portbench.harness import spec

CELLS = ("7b_robot_b1", "14b_int4_robot_b1")


def _run(cell, seed, *extra):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if cell not in {w["name"] for w in spec.benchmark()["workloads"]}:
        pytest.skip(f"{cell} is not in BENCHMARK.json")
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(seed), "--seconds", "10", "--trace", "0", *extra],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [3_000_000_001, 3_000_000_002,
                                  3_000_000_003])
def test_the_control_is_not_correct(cell, seed):
    out = _run(cell, seed, "--control")
    assert not out["correct"]
    gap = out["checks"]["max_gap"]
    assert gap["value"] > gap["limit"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    out = _run(cell, 3_000_000_004)
    assert out["correct"], out["checks"]
