"""The port's training command on a mesh: two ranks of a gloo group with
torchrun's variables set run `python -m streamvln_tpu_torch.train ...
--fsdp 2 --device cpu`, against the port's one-device command on the
same trajectories (the one-device command is held against JAX's in
test_torch_train_cli.py): the log lines within tolerance, written once
(rank 0 alone writes; rank 1 prints nothing and rank 0 prints JAX's
eval-skip line), and checkpoints that move both ways: a mesh checkpoint
resumed on one device and a one-device checkpoint resumed on the mesh
both give the one-device resume's next step.

f32 on the CPU; tolerance rtol 2e-4, atol 2e-5 (f32 sums in another
order: the mesh sums its ranks' rows).
"""
import json
import os
import shutil

import numpy as np
import pytest

import torch_ranks
from streamvln_tpu_torch import train as ttrain_cli
from streamvln_tpu_torch.data.vln_dataset import (write_annotations,
                                                  write_trajectory)

ATOL, RTOL = 2e-5, 2e-4
ARGS = ["--model_size", "tiny", "--num_frames", "8", "--num_future_steps",
        "2", "--num_history", "2", "--batch_size", "2", "--log_steps", "1",
        "--learning_rate", "1e-3", "--save_steps", "2", "--device", "cpu",
        "--prefetch_depth", "0"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_mesh")
    traj = str(root / "traj")
    rng = np.random.RandomState(0)
    entries = [write_trajectory(traj, f"scene_{ep}",
                                rng.randint(0, 255, (10, 48, 64, 3),
                                            np.uint8),
                                [f"instr {ep}"],
                                rng.randint(0, 4, 10).tolist())
               for ep in range(3)]
    write_annotations(traj, entries)

    def argv(out, steps, *extra):
        return ["--video_folders", traj, "--output_dir", str(root / out),
                "--num_steps", str(steps)] + ARGS + list(extra)

    def resume_from(src, dst):
        """dst holding src's step-2 checkpoint alone."""
        os.makedirs(root / dst / "ckpt")
        shutil.copytree(root / src / "ckpt" / "2", root / dst / "ckpt" / "2")

    ttrain_cli.main(argv("one", 3, "--fsdp", "1"))
    resume_from("one", "mesh_resumed")
    out = torch_ranks.run(torch_ranks.cli_rank, 2, root, [
        argv("mesh", 3, "--fsdp", "2", "--eval_steps", "2"),
        argv("mesh_resumed", 3, "--fsdp", "2")], timeout=150)
    resume_from("one", "one_resumed")
    resume_from("mesh", "one_from_mesh")
    for d in ("one_resumed", "one_from_mesh"):
        ttrain_cli.main(argv(d, 3, "--fsdp", "1"))
    return root, out


def _log(path):
    with open(os.path.join(path, "train_log.jsonl")) as f:
        return [json.loads(line) for line in f]


def _same(got, want):
    assert [r["step"] for r in got] == [r["step"] for r in want]
    for g, w in zip(got, want):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(g[k], w[k], rtol=RTOL, atol=ATOL,
                                       err_msg=f"step {w['step']} {k}")


def test_mesh_command_matches_one_device(runs):
    root, _ = runs
    _same(_log(root / "mesh"), _log(root / "one"))
    assert sorted(os.listdir(root / "mesh" / "ckpt")) == ["2", "3"]


def test_rank_zero_alone_writes(runs):
    root, out = runs
    with open(root / "mesh" / "metrics.jsonl") as f:
        assert [json.loads(line)["step"] for line in f] == [1, 2, 3]
    rank0, rank1 = out[0][0], out[1][0]
    assert rank1 == "" and out[1][1] == ""
    assert "eval_steps: skipped on multi-host runs" in rank0
    lines = [json.loads(line) for line in rank0.splitlines()
             if line.startswith("{")]
    assert [r.get("step") for r in lines if "loss" in r] == [1, 2, 3]
    assert lines[-1] == {"final_step": 3, "done": True}


def test_checkpoints_move_between_mesh_and_one_device(runs):
    root, _ = runs
    want = _log(root / "one_resumed")
    assert [r["step"] for r in want] == [3]
    _same(_log(root / "one_from_mesh"), want)
    _same(_log(root / "mesh_resumed"), want)
