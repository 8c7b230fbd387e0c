"""Oracle trajectory generation of the PyTorch port: replay episodes with
the shortest-path expert and write the training data format.

Counterpart of `streamvln_tpu/trajectory_generation.py` (reference:
streamvln/streamvln_trajectory_generation.py:48-168). Per episode the
expert follows the reference path's waypoints with goal radius 0.5 (0.25
on the final waypoint); each step's RGB frame goes to
`images/<scene>_<dataset>_<episode>/rgb/NNN.jpg` and the annotations
collect `{id, video, instructions, actions}`. Episodes are sharded by rank
(`episodes[rank::world_size]`), each rank writes `annotations_<rank>.json`
and rank 0 merges them. Host only: no model and no kernel.

    python -m streamvln_tpu_torch.trajectory_generation --output_path <dir> \
        --num_episodes 16 --env_backend fake
"""
from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional

import numpy as np

from streamvln_tpu_torch.eval.fake_env import FakeNavEnv, make_episodes
from streamvln_tpu_torch.eval.shortest_path import make_follower

WAYPOINT_RADIUS = 0.5
FINAL_RADIUS = 0.25


def episode_name(episode, dataset: str) -> str:
    """`<scene>_<dataset>_<episode:06d>`, the reference's folder name."""
    scene_id = episode.scene_id.split("/")[-2] \
        if "/" in episode.scene_id else episode.scene_id
    return f"{scene_id}_{dataset}_{int(episode.episode_id):06d}"


def save_frames(output_path: str, name: str, frames) -> str:
    """Write frames as images/<name>/rgb/001.jpg, ...; returns the video
    path relative to output_path."""
    from PIL import Image
    rgb_dir = os.path.join(output_path, "images", name, "rgb")
    os.makedirs(rgb_dir, exist_ok=True)
    for i, frame in enumerate(frames):
        Image.fromarray(frame).save(os.path.join(rgb_dir, f"{i + 1:03d}.jpg"))
    return os.path.join("images", name)


def generate_episode(env: FakeNavEnv, episode, dataset: str,
                     output_path: str, max_steps: int = 500
                     ) -> Optional[dict]:
    """One expert episode. Actions start with a -1 placeholder (the
    dataset shifts them by one), a frame is recorded each iteration before
    acting, the episode ends when the waypoint list is exhausted (no STOP
    is stepped), and episodes of more than 498 actions are dropped."""
    env.current_episode = episode
    obs = env.reset()
    follower = make_follower(env, WAYPOINT_RADIUS)
    ref_path = episode.reference_path
    assert ref_path is not None

    frames: List[np.ndarray] = []
    actions: List[int] = [-1]
    wp = 1
    while not env.episode_over and len(actions) <= max_steps:
        frames.append(obs["rgb"])
        action = follower.get_next_action(ref_path[wp])
        force_over = False
        while action == 0:
            wp += 1
            if wp == len(ref_path) - 1:
                follower.goal_radius = FINAL_RADIUS
            if wp >= len(ref_path):
                force_over = True
                break
            action = follower.get_next_action(ref_path[wp])
        if force_over:
            break
        obs = env.step(int(action))
        actions.append(int(action))

    if len(actions) > 498 or len(actions) != len(frames):
        return None
    return {
        "id": int(episode.episode_id),
        "video": save_frames(output_path, episode_name(episode, dataset),
                             frames),
        "instructions": [episode.instruction_text],
        "actions": actions,
    }


def run(env: FakeNavEnv, output_path: str, dataset: str = "fake",
        rank: int = 0, world_size: int = 1, max_steps: int = 500) -> str:
    """This rank's episodes; returns its annotations file."""
    os.makedirs(output_path, exist_ok=True)
    annotations = []
    for episode in env.episodes[rank::world_size]:
        entry = generate_episode(env, episode, dataset, output_path,
                                 max_steps)
        if entry is not None:
            annotations.append(entry)
    part = os.path.join(output_path, f"annotations_{rank}.json")
    with open(part, "w") as f:
        json.dump(annotations, f)
    return part


def merge(output_path: str, world_size: int) -> list:
    """Rank 0's merge of the ranks' annotation files into
    annotations.json."""
    merged = []
    for r in range(world_size):
        part = os.path.join(output_path, f"annotations_{r}.json")
        if os.path.exists(part):
            with open(part) as f:
                merged.extend(json.load(f))
    with open(os.path.join(output_path, "annotations.json"), "w") as f:
        json.dump(merged, f)
    return merged


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--output_path", required=True)
    p.add_argument("--num_episodes", type=int, default=16)
    p.add_argument("--dataset", default="fake")
    p.add_argument("--rank", type=int, default=0)
    p.add_argument("--world_size", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--rgb_height", type=int, default=480)
    p.add_argument("--rgb_width", type=int, default=640)
    p.add_argument("--env_backend", choices=["habitat", "fake", "auto"],
                   default="auto")
    p.add_argument("--observable_goal", action="store_true",
                   help="fake env only: render goal bearing/distance "
                        "into the frames (learnable observations for "
                        "closed-loop train->eval validation)")
    p.add_argument("--habitat_config_path",
                   default="config/vln_r2r.yaml")
    p.add_argument("--split", default="train")
    args = p.parse_args(argv)
    if args.env_backend != "fake":
        from streamvln_tpu_torch.dagger import build_env
        env = build_env(args.env_backend, args.habitat_config_path,
                        args.split, args.num_episodes, args.seed,
                        rgb_shape=(args.rgb_height, args.rgb_width, 3))
    else:
        env = FakeNavEnv(make_episodes(args.num_episodes, seed=args.seed),
                         rgb_shape=(args.rgb_height, args.rgb_width, 3),
                         observable_goal=args.observable_goal)
    run(env, args.output_path, args.dataset, args.rank, args.world_size)
    if args.rank == 0:
        merged = merge(args.output_path, args.world_size)
        print(json.dumps({"episodes": len(merged)}))


if __name__ == "__main__":
    main()
