"""DAgger data collection of the PyTorch port: mixed expert/model
rollouts over the port's agent.

Counterpart of `streamvln_tpu/dagger.py`, with the reference collector's
behaviour (streamvln/streamvln_dagger.py):
- expert probability beta = p ** data_iteration (:162), drawn per action
  segment from Python's `random` seeded with seed + rank, so the port
  makes the same expert/model choices as the JAX collector; when the
  expert takes over it holds for num_future_steps actions (:254-260)
- waypoint advance: while the follower says STOP for the current
  waypoint, move to the next; the final waypoint tightens the goal radius
  to 0.25 (:334-345)
- error tolerance: steps where the taken action differs from the expert's
  count; the expert takes over when the model STOPs far from the goal
  (d >= 3.0), when the count exceeds 0.8 x the per-segment budget, or
  after 12 errors (:350-357)
- save gate: distance_to_goal < 0.5 AND a relative-path-length test, pl <
  0.93 for expert-assisted episodes, pl < 0.85 when the model succeeded
  alone (:405, constants :52-55)
- per-rank annotations_{rank}.json merged by rank 0 (:582-606)

    python -m streamvln_tpu_torch.dagger --output_path <dir> \
        --model_size tiny --device cpu --num_episodes 2 --env_backend fake
"""
from __future__ import annotations

import argparse
import json
import os
import random
from typing import List, Optional

import numpy as np

from streamvln_tpu_torch.eval.fake_env import FakeNavEnv, make_episodes
from streamvln_tpu_torch.eval.shortest_path import make_follower
from streamvln_tpu_torch.trajectory_generation import (episode_name,
                                                       save_frames)
from streamvln_tpu_torch.trajectory_generation import \
    merge as merge_annotations

MIDGOAL_RADIUS = 0.5
GOAL_RADIUS = 0.25
RELATIVE_PATH_LENGTH_THRESHOLD = 0.93
SUCCESS_RELATIVE_PATH_LENGTH_THRESHOLD = 0.85


class DAggerCollector:
    def __init__(self, agent, output_path: str, dataset: str = "fake",
                 p: float = 0.75, data_iteration: int = 0,
                 num_future_steps: int = 4, rank: int = 0,
                 world_size: int = 1, seed: int = 0, max_steps: int = 500):
        self.agent = agent
        self.output_path = output_path
        self.dataset = dataset
        self.beta = 0.0 if p == 0 else p ** data_iteration
        self.nfs = num_future_steps
        self.rank = rank
        self.world_size = world_size
        self.max_steps = max_steps
        self.rng = random.Random(seed + rank)
        # the save gate's decision and metrics of each collected episode
        self.decisions: List[dict] = []
        os.makedirs(output_path, exist_ok=True)

    # ------------------------------------------------------------------
    def collect_episode(self, env: FakeNavEnv, episode,
                        force_expert: bool = False) -> Optional[dict]:
        env.current_episode = episode
        obs = env.reset()
        self.agent.reset_memory(0)
        follower = make_follower(env, MIDGOAL_RADIUS)
        ref_path = episode.reference_path
        ref_actions_len = max(len(ref_path) * 4, 1)

        frames: List[np.ndarray] = []
        actions: List[int] = [-1]     # leading placeholder (the dataset
        # shifts actions by one; reference: streamvln_dagger.py:178)
        action_seq: List[int] = []
        next_wp = 1
        left_expert = 0
        accumulated_error = 0
        model_success = True
        from_expert = force_expert
        force_episode_end = False
        step_id = 0

        while not env.episode_over and step_id < self.max_steps:
            frames.append(obs["rgb"])
            if len(action_seq) == 0 and left_expert == 0:
                from_expert = force_expert or self.rng.random() < self.beta

            run_model = (len(action_seq) == 0 and left_expert == 0
                         and not from_expert)
            model_actions, _, _ = self.agent.step(
                0, obs["rgb"], episode.instruction_text,
                run_model=run_model)

            if len(action_seq) == 0:
                if left_expert > 0:
                    action_seq = [follower.get_next_action(
                        ref_path[next_wp])]
                    left_expert -= 1
                elif from_expert:
                    action_seq = [follower.get_next_action(
                        ref_path[next_wp])]
                    left_expert = self.nfs - 1
                else:
                    action_seq = list(model_actions or [0])
            if not action_seq:
                action_seq = [0]
            action = action_seq.pop(0)

            expert_action = follower.get_next_action(ref_path[next_wp])
            if action != expert_action:
                accumulated_error += 1

            # waypoint advance (reference: streamvln_dagger.py:334-345)
            while follower.get_next_action(ref_path[next_wp]) == 0:
                next_wp += 1
                force_expert = False
                left_expert = 0
                if next_wp == len(ref_path) - 1:
                    follower.goal_radius = GOAL_RADIUS
                if next_wp >= len(ref_path):
                    force_episode_end = True
                    action = 0
                    break

            # expert takeover on intolerable error (:350-357)
            d2g = env.distance_to_goal()
            if next_wp < len(ref_path):
                err_budget = max(1, ref_actions_len // max(
                    len(ref_path) - 1, 1))
                error_not_tolerated = (
                    (not from_expert and action == 0 and d2g >= 3.0)
                    or (accumulated_error / err_budget > 0.8)
                    or accumulated_error > 12)
                if error_not_tolerated:
                    model_success = False
                    force_expert = True
                    accumulated_error = 0
                    action = follower.get_next_action(ref_path[next_wp])
                    action_seq = []

            # a STOP that is not the episode end is replaced by the
            # expert's action (:360-361)
            if action == 0 and not force_episode_end:
                action = follower.get_next_action(ref_path[next_wp])

            obs = env.step(int(action))
            if env.episode_over or force_episode_end:
                break
            actions.append(int(action))
            step_id += 1
            if step_id % self.agent.cfg.num_frames == 0:
                self.agent.engine.reset_for_env(0)
                self.agent.in_dialogue[0] = False
                self.agent.time_ids[0] = []

        metrics = env.get_metrics()
        save = (len(frames) == len(actions)
                and metrics["distance_to_goal"] < MIDGOAL_RADIUS and (
                    ((not model_success)
                     and metrics["pl"] < RELATIVE_PATH_LENGTH_THRESHOLD)
                    or metrics["pl"] <
                    SUCCESS_RELATIVE_PATH_LENGTH_THRESHOLD))
        self.decisions.append({
            "episode_id": str(episode.episode_id), "saved": bool(save),
            "distance_to_goal": float(metrics["distance_to_goal"]),
            "pl": float(metrics["pl"]), "model_success": model_success,
            "steps": step_id})
        if not save:
            return None
        return {
            "id": int(episode.episode_id),
            "video": save_frames(self.output_path,
                                 episode_name(episode, self.dataset),
                                 frames),
            "instructions": [episode.instruction_text],
            "actions": actions,
        }

    # ------------------------------------------------------------------
    def update_dataset(self, env: FakeNavEnv,
                       update_size: Optional[int] = None) -> str:
        annotations = []
        for episode in env.episodes[self.rank::self.world_size]:
            entry = self.collect_episode(env, episode)
            if entry is not None:
                annotations.append(entry)
            if update_size and len(annotations) >= update_size:
                break
        part = os.path.join(self.output_path,
                            f"annotations_{self.rank}.json")
        with open(part, "w") as f:
            json.dump(annotations, f)
        return part


def build_env(backend: str, habitat_config_path: str, split: str,
              num_episodes: int, seed: int, rgb_shape=(480, 640, 3)):
    """habitat when asked for (the geodesic expert on real scenes,
    reference: streamvln_dagger.py:330-357); "auto" takes habitat where
    it imports, else the fake plane env."""
    if backend == "habitat":
        from streamvln_tpu_torch.eval.habitat_backend import (
            make_habitat_env)
        return make_habitat_env(habitat_config_path, split)
    if backend == "auto":
        try:
            from streamvln_tpu_torch.eval.habitat_backend import (
                make_habitat_env)
            return make_habitat_env(habitat_config_path, split)
        except ImportError:
            pass
    return FakeNavEnv(make_episodes(num_episodes, seed=seed),
                      rgb_shape=rgb_shape)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--output_path", required=True)
    p.add_argument("--model_path", default=None)
    p.add_argument("--model_size", default="tiny")
    p.add_argument("--num_episodes", type=int, default=16)
    p.add_argument("--dagger_p", type=float, default=0.75)
    p.add_argument("--dagger_data_it", type=int, default=0)
    p.add_argument("--num_future_steps", type=int, default=4)
    p.add_argument("--rank", type=int, default=0)
    p.add_argument("--world_size", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--env_backend", choices=["habitat", "fake", "auto"],
                   default="auto")
    p.add_argument("--habitat_config_path",
                   default="config/vln_dagger.yaml")
    p.add_argument("--split", default="train")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the kernels) or cpu (their plain versions)")
    args = p.parse_args(argv)

    from streamvln_tpu_torch.eval_cli import build_agent
    agent = build_agent(args.model_path, args.model_size,
                        device=args.device)
    env = build_env(args.env_backend, args.habitat_config_path,
                    args.split, args.num_episodes, args.seed)
    collector = DAggerCollector(
        agent, args.output_path, p=args.dagger_p,
        data_iteration=args.dagger_data_it,
        num_future_steps=args.num_future_steps,
        rank=args.rank, world_size=args.world_size, seed=args.seed)
    collector.update_dataset(env)
    if args.rank == 0:
        merged = merge_annotations(args.output_path, args.world_size)
        print(json.dumps({"collected": len(merged)}))
    return collector


if __name__ == "__main__":
    main()
