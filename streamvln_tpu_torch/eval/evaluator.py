"""Episode-loop evaluator of the PyTorch port (the reference's
streamvln_eval harness).

A twin of `streamvln_tpu/eval/evaluator.py` over the port's agent: scene-
grouped episodes, rank-sharded `episodes[rank::world]`, a streaming
dialogue per episode with an action queue, the window reset every
num_frames steps after `env.step`, result.json resume, and aggregate
SR/SPL/OS/NE (nDTW where episodes have reference paths) with the
model-call p50/p90 latency.

Env backends plug in through the habitat.Env-shaped surface
(reset/step/episode_over/get_metrics/episodes/current_episode): the port's
FakeNavEnv; the habitat backend is a later slice of the port. Distributed
eval shards episodes across processes; aggregation is host-side.
"""
from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np

from streamvln_tpu_torch.agent import VLNAgent
from streamvln_tpu_torch.utils.constants import MEMORY_PROMPT_EVAL
from streamvln_tpu_torch.utils.observability import LatencyTracker


class VLNEvaluator:
    """Runs episodes through a VLNAgent; owns resume + results files."""

    def __init__(self, env, agent: VLNAgent, output_path: str,
                 rank: int = 0, world_size: int = 1,
                 epoch: int = 0, save_obs: bool = False,
                 save_video: bool = False,
                 max_steps_per_episode: Optional[int] = None):
        self.env = env
        self.agent = agent
        # eval uses the eval-flavoured memory clause + random conjunction
        # (reference: streamvln_eval.py:295, 424)
        self.agent.memory_prompt = MEMORY_PROMPT_EVAL
        self.output_path = output_path
        self.rank = rank
        self.world_size = world_size
        self.epoch = epoch
        self.save_video = save_video
        self.max_steps = max_steps_per_episode
        os.makedirs(output_path, exist_ok=True)
        # p50 model-call latency is the serving metric; tracked per phase
        self.latency = LatencyTracker()

    # ------------------------------------------------------------------
    def _result_file(self) -> str:
        return os.path.join(self.output_path, "result.json")

    def _load_done(self) -> List[list]:
        done = []
        path = self._result_file()
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    try:
                        res = json.loads(line)
                    except json.JSONDecodeError:
                        continue
                    if "episode_id" in res:
                        done.append([res["scene_id"], res["episode_id"],
                                     res.get("episode_instruction")])
        return done

    # ------------------------------------------------------------------
    def run_episode(self, episode) -> dict:
        env = self.env
        agent = self.agent
        env.current_episode = episode
        observations = env.reset()
        agent.reset_memory(0)

        action_queue: List[int] = []
        step_id = 0
        nf = agent.cfg.num_frames
        vis_frames: List = []
        sim = getattr(env, "sim", None)
        if self.save_video and sim is not None \
                and hasattr(sim, "pathfinder"):
            # the reference draws a simulator's navmesh occupancy map here
            raise NotImplementedError(
                "save_video over a simulator with a navmesh "
                "(habitat_extensions/maps.py) is ROADMAP queue 1 item 10 "
                "of the PyTorch port")
        while not env.episode_over:
            if self.save_video:
                from streamvln_tpu_torch.utils.visualize import (
                    append_text_underneath_image)
                vis_frames.append(append_text_underneath_image(
                    observations["rgb"],
                    f"step {step_id}: {episode.instruction_text[:60]}"))
            run_model = len(action_queue) == 0
            with self.latency.measure("env_step" if not run_model
                                      else "model_call"):
                actions, gen_t, _ = agent.step(
                    0, observations["rgb"], episode.instruction_text,
                    run_model=run_model)
            if run_model:
                self.latency.record("generate", gen_t)
                action_queue = list(actions)
            action = action_queue.pop(0)
            with self.latency.measure("sim_step"):
                observations = env.step(action)
            step_id += 1
            # window reset AFTER env.step (reference:
            # streamvln_eval.py:346-350); the agent's internal non-model
            # branch also resets, this covers the model-step boundary
            if step_id % nf == 0:
                agent.engine.reset_for_env(0)
                agent.in_dialogue[0] = False
                agent.time_ids[0] = []
            if self.max_steps is not None and step_id >= self.max_steps:
                break

        metrics = env.get_metrics()
        scene_id = episode.scene_id.split("/")[-2] \
            if "/" in episode.scene_id else episode.scene_id
        if self.save_video and vis_frames:
            from streamvln_tpu_torch.utils.visualize import (
                draw_top_down_map, images_to_video)
            vis_dir = os.path.join(self.output_path,
                                   f"vis_{self.epoch}")
            images_to_video(vis_frames, vis_dir,
                            f"{scene_id}_{episode.episode_id}")
            tracker = getattr(env, "_tracker", None)
            if tracker is not None and tracker.positions:
                # no simulator pathfinder: abstract trajectory plot
                topdown = draw_top_down_map(
                    tracker.positions, tracker.goal,
                    getattr(episode, "reference_path", None))
                from PIL import Image
                Image.fromarray(topdown).save(os.path.join(
                    vis_dir,
                    f"{scene_id}_{episode.episode_id}_map.png"))
        result = {
            "scene_id": scene_id,
            "episode_id": episode.episode_id,
            "success": metrics["success"],
            "spl": metrics["spl"],
            "os": metrics["oracle_success"],
            "ne": metrics["distance_to_goal"],
            "steps": step_id,
            "episode_instruction": episode.instruction_text,
        }
        if "ndtw" in metrics:
            result["ndtw"] = metrics["ndtw"]
        return result

    # ------------------------------------------------------------------
    def eval_action(self) -> dict:
        """Run this rank's episode shard. Returns partial sums."""
        done = self._load_done()
        sucs, spls, oss, ones, ndtws = [], [], [], [], []
        # resume: re-read already-finished episodes' numbers (rank 0 only,
        # mirroring streamvln_eval.py:203-212)
        if self.rank == 0:
            path = self._result_file()
            if os.path.exists(path):
                with open(path) as f:
                    for line in f:
                        try:
                            res = json.loads(line)
                        except json.JSONDecodeError:
                            continue
                        if "episode_id" in res:
                            sucs.append(res["success"])
                            spls.append(res["spl"])
                            oss.append(res["os"])
                            ones.append(res["ne"])
                            if "ndtw" in res:
                                ndtws.append(res["ndtw"])

        scene_groups = {}
        for ep in self.env.episodes:
            scene_groups.setdefault(ep.scene_id, []).append(ep)

        for scene in sorted(scene_groups):
            for episode in scene_groups[scene][self.rank::self.world_size]:
                scene_id = episode.scene_id.split("/")[-2] \
                    if "/" in episode.scene_id else episode.scene_id
                if [scene_id, episode.episode_id,
                        episode.instruction_text] in done:
                    continue
                result = self.run_episode(episode)
                sucs.append(result["success"])
                spls.append(result["spl"])
                oss.append(result["os"])
                ones.append(result["ne"])
                if "ndtw" in result:
                    ndtws.append(result["ndtw"])
                with open(self._result_file(), "a") as f:
                    f.write(json.dumps(result) + "\n")

        return {"sucs": sucs, "spls": spls, "oss": oss, "ones": ones,
                "ndtws": ndtws}

    # ------------------------------------------------------------------
    def aggregate(self, partials: List[dict]) -> dict:
        """Merge per-rank partials into the final line (reference:
        streamvln_eval.py:570-581)."""
        sucs = sum((p["sucs"] for p in partials), [])
        spls = sum((p["spls"] for p in partials), [])
        oss = sum((p["oss"] for p in partials), [])
        ones = sum((p["ones"] for p in partials), [])
        ndtws = sum((p.get("ndtws", []) for p in partials), [])
        n = max(len(sucs), 1)
        out = {
            "sucs_all": float(np.sum(sucs)) / n,
            "spls_all": float(np.sum(spls)) / n,
            "oss_all": float(np.sum(oss)) / n,
            "ones_all": float(np.sum(ones)) / n,
            "length": len(sucs),
        }
        if ndtws:
            out["ndtw_all"] = float(np.mean(ndtws))
        lat = self.latency.summary("model_call")
        if lat:
            out["model_call_p50_ms"] = lat["p50_ms"]
            out["model_call_p90_ms"] = lat["p90_ms"]
        if self.rank == 0:
            # trailing newline matters: a resumed run appends its own
            # aggregate, and without it the two JSON objects concatenate
            # onto one unparseable line
            with open(self._result_file(), "a") as f:
                f.write(json.dumps(out) + "\n")
        return out
