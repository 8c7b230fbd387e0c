"""Batched multi-env evaluation of the PyTorch port: N parallel episodes
against one model.

A twin of `streamvln_tpu/eval/batched_evaluator.py`. The reference
parallelizes eval as one env per GPU process (streamvln_eval.py:219
episodes[rank::world]); here one process drives N envs through the
engine's `generate_batch_async` / `collect`, so decode batches across
dialogues and the weights' bandwidth is shared by N envs.

Each env keeps its own dialogue state in the shared VLNAgent; the envs
that need a model call this step go into one batched call, and the other
slots step their simulators meanwhile. Episodes come from a shared queue,
so a fast episode does not idle its slot.
"""
from __future__ import annotations

import json
import os
from typing import Callable, List, Optional

from streamvln_tpu_torch.agent import VLNAgent
from streamvln_tpu_torch.data import chatml
from streamvln_tpu_torch.streaming.engine import StreamingEngine
from streamvln_tpu_torch.utils.constants import MEMORY_PROMPT_EVAL


class BatchedVLNEvaluator:
    def __init__(self, env_factory: Callable[[], object],
                 agent: VLNAgent, output_path: str,
                 max_steps_per_episode: Optional[int] = None):
        """env_factory: builds one env instance per slot (each slot
        steps its own simulator). agent: a VLNAgent whose engine has
        n_envs slots."""
        self.engine: StreamingEngine = agent.engine
        self.agent = agent
        self.agent.memory_prompt = MEMORY_PROMPT_EVAL
        self.n = self.engine.n_envs
        self.envs = [env_factory() for _ in range(self.n)]
        self.output_path = output_path
        self.max_steps = max_steps_per_episode
        os.makedirs(output_path, exist_ok=True)

    def run(self, episodes: List) -> List[dict]:
        queue = list(episodes)
        results = []
        # slot state
        current = [None] * self.n        # episode per slot
        obs = [None] * self.n
        action_q: List[List[int]] = [[] for _ in range(self.n)]
        steps = [0] * self.n

        def start(slot):
            if not queue:
                current[slot] = None
                return
            ep = queue.pop(0)
            current[slot] = ep
            self.envs[slot].current_episode = ep
            obs[slot] = self.envs[slot].reset()
            self.agent.reset_memory(slot)
            action_q[slot] = []
            steps[slot] = 0

        for slot in range(self.n):
            start(slot)

        while any(ep is not None for ep in current):
            # 1. classify slots; build model requests (host-side prep)
            requests = []
            queued_slots = []
            for slot in range(self.n):
                if current[slot] is None:
                    continue
                if action_q[slot]:
                    queued_slots.append(slot)
                else:
                    requests.append(self.agent.prepare_model_step(
                        slot, obs[slot]["rgb"],
                        current[slot].instruction_text))

            # 2. the batched model call (the port's generate_batch_async
            #    returns when its decode loop has ended; collect settles it)
            handle = self.engine.generate_batch_async(
                [r["request"] for r in requests]) if requests else None

            # 3. step the simulators of slots that already have queued
            #    actions. With multi-process env workers
            #    (eval/env_workers.py RemoteEnv) the steps run concurrently
            #    across host cores: dispatch all, then collect.
            stepped = []
            async_slots = []
            for slot in queued_slots:
                self.agent.step(slot, obs[slot]["rgb"],
                                current[slot].instruction_text,
                                run_model=False)
                action = action_q[slot].pop(0)
                env = self.envs[slot]
                if hasattr(env, "step_async"):
                    env.step_async(action)
                    async_slots.append(slot)
                else:
                    obs[slot] = env.step(action)
                steps[slot] += 1
                stepped.append(slot)

            # 4. collect tokens; step the model slots' envs
            if handle is not None:
                outs = self.engine.collect(handle)
                for r in requests:
                    slot = r["slot"]
                    text = self.agent.tok.decode(outs[slot])
                    actions = chatml.parse_actions(text) or [0]
                    self.agent.finish_model_step(slot)
                    action_q[slot] = list(actions)
                    action = action_q[slot].pop(0)
                    env = self.envs[slot]
                    if hasattr(env, "step_async"):
                        env.step_async(action)
                        async_slots.append(slot)
                    else:
                        obs[slot] = env.step(action)
                    steps[slot] += 1
                    stepped.append(slot)

            for slot in async_slots:
                obs[slot] = self.envs[slot].step_wait()

            # 5. episode bookkeeping
            for slot in stepped:
                ep = current[slot]
                if steps[slot] % self.agent.cfg.num_frames == 0:
                    self.engine.reset_for_env(slot)
                    self.agent.in_dialogue[slot] = False
                    self.agent.time_ids[slot] = []
                done = self.envs[slot].episode_over or (
                    self.max_steps and steps[slot] >= self.max_steps)
                if done:
                    m = self.envs[slot].get_metrics()
                    scene_id = ep.scene_id.split("/")[-2] \
                        if "/" in ep.scene_id else ep.scene_id
                    res = {"scene_id": scene_id,
                           "episode_id": ep.episode_id,
                           "success": m["success"], "spl": m["spl"],
                           "os": m["oracle_success"],
                           "ne": m["distance_to_goal"],
                           "steps": steps[slot],
                           "episode_instruction": ep.instruction_text}
                    if "ndtw" in m:
                        res["ndtw"] = m["ndtw"]
                    results.append(res)
                    with open(os.path.join(self.output_path,
                                           "result.json"), "a") as f:
                        f.write(json.dumps(res) + "\n")
                    start(slot)
        return results

    def close(self):
        """Shut down env slots (joins RemoteEnv worker processes)."""
        for env in self.envs:
            if hasattr(env, "close"):
                env.close()
