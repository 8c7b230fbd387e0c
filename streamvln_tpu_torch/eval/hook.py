"""Mid-training evaluation hook.

Counterpart of `streamvln_tpu/eval/hook.py`. The reference stack's trainer
shells out to lmms_eval mid-training; here an in-process held-out episode
evaluation (fake-env VLN episodes by default: no simulator or external
harness) runs against the CURRENT training parameters and returns the
aggregated navigation metrics, which train.py folds into train_log.jsonl.
"""
from __future__ import annotations

import gc
import os
import tempfile
from typing import List, Optional

import torch


class MidTrainingEvaluator:
    """Evaluate train-state params on held-out episodes every N steps.

    Builds a fresh StreamingEngine per call (params change every step) and
    drives the standard VLNEvaluator loop over `n_episodes` fake-env
    episodes. The engine serves the live params where they lie, in the
    compute dtype of the device: bf16 on the card, f32 on the CPU. It runs
    without autograd (the LoRA leaves require grad), and the engine, its
    decode graphs and its cache are released before `evaluate` returns,
    so the next training step finds the card as it left it."""

    def __init__(self, cfg, tokenizer, *, n_episodes: int = 4,
                 max_steps_per_episode: int = 12, seed: int = 0,
                 episodes: Optional[List] = None,
                 env_factory=None, max_new_tokens: int = 8,
                 cache_capacity: int = 2048,
                 buckets=(512, 768, 1024)):
        from streamvln_tpu_torch.eval.fake_env import (FakeNavEnv,
                                                       make_episodes)
        self.cfg = cfg
        self.tok = tokenizer
        self.max_steps = max_steps_per_episode
        self.max_new_tokens = max_new_tokens
        self.cache_capacity = cache_capacity
        self.buckets = buckets
        self.episodes = episodes if episodes is not None else \
            make_episodes(n_episodes, seed=seed)
        self.env_factory = env_factory or (
            lambda: FakeNavEnv(self.episodes,
                               max_episode_steps=max_steps_per_episode))

    def evaluate(self, params, step: int) -> dict:
        """Returns {"eval/sucs_all": ..., "eval/spls_all": ..., ...}."""
        from streamvln_tpu_torch.agent import VLNAgent
        from streamvln_tpu_torch.eval.evaluator import VLNEvaluator
        from streamvln_tpu_torch.streaming.engine import StreamingEngine

        device = params["llm"]["embed"].device
        dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
        with torch.no_grad():
            engine = StreamingEngine(
                params, self.cfg, stop_ids=(self.tok.im_end_id,),
                compute_dtype=dtype, max_new_tokens=self.max_new_tokens,
                cache_capacity=self.cache_capacity, buckets=self.buckets,
                # the trainer keeps the live params, so fused copies of
                # q/k/v and gate/up (~4 GB at 7B) would sit beside them
                fuse_proj=False, device=device)
            agent = VLNAgent(engine, self.tok)
            with tempfile.TemporaryDirectory() as tmp:
                ev = VLNEvaluator(
                    self.env_factory(), agent, os.path.join(tmp, "eval"),
                    rank=0, world_size=1,
                    max_steps_per_episode=self.max_steps)
                partial = ev.eval_action()
                agg = ev.aggregate([partial])
        del engine, agent, ev
        gc.collect()
        if device.type == "cuda":
            # the decode graphs' warm-up and capture streams each got a
            # cuBLAS workspace (32 MiB on Hopper) that the handle pool keeps
            # per stream; release them with the engine
            torch._C._cuda_clearCublasWorkspaces()
            torch.cuda.empty_cache()
        return {f"eval/{k}": float(v) for k, v in agg.items()
                if isinstance(v, (int, float))}
