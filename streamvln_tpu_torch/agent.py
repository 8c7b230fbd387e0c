"""Sim-free streaming VLN agent of the PyTorch port:
`step(idx, rgb, instruction, run_model)`.

A twin of `streamvln_tpu/agent.py` (which imports the JAX engine) over the
port's StreamingEngine, with the same behaviour:

- per step, the RGB frame is recorded; the model runs only when the action
  queue is empty (`run_model=True`)
- first call of a window sends system + instruction prompt (with the
  memory clause and <memory> token when step_id != 0); subsequent calls
  send an empty user turn
- every call appends '<conjunction> <image>.' to the user turn
- window reset every `num_frames` env steps clears dialogue state
- actions are regex-parsed from the decoded text; empty parse -> [STOP]

History memory gathers cached pooled frame features; frames that never
saw a model call are encoded on demand through the engine's backfill.
Depth/pose/intrinsic inputs are accepted for API parity and unused.
"""
from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np

from streamvln_tpu_torch.configs import StreamVLNConfig
from streamvln_tpu_torch.data import chatml
from streamvln_tpu_torch.data.tokenizer import Tokenizer
from streamvln_tpu_torch.streaming.engine import StreamingEngine
from streamvln_tpu_torch.utils.constants import (
    DEFAULT_MEMORY_TOKEN, MEMORY_PROMPT_AGENT, NAV_PROMPT,
    NAV_PROMPT_SUFFIX)


class VLNAgent:
    """One streaming dialogue per env on top of a shared StreamingEngine."""

    def __init__(self, engine: StreamingEngine, tokenizer: Tokenizer, *,
                 memory_prompt: str = MEMORY_PROMPT_AGENT,
                 deterministic_conjunction: bool = True,
                 rng: Optional[np.random.Generator] = None):
        self.engine = engine
        self.tok = tokenizer
        self.cfg: StreamVLNConfig = engine.cfg
        self.memory_prompt = memory_prompt
        self.rng = None if deterministic_conjunction else \
            (rng or np.random.default_rng(0))
        n = engine.n_envs
        self.step_id = [0] * n
        self.time_ids: List[List[int]] = [[] for _ in range(n)]
        self.in_dialogue = [False] * n   # output_ids is not None, in ref
        self.action_seq: List[List[int]] = [[] for _ in range(n)]
        # episode-global frame store (uint8, host) for history backfill
        self.rgb_list: List[List[np.ndarray]] = [[] for _ in range(n)]

    # ------------------------------------------------------------------
    def reset_memory(self, idx: int = 0):
        """Full episode reset (reference: streamvln_agent.py:87-99)."""
        self.step_id[idx] = 0
        self.time_ids[idx] = []
        self.in_dialogue[idx] = False
        self.action_seq[idx] = []
        self.rgb_list[idx] = []
        self.engine.reset_episode(idx)

    # ------------------------------------------------------------------
    def _build_turn(self, idx: int, instruction: str,
                    with_memory: bool) -> np.ndarray:
        """Token ids for this call's user turn (+ generation prompt)."""
        if not self.in_dialogue[idx]:
            base = NAV_PROMPT.replace("<instruction>.", instruction) \
                + NAV_PROMPT_SUFFIX
            if with_memory:
                base += self.memory_prompt.format(DEFAULT_MEMORY_TOKEN)
            add_system = True
        else:
            base = ""
            add_system = False
        user_text = chatml.observation_prompt(self.rng, base)
        ids, _ = chatml.tokenize_dialogue(
            self.tok, [("user", user_text)], add_system=add_system,
            with_labels=False)
        gen = np.asarray(chatml.generation_prompt(self.tok), np.int32)
        return np.concatenate([ids, gen])

    def _history_steps(self, idx: int) -> List[int]:
        """Episode-global history step ids for the slow memory
        (reference: streamvln_agent.py:223-232)."""
        t0 = self.time_ids[idx][0]
        if self.cfg.num_history is None:
            stride = self.cfg.num_future_steps
        else:
            stride = max(t0 // self.cfg.num_history, 1)
        return list(range(0, t0, stride))

    # ------------------------------------------------------------------
    def prepare_model_step(self, idx: int, rgb: np.ndarray,
                           instruction_text: str = "") -> dict:
        """Host-side half of a model step: record the frame, build the
        turn (+memory/history), backfill missing history features.
        Returns the engine request for generate/generate_batch; call
        finish_model_step(idx) after the engine call."""
        self.time_ids[idx].append(self.step_id[idx])
        self.rgb_list[idx].append(rgb)
        step = self.step_id[idx]
        boundary = (not self.in_dialogue[idx]) and step != 0
        # History is injected at EVERY first post-reset call, aligned or
        # not: the reference adds the memory clause whenever
        # output_ids is None and step_id != 0 (streamvln_eval.py:295-297,
        # streamvln_agent.py:205-207), and the training data always pairs
        # the clause with num_history frames (vln_action_dataset.py:
        # 753-773). The reference's image stacking is gated on
        # step_id % num_frames == 0 (streamvln_eval.py:313-321), which in
        # the misaligned case (LLM emitted != num_future_steps actions)
        # leaves the <memory> token with memory_features=None and
        # crashes in the splice (stream_video_vln.py:126, 228-231) — so
        # we follow the clause's (and the training distribution's)
        # intent instead: history sampled from time_ids[0], which is
        # the window-reset step in both regimes. Frames that never saw a
        # model call are encoded on demand via backfill. A window's first
        # call that follows only non-model steps from step 0 (an offline
        # video's last frame, a DAgger rollout the expert began) has no
        # history to show: it gets no memory clause, where the JAX package
        # adds the clause and its splice reads the <memory> rows past the
        # vision pool (ROADMAP §3, item 9).
        history = self._history_steps(idx) if boundary else []
        turn_ids = self._build_turn(idx, instruction_text,
                                    with_memory=bool(history))
        if history:
            # one dispatch for ALL missing history frames (engine
            # dedupes already-encoded steps)
            self.engine.backfill_batch(
                idx, [self.rgb_list[idx][s] for s in history], history)
        return {"slot": idx,
                "request": (idx, rgb, turn_ids, step, tuple(history))}

    def finish_model_step(self, idx: int):
        self.in_dialogue[idx] = True
        self._advance(idx)

    def _advance(self, idx: int):
        """Advance the env step counter and perform window-reset
        bookkeeping when the new step lands on a num_frames boundary.
        Shared by model and non-model steps: a model call whose action
        queue empties exactly at a boundary (possible whenever the LLM
        emits != num_future_steps actions) must reset too, or the
        dialogue silently runs a double-length window until the prompt
        overflows. External drivers that also reset at boundaries
        (reference parity: streamvln_eval.py:346-350) stay correct —
        the reset is idempotent."""
        self.step_id[idx] += 1
        if self.step_id[idx] % self.cfg.num_frames == 0:
            self.engine.reset_for_env(idx)
            self.in_dialogue[idx] = False
            self.time_ids[idx] = []

    def step(self, idx: int, rgb: np.ndarray, instruction_text: str = "",
             run_model: bool = False, depth: Optional[np.ndarray] = None,
             pose: Optional[np.ndarray] = None,
             intrinsic: Optional[np.ndarray] = None,
             temperature: Optional[float] = None,
             top_p: Optional[float] = None
             ) -> Tuple[Optional[List[int]], float, Optional[str]]:
        """One env step. Returns (action_seq, generate_time, llm_text);
        (None, 0, None) on non-model steps — reference signature parity
        (streamvln_agent.py:169-258). depth/pose/intrinsic are accepted
        for API parity and unused by the released RGB-only path
        (reference: streamvln_agent.py:171-174, SURVEY §2.7)."""
        if not run_model:
            self.time_ids[idx].append(self.step_id[idx])
            self.rgb_list[idx].append(rgb)
            # window-reset bookkeeping on the step BEFORE the boundary
            # call (reference: streamvln_agent.py:192-199) — shared
            # with the model branch via _advance
            self._advance(idx)
            return None, 0.0, None

        req = self.prepare_model_step(idx, rgb, instruction_text)
        t0 = time.perf_counter()
        out_tokens = self.engine.generate_batch(
            [req["request"]], temperature=temperature, top_p=top_p)[idx]
        gen_time = time.perf_counter() - t0
        self.finish_model_step(idx)

        text = self.tok.decode(out_tokens)
        actions = chatml.parse_actions(text)
        if not actions:
            actions = [0]
        self.action_seq[idx] = list(actions)
        return actions, gen_time, text
