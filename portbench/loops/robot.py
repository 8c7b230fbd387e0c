"""The robot's closed loop (a mix with `"loop": "robot"`): one env,
episodes back to back, `VLNAgent.step` at every env step, a model call at
the steps the mix's cadence names; the next step starts when the last
returned. A call's record runs from the agent's entry on a model step to
its actions on the host.

`correct`: the served tokens of a sample of the window's dialogue windows
judged by the plain reference (portbench/harness/check.py), and no call
short of its token budget without a stop token, refused or out of the
vocabulary.
"""
from __future__ import annotations

import gc
import itertools
import sys
import time
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from portbench.harness import check, drive, system, traffic
from portbench.harness.traffic import Episode
from portbench.reference import bpe, weights


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


class Driver:
    def __init__(self, agent, rec: drive.Recorder,
                 episodes: Iterator[Episode], pool: np.ndarray,
                 call_every: int):
        self.agent, self.rec, self.queue = agent, rec, episodes
        self.pool, self.every = pool, call_every
        self.episodes: Dict[int, Episode] = {}
        self.ep: Optional[Episode] = None
        self.s = 0
        self.steps: List[float] = []      # completion time of each env step
        self.failures: List[str] = []

    def run(self, until: Optional[float] = None,
            count: Optional[int] = None) -> List[dict]:
        """Step until the clock passes `until` or `count` calls are done;
        returns the calls' records."""
        agent, eng, rec = self.agent, self.agent.engine, self.rec
        calls: List[dict] = []
        while (until is None or time.perf_counter() < until) and \
                (count is None or len(calls) < count):
            if self.ep is None or self.s >= self.ep.length:
                agent.reset_memory(0)
                self.ep = next(self.queue)
                self.episodes[self.ep.index] = self.ep
                self.s = 0
            ep, s = self.ep, self.s
            frame = self.pool[ep.step_frames[s]]
            if s % self.every == 0:
                kv0, c0 = eng.envs[0].kv_length, rec.counters()
                t0 = time.perf_counter()
                try:
                    with rec.span("agent.call"):
                        agent.step(0, frame, ep.instruction, run_model=True)
                except RuntimeError as e:       # a refusal: next episode
                    self.failures.append(str(e))
                    self.ep = None
                    continue
                t1 = time.perf_counter()
                calls.append(drive.call_record(rec, 0, ep, s, kv0, t0, t1,
                                               c0))
            else:
                with rec.span("agent.env_step"):
                    agent.step(0, frame, ep.instruction, run_model=False)
            self.steps.append(time.perf_counter())
            self.s += 1
        return calls


def summary(calls: List[dict]) -> None:
    """Per-class means of the calls (by prompt bucket), and the decode
    loop's tokens per forward, on standard error."""
    by: Dict[int, List[dict]] = {}
    for c in calls:
        b = 256
        while b < c["prefill_len"]:
            b *= 2 if b < 2048 else 1.25
        by.setdefault(int(b), []).append(c)
    for b, cs in sorted(by.items()):
        ph = [c["phase_ms"] for c in cs if c["phase_ms"]]
        mean = [sum(p[i] for p in ph) / len(ph) for i in range(3)] \
            if ph else []
        log(f"  prompts <= {b}: {len(cs)} calls, wall "
            f"{sum(c['wall_ms'] for c in cs) / len(cs):.3f} ms, phases "
            f"{[round(m, 3) for m in mean]} ms, forwards per call "
            f"{sum(c['decode_forwards'] for c in cs) / len(cs):.3f}")
    fwd = sum(c["decode_forwards"] for c in calls)
    if fwd:
        log(f"  tokens per decode forward "
            f"{sum(c['decode_tokens'] for c in calls) / fwd:.4f}")


class System:
    """The agent over its streaming engine, built from the seed and warmed
    up (the set-up), driven by the robot's loop."""
    SPANS = ("agent.call", "agent.env_step") + drive.SPANS

    def __init__(self, cfg: dict, mix: dict, wl: dict, seed: int, device,
                 control: bool = False):
        self.cfg, self.mix, self.wl, self.seed = cfg, mix, wl, seed
        self.device = device
        self.dtype = system.DTYPES[cfg["dtype"]]
        self.ctl = cfg.get("control", {}) if control else {}
        self.tok = bpe.Tokenizer()
        t0 = time.perf_counter()
        system.build_kernels(device)
        t1 = time.perf_counter()
        self.agent = system.build_agent(
            cfg, lambda: weights.make(cfg, seed, device, self.dtype),
            self.tok, 1, device, bits=self.ctl.get("program_bits"))
        t2 = time.perf_counter()
        self.rec = drive.Recorder(self.agent)
        self.pool = traffic.frame_pool(mix, seed, device)
        self._warm_up()
        self.setup_split = {"kernels": t1 - t0, "build": t2 - t1,
                            "warm-up": time.perf_counter() - t2}
        self.driver = Driver(self.agent, self.rec,
                             traffic.episodes(mix, seed), self.pool,
                             mix["call_every"])

    def _warm_up(self) -> None:
        """Episodes of `warmup_steps` steps with the mix's shortest and
        longest instruction: every bucket (first call, later calls, the
        memory call) and the decode graphs, captured at first use."""
        mix, n = self.mix, self.mix["warmup_steps"]
        eps = [Episode(-1 - i, text, n, [i % mix["frames"]] * n)
               for i, text in enumerate(
                   traffic.extreme_instructions(mix, self.seed))]
        d = Driver(self.agent, self.rec, itertools.cycle(eps), self.pool,
                   mix["call_every"])
        d.run(count=2 * (n // mix["call_every"] + 1))
        self.agent.reset_memory(0)

    def set_spans(self, on: bool) -> None:
        self.rec.spans = on

    def run(self, until: Optional[float] = None,
            count: Optional[int] = None) -> List[dict]:
        return self.driver.run(until=until, count=count)

    def window(self, calls: List[dict], t_w0: float, t_w1: float) -> dict:
        """The window's fields of `ctx`: the calls it completed and its env
        steps."""
        done = [c for c in calls if c["t1"] <= t_w1]
        steps = sum(1 for t in self.driver.steps if t_w0 <= t <= t_w1)
        summary(done)
        log(f"window: {len(done)} calls, {steps} env steps, "
            f"{len(self.driver.failures)} refused")
        self.done = done
        return {"calls": done, "steps": steps}

    def segment(self, calls: List[dict]) -> dict:
        """The traced segment's fields of `ctx["trace"]`."""
        return {"calls": calls}

    def judge(self) -> dict:
        """Free the program, then judge the window's calls with the plain
        reference: `correct`, `attempted`, `failed`, `checks` (each number
        compared, with the most it may read) and `judged`."""
        cfg, tok, done = self.cfg, self.tok, self.done
        # a call ends at its token budget or at a stop token, never earlier
        stops = {tok.im_end_id, tok.eos_id}
        short = sum(1 for c in done if len(c["served"]) < cfg["serving"][
            "max_new_tokens"] and not (c["served"] and
                                       c["served"][-1] in stops))
        episodes, refused = self.driver.episodes, len(self.driver.failures)
        self.agent = self.rec = self.driver = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        t_ref = time.perf_counter()
        wins = check.windows_of(done, episodes, cfg["num_frames"])
        # a window that completed no call has nothing to judge: not correct
        judged = check.judge(
            cfg, self.seed, self.device, tok,
            check.sample(wins, self.wl["check"]["windows"], self.seed),
            self.pool, self.dtype,
            control_bits=self.ctl.get("reference_bits")) if wins else {
            "max_gap": float("inf"), "tokens": 0, "flips": 0,
            "out_of_vocab": 0, "windows": 0}
        log(f"reference: {time.perf_counter() - t_ref:.3f} s over "
            f"{judged['windows']} windows, {judged['tokens']} tokens")
        gap = judged.get("control_max_gap", judged["max_gap"])
        checks = {"max_gap": {"value": gap,
                              "limit": self.wl["check"]["max_gap"]},
                  "out_of_vocab": {"value": judged["out_of_vocab"],
                                   "limit": 0},
                  "short_calls": {"value": short, "limit": 0},
                  "refused_calls": {"value": refused, "limit": 0}}
        correct = judged["tokens"] > 0 and all(
            c["value"] <= c["limit"] for c in checks.values())
        return {"correct": bool(correct), "attempted": len(done) + refused,
                "failed": refused, "checks": checks, "judged": judged}
