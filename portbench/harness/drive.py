"""Recording what the program did, for loops that drive its agent.

`Recorder` wraps the engine's public calls on the instance (the program
is not edited): `collect` gives each call's served tokens, its prefill
length and the engine's phase times (`last_phase_ms`, CUDA events).
With `spans` on, each wrapper (`backfill_batch` too) runs inside a
`torch.profiler.record_function` span named after the layer it enters,
and a loop's own steps may open one with `span`, so a device trace can
say what the host was doing.
"""
from __future__ import annotations

import contextlib
from typing import Optional

SPANS = ("agent.prepare", "engine.backfill", "engine.prefill_decode",
         "engine.collect")


class Recorder:
    def __init__(self, agent):
        eng = self.engine = agent.engine
        self.spans = False
        self.last: Optional[dict] = None
        collect, backfill = eng.collect, eng.backfill_batch
        dispatch, prepare = eng.generate_batch_async, agent.prepare_model_step

        def rec_collect(handle):
            with self.span("engine.collect"):
                out = collect(handle)
            self.last = {"tokens": out,
                         "prefill_lens": dict(handle["prefill_lens"]),
                         "phase_ms": eng.last_phase_ms}
            return out

        def rec_backfill(env, frames_u8, step_ids):
            with self.span("engine.backfill"):
                return backfill(env, frames_u8, step_ids)

        def rec_dispatch(*a, **k):
            with self.span("engine.prefill_decode"):
                return dispatch(*a, **k)

        def rec_prepare(*a, **k):
            with self.span("agent.prepare"):
                return prepare(*a, **k)

        eng.collect, eng.backfill_batch = rec_collect, rec_backfill
        eng.generate_batch_async = rec_dispatch
        agent.prepare_model_step = rec_prepare

    def span(self, name: str):
        if not self.spans:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(name)

    def counters(self):
        return self.engine.decode_tokens, self.engine.decode_forwards


def call_record(rec: Recorder, env: int, ep, step: int, kv_before: int,
                t0: float, t1: float, counters0) -> dict:
    """One model call of env `env` at step `step` of episode `ep`, from
    what the recorder saw between `t0` and `t1`."""
    last = rec.last
    toks = [int(t) for t in last["tokens"][env]]
    tok1, fwd1 = rec.counters()
    return {"episode": ep.index, "step": step, "env": env,
            "frame": ep.step_frames[step], "served": toks,
            "prefill_len": int(last["prefill_lens"][env]),
            "kv_before": int(kv_before), "t0": t0, "t1": t1,
            "wall_ms": (t1 - t0) * 1e3, "phase_ms": last["phase_ms"],
            "decode_tokens": tok1 - counters0[0],
            "decode_forwards": fwd1 - counters0[1]}
