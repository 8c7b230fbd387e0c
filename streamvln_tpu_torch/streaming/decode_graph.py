"""Decode forwards replayed as CUDA graphs.

The reference runs each decode loop as one `lax.while_loop` on the device
(`streamvln_tpu/streaming/engine.py`). The port's loops
(`streaming/engine.py`) advance through step functions that read and
write only device tensors: the loop's state (tokens, counters, `done`),
the KV cache at offsets read on the device, and the token-id shadow. On
the card the engine captures each step once per (loop kind, batch,
queries per forward) as a `torch.cuda.CUDAGraph`, and every later decode
forward is one replay followed by one read of the loop's `more` flag.

Capture: a warm-up run of the step on a side stream, on a copy of the
loop state with every row done (it writes nothing: done rows write back
what the cache and the shadow hold and keep their lengths), then
`torch.cuda.graph` over static copies of the state. A sampling step's
generator is registered with the graph, so each replay draws what the
eager step would draw from the generator's current seed and offset.

A graph reads through the addresses it captured. Before each replay the
storage of every tensor the step reads (the cache's k, v and length, the
int8 cache's k_scale and v_scale, the shadow, every weight leaf) is
compared, on the host, with what the capture saw: a rebound tensor raises
instead of being read stale. An edit in place keeps the storage and is
read by the next replay.

Launch counts: a kernel wrapper counts a launch when Python calls it, so
it counts during capture, when nothing runs, and not during a replay,
when its kernel runs. Each graph takes back what its capture counted and
adds that much per replay; the warm-up's launches run and stay counted.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

from streamvln_tpu_torch.ops import decode_attention, flash_attention, \
    int4_matmul

# the launch counters of the kernels a decode step can reach: K8, K6 (and
# K7 above KERNEL_MAX_ROWS rows), K2 (64 or more queries)
COUNTERS = ((decode_attention, "launches"), (int4_matmul, "launches"),
            (int4_matmul, "dequant_launches"), (flash_attention, "launches"))


def _counts() -> list:
    return [getattr(mod, name) for mod, name in COUNTERS]


def _add(delta) -> None:
    for (mod, name), d in zip(COUNTERS, delta):
        setattr(mod, name, getattr(mod, name) + d)


def _storage(reads: Dict[str, torch.Tensor]) -> dict:
    return {name: (t.data_ptr(), tuple(t.shape), t.dtype)
            for name, t in reads.items()}


class StepGraph:
    """One decode step captured as a CUDA graph.

    fn(state) runs one forward in place on `state` (a dict of device
    tensors with a bool `more` flag) and on the engine's cache and shadow,
    and returns a dict of its outputs (logits, drafts). reads() names the
    engine tensors the step reads. After each replay `state` holds the
    loop's state and `outputs` that forward's outputs."""

    def __init__(self, fn: Callable[[dict], dict], state: dict,
                 reads: Callable[[], Dict[str, torch.Tensor]],
                 generator: Optional[torch.Generator] = None):
        t0 = time.perf_counter()
        self.fn, self._reads = fn, reads
        self.state = {k: v.clone() for k, v in state.items()}
        self._storage = _storage(reads())
        self._warm_up(generator)
        base = _counts()
        self.graph = torch.cuda.CUDAGraph()
        if generator is not None:
            self.graph.register_generator_state(generator)
        # only this thread's calls are held out of the capture: another
        # thread (the trainer's prefetch worker, uploading the next batch
        # while the mid-training evaluation captures) may use the CUDA API
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self.outputs = fn(self.state)
        self.per_replay = [a - b for a, b in zip(_counts(), base)]
        _add([-d for d in self.per_replay])
        torch.cuda.synchronize()
        self.capture_s = time.perf_counter() - t0
        self.replays = 0

    def _warm_up(self, generator) -> None:
        warm = {k: v.clone() for k, v in self.state.items()}
        warm["done"].fill_(True)
        rng = None if generator is None else generator.get_state()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self.fn(warm)
        torch.cuda.current_stream().wait_stream(side)
        if rng is not None:
            generator.set_state(rng)

    def load(self, state: dict) -> None:
        """Copy a call's starting state into the static buffers."""
        for k, v in state.items():
            self.state[k].copy_(v)

    def replay(self) -> None:
        """One forward: the captured step on the static state."""
        now = _storage(self._reads())
        if now != self._storage:
            moved = sorted(k for k in set(now) | set(self._storage)
                           if now.get(k) != self._storage.get(k))
            raise RuntimeError(
                f"decode graph: {moved} no longer hold the storage the "
                f"graph captured (rebound, not edited in place); a replay "
                f"would read the old tensors")
        self.graph.replay()
        _add(self.per_replay)
        self.replays += 1
