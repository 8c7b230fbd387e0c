"""Latency histograms, tracing, metric logging and running averages of
the PyTorch port.

Own copy of `streamvln_tpu/utils/observability.py`:
- LatencyTracker: per-phase latency records with percentile summaries (p50
  model-call latency is the serving metric);
- trace(): a torch.profiler capture of a code region into log_dir (CPU
  and, where there is a card, CUDA activity), written as a TensorBoard /
  Chrome trace;
- MetricsLogger: JSONL sink + optional wandb mirror, rank-0 gated;
- AverageMeter: running averages, summed across processes by
  `torch.distributed.all_reduce` when a process group is initialized.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np


class LatencyTracker:
    """Per-phase latency records with percentile summaries."""

    def __init__(self, capacity: int = 100_000):
        self.capacity = capacity
        self._data: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def measure(self, phase: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(phase, time.perf_counter() - t0)

    def record(self, phase: str, seconds: float):
        arr = self._data.setdefault(phase, [])
        if len(arr) < self.capacity:
            arr.append(seconds)

    def summary(self, phase: Optional[str] = None) -> dict:
        def one(name):
            a = np.asarray(self._data.get(name, []))
            if a.size == 0:
                return {}
            return {
                "count": int(a.size),
                "mean_ms": float(a.mean() * 1e3),
                "p50_ms": float(np.percentile(a, 50) * 1e3),
                "p90_ms": float(np.percentile(a, 90) * 1e3),
                "p99_ms": float(np.percentile(a, 99) * 1e3),
                "max_ms": float(a.max() * 1e3),
            }
        if phase is not None:
            return one(phase)
        return {name: one(name) for name in self._data}

    def hz(self, phase: str, percentile: float = 50) -> float:
        a = np.asarray(self._data.get(phase, []))
        if a.size == 0:
            return 0.0
        return 1.0 / float(np.percentile(a, percentile))


@contextlib.contextmanager
def trace(log_dir: str, enabled: bool = True):
    """torch.profiler capture around a code region, written into log_dir
    (one trace file per capture, readable by TensorBoard and Chrome's
    trace viewer); CUDA activity is recorded where a card is present."""
    if not enabled:
        yield
        return
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


class MetricsLogger:
    """JSONL metric sink; optional wandb mirror; rank-0 gated."""

    def __init__(self, output_dir: str, rank: int = 0,
                 use_wandb: bool = False, run_name: str = "streamvln"):
        self.rank = rank
        self.path = os.path.join(output_dir, "metrics.jsonl")
        self._wandb = None
        if rank == 0:
            os.makedirs(output_dir, exist_ok=True)
            if use_wandb:
                try:
                    import wandb
                    # Honor WANDB_MODE so unauthenticated hosts/tests can
                    # run offline/disabled instead of blocking on a
                    # networked login.
                    self._wandb = wandb.init(
                        project="streamvln_tpu", name=run_name,
                        mode=os.environ.get("WANDB_MODE", "online"))
                except Exception as e:  # noqa: BLE001 - degrade to JSONL
                    import warnings
                    warnings.warn(f"wandb.init failed ({e!r}); "
                                  "metrics degrade to JSONL only")
                    self._wandb = None

    def log(self, metrics: dict, step: Optional[int] = None):
        if self.rank != 0:
            return
        rec = dict(metrics)
        if step is not None:
            rec["step"] = step
        rec.setdefault("ts", time.time())
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self._wandb is not None:
            wb = {k: v for k, v in metrics.items() if k != "step"}
            self._wandb.log(wb, step=step)

    def close(self):
        if self._wandb is not None:
            try:
                self._wandb.finish()
            finally:
                self._wandb = None


class AverageMeter:
    """Running average; `all_reduce()` folds in the other processes' sums
    through torch.distributed (a no-op without a process group, as one
    process is in the reference)."""

    def __init__(self, name: str = ""):
        self.name = name
        self.reset()

    def reset(self):
        self.sum = 0.0
        self.count = 0

    def update(self, value: float, n: int = 1):
        self.sum += float(value) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)

    def all_reduce(self):
        import torch
        import torch.distributed as dist
        if not (dist.is_available() and dist.is_initialized()) \
                or dist.get_world_size() == 1:
            return self
        device = "cuda" if dist.get_backend() == "nccl" else "cpu"
        vals = torch.tensor([self.sum, float(self.count)],
                            dtype=torch.float64, device=device)
        dist.all_reduce(vals)
        self.sum = float(vals[0])
        self.count = int(vals[1])
        return self
