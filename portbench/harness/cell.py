"""One run of one cell: set-up, the measured window, the traced segment
(with `trace`), the metrics, and the check of the window's output.

The cell's mix names its loop, a module found by name
(`portbench/loops/<loop>.py`, `spec.loop`) that exports `System`:

- `System(cfg, mix, wl, seed, device, control)` is the set-up: the
  system under test built from the seed (`control`: the cell's control in
  its place) and every shape the mix uses warmed up; `setup_split` names
  its stages' seconds;
- `run(until=None, count=None)` drives it until the host clock passes
  `until` or `count` units (calls, waves, steps) are done, and returns a
  record of each;
- `window(records, t_w0, t_w1)` gives the window's fields of `ctx`, which
  the metric readers read; `segment(records)` those of the traced
  segment, under `ctx["trace"]`; `SPANS` and `set_spans(on)` name and
  switch the spans the traced segment records;
- `judge()`, once the device peak is read, frees the program and judges
  what the window produced against the plain reference: `correct`,
  `attempted`, `failed`, `checks` (each number compared beside its limit)
  and `judged`.

`setup_s` runs from the process start to the window's start. The window
is the loop for `seconds` on the host clock; with `trace`, the same loop
goes on for `trace_calls` units under the profiler.
"""
from __future__ import annotations

import subprocess
import sys
import time
from typing import Optional

import numpy as np
import torch

from portbench.harness import spec, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "streamvln_tpu")


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (the port's name begins with the JAX package's)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def smi(fields: str) -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unavailable ({e})"


def host_probe_ms() -> float:
    """A fixed piece of host work (Python loop and a small numpy product),
    timed: hosts differ by tens of percent, and this says which one ran."""
    t0 = time.perf_counter()
    acc = 0
    for i in range(1_000_000):
        acc += i * i
    a = np.random.default_rng(0).standard_normal((256, 256))
    for _ in range(50):
        a = np.tanh(a @ a.T / 256.0)
    return (time.perf_counter() - t0) * 1e3


def run(name: str, seed: int, seconds: float, traced: bool, device,
        t_start: float, bench: Optional[dict] = None,
        base: str = spec.PORTBENCH, control: bool = False) -> dict:
    """The result line's object for one run of cell `name` (the control
    with `control`)."""
    bench = bench if bench is not None else spec.benchmark()
    wl = spec.workload(name, base)
    cfg = spec.config(wl["config"], base)
    mix = spec.mix(wl["traffic"], wl.get("traffic_params"), base)
    cuda = device.type == "cuda"
    sut = spec.loop(mix["loop"], base).System(cfg, mix, wl, seed, device,
                                              control)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    log(f"setup {setup_s:.3f} s (" + ", ".join(
        f"{k} {v:.3f}" for k, v in sut.setup_split.items()) + ")")
    if cuda:
        log("nvidia-smi before:", smi("name,clocks.sm,clocks.mem,"
                                      "power.draw,power.limit,"
                                      "temperature.gpu"))

    t_w0 = time.perf_counter()
    t_w1 = t_w0 + seconds
    records = sut.run(until=t_w1)
    t_closed = time.perf_counter()
    if cuda:
        log("nvidia-smi after:", smi("clocks.sm,power.draw,temperature.gpu"))
    log(f"host probe {host_probe_ms():.3f} ms")
    log(f"window of {seconds} s: the last unit closed "
        f"{t_closed - t_w0:.3f} s after the start")
    ctx = {"cfg": cfg, "mix": mix, "window_s": seconds, "setup_s": setup_s,
           "trace": None, **sut.window(records, t_w0, t_w1)}
    if traced:
        sut.set_spans(True)
        n = mix["trace_calls"]
        seg, info = trace.traced(torch, lambda: sut.run(count=n), sut.SPANS)
        sut.set_spans(False)
        info.update(sut.segment(seg))
        ctx["trace"] = info
        log(f"trace: busy {info['busy_s']:.6f} s of {info['window_s']:.6f} "
            f"s, {info['device_ops']} device operations")
        for k, v in sorted(info["kernel_s"].items(),
                           key=lambda kv: -kv[1])[:40]:
            log(f"  device {v:.6f} s  {k[:200]}")
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    found = forbidden_modules()
    if found:
        raise SystemExit(f"forbidden modules loaded: {found}")
    metrics = spec.read_metrics(spec.cell_metrics(bench, name, traced),
                                ctx, base)
    verdict = sut.judge()
    out = {"correct": verdict["correct"],
           "attempted": verdict["attempted"], "failed": verdict["failed"],
           "metrics": metrics,
           "device": {"platform": "gpu" if cuda else device.type,
                      "kind": torch.cuda.get_device_name(0) if cuda
                      else "cpu",
                      "count": 1, "memory_peak_bytes": int(memory_peak)}}
    if ctx["trace"]:
        out["device"]["busy_s"] = ctx["trace"]["busy_s"]
        out["device"]["window_s"] = ctx["trace"]["window_s"]
        out["breakdown"] = ctx["trace"]["breakdown"]
    out["judged"] = verdict["judged"]
    out["checks"] = verdict["checks"]
    return out
