"""The device trace of a traced segment: `torch.profiler` with CPU and
CUDA activities around work that the caller runs, reduced to

- `busy_s`: the union of the device operations' intervals (kernels,
  copies, sets) inside the segment, and `window_s`, the segment's length,
  both on the profiler's clock, from the same segment;
- `kernel_s`: device seconds by operation name;
- `breakdown`: the ten operations that took the most device time, and
  the idle time between device operations by what the host was doing
  then (the innermost benchmark span, and the innermost host operation).
"""
from __future__ import annotations

import bisect
from typing import Callable, Dict, List, Tuple

SEGMENT = "portbench.segment"


def union_s(intervals: List[Tuple[float, float]], lo: float,
            hi: float) -> Tuple[float, List[Tuple[float, float]]]:
    """Seconds covered by the union of (start, end) microsecond intervals
    clipped to [lo, hi], and the merged blocks."""
    blocks: List[List[float]] = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if blocks and s <= blocks[-1][1]:
            blocks[-1][1] = max(blocks[-1][1], e)
        else:
            blocks.append([s, e])
    return sum(e - s for s, e in blocks) / 1e6, [tuple(b) for b in blocks]


def _innermost(events, starts, t: float, pick: Callable) -> str:
    """Name of the latest-starting event of `events` (sorted by start)
    that covers time t and passes `pick`, or "-"."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 256, -1), -1):
        s, e, name = events[j]
        if e >= t and pick(name):
            return name
    return "-"


def traced(torch, run: Callable[[], object],
           span_names) -> Tuple[object, dict]:
    """Run `run()` under the profiler inside one segment span; returns its
    result and the reduced trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        with record_function(SEGMENT):
            out = run()
            sync()
    dev, host = [], []
    lo = hi = None
    spans = set(span_names) | {SEGMENT}
    for e in prof.events():
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            # the spans' own device-side ranges are annotations, not work
            if e.name not in spans and not getattr(
                    e, "is_user_annotation", False):
                dev.append((tr.start, tr.end, e.name))
        elif e.name == SEGMENT:
            lo, hi = tr.start, tr.end
        else:
            host.append((tr.start, tr.end, e.name))
    busy, blocks = union_s([(s, e) for s, e, _ in dev], lo, hi)
    kernel_s: Dict[str, float] = {}
    for s, e, name in dev:
        kernel_s[name] = kernel_s.get(name, 0.0) + (e - s) / 1e6
    host.sort()
    starts = [s for s, _, _ in host]
    marks = [h for h in host if h[2] in spans]
    idle: Dict[str, float] = {}
    edges = [lo] + [x for b in blocks for x in b] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        inside = [name for s, e, name in marks if s <= mid <= e]
        label = (inside[-1] if inside else "-") + " | " + \
            _innermost(host, starts, mid, lambda n: n not in spans)
        idle[label] = idle.get(label, 0.0) + (b - a) / 1e6
    top = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return out, {
        "busy_s": busy, "window_s": (hi - lo) / 1e6, "kernel_s": kernel_s,
        "device_ops": len(dev),
        "breakdown": {"device_ops": [[n[:160], s] for n, s in top],
                      "idle_gaps": [[n[:160], s] for n, s in gaps]}}


def kernel_seconds(trace: dict, pattern: str) -> float:
    """Device seconds of the operations whose names match `pattern`."""
    import re
    rx = re.compile(pattern)
    return sum(s for n, s in trace["kernel_s"].items() if rx.search(n))
