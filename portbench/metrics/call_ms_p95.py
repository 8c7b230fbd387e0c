"""call_ms_p95 (ms, host clock): 95th percentile (linear between order
statistics) of the same walls. It lands inside the window-boundary
<memory> calls: they are one call in 8 at most and ~10% of a window's
calls, so the 90th percentile would sit on the edge between them and the
episodes' first calls."""
import numpy as np

LAYER, UNIT, SOURCE, MOVES = "agent", "ms", "host_clock", "call_ms_p95"


def read(ctx):
    walls = [c["wall_ms"] for c in ctx["calls"]]
    return float(np.percentile(walls, 95)) if walls else None
