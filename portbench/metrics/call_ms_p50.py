"""call_ms_p50 (ms, host clock): median wall time of a model call, from
the agent's entry on a model step to its actions on the host, over every
call that the window completed. A robot waits on this number."""
import statistics

LAYER, UNIT, SOURCE, MOVES = "agent", "ms", "host_clock", "call_ms_p50"


def read(ctx):
    walls = [c["wall_ms"] for c in ctx["calls"]]
    return statistics.median(walls) if walls else None
