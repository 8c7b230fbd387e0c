"""decode_ms_per_token.robot (ms/token): the engine's decode phase (CUDA
events) over the tokens it emitted (a call's served tokens but the
first, which the prefill gives), summed over the window's calls."""
LAYER, UNIT, SOURCE, MOVES = ("decode and spec verify", "ms/token",
                              "program_span", "call_ms_p50")


def read(ctx):
    calls = [c for c in ctx["calls"] if c["phase_ms"]]
    tokens = sum(len(c["served"]) - 1 for c in calls)
    return sum(c["phase_ms"][2] for c in calls) / tokens if tokens else None
