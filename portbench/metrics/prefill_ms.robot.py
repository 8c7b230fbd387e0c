"""prefill_ms.robot (ms): the engine's prefill phase (splice and the
decoder over the prompt into the cache at the row's offset; CUDA events),
mean per call."""
LAYER, UNIT, SOURCE, MOVES = "prefill", "ms", "program_span", "call_ms_p95"


def read(ctx):
    rows = [c["phase_ms"][1] for c in ctx["calls"] if c["phase_ms"]]
    return sum(rows) / len(rows) if rows else None
