"""host_ms.robot (ms): per call, the wall minus the engine's three CUDA-
event phases (vision, prefill, decode), averaged over the window's calls:
the agent's prompt building, history backfill, the engine's host work
outside the phases, and the decode of the text."""
LAYER, UNIT, SOURCE, MOVES = ("agent and engine host", "ms", "program_span",
                              "call_ms_p50")


def read(ctx):
    rows = [c["wall_ms"] - sum(c["phase_ms"]) for c in ctx["calls"]
            if c["phase_ms"]]
    return sum(rows) / len(rows) if rows else None
