"""vision_ms.robot (ms): the engine's vision phase (preprocess, SigLIP,
projector, pool of the call's frame; CUDA events), mean per call."""
LAYER, UNIT, SOURCE, MOVES = "vision", "ms", "program_span", "call_ms_p95"


def read(ctx):
    rows = [c["phase_ms"][0] for c in ctx["calls"] if c["phase_ms"]]
    return sum(rows) / len(rows) if rows else None
