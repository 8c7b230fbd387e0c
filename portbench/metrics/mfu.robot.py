"""mfu.robot (%): the model operations of the window's completed calls
(portbench/harness/flops.py: the frame, the prompt at its offset, the
served tokens fed back) over window x 989 TFLOP/s (H100 bf16 dense)."""
from portbench.harness import flops

LAYER, UNIT, SOURCE, MOVES = "whole step", "%", "host_clock", "call_ms_p50"


def read(ctx):
    if not ctx["calls"]:
        return None
    work = sum(flops.call(ctx["cfg"], c) for c in ctx["calls"])
    return 100.0 * work / (ctx["window_s"] * flops.PEAK_BF16_FLOPS)
