"""int4_decode_roofline.robot (%): the least time the traced segment's
one-row int4 products (K6: every decode forward's projections and head,
and each prefill's head) could take at 3.35 TB/s, over the device time
of the kernels named below in the segment's trace. The bytes are counted
from the segment's served tokens (portbench/harness/flops.py)."""
from portbench.harness import flops, trace

LAYER, UNIT, SOURCE, MOVES = ("int4 weights", "%", "device_trace",
                              "call_ms_p50")
KERNELS = r"int4_mma_kernel|int4_f32_kernel"
GROUP = 64


def read(ctx):
    tr = ctx["trace"]
    if not tr or ctx["cfg"]["serving"]["bits"] != 4:
        return None
    busy = trace.kernel_seconds(tr, KERNELS)
    if busy <= 0:
        return None
    lc = ctx["cfg"]["llm"]
    per_pass = flops.int4_decode_pass_bytes(lc, GROUP)
    head = flops.head_int4_bytes(lc, GROUP)
    nbytes = sum((len(c["served"]) - 1) * per_pass + head
                 for c in tr["calls"])
    return 100.0 * nbytes / flops.PEAK_BYTES_PER_S / busy
