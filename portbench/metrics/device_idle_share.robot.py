"""device_idle_share.robot (%): 100 x (1 - busy / window) of the traced
segment: the union of the device operations' intervals over the
segment's length, both from the same trace."""
LAYER, UNIT, SOURCE, MOVES = "device", "%", "device_trace", "call_ms_p50"


def read(ctx):
    tr = ctx["trace"]
    if not tr or not tr["device_ops"] or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
