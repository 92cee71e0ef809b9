"""Share of the traced window's device timeline outside the calls' CUDA
event spans: 100 * (1 - sum of spans / first event to last). Idle time
inside a call (the device waiting on the host between two launches of
one call) counts as busy here."""


def read(ctx):
    window = ctx["device_window_ms"]
    if not window or not ctx["calls"]:
        return None
    busy = sum(c["device_ms"] for c in ctx["calls"])
    return 100.0 * max(0.0, 1.0 - busy / window)
