"""95th percentile, over every frame completed in the window, of the host
time from the call that submitted it to its result on the host."""

from benchmark.harness import stats


def read(ctx):
    lat = stats.latencies_ms(ctx["submitted"], ctx["completed"])
    return stats.percentile(lat, 95.0) if lat else None
