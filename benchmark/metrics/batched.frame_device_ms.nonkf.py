"""Median device time of the traced window's batched calls without a keyframe pipeline:
CUDA events on the stream before and after each call."""

from benchmark.harness import stats


def read(ctx):
    xs = [c["device_ms"] for c in ctx["calls"] if c["layer"] == "batched" and c["kf"] is False]
    return stats.median(xs) if xs else None
