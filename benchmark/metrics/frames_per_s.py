"""Frames whose result reached the host inside the window, over the
window's seconds (host clock; a frame is one stereo pair of one drive)."""

from benchmark.harness import stats


def read(ctx):
    return stats.rate(len(ctx["completed"]), ctx["window_s"])
