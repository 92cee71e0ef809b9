"""Device ms of windowed BA per keyframe: the `graph.kf.ba` section's
stamped time over the keyframe programs, per `kf` run
(`harness/stages.py`: every replay since the build, the window the most
by far)."""

from benchmark.harness import stages


def read(ctx):
    return stages.per_keyframe(ctx, "graph.kf.ba", "device_ms")
