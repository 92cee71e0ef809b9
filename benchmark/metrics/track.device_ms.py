"""Device ms of the track half per frame: the `track` section's stamped
time over the frame programs, per run of it (`harness/stages.py`: every
replay since the build, the window the most by far)."""

from benchmark.harness import stages


def read(ctx):
    return stages.per_frame(ctx, "track", "device_ms")
