"""Device ms of the keyframe branch per keyframe: the `kf` section's
stamped time over the keyframe programs, per run of it (in the fleet a
keyframe subset of 1-3 drives is one run; `harness/stages.py`: every
replay since the build, the window the most by far)."""

from benchmark.harness import stages


def read(ctx):
    return stages.per_keyframe(ctx, "kf", "device_ms")
