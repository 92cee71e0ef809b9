"""BA iterations per keyframe: the trips the device counted in BA's loop
(`ba`) over the keyframe programs, per `kf` run (`harness/stages.py`:
every replay since the build, the window the most by far)."""

from benchmark.harness import stages


def read(ctx):
    return stages.per_keyframe(ctx, "ba", "trips")
