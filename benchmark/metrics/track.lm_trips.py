"""LM trips per frame: the trips the device counted in the tracker's LM
loops (`track.lm`, every level and hypothesis row) over the frame
programs, per `track` run (`harness/stages.py`: every replay since the
build, the window the most by far)."""

from benchmark.harness import stages


def read(ctx):
    return stages.per_frame(ctx, "track.lm", "trips")
