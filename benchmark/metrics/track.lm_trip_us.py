"""Device us of one LM trip: the time of the tracker's LM loops
(`track.lm`, from the set of each loop's condition to its last trip's
end) over their trips, in the frame programs (`harness/stages.py`: every
replay since the build, the window the most by far)."""

from benchmark.harness import stages


def read(ctx):
    return stages.ratio(ctx, "track", lambda ps: 1000.0 * stages.total(ps, "track.lm", "device_ms"),
                        lambda ps: stages.total(ps, "track.lm", "trips"))
