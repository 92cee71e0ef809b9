"""Device ms a frame spends in the programs' copies: `program.call` (eager
stamps before the input copies and after the output copies) less
`program.replay` (the graph's first and last node), summed over the frame
and keyframe programs, per call of the frame programs
(`harness/stages.py`: every replay since the build, the window the most
by far)."""

from benchmark.harness import stages


def read(ctx):
    return stages.copy_ms_per_frame(ctx)
