"""Seconds from the start of benchmark/run.py to the first timed call:
rendering, loading the kernels (building them on a checkout's first run),
bootstrapping, capturing the programs and the warm frames."""


def read(ctx):
    return ctx["setup_s"]
