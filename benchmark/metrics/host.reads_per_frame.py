"""Device-to-host reads the port counts (utils/host.READS) over the
window, per frame completed in it."""


def read(ctx):
    n = len(ctx["completed"])
    return ctx["host_reads"] / n if n else None
