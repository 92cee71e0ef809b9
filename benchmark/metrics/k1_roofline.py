"""K1 (csrc/epipolar_search.cu): the least time the card could take over the device time, in %,
summed over the searches one more call makes after the window (each
search timed on its own operands by kernels.cuda_ms, its least time by
kernels.search_bound). Nothing when the call made no such search."""


def read(ctx):
    got = ctx["kernels"].get("k1")
    if not got or got[0] <= 0:
        return None
    ms, bound_ms, _ = got
    return 100.0 * bound_ms / ms
