"""Kernel rooflines: the operands a frame hands its epipolar search, the
device time of the kernel on them, and the least time the card could take.

Frozen from the port at commit 6bc983070e31600c426f47f1ed626131eb797c90:
`search_bound` from `ops/trace_cuda.py`, `cuda_ms` and `busy_card_ms` from
`tools/_common.py`, and the recording of the wrappers' operands from
`tools/_common.recorded_searches`.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import NamedTuple

import torch

# published peaks of one H100 SXM (dense, no sparsity): HBM bytes/s, f32 FLOP/s
HBM_BYTES_PER_S, F32_FLOP_PER_S = 3.35e12, 67e12
# cuda_ms keeps the card busy this long while the host enqueues the timed
# calls: 2.5e7 cycles are over 12 ms at any clock up to 2 GHz
SLEEP_CYCLES, SLEEP_MIN_S = 25_000_000, 12e-3
# the port's two search wrappers (ops/trace_cuda) and the kernel each launches
WRAPPERS = {"epipolar_search": "k1", "epipolar_search_slab": "k2"}


class SearchBound(NamedTuple):
    bytes: float
    ops: float
    ms: float
    by: str


def search_bound(H: int, W: int, scal, S: int, gn_iters: int) -> SearchBound:
    """The least time for one search of an (H, W) image on the lanes `scal`
    (N, 8), or the sum over a batch (B, N, 8). Bytes, each once, over the
    memory rate: the five (N, 8) operands, the (N, 8) output and the pixels
    of the intensity plane under each lane's valid steps (its steps plus 7
    along the line, 8 across; a lane without a step needs the 7 x 8 patch
    Gauss-Newton reads at step 0), capped at the plane. Operations over the
    f32 peak: 30 per (step, pattern pixel) for the position, a 4-tap
    bilinear and the Huber energy; 80 per (Gauss-Newton iteration, pattern
    pixel)."""
    scal = scal.reshape((-1,) + tuple(scal.shape[-2:]))
    n = scal.shape[0] * scal.shape[1]
    per_seq = torch.ceil(torch.clamp(torch.nan_to_num(scal[..., 4], nan=0.0), 0, S)).sum(-1)
    steps = float(per_seq.sum())
    pixels = sum(min(H * W, 8 * (float(k) + 7 * scal.shape[1])) for k in per_seq)
    nbytes = 4 * (pixels + 5 * n * 8 + n * 8)
    flops = 8 * (30 * steps + 80 * gn_iters * n)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return SearchBound(nbytes, flops, 1000.0 * max(t_bytes, t_ops),
                       "bytes" if t_bytes >= t_ops else "operations")


def busy_card_ms(fn, reps=20, busy=1):
    """(host ms, device ms) per call of `fn`, `reps` calls enqueued while
    the card is kept busy: the calls run back to back, so the time between
    two events around them is the device's."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(busy * SLEEP_CYCLES)
    a.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    b.record()
    torch.cuda.synchronize()
    if host_s > busy * SLEEP_MIN_S:
        raise RuntimeError(f"busy_card_ms: the host took {host_s * 1e3:.1f} ms to enqueue {reps} "
                           f"calls, longer than the card was kept busy")
    return 1000.0 * host_s / reps, a.elapsed_time(b) / reps


def cuda_ms(fn, reps=20, rounds=5):
    """Device time of one call of `fn`, in ms: `reps` calls on a busy card,
    median of `rounds` (a call under a millisecond is shorter than its
    enqueue); a longer call is timed call by call, median of `reps`."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    if one_s <= 1e-3:
        busy = max(1, math.ceil(2 * reps * one_s / SLEEP_MIN_S))
        times = sorted(busy_card_ms(fn, reps, busy)[1] for _ in range(rounds))
        return times[len(times) // 2]
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


@contextlib.contextmanager
def recorded_searches():
    """Within the block the port's programs run eagerly, and each call of
    its two search wrappers is noted as (wrapper, tensors, keywords)."""
    from stereo_dso_g2o_tpu_torch.ops import trace_cuda as tk
    from stereo_dso_g2o_tpu_torch.runtime import program

    calls = []
    wrappers = {name: getattr(tk, name) for name in WRAPPERS}

    def recording(name):
        def call(*tensors, **kw):
            calls.append((name, tensors, kw))
            return wrappers[name](*tensors, **kw)
        return call

    for name in WRAPPERS:
        setattr(tk, name, recording(name))
    try:
        with program.disabled():
            yield calls
    finally:
        for name, fn in wrappers.items():
            setattr(tk, name, fn)


def rooflines(calls):
    """{"k1"|"k2": (device ms, bound ms, launches)} summed over the recorded
    calls of each kernel: each call timed by `cuda_ms` on its own operands."""
    from stereo_dso_g2o_tpu_torch.ops import trace_cuda as tk

    out = {}
    for name, tensors, kw in calls:
        dI, scal = tensors[0], tensors[1]
        H, W = dI.shape[-3], dI.shape[-2]
        fn = getattr(tk, name)
        ms = cuda_ms(lambda: fn(*tensors, **kw))
        bound = search_bound(H, W, scal, kw["S"], kw["gn_iters"]).ms
        k = WRAPPERS[name]
        t, b, n = out.get(k, (0.0, 0.0, 0))
        out[k] = (t + ms, b + bound, n + 1)
    return out
