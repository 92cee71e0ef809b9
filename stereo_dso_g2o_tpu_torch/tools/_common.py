"""What the tools share: `key=value` arguments, bench.py's sequences and
settings, the bootstrap, synchronized timing, the device time of a call
(`cuda_ms`), the operands of the searches a block of code makes, and the
profiler's summaries of the device's and the host's time."""

from __future__ import annotations

import contextlib
import json
import math
import re
import sys
import time

import torch

# cuda_ms keeps the card busy this long while the host enqueues the timed
# calls: 2.5e7 cycles are over 12 ms at any clock up to 2 GHz
SLEEP_CYCLES, SLEEP_MIN_S = 25_000_000, 12e-3
SEARCHES = ("epipolar_search", "epipolar_search_slab")  # the wrappers of ops/trace_cuda
RUNTIME_CALL = re.compile(r"^cu(da)?[A-Z]")  # a CUDA runtime or driver call in a host trace


def emit(obj):
    print(json.dumps(obj), flush=True)


def cli(main, argv, keys, prog) -> int:
    """Run `main(**args)` from `key=value` arguments; a bad argument prints
    the usage and returns 2."""
    args = {}
    for a in argv:
        k, _, v = a.partition("=")
        if k not in keys or not v:
            print(f"usage: python -m stereo_dso_g2o_tpu_torch.tools.{prog} "
                  f"[{'] ['.join(k + '=...' for k in keys)}]", file=sys.stderr)
            return 2
        args[k] = v
    main(**args)
    return 0


def flag(v) -> bool:
    return str(v) in ("1", "true", "True")


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timed_ms(fn, device, reps: int):
    """Median of `reps` synchronized calls of fn, in ms (one warm call
    first); returns (ms, the last result)."""
    out = fn()
    sync(device)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        sync(device)
        ts.append(1000.0 * (time.perf_counter() - t0))
    ts.sort()
    return ts[len(ts) // 2], out


def mean_ms(fn, device, reps: int) -> float:
    """Mean ms of `reps` calls of fn enqueued back to back, the device
    synchronized after a warm call and after the last: the JAX tools'
    timing."""
    fn()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync(device)
    return (time.perf_counter() - t0) / reps * 1e3


def busy_card_ms(fn, reps=20, busy=1):
    """(host ms, device ms) per call of `fn`, `reps` calls enqueued while
    the card is kept busy (`torch.cuda._sleep`, `busy` times SLEEP_CYCLES):
    the calls then run back to back, so the time between two events around
    them is the device's, and the host clock around the loop reads what
    enqueuing a call costs."""
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
    """Device time of one call of `fn`, in ms. A call that takes the card
    under a millisecond is shorter than what the host needs to enqueue it
    (a wrapper's Python is tens of microseconds), so one call between two
    events would time the host. Instead `busy_card_ms` enqueues `reps`
    calls on a busy card; median of `rounds` such runs. A longer `fn` (a
    plain version: hundreds of small kernels) is timed call by call, median
    of `reps`, host gaps included, as its caller would see it."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    if one_s <= 1e-3:
        # the card kept busy for twice what `reps` such calls take the host,
        # at least SLEEP_MIN_S: a slow host's enqueue still fits
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


def device_ms(fn, device, reps=20):
    """`cuda_ms` on the GPU; None on the CPU, which has no device time."""
    return cuda_ms(fn, reps) if torch.device(device).type == "cuda" else None


@contextlib.contextmanager
def recorded_searches():
    """Within the block, each call of the two search wrappers of
    `ops/trace_cuda` is also noted as (name, tensors, keywords) in the list
    this yields: the operands a trace built for its kernel. A replayed
    program calls no wrapper, so the block runs the frame programs eagerly
    (`runtime/program.disabled`)."""
    from stereo_dso_g2o_tpu_torch.ops import trace_cuda as tk
    from stereo_dso_g2o_tpu_torch.runtime import program

    calls = []
    wrappers = {name: getattr(tk, name) for name in SEARCHES}

    def recording(name):
        def call(*tensors, **kw):
            calls.append((name, tensors, kw))
            return wrappers[name](*tensors, **kw)
        return call

    for name in SEARCHES:
        setattr(tk, name, recording(name))
    try:
        with program.disabled():
            yield calls
    finally:
        for name, fn in wrappers.items():
            setattr(tk, name, fn)


def sequence(seq=0, frames=None, small=False, ladder_fine=None, device=None):
    """bench.py's sequence `seq` rendered on the device, with its calib and
    Settings: (dev, cfg, settings, calib, lefts, rights, poses_wc)."""
    from stereo_dso_g2o_tpu_torch import bench, default_device
    from stereo_dso_g2o_tpu_torch.models.camera import make_calib

    dev = default_device(device)
    cfg = bench.bench_config(bool(small))
    n_frames = cfg["n_frames"] if frames is None else int(frames)
    emit(bench.device_line(dev))
    K, (lefts, rights, poses) = bench.render_sequence(cfg, int(seq), n_frames, dev)
    calib = make_calib(K[0, 0], K[1, 1], K[0, 2], K[1, 2], cfg["base"], cfg["w"], cfg["h"],
                       n_levels=6, device=dev)
    return dev, cfg, bench.bench_settings(cfg, ladder_fine), calib, lefts, rights, poses


def bootstrap(calib, settings, lefts, rights, dev):
    """bench.py's start: BOOT frames through FullSystem, then frozen into
    a GraphSystem."""
    from stereo_dso_g2o_tpu_torch.bench import BOOT
    from stereo_dso_g2o_tpu_torch.frontend.full_system import FullSystem
    from stereo_dso_g2o_tpu_torch.frontend.graph_system import GraphSystem

    fs = FullSystem(calib, settings, device=dev)
    for i in range(BOOT):
        fs.add_frame(lefts[i], rights[i], i, timestamp=0.1 * i)
    return GraphSystem.from_full_system(fs)


def profiled(device, host=True):
    """A torch.profiler over the host and, on the GPU, the device. With
    `host=False` the device alone: the host's ~85,000 ops a frame go
    unrecorded, which costs the traced frames less; on the CPU that
    records nothing and gives None."""
    acts = [torch.profiler.ProfilerActivity.CPU] if host else []
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts) if acts else contextlib.nullcontext()


def search_kernel(name: str):
    """Which search kernel a device event's name is: "epipolar_search_slab",
    "epipolar_search", or None for any other."""
    for k in reversed(SEARCHES):
        if k in name:
            return k
    return None


def device_launches(prof) -> list:
    """(name, device us) of every device event in a trace: kernels, copies
    and sets, one entry per launch; empty on the CPU. Read from the
    profiler's raw results, in ns: `prof.events()` would first make a
    Python event of each of a frame's ~76,000 records (kernels and their
    launch calls), some 20 times slower, and round each to a microsecond."""
    if prof is None:
        return []
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.duration_ns() / 1e3) for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda]


def profile_summary(prof, wall_ms: float, n_frames: int) -> dict:
    """The device's busy share and kernels per frame over a traced window
    (None on the CPU, which has no device), and the aten ops the host
    issued per frame."""
    events = prof.key_averages()
    # kernels only: the aten ops above them carry the same device time again
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    ops = sum(e.count for e in events if e.key.startswith("aten::"))
    out = {"traced_frames": n_frames, "traced_wall_ms": round(wall_ms, 2),
           "aten_ops_per_frame": round(ops / max(n_frames, 1), 1),
           "device_busy_ms_per_frame": None, "device_busy_share": None,
           "kernels_per_frame": None}
    if kernels:
        dev_ms = sum(e.self_device_time_total for e in kernels) / 1000.0
        n_k = sum(e.count for e in kernels)
        out.update(device_busy_ms_per_frame=round(dev_ms / max(n_frames, 1), 3),
                   device_busy_share=round(dev_ms / max(wall_ms, 1e-9), 4),
                   kernels_per_frame=round(n_k / max(n_frames, 1), 1))
    return out


def union_ns(intervals) -> int:
    """Length of the union of (start, end) intervals: nested ops count once."""
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total, end = total + b - a, b
        elif b > end:
            total, end = total + b - end, b
    return total


def host_split(prof, wall_ms: float, n_frames: int) -> dict:
    """The host's time per frame in a trace made with CPU activity on, from
    the profiler's raw records: `aten_ms_per_frame` the outermost aten ops
    (the dispatcher, the ops' host work and the runtime calls they make),
    `launch_ms_per_frame` and `launch_calls_per_frame` the CUDA runtime and
    driver calls that launch a kernel, `other_runtime_ms_per_frame` every
    other such call (copies, synchronizations, events), and
    `outside_ms_per_frame` the wall outside both (Python and the trace's
    own bookkeeping). The trace slows every op, so these are shares of a
    slowed frame: `wall_ms_per_frame` is the traced wall."""
    ops, runtime = [], []
    launch_ns = other_ns = n_launch = 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CPU:
            continue
        name = e.name()
        if name.startswith("aten::"):
            ops.append((e.start_ns(), e.start_ns() + e.duration_ns()))
        elif RUNTIME_CALL.match(name):
            runtime.append((e.start_ns(), e.start_ns() + e.duration_ns()))
            if "Launch" in name:
                launch_ns, n_launch = launch_ns + e.duration_ns(), n_launch + 1
            else:
                other_ns += e.duration_ns()
    per = 1e6 * n_frames
    return {"frames": n_frames, "wall_ms_per_frame": wall_ms,
            "aten_ms_per_frame": union_ns(ops) / per,
            "launch_ms_per_frame": launch_ns / per, "launch_calls_per_frame": n_launch / n_frames,
            "other_runtime_ms_per_frame": other_ns / per,
            "outside_ms_per_frame": wall_ms - union_ns(ops + runtime) / per}
