"""Where a steady-state frame's device time and host time go, and how near
the epipolar search comes to the card's memory rate.

Port of `tools/roofline.py`:

    python -m stereo_dso_g2o_tpu_torch.tools.roofline [traced=12] [seq=0]
        [small=0] [device=cuda|cpu]

bench.py's sequence `seq`: 12 bootstrap frames, 10 warm graph frames, then
`traced` frames under torch.profiler with the device alone recorded (the
JAX tool's window). Keys: `wall_ms_per_frame` (host clock over the traced
frames, the device synchronized at the end; the profiler's start and its
reading of the trace are outside it), `n_frames_traced`,
`device_ms_per_frame` (the device events' time: kernels, copies, sets),
`launches_per_frame`, and `top_ops`: the 10 device ops with the most self
time, each with `op`, `category` (kernel / memcpy / memset),
`self_ms_per_frame`, `launches_per_frame`, `us_per_launch` and `pct` of the
device time. The port's own: `short_kernel_share`, the share of device
time and of launches in launches under 5 us (launch-bound work);
`search_ops`, the same rows for the two search kernels whatever their
rank, beside `search_launches_per_frame` from the wrappers' counters; and
`host`, where the host's time goes: 2 more frames timed untraced
(`untraced_wall_ms_per_frame`), then 2 traced with the host recorded too,
split by `_common.host_split` into aten ops, kernel launch calls, other
runtime calls and the rest.

Every measured frame runs eagerly (`program.disabled()`, the key `mode`;
the warm frames replay the track program, `runtime/program.py`):
torch.profiler records a kernel inside a replayed WHILE node once per
replay, not once per trip, so a replayed frame's device time, launches
and top ops cannot be read from it, and the host keys are of the same
eager frames. A replay's own device time is `chip_smoke.py` [program]'s,
from CUDA events.

Eager PyTorch has no counterpart of XLA's cost analysis of a whole frame
program, so no byte count is made up for the frame (`bytes_scope` says
so): `achieved_GBps` and `pct_of_peak` (of `peak_GBps`, the H100's 3.35
TB/s) are those of the K1/K2 launches in the window only, and their bytes
(`search_bytes_per_frame`) are the least the search must move
(`ops/trace_cuda.search_bound`), not measured traffic: the rate is the
kernels' bound over their time. On the CPU every device key is None, as
`_common.profile_summary` gives them.
"""

from __future__ import annotations

import sys
import time

from stereo_dso_g2o_tpu_torch.runtime import program
from stereo_dso_g2o_tpu_torch.tools._common import (
    bootstrap, cli, device_launches, emit, flag, host_split, profiled, recorded_searches,
    search_kernel, sequence, sync,
)

KEYS = ("traced", "seq", "small", "device")
WARM = 10  # graph frames before the traced window
TOP = 10
HOST_FRAMES = 2  # frames timed untraced, then as many traced with the host recorded
SHORT_US = 5.0


def category(name: str) -> str:
    low = name.lower()
    return "memcpy" if low.startswith("memcpy") else "memset" if low.startswith("memset") else "kernel"


def op_rows(launches, n_frames: int, total_us: float, key=lambda name: name[:120]) -> list:
    """Rows of device time per op, the most first: `launches` is (name, us)
    per launch, grouped by (key(name), category); `pct` is of `total_us`."""
    acc = {}
    for name, us in launches:
        group = (key(name), category(name))
        t, c = acc.get(group, (0.0, 0))
        acc[group] = (t + us, c + 1)
    return [{"op": op, "category": cat, "self_ms_per_frame": t / 1e3 / n_frames,
             "launches_per_frame": c / n_frames, "us_per_launch": t / c,
             "pct": 100.0 * t / max(total_us, 1e-9)}
            for (op, cat), (t, c) in sorted(acc.items(), key=lambda kv: -kv[1][0])]


def short_kernel_share(launches, below_us=SHORT_US) -> dict:
    """Share of device time and of launches in launches under `below_us`."""
    short = [us for _, us in launches if us < below_us]
    total = sum(us for _, us in launches)
    return {"below_us": below_us, "device_time": sum(short) / max(total, 1e-9),
            "launches": len(short) / max(len(launches), 1)}


def main(traced=12, seq=0, small=False, device=None) -> dict:
    from stereo_dso_g2o_tpu_torch.bench import BOOT
    from stereo_dso_g2o_tpu_torch.ops import trace_cuda as tk

    n_tr = int(traced)
    if n_tr < 1:
        raise ValueError(f"traced={n_tr} must be at least 1")
    dev, cfg, settings, calib, lefts, rights, _ = sequence(
        seq, BOOT + WARM + n_tr + 2 * HOST_FRAMES, flag(small), None, device)
    gs = bootstrap(calib, settings, lefts, rights, dev)

    def run(a, b):
        """Frames a to b - 1 through the graph path; ms a frame."""
        t0 = time.perf_counter()
        for i in range(a, b):
            gs.add_frame(lefts[i], rights[i], i, timestamp=0.1 * i)
        gs.flush()
        sync(dev)
        return (time.perf_counter() - t0) / (b - a) * 1e3

    run(BOOT, BOOT + WARM)
    emit({"progress": "warm"})

    i0, i1 = BOOT + WARM, BOOT + WARM + n_tr
    k0 = (tk.LAUNCHES, tk.LAUNCHES_SLAB)
    with program.disabled():
        with profiled(dev, host=False) as prof, recorded_searches() as calls:
            wall_ms = run(i0, i1)
        counted = {"epipolar_search": (tk.LAUNCHES - k0[0]) / n_tr,
                   "epipolar_search_slab": (tk.LAUNCHES_SLAB - k0[1]) / n_tr}
        untraced_ms = run(i1, i1 + HOST_FRAMES)
        with profiled(dev) as host_prof:
            host_ms = run(i1 + HOST_FRAMES, i1 + 2 * HOST_FRAMES)
    launches = device_launches(prof)
    host = dict(host_split(host_prof, host_ms, HOST_FRAMES), untraced_wall_ms_per_frame=untraced_ms)

    search = [(name, us) for name, us in launches if search_kernel(name)]
    search_bytes = sum(tk.search_bound(*ops[0].shape[-3:-1], ops[1], kw["S"], kw["gn_iters"]).bytes
                       for _, ops, kw in calls)
    peak_GBps = tk.HBM_BYTES_PER_S / 1e9
    out = {"backend": str(dev), "mode": "eager (program.disabled)", "wall_ms_per_frame": wall_ms,
           "n_frames_traced": n_tr,
           "device_ms_per_frame": None, "launches_per_frame": None, "top_ops": None,
           "short_kernel_share": None, "search_ops": None,
           "search_launches_per_frame": counted, "search_bytes_per_frame": search_bytes / n_tr,
           "achieved_GBps": None, "peak_GBps": peak_GBps, "pct_of_peak": None,
           "bytes_scope": ("K1/K2 launches only, their bytes the least the search must move "
                           "(search_bound), not measured traffic: the rest of the frame has no "
                           "byte count"),
           "host": host}
    if launches:
        total_us = sum(us for _, us in launches)
        search_us = sum(us for _, us in search)
        out.update(device_ms_per_frame=total_us / 1e3 / n_tr,
                   launches_per_frame=len(launches) / n_tr,
                   top_ops=op_rows(launches, n_tr, total_us)[:TOP],
                   short_kernel_share=short_kernel_share(launches),
                   search_ops=op_rows(search, n_tr, total_us, search_kernel))
        if search_us > 0:
            out["achieved_GBps"] = search_bytes / 1e9 / (search_us / 1e6)
            out["pct_of_peak"] = 100.0 * out["achieved_GBps"] / peak_GBps
    emit(out)
    return out


if __name__ == "__main__":
    sys.exit(cli(main, sys.argv[1:], KEYS, "roofline"))
