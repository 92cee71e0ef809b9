"""Steady-state per-frame profile of the graph path: keyframe against
non-keyframe frame times, and where the device sits idle.

Port of `tools/profile_frame.py`:

    python -m stereo_dso_g2o_tpu_torch.tools.profile_frame [frames=120]
        [traced=10] [seq=0] [small=0] [device=cuda|cpu]

bench.py's sequence `seq`: 12 bootstrap frames, 8 warm graph frames, then
`frames` timed frames as a user runs them (host clock, the device
synchronized after each; on the card the track half replays its captured
program, `runtime/program.py`), each tagged keyframe or not by its own
bundle. In place of the JAX tool's XLA cost analysis of the fused frame
program, torch.profiler traces `traced` more frames, run eagerly
(`program.disabled()`, `traced_mode`): torch.profiler records a kernel
inside a replayed WHILE node once per replay, not once per trip, so a
replayed frame's device time and kernel count cannot be read from it.
Over those eager frames: the device's busy share and kernels per frame
(every op launched from the host, so the host's launch rate bounds a frame
when the device is mostly idle), and the aten ops the host issues. A
replay's own device time is `chip_smoke.py` [program]'s, from CUDA events.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from stereo_dso_g2o_tpu_torch.runtime import program
from stereo_dso_g2o_tpu_torch.tools._common import (
    bootstrap, cli, emit, flag, profile_summary, profiled, sequence, sync,
)

KEYS = ("frames", "traced", "seq", "small", "device")


def main(frames=120, traced=10, seq=0, small=False, device=None) -> dict:
    from stereo_dso_g2o_tpu_torch.bench import BOOT, WARM

    n_timed, n_traced = int(frames), int(traced)
    if n_timed < 1 or n_traced < 1:
        raise ValueError(f"frames={n_timed} and traced={n_traced} must be at least 1")
    warm_until = BOOT + WARM
    end = warm_until + n_timed
    dev, cfg, settings, calib, lefts, rights, _ = sequence(
        seq, end + n_traced, flag(small), None, device)
    gs = bootstrap(calib, settings, lefts, rights, dev)
    for i in range(BOOT, warm_until):
        gs.add_frame(lefts[i], rights[i], i, timestamp=0.1 * i)
    gs.flush()
    sync(dev)

    # the graph path drains bundle i at frame i + fetch_lag; the keyframe
    # tag is read from the state the frame leaves (a new slot's frame id)
    def frame(i):
        n_kf = len(gs.kf_shells)
        t0 = time.perf_counter()
        gs.add_frame(lefts[i], rights[i], i, timestamp=0.1 * i)
        gs.flush()
        sync(dev)
        return time.perf_counter() - t0, len(gs.kf_shells) > n_kf

    times, kinds = zip(*(frame(i) for i in range(warm_until, end)))
    with program.disabled(), profiled(dev) as prof:
        traced_s = sum(frame(i)[0] for i in range(end, end + n_traced))

    t_all = np.array(times)
    kf_mask = np.array(kinds)
    out = {
        "backend": str(dev),
        "n_timed": len(times),
        "fps": round(float(1.0 / t_all.mean()), 2),
        "frame_ms_mean": round(float(1e3 * t_all.mean()), 2),
        "frame_ms_p50": round(float(1e3 * np.median(t_all)), 2),
        "frame_ms_p90": round(float(1e3 * np.quantile(t_all, 0.9)), 2),
        "kf_frame_ms_p50": (round(float(1e3 * np.median(t_all[kf_mask])), 2)
                            if kf_mask.any() else None),
        "nonkf_frame_ms_p50": (round(float(1e3 * np.median(t_all[~kf_mask])), 2)
                               if (~kf_mask).any() else None),
        "kf_rate": round(float(kf_mask.mean()), 3),
        "n_keyframes": len(gs.kf_shells),
        "traced_mode": "eager (program.disabled)",
        **profile_summary(prof, 1e3 * traced_s, n_traced),
    }
    emit(out)
    return out


if __name__ == "__main__":
    sys.exit(cli(main, sys.argv[1:], KEYS, "profile_frame"))
