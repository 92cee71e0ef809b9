"""What the tools share: `key=value` arguments, bench.py's sequences and
settings, the bootstrap, synchronized timing and the profiler summary."""

from __future__ import annotations

import json
import sys
import time

import torch


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


def profiled(device):
    """A torch.profiler over the host and, on the GPU, the device."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


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
