"""One windowed-BA GN iteration: the production window (F = 8, 2048
points) against the enlarged one of BASELINE config 5 (F = 16, 8192
points, residuals from every point to every other frame).

Port of `tools/bench_enlarged_window.py`:

    python -m stereo_dso_g2o_tpu_torch.tools.bench_enlarged_window [reps=5]
        [device=cuda|cpu]

Each iteration is timed between CUDA events (the host clock on the CPU),
median of `reps`. One card measures the cost growth of the window, not the
sharded BA's scaling (AccumulatedTopHessian.cpp:201-229: the stitch is a
sum over independent pair blocks). The window is built here, as
`tests/test_dist_ba.py::_build_enlarged_window` builds it for the JAX
package: the tilted plane of `default_scene(seed)` at 192x96, F poses
along a slow screw, 1.5e-3 pose noise, the points spread over every host
with 3 % inverse-depth noise.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from stereo_dso_g2o_tpu_torch.tools._common import cli, emit

KEYS = ("reps", "device")
WID, HGT = 192, 96


def build_enlarged_window(F=16, n_pts=8192, seed=11, *, device, settings=None):
    """F keyframes, n_pts points hosted across all frames, residuals to
    every other frame: (window, (F, H, W, 3) image stack)."""
    from stereo_dso_g2o_tpu_torch.backend import builder
    from stereo_dso_g2o_tpu_torch.backend import window as W
    from stereo_dso_g2o_tpu_torch.config import default_settings
    from stereo_dso_g2o_tpu_torch.io import synthetic
    from stereo_dso_g2o_tpu_torch.ops import trace as trace_ops
    from stereo_dso_g2o_tpu_torch.ops.pyramid import build_pyramid
    from stereo_dso_g2o_tpu_torch.utils import se3

    settings = settings or default_settings()
    scene = synthetic.default_scene(seed)
    K = synthetic.default_K(WID, HGT)
    rng = np.random.default_rng(seed)

    def exp(xi):
        return se3.se3_exp(torch.as_tensor(np.asarray(xi, np.float32))).numpy().astype(np.float64)

    poses, dIs, idepths = [], [], []
    for i in range(F):
        T = exp([0.015 * i, -0.004 * i, 0.010 * i, 0.0008 * i, 0.0015 * i, -0.0005 * i])
        poses.append(T)
        img, idp = synthetic.render(scene, K, WID, HGT, T)
        # box-blur so central-diff gradients match the bilinear surface
        im = img
        for _ in range(2):
            p = np.pad(im, 1, mode="edge")
            im = sum(
                p[1 + dy: p.shape[0] - 1 + dy, 1 + dx: p.shape[1] - 1 + dx]
                for dy in (-1, 0, 1) for dx in (-1, 0, 1)
            ) / 9.0
        dIs.append(build_pyramid(torch.as_tensor(im.astype(np.float32), device=device), 1)[0][0])
        idepths.append(idp)
    dI_stack = torch.stack(dIs)

    win = W.empty_window(F, n_pts, [K[0, 0], K[1, 1], K[0, 2], K[1, 2]], device)
    for i in range(F):
        T_pert = exp(rng.standard_normal(6) * (1.5e-3 if i > 0 else 0.0)) @ poses[i]
        win = builder.insert_frame(win, i, T_pert, (0.0, 0.0), 1.0, i)

    per = n_pts // F
    for h in range(F):
        us = rng.integers(10, WID - 10, per).astype(np.float32)
        vs = rng.integers(10, HGT - 10, per).astype(np.float32)
        ids = idepths[h][vs.astype(int), us.astype(int)].astype(np.float32)
        ids = ids * (1.0 + rng.standard_normal(per).astype(np.float32) * 0.03)
        tu, tv = torch.as_tensor(us, device=device), torch.as_tensor(vs, device=device)
        color, weights, _, eth = trace_ops.extract_point_data(dIs[h], tu, tv, settings)
        win = builder.insert_points(win, np.arange(h * per, (h + 1) * per), h, tu, tv,
                                    torch.as_tensor(ids, device=device), color, weights, eth)
    return builder.add_residuals_all_pairs(win), dI_stack


def main(reps=5, device=None) -> dict:
    from stereo_dso_g2o_tpu_torch import default_device
    from stereo_dso_g2o_tpu_torch.backend import ba
    from stereo_dso_g2o_tpu_torch.config import default_settings

    dev = default_device(device)
    settings = default_settings()
    reps = int(reps)
    out = {"backend": str(dev)}
    for label, F, n_pts in (("production_F8_2048", 8, 2048), ("enlarged_F16_8192", 16, 8192)):
        win, dI_stack = build_enlarged_window(F=F, n_pts=n_pts, device=dev, settings=settings)
        _, e, _, nres = ba.ba_iteration(win, dI_stack, 0, settings=settings)  # warm
        ms = []
        for _ in range(reps):
            if dev.type == "cuda":
                t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                t0.record()
                ba.ba_iteration(win, dI_stack, 0, settings=settings)
                t1.record()
                t1.synchronize()
                ms.append(t0.elapsed_time(t1))
            else:
                t0 = time.perf_counter()
                ba.ba_iteration(win, dI_stack, 0, settings=settings)
                ms.append(1000.0 * (time.perf_counter() - t0))
        dt = float(np.median(ms))
        out[f"{label}_iter_ms"] = round(dt, 1)
        out[f"{label}_nres"] = int(nres)
        out[f"{label}_energy"] = float(e)
        emit({"progress": label, "iter_ms": round(dt, 1), "nres": int(nres)})
    out["cost_ratio"] = round(
        out["enlarged_F16_8192_iter_ms"] / max(out["production_F8_2048_iter_ms"], 1e-9), 2)
    emit(out)
    return out


if __name__ == "__main__":
    sys.exit(cli(main, sys.argv[1:], KEYS, "bench_enlarged_window"))
