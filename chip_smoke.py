#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each one passes or the script exits non-zero; nothing is caught):
  1. device: requires CUDA, prints `nvidia-smi` name and power limit;
  2. build: compiles the epipolar-search kernel (csrc/, nvcc, sm_90a);
  3. kernel vs plain: runs the kernel and its plain PyTorch version on a
     rendered 1216x352 stereo pair with seeded lanes at the slice's shapes
     (temporal N=5120, stereo N=2560 in both directions), checks agreement
     and times both (CUDA events, median of 20 synchronized repetitions);
  4. slice: renders 40 frames of the bench corridor (sequence 0) on the
     card, runs the port's FullSystem over them at the KITTI-resolution
     bench settings, and checks: not lost, finite poses, the kernel was
     launched, a frame marginalization ran, KF count and ATE inside the
     bounds recorded in PERF.md.
The last two lines are the kernel report and the device report (JSON).
With SDSO_PROFILE=1 the slice also prints its per-section host times and a
torch.profiler summary of its last frames (device busy share, top kernels).
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
PKG = ROOT / "stereo_dso_g2o_tpu_torch"

W_, H_, BASE, N_FRAMES, STEP = 1216, 352, 0.54, 40, 0.30
N_TEMPORAL, N_STEREO = 5120, 2560
# JAX package, FullSystem on CPU, same 40 frames and settings (PERF.md):
# 10 KFs, ATE 0.0334 m. Bounds: KF count within +-3, ATE <= 2x + 0.01 m.
KF_RANGE = (7, 13)
ATE_MAX = 2 * 0.0334 + 0.01
# kernel vs plain version (both f32, same op order; see PERF.md)
IDX_AGREE_MIN = 0.999
PROFILE_FRAMES = 10
UV_TOL_PX = 1e-3
E_TOL_REL = 1e-4


def fail(msg):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def settings_kitti():
    """bench.py's KITTI-resolution settings (uncalibrated affine: modes 0)."""
    from stereo_dso_g2o_tpu_torch.config import Settings

    return Settings(
        desired_point_density=2000.0, desired_immature_density=1500.0,
        immature_cap=2048, active_cap=2048,
        affine_opt_mode_a=0.0, affine_opt_mode_b=0.0,
    )


def cuda_ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
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


def make_lanes(settings, dI_host, dI_tgt, n, stereo, dirx, seed):
    """Seeded lanes: host pixels of the left image, search lines through the
    target image (horizontal for stereo, random slant for temporal)."""
    from stereo_dso_g2o_tpu_torch.config import PATTERN
    from stereo_dso_g2o_tpu_torch.ops import trace as trace_ops
    from stereo_dso_g2o_tpu_torch.ops import trace_cuda as tk

    dev = dI_host.device
    rng = np.random.default_rng(seed)
    H, W = dI_host.shape[:2]
    S = min(settings.trace_max_steps, int(np.ceil((W + H) * settings.max_pix_search)) + 3)
    u = rng.uniform(12, W - 13, n).astype(np.float32)
    v = rng.uniform(12, H - 13, n).astype(np.float32)
    ut = torch.as_tensor(u, device=dev)
    vt = torch.as_tensor(v, device=dev)
    color, weights, _, _ = trace_ops.extract_point_data(dI_host, ut, vt, settings)
    nsteps = rng.integers(2, S, n).astype(np.float32)
    pat = PATTERN.astype(np.float32)
    if stereo:
        dx = np.full(n, dirx, np.float32)
        dy = np.zeros(n, np.float32)
        aff = np.stack([np.ones(n), np.zeros(n)], 1).astype(np.float32)
        patx = np.broadcast_to(pat[:, 0], (n, 8)).copy()
        paty = np.broadcast_to(pat[:, 1], (n, 8)).copy()
        ptx = u + rng.uniform(-2, 2, n).astype(np.float32)
        pty = v
    else:
        th = np.pi + rng.normal(0, 0.3, n)
        dx = np.cos(th).astype(np.float32)
        dy = np.sin(th).astype(np.float32)
        aff = np.stack([1 + rng.normal(0, 0.03, n), rng.normal(0, 2, n)], 1).astype(np.float32)
        rot = rng.normal(0, 0.05, n)
        c, s = np.cos(rot)[:, None], np.sin(rot)[:, None]
        patx = (c * pat[None, :, 0] - s * pat[None, :, 1]).astype(np.float32)
        paty = (s * pat[None, :, 0] + c * pat[None, :, 1]).astype(np.float32)
        ptx = u + rng.uniform(-3, 3, n).astype(np.float32)
        pty = v + rng.uniform(-2, 2, n).astype(np.float32)
    scal = np.stack([ptx, pty, dx, dy, nsteps, aff[:, 0], aff[:, 1], np.zeros(n, np.float32)], 1)
    T = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev)  # noqa: E731
    return dict(dI=dI_tgt.contiguous(), scal=T(scal), color=color.contiguous(),
                weights=weights.contiguous(), patx=T(patx), paty=T(paty), S=S,
                edge=tk.EDGE_ZERO if stereo else tk.EDGE_CLAMP)


def compare(out_k, out_p, name):
    from stereo_dso_g2o_tpu_torch.ops import trace_cuda as tk

    bidx_eq = out_k[:, tk.OUT_BEST_IDX] == out_p[:, tk.OUT_BEST_IDX]
    frac = float(bidx_eq.float().mean())
    m = bidx_eq
    uv = torch.abs(out_k[m][:, :2] - out_p[m][:, :2])
    uv_err = float(uv.max()) if uv.numel() else 0.0
    e_rel = 0.0
    for lane in (tk.OUT_E_SEARCH, tk.OUT_SECOND_BEST, tk.OUT_E_GN):
        a, b = out_k[m][:, lane], out_p[m][:, lane]
        fin = torch.isfinite(a) & torch.isfinite(b)
        if not bool((torch.isfinite(a) == torch.isfinite(b)).all()):
            fail(f"{name}: finite/inf pattern of energy lane {lane} differs")
        if bool(fin.any()):
            rel = torch.abs(a[fin] - b[fin]) / torch.clamp(torch.abs(b[fin]), min=1e-6)
            e_rel = max(e_rel, float(rel.max()))
    print(f"[kernel] {name}: best_idx equal on {frac:.5f} of {out_k.shape[0]} lanes, "
          f"max |d best_uv| {uv_err:.3g} px, max energy rel err {e_rel:.3g}")
    if frac < IDX_AGREE_MIN:
        fail(f"{name}: best_idx agreement {frac} < {IDX_AGREE_MIN}")
    if uv_err > UV_TOL_PX:
        fail(f"{name}: best_u/v error {uv_err} > {UV_TOL_PX} px")
    if e_rel > E_TOL_REL:
        fail(f"{name}: energy rel error {e_rel} > {E_TOL_REL}")
    return uv_err


def print_profile(prof, wall_ms):
    """Host sections of the whole run, then the device's busy share and
    top kernels over the traced frames."""
    from stereo_dso_g2o_tpu_torch.utils.timing import PROF

    print("[profile] host sections, whole run (synchronized):")
    print(PROF.report())
    events = prof.key_averages()
    # kernels only: the aten ops above them carry the same device time again
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1000.0
    launches = sum(e.count for e in kernels)
    print(f"[profile] last {PROFILE_FRAMES} frames: wall {wall_ms:.1f} ms, device busy "
          f"{dev_ms:.1f} ms ({100.0 * dev_ms / wall_ms:.1f} %), {launches} kernels "
          f"({launches / PROFILE_FRAMES:.0f}/frame, {1000.0 * dev_ms / max(launches, 1):.2f} us each)")
    print(events.table(sort_by="self_device_time_total", row_limit=15, max_name_column_width=60))


def main() -> int:
    if not (PKG / "__init__.py").is_file():
        print("chip_smoke: the stereo_dso_g2o_tpu_torch package is not beside this script",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a GPU",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)

    # ---- 1. device ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # ---- 2. build ----
    from stereo_dso_g2o_tpu_torch.ops import trace_cuda as tk

    t0 = time.perf_counter()
    lib = tk.build()
    print(f"[build] {lib.name} in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {tk.BUILD_SECONDS if tk.BUILD_SECONDS is not None else 'cached'})")
    ptxas = tk.BUILD_DIR / "ptxas.log"
    if ptxas.exists():
        for line in ptxas.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {line.strip()}")

    # ---- 3. kernel vs plain at the slice's shapes ----
    from stereo_dso_g2o_tpu_torch.io import synthetic
    from stereo_dso_g2o_tpu_torch.ops.pyramid import build_pyramid

    settings = settings_kitti()
    K = synthetic.default_K(W_, H_, fov_deg=80.0)
    scene = synthetic.corridor_scene(seed=100, length=STEP * N_FRAMES + 40.0,
                                     box_spacing=9.0, lateral=14.0)
    poses_cw = synthetic.forward_trajectory(N_FRAMES, step=STEP, yaw_amp=0.10,
                                            yaw_period=80.0, seed=0)
    expos = 1.0 + 0.12 * np.sin(0.25 * np.arange(N_FRAMES))
    t0 = time.perf_counter()
    lefts, rights = synthetic.render_stereo_sequence_fast(
        scene, K, W_, H_, BASE, poses_cw, expos, device=dev)
    torch.cuda.synchronize()
    print(f"[render] {N_FRAMES} stereo pairs {W_}x{H_} on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    dIL = build_pyramid(lefts[0].float(), 1)[0][0]
    dIR = build_pyramid(rights[0].float(), 1)[0][0]

    gn = dict(huber_th=float(settings.huber_th), gn_iters=int(settings.trace_gn_iterations),
              gn_threshold=float(settings.trace_gn_threshold),
              radius=int(settings.min_trace_test_radius))
    cases = [
        ("temporal N=5120", make_lanes(settings, dIL, dIR, N_TEMPORAL, False, 0.0, 1)),
        ("stereo L->R N=2560", make_lanes(settings, dIL, dIR, N_STEREO, True, -1.0, 2)),
        ("stereo R->L N=2560", make_lanes(settings, dIR, dIL, N_STEREO, True, 1.0, 3)),
    ]
    timing = {}
    max_err = 0.0
    for name, c in cases:
        args = (c["dI"], c["scal"], c["color"], c["weights"], c["patx"], c["paty"])
        kw = dict(S=c["S"], edge=c["edge"], **gn)
        out_k = tk.epipolar_search(*args, **kw)
        out_p = tk.epipolar_search_ref(*args, **kw)
        torch.cuda.synchronize()
        max_err = max(max_err, compare(out_k, out_p, name))
        ms_p1 = cuda_ms(lambda: tk.epipolar_search_ref(*args, **kw))
        ms_k1 = cuda_ms(lambda: tk.epipolar_search(*args, **kw))
        ms_k2 = cuda_ms(lambda: tk.epipolar_search(*args, **kw))
        ms_p2 = cuda_ms(lambda: tk.epipolar_search_ref(*args, **kw))
        timing[name] = (min(ms_k1, ms_k2), min(ms_p1, ms_p2))
        print(f"[kernel] {name}: S={c['S']} kernel {ms_k1:.4f}/{ms_k2:.4f} ms, "
              f"plain {ms_p1:.4f}/{ms_p2:.4f} ms (median of 20, order p,k,k,p)")

    # ---- 4. the slice: FullSystem over 40 frames ----
    from stereo_dso_g2o_tpu_torch.frontend.full_system import FullSystem
    from stereo_dso_g2o_tpu_torch.io import trajectory
    from stereo_dso_g2o_tpu_torch.models.camera import make_calib

    from stereo_dso_g2o_tpu_torch.utils.timing import PROF

    calib = make_calib(K[0, 0], K[1, 1], K[0, 2], K[1, 2], BASE, W_, H_, n_levels=6, device=dev)
    fs = FullSystem(calib, settings, device=dev)
    # SDSO_PROFILE=1: per-section host times (each section synchronizes, so
    # the frame times of such a run are not the steady-state ones) and a
    # torch.profiler trace of the last PROFILE_FRAMES frames
    traced = contextlib.ExitStack()
    tk.reset_launches()
    frame_ms = []
    t_all = time.perf_counter()
    for i in range(N_FRAMES):
        if PROF.enabled and i == N_FRAMES - PROFILE_FRAMES:
            prof = traced.enter_context(torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]))
        t1 = time.perf_counter()
        fs.add_frame(lefts[i], rights[i], i, timestamp=0.1 * i)
        torch.cuda.synchronize()
        frame_ms.append(1000.0 * (time.perf_counter() - t1))
        if fs.is_lost:
            fail(f"lost at frame {i}")
    traced.close()
    total_s = time.perf_counter() - t_all
    launches = tk.LAUNCHES
    traj = fs.trajectory()
    gt = [np.linalg.inv(T) for T in poses_cw]
    if len(traj) != N_FRAMES or not all(np.isfinite(T).all() for T in traj):
        fail("non-finite or missing poses")
    ate = trajectory.ate_rmse(traj, gt)
    n_kf = len(fs.kf_shells)
    steady = frame_ms[2:]
    print(f"[slice] {N_FRAMES} frames in {total_s:.1f} s; ms/frame median "
          f"{float(np.median(steady)):.1f} mean {float(np.mean(steady)):.1f} (frames 2..), "
          f"first two {frame_ms[0]:.0f}/{frame_ms[1]:.0f} ms")
    print(f"[slice] KFs {n_kf} at frames {[s.id for s in fs.kf_shells]}, ATE {ate:.5f} m, "
          f"frame marginalizations {fs.n_frame_marginalizations}, kernel launches {launches}, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    if PROF.enabled:
        print_profile(prof, sum(frame_ms[-PROFILE_FRAMES:]))
    if launches <= 0:
        fail("the epipolar kernel was not launched on the main path")
    if fs.n_frame_marginalizations < 1:
        fail("no frame marginalization ran")
    if not KF_RANGE[0] <= n_kf <= KF_RANGE[1]:
        fail(f"KF count {n_kf} outside {KF_RANGE}")
    if not ate <= ATE_MAX:
        fail(f"ATE {ate} > {ATE_MAX}")

    t_ms, p_ms = timing["temporal N=5120"]
    s_ms, s_pms = timing["stereo L->R N=2560"]
    report = {"kernels": [{
        "name": "epipolar_search",
        "route": "cuda",
        "source": "stereo_dso_g2o_tpu_torch/csrc/epipolar_search.cu",
        "replaces": "stereo_dso_g2o_tpu/ops/trace_pallas.py:449",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": t_ms,
        "plain_ms": p_ms,
        "ms_stereo": s_ms,
        "plain_ms_stereo": s_pms,
    }]}
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
