#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each one passes or the script exits non-zero; nothing is caught):
  1. device: requires CUDA, prints `nvidia-smi` name and power limit;
  2. build: compiles both epipolar-search kernels (csrc/, nvcc, sm_90a, one
     compiler process per source, started together);
  3. resident kernel vs plain: runs the kernel and its plain PyTorch
     version on a rendered 1216x352 stereo pair with seeded lanes at the
     slice's shapes (temporal N=5120, stereo N=2560 in both directions),
     checks agreement and times both (CUDA events, median of 20
     synchronized repetitions); the slab kernel is held against it and
     timed on the same lanes;
  4. slice: renders 40 frames of the bench corridor (sequence 0) on the
     card, runs the port's FullSystem over them at the KITTI-resolution
     bench settings, and checks: not lost, finite poses, the kernel was
     launched, a frame marginalization ran, KF count and ATE inside the
     bounds recorded in PERF.md;
  5. slab kernel vs plain, and vs the resident kernel, on a rendered
     2048x1024 pair (over the 6 MB gate) at max_pix_search 0.027 (S = 86):
     temporal N=5120, stereo N=2560 both ways, stereo N=8192 (what
     stereo_match gives it); both kernels timed there;
  6. stereo_match on that pair: went through the slab kernel, enough good
     points, inverse depth against the renderer's ground truth;
  7. the main path as bench.py drives it: FullSystem over frames 0-11,
     GraphSystem.from_full_system, add_frame over frames 12-39: not lost,
     finite poses, the resident kernel launched, a keyframe and a frame
     marginalization decided by the graph path, KF count and ATE inside
     the bounds recorded in PERF.md.
Every kernel launch counter is set to 0 just before a path is driven and
read just after. The last two lines are the kernel report and the device
report (JSON). With SDSO_PROFILE=1 the two odometry paths also print their
per-section host times and a torch.profiler summary of their last frames
(device busy share, top kernels).
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
BOOT = 12  # bench.py: frames the host FullSystem bootstraps before the freeze
# the stereo-match configuration: a 2048x1024 pair, the KITTI settings scaled
# by the pixel count (x4.9, rounded); max_pix_search 0.027 gives S = 86
W2, H2, MAX_PIX_SEARCH2, N_MATCH = 2048, 1024, 0.027, 8192
MATCH_DENSITY, MATCH_GOOD_MIN, MATCH_REL_MAX = 6000.0, 1500, 0.03
# JAX package, bootstrap 12 + GraphSystem 28 frames on CPU, same frames and
# settings (tests/_torch_parity.py, PERF.md): 10 KFs, ATE 0.0279 m.
GRAPH_KF_RANGE = (7, 13)
GRAPH_ATE_MAX = 2 * 0.0279 + 0.01
# published peaks of one H100 SXM: the roofline a kernel's bound is taken from
HBM_BYTES_PER_S, F32_FLOP_PER_S = 3.35e12, 67e12
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


def bound_ms(H, W, channels, c, gn_iters):
    """The least time the card could take for one search on these inputs:
    bytes (the image the kernel's function needs, the five (N, 8) operands
    and the (N, 8) output, each once) over the memory rate, against the
    operations these lanes need (their valid steps, not S) over the f32
    peak. Per (step, pixel): 2 adds for the position, a 4-tap bilinear (2
    floors, 2 subs, 8 mul/add for the weights, 7 for the sum), residual and
    Huber energy (9): 30; per GN iteration and pixel: three such samples
    with differenced gradients and the step: 80."""
    n = c["scal"].shape[0]
    steps = float(torch.clamp(c["scal"][:, 4], 0, c["S"]).sum())
    nbytes = 4 * (H * W * channels + 5 * n * 8 + n * 8)
    flops = 8 * (30 * steps + 80 * gn_iters * n)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return 1000.0 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def time_pair(kernel, plain):
    """CUDA-event medians in the order plain, kernel, kernel, plain; the
    lower of each pair."""
    p1, k1, k2, p2 = cuda_ms(plain), cuda_ms(kernel), cuda_ms(kernel), cuda_ms(plain)
    return min(k1, k2), min(p1, p2), (k1, k2, p1, p2)


def run_odometry(step, n_from, n_to, is_lost, label, prof_frames):
    """Drive frames n_from..n_to-1 through `step(i)`, each synchronized;
    with SDSO_PROFILE=1 trace the last `prof_frames`. Returns (frame ms
    list, profiler or None)."""
    from stereo_dso_g2o_tpu_torch.utils.timing import PROF

    traced = contextlib.ExitStack()
    prof = None
    frame_ms = []
    for i in range(n_from, n_to):
        if PROF.enabled and i == n_to - prof_frames:
            prof = traced.enter_context(torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]))
        t1 = time.perf_counter()
        step(i)
        torch.cuda.synchronize()
        frame_ms.append(1000.0 * (time.perf_counter() - t1))
        if is_lost():
            fail(f"{label}: lost at frame {i}")
    traced.close()
    return frame_ms, prof


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
    libs = tk.build()
    print(f"[build] {len(libs)} kernels in {time.perf_counter() - t0:.1f} s")
    for name, lib in libs.items():
        secs = tk.BUILD_SECONDS.get(name)
        print(f"[build] {name}: {lib.name}, nvcc "
              f"{f'{secs:.1f} s' if secs is not None else 'cached'}")
        ptxas = tk.BUILD_DIR / f"ptxas_{name}.log"
        if ptxas.exists():
            for line in ptxas.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"[build] {name}: {line.strip()}")

    # ---- 3. resident kernel vs plain at the slice's shapes ----
    import dataclasses

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
    timing = {}  # (kernel, size, case) -> (kernel ms, plain ms)
    max_err = {"epipolar_search": 0.0, "epipolar_search_slab": 0.0}
    bounds = {}

    def check_and_time(size, cases, first, first_ref, second, second_ref):
        """`first` against its plain version and `second` against `first`,
        on every case; both timed beside their plain versions."""
        H, W = size
        for name, c in cases:
            args = (c["dI"], c["scal"], c["color"], c["weights"], c["patx"], c["paty"])
            kw = dict(S=c["S"], edge=c["edge"], **gn)
            fns = {f.__name__: f for f in (first, first_ref, second, second_ref)}
            out = {k: f(*args, **kw) for k, f in fns.items()}
            torch.cuda.synchronize()
            tag = f"{W}x{H} {name}"
            err = compare(out[first.__name__], out[first_ref.__name__],
                          f"{first.__name__} vs plain, {tag}")
            max_err[first.__name__] = max(max_err[first.__name__], err)
            err = compare(out[second.__name__], out[second_ref.__name__],
                          f"{second.__name__} vs plain, {tag}")
            max_err[second.__name__] = max(max_err[second.__name__], err)
            compare(out[second.__name__], out[first.__name__],
                    f"{second.__name__} vs {first.__name__}, {tag}")
            for kern, ref in ((first, first_ref), (second, second_ref)):
                k_ms, p_ms, raw = time_pair(lambda: kern(*args, **kw), lambda: ref(*args, **kw))
                timing[(kern.__name__, f"{W}x{H}", name)] = (k_ms, p_ms)
                channels = 3 if kern is tk.epipolar_search else 1
                bounds[(kern.__name__, f"{W}x{H}", name)] = bound_ms(H, W, channels, c, gn["gn_iters"])
                b_ms, b_by = bounds[(kern.__name__, f"{W}x{H}", name)]
                print(f"[kernel] {kern.__name__} {tag}: S={c['S']} kernel {raw[0]:.4f}/{raw[1]:.4f} ms, "
                      f"plain {raw[2]:.4f}/{raw[3]:.4f} ms (median of 20, order p,k,k,p); "
                      f"bound {b_ms:.5f} ms by {b_by}, share {100 * b_ms / k_ms:.1f} %")

    cases = [
        ("temporal N=5120", make_lanes(settings, dIL, dIR, N_TEMPORAL, False, 0.0, 1)),
        ("stereo L->R N=2560", make_lanes(settings, dIL, dIR, N_STEREO, True, -1.0, 2)),
        ("stereo R->L N=2560", make_lanes(settings, dIR, dIL, N_STEREO, True, 1.0, 3)),
    ]
    check_and_time((H_, W_), cases, tk.epipolar_search, tk.epipolar_search_ref,
                   tk.epipolar_search_slab, tk.epipolar_search_slab_ref)

    # ---- 4. the slice: FullSystem over 40 frames ----
    from stereo_dso_g2o_tpu_torch.frontend import graph_system as tgs
    from stereo_dso_g2o_tpu_torch.frontend.full_system import FullSystem
    from stereo_dso_g2o_tpu_torch.io import trajectory
    from stereo_dso_g2o_tpu_torch.models.camera import make_calib
    from stereo_dso_g2o_tpu_torch.utils.timing import PROF

    launches = {}  # path -> (resident launches, slab launches)
    gt = [np.linalg.inv(T) for T in poses_cw]
    calib = make_calib(K[0, 0], K[1, 1], K[0, 2], K[1, 2], BASE, W_, H_, n_levels=6, device=dev)
    fs = FullSystem(calib, settings, device=dev)
    # SDSO_PROFILE=1: per-section host times (each section synchronizes, so
    # the frame times of such a run are not the steady-state ones) and a
    # torch.profiler trace of the last PROFILE_FRAMES frames
    tk.reset_launches()
    t_all = time.perf_counter()
    frame_ms, prof = run_odometry(
        lambda i: fs.add_frame(lefts[i], rights[i], i, timestamp=0.1 * i),
        0, N_FRAMES, lambda: fs.is_lost, "slice", PROFILE_FRAMES)
    total_s = time.perf_counter() - t_all
    launches["full_system"] = (tk.LAUNCHES, tk.LAUNCHES_SLAB)
    traj = fs.trajectory()
    if len(traj) != N_FRAMES or not all(np.isfinite(T).all() for T in traj):
        fail("non-finite or missing poses")
    ate = trajectory.ate_rmse(traj, gt)
    n_kf = len(fs.kf_shells)
    steady = frame_ms[2:]
    print(f"[slice] {N_FRAMES} frames in {total_s:.1f} s; ms/frame median "
          f"{float(np.median(steady)):.1f} mean {float(np.mean(steady)):.1f} (frames 2..), "
          f"first two {frame_ms[0]:.0f}/{frame_ms[1]:.0f} ms")
    print(f"[slice] KFs {n_kf} at frames {[s.id for s in fs.kf_shells]}, ATE {ate:.5f} m, "
          f"frame marginalizations {fs.n_frame_marginalizations}, kernel launches "
          f"{launches['full_system']}, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    if PROF.enabled:
        print_profile(prof, sum(frame_ms[-PROFILE_FRAMES:]))
        PROF.reset()
    if launches["full_system"][0] <= 0:
        fail("the epipolar kernel was not launched on the main path")
    if fs.n_frame_marginalizations < 1:
        fail("no frame marginalization ran")
    if not KF_RANGE[0] <= n_kf <= KF_RANGE[1]:
        fail(f"KF count {n_kf} outside {KF_RANGE}")
    if not ate <= ATE_MAX:
        fail(f"ATE {ate} > {ATE_MAX}")
    del fs

    # ---- 5. slab kernel vs plain and vs the resident kernel, 2048x1024 ----
    settings2 = dataclasses.replace(
        settings, max_pix_search=MAX_PIX_SEARCH2, immature_cap=N_MATCH,
        desired_immature_density=MATCH_DENSITY)
    K2 = synthetic.default_K(W2, H2, fov_deg=80.0)
    pair_poses = np.stack([poses_cw[0], synthetic.stereo_pose(poses_cw[0], BASE)])
    t0 = time.perf_counter()
    imgs2, ideps2 = synthetic.render_multi_batch(scene, K2, W2, H2, pair_poses, device=dev)
    torch.cuda.synchronize()
    print(f"[render] one stereo pair {W2}x{H2} with inverse depth on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    if not tk.uses_slab_route(H2, W2) or tk.uses_slab_route(H_, W_):
        fail("the route gate does not send 2048x1024 to the slab kernel and 1216x352 to the other")
    dIL2 = build_pyramid(imgs2[0], 1)[0][0]
    dIR2 = build_pyramid(imgs2[1], 1)[0][0]
    cases2 = [
        ("temporal N=5120", make_lanes(settings2, dIL2, dIR2, N_TEMPORAL, False, 0.0, 4)),
        ("stereo L->R N=2560", make_lanes(settings2, dIL2, dIR2, N_STEREO, True, -1.0, 5)),
        ("stereo R->L N=2560", make_lanes(settings2, dIR2, dIL2, N_STEREO, True, 1.0, 6)),
        (f"stereo L->R N={N_MATCH}", make_lanes(settings2, dIL2, dIR2, N_MATCH, True, -1.0, 7)),
    ]
    check_and_time((H2, W2), cases2, tk.epipolar_search_slab, tk.epipolar_search_slab_ref,
                   tk.epipolar_search, tk.epipolar_search_ref)

    # ---- 6. stereo_match at full width ----
    from stereo_dso_g2o_tpu_torch.frontend.stereo_match import stereo_match

    calib2 = make_calib(K2[0, 0], K2[1, 1], K2[0, 2], K2[1, 2], BASE, W2, H2, n_levels=6,
                        device=dev)
    tk.reset_launches()
    result, imap = stereo_match(imgs2[0], imgs2[1], calib2, settings=settings2, device=dev)
    torch.cuda.synchronize()
    launches["stereo_match"] = (tk.LAUNCHES, tk.LAUNCHES_SLAB)
    match_ms = []
    for _ in range(5):
        t1 = time.perf_counter()
        stereo_match(imgs2[0], imgs2[1], calib2, settings=settings2, device=dev)
        torch.cuda.synchronize()
        match_ms.append(1000.0 * (time.perf_counter() - t1))
    good = result.good
    n_good, n_sel = int(good.sum()), int(result.valid.sum())
    iu, iv = result.us.long(), result.vs.long()
    gt_id = ideps2[0][iv, iu]
    rel = (torch.abs(result.idepth - gt_id) / gt_id)[good]
    med_rel = float(rel.median()) if n_good else float("nan")
    print(f"[stereo_match] {W2}x{H2}: {n_sel} selected, {n_good} good, median relative "
          f"inverse-depth error {med_rel:.5f}, over 0.2: {float((rel > 0.2).float().mean()):.4f}; "
          f"ms/call median {float(np.median(match_ms)):.1f} (of 5, synchronized); "
          f"kernel launches {launches['stereo_match']}")
    if launches["stereo_match"][1] < 2:
        fail("stereo_match did not go through the slab kernel")
    if launches["stereo_match"][0] != 0:
        fail("stereo_match launched the resident kernel on an image over the gate")
    if n_good < MATCH_GOOD_MIN:
        fail(f"stereo_match: {n_good} good points < {MATCH_GOOD_MIN}")
    if not med_rel < MATCH_REL_MAX:
        fail(f"stereo_match: median relative inverse-depth error {med_rel} >= {MATCH_REL_MAX}")
    if not bool((result.idepth_min[good] <= result.idepth_max[good]).all()):
        fail("stereo_match: idepth_min > idepth_max on an accepted point")
    if not bool((imap[iv[good], iu[good], 0] == result.idepth[good]).all()):
        fail("stereo_match: the map does not hold the estimates at the selected pixels")
    if not bool(torch.isfinite(imap).all()) or imap.shape != (H2, W2, 3):
        fail("stereo_match: map not finite or of the wrong shape")

    # ---- 7. the main path: FullSystem bootstrap, freeze, GraphSystem ----
    torch.cuda.reset_peak_memory_stats()
    fs = FullSystem(calib, settings, device=dev)
    for i in range(BOOT):
        fs.add_frame(lefts[i], rights[i], i, timestamp=0.1 * i)
    gs = tgs.GraphSystem.from_full_system(fs)
    kfs_boot = len(gs.kf_shells)
    tk.reset_launches()
    tgs.reset_host_reads()
    PROF.reset()

    t_all = time.perf_counter()
    frame_ms, prof = run_odometry(
        lambda i: gs.add_frame(lefts[i], rights[i], i, timestamp=0.1 * i),
        BOOT, N_FRAMES, lambda: gs.is_lost, "graph", PROFILE_FRAMES)
    gs.flush()
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t_all
    launches["graph_system"] = (tk.LAUNCHES, tk.LAUNCHES_SLAB)
    reads = tgs.HOST_READS
    traj = gs.trajectory()
    if gs.is_lost:
        fail("graph: lost")
    if len(traj) != N_FRAMES or not all(np.isfinite(T).all() for T in traj):
        fail("graph: non-finite or missing poses")
    ate = trajectory.ate_rmse(traj, gt)
    kf_frames = [s.id for s in gs.kf_shells]
    n_kf = len(kf_frames)
    graph_kfs = [f for f in kf_frames if f >= BOOT]
    steady = [(i, ms) for i, ms in zip(range(BOOT, N_FRAMES), frame_ms) if i >= BOOT + 2]
    kf_ms = [ms for i, ms in steady if i in graph_kfs]
    nonkf_ms = [ms for i, ms in steady if i not in graph_kfs]
    print(f"[graph] bootstrap {BOOT} + {N_FRAMES - BOOT} graph frames in {total_s:.1f} s; ms/frame "
          f"median {float(np.median([m for _, m in steady])):.1f} mean "
          f"{float(np.mean([m for _, m in steady])):.1f} (frames {BOOT + 2}..{N_FRAMES - 1}); "
          f"non-KF median {float(np.median(nonkf_ms)):.1f}, KF frames "
          f"{[round(m, 1) for m in kf_ms]} ms")
    print(f"[graph] KFs {n_kf} at frames {kf_frames} ({len(graph_kfs)} by the graph path), "
          f"ATE {ate:.5f} m, frames marginalized by the graph path {gs.n_frame_marginalizations}, kernel "
          f"launches {launches['graph_system']}, host reads of the frame program "
          f"{reads} ({reads / (N_FRAMES - BOOT):.2f}/frame), "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    if PROF.enabled:
        print_profile(prof, sum(frame_ms[-PROFILE_FRAMES:]))
    if launches["graph_system"][0] <= 0:
        fail("graph: the epipolar kernel was not launched")
    if launches["graph_system"][1] != 0:
        fail("graph: the slab kernel ran on an image under the gate")
    if n_kf <= kfs_boot:
        fail("graph: no keyframe was decided by the graph path")
    if gs.n_frame_marginalizations < 1:
        fail("graph: no frame was marginalized by the graph path")
    if not GRAPH_KF_RANGE[0] <= n_kf <= GRAPH_KF_RANGE[1]:
        fail(f"graph: KF count {n_kf} outside {GRAPH_KF_RANGE}")
    if not ate <= GRAPH_ATE_MAX:
        fail(f"graph: ATE {ate} > {GRAPH_ATE_MAX}")

    # ---- report: each kernel at the shape its main path gives it ----
    def row(name, source, replaces, key, col):
        k_ms, p_ms = timing[key]
        b_ms, b_by = bounds[key]
        by_path = {path: n[col] for path, n in launches.items()}
        if sum(by_path.values()) <= 0:
            fail(f"{name} was launched by no path")
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max_err[name], "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None,  # no single PyTorch call computes the search
            "shape": " ".join(key[1:]),
            "times": {" ".join(k[1:]): {"ms": v[0], "plain_ms": v[1], "bound_ms": bounds[k][0]}
                      for k, v in timing.items() if k[0] == name},
        }

    report = {"kernels": [
        row("epipolar_search", "stereo_dso_g2o_tpu_torch/csrc/epipolar_search.cu",
            "stereo_dso_g2o_tpu/ops/trace_pallas.py:449",
            ("epipolar_search", f"{W_}x{H_}", "temporal N=5120"), 0),
        row("epipolar_search_slab", "stereo_dso_g2o_tpu_torch/csrc/epipolar_search_slab.cu",
            "stereo_dso_g2o_tpu/ops/trace_pallas.py:194",
            ("epipolar_search_slab", f"{W2}x{H2}", f"stereo L->R N={N_MATCH}"), 1),
    ]}
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
