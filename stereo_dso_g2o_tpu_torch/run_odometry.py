#!/usr/bin/env python
"""CLI playback driver — the main_dso_pangolin.cpp equivalent, on the
PyTorch port (counterpart of the repository's `run_odometry.py`).

Usage (key=value arguments like the reference, main_dso_pangolin.cpp:146-341):

    python -m stereo_dso_g2o_tpu_torch.run_odometry files=/path/to/kitti/seq/05 \\
        calib=/path/camera.txt preset=0 output=traj.txt

    python -m stereo_dso_g2o_tpu_torch.run_odometry files=... intrinsics=fx,fy,cx,cy baseline=0.54

    # idepth-map-only workload (MODE_STEREOMATCH, main:473-491):
    python -m stereo_dso_g2o_tpu_torch.run_odometry files=... calib=... stereomatch=1

    # synthetic self-test (no dataset needed):
    python -m stereo_dso_g2o_tpu_torch.run_odometry synthetic=20

Keys: files calib intrinsics baseline gamma vignette levels maxframes start
stereomatch preset quiet feed viz prefetch graph output synthetic, as the
JAX CLI reads them, and `device=` (default: the GPU; `device=cpu` runs on
the CPU; without a GPU and without it, the run raises).

Presets 0-3 mirror the reference's settingsDefault (main:90-144): point
densities, window size; realtime throttling is meaningless in playback and is
ignored. `quiet=1` silences per-frame output. A timing report (fps, ms/frame)
is printed at the end like main:534-545.
"""

from __future__ import annotations

import sys
import time

import numpy as np


def parse_args(argv):
    args = {}
    for a in argv:
        if "=" in a:
            k, v = a.split("=", 1)
            args[k] = v
    return args


def apply_preset(preset: int):
    from stereo_dso_g2o_tpu_torch.config import Settings

    # main_dso_pangolin.cpp:90-144 settingsDefault
    if preset in (0, 1):
        return Settings(
            desired_point_density=2000.0,
            desired_immature_density=1500.0,
            max_frames=7,
            min_frames=5,
            max_opt_iterations=6,
            min_opt_iterations=1,
            immature_cap=2048,
            active_cap=2048,
        )
    # fast presets 2/3: 800 points, 5-frame window
    return Settings(
        desired_point_density=800.0,
        desired_immature_density=600.0,
        max_frames=5,
        min_frames=4,
        max_opt_iterations=4,
        min_opt_iterations=1,
        immature_cap=1024,
        active_cap=1024,
    )


def synthetic_pose(i: int) -> np.ndarray:
    """Frame i's world-to-camera pose of `synthetic=N` (float64), the exp of
    a float32 twist as the reference computes it."""
    import torch

    from stereo_dso_g2o_tpu_torch.utils import se3

    xi = np.array([0.025 * i, -0.008 * i, 0.04 * i, 0.002 * i, 0.004 * i, -0.001 * i])
    return se3.se3_exp(torch.as_tensor(xi, dtype=torch.float32)).numpy().astype(np.float64)


def run_synthetic(n_frames: int, quiet: bool, device):
    from stereo_dso_g2o_tpu_torch.frontend.full_system import FullSystem
    from stereo_dso_g2o_tpu_torch.io import synthetic, trajectory
    from stereo_dso_g2o_tpu_torch.models.camera import make_calib

    w, h, b = 256, 128, 0.12
    K = synthetic.default_K(w, h)
    scene = synthetic.default_scene(0)
    calib = make_calib(K[0, 0], K[1, 1], K[0, 2], K[1, 2], b, w, h, n_levels=5, device=device)
    fs = FullSystem(calib, apply_preset(2), device=device)
    gt = []
    t0 = time.perf_counter()
    for i in range(n_frames):
        T = synthetic_pose(i)
        gt.append(np.linalg.inv(T))
        left, right, _ = synthetic.render_stereo_pair(scene, K, w, h, b, T)
        fs.add_frame(left, right, i, timestamp=0.1 * i)
        if not quiet:
            print(f"frame {i}: kfs={len(fs.kf_slots)} lost={fs.is_lost}")
    dt = time.perf_counter() - t0
    traj = fs.trajectory()
    ate = trajectory.ate_rmse(traj, gt)
    print(f"synthetic run: {n_frames} frames, ATE={ate * 1000:.2f}mm, "
          f"{n_frames / dt:.2f} fps ({1000 * dt / n_frames:.1f} ms/frame incl. warm-up)")
    return {"rc": 0, "frames": n_frames, "ate": ate, "keyframes": len(fs.kf_shells)}


def run(argv) -> dict:
    """main's body: plays the sequence and prints as main does; returns a
    summary dict with `rc` (main's exit code) and what the run measured."""
    from stereo_dso_g2o_tpu_torch import default_device

    args = parse_args(argv)
    quiet = args.get("quiet", "0") == "1"
    device = default_device(args.get("device"))

    if "synthetic" in args:
        return run_synthetic(int(args["synthetic"]), quiet, device)

    from stereo_dso_g2o_tpu_torch.frontend.full_system import FullSystem, device_image
    from stereo_dso_g2o_tpu_torch.frontend.graph_system import GraphSystem
    from stereo_dso_g2o_tpu_torch.frontend.stereo_match import stereo_match
    from stereo_dso_g2o_tpu_torch.io import trajectory
    from stereo_dso_g2o_tpu_torch.io.dataset import StereoDataset
    from stereo_dso_g2o_tpu_torch.io.output_wrapper import JsonlOutputWrapper, SampleOutputWrapper
    from stereo_dso_g2o_tpu_torch.runtime import native_loader

    files = args.get("files")
    if not files:
        print(__doc__)
        return {"rc": 1}

    intr = None
    if "intrinsics" in args:
        intr = tuple(float(v) for v in args["intrinsics"].split(","))
    ds = StereoDataset(
        files,
        calib_file=args.get("calib"),
        intrinsics=intr,
        baseline=float(args["baseline"]) if "baseline" in args else None,
        gamma_file=args.get("gamma"),
        vignette_file=args.get("vignette"),
        n_levels=int(args.get("levels", 6)),
        device=device,
    )
    n = len(ds)
    if "maxframes" in args:
        n = min(n, int(args["maxframes"]))
    start = int(args.get("start", 0))

    if args.get("stereomatch", "0") == "1":
        # MODE_STEREOMATCH (FullSystem::stereoMatch per pair)
        good = []
        for i in range(start, n):
            left, right, ts, exp = ds.get(i)
            result, imap = stereo_match(left, right, ds.calib, device=device)
            good.append(int(result.good.sum()))
            print(f"frameID {i} got good matches {good[-1]}")
        return {"rc": 0, "good": good}

    settings = apply_preset(int(args.get("preset", 0)))
    fs = FullSystem(ds.calib, settings, device=device)
    wrapper = SampleOutputWrapper() if not quiet else None
    feed_fh = None
    if "feed" in args:
        feed_fh = open(args["feed"], "w")
        wrapper = JsonlOutputWrapper(feed_fh)
    viz = args.get("viz")
    accum = None
    if viz or feed_fh:
        from stereo_dso_g2o_tpu_torch.io.viewer import CloudAccumulator

        accum = CloudAccumulator()

    # Frame stream: native C++ prefetch (decode + remap + photometric on
    # worker threads) unless disabled via prefetch=0 or start/maxframes
    # windowing needs random access.
    streamed = args.get("prefetch", "1") == "1" and start == 0 and n == len(ds)
    source = ds.frame_source() if streamed else "get"
    if source == "native":
        print("frames: native loader (decode, remap and photometric correction on host threads)")
    else:
        why = ("prefetch=0 or start/maxframes given" if not streamed
               else "a zip source" if native_loader.available()
               else f"native loader unavailable: {native_loader.build_error()}")
        print(f"frames: StereoDataset.get, remap and photometric correction on {device} ({why})")

    def frames():
        if streamed:
            for i, item in enumerate(ds.prefetch()):
                yield (i, *item)
        else:
            for i in range(start, n):
                yield (i, *ds.get(i))

    # graph=1 (default): after host bootstrap, continue on the frame program
    # (graph=0 keeps the host orchestrator for the whole run)
    use_graph = args.get("graph", "1") == "1"

    try:
        t0 = time.perf_counter()
        t_last = t0
        frame_ms = []
        n_done = 0
        n_kfs_seen = 0
        switch_frame = None
        resets = []
        for i, left, right, ts, exp in frames():
            if (
                use_graph
                and isinstance(fs, FullSystem)
                and fs.initialized
                and not fs.init_failed
                and not fs.is_lost
                and len(fs.kf_shells) >= 4
                and len(fs.history) >= 3
            ):
                fs = GraphSystem.from_full_system(fs)
                switch_frame = i
                print(f"switched to GraphSystem at frame {i}")
            fs.add_frame(device_image(left, device), device_image(right, device), i,
                         timestamp=ts, exposure=exp)
            n_done += 1
            if wrapper and fs.history:
                sh = fs.history[-1]
                wrapper.publish_cam_pose(sh.id, fs._shell_T_cw(sh), sh.timestamp)
            if accum is not None and len(fs.kf_shells) > n_kfs_seen:
                n_kfs_seen = len(fs.kf_shells)
                accum.update_from(fs)
                if wrapper:
                    wrapper.publish_keyframes(
                        [(k, sh.T_cw) for k, sh in enumerate(fs.kf_shells)
                         if sh.T_cw is not None],
                        fs.point_cloud(),
                    )
            t_now = time.perf_counter()
            frame_ms.append(1000.0 * (t_now - t_last))
            t_last = t_now
            if fs.init_failed and len(fs.kf_shells) <= 4:
                # full reset, keep playing (main_dso_pangolin.cpp:497-514)
                print(f"RESETTING at frame {i} (initialization failed)")
                resets.append(i)
                fs = FullSystem(ds.calib, settings, device=device)
                continue
            if fs.is_lost:
                print("LOST: aborting (reference aborts too, main:516-519)")
                break
    finally:
        if feed_fh:
            feed_fh.close()
    dt = time.perf_counter() - t0

    out = args.get("output", "result.txt")
    traj = fs.trajectory()
    trajectory.write_kitti(out, traj)
    med = float(np.median(frame_ms)) if frame_ms else float("nan")
    print(
        f"processed {n_done} frames in {dt:.1f}s "
        f"({n_done / max(dt, 1e-9):.2f} fps, {1000 * dt / max(n_done, 1):.1f} ms/frame, "
        f"median {med:.1f})"
    )
    print(f"trajectory written to {out} ({len(fs.kf_shells)} keyframes)")
    if feed_fh:
        print(f"viewer feed written to {args['feed']}")
    n_points = 0
    if viz:
        from stereo_dso_g2o_tpu_torch.io.viewer import render_run

        xyz, idp = accum.cloud()
        n_points = len(xyz)
        render_run(viz, traj, xyz, idp)
        print(f"visualization written to {viz} ({n_points} points)")
    return {
        "rc": 0, "frames": n_done, "seconds": dt, "frame_ms": frame_ms,
        "switch_frame": switch_frame, "keyframes": len(fs.kf_shells),
        "lost": bool(fs.is_lost), "resets": resets, "source": source,
        "trajectory": traj,
    }


def main(argv):
    return run(argv)["rc"]


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
