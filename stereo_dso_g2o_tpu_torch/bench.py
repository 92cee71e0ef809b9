"""Benchmark entry of the port: prints JSON lines; the LAST line is the
headline result {"metric", "value", "unit", "vs_baseline", ...}.

Port of the repository's `bench.py`, run the same way on the same
workload: full stereo direct SLAM at KITTI resolution (1216x352) on the
rendered hostile synthetic corridor (multi-box street with occlusion
boundaries, depth discontinuities, ground plane, side facades, sinusoidal
exposure the engine is not told of, a forward trajectory with yaw),
through the per-frame graph pipeline with steady-state window churn.

    python -m stereo_dso_g2o_tpu_torch.bench [frames=200] [nseq=4] [small=0]
        [ladder_fine=2] [obs=.cache/torch_bench_obs.jsonl] [device=cuda|cpu]

In order, as `bench.py` prints them: progress lines (the device first),
the single-sequence line `full_slam_single_seq_fps_...` (sequence 0: 12
host-bootstrap frames through `FullSystem`, `GraphSystem.from_full_system`,
8 warm frames, the rest timed; ATE and KITTI relative errors against the
renderer's poses), the observability record written to `obs=` (each timed
frame's keyframe-decision terms, the final window's eigenvalue record),
the batched line `full_slam_agg_fps_...` (`BatchedRunner` over `nseq`
bootstrapped sequences, 8 warm frames, up to 100 timed), and the headline
`full_slam_fps_per_chip_...`, the better of the two.

Frames are rendered on the device and stay there; a frame's host clock
stamp does not wait for the device (the frame program reads `need_kf` on
the host every frame), and the device is synchronized before each stamp
that opens or closes a timed window. `small=1` is bench.py's smoke mode (2
sequences x 40 frames at 256x128). `frames=` cuts the sequences.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

BOOT = 12  # host-bootstrap frames per sequence (initialization)
WARM = 8  # untimed graph frames before each timed window
BATCH_TIMED_MAX = 108  # the batched window ends by frame BOOT + 108
BASELINE_FPS = 18.9  # reference KITTI 05 full pipeline (BASELINE.md)
OBS_DEFAULT = Path(__file__).resolve().parents[1] / ".cache" / "torch_bench_obs.jsonl"


def emit(obj):
    print(json.dumps(obj), flush=True)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench_config(small: bool) -> dict:
    """bench.py's full or smoke mode: sequences, frames, image size,
    baseline, corridor (lateral, box spacing, step) and the Settings'
    densities and caps."""
    if small:
        return dict(n_seq=2, n_frames=40, w=256, h=128, base=0.2, lateral=6.0, box_spacing=5.0,
                    step=0.12, density=600.0, imm_density=450.0, imm_cap=512, act_cap=1024)
    return dict(n_seq=4, n_frames=200, w=1216, h=352, base=0.54, lateral=14.0, box_spacing=9.0,
                step=0.30, density=2000.0, imm_density=1500.0, imm_cap=2048, act_cap=2048)


def render_sequence(cfg, s, n_frames, device):
    """Corridor sequence `s` rendered on `device`: (K, (lefts (N,h,w) uint8,
    rights, poses_wc (N,4,4) numpy))."""
    from stereo_dso_g2o_tpu_torch.io import synthetic

    w, h = cfg["w"], cfg["h"]
    K = synthetic.default_K(w, h, fov_deg=80.0)
    t0 = time.perf_counter()
    # long enough that structure stays 5-40 m ahead for every frame
    scene = synthetic.corridor_scene(seed=100 + s, length=cfg["step"] * n_frames + 40.0,
                                     box_spacing=cfg["box_spacing"], lateral=cfg["lateral"])
    poses_cw = synthetic.forward_trajectory(n_frames, step=cfg["step"], yaw_amp=0.10,
                                            yaw_period=80.0, seed=s)
    expos = 1.0 + 0.12 * np.sin(0.25 * np.arange(n_frames) + s)
    lefts, rights = synthetic.render_stereo_sequence_fast(
        scene, K, w, h, cfg["base"], poses_cw, expos, device=device)
    _sync(device)
    emit({"progress": "rendered_seq", "seq": s, "secs": round(time.perf_counter() - t0, 1)})
    return K, (lefts, rights, np.stack([np.linalg.inv(T) for T in poses_cw]))


def render_sequences(cfg, n_seq, n_frames, device):
    """`n_seq` corridor sequences rendered on `device`: (K, [(lefts (N,h,w)
    uint8, rights, poses_wc (N,4,4) numpy)])."""
    seqs = [render_sequence(cfg, s, n_frames, device) for s in range(n_seq)]
    return seqs[0][0], [seq for _, seq in seqs]


def bench_settings(cfg, ladder_fine=None):
    """The Settings bench.py runs: the config's densities and caps, affine
    modes 0 (the exposure is synthesized but NOT fed to the engine:
    uncalibrated input, so the affine brightness is free, the reference's
    KITTI operating point), and `ladder_fine_levels` when given."""
    from stereo_dso_g2o_tpu_torch.config import Settings

    lf = {} if ladder_fine is None else {"ladder_fine_levels": int(ladder_fine)}
    return Settings(
        desired_point_density=cfg["density"], desired_immature_density=cfg["imm_density"],
        immature_cap=cfg["imm_cap"], active_cap=cfg["act_cap"],
        affine_opt_mode_a=0.0, affine_opt_mode_b=0.0, **lf,
    )


def device_line(device):
    """The device a run's numbers belong to."""
    line = {"progress": "device", "device": str(device)}
    if device.type == "cuda":
        line["name"] = torch.cuda.get_device_name(device)
        try:
            line["nvidia_smi"] = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                capture_output=True, text=True, check=True, timeout=60,
            ).stdout.strip().splitlines()[device.index or 0]
        except (OSError, subprocess.SubprocessError, IndexError):
            pass
    return line


def _kf_record(i, b):
    """bench.py's per-frame keyframe-decision record (the bundle drained at
    frame i, `fetch_lag` frames behind it)."""
    rec = {
        "frame": i, "need_kf": bool(b.need_kf),
        "kf_delta": round(float(b.kf_delta), 4),
        "kf_rmse": round(float(b.kf_rmse), 3),
        "kf_first_rmse": round(float(b.kf_first_rmse), 3),
    }
    if bool(b.need_kf):
        rec.update({
            "energy": float(b.energy),
            "nres": int(b.nres), "n_active": int(b.n_active),
            "n_activated": int(b.n_activated), "n_imm": int(b.n_imm),
            "n_marg": int(b.n_marg), "n_dropped": int(b.n_dropped),
            "sel_num": int(b.sel_num),
        })
    return rec


def main(frames=None, nseq=None, small=False, ladder_fine=None, obs=None, device=None) -> dict:
    """Run the benchmark and print its lines. Returns what it measured:
    the three result lines, sequence 0's trajectory, keyframe frames and
    frame records, and the epipolar kernel's launches in the single and
    batched runs."""
    from stereo_dso_g2o_tpu_torch import default_device
    from stereo_dso_g2o_tpu_torch.frontend.full_system import FullSystem
    from stereo_dso_g2o_tpu_torch.frontend.graph_system import GraphSystem
    from stereo_dso_g2o_tpu_torch.io import trajectory
    from stereo_dso_g2o_tpu_torch.models.camera import make_calib
    from stereo_dso_g2o_tpu_torch.ops import trace_cuda
    from stereo_dso_g2o_tpu_torch.parallel.batched import BatchedRunner
    from stereo_dso_g2o_tpu_torch.runtime.diagnostics import eigenvalue_record

    dev = default_device(device)
    cfg = bench_config(bool(small))
    n_seq = cfg["n_seq"] if nseq is None else int(nseq)
    n_frames = cfg["n_frames"] if frames is None else int(frames)
    if n_frames < BOOT + WARM + 1:
        raise ValueError(f"frames={n_frames}: the timed window needs more than {BOOT + WARM}")
    emit(device_line(dev))
    settings = bench_settings(cfg, ladder_fine)
    t_render0 = time.perf_counter()
    K, seqs = render_sequences(cfg, n_seq, n_frames, dev)
    emit({"progress": "frames_ready", "secs": round(time.perf_counter() - t_render0, 1)})
    calib = make_calib(K[0, 0], K[1, 1], K[0, 2], K[1, 2], cfg["base"], cfg["w"], cfg["h"],
                       n_levels=6, device=dev)

    def bootstrap(lefts, rights):
        fs = FullSystem(calib, settings, device=dev)
        for i in range(BOOT):
            fs.add_frame(lefts[i], rights[i], i, timestamp=0.1 * i)
        return GraphSystem.from_full_system(fs)

    # ---- single-sequence run (accuracy + single-seq fps) ----
    lefts0, rights0, poses0 = seqs[0]
    k1_start = trace_cuda.LAUNCHES
    gs = bootstrap(lefts0, rights0)
    warm_until = BOOT + WARM  # the keyframe and non-keyframe paths both run before timing
    for i in range(BOOT, warm_until):
        gs.add_frame(lefts0[i], rights0[i], i, timestamp=0.1 * i)
    emit({"progress": "single_seq_warm"})
    obs_recs = []  # per-frame keyframe-decision records
    frame_ts = []  # per-frame host stamps: a p50 fps beside the mean
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(warm_until, n_frames):
        frame_ts.append(time.perf_counter())
        b = gs.add_frame(lefts0[i], rights0[i], i, timestamp=0.1 * i)
        if b is not None:
            obs_recs.append(_kf_record(i, b))
    _sync(dev)
    t1 = time.perf_counter()
    dt_single = (t1 - t0) / (n_frames - warm_until)
    single_fps = 1.0 / dt_single
    frame_ts.append(t1)
    d = np.diff(np.asarray(frame_ts))
    fps_p50 = float(1.0 / np.median(d)) if d.size else single_fps

    traj = gs.trajectory()
    k1_single = trace_cuda.LAUNCHES - k1_start
    n_finite = int(sum(bool(np.isfinite(T).all()) for T in traj))
    try:
        ate = trajectory.ate_rmse(traj, poses0)
        rel_t, rel_r = trajectory.kitti_rel_errors(traj, poses0, lengths=(10, 20, 30, 40), step=5)
    except Exception:
        ate, rel_t, rel_r = float("nan"), float("nan"), float("nan")
    common = {
        "unit": "frames/sec/chip",
        "single_seq_fps": round(single_fps, 2),
        "single_seq_fps_p50": round(fps_p50, 2),
        "ate_rmse_m": round(float(ate), 4) if np.isfinite(ate) else None,
        "n_finite_frames": n_finite,
        "lost": bool(gs.is_lost),
        # rel errors need >= 10 m segments; guard so the JSON stays parseable
        "kitti_rel_trans_pct": round(rel_t, 3) if np.isfinite(rel_t) else None,
        "kitti_rel_rot_degpm": round(rel_r, 5) if np.isfinite(rel_r) else None,
        "n_keyframes": len(gs.kf_shells),
        "n_frames": n_frames,
    }
    # progressive result: should the batched phase be cut, this line is
    # still a complete single-sequence datum
    lines = [dict(
        metric="full_slam_single_seq_fps_kitti_res_hostile_synthetic",
        value=round(single_fps, 2), vs_baseline=round(single_fps / BASELINE_FPS, 3), **common,
    )]
    emit(lines[-1])

    # the frame records and the final window's eigenvalue spectrum, after
    # the progressive result
    obs_path = Path(obs) if obs else OBS_DEFAULT
    try:
        obs_path.parent.mkdir(parents=True, exist_ok=True)
        with open(obs_path, "w") as f:
            for rec in obs_recs:
                f.write(json.dumps(rec) + "\n")
            eig = eigenvalue_record(gs.state.win, settings=settings)
            eig["final_window"] = True
            f.write(json.dumps(eig) + "\n")
        emit({"progress": "obs_archived", "n_frame_records": len(obs_recs), "path": str(obs_path)})
    except Exception as e:
        emit({"progress": "obs_failed", "err": repr(e)[:200]})

    # ---- batched n_seq aggregate throughput ----
    k1_start = trace_cuda.LAUNCHES
    runner = BatchedRunner([bootstrap(s[0], s[1]) for s in seqs])
    L_all = torch.stack([s[0] for s in seqs])  # (S, N, H, W) uint8, on the device
    R_all = torch.stack([s[1] for s in seqs])
    runner.warm_kf_buckets((L_all[:, BOOT], R_all[:, BOOT]))  # every program, before timing
    warm_until_b = BOOT + WARM
    for i in range(BOOT, warm_until_b):
        runner.add_frames((L_all[:, i], R_all[:, i]), i, timestamp=0.1 * i)
    emit({"progress": "batched_warm"})
    n_timed_b = min(n_frames, BOOT + BATCH_TIMED_MAX) - warm_until_b
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(warm_until_b, warm_until_b + n_timed_b):
        runner.add_frames((L_all[:, i], R_all[:, i]), i, timestamp=0.1 * i)
    _sync(dev)
    dt_b = time.perf_counter() - t0
    batched_trajs = runner.trajectories()  # lands the last keyframe hand-off
    k1_batched = trace_cuda.LAUNCHES - k1_start
    agg_fps = n_seq * n_timed_b / dt_b
    lines.append(dict(
        metric="full_slam_agg_fps_kitti_res_hostile_synthetic",
        value=round(agg_fps, 2), vs_baseline=round(agg_fps / BASELINE_FPS, 3),
        n_seq_batched=n_seq, **common,
    ))
    emit(lines[-1])

    # headline last: the better per-chip configuration of the two above
    best = max(single_fps, agg_fps)
    lines.append(dict(
        metric="full_slam_fps_per_chip_kitti_res_hostile_synthetic",
        value=round(best, 2), vs_baseline=round(best / BASELINE_FPS, 3),
        best_config_n_seq=1 if single_fps >= agg_fps else n_seq,
        agg_fps_batched=round(agg_fps, 2), **common,
    ))
    emit(lines[-1])
    return dict(lines=lines, traj=traj, kf_frames=[s.id for s in gs.kf_shells], obs=obs_recs,
                frames=(lefts0, rights0),
                launches={"single": k1_single, "batched": k1_batched},
                batched_trajs=batched_trajs)


def cli(argv) -> int:
    keys = ("frames", "nseq", "small", "ladder_fine", "obs", "device")
    args = {}
    for a in argv:
        k, _, v = a.partition("=")
        if k not in keys or not v:
            print(f"usage: python -m stereo_dso_g2o_tpu_torch.bench "
                  f"[{'] ['.join(k + '=...' for k in keys)}]", file=sys.stderr)
            return 2
        args[k] = v
    main(frames=args.get("frames"), nseq=args.get("nseq"), small=args.get("small") == "1",
         ladder_fine=args.get("ladder_fine"), obs=args.get("obs"), device=args.get("device"))
    return 0


if __name__ == "__main__":
    sys.exit(cli(sys.argv[1:]))
