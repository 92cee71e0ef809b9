"""Shared helpers of the tests that hold the PyTorch port against the JAX
package: numpy hand-over, the JAX thinning draw, and state snapshots for
`stereo_dso_g2o_tpu_torch.bridge`."""

import dataclasses

import jax
import numpy as np
import torch

# tier-1 runs several test processes at once: keep torch's pool small
torch.set_num_threads(2)


def t(x, dtype=None):
    """JAX/numpy array -> CPU torch tensor (float64 arrays become float32:
    tests/conftest.py turns on jax x64, the port is float32)."""
    a = np.array(x)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    out = torch.from_numpy(a)
    return out if dtype is None else out.to(dtype)


def n(x):
    """torch tensor -> numpy."""
    return x.detach().cpu().numpy()


class ReadCounter:
    """Counts, through `monkeypatch`, every Python-level read of a tensor's
    value on the host (`bool`, `int`, `float`, `index`, `.item`, `.tolist`,
    `.cpu`, `.numpy`) while `on`; `n` is the count, `by` per method."""

    READS = ("__bool__", "__int__", "__float__", "__index__", "item", "tolist", "cpu", "numpy")

    def __init__(self, monkeypatch):
        self.n, self.by, self.on = 0, {}, True
        for name in self.READS:
            inner = getattr(torch.Tensor, name)

            def spy(*a, _inner=inner, _name=name, **kw):
                if self.on:
                    self.n += 1
                    self.by[_name] = self.by.get(_name, 0) + 1
                return _inner(*a, **kw)

            monkeypatch.setattr(torch.Tensor, name, spy)


def jax_uniform(salt, shape, device="cpu"):
    """The JAX package's selector thinning draw, for PixelSelector(uniform=)."""
    u = jax.random.uniform(jax.random.PRNGKey(salt & 0x7FFFFFFF), shape)
    return torch.from_numpy(np.array(u)).to(device)


def fields(obj):
    """numpy dict of a flax struct dataclass's leaves."""
    return {f.name: np.array(getattr(obj, f.name)) for f in dataclasses.fields(obj)}


def fs_snapshot(fs):
    """Snapshot of a JAX FullSystem for bridge.full_system_from_snapshot."""
    return dict(
        win=fields(fs.win),
        imm=fields(fs.imm),
        tracker_ref=[tuple(np.array(x) for x in lvl) for lvl in fs.tracker.ref],
        tracker_ref_aff=np.array(fs.tracker.ref_aff),
        tracker_ref_exposure=fs.tracker.ref_exposure,
        tracker_first_coarse_rmse=fs.tracker.first_coarse_rmse,
        tracker_ref_frame_id=fs.tracker.ref_frame_id,
        dI_slots=[None if p is None else tuple(np.array(x) for x in p) for p in fs.dI_slots],
        right_slots=[None if r is None else np.array(r) for r in fs.right_slots],
        history=[dataclasses.asdict(h) for h in fs.history],
        kf_slots=list(fs.kf_slots),
        slot_frame_id=dict(fs.slot_frame_id),
        slot_meta=dict(fs.slot_meta),
        kf_out_count=np.array(fs.kf_out_count),
        current_min_act_dist=fs.current_min_act_dist,
        last_coarse_rmse=np.array(fs.last_coarse_rmse),
        next_kf_id=fs.next_kf_id,
        initialized=fs.initialized,
        is_lost=fs.is_lost,
        init_failed=fs.init_failed,
        selector_potential=fs.selector.current_potential,
        selector_calls=fs.selector._calls,
    )


def jax_graph_uniform(salt, shape, device="cpu"):
    """The thinning draw of the JAX graph_system's keyframe branch
    (graph_system.py:492-495), for GraphSystem(uniform=) / frame_auto(uniform=)."""
    key = jax.random.fold_in(jax.random.PRNGKey(17), np.uint32(salt))
    return torch.from_numpy(np.array(jax.random.uniform(key, shape))).to(device)


def _shell(h):
    return dict(id=h.id, timestamp=h.timestamp, T_cam_to_ref=np.array(h.T_cam_to_ref),
                ref_kf_id=h.ref_kf_id, aff=np.array(h.aff), is_kf=h.is_kf,
                T_cw=None if h.T_cw is None else np.array(h.T_cw))


def graph_state_snapshot(st):
    """A JAX GraphState as numpy, for bridge.graph_state_from_numpy."""
    scalars = {
        k: np.array(getattr(st, k))
        for k in st._fields if k not in ("win", "imm", "ref", "dI0_slots")
    }
    return dict(
        win=fields(st.win),
        imm=fields(st.imm),
        ref=[tuple(np.array(x) for x in lvl) for lvl in st.ref],
        dI0_slots=np.array(st.dI0_slots),
        scalars=scalars,
    )


def gs_snapshot(gs):
    """Snapshot of a JAX GraphSystem for bridge.graph_system_from_snapshot."""
    return dict(
        **graph_state_snapshot(gs.state),
        history=[_shell(h) for h in gs.history],
        kf_shells=[_shell(h) for h in gs.kf_shells],
        slot_frame_id=dict(gs.slot_frame_id),
        pot=gs.pot,
        is_lost=gs.is_lost,
    )


def jax_graph_reference(w, h, base, n_boot, n_frames, seq=0, scene_frames=None):
    """The JAX package's bootstrap + GraphSystem run over the KITTI-settings
    corridor that chip_smoke.py drives through the port (sequence `seq` of
    bench.py: scene seed 100 + seq, exposure phase seq): KF frames and ATE,
    the bounds chip_smoke.py holds the port to. `scene_frames` sizes the
    corridor where it is longer than the run (chip_smoke.py builds every
    scene for 40 frames and drives the batched runner over the first 32).

        JAX_PLATFORMS=cpu python tests/_torch_parity.py 1216 352 0.54 12 40
        JAX_PLATFORMS=cpu python tests/_torch_parity.py 1216 352 0.54 12 32 <seq> 40
    """
    import time

    from stereo_dso_g2o_tpu.config import Settings
    from stereo_dso_g2o_tpu.frontend.full_system import FullSystem
    from stereo_dso_g2o_tpu.frontend.graph_system import GraphSystem
    from stereo_dso_g2o_tpu.io import synthetic, trajectory
    from stereo_dso_g2o_tpu.models.camera import make_calib

    step = 0.30
    settings = Settings(
        desired_point_density=2000.0, desired_immature_density=1500.0,
        immature_cap=2048, active_cap=2048,
        affine_opt_mode_a=0.0, affine_opt_mode_b=0.0,
    )
    K = synthetic.default_K(w, h, fov_deg=80.0)
    scene = synthetic.corridor_scene(seed=100 + seq,
                                     length=step * (scene_frames or n_frames) + 40.0,
                                     box_spacing=9.0, lateral=14.0)
    poses_cw = synthetic.forward_trajectory(n_frames, step=step, yaw_amp=0.10,
                                            yaw_period=80.0, seed=seq)
    expos = 1.0 + 0.12 * np.sin(0.25 * np.arange(n_frames) + seq)
    lefts, rights = synthetic.render_stereo_sequence_fast(scene, K, w, h, base, poses_cw, expos)
    calib = make_calib(K[0, 0], K[1, 1], K[0, 2], K[1, 2], base, w, h, n_levels=6)
    fs = FullSystem(calib, settings)
    t0 = time.perf_counter()
    for i in range(n_boot):
        fs.add_frame(lefts[i], rights[i], i, timestamp=0.1 * i)
    print(f"bootstrap {n_boot} frames: {time.perf_counter() - t0:.1f} s, "
          f"KFs {[s.id for s in fs.kf_shells]}", flush=True)
    gs = GraphSystem.from_full_system(fs)
    need_kf = []  # bench.py's record: frame i beside the bundle drained at it
    for i in range(n_boot, n_frames):
        t1 = time.perf_counter()
        b = gs.add_frame(lefts[i], rights[i], i, timestamp=0.1 * i)
        if b is not None:
            need_kf.append((i, bool(b.need_kf)))
        print(f"frame {i}: {time.perf_counter() - t1:.1f} s", flush=True)
    traj = gs.trajectory()
    gt = [np.linalg.inv(T) for T in poses_cw]
    rel_t, rel_r = trajectory.kitti_rel_errors(traj, gt, lengths=(10, 20, 30, 40), step=5)
    out = dict(w=w, h=h, n_boot=n_boot, n_frames=n_frames, seq=seq, lost=bool(gs.is_lost),
               kf_frames=[s.id for s in gs.kf_shells], n_kf=len(gs.kf_shells),
               ate=float(trajectory.ate_rmse(traj, gt)),
               rel_trans_pct=float(rel_t), rel_rot_degpm=float(rel_r),
               n_finite=int(sum(bool(np.isfinite(T).all()) for T in traj)),
               need_kf_frames=[i for i, k in need_kf if k], need_kf=[int(k) for _, k in need_kf],
               seconds=round(time.perf_counter() - t0, 1))
    print(out, flush=True)
    return out


def jax_playback_reference(seq_dir, n_frames=40):
    """The [playback] cell of chip_smoke.py through the JAX package: corridor
    sequence 0 (chip_smoke.py's scene, trajectory and exposures) rendered by
    the JAX ray caster at KITTI 05's image size, 1226x370, written in the
    KITTI layout with a `crop` calib (stereo_dso_g2o_tpu_torch.io.dataset.
    write_sequence), then the repository's run_odometry.py over it as a user
    runs it: KF count, ATE against the renderer's poses, lost, finite poses.

        JAX_PLATFORMS=cpu python tests/_torch_parity.py playback <empty dir>
    """
    import os
    import re
    import subprocess
    import sys
    import time

    from stereo_dso_g2o_tpu.io import synthetic, trajectory
    from stereo_dso_g2o_tpu_torch.io.dataset import write_sequence

    w, h, base, step = 1226, 370, 0.54, 0.30
    K = synthetic.default_K(w, h, fov_deg=80.0)
    scene = synthetic.corridor_scene(seed=100, length=step * n_frames + 40.0,
                                     box_spacing=9.0, lateral=14.0)
    poses_cw = synthetic.forward_trajectory(n_frames, step=step, yaw_amp=0.10,
                                            yaw_period=80.0, seed=0)
    expos = 1.0 + 0.12 * np.sin(0.25 * np.arange(n_frames))
    lefts, rights = synthetic.render_stereo_sequence_fast(scene, K, w, h, base, poses_cw, expos)
    seq, calib = write_sequence(seq_dir, lefts, rights, K, base, expos, out_mode="crop")
    out = os.path.join(seq_dir, "jax_traj.txt")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, os.path.join(root, "run_odometry.py"), f"files={seq}", f"calib={calib}",
         "preset=0", "quiet=1", "levels=6", f"output={out}"],
        capture_output=True, text=True, check=True, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    print(run.stdout, flush=True)
    traj = trajectory.read_kitti(out)
    gt = [np.linalg.inv(T) for T in poses_cw]
    res = dict(frames=len(traj), lost="LOST" in run.stdout,
               n_kf=int(re.search(r"\((\d+) keyframes\)", run.stdout).group(1)),
               ate=float(trajectory.ate_rmse(traj, gt[: len(traj)])),
               finite=bool(all(np.isfinite(T).all() for T in traj)),
               seconds=round(time.perf_counter() - t0, 1))
    print(res, flush=True)
    return res


INIT_MOTION = (0.06, 0.015, 0.02, 0.0, 0.004, 0.0)  # tests/test_initializer.py:51


def jax_initializer_reference(w=1216, h=352, n_levels=6, n_frames=7):
    """The JAX package's mono initializer over tests/test_initializer.py's
    scene and motion, rendered at w x h (the numpy plane renderer, which
    the port has bit for bit): the frame it snaps at, whether it is ready,
    good points per level, and the port's score_against_truth of its
    result. chip_smoke.py's
    [initializer] holds the port on the card to these numbers.

        JAX_PLATFORMS=cpu python tests/_torch_parity.py initializer
    """
    import time

    import jax.numpy as jnp

    from stereo_dso_g2o_tpu.config import Settings
    from stereo_dso_g2o_tpu.frontend.initializer import MonoInitializer
    from stereo_dso_g2o_tpu.io import synthetic
    from stereo_dso_g2o_tpu.models.camera import make_calib
    from stereo_dso_g2o_tpu.ops.pyramid import build_pyramid
    from stereo_dso_g2o_tpu.utils import se3
    from stereo_dso_g2o_tpu_torch.frontend.initializer import score_against_truth

    scene = synthetic.default_scene(13)
    K = synthetic.default_K(w, h)
    calib = make_calib(K[0, 0], K[1, 1], K[0, 2], K[1, 2], 0.1, w, h, n_levels=n_levels)
    img0, idepth0 = synthetic.render(scene, K, w, h, np.eye(4))
    ini = MonoInitializer(calib, Settings(desired_point_density=600.0, immature_cap=512,
                                          active_cap=1024))
    ini.set_first(*build_pyramid(jnp.asarray(img0), n_levels))
    t0 = time.perf_counter()
    ready = []
    for i in range(1, n_frames + 1):
        T = np.asarray(se3.se3_exp(jnp.asarray(np.asarray(INIT_MOTION) * i, jnp.float32)),
                       np.float64)
        img, _ = synthetic.render(scene, K, w, h, T)
        ready.append(bool(ini.track_frame(build_pyramid(jnp.asarray(img), n_levels)[0])))
    L = ini.levels[0]
    out = dict(w=w, h=h, n_levels=n_levels, n_frames=n_frames, snapped=bool(ini.snapped),
               snapped_at=ini.snapped_at, ready=ready,
               good_per_level=[int(np.sum(np.asarray(x.valid & x.is_good))) for x in ini.levels],
               seconds=round(time.perf_counter() - t0, 1),
               **score_against_truth(jax.device_get(L), idepth0, ini.this_to_next, T))
    print(out, flush=True)
    return out


def jax_probe(seq=0, n_frames=200, save=None):
    """tools/accuracy_probe.py's run, through the JAX package with x64 off
    as a user runs it (bench.py's frames and settings, the same loop), with
    the port's probe's extra keys: the keyframe frames, the largest
    |R^T R - I| over the poses and the rotation error of the poses made
    orthonormal. `save` writes the trajectory and the ground truth (npz).

        JAX_PLATFORMS=cpu python tests/_torch_parity.py probe <seq> [frames] [save.npz]
    """
    import time

    import bench
    from stereo_dso_g2o_tpu.config import Settings
    from stereo_dso_g2o_tpu.frontend.full_system import FullSystem
    from stereo_dso_g2o_tpu.frontend.graph_system import GraphSystem
    from stereo_dso_g2o_tpu.io import trajectory
    from stereo_dso_g2o_tpu.models.camera import make_calib
    from stereo_dso_g2o_tpu_torch.tools.accuracy_probe import orthonormalized, rot_orth_max

    jax.config.update("jax_default_matmul_precision", "highest")
    settings = Settings(desired_point_density=2000.0, desired_immature_density=1500.0,
                        immature_cap=2048, active_cap=2048,
                        affine_opt_mode_a=0.0, affine_opt_mode_b=0.0)
    K, seqs = bench.render_sequences()
    calib = make_calib(K[0, 0], K[1, 1], K[0, 2], K[1, 2], bench.BASE, bench.W_, bench.H_,
                       n_levels=6)
    lefts, rights, poses = seqs[seq]
    fs = FullSystem(calib, settings)
    for i in range(bench.BOOT):
        fs.add_frame(lefts[i], rights[i], i, timestamp=0.1 * i)
    gs = GraphSystem.from_full_system(fs)
    lefts_d = jax.block_until_ready(jax.numpy.asarray(lefts[:n_frames]))
    rights_d = jax.block_until_ready(jax.numpy.asarray(rights[:n_frames]))
    t0 = time.perf_counter()
    for i in range(bench.BOOT, n_frames):
        gs.add_frame(lefts_d[i], rights_d[i], i, timestamp=0.1 * i)
    gs.flush()
    wall = time.perf_counter() - t0
    traj = gs.trajectory()
    gt = poses[:n_frames]
    rel_t, rel_r = trajectory.kitti_rel_errors(traj, gt, lengths=(10, 20, 30, 40), step=5)
    _, rel_r_svd = trajectory.kitti_rel_errors(orthonormalized(traj), gt,
                                               lengths=(10, 20, 30, 40), step=5)
    out = dict(backend=jax.default_backend(), seq=seq, n_frames=n_frames,
               ate_rmse_m=float(trajectory.ate_rmse(traj, gt)),
               kitti_rel_trans_pct=float(rel_t), kitti_rel_rot_degpm=float(rel_r),
               n_keyframes=len(gs.kf_shells), lost=bool(gs.is_lost), wall_s=round(wall, 1),
               kf_frames=[s.id for s in gs.kf_shells], rot_orth_max=rot_orth_max(traj),
               kitti_rel_rot_degpm_orthonormal=float(rel_r_svd))
    if save:
        np.savez(save, traj=np.stack(traj), gt=np.stack(gt))
    print(out, flush=True)
    return out


if __name__ == "__main__":
    import sys

    a = sys.argv[1:]
    if a[0] == "playback":
        jax_playback_reference(a[1])
    elif a[0] == "initializer":
        jax_initializer_reference()
    elif a[0] == "probe":
        jax_probe(int(a[1]), *(int(x) for x in a[2:3]), *a[3:4])
    else:
        jax_graph_reference(int(a[0]), int(a[1]), float(a[2]), int(a[3]), int(a[4]),
                            *(int(x) for x in a[5:7]))
