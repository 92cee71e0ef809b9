"""The JAX package's reference checks of `FullSystem` held on the port, each
to the JAX test's own bound and with its mark: garbage input
(tests/test_full_system.py:130), the occlusion scene
(tests/test_full_system.py:96, slow), the long run with marginalization
cycles (tests/test_long_run.py:68, slow) and the KITTI-resolution envelope
(tests/test_kitti_res_accuracy.py:30, slow). The port runs on the CPU
here; on the card its stages are programs, and these checks hold the
same function."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from stereo_dso_g2o_tpu_torch.backend import window as W
from stereo_dso_g2o_tpu_torch.config import Settings
from stereo_dso_g2o_tpu_torch.frontend.full_system import FullSystem
from stereo_dso_g2o_tpu_torch.io import synthetic, trajectory
from stereo_dso_g2o_tpu_torch.models.camera import make_calib
from stereo_dso_g2o_tpu_torch.utils import se3

W_, H_ = 256, 128
BASE = 0.12
# tests/test_full_system.py's settings
SET = Settings(
    desired_point_density=600.0,
    desired_immature_density=450.0,
    immature_cap=512,
    active_cap=1024,
)


def _calib(K, baseline, w, h, levels):
    return make_calib(K[0, 0], K[1, 1], K[0, 2], K[1, 2], baseline, w, h, n_levels=levels,
                      device="cpu")


def test_garbage_input_no_crash():
    """Uncorrelated noise frames: the system fails gracefully (a declared
    failure, lost, or simply no tracking) and never crashes (reference
    resets, main_dso_pangolin.cpp:497-514)."""
    rng = np.random.default_rng(0)
    K = synthetic.default_K(W_, H_)
    fs = FullSystem(_calib(K, BASE, W_, H_, 5), SET, device="cpu")
    for i in range(5):
        left = rng.uniform(0, 255, (H_, W_)).astype(np.float32)
        right = rng.uniform(0, 255, (H_, W_)).astype(np.float32)
        fs.add_frame(left, right, i)
    assert isinstance(fs.init_failed, bool)
    traj = fs.trajectory()
    assert 1 <= len(traj) <= 5
    if len(traj) < 5 or not all(np.isfinite(T).all() for T in traj):
        # an early stop or a non-finite pose only with a declared failure
        assert fs.is_lost or fs.init_failed


@pytest.mark.slow
def test_full_system_occlusion_scene():
    """Odometry among boxes at staggered depths, a ground plane and side
    facades (occlusion boundaries, revealed background), exposure varying
    sinusoidally: ATE under 8 cm over ~5.3 m, at least 4 keyframes."""
    w, h = 256, 96
    baseline = 0.3
    K = synthetic.default_K(w, h, fov_deg=75.0)
    scene = synthetic.box_scene(seed=7, n_boxes=5, depth_range=(6.0, 25.0), lateral=8.0,
                                backdrop_dist=40.0)
    poses = synthetic.forward_trajectory(24, step=0.22, yaw_amp=0.10, yaw_period=30.0)
    fs = FullSystem(_calib(K, baseline, w, h, 5), SET, device="cpu")
    gt_c2w = []
    for i, T_cw in enumerate(poses):
        expo = 1.0 + 0.15 * np.sin(0.4 * i)
        left, right, _ = synthetic.render_multi_stereo_pair(scene, K, w, h, baseline, T_cw,
                                                            exposure=expo)
        fs.add_frame(left, right, i, timestamp=0.1 * i)
        assert not fs.is_lost, f"lost at frame {i}"
        gt_c2w.append(np.linalg.inv(T_cw))
    ate = trajectory.ate_rmse(fs.trajectory(), gt_c2w)
    assert ate < 0.08, ate
    assert len(fs.kf_shells) >= 4


@pytest.mark.slow
def test_long_sequence_with_marginalization_cycles():
    """24 frames at 192x96 with a 5-frame window: slots reused, the window
    full, ATE under 5 cm, the marginal prior finite and symmetric."""
    w, h, base = 192, 96, 0.1
    s = Settings(desired_point_density=400.0, desired_immature_density=300.0,
                 immature_cap=512, active_cap=512, min_frames=4, max_frames=5)
    scene = synthetic.default_scene(41)
    K = synthetic.default_K(w, h)
    fs = FullSystem(_calib(K, base, w, h, 4), s, device="cpu")
    poses, max_kfs = [], 0
    for i in range(24):
        xi = np.array([0.02 * i, -0.004 * i, 0.035 * i, 0.0, 0.012 * i, 0.0015 * i])
        T = se3.se3_exp(torch.as_tensor(xi)).numpy().astype(np.float64)
        poses.append(np.linalg.inv(T))
        left, right, _ = synthetic.render_stereo_pair(scene, K, w, h, base, T)
        fs.add_frame(left, right, i, timestamp=0.1 * i)
        assert not fs.is_lost, f"lost at {i}"
        max_kfs = max(max_kfs, len(fs.kf_slots))
        assert len(fs.kf_slots) <= s.max_frames + 1
        assert len(set(fs.kf_slots)) == len(fs.kf_slots)
    assert fs.next_kf_id > s.max_frames + 1, fs.next_kf_id  # slot reuse happened
    assert max_kfs >= s.max_frames
    ate = trajectory.ate_rmse(fs.trajectory(), poses)
    assert ate < 0.05, ate
    HM = fs.win.HM.numpy()
    assert np.isfinite(HM).all() and np.abs(HM).max() > 0
    np.testing.assert_allclose(HM, HM.T, atol=1e-3 * max(np.abs(HM).max(), 1))
    assert int((fs.win.pt_status == W.PT_ACTIVE).sum()) > 0


@pytest.mark.slow
def test_kitti_res_within_reference_envelope():
    """bench.py's sequence 0 at 1216x352, cut to 120 frames, through the
    port's accuracy probe on the CPU in a process of its own: not lost, at
    least 15 keyframes, and inside the reference's published KITTI
    envelope (rel-trans <= 4.2 %, rel-rot <= 0.0053 deg/m)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-m", "stereo_dso_g2o_tpu_torch.tools.accuracy_probe", "seq=0",
         "frames=120", "device=cpu"],
        env=dict(os.environ, PYTHONPATH=root), capture_output=True, text=True, timeout=1500,
        cwd=root,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    r = json.loads([line for line in out.stdout.strip().splitlines() if line.startswith("{")][-1])
    assert not r["lost"]
    assert r["n_keyframes"] >= 15, r
    assert r["kitti_rel_trans_pct"] <= 4.2, r
    assert r["kitti_rel_rot_degpm"] <= 0.0053, r
