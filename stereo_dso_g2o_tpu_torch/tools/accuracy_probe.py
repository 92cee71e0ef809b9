"""Single-sequence accuracy probe: one of bench.py's sequences through the
graph path, one JSON line with ATE, KITTI relative errors and keyframes.

Port of `tools/accuracy_probe.py`:

    python -m stereo_dso_g2o_tpu_torch.tools.accuracy_probe [seq=0] [frames=200]
        [ladder_fine=2] [route=resident|slab] [small=0] [save=traj.npz]
        [device=cuda|cpu]

`seq` is the bench sequence (scene seed 100 + seq, trajectory seed seq,
exposure phase seq), rendered by the port on the device; 12 frames of
FullSystem bootstrap, then GraphSystem, as bench.py runs it. `route=`
sends every epipolar trace of the run through one kernel (the JAX tool's
SDSO_TRACE_BACKEND); unset, each trace takes the size gate. Beside the JAX
tool's keys: `kf_frames`; `rot_orth_max`, the largest |R^T R - I| over the
returned poses (a rotation that is less orthonormal reads as rotation
error in `kitti_rel_errors`, which takes arccos((tr R - 1) / 2)); and
`kitti_rel_rot_degpm_orthonormal`, the rotation error of the same poses
with each R replaced by the nearest rotation. `save=` writes the
trajectory and the ground truth (npz: `traj`, `gt`).
"""

from __future__ import annotations

import sys
import time

import numpy as np

from stereo_dso_g2o_tpu_torch.tools._common import bootstrap, cli, emit, flag, sequence, sync

KEYS = ("seq", "frames", "ladder_fine", "route", "small", "save", "device")


def rot_orth_max(traj) -> float:
    """max over poses of max |R^T R - I|."""
    R = np.stack([np.asarray(T, np.float64)[:3, :3] for T in traj])
    return float(np.abs(np.einsum("nji,njk->nik", R, R) - np.eye(3)).max())


def orthonormalized(traj):
    """The poses with each R replaced by the nearest rotation (SVD polar
    factor): what `kitti_rel_errors` reads as rotation error once the
    drift of R away from a rotation is taken out."""
    out = []
    for T in traj:
        T = np.array(T, np.float64)
        U, _, Vt = np.linalg.svd(T[:3, :3])
        T[:3, :3] = U @ np.diag([1.0, 1.0, np.linalg.det(U @ Vt)]) @ Vt
        out.append(T)
    return out


def main(seq=0, frames=None, ladder_fine=None, route=None, small=False, save=None,
         device=None) -> dict:
    from stereo_dso_g2o_tpu_torch.bench import BOOT
    from stereo_dso_g2o_tpu_torch.io import trajectory
    from stereo_dso_g2o_tpu_torch.ops import trace

    if route not in (None, "resident", "slab"):
        raise ValueError(f"route must be resident or slab, got {route!r}")
    dev, cfg, settings, calib, lefts, rights, poses = sequence(
        seq, frames, flag(small), ladder_fine, device)
    n_frames = len(poses)
    before = trace.DEFAULT_ROUTE
    trace.DEFAULT_ROUTE = route
    try:
        gs = bootstrap(calib, settings, lefts, rights, dev)
        sync(dev)
        t0 = time.perf_counter()
        for i in range(BOOT, n_frames):
            gs.add_frame(lefts[i], rights[i], i, timestamp=0.1 * i)
        gs.flush()
        sync(dev)
        wall = time.perf_counter() - t0
    finally:
        trace.DEFAULT_ROUTE = before

    traj = gs.trajectory()
    ate = trajectory.ate_rmse(traj, poses)
    rel_t, rel_r = trajectory.kitti_rel_errors(traj, poses, lengths=(10, 20, 30, 40), step=5)
    _, rel_r_svd = trajectory.kitti_rel_errors(orthonormalized(traj), poses,
                                               lengths=(10, 20, 30, 40), step=5)
    out = {
        "backend": str(dev),
        "seq": int(seq),
        "trace_backend": route or "gate",
        "ladder_fine_levels": settings.ladder_fine_levels,
        "n_frames": n_frames,
        "ate_rmse_m": round(float(ate), 4),
        "kitti_rel_trans_pct": round(float(rel_t), 3),
        "kitti_rel_rot_degpm": round(float(rel_r), 5),
        "n_keyframes": len(gs.kf_shells),
        "lost": bool(gs.is_lost),
        "wall_s": round(wall, 1),
        "fps": round((n_frames - BOOT) / wall, 2),
        "kf_frames": [s.id for s in gs.kf_shells],
        "rot_orth_max": rot_orth_max(traj),
        "kitti_rel_rot_degpm_orthonormal": round(float(rel_r_svd), 5),
    }
    if save:
        np.savez(save, traj=np.stack(traj), gt=np.stack(poses))
    emit(out)
    return out


if __name__ == "__main__":
    sys.exit(cli(main, sys.argv[1:], KEYS, "accuracy_probe"))
