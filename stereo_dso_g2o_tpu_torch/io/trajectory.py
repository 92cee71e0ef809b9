"""Trajectory output + accuracy evaluation.

Writer follows the reference's KITTI 3x4 row-major format
(FullSystem::printResult, FullSystem.cpp:236-285). The evaluator implements
the metrics the reference's README reports (SURVEY.md par. 6): ATE RMSE after
SE(3) (or Sim(3)) alignment and the KITTI relative translation/rotation error.
The reference repo itself has no evaluator; this replaces the authors'
external plotting scripts.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def write_kitti(path: str, poses_cam_to_world: Sequence[np.ndarray]):
    with open(path, "w") as f:
        for T in poses_cam_to_world:
            row = T[:3, :4].reshape(-1)
            f.write(" ".join(f"{v:.6e}" for v in row) + "\n")


def read_kitti(path: str) -> List[np.ndarray]:
    out = []
    for line in open(path):
        v = np.fromstring(line, sep=" ")
        if v.size != 12:
            continue
        T = np.eye(4)
        T[:3, :4] = v.reshape(3, 4)
        out.append(T)
    return out


def _umeyama(src, dst, with_scale=False):
    """Least-squares rigid (or similarity) alignment src -> dst. (N,3) each."""
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d
    C = xd.T @ xs / len(src)
    U, S, Vt = np.linalg.svd(C)
    sgn = np.sign(np.linalg.det(U @ Vt))
    D = np.diag([1.0, 1.0, sgn])
    R = U @ D @ Vt
    if with_scale:
        var_s = (xs**2).sum() / len(src)
        scale = np.trace(np.diag(S) @ D) / var_s
    else:
        scale = 1.0
    t = mu_d - scale * R @ mu_s
    return scale, R, t


def ate_rmse(est: Sequence[np.ndarray], gt: Sequence[np.ndarray], align_scale=False):
    """Absolute trajectory error after alignment. Poses are camToWorld.

    Non-finite estimated poses (tracking lost / diverged) are excluded from
    the alignment pair set rather than poisoning the SVD; returns NaN when
    fewer than 3 finite pairs remain."""
    p_est = np.array([T[:3, 3] for T in est])
    p_gt = np.array([T[:3, 3] for T in gt])
    n = min(len(p_est), len(p_gt))
    p_est, p_gt = p_est[:n], p_gt[:n]
    ok = np.isfinite(p_est).all(axis=1) & np.isfinite(p_gt).all(axis=1)
    p_est, p_gt = p_est[ok], p_gt[ok]
    if len(p_est) < 3:
        return float("nan")
    try:
        s, R, t = _umeyama(p_est, p_gt, with_scale=align_scale)
    except np.linalg.LinAlgError:
        return float("nan")
    aligned = (s * (R @ p_est.T)).T + t
    err = np.linalg.norm(aligned - p_gt, axis=1)
    return float(np.sqrt(np.mean(err**2)))


def kitti_rel_errors(
    est: Sequence[np.ndarray],
    gt: Sequence[np.ndarray],
    lengths=(100, 200, 300, 400, 500, 600, 700, 800),
    step: int = 10,
):
    """KITTI odometry relative errors: (translation %, rotation deg/m),
    averaged over all sub-sequences of the standard lengths."""
    n = min(len(est), len(gt))
    est, gt = list(est)[:n], list(gt)[:n]
    dist = [0.0]
    for i in range(1, n):
        dist.append(dist[-1] + np.linalg.norm(gt[i][:3, 3] - gt[i - 1][:3, 3]))

    def frame_at(start, length):
        target = dist[start] + length
        for i in range(start, n):
            if dist[i] >= target:
                return i
        return -1

    t_errs, r_errs = [], []
    for start in range(0, n, step):
        for L in lengths:
            end = frame_at(start, L)
            if end < 0:
                continue
            if not (
                np.isfinite(est[start]).all() and np.isfinite(est[end]).all()
            ):
                continue
            dgt = np.linalg.inv(gt[start]) @ gt[end]
            dest = np.linalg.inv(est[start]) @ est[end]
            E = np.linalg.inv(dgt) @ dest
            t_errs.append(np.linalg.norm(E[:3, 3]) / L)
            ang = np.arccos(
                np.clip((np.trace(E[:3, :3]) - 1.0) * 0.5, -1.0, 1.0)
            )
            r_errs.append(np.degrees(ang) / L)
    if not t_errs:
        return float("nan"), float("nan")
    return float(np.mean(t_errs) * 100.0), float(np.mean(r_errs))
