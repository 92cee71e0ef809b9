"""The plain reference and the comparison that decides `correct`.

The reference is the scene itself: the poses the drives were rendered from
and the inverse depth the ray caster finds at each pixel (`render.py`). It
imports nothing of the port, and takes nothing the port made. What is
judged is what the timed path handed the host: each frame's pose, and what
BA left in each system's final window (the keyframe poses and the active
points' inverse depths, through the port's viewer feed).

Numbers compared, each the worst over the drives of a run, each against
its limit in `benchmark/workloads/<cell>.json`:

- `track_rel_t_m`: the median translation error (m) of a frame's motion
  from the frame before it (the tracker; BA where the frame is a keyframe);
- `wrong_frame_share`: the share of frames whose motion is off by more
  than the cell's `wrong_frame_m`;
- `kf_motion_rel`: over the final window's consecutive keyframes, the
  median translation error of BA's motion from one to the next, as a
  share of the true motion (BA with marginalization);
- `point_idepth_rel`: over the final window's active points, the median
  error of the inverse depth, as a share of the true inverse depth at the
  point's pixel of its host keyframe (depth refinement through K1, then
  BA).

Shown beside them and not compared: `track_rel_r_deg`, the median rotation
error (degrees) of a frame's motion, each rotation made orthonormal first.

Answers that never come, are not finite, or belong to a drive that was
lost count as failed.

The control (`control.py`) puts the reference, computed in bfloat16, in
the port's place and is judged the same way: the true poses rounded to
bfloat16 for the poses, the ray caster run in bfloat16 for the depths.
"""

from __future__ import annotations

import numpy as np
import torch

def _orthonormal(R):
    u, _, vt = np.linalg.svd(R)
    return u @ vt


def _rel(a, b):
    """The motion from camera-to-world `a` to `b`: inv(a) @ b."""
    return np.linalg.solve(a, b)


def _rel_errors(est_a, est_b, true_a, true_b):
    """(translation m, rotation deg, true translation m) of est's motion
    a -> b against the true one."""
    e, t = _rel(est_a, est_b), _rel(true_a, true_b)
    dt = float(np.linalg.norm(e[:3, 3] - t[:3, 3]))
    dR = _orthonormal(e[:3, :3]).T @ t[:3, :3]
    c = np.clip((np.trace(dR) - 1.0) / 2.0, -1.0, 1.0)
    return dt, float(np.degrees(np.arccos(c))), float(np.linalg.norm(t[:3, 3]))


def _at_pixels(pts, true_idepth):
    """(the truth at each point's nearest pixel centre, whether that pixel
    is on the image). `true_idepth(frames)` -> (n, h, w)."""
    frames = np.unique(pts["frame"])
    truth = true_idepth(frames)
    slot = np.searchsorted(frames, pts["frame"])
    h, w = truth.shape[1:]
    u, v = np.rint(pts["u"]), np.rint(pts["v"])
    on = np.isfinite(u) & np.isfinite(v) & (u >= 0) & (v >= 0) & (u < w) & (v < h)
    t = np.zeros(len(u))
    t[on] = truth[slot[on], v[on].astype(np.int64), u[on].astype(np.int64)]
    return t, on


def _idepth_rel(pts, true_idepth):
    """Each point's inverse-depth error as a share of the truth at its
    pixel; points off the image or on no surface are left out."""
    if not len(pts["frame"]):
        return np.zeros(0)
    t, on = _at_pixels(pts, true_idepth)
    keep = on & (t > 0)
    est = np.asarray(pts["idepth"])
    return np.abs(est[keep] - t[keep]) / t[keep]


def drive_checks(poses, lost, windows, drives, due, wrong_m):
    """poses {(start, drive, frame): c2w}, lost {(start, drive)}, windows
    [(start, drive, [(frame, c2w)], points)] (`DriveSession.final_windows`),
    drives: the rendered drives (truth: `c2w`, `true_idepth`), due: the
    keys submitted in the window; wrong_m: the translation error of a
    frame's motion past which that frame's pose is wrong. Returns (failed
    keys, the numbers compared, the numbers shown)."""
    failed = set()
    for key in due:
        P = poses.get(key)
        if P is None or not np.isfinite(P).all() or key[:2] in lost:
            failed.add(key)
    per_drive = {}
    for (r, k, i), P in poses.items():
        prev = poses.get((r, k, i - 1))
        if prev is None or not (np.isfinite(P).all() and np.isfinite(prev).all()):
            continue
        per_drive.setdefault((r, k), []).append(
            _rel_errors(prev, P, drives[k].c2w[i - 1], drives[k].c2w[i]))
    t_med = r_med = wrong = 0.0
    for errs in per_drive.values():
        e = np.asarray(errs)
        t_med = max(t_med, float(np.median(e[:, 0])))
        r_med = max(r_med, float(np.median(e[:, 1])))
        wrong = max(wrong, float(np.mean(~(e[:, 0] <= wrong_m))))
    kf_rel = pt_rel = 0.0
    for r, k, kfs, pts in windows:
        if (r, k) in lost:
            continue
        c2w = drives[k].c2w
        e = []
        for (fa, Pa), (fb, Pb) in zip(kfs, kfs[1:]):
            dt, _, norm = _rel_errors(Pa, Pb, c2w[fa], c2w[fb])
            e.append(dt / norm if norm > 0 else np.inf)
        kf_rel = max(kf_rel, float(np.median(e)) if e else np.inf)
        d = _idepth_rel(pts, lambda f, k=k: drives[k].true_idepth(f))
        pt_rel = max(pt_rel, float(np.median(d)) if d.size else np.inf)
    numbers = {"track_rel_t_m": t_med, "wrong_frame_share": wrong,
               "kf_motion_rel": kf_rel, "point_idepth_rel": pt_rel}
    return failed, numbers, {"track_rel_r_deg": r_med}


def drive_control(poses, windows, drives, due, wrong_m, dtype=torch.bfloat16):
    """The control's numbers: the same keys as the port's answers, each
    the true pose computed in `dtype` (rounded from the float64 truth);
    the same points of the same windows, each inverse depth the ray
    caster's in `dtype` at the point's pixel."""
    def low(T):
        return torch.as_tensor(T).to(dtype).double().numpy()

    def low_idepth(pts, drive):
        if not len(pts["frame"]):
            return np.zeros(0)
        return _at_pixels(pts, lambda f: drive.true_idepth(f, dtype))[0]

    ctl = {key: low(drives[key[1]].c2w[key[2]]) for key in poses}
    ctl_windows = [(r, k, [(f, low(drives[k].c2w[f])) for f, _ in kfs],
                    dict(pts, idepth=low_idepth(pts, drives[k])))
                   for r, k, kfs, pts in windows]
    return drive_checks(ctl, set(), ctl_windows, drives, due, wrong_m)[1]
