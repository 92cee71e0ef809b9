"""Coarse tracker: direct pyramid image alignment against the last keyframe.

Port of `stereo_dso_g2o_tpu/frontend/coarse_tracker.py`
(CoarseTracker::setCoarseTrackingRef / trackNewestCoarse, legacy LM
semantics) plus the pose-hypothesis ladders of FullSystem::trackNewCoarse.
Host code drives the level cascade; the numeric work is in
`ops/tracker_ops.py`.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from stereo_dso_g2o_tpu_torch.config import Settings, default_settings
from stereo_dso_g2o_tpu_torch.models.camera import Calib
from stereo_dso_g2o_tpu_torch.ops import tracker_ops
from stereo_dso_g2o_tpu_torch.utils import se3

# Legacy DSO per-level iteration caps (CoarseTracker.cpp:861), extended for
# deeper pyramids.
MAX_ITERATIONS = (10, 20, 50, 50, 50, 50)


def level_caps(calib: Calib) -> List[int]:
    """Fixed capacities for the compacted per-level reference point lists."""
    caps = []
    for lvl in range(calib.n_levels):
        area = calib.w[lvl] * calib.h[lvl]
        caps.append(int(min(area, max(512, 8192 >> max(lvl - 2, 0)))))
    return caps


def k_levels(calib: Calib):
    """Per-level (4,) (fx, fy, cx, cy) tensors ((N, 4) for N sequences)."""
    return [
        torch.stack([calib.fx(l), calib.fy(l), calib.cx(l), calib.cy(l)], -1)
        for l in range(calib.n_levels)
    ]


class TrackResult(NamedTuple):
    ok: bool
    T_ref_new: np.ndarray  # (4,4)
    aff: np.ndarray  # (2,)
    residuals: np.ndarray  # (L,) per-level sqrt(E/n); NaN where not evaluated
    flow: np.ndarray  # (3,) flow indicators (T, 0, RT)


class CoarseTracker:
    def __init__(self, calib: Calib, settings: Settings = default_settings()):
        self.calib = calib
        self.settings = settings
        self.caps = level_caps(calib)
        self.ref = None  # per-level compacted lists
        self.ref_aff = torch.zeros(2, dtype=torch.float32, device=calib.device)
        self.ref_exposure = 1.0
        self.first_coarse_rmse = -1.0
        self.ref_frame_id = -1

    def set_reference(self, dI_ref_pyr, us, vs, idepths, weights, valid,
                      ref_aff=None, ref_exposure: float = 1.0,
                      ref_frame_id: int = -1):
        """Build the semi-dense tracking reference from splatted points
        (makeCoarseDepthL0 STEP2-5)."""
        n_levels = self.calib.n_levels
        id_maps, valid_maps, color_maps = tracker_ops.build_ref_maps(
            us, vs, idepths, weights, valid, n_levels=n_levels, dI_ref=dI_ref_pyr
        )
        self.ref = [
            tracker_ops.compact_ref_level(
                id_maps[lvl], valid_maps[lvl], color_maps[lvl], self.caps[lvl]
            )
            for lvl in range(n_levels)
        ]
        dev = self.calib.device
        self.ref_aff = (
            torch.zeros(2, dtype=torch.float32, device=dev)
            if ref_aff is None
            else torch.as_tensor(np.asarray(ref_aff, np.float32), device=dev)
        )
        self.ref_exposure = float(ref_exposure)
        self.first_coarse_rmse = -1.0
        self.ref_frame_id = ref_frame_id

    def track_newest_coarse(self, dI_new_pyr, T_init: np.ndarray, aff_init: np.ndarray,
                            coarsest_lvl: int, min_res_for_abort: np.ndarray,
                            new_exposure: float = 1.0) -> TrackResult:
        """Pyramid LM alignment of one hypothesis (trackNewestCoarse)."""
        s = self.settings
        n_levels = self.calib.n_levels
        assert coarsest_lvl < n_levels
        dev = self.calib.device
        residuals = np.full(n_levels, np.nan, dtype=np.float64)
        flow = np.array([100.0, 0.0, 100.0])
        Ks = k_levels(self.calib)

        T = torch.as_tensor(np.asarray(T_init, np.float32), device=dev)[None]
        aff = torch.as_tensor(np.asarray(aff_init, np.float32), device=dev)[None]
        ref_exp = torch.tensor(self.ref_exposure, dtype=torch.float32, device=dev)
        new_exp = torch.tensor(float(new_exposure), dtype=torch.float32, device=dev)

        def result(ok, aff_out=None):
            a = np.asarray(aff[0].cpu(), np.float64) if aff_out is None else aff_out
            return TrackResult(ok, np.asarray(T[0].cpu(), np.float64), a, residuals, flow)

        have_repeated = False
        for lvl in range(coarsest_lvl, -1, -1):
            pc_u, pc_v, pc_id, pc_color, pc_ok = self.ref[lvl]
            out = tracker_ops.lm_level(
                pc_u, pc_v, pc_id, pc_color, pc_ok, dI_new_pyr[lvl], Ks[lvl],
                T, aff, self.ref_aff, ref_exp, new_exp,
                torch.tensor([have_repeated], device=dev),
                settings=s,
                max_iterations=MAX_ITERATIONS[min(lvl, len(MAX_ITERATIONS) - 1)],
            )
            have_repeated = have_repeated or bool(out.repeated[0])
            res = float(out.res_per_point[0])
            residuals[lvl] = res
            if lvl == 0:
                flow = np.array([float(out.flow_t[0]), 0.0, float(out.flow_rt[0])])
            if not np.isfinite(res) or res > 1.5 * min_res_for_abort[lvl]:
                return result(False)
            if lvl <= 2:
                n_ref = int(pc_ok.sum())
                if int(out.num_terms[0]) < max(10, int(0.25 * n_ref)):
                    return result(False)
            T, aff = out.T, out.aff

        aff_np = np.asarray(aff[0].cpu(), dtype=np.float64)
        if (s.affine_opt_mode_a != 0 and abs(aff_np[0]) > 1.2) or (
            s.affine_opt_mode_b != 0 and abs(aff_np[1]) > 200
        ):
            return result(False, aff_np)
        ref_aff = self.ref_aff.cpu().numpy()
        rel_a = np.exp(aff_np[0] - float(ref_aff[0])) * new_exposure / self.ref_exposure
        rel_b = aff_np[1] - rel_a * float(ref_aff[1])
        if (s.affine_opt_mode_a == 0 and abs(np.log(max(rel_a, 1e-12))) > 1.5) or (
            s.affine_opt_mode_b == 0 and abs(rel_b) > 200
        ):
            return result(False, aff_np)
        if s.affine_opt_mode_a < 0:
            aff_np[0] = 0.0
        if s.affine_opt_mode_b < 0:
            aff_np[1] = 0.0
        return result(True, aff_np)


def rotation_ladder(n_levels_unused: int = 0) -> List[np.ndarray]:
    """The 26-rotation perturbation set of frame-1 initialization
    (FullSystem.cpp:313-341), from unnormalized quaternions (1, +-d, +-d, +-d)
    with d in {0.02, 0.04}."""
    out = []
    for d in (0.02, 0.04):
        combos = [
            (d, 0, 0), (0, d, 0), (0, 0, d), (-d, 0, 0), (0, -d, 0), (0, 0, -d),
            (d, d, 0), (0, d, d), (d, 0, d), (-d, d, 0), (0, -d, d), (-d, 0, d),
            (d, -d, 0), (0, d, -d), (d, 0, -d), (-d, -d, 0), (0, -d, -d),
            (-d, 0, -d), (-d, -d, -d), (-d, -d, d), (-d, d, -d), (-d, d, d),
            (d, -d, -d), (d, -d, d), (d, d, -d), (d, d, d),
        ]
        for (qx, qy, qz) in combos:
            q = np.array([1.0, qx, qy, qz])
            q = q / np.linalg.norm(q)
            w, x, y, z = q
            R = np.array(
                [
                    [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                    [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                    [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
                ]
            )
            T = np.eye(4)
            T[:3, :3] = R
            out.append(T)
    return out


def motion_model_tries(
    T_world_sprelast: Optional[np.ndarray],
    T_world_slast: Optional[np.ndarray],
    T_world_lastF: np.ndarray,
) -> List[np.ndarray]:
    """Pose hypotheses lastF->fh for an ordinary frame (FullSystem.cpp:349-377):
    constant motion, double, half, zero motion, zero from KF."""
    inv = np.linalg.inv
    if T_world_sprelast is None or T_world_slast is None:
        return [np.eye(4)]
    slast_2_sprelast = inv(T_world_sprelast) @ T_world_slast
    lastF_2_slast = inv(T_world_slast) @ T_world_lastF
    fh_2_slast = slast_2_sprelast  # constant-velocity assumption

    half = se3.se3_exp(0.5 * se3.se3_log(torch.as_tensor(fh_2_slast))).numpy()
    return [
        inv(fh_2_slast) @ lastF_2_slast,
        inv(fh_2_slast) @ inv(fh_2_slast) @ lastF_2_slast,
        inv(half) @ lastF_2_slast,
        lastF_2_slast,
        np.eye(4),
    ]
