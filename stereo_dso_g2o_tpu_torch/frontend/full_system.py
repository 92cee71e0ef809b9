"""The full stereo direct-SLAM pipeline orchestrator.

Port of `stereo_dso_g2o_tpu/frontend/full_system.py` (FullSystem): owns the
window state, immature point sets, coarse tracker and selector, and drives
the per-frame pipeline:

  add_frame -> track (retry ladder) -> keyframe decision
    -> make keyframe | keep the speculative non-keyframe refinement

makeKeyFrame: temporal trace -> frame flagging -> window insert -> residual
creation -> activation -> windowed BA -> final linearization, outlier
removal, tracking-reference rebuild, point marginalization -> new traces
-> frame marginalization. Initialization is the stereo path: frame 0's
static-stereo depths seed the first keyframe.

The host code is control flow; numeric stages are torch ops on `device`.
With `Settings.dist_ba_shards > 1` the windowed BA runs point-sharded over a
`torch.distributed` process group (`_dist_ba`, parallel/dist_ba.py); with
`Settings.log_eigenvalues` and a `log_stream` every keyframe writes one
eigenvalue record (runtime/diagnostics.py).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Callable, List, Optional

import numpy as np
import torch

from stereo_dso_g2o_tpu_torch import default_device
from stereo_dso_g2o_tpu_torch.backend import ba, builder
from stereo_dso_g2o_tpu_torch.backend import window as W
from stereo_dso_g2o_tpu_torch.config import Settings, default_settings
from stereo_dso_g2o_tpu_torch.frontend import frame_step as FS
from stereo_dso_g2o_tpu_torch.frontend import immature as IMM
from stereo_dso_g2o_tpu_torch.frontend.coarse_tracker import (
    CoarseTracker,
    motion_model_tries,
    rotation_ladder,
)
from stereo_dso_g2o_tpu_torch.models.camera import Calib
from stereo_dso_g2o_tpu_torch.ops import trace as trace_ops
from stereo_dso_g2o_tpu_torch.ops.pyramid import build_pyramid
from stereo_dso_g2o_tpu_torch.ops.selector import PixelSelector, map_to_points
from stereo_dso_g2o_tpu_torch.utils.timing import PROF


@dataclasses.dataclass
class FrameShell:
    """Per-frame pose record (util/FrameShell.h)."""

    id: int
    timestamp: float
    T_cam_to_ref: np.ndarray  # camToTrackingRef
    ref_kf_id: int  # tracking reference keyframe id (-1 for first)
    aff: np.ndarray
    is_kf: bool = False
    T_cw: Optional[np.ndarray] = None  # camToWorld (KFs: updated after BA)


def device_image(x, device):
    """An (H, W) image (numpy or tensor, uint8 or float) as a tensor on
    `device`; numpy floats become float32."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    x = np.asarray(x)
    if x.dtype != np.uint8:
        x = x.astype(np.float32)
    return torch.as_tensor(x, device=device)


def _f32(x, device):
    return torch.tensor(float(x), dtype=torch.float32, device=device)


class FullSystem:
    def __init__(self, calib: Calib, settings: Settings = default_settings(),
                 device=None, uniform: Optional[Callable] = None):
        """device: where every tensor lives (None: the GPU; calib moves
        there); uniform: the selector's thinning draw (see ops/selector.py)."""
        self.device = default_device(device)
        if calib.device != self.device:
            calib = dataclasses.replace(
                calib, c=calib.c.to(self.device), baseline=calib.baseline.to(self.device)
            )
        self.calib = calib
        self.settings = settings
        F = settings.window_cap
        NP = settings.active_cap + 1024  # slack above the density target
        self.win = W.empty_window(F, NP, calib.c.cpu().numpy(), device=self.device)
        self.imm = IMM.empty(F, settings.immature_cap, device=self.device)
        self.selector = PixelSelector(settings, uniform=uniform)
        self.tracker = CoarseTracker(calib, settings)
        self.initialized = False
        self.is_lost = False
        self.init_failed = False
        self.log_stream = None  # optional file handle for per-KF stats
        self.dist_group = None  # process group of the sharded BA (None: the default one)

        self.history: List[FrameShell] = []
        self.slot_meta = {}  # slot -> (exposure, aff np)
        self.kf_shells: List[FrameShell] = []  # by keyframe id
        self.kf_slots: List[int] = []  # window order oldest..newest
        self.slot_frame_id: dict = {}
        self.kf_out_count = np.zeros(F, dtype=np.int64)
        self.dI_slots = [None] * F  # per-slot full left pyramid
        self.right_slots = [None] * F  # per-slot right level-0 dI
        self.current_min_act_dist = 2.0
        self.last_coarse_rmse = np.full(calib.n_levels, np.inf)
        self.first_pair = None
        self.next_kf_id = 0
        self.stats_n_frames = 0
        self.n_frame_marginalizations = 0

    @property
    def n_levels(self):
        return self.calib.n_levels

    def _dI_stack(self):
        """(F, H, W, 3) stacked level-0 pyramids of window keyframes."""
        H0, W0 = self.calib.h[0], self.calib.w[0]
        zero = torch.zeros((H0, W0, 3), dtype=torch.float32, device=self.device)
        return torch.stack([
            self.dI_slots[s][0] if self.dI_slots[s] is not None else zero
            for s in range(self.win.F)
        ])

    def _dist_ba(self, dI_stack, max_its: int):
        """Windowed BA over the dist_ba_shards ranks of `self.dist_group`
        (Settings opt-in, BASELINE config 5): take this rank's block of the
        point axis, run the whole GN loop with the camera system all-reduced,
        gather back. Every rank runs this same FullSystem on the same
        frames; only BA is split. Sharding and gathering per keyframe is the
        price of keeping the rest of the pipeline as it is; a deployment
        that lives on several devices would keep the window sharded between
        keyframes (parallel/dist_ba.py)."""
        import torch.distributed as dist

        from stereo_dso_g2o_tpu_torch.parallel import dist_ba as DBA

        n = self.settings.dist_ba_shards
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(
                f"dist_ba_shards={n} needs an initialized torch.distributed process "
                f"group of {n} ranks (nccl for CUDA tensors, gloo for CPU tensors)"
            )
        world = dist.get_world_size(self.dist_group)
        if world != n:
            raise RuntimeError(f"dist_ba_shards={n} but the process group has {world} ranks")
        if self.win.NP % n:
            raise RuntimeError(
                f"the point capacity {self.win.NP} is not divisible by dist_ba_shards={n}"
            )
        win_sh = DBA.shard_window(self.win, dist.get_rank(self.dist_group), n)
        run = DBA.sharded_optimize_fused(self.dist_group, self.settings, max_its)
        win_sh, energy, nres = run(win_sh, dI_stack)
        return DBA.gather_window(win_sh, self.dist_group), energy, nres

    def add_frame(self, left, right, frame_id: int, timestamp: float = 0.0,
                  exposure: float = 1.0, exposure_right: float = 1.0):
        """FullSystem::addActiveFrame. left/right: (H, W) uint8 or float
        images (numpy or tensors)."""
        if self.is_lost:
            return
        n_lvl = self.n_levels
        left_dev = device_image(left, self.device)
        right_dev = device_image(right, self.device)

        if not self.initialized:
            dIpL, asgL = build_pyramid(left_dev.to(torch.float32), n_lvl)
            dIpR, _ = build_pyramid(right_dev.to(torch.float32), n_lvl)
            self.first_pair = (dIpL, dIpR, asgL, exposure)
            self.history.append(FrameShell(frame_id, timestamp, np.eye(4), -1, np.zeros(2)))
            self.initialized = True
            return

        if len(self.kf_slots) == 0:
            self._initialize_first_kf()

        with PROF.section("track_frame"):
            out = self._track_frame(left_dev, right_dev, frame_id, timestamp, exposure)
        if out is None:
            return
        pyrs, imm_new, best_T, best_aff, flow, achieved, rmse0 = out
        with PROF.section("deliver"):
            self._deliver(pyrs, imm_new, best_T, best_aff, flow, achieved, rmse0,
                          frame_id, timestamp, exposure)

    # ------------------------------------------------------------------
    def _initialize_first_kf(self):
        """setFirstStereo: select pixels on frame 0, static-stereo trace for
        idepth, create the first keyframe with depth-prior points."""
        s = self.settings
        dev = self.device
        dIpL, dIpR, asgL, exposure = self.first_pair
        status_map, _ = self.selector.make_maps(
            dIpL[0], asgL[0], asgL[1], asgL[2], s.desired_point_density
        )
        us, vs, types, valid = map_to_points(status_map, s.active_cap)
        color, weights, gradH, eth = trace_ops.extract_point_data(dIpL[0], us, vs, s)
        n = us.shape[0]
        res, idepth_stereo = trace_ops.trace_stereo(
            us, vs, torch.zeros(n, device=dev), torch.full((n,), float("nan"), device=dev),
            color, weights, gradH, eth, torch.full((n,), 10000.0, device=dev),
            torch.full((n,), trace_ops.IPS_UNINITIALIZED, dtype=torch.int32, device=dev),
            self.calib.K(0), self.calib.baseline, dIpR[0], mode_right=True, settings=s,
        )
        good = (
            valid
            & (res.status == trace_ops.IPS_GOOD)
            & torch.isfinite(res.idepth_min)
            & torch.isfinite(res.idepth_max)
            & (res.idepth_min >= 0)
            & (res.idepth_max >= 0)
        )
        idepth0 = torch.where(good, idepth_stereo, torch.zeros_like(idepth_stereo))

        slot = 0
        kf_id = self.next_kf_id
        self.next_kf_id += 1
        self.win = builder.insert_frame(self.win, slot, np.eye(4), (0.0, 0.0), exposure, kf_id)
        idx = torch.arange(n, device=dev)
        self.win = builder.insert_points(
            self.win, idx, slot, us, vs, idepth0, color, weights, eth, has_prior=True,
        )
        status = self.win.pt_status.clone()
        status[idx] = torch.where(good, W.PT_ACTIVE, W.PT_INACTIVE).to(status.dtype)
        self.win = self.win.replace(pt_status=status)
        self.dI_slots[slot] = dIpL
        self.right_slots[slot] = dIpR[0]
        self.kf_slots = [slot]
        self.slot_frame_id[slot] = kf_id
        self.slot_meta[slot] = (exposure, np.zeros(2))
        shell = self.history[0]
        shell.is_kf = True
        shell.T_cw = np.eye(4)
        self.kf_shells.append(shell)

        self.tracker.set_reference(
            dIpL, us, vs, idepth0, torch.ones(n, device=dev), good,
            ref_aff=np.zeros(2), ref_exposure=exposure, ref_frame_id=kf_id,
        )

    # ------------------------------------------------------------------
    def _track_frame(self, left_dev, right_dev, frame_id, timestamp, exposure):
        """Tracking with the retry ladder; the steady-state path runs every
        hypothesis plus the speculative depth refinement in one step and
        falls back to the host cascade only on a failed track."""
        s = self.settings
        dev = self.device
        n_lvl = self.n_levels

        ref_kf_id = self.tracker.ref_frame_id
        if len(self.history) >= 3:
            sl = self.history[-1]
            spl = self.history[-2]
            tries = motion_model_tries(
                self._shell_T_cw(spl), self._shell_T_cw(sl), self._kf_T_cw(ref_kf_id)
            )
            aff_last = sl.aff.copy()
        else:
            tries = [np.eye(4)] + rotation_ladder()
            aff_last = np.zeros(2)

        ref_slot = self.kf_slots[-1]
        ref_exp = _f32(self.tracker.ref_exposure, dev)
        new_exp = _f32(exposure, dev)
        aff_t = torch.as_tensor(np.asarray(aff_last, np.float32), device=dev)
        if len(tries) == 5:
            last0 = self.last_coarse_rmse[0]
            (dIpL, dIpR), imm_new, track, _ = FS.frame_step_full(
                left_dev, right_dev, tuple(self.tracker.ref), self.win, self.imm,
                self.calib.c, self.calib.baseline, ref_slot,
                torch.as_tensor(np.stack(tries).astype(np.float32), device=dev),
                aff_t, self.tracker.ref_aff, ref_exp, new_exp,
                _f32(last0 if np.isfinite(last0) else 1e30, dev),
                settings=s, n_levels=n_lvl, n_tries=5,
            )
            T_np = track.T.cpu().numpy()
            aff_np = track.aff.cpu().numpy()
            res_np = track.residuals.cpu().numpy()
            flow_np = track.flow.cpu().numpy()
            if bool(track.ok) and float(track.sat_frac0) <= 0.6 and np.isfinite(res_np[0]):
                self.last_coarse_rmse = np.where(
                    np.isfinite(res_np), res_np, self.last_coarse_rmse
                )
                if self.tracker.first_coarse_rmse < 0:
                    self.tracker.first_coarse_rmse = float(res_np[0])
                return (
                    (dIpL, dIpR), imm_new,
                    np.asarray(T_np, np.float64), np.asarray(aff_np, np.float64),
                    np.asarray(flow_np, np.float64), np.asarray(res_np, np.float64),
                    float(res_np[0]),
                )
            # saturated or failed: the host cascade ladder
            best_T = None
            achieved = np.full(n_lvl, np.nan)
            flow = np.array([100.0, 0.0, 100.0])
            imm_new = None
            for T_try in tries:
                res = self.tracker.track_newest_coarse(
                    dIpL, T_try, aff_last, n_lvl - 1,
                    np.where(np.isfinite(achieved), achieved, np.inf),
                    new_exposure=exposure,
                )
                took = res.ok and np.isfinite(res.residuals[0]) and (
                    not np.isfinite(achieved[0]) or res.residuals[0] < achieved[0]
                )
                if took:
                    best_T = res.T_ref_new
                    best_aff = res.aff
                    flow = res.flow
                if best_T is not None:
                    upd = ~np.isfinite(achieved) | (achieved > res.residuals)
                    achieved = np.where(upd & np.isfinite(res.residuals), res.residuals, achieved)
                if best_T is not None and achieved[0] < self.last_coarse_rmse[0] * s.re_track_threshold:
                    break
        else:
            # initialization frame: big rotation ladder
            abort_inf = torch.full((n_lvl,), float("inf"), device=dev)
            (dIpL, dIpR), imm_spec, track = FS.frame_step(
                left_dev, right_dev, tuple(self.tracker.ref), self.win, self.imm,
                self.calib.c, self.calib.baseline, ref_slot,
                torch.as_tensor(tries[0].astype(np.float32), device=dev),
                aff_t, self.tracker.ref_aff, ref_exp, new_exp, abort_inf,
                settings=s, n_levels=n_lvl, is_kf=False,
            )
            res_np = track.residuals.cpu().numpy()
            achieved = np.full(n_lvl, np.nan)
            best_T = None
            flow = np.array([100.0, 0.0, 100.0])
            imm_new = None
            if bool(track.ok) and np.isfinite(res_np[0]) and float(track.sat_frac0) <= 0.6:
                best_T = np.asarray(track.T.cpu().numpy(), np.float64)
                best_aff = np.asarray(track.aff.cpu().numpy(), np.float64)
                flow = np.asarray(track.flow.cpu().numpy(), np.float64)
                achieved = np.where(np.isfinite(res_np), res_np, np.nan)
                imm_new = imm_spec
            if not (
                best_T is not None
                and achieved[0] < self.last_coarse_rmse[0] * s.re_track_threshold
            ) and len(tries) > 1:
                for chunk in range(1, len(tries), 8):
                    sub = tries[chunk : chunk + 8]
                    while len(sub) < 8:
                        sub = sub + [np.eye(4)]
                    abort = torch.as_tensor(
                        np.where(np.isfinite(achieved), achieved, np.inf).astype(np.float32),
                        device=dev,
                    )
                    trb = FS.cascade_batch(
                        dIpL, tuple(self.tracker.ref), self.calib.c, self.calib.baseline,
                        torch.as_tensor(np.stack(sub).astype(np.float32), device=dev),
                        aff_t, self.tracker.ref_aff, ref_exp, new_exp, abort,
                        settings=s, n_levels=n_lvl,
                    )
                    Tb, ab, rb, fb, okb = (
                        x.cpu().numpy() for x in (trb.T, trb.aff, trb.residuals, trb.flow, trb.ok)
                    )
                    done = False
                    for k in range(len(sub)):
                        took = bool(okb[k]) and np.isfinite(rb[k, 0]) and (
                            not np.isfinite(achieved[0]) or rb[k, 0] < achieved[0]
                        )
                        if took:
                            best_T = np.asarray(Tb[k], np.float64)
                            best_aff = np.asarray(ab[k], np.float64)
                            flow = np.asarray(fb[k], np.float64)
                            imm_new = None
                        if best_T is not None:
                            upd = ~np.isfinite(achieved) | (achieved > rb[k])
                            achieved = np.where(upd & np.isfinite(rb[k]), rb[k], achieved)
                        if best_T is not None and achieved[0] < self.last_coarse_rmse[0] * s.re_track_threshold:
                            done = True
                            break
                    if done:
                        break

        if best_T is None:
            # take predicted pose and hope (FullSystem.cpp:503-508)
            best_T = tries[0]
            best_aff = aff_last
            flow = np.zeros(3)
            coarse_rmse0 = np.inf
        else:
            coarse_rmse0 = achieved[0]
            self.last_coarse_rmse = np.where(np.isfinite(achieved), achieved, self.last_coarse_rmse)
            if self.tracker.first_coarse_rmse < 0:
                self.tracker.first_coarse_rmse = coarse_rmse0

        if not np.all(np.isfinite(best_T)):
            self.is_lost = True
            return None
        return (dIpL, dIpR), imm_new, best_T, best_aff, flow, achieved, coarse_rmse0

    def _deliver(self, pyrs, imm_new, best_T, best_aff, flow, achieved,
                 coarse_rmse0, frame_id, timestamp, exposure):
        s = self.settings
        dIpL, dIpR = pyrs
        self.last_coarse_rmse = np.where(np.isfinite(achieved), achieved, self.last_coarse_rmse)
        if self.tracker.first_coarse_rmse < 0:
            self.tracker.first_coarse_rmse = coarse_rmse0

        shell = FrameShell(
            frame_id, timestamp, np.linalg.inv(best_T), self.tracker.ref_frame_id,
            np.asarray(best_aff, dtype=np.float64),
        )
        self.history.append(shell)

        # keyframe decision (:1127-1152)
        ref_slot = self.kf_slots[-1]
        ref_exp, ref_aff = self.slot_meta[ref_slot]
        a_rel = np.exp(best_aff[0] - ref_aff[0]) * exposure / max(ref_exp, 1e-9)
        wh = self.calib.w[0] + self.calib.h[0]
        delta = (
            s.kf_global_weight * s.max_shift_weight_t * np.sqrt(max(flow[0], 0)) / wh
            + s.kf_global_weight * s.max_shift_weight_r * np.sqrt(max(flow[1], 0)) / wh
            + s.kf_global_weight * s.max_shift_weight_rt * np.sqrt(max(flow[2], 0)) / wh
            + s.kf_global_weight * s.max_affine_weight * abs(np.log(max(a_rel, 1e-9)))
        )
        need_kf = (
            len(self.history) == 2
            or delta > 1.0
            or 2.0 * self.tracker.first_coarse_rmse < coarse_rmse0
        )
        self.stats_n_frames += 1
        if need_kf:
            self._make_keyframe(dIpL, dIpR, shell, best_T, best_aff, exposure)
        elif imm_new is not None:
            self.imm = imm_new  # the speculative refinement already ran
        else:
            self._make_non_keyframe(dIpL, dIpR, shell, best_T, best_aff, exposure)

    # ------------------------------------------------------------------
    def _shell_T_cw(self, shell: FrameShell):
        """camToWorld composed through the (BA-updated) tracking reference."""
        if shell.is_kf and shell.T_cw is not None:
            return shell.T_cw
        if shell.ref_kf_id < 0:
            return shell.T_cam_to_ref
        return self.kf_shells[shell.ref_kf_id].T_cw @ shell.T_cam_to_ref

    def _kf_T_cw(self, kf_id):
        """camToWorld of the keyframe."""
        return self.kf_shells[kf_id].T_cw

    def _make_non_keyframe(self, dIpL, dIpR, shell, T_ref_new, aff, exposure):
        """makeNonKeyFrame: temporal + stereo depth refinement only."""
        dev = self.device
        self.imm = FS.nonkey_refine_step(
            self.win, self.imm, dIpL[0], dIpR[0], self.calib.c, self.calib.baseline,
            self.kf_slots[-1], torch.as_tensor(np.asarray(T_ref_new, np.float32), device=dev),
            torch.as_tensor(np.asarray(aff, np.float32), device=dev), _f32(exposure, dev),
            settings=self.settings, n_levels=self.n_levels,
        )

    # ------------------------------------------------------------------
    def _make_keyframe(self, dIpL, dIpR, shell, T_ref_new, aff, exposure):
        s = self.settings
        dev = self.device
        ref_T_cw = self._kf_T_cw(shell.ref_kf_id)
        T_new_w2c = T_ref_new @ np.linalg.inv(ref_T_cw)

        # STEP 1: temporal trace of every immature point onto the new KF
        with PROF.section("kf.trace", True):
            self.imm = FS.kf_trace_step(
                self.win, self.imm, dIpL[0], self.calib.c, self.calib.baseline,
                torch.as_tensor(np.asarray(T_new_w2c, np.float32), device=dev),
                torch.as_tensor(np.asarray(aff, np.float32), device=dev), _f32(exposure, dev),
                settings=s, n_levels=self.n_levels,
            )

        # STEP 2: flag frames for marginalization (host-side policy)
        with PROF.section("kf.flag_frames"):
            flagged = self._flag_frames()

        # STEP 3: insert the new KF into the window
        slot = self._free_slot()
        kf_id = self.next_kf_id
        self.next_kf_id += 1
        self.win = builder.insert_frame(
            self.win, slot, T_new_w2c, tuple(np.asarray(aff)), exposure, kf_id
        )
        self.dI_slots[slot] = dIpL
        self.right_slots[slot] = dIpR[0]
        self.kf_slots.append(slot)
        self.slot_frame_id[slot] = kf_id
        self.slot_meta[slot] = (exposure, np.asarray(aff, np.float64))
        shell.is_kf = True
        shell.T_cw = np.linalg.inv(T_new_w2c)
        self.kf_shells.append(shell)

        # STEP 4: residuals from every active point to the new KF
        active_pts = self.win.pt_status == W.PT_ACTIVE
        res_exists = self.win.res_exists.clone()
        res_state = self.win.res_state.clone()
        res_lin = self.win.res_linearized.clone()
        res_exists[:, slot] = active_pts
        res_state[:, slot] = W.RES_IN
        res_lin[:, slot] = False
        self.win = self.win.replace(
            res_exists=res_exists, res_state=res_state, res_linearized=res_lin
        )
        dI_stack = self._dI_stack()

        # STEP 5: activate points
        with PROF.section("kf.activate", True):
            self._activate_points(dI_stack, slot)

        # STEP 6: windowed BA
        max_its = s.max_opt_iterations
        if len(self.kf_slots) < 3:
            max_its = 20
        elif len(self.kf_slots) < 4:
            max_its = 15
        with PROF.section("kf.ba", True):
            if s.dist_ba_shards > 1:
                self.win, energy, nres = self._dist_ba(dI_stack, max_its)
            else:
                self.win, energy, nres = ba.optimize_fused(
                    self.win, dI_stack, settings=s, max_its=max_its)
        if s.log_eigenvalues and self.log_stream is not None:
            from stereo_dso_g2o_tpu_torch.runtime.diagnostics import eigenvalue_record

            rec = eigenvalue_record(self.win, settings=s)
            rec["kf_id"] = kf_id
            self.log_stream.write(json.dumps(rec) + "\n")

        # STEPS 7-8 + final linearization
        prev_slot = self.kf_slots[-2] if len(self.kf_slots) >= 2 else -1
        with PROF.section("kf.finalize", True):
            self.win, ref_inputs, gone_dev, w2c_dev, aff_dev, _, _stats = FS.kf_finalize(
                self.win, dI_stack, self.dI_slots[slot][0], self.right_slots[slot], slot,
                torch.as_tensor(flagged, device=dev), prev_slot,
                self.calib.c, self.calib.baseline, settings=s, n_levels=self.n_levels,
            )
        gone = gone_dev.cpu().numpy()
        w2c = w2c_dev.cpu().numpy().astype(np.float64)
        aff_all = aff_dev.cpu().numpy().astype(np.float64)
        pt_host_np = self.win.pt_host.cpu().numpy()
        energy_np = float(energy)
        nres_np = int(nres)
        # initialization-failure check (FullSystem.cpp:1404-1418)
        rmse = float(np.sqrt(max(energy_np, 0.0) / max(8.0 * nres_np, 1.0)))
        n_kfs_hist = len(self.kf_shells)
        slack = 2.0
        if n_kfs_hist <= 4 and (
            (n_kfs_hist == 2 and rmse > 20 * slack)
            or (n_kfs_hist == 3 and rmse > 13 * slack)
            or (n_kfs_hist == 4 and rmse > 9 * slack)
        ):
            self.init_failed = True
        if not np.isfinite(energy_np):
            self.is_lost = True
        if self.log_stream is not None:
            self.log_stream.write(json.dumps({
                "type": "kf", "kf_id": self.slot_frame_id[slot], "frame_id": shell.id,
                "rmse": rmse, "energy": energy_np, "n_res": nres_np,
                "n_points": int((self.win.pt_status == W.PT_ACTIVE).sum()),
                "n_kfs": len(self.kf_slots), "marg_points": int(gone.sum()),
            }) + "\n")
        for s_ in self.kf_slots:
            kid = self.slot_frame_id[s_]
            self.kf_shells[kid].T_cw = np.linalg.inv(w2c[s_])
            self.kf_shells[kid].aff = aff_all[s_]
            self.slot_meta[s_] = (self.slot_meta[s_][0], aff_all[s_])
        np.add.at(self.kf_out_count, pt_host_np[gone], 1)

        us_r, vs_r, id_r, w_r, sel_r = ref_inputs
        self.tracker.set_reference(
            self.dI_slots[slot], us_r, vs_r, id_r, w_r, sel_r,
            ref_aff=aff_all[slot], ref_exposure=self.slot_meta[slot][0],
            ref_frame_id=self.slot_frame_id[slot],
        )

        # STEP 9: seed new immature points on the new KF (makeNewTraces)
        with PROF.section("kf.new_traces", True):
            asg = build_pyramid(dIpL[0][..., 0], 3)[1]
            status_map, _ = self.selector.make_maps(
                dIpL[0], asg[0], asg[1], asg[2], s.desired_immature_density
            )
            us, vs, types, valid = map_to_points(status_map, s.immature_cap)
            self.imm = IMM.seed_slot(self.imm, slot, dIpL[0], us, vs, types, valid, settings=s)

        # STEP 10: marginalize flagged frames
        with PROF.section("kf.marg_frames", True):
            if flagged.any():
                self.win = ba.marginalize_frames_masked(self.win, flagged, settings=s)
                self.imm = self.imm.replace(
                    valid=self.imm.valid & ~torch.as_tensor(flagged, device=dev)[:, None]
                )
                for s_ in list(self.kf_slots):
                    if flagged[s_]:
                        self._forget_slot(s_)
                        self.n_frame_marginalizations += 1

    # ------------------------------------------------------------------
    def _free_slot(self) -> int:
        free = np.nonzero(~self.win.frame_valid.cpu().numpy())[0]
        assert len(free) > 0, "window capacity exceeded"
        return int(free[0])

    def _flag_frames(self) -> np.ndarray:
        """flagFramesForMarginalization (FullSystemMarginalize.cpp:59-145)."""
        s = self.settings
        F = self.win.F
        flagged = np.zeros(F, dtype=bool)
        if len(self.kf_slots) < 2:
            return flagged
        pt_status = self.win.pt_status.cpu().numpy()
        pt_host = self.win.pt_host.cpu().numpy()
        imm_valid = self.imm.valid.cpu().numpy()
        aff_all = self.win.aff_g2l().cpu().numpy().astype(np.float64)
        exps = self.win.ab_exposure.cpu().numpy().astype(np.float64)
        n_flagged = 0
        n_kfs = len(self.kf_slots)
        back = self.kf_slots[-1]
        for s_ in self.kf_slots:
            n_in = int(((pt_status == W.PT_ACTIVE) & (pt_host == s_)).sum()) + int(imm_valid[s_].sum())
            n_out = int(self.kf_out_count[s_])
            a_rel = np.exp(aff_all[s_, 0] - aff_all[back, 0]) * exps[s_] / max(exps[back], 1e-9)
            if (
                n_in < s.min_points_remaining * (n_in + n_out)
                or abs(np.log(max(a_rel, 1e-12))) > s.max_log_aff_fac_in_window
            ) and (n_kfs - n_flagged > s.min_frames):
                flagged[s_] = True
                n_flagged += 1

        if n_kfs + 1 - n_flagged >= s.max_frames + 1:
            w2c = self.win.w2c().cpu().numpy().astype(np.float64)
            latest = self.kf_slots[-1]
            latest_id = self.slot_frame_id[latest]
            best_score = 1.0
            best_slot = None
            for s_ in self.kf_slots:
                fid = self.slot_frame_id[s_]
                if fid > latest_id - s.min_frame_age or fid == 0:
                    continue
                dist_score = 0.0
                for t_ in self.kf_slots:
                    tid = self.slot_frame_id[t_]
                    if tid > latest_id - s.min_frame_age + 1 or t_ == s_:
                        continue
                    d = np.linalg.norm((w2c[t_] @ np.linalg.inv(w2c[s_]))[:3, 3])
                    dist_score += 1.0 / (1e-5 + d)
                d_latest = np.linalg.norm((w2c[latest] @ np.linalg.inv(w2c[s_]))[:3, 3])
                dist_score *= -np.sqrt(max(d_latest, 1e-12))
                if dist_score < best_score:
                    best_score = dist_score
                    best_slot = s_
            if best_slot is not None:
                flagged[best_slot] = True
        return flagged

    # ------------------------------------------------------------------
    def _activate_points(self, dI_stack, newest_slot):
        """activatePointsMT."""
        s = self.settings
        n_active = int((self.win.pt_status == W.PT_ACTIVE).sum())
        d = s.desired_point_density
        if n_active < d * 0.66:
            self.current_min_act_dist -= 0.8
        if n_active < d * 0.8:
            self.current_min_act_dist -= 0.5
        elif n_active < d * 0.9:
            self.current_min_act_dist -= 0.2
        elif n_active < d:
            self.current_min_act_dist -= 0.1
        if n_active > d * 1.5:
            self.current_min_act_dist += 0.8
        if n_active > d * 1.3:
            self.current_min_act_dist += 0.5
        if n_active > d * 1.15:
            self.current_min_act_dist += 0.2
        if n_active > d:
            self.current_min_act_dist += 0.1
        self.current_min_act_dist = float(np.clip(self.current_min_act_dist, 0.0, 4.0))

        pre = W.precalc(self.win)
        cand_flat, delete = IMM.activation_gate(
            self.win, self.imm, newest_slot,
            torch.tensor(self.current_min_act_dist, dtype=torch.float32, device=self.device),
            self.calib.c, settings=s, h1=self.calib.h[1], w1=self.calib.w[1],
        )
        self.imm = self.imm.replace(valid=self.imm.valid & ~delete)
        act = IMM.optimize_immature(
            self.imm, cand_flat, pre["RTll"], pre["tTll"], pre["aff"],
            self.win.frame_valid, dI_stack, self.win.c_value, settings=s,
        )
        self.win, self.imm, _ = IMM.insert_activated(self.win, self.imm, act, settings=s)

    # ------------------------------------------------------------------
    def _marginalize_frame(self, slot):
        """marginalizeFrame for one slot: drop residuals targeting the frame,
        drop its hosted points, Schur-eliminate."""
        self.win = ba.drop_frame_refs(self.win, slot)
        self.win = ba.marginalize_frame(self.win, slot, settings=self.settings)
        self.imm = IMM.clear_slot(self.imm, slot)
        self._forget_slot(slot)
        self.n_frame_marginalizations += 1

    def _forget_slot(self, slot):
        """Host bookkeeping of a marginalized window slot."""
        self.dI_slots[slot] = None
        self.right_slots[slot] = None
        self.kf_slots.remove(slot)
        self.kf_out_count[slot] = 0
        del self.slot_frame_id[slot]
        self.slot_meta.pop(slot, None)

    # ------------------------------------------------------------------
    def trajectory(self):
        """camToWorld per frame, composed through the final keyframe poses
        (printResult, FullSystem.cpp:236-285)."""
        return [self._shell_T_cw(shell) for shell in self.history]

    def point_cloud(self):
        """World-space 3D positions of the window's active points — the data
        the reference's viewer renders per keyframe (PangolinDSOViewer's
        KeyFrameDisplay, KeyFrameDisplay.cpp:102-173). Returns a numpy dict
        with 'xyz' (N, 3), 'idepth' (N,), 'host_kf_id' (N,)."""
        return window_point_cloud(self.win, self.calib, self.slot_frame_id)


def window_point_cloud(win, calib, slot_frame_id):
    """World-space 3D positions of a window's active points (shared by
    FullSystem and GraphSystem; KeyFrameDisplay.cpp:102-173). numpy dict:
    xyz (n, 3), idepth (n,), host_kf_id (n,)."""
    from stereo_dso_g2o_tpu_torch.config import SCALE_IDEPTH

    def host(x, dtype=None):
        return np.asarray(x.cpu().numpy(), dtype)

    sel = host(win.pt_status) == W.PT_ACTIVE
    if not sel.any():
        return {"xyz": np.zeros((0, 3)), "idepth": np.zeros(0), "host_kf_id": np.zeros(0, int)}
    u = host(win.pt_u, np.float64)[sel]
    v = host(win.pt_v, np.float64)[sel]
    idp = host(win.pt_idepth, np.float64)[sel] * SCALE_IDEPTH
    hosts = host(win.pt_host)[sel]
    ok = idp > 1e-6
    u, v, idp, hosts = u[ok], v[ok], idp[ok], hosts[ok]
    fx, fy, cx, cy = host(calib.c, np.float64)
    Xc = np.stack([(u - cx) / fx / idp, (v - cy) / fy / idp, 1.0 / idp], -1)
    c2w = np.linalg.inv(host(win.w2c(), np.float64))
    xyz = np.einsum("nij,nj->ni", c2w[hosts][:, :3, :3], Xc) + c2w[hosts][:, :3, 3]
    kf_ids = np.array([slot_frame_id.get(int(s_), -1) for s_ in hosts], int)
    return {"xyz": xyz, "idepth": idp, "host_kf_id": kf_ids}
