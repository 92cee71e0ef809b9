"""The whole per-frame SLAM step as one frame program, keyframes included.

Port of `stereo_dso_g2o_tpu/frontend/graph_system.py`. The JAX package
jits `frame_auto` into one XLA program whose keyframe decision is a
`lax.cond`; here `frame_auto` is one program on the card, captured once
per shape as a CUDA graph and replayed (`runtime/program.py`), whose
keyframe decision is an IF node on the device's `need_kf` (BA's loop a
WHILE node inside it), and so are `frame_track` and `frame_kf`, the halves
the batched runner dispatches apart:

  track (pyramids + cascade + retry ladder + speculative depth refinement)
  ->  keyframe decision (FullSystem.cpp:1127-1152)
  ->  non-KF: keep the speculative refinement (makeNonKeyFrame)
      KF:     trace-on-KF, flagFramesForMarginalization policy
              (FullSystemMarginalize.cpp:59-145), window insertion,
              activation gate + 1-dof LM + insertion, windowed BA, final
              linearization / flag / marginalize points, tracking-reference
              rebuild, pixel selection + immature seeding, flagged-frame
              marginalization.

All state of a running sequence is one `GraphState` of tensors on one
device; the policies (`kf_decision`, `flag_frames`, `motion_tries`, the
activation-distance controller) are tensor code with no host read. The
track half (`frame_track`, `_track_common`, `_nonkf_branch`) runs N
sequences at once on a state stacked over a leading axis, as the JAX
package's batched program vmaps it; one sequence is the batch of one.

The keyframe pipeline (`_kf_branch`) runs N sequences at once too, as the
JAX package's vmap of it: every step once for all of them, one sequence as
the batch of one (`frame_kf`, `frame_auto`'s keyframe branch).

The captured program reads nothing; `GraphSystem.add_frame` reads the
device once a frame, at the lagged drain of a bundle (`utils/host.Fetch`).
Run eagerly (on the CPU, or inside `program.disabled()`), each loop and
branch of the program reads its flag on the host (`utils/loop.py`): the
tracker's LM levels once an iteration, `need_kf`, and on a keyframe BA's
convergence flags once an iteration, the selector's potentials and the
flagged frames one read each, every read for all sequences of a batch.
`HOST_READS` is their count (`utils/host.py`).

Deviations from the reference, as in the JAX module: one selection pass at
the potential adapted from the previous keyframe's yield plus the random
thinning; the saturation cutoff-repeat runs inside `tracker_ops.lm_level`;
initialization stays on the host `FullSystem`, and
`GraphSystem.from_full_system` freezes a warmed system into graph state.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from stereo_dso_g2o_tpu_torch.backend import ba, builder
from stereo_dso_g2o_tpu_torch.backend import window as W
from stereo_dso_g2o_tpu_torch.config import Settings, default_settings
from stereo_dso_g2o_tpu_torch.frontend import frame_step as FS
from stereo_dso_g2o_tpu_torch.frontend import immature as IMM
from stereo_dso_g2o_tpu_torch.frontend.coarse_tracker import level_caps
from stereo_dso_g2o_tpu_torch.frontend.full_system import device_image, window_point_cloud
from stereo_dso_g2o_tpu_torch.models.camera import Calib
from stereo_dso_g2o_tpu_torch.ops import selector as SEL
from stereo_dso_g2o_tpu_torch.ops import trace as trace_ops
from stereo_dso_g2o_tpu_torch.ops import tracker_ops
from stereo_dso_g2o_tpu_torch.ops.pyramid import build_pyramid
from stereo_dso_g2o_tpu_torch.runtime import program
from stereo_dso_g2o_tpu_torch.utils import host, loop, se3
from stereo_dso_g2o_tpu_torch.utils.fixed import constant
from stereo_dso_g2o_tpu_torch.utils.smalls import matmul_fma
from stereo_dso_g2o_tpu_torch.utils.timing import PROF
from stereo_dso_g2o_tpu_torch.utils.tree import at_rows, first, lead_one, select_rows, tree_map


def __getattr__(name):
    # HOST_READS: the device->host reads of the frame program (utils/host.py)
    if name == "HOST_READS":
        return host.READS
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def reset_host_reads():
    host.reset()


class GraphState(NamedTuple):
    """All device state of one running sequence (fixed shapes)."""

    win: W.Window
    imm: IMM.ImmatureSet
    ref: Tuple  # tracker reference: per-level (u, v, idepth, color, ok)
    ref_slot: torch.Tensor  # () int32 window slot of the tracking reference
    ref_aff: torch.Tensor  # (2,)
    ref_exposure: torch.Tensor  # ()
    dI0_slots: torch.Tensor  # (F, H, W, 3) level-0 pyramids of the window KFs
    last_rmse0: torch.Tensor  # () previous finest-level coarse RMSE
    first_rmse: torch.Tensor  # () first KF-pair RMSE (KF-decision gate)
    kf_out_count: torch.Tensor  # (F,) marginalized-point counters per slot
    min_act_dist: torch.Tensor  # () activation distance controller
    next_kf_id: torch.Tensor  # () int32
    salt: torch.Tensor  # () int32 selector randomization counter
    last_c2w: torch.Tensor  # (4, 4) camToWorld of the previous frame (frozen)
    prev_c2w: torch.Tensor  # (4, 4) camToWorld of the frame before that
    last_aff: torch.Tensor  # (2,) previous frame's affine estimate
    # camToRef + reference identity of the two previous frames: the motion
    # model recomposes their camToWorld with the CURRENT (post-BA) window
    # pose of the reference instead of the frozen composite above
    # (FullSystem.cpp:305-312)
    last_rel: torch.Tensor  # (4, 4) camToRef of the previous frame
    last_slot: torch.Tensor  # () its reference's window slot
    last_fid: torch.Tensor  # () its reference's frame id (slot-reuse guard)
    prev_rel: torch.Tensor  # (4, 4)
    prev_slot: torch.Tensor  # ()
    prev_fid: torch.Tensor  # ()


class FrameBundle(NamedTuple):
    """Small per-frame fetch: everything the host bookkeeping needs."""

    T: torch.Tensor  # (4, 4) refToNew at the PRE-KF tracking reference
    aff: torch.Tensor  # (2,)
    residuals: torch.Tensor  # (L,)
    flow: torch.Tensor  # (3,)
    ok: torch.Tensor  # ()
    sat_frac0: torch.Tensor  # ()
    need_kf: torch.Tensor  # ()
    slot: torch.Tensor  # () inserted window slot (-1 if non-KF)
    flagged: torch.Tensor  # (F,) frames marginalized this step
    w2c: torch.Tensor  # (F, 4, 4) post-step window poses
    aff_all: torch.Tensor  # (F, 2)
    frame_valid: torch.Tensor  # (F,)
    frame_id: torch.Tensor  # (F,) per-slot KF ids
    energy: torch.Tensor  # () BA energy (nan-able)
    nres: torch.Tensor  # ()
    sel_num: torch.Tensor  # () selector yield (for host pot adaptation)
    n_active: torch.Tensor  # ()
    # per-KF point-lifecycle stats (FullSystem.cpp:1646-1687): activated,
    # immature alive, marginalized, dropped; zero on non-KF frames
    n_activated: torch.Tensor  # ()
    n_imm: torch.Tensor  # ()
    n_marg: torch.Tensor  # ()
    n_dropped: torch.Tensor  # ()
    # keyframe-decision inputs (FullSystem.cpp:1127-1152): the weighted
    # flow/affine score (KF when > 1) and the rmse-vs-firstCoarseRMSE pair
    kf_delta: torch.Tensor  # ()
    kf_rmse: torch.Tensor  # () level-0 coarse RMSE of this frame
    kf_first_rmse: torch.Tensor  # () firstCoarseRMSE of the current ref


# ---------------------------------------------------------------------------
# policies (tensor code, no host read)
# ---------------------------------------------------------------------------


def kf_decision(track: FS.TrackOut, ref_aff, ref_exposure, new_exposure,
                first_rmse, wh: float, settings: Settings):
    """FullSystem::makeKeyFrame decision (FullSystem.cpp:1127-1152)."""
    s = settings
    a_rel = (
        torch.exp(track.aff[..., 0] - ref_aff[..., 0]) * new_exposure
        / torch.clamp(ref_exposure, min=1e-9)
    )

    def shift(k):
        return torch.sqrt(torch.clamp(track.flow[..., k], min=0.0)) / wh

    delta = (
        s.kf_global_weight * s.max_shift_weight_t * shift(0)
        + s.kf_global_weight * s.max_shift_weight_r * shift(1)
        + s.kf_global_weight * s.max_shift_weight_rt * shift(2)
        + s.kf_global_weight * s.max_affine_weight
        * torch.abs(torch.log(torch.clamp(a_rel, min=1e-9)))
    )
    need = (delta > 1.0) | (2.0 * first_rmse < track.residuals[..., 0])
    return need, delta


def flag_frames(win: W.Window, imm_valid, kf_out_count, settings: Settings):
    """flagFramesForMarginalization (FullSystemMarginalize.cpp:59-145) on
    tensors. Returns (F,) bool: candidates in frame-id order bounded by
    (n_kfs - min_frames), then the distance-score rule when the window would
    overflow. (N, F) for a window stacked over N sequences."""
    s = settings
    F = win.F
    dev = win.device
    valid = win.frame_valid
    fid = torch.where(valid, win.frame_id, torch.full_like(win.frame_id, 2**31 - 1))
    n_kfs = torch.sum(valid, dim=-1)

    active = win.pt_status == W.PT_ACTIVE
    n_in = torch.zeros(valid.shape, dtype=torch.int32, device=dev).scatter_add_(
        -1, win.pt_host.long(), active.to(torch.int32)
    ) + torch.sum(imm_valid, dim=-1).to(torch.int32)
    n_out = kf_out_count.to(torch.int32)

    # affine gap vs the newest window KF (frameHessians.back())
    back = torch.argmax(torch.where(valid, win.frame_id, torch.full_like(win.frame_id, -1)), dim=-1)
    aff_all = win.aff_g2l()
    exps = win.ab_exposure
    aff_back = FS._at_slot(aff_all, back)
    a_rel = (torch.exp(aff_all[..., 0] - aff_back[..., 0, None]) * exps
             / torch.clamp(FS._at_slot(exps, back)[..., None], min=1e-9))
    drop = (n_in < s.min_points_remaining * (n_in + n_out)) | (
        torch.abs(torch.log(torch.clamp(a_rel, min=1e-12))) > s.max_log_aff_fac_in_window
    )
    candidate = valid & drop

    # greedy in frame-id order, at most max(n_kfs - min_frames, 0) flags
    order = torch.argsort(fid, dim=-1, stable=True)
    cand_sorted = torch.gather(candidate, -1, order)
    rank = torch.cumsum(cand_sorted.to(torch.int32), -1) - 1  # rank among cands
    allow = cand_sorted & (rank < torch.clamp(n_kfs - s.min_frames, min=0)[..., None])
    flagged = torch.zeros_like(valid).scatter(-1, order, allow)
    n_flagged = torch.sum(flagged, dim=-1)

    # distance-score rule when the window is (over)full; +1 for the incoming
    need_dist = (n_kfs + 1 - n_flagged) >= (s.max_frames + 1)
    w2c = win.w2c()
    latest = back
    latest_id = FS._at_slot(win.frame_id, latest)[..., None]
    rel = torch.einsum("...tij,...sjk->...stik", w2c, torch.linalg.inv_ex(w2c).inverse)  # [s,t]
    d = torch.linalg.norm(rel[..., :3, 3], dim=-1)  # (F_s, F_t)
    t_ok = valid & ~(win.frame_id > latest_id - s.min_frame_age + 1)
    eye = torch.eye(F, dtype=torch.bool, device=dev)
    contrib = torch.where(t_ok[..., None, :] & ~eye, 1.0 / (1e-5 + d), torch.zeros_like(d))
    d_latest = torch.gather(d, -1, latest[..., None, None].expand(d.shape[:-1] + (1,)))[..., 0]
    score = -torch.sqrt(torch.clamp(d_latest, min=1e-12)) * torch.sum(contrib, -1)
    s_ok = valid & (win.frame_id <= latest_id - s.min_frame_age) & (win.frame_id != 0)
    score = torch.where(s_ok, score, torch.full_like(score, float("inf")))
    best_slot = torch.argmin(score, dim=-1)
    flag_dist = need_dist & torch.isfinite(FS._at_slot(score, best_slot))
    return flagged | ((torch.arange(F, device=dev) == best_slot[..., None]) & flag_dist[..., None])


def _free_slot(win: W.Window):
    return torch.argmin(win.frame_valid.to(torch.int32), dim=-1).to(torch.int32)


def _rigid_inv(T):
    """SE(3) inverse without a linear solve; T (..., 4, 4)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Ti = torch.eye(4, dtype=T.dtype, device=T.device).expand(T.shape).clone()
    Ti[..., :3, :3] = R.transpose(-1, -2)
    Ti[..., :3, 3] = matmul_fma(-R.transpose(-1, -2), t[..., None])[..., 0]
    return Ti


def motion_tries(last_c2w, prev_c2w, ref_c2w, dtype=torch.float32):
    """The 5 pose hypotheses lastF->fh (FullSystem.cpp:349-377): constant
    motion, double, half, last-frame pose, zero-from-KF. (5, 4, 4), or
    (N, 5, 4, 4) for (N, 4, 4) poses of N sequences."""
    mm = matmul_fma  # a sequence's products round alike alone and in a batch
    slast_2_sprelast = mm(_rigid_inv(prev_c2w), last_c2w)
    lastF_2_slast = mm(_rigid_inv(last_c2w), ref_c2w)
    fh_2_slast = slast_2_sprelast  # constant velocity
    fh_inv = _rigid_inv(fh_2_slast)
    half = se3.se3_exp(0.5 * se3.se3_log(fh_2_slast, matmul=mm), matmul=mm)
    eye = torch.eye(4, dtype=dtype, device=last_c2w.device)
    tries = torch.stack(
        [
            mm(fh_inv, lastF_2_slast),
            mm(mm(fh_inv, fh_inv), lastF_2_slast),
            mm(_rigid_inv(half), lastF_2_slast),
            lastF_2_slast,
            eye.expand(lastF_2_slast.shape),
        ],
        dim=-3,
    ).to(dtype)
    # non-finite guards (uninitialized history): fall back to identity
    ok = torch.isfinite(tries).all(dim=-1).all(dim=-1)[..., None, None]
    return torch.where(ok, tries, eye)


def _update_min_act_dist(min_act_dist, n_active, density):
    """The activation distance controller (FullSystem.cpp:808-824)."""
    d = density
    n = n_active.to(torch.float32)
    w = torch.where
    delta = w(n < d * 0.66, -0.8, 0.0)
    delta = delta + w(n < d * 0.8, -0.5, w(n < d * 0.9, -0.2, w(n < d, -0.1, 0.0)))
    delta = delta + w(n > d * 1.5, 0.8, 0.0)
    delta = delta + w(n > d * 1.3, 0.5, w(n > d * 1.15, 0.2, w(n > d, 0.1, 0.0)))
    return torch.clamp(min_act_dist + delta, 0.0, 4.0)


# ---------------------------------------------------------------------------
# the frame program
# ---------------------------------------------------------------------------


def _levels(calib: Calib):
    return calib.n_levels


class TrackAux(NamedTuple):
    """Everything the keyframe program needs beyond the pre-state."""

    dIpL: Tuple  # full left pyramid (n_levels tensors)
    dIpR0: torch.Tensor  # right level-0 pyramid
    track: FS.TrackOut
    T_best: torch.Tensor
    aff_best: torch.Tensor
    flow: torch.Tensor
    ok_eff: torch.Tensor
    new_last: torch.Tensor
    new_first: torch.Tensor
    need_kf: torch.Tensor
    kf_inputs: torch.Tensor  # (3,) decision-audit inputs (delta, rmse, first)


@PROF.section("track", True)
def _track_common(state: GraphState, left, right, calib_c, baseline, new_exposure,
                  settings: Settings, n_levels: int, n_tries: int, w0: int, h0: int):
    """Shared front half of every frame: pyramids + cascade + retry ladder +
    speculative non-KF refinement + the keyframe decision. Returns the
    speculative immature set and a TrackAux.

    N sequences at once: `state` stacked over N, images (N, H, W),
    calib_c (N, 4), baseline and new_exposure (N,); every slot is gathered
    on the device (`_track_one` runs one sequence as the batch of one)."""
    s = settings
    win = state.win
    w2c_pre0 = win.w2c()
    ref_c2w = _rigid_inv(at_rows(w2c_pre0, state.ref_slot.long()))

    def fresh_c2w(comp, rel, slot, fid):
        slot = slot.long()
        ok = at_rows(win.frame_valid, slot) & (at_rows(win.frame_id, slot) == fid)
        fresh = matmul_fma(_rigid_inv(at_rows(w2c_pre0, slot)), rel)
        return torch.where(ok[:, None, None], fresh, comp)

    last_c2w = fresh_c2w(state.last_c2w, state.last_rel, state.last_slot, state.last_fid)
    prev_c2w = fresh_c2w(state.prev_c2w, state.prev_rel, state.prev_slot, state.prev_fid)
    T_tries = motion_tries(last_c2w, prev_c2w, ref_c2w)[:, :n_tries]
    aff_init = state.last_aff

    last_rmse = torch.where(
        torch.isfinite(state.last_rmse0), state.last_rmse0,
        torch.full_like(state.last_rmse0, 1e30),
    )
    (dIpL, dIpR), imm_spec, track, _ = FS.frame_step_full(
        left, right, state.ref, win, state.imm, calib_c, baseline, state.ref_slot,
        T_tries, aff_init, state.ref_aff, state.ref_exposure, new_exposure,
        last_rmse, settings=s, n_levels=n_levels, n_tries=n_tries,
    )
    # track failure: take the predicted pose and hope (FullSystem.cpp:503-508)
    rmse0 = track.residuals[:, 0]
    ok_eff = track.ok & torch.isfinite(rmse0) & (track.sat_frac0 <= 0.6)
    T_best = torch.where(ok_eff[:, None, None], track.T, T_tries[:, 0])
    aff_best = torch.where(ok_eff[:, None], track.aff, aff_init)
    flow = torch.where(ok_eff[:, None], track.flow, torch.zeros_like(track.flow))
    new_last = torch.where(ok_eff & torch.isfinite(rmse0), rmse0, state.last_rmse0)
    new_first = torch.where(
        state.first_rmse < 0, torch.where(ok_eff, rmse0, state.first_rmse),
        state.first_rmse,
    )

    track_eff = track._replace(T=T_best, aff=aff_best, flow=flow)
    need_kf, kf_delta = kf_decision(
        track_eff, state.ref_aff, state.ref_exposure, new_exposure,
        new_first, float(w0 + h0), s,
    )
    aux = TrackAux(
        dIpL=dIpL, dIpR0=dIpR[0], track=track, T_best=T_best, aff_best=aff_best,
        flow=flow, ok_eff=ok_eff, new_last=new_last, new_first=new_first,
        need_kf=need_kf, kf_inputs=torch.stack([kf_delta, rmse0, new_first], -1),
    )
    return imm_spec, aux


def _track_one(state: GraphState, left, right, calib_c, baseline, new_exposure,
               settings: Settings, n_levels: int, n_tries: int, w0: int, h0: int):
    """The track half of one sequence as the batch of one: (the state with
    a leading axis of one, its speculative immature set, its TrackAux)."""
    dev = left.device
    one = lead_one(state)
    imm_spec, aux = _track_common(
        one, left[None], right[None], calib_c[None], torch.as_tensor(baseline, device=dev)[None],
        torch.as_tensor(new_exposure, device=dev)[None], settings, n_levels, n_tries, w0, h0,
    )
    return one, imm_spec, aux


def _nonkf_one(state: GraphState, one: GraphState, imm_spec, aux: TrackAux):
    """`_nonkf_branch` of one sequence run as the batch of one (`one`: the
    state with its leading axis); a field it passes on unchanged stays the
    caller's object."""
    st, bundle = _nonkf_branch(one, imm_spec, aux)
    own = {id(getattr(one, f)): getattr(state, f) for f in GraphState._fields}
    return GraphState(*[own[id(x)] if id(x) in own else first(x) for x in st]), first(bundle)


def _nonkf_branch(state: GraphState, imm_spec, aux: TrackAux):
    """makeNonKeyFrame: keep the speculative refinement. One sequence, or N
    with every leaf stacked."""
    win = state.win
    dev = win.device
    F = win.F
    lead = tuple(state.ref_slot.shape)  # () or (N,)
    w2c_pre0 = win.w2c()
    ref_slot = state.ref_slot.long()
    st = state._replace(
        imm=imm_spec, last_rmse0=aux.new_last, first_rmse=aux.new_first,
        last_c2w=_rigid_inv(matmul_fma(aux.T_best, FS._at_slot(w2c_pre0, ref_slot))),
        prev_c2w=state.last_c2w,
        last_aff=aux.aff_best,
        last_rel=_rigid_inv(aux.T_best),
        last_slot=state.ref_slot,
        last_fid=FS._at_slot(win.frame_id, ref_slot),
        prev_rel=state.last_rel,
        prev_slot=state.last_slot,
        prev_fid=state.last_fid,
    )
    zero = torch.zeros(lead, dtype=torch.int32, device=dev)
    bundle = FrameBundle(
        T=aux.T_best, aff=aux.aff_best, residuals=aux.track.residuals, flow=aux.flow,
        ok=aux.ok_eff, sat_frac0=aux.track.sat_frac0, need_kf=aux.need_kf,
        slot=torch.full(lead, -1, dtype=torch.int32, device=dev),
        flagged=torch.zeros(lead + (F,), dtype=torch.bool, device=dev),
        w2c=w2c_pre0, aff_all=win.aff_g2l(),
        frame_valid=win.frame_valid, frame_id=win.frame_id,
        energy=torch.full(lead, float("nan"), dtype=torch.float32, device=dev),
        nres=zero, sel_num=zero,
        n_active=torch.sum(win.pt_status == W.PT_ACTIVE, dim=-1).to(torch.int32),
        n_activated=zero,
        n_imm=torch.sum(imm_spec.valid.reshape(lead + (-1,)), dim=-1).to(torch.int32),
        n_marg=zero, n_dropped=zero,
        kf_delta=aux.kf_inputs[..., 0], kf_rmse=aux.kf_inputs[..., 1],
        kf_first_rmse=aux.kf_inputs[..., 2],
    )
    return st, bundle


@PROF.section("kf", True)
def _kf_branch(state: GraphState, aux: TrackAux, calib_c, baseline, new_exposure,
               settings: Settings, n_levels: int, pots, caps: Tuple[int, ...],
               w0: int, h0: int, imm_cap: int,
               uniforms: Optional[Sequence[Optional[Callable]]] = None):
    """The whole keyframe pipeline (makeKeyFrame) from the PRE-frame state +
    the tracking result, in the JAX branch's order of operations, for N
    sequences at once: `state` and `aux` stacked over N, calib_c (N, 4),
    baseline and new_exposure (N,), a selector potential per sequence
    (`pots`, (N,) integers on the device) and its salt from the state.
    Each step runs once for all N (K1 three launches in all); one sequence
    is the batch of one. No host read: BA's loop, the selector's
    potentials and the flagged frames are device loops and branches
    (`utils/loop.py`), the thinning draw `selector.graph_uniform`.

    `uniforms`: per sequence, None (that draw) or a host function
    `uniform(salt, shape, device)` in its place, which reads the salts (a
    test's injected draw; eager only, `_host_draw`)."""
    s = settings
    win, imm = state.win, state.imm
    dev = win.device
    N, F = win.frame_valid.shape
    rows = torch.arange(N, device=dev)
    dIpL, T_best, aff_best = aux.dIpL, aux.T_best, aux.aff_best
    T_new_w2c = matmul_fma(T_best, at_rows(win.w2c(), state.ref_slot.long()))

    # STEP 1: trace all immature points onto the incoming KF
    with PROF.section("graph.kf.trace", True):
        imm = FS.kf_trace_step(
            win, imm, dIpL[0], calib_c, baseline, T_new_w2c, aff_best, new_exposure,
            settings=s, n_levels=n_levels,
        )

    # STEP 2: flagging policy (pre-insertion window); the flags stay on the
    # device (STEP 10 marginalizes slot by slot under a device branch)
    flagged = flag_frames(win, imm.valid, state.kf_out_count, s)
    slot = _free_slot(win)
    kf_id = state.next_kf_id.to(torch.int32)

    # STEP 3: insert the KF. Its level-0 pyramid goes into the slot's row of
    # a new (N, F, H, W, 3) stack, as the JAX package's `.at[].set` (41 MB
    # a sequence at 1216x352): the pre-frame state keeps its own stack
    win = builder.insert_frame(win, slot, T_new_w2c, aff_best, new_exposure, kf_id)
    dI0 = state.dI0_slots.clone()
    dI0[rows, slot.long()] = dIpL[0]

    # STEP 4: residuals from active points to the new KF
    active_pts = win.pt_status == W.PT_ACTIVE
    tgt = (torch.arange(F, device=dev) == slot[:, None])[:, None, :]
    win = win.replace(
        res_exists=torch.where(tgt, active_pts[..., None], win.res_exists),
        res_state=torch.where(tgt, torch.full_like(win.res_state, W.RES_IN), win.res_state),
        res_linearized=win.res_linearized & ~tgt,
    )

    # STEP 5: activation (distance controller + gate + LM + insertion)
    n_active = torch.sum(active_pts, dim=-1).to(torch.int32)
    mad = _update_min_act_dist(state.min_act_dist, n_active, s.desired_point_density)
    with PROF.section("graph.kf.activate", True):
        cand_flat, delete = IMM.activation_gate(
            win, imm, slot, mad, calib_c, settings=s, h1=h0 >> 1, w1=w0 >> 1
        )
        imm = imm.replace(valid=imm.valid & ~delete)
        pre = W.precalc(win)
        act = IMM.optimize_immature(
            imm, cand_flat, pre["RTll"], pre["tTll"], pre["aff"], win.frame_valid,
            dI0, win.c_value, settings=s,
        )
        win, imm, n_activated = IMM.insert_activated(win, imm, act, settings=s)

    # STEP 6: windowed BA (steady-state window: standard iteration cap)
    with PROF.section("graph.kf.ba", True):
        win, energy, nres = ba.optimize_fused(win, dI0, settings=s, max_its=s.max_opt_iterations)

    # STEPS 7-8: final linearization, outlier removal, tracking-ref inputs,
    # point flagging + marginalization
    with PROF.section("graph.kf.finalize", True):
        win, ref_inputs, gone, w2c_post, aff_all, _, (n_marg, n_drop) = FS.kf_finalize(
            win, dI0, dIpL[0], aux.dIpR0, slot, flagged, state.ref_slot, calib_c, baseline,
            settings=s, n_levels=n_levels,
        )
    kf_out = state.kf_out_count + torch.zeros((N, F), dtype=torch.int32, device=dev).scatter_add_(
        -1, win.pt_host.long(), gone.to(torch.int32)
    )

    # tracking reference rebuild (makeCoarseDepthL0 STEP2-5)
    us_r, vs_r, id_r, wt_r, sel_r = ref_inputs
    with PROF.section("graph.kf.ref", True):
        id_maps, valid_maps, color_maps = tracker_build_ref(
            us_r, vs_r, id_r, wt_r, sel_r, dIpL, n_levels
        )
        new_ref = tuple(
            SEL_compact(id_maps[l], valid_maps[l], color_maps[l], caps[l])
            for l in range(n_levels)
        )

    # STEP 9: seed new immature points (one selection pass at each
    # sequence's host-adapted potential, with the reference's random
    # thinning, each sequence's own draw)
    with PROF.section("graph.kf.new_traces", True):
        asg = build_pyramid(dIpL[0][..., 0], 3)[1]
        ths = SEL.block_thresholds(asg[0], s)
        selm = SEL.select(dIpL[0], asg[0], asg[1], asg[2], ths, pots, 1.0, state.salt, s)
        num_have = torch.sum(selm.counts, dim=-1)
        quotia = s.desired_immature_density / torch.clamp(num_have.to(torch.float64), min=1.0)
        shape = tuple(selm.status_map.shape[1:])
        if uniforms is not None and any(d is not None for d in uniforms):
            u = _host_draw(state.salt, shape, uniforms)
        else:
            u = SEL.graph_uniform(state.salt, shape)
        # compared in the draw's precision, as one sequence's 0-dim quotia is
        q = quotia[:, None, None]
        thin = (q < 0.95) & ~(u < q.to(u.dtype))
        status = torch.where(thin, torch.zeros_like(selm.status_map), selm.status_map)
        us, vs, types, sel_valid = SEL.map_to_points(status, imm_cap)
        imm = IMM.seed_slot(imm, slot, dIpL[0], us, vs, types, sel_valid, settings=s)

    # STEP 10: marginalize flagged frames
    with PROF.section("graph.kf.marg_frames", True):
        win = ba.marginalize_frames_masked(win, flagged, settings=s)
        imm = imm.replace(valid=imm.valid & ~flagged[..., None])

    aff_slot = at_rows(aff_all, slot.long())
    st = GraphState(
        win=win,
        imm=imm,
        ref=new_ref,
        ref_slot=slot,
        ref_aff=aff_slot,
        ref_exposure=new_exposure,
        dI0_slots=dI0,
        last_rmse0=aux.new_last,
        # firstCoarseRMSE is per tracking reference: reset on every new KF
        # (CoarseTracker.cpp:803,823); the next frame's RMSE against the new
        # reference becomes "first"
        first_rmse=torch.full((N,), -1.0, dtype=torch.float32, device=dev),
        kf_out_count=kf_out,
        min_act_dist=mad,
        next_kf_id=kf_id + 1,
        salt=state.salt.to(torch.int32) + 1,
        last_c2w=_rigid_inv(at_rows(w2c_post, slot.long())),
        prev_c2w=state.last_c2w,
        last_aff=aff_slot.to(state.last_aff.dtype),
        last_rel=torch.eye(4, dtype=state.last_rel.dtype, device=dev).expand(N, 4, 4).clone(),
        last_slot=slot,
        last_fid=kf_id,
        prev_rel=state.last_rel,
        prev_slot=state.last_slot,
        prev_fid=state.last_fid,
    )
    bundle = FrameBundle(
        T=T_best, aff=aff_best, residuals=aux.track.residuals, flow=aux.flow,
        ok=aux.ok_eff, sat_frac0=aux.track.sat_frac0, need_kf=aux.need_kf,
        slot=slot,
        flagged=flagged,
        w2c=win.w2c(), aff_all=win.aff_g2l(),
        frame_valid=win.frame_valid, frame_id=win.frame_id,
        energy=energy.to(torch.float32), nres=nres.to(torch.int32),
        sel_num=num_have.to(torch.int32),
        n_active=n_active,
        n_activated=n_activated.to(torch.int32),
        n_imm=torch.sum(imm.valid.flatten(-2), dim=-1).to(torch.int32),
        n_marg=n_marg, n_dropped=n_drop,
        kf_delta=aux.kf_inputs[..., 0], kf_rmse=aux.kf_inputs[..., 1],
        kf_first_rmse=aux.kf_inputs[..., 2],
    )
    return st, bundle


def _host_draw(salts, shape, uniforms):
    """The thinning draws of `_kf_branch` where a host function replaces
    `selector.graph_uniform` for some sequences: one read of the salts."""
    dev = salts.device
    out = []
    for k, (salt, draw) in enumerate(zip(host.tolist(salts), uniforms)):
        u = SEL.graph_uniform(salts[k], shape) if draw is None else draw(salt, shape, dev)
        out.append(torch.as_tensor(u, device=dev))
    return torch.stack(out)


def _kf_one(state: GraphState, aux_one: TrackAux, calib_c, baseline, new_exposure, pot,
            settings: Settings, n_levels: int, caps: Tuple[int, ...],
            w0: int, h0: int, imm_cap: int, uniform: Optional[Callable] = None):
    """The keyframe pipeline of one sequence as the batch of one (`aux_one`
    with its leading axis; `pot` a () integer tensor)."""
    st, bundle = _kf_branch(
        lead_one(state), aux_one, calib_c[None], baseline.reshape(1), new_exposure.reshape(1),
        settings, n_levels, pot.reshape(1), caps, w0, h0, imm_cap,
        None if uniform is None else [uniform],
    )
    return first(st), first(bundle)


def _frame_auto(state: GraphState, left, right, calib_c, baseline, new_exposure, pots,
                settings: Settings, n_levels: int, n_tries: int, caps: Tuple[int, ...],
                w0: int, h0: int, imm_cap: int, gate: bool = True,
                uniforms: Optional[Sequence[Optional[Callable]]] = None):
    """`frame_auto` (one sequence, images (H, W)) or "fused" (N stacked,
    images (N, H, W)) run eagerly: what their programs capture. The track
    half, the non-keyframe update, and the keyframe pipeline from the
    pre-frame state, kept per row where `need_kf` holds. With `gate` the
    pipeline is the body of a `utils/loop.cond` on "some row needs a
    keyframe" (an IF node in the program: the JAX package's scalar
    `lax.cond`, which runs the taken branch only); without it, it always
    runs (the JAX package's vmap of that cond, which runs both)."""
    if left.dim() == 2:
        st, bundle = _frame_auto(
            lead_one(state), left[None], right[None], calib_c[None], baseline.reshape(1),
            new_exposure.reshape(1), pots.reshape(1), settings, n_levels, n_tries, caps,
            w0, h0, imm_cap, gate, uniforms)
        return first(st), first(bundle)
    imm_spec, aux = _track_common(state, left, right, calib_c, baseline, new_exposure,
                                  settings, n_levels, n_tries, w0, h0)
    nonkf = _nonkf_branch(state, imm_spec, aux)

    def kf():
        st_k, b_k = _kf_branch(state, aux, calib_c, baseline, new_exposure, settings, n_levels,
                               pots, caps, w0, h0, imm_cap, uniforms)
        picked = select_rows(aux.need_kf, (st_k, b_k), nonkf)
        return tree_map(lambda x, like: x.to(like.dtype), picked, nonkf)

    return loop.cond(aux.need_kf.any(), kf, nonkf, name="kf.need") if gate else kf()


def _on_device(x, dtype, dev) -> torch.Tensor:
    """An input of a frame program on `dev`: a tensor as it is; a Python
    number on a program path made once per device (`utils/fixed.constant`:
    no copy from the host that waits for the device), else a new tensor."""
    if isinstance(x, torch.Tensor):
        return x.to(device=dev)
    if program.active(dev):
        return constant(x, dtype, dev)
    return torch.as_tensor(x, dtype=dtype, device=dev)


def _no_host_draw(uniform, arg: str):
    """A host draw (`uniform=`, `uniforms=`) cannot be captured: on a
    program path it raises and names the argument."""
    draws = uniform if isinstance(uniform, (list, tuple)) else [uniform]
    if any(d is not None for d in draws):
        raise ValueError(
            f"`{arg}`: a host function cannot be captured into the frame program, which "
            "draws with selector.graph_uniform (the JAX package's draw); pass it only on "
            "the CPU or inside program.disabled()")


def frame_auto(state: GraphState, left, right, calib_c, baseline, new_exposure,
               settings: Settings = default_settings(), n_levels: int = 6,
               n_tries: int = 5, pot=3, caps: Tuple[int, ...] = (),
               w0: int = 0, h0: int = 0, imm_cap: int = 2048,
               uniform: Optional[Callable] = None):
    """One full frame, the JAX package's `jax.jit(frame_auto)`: the track
    half, then the keyframe pipeline from the pre-frame state under a
    branch on the device's `need_kf`, or the track's speculative non-KF
    update. On the card one program per shape, captured at its first call
    and replayed after it (`runtime/program.py`): the branch is an IF node
    whose body holds BA's WHILE node and the selector's and the
    marginalization's IF nodes, and nothing in it reads the host. On the
    CPU, and inside `program.disabled()`, it runs eagerly (one read of
    `need_kf`, and the reads of its loops).

    left/right: (H, W) raw images on the state's device. Pose hypotheses
    (constant-velocity motion model, FullSystem.cpp:349-377) and the affine
    init come from GraphState. `pot`: the selector potential, an int or a
    () integer tensor, an input of the program (not part of its key).
    `uniform(salt, shape, device)` replaces the thinning draw
    (`selector.graph_uniform`) eagerly only: on a program path it raises.
    Returns (GraphState, FrameBundle)."""
    dev = left.device
    args = (state, left, right, calib_c, _on_device(baseline, torch.float32, dev),
            _on_device(new_exposure, torch.float32, dev), _on_device(pot, torch.int32, dev))
    static = dict(settings=settings, n_levels=n_levels, n_tries=n_tries, caps=tuple(caps),
                  w0=w0, h0=h0, imm_cap=imm_cap)
    if program.active(dev):
        _no_host_draw(uniform, "uniform")
        return program.run(_frame_auto, args, static, key=(trace_ops.DEFAULT_ROUTE,))
    return _frame_auto(*args, **static, uniforms=None if uniform is None else [uniform])


def frame_track(state: GraphState, left, right, calib_c, baseline, new_exposure,
                settings: Settings = default_settings(), n_levels: int = 6,
                n_tries: int = 5, w0: int = 0, h0: int = 0):
    """Track-only half: always applies the speculative non-KF update and
    returns the aux needed to run the keyframe pipeline from the pre-state
    when `need_kf` comes back true (makeKeyFrame vs makeNonKeyFrame
    dispatch, FullSystem.cpp:1168-1221). Returns (state, bundle, aux).

    N sequences at once (`parallel/batched.frame_track_batched`): `state`
    stacked over N, images (N, H, W), calib_c (N, 4), baseline and
    new_exposure (N,); the outputs are stacked. One sequence (images
    (H, W)) runs as the batch of one.

    On the card this is the JAX package's `jax.jit(frame_track)`: one
    program per shape, captured at its first call and replayed after it
    (`runtime/program.py`), with no host read inside; it writes none of
    its inputs. On the CPU, and inside `program.disabled()`, it runs
    eagerly."""
    dev = left.device
    if program.active(dev):
        return program.run(
            _frame_track,
            (state, left, right, calib_c, torch.as_tensor(baseline, device=dev),
             torch.as_tensor(new_exposure, device=dev)),
            dict(settings=settings, n_levels=n_levels, n_tries=n_tries, w0=w0, h0=h0),
            key=(trace_ops.DEFAULT_ROUTE,),
        )
    return _frame_track(state, left, right, calib_c, baseline, new_exposure, settings,
                        n_levels, n_tries, w0, h0)


def _frame_track(state: GraphState, left, right, calib_c, baseline, new_exposure,
                 settings: Settings, n_levels: int, n_tries: int, w0: int, h0: int):
    """`frame_track` run eagerly (what its program captures)."""
    if left.dim() == 2:
        one, imm_spec, aux = _track_one(
            state, left, right, calib_c, baseline, new_exposure, settings,
            n_levels, n_tries, w0, h0,
        )
        st, bundle = _nonkf_one(state, one, imm_spec, aux)
        return st, bundle, first(aux)
    imm_spec, aux = _track_common(
        state, left, right, calib_c, baseline, new_exposure, settings,
        n_levels, n_tries, w0, h0,
    )
    st, bundle = _nonkf_branch(state, imm_spec, aux)
    return st, bundle, aux


def frame_kf(state_pre: GraphState, aux: TrackAux, calib_c, baseline, new_exposure,
             settings: Settings = default_settings(), n_levels: int = 6,
             pot=3, caps: Tuple[int, ...] = (), w0: int = 0, h0: int = 0,
             imm_cap: int = 2048, uniform: Optional[Callable] = None):
    """The keyframe pipeline of one sequence from the PRE-frame state +
    frame_track's aux: the same function as frame_auto's keyframe branch,
    run as the batch of one (`parallel/batched.frame_kf_subset_batched`
    runs several sequences' as one). On the card one program per shape
    (the JAX package's `jax.jit(frame_kf)`), eagerly on the CPU and inside
    `program.disabled()`; `pot` and `uniform` as in `frame_auto`."""
    dev = calib_c.device
    args = (state_pre, aux, calib_c, _on_device(baseline, torch.float32, dev),
            _on_device(new_exposure, torch.float32, dev), _on_device(pot, torch.int32, dev))
    static = dict(settings=settings, n_levels=n_levels, caps=tuple(caps), w0=w0, h0=h0,
                  imm_cap=imm_cap)
    if program.active(dev):
        _no_host_draw(uniform, "uniform")
        return program.run(_frame_kf, args, static, key=(trace_ops.DEFAULT_ROUTE,))
    return _frame_kf(*args, **static, uniform=uniform)


def _frame_kf(state_pre: GraphState, aux: TrackAux, calib_c, baseline, new_exposure, pot,
              settings: Settings, n_levels: int, caps: Tuple[int, ...], w0: int, h0: int,
              imm_cap: int, uniform: Optional[Callable] = None):
    """`frame_kf` run eagerly (what its program captures)."""
    return _kf_one(state_pre, lead_one(aux), calib_c, baseline, new_exposure, pot, settings,
                   n_levels, caps, w0, h0, imm_cap, uniform)


def tracker_build_ref(us, vs, idepths, weights, valid, dI_ref, n_levels):
    return tracker_ops.build_ref_maps(
        us, vs, idepths, weights, valid, n_levels=n_levels, dI_ref=dI_ref
    )


def SEL_compact(id_map, valid_map, color_map, cap):
    return tracker_ops.compact_ref_level(id_map, valid_map, color_map, cap)


# ---------------------------------------------------------------------------
# host wrapper
# ---------------------------------------------------------------------------


class GraphShell:
    __slots__ = ("id", "timestamp", "T_cam_to_ref", "ref_kf_id", "aff", "is_kf", "T_cw")

    def __init__(self, fid, ts, T_cam_to_ref, ref_kf_id, aff):
        self.id = fid
        self.timestamp = ts
        self.T_cam_to_ref = T_cam_to_ref
        self.ref_kf_id = ref_kf_id
        self.aff = aff
        self.is_kf = False
        self.T_cw = None


class GraphSystem:
    """Steady-state odometry on the frame program.

    Bootstrap through the host FullSystem (initialization + first
    keyframes), then `GraphSystem.from_full_system(fs)` continues from its
    state, on its device. Host state is bookkeeping only: trajectory shells,
    keyframe shells, selector-potential adaptation."""

    def __init__(self, calib: Calib, settings: Settings, state: GraphState,
                 history, kf_shells, slot_frame_id, pot: int = 3,
                 uniform: Optional[Callable] = None):
        self.calib = calib
        self.settings = settings
        self.state = state
        self.device = state.win.device
        self.history: List[GraphShell] = history
        self.kf_shells = kf_shells
        self.slot_frame_id = dict(slot_frame_id)
        self.pot = pot
        self.uniform = uniform
        self.caps = tuple(level_caps(calib))
        self.is_lost = False
        self.n_frame_marginalizations = 0  # by this system, as FullSystem counts its own
        self.init_failed = False  # initialization is always host-side; kept
        # for interface parity with FullSystem (CLI reset logic)
        self._pending_q = []  # [(FrameBundle (device), frame_id, ts, its Fetch), ...]

    # -- construction ------------------------------------------------------
    @classmethod
    def from_full_system(cls, fs, uniform: Optional[Callable] = None) -> "GraphSystem":
        """Freeze a warmed FullSystem into graph state on the FullSystem's
        device. `uniform`: the thinning draw of the keyframe branch."""
        dev = fs.device
        F = fs.win.F
        H, Wd = fs.calib.h[0], fs.calib.w[0]
        zeros_im = torch.zeros((H, Wd, 3), dtype=torch.float32, device=dev)
        dI0 = torch.stack([
            fs.dI_slots[s_][0] if fs.dI_slots[s_] is not None else zeros_im
            for s_ in range(F)
        ])

        def shell_rel(sh):
            """(camToRef, ref window slot, ref frame id) for the motion
            model's at-use recomposition; (-1 fid) disables it when the
            reference already left the window."""
            kf_id_of_slot = fs.slot_frame_id  # {slot: kf_id}
            if sh.is_kf:
                # the shell IS a keyframe: find its own slot
                own_id = next(k for k, kf in enumerate(fs.kf_shells) if kf is sh)
                for s_, kid in kf_id_of_slot.items():
                    if kid == own_id:
                        return np.eye(4), s_, kid
                # fall through if already marginalized
            if sh.ref_kf_id >= 0:
                for s_, kid in kf_id_of_slot.items():
                    if kid == sh.ref_kf_id:
                        return np.asarray(sh.T_cam_to_ref), s_, kid
            return np.eye(4), 0, -1  # fallback: frozen composite only

        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=dev)

        def i32(x):
            return torch.as_tensor(np.asarray(x, np.int32), device=dev)

        rel_l, slot_l, fid_l = shell_rel(fs.history[-1])
        rel_p, slot_p, fid_p = shell_rel(fs.history[-2])
        rmse0 = fs.last_coarse_rmse[0]
        state = GraphState(
            win=fs.win,
            imm=fs.imm,
            ref=tuple(fs.tracker.ref),
            ref_slot=i32(fs.kf_slots[-1]),
            ref_aff=fs.tracker.ref_aff.to(torch.float32),
            ref_exposure=f32(fs.tracker.ref_exposure),
            dI0_slots=dI0,
            last_rmse0=f32(rmse0 if np.isfinite(rmse0) else 1e30),
            first_rmse=f32(fs.tracker.first_coarse_rmse),
            kf_out_count=i32(fs.kf_out_count),
            min_act_dist=f32(fs.current_min_act_dist),
            next_kf_id=i32(fs.next_kf_id),
            salt=i32(1000 * (1 + len(fs.kf_shells))),
            last_c2w=f32(fs._shell_T_cw(fs.history[-1])),
            prev_c2w=f32(fs._shell_T_cw(fs.history[-2])),
            last_aff=f32(fs.history[-1].aff),
            last_rel=f32(rel_l),
            last_slot=i32(slot_l),
            last_fid=i32(fid_l),
            prev_rel=f32(rel_p),
            prev_slot=i32(slot_p),
            prev_fid=i32(fid_p),
        )
        history = [
            GraphShell(sh.id, sh.timestamp, sh.T_cam_to_ref, sh.ref_kf_id, sh.aff)
            for sh in fs.history
        ]
        for g, sh in zip(history, fs.history):
            g.is_kf = sh.is_kf
            g.T_cw = sh.T_cw
        # as in the JAX module, the keyframe list keeps the FullSystem's own
        # shells: a later BA refresh moves the poses that non-keyframes
        # compose through, while the bootstrap keyframes' entries in
        # `history` keep the pose they had at the freeze
        return cls(
            fs.calib, fs.settings, state, history, list(fs.kf_shells),
            fs.slot_frame_id, pot=fs.selector.current_potential, uniform=uniform,
        )

    # -- stepping ----------------------------------------------------------
    #
    # As the JAX package, frame i+1 is dispatched without waiting on frame
    # i, and the small FrameBundle drains `fetch_lag` frames behind: each
    # frame's bundle starts its copy to the host behind the frame's program
    # (`utils/host.Fetch`), and the drain waits for that copy only, so the
    # device runs up to `fetch_lag` frames ahead of the host. The selector
    # potential a frame uses is the one adapted at the drain before it, two
    # frames stale, as in the JAX runner.
    fetch_lag = 2

    def add_frame(self, left, right, frame_id: int, timestamp: float = 0.0,
                  exposure: float = 1.0):
        s = self.settings
        state, bundle = frame_auto(
            self.state, device_image(left, self.device), device_image(right, self.device),
            self.calib.c, self.calib.baseline, float(exposure),
            settings=s, n_levels=self.calib.n_levels, n_tries=5,
            pot=self.pot, caps=self.caps,
            w0=self.calib.w[0], h0=self.calib.h[0],
            imm_cap=s.immature_cap, uniform=self.uniform,
        )
        self.state = state
        self._pending_q.append((bundle, frame_id, timestamp, host.Fetch(bundle)))
        drained = None
        while len(self._pending_q) > self.fetch_lag:
            drained = self._drain_one()
        return drained

    def _drain_one(self):
        _, frame_id, timestamp, fetch = self._pending_q.pop(0)
        b = FrameBundle(*fetch.get())  # one wait, for that frame's copy
        ref_kf_id = len(self.kf_shells) - 1
        self.apply_bundle(b, frame_id, timestamp, ref_kf_id)
        return b

    def flush(self):
        """Drain all pending frame results into the host bookkeeping."""
        while self._pending_q:
            self._drain_one()

    def apply_bundle(self, b, frame_id: int, timestamp: float, ref_kf_id: int):
        """Host bookkeeping from a fetched FrameBundle (numpy leaves)."""
        s = self.settings
        shell = GraphShell(
            frame_id, timestamp, np.linalg.inv(np.asarray(b.T, np.float64)),
            ref_kf_id, np.asarray(b.aff, np.float64),
        )
        self.history.append(shell)

        if bool(b.need_kf):
            shell.is_kf = True
            self.n_frame_marginalizations += int(np.sum(b.flagged))
            self.slot_frame_id = {
                int(s_): int(f_)
                for s_, f_ in enumerate(np.asarray(b.frame_id))
                if bool(np.asarray(b.frame_valid)[s_])
            }
            self.kf_shells.append(shell)
            # refresh all in-window KF poses from the BA result
            w2c = np.asarray(b.w2c, np.float64)
            aff_all = np.asarray(b.aff_all, np.float64)
            for s_, f_ in self.slot_frame_id.items():
                self.kf_shells[f_].T_cw = np.linalg.inv(w2c[s_])
                self.kf_shells[f_].aff = aff_all[s_]
            # selector potential adaptation (stale-by-one, PixelSelector2)
            num_have = float(b.sel_num)
            quotia = s.desired_immature_density / max(num_have, 1.0)
            K = num_have * (self.pot + 1) ** 2
            ideal = max(int(np.sqrt(K / s.desired_immature_density) - 1), 1)
            if quotia > 1.25 and self.pot > 1:
                self.pot = SEL.snap_pot(max(min(ideal, self.pot - 1), 1))
            elif quotia < 0.25:
                self.pot = SEL.snap_pot(max(ideal, self.pot + 1))
            else:
                self.pot = SEL.snap_pot(max(ideal, 1))
            if not np.isfinite(float(b.energy)) or int(b.nres) == 0:
                # non-finite BA energy, or a window with zero surviving
                # residuals: the map is dead; surface it like tracking loss
                self.is_lost = True
        return b

    # -- host helpers --------------------------------------------------
    def slot_frame_id_of_ref(self):
        # the tracking reference is always the newest keyframe
        return len(self.kf_shells) - 1

    def _shell_T_cw(self, shell: GraphShell):
        if shell.is_kf and shell.T_cw is not None:
            return shell.T_cw
        if shell.ref_kf_id < 0:
            return shell.T_cam_to_ref
        return self.kf_shells[shell.ref_kf_id].T_cw @ shell.T_cam_to_ref

    def trajectory(self):
        self.flush()
        return [self._shell_T_cw(sh) for sh in self.history]

    def point_cloud(self):
        """Window point cloud for a viewer feed (KeyFrameDisplay.cpp:102-173)."""
        self.flush()
        return window_point_cloud(self.state.win, self.calib, self.slot_frame_id)
