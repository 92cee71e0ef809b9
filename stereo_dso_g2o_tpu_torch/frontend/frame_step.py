"""Per-frame programs: tracking cascade, depth refinement, keyframe tail.

Port of `stereo_dso_g2o_tpu/frontend/frame_step.py`. The JAX package fuses
each of these into one jitted program; here they are plain functions that
launch torch ops (and the epipolar kernel) eagerly, and on the card the
track half also runs captured as one program (`runtime/program.py`). Pose
hypotheses are a batch dimension (the JAX `vmap`); the retry ladder's
`lax.cond` and the tracker's `lax.while_loop` are `utils/loop.cond` and
`while_loop`: host branches and loops eagerly, IF and WHILE nodes in a
captured program.

The non-keyframe step (`frame_step_full`) runs N sequences at once, as the
JAX package's batched frame program vmaps it: every operand leads with the
sequence axis, the hypotheses of all sequences run as one (N, K) batch of
rows, each sequence's winner is picked on the device, and one sequence is
the batch of one. The keyframe steps (`kf_trace_step`, `kf_finalize`,
`tracking_ref_inputs`) take the same leading axis, with slots (N,).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from stereo_dso_g2o_tpu_torch.backend import ba, builder
from stereo_dso_g2o_tpu_torch.backend import window as W
from stereo_dso_g2o_tpu_torch.config import Settings, default_settings
from stereo_dso_g2o_tpu_torch.frontend import immature as IMM
from stereo_dso_g2o_tpu_torch.frontend.coarse_tracker import MAX_ITERATIONS, k_levels
from stereo_dso_g2o_tpu_torch.models.camera import calib_from_c
from stereo_dso_g2o_tpu_torch.ops import trace as trace_ops
from stereo_dso_g2o_tpu_torch.ops import tracker_ops
from stereo_dso_g2o_tpu_torch.ops.pyramid import build_pyramid
from stereo_dso_g2o_tpu_torch.utils import loop
from stereo_dso_g2o_tpu_torch.utils.smalls import matmul_fma
from stereo_dso_g2o_tpu_torch.utils.tree import at_index, at_rows, first, lead_one, per_row


class TrackOut(NamedTuple):
    T: torch.Tensor  # (4,4) refToNew (or (B,4,4) for a hypothesis batch)
    aff: torch.Tensor  # (2,)
    residuals: torch.Tensor  # (L,)
    flow: torch.Tensor  # (3,)
    ok: torch.Tensor  # () bool
    sat_frac0: torch.Tensor  # () saturation fraction at the finest level


class CascadeCarry(NamedTuple):
    """Running state of the per-level LM cascade for a batch of hypothesis
    rows: (B,) for one sequence, (N, K) for K hypotheses of N sequences."""

    T: torch.Tensor  # (B,4,4)
    aff: torch.Tensor  # (B,2)
    ok: torch.Tensor  # (B,)
    residuals: torch.Tensor  # (B,L) per-level res (nan where not run)
    flow: torch.Tensor  # (B,3)
    sat0: torch.Tensor  # (B,)
    sat_last: torch.Tensor  # (B,)
    have_repeated: torch.Tensor  # (B,)


def _cascade_init(T_init, aff_init, n_levels: int) -> CascadeCarry:
    """T_init (B, 4, 4) with aff_init (2,), or (N, K, 4, 4) with (N, 2)."""
    rows = tuple(T_init.shape[:-2])
    dev = T_init.device
    flow = torch.full(rows + (3,), 100.0, device=dev)
    flow[..., 1].fill_(0.0)
    return CascadeCarry(
        T=T_init.to(torch.float32),
        aff=aff_init.to(torch.float32)[..., None, :].expand(rows + (2,)).clone(),
        ok=torch.ones(rows, dtype=torch.bool, device=dev),
        residuals=torch.full(rows + (n_levels,), float("nan"), device=dev),
        flow=flow,
        sat0=torch.zeros(rows, device=dev),
        sat_last=torch.zeros(rows, device=dev),
        have_repeated=torch.zeros(rows, dtype=torch.bool, device=dev),
    )


def _cascade_levels(carry: CascadeCarry, ref, dI_new_pyr, Ks, levels, ref_aff,
                    ref_exposure, new_exposure, min_res_for_abort,
                    settings: Settings) -> CascadeCarry:
    """Run the per-level LM cascade over `levels` (descending). For N
    sequences every operand leads with N (`tracker_ops.lm_level`)."""
    T, aff, ok = carry.T, carry.aff, carry.ok
    residuals, flow = carry.residuals.clone(), carry.flow
    sat0, sat_last = carry.sat0, carry.sat_last
    have_repeated = carry.have_repeated
    for lvl in levels:
        pc_u, pc_v, pc_id, pc_color, pc_ok = ref[lvl]
        out = tracker_ops.lm_level(
            pc_u, pc_v, pc_id, pc_color, pc_ok, dI_new_pyr[lvl], Ks[lvl],
            T, aff, ref_aff, ref_exposure, new_exposure, have_repeated,
            settings=settings,
            max_iterations=MAX_ITERATIONS[min(lvl, len(MAX_ITERATIONS) - 1)],
        )
        have_repeated = have_repeated | out.repeated
        res = out.res_per_point
        lvl_ok = torch.isfinite(res) & (res <= 1.5 * min_res_for_abort[lvl])
        if lvl <= 2:
            # coverage guard (fine levels only): a diverged hypothesis that
            # throws (nearly) all reference points out of view must not win
            n_ref = torch.sum(pc_ok, dim=-1).to(torch.float32)[..., None]
            enough = (out.num_terms >= 10) & (out.num_terms >= 0.25 * n_ref)
            lvl_ok = lvl_ok & enough
        take = ok & lvl_ok
        T = torch.where(take[..., None, None], out.T, T)
        aff = torch.where(take[..., None], out.aff, aff)
        residuals[..., lvl] = torch.where(ok, res, torch.full_like(res, float("nan")))
        sat_last = torch.where(ok, out.sat_frac, sat_last)
        if lvl == 0:
            f = torch.stack([out.flow_t, torch.zeros_like(out.flow_t), out.flow_rt], -1)
            flow = torch.where(ok[..., None], f, flow)
            sat0 = out.sat_frac
        ok = ok & lvl_ok
    return CascadeCarry(
        T=T, aff=aff, ok=ok, residuals=residuals, flow=flow, sat0=sat0,
        sat_last=sat_last, have_repeated=have_repeated,
    )


def _cascade_finalize(carry: CascadeCarry, settings: Settings) -> TrackOut:
    """Affine sanity gates (trackNewestCoarse :1075-1095); batched TrackOut."""
    s = settings
    aff, ok = carry.aff, carry.ok
    a_bad = (s.affine_opt_mode_a != 0) & (torch.abs(aff[..., 0]) > 1.2)
    b_bad = (s.affine_opt_mode_b != 0) & (torch.abs(aff[..., 1]) > 200.0)
    return TrackOut(
        T=carry.T, aff=aff, residuals=carry.residuals, flow=carry.flow,
        ok=ok & ~a_bad & ~b_bad, sat_frac0=carry.sat0,
    )


def _squeeze(t: TrackOut) -> TrackOut:
    return TrackOut(*[x[0] for x in t])


def _squeeze_rows(t: TrackOut) -> TrackOut:
    """N sequences' one-row TrackOut (N, 1, ...) as (N, ...)."""
    return TrackOut(*[x[:, 0] for x in t])


def track_cascade(ref, dI_new_pyr, calib, T_init, aff_init, ref_aff, ref_exposure,
                  new_exposure, min_res_for_abort, settings: Settings) -> TrackOut:
    """trackNewestCoarse for a batch of B hypotheses T_init (B,4,4) (or
    (N, K, 4, 4) for N sequences); returns a batched TrackOut."""
    n_levels = calib.n_levels
    carry = _cascade_init(T_init, aff_init, n_levels)
    carry = _cascade_levels(
        carry, ref, dI_new_pyr, k_levels(calib), range(n_levels - 1, -1, -1),
        ref_aff, ref_exposure, new_exposure, min_res_for_abort, settings,
    )
    return _cascade_finalize(carry, settings)


def cascade_step(dIpL, ref, calib_c, baseline, T_init, aff_init, ref_aff, ref_exposure,
                 new_exposure, min_res_for_abort, settings: Settings = default_settings(),
                 n_levels: int = 6) -> TrackOut:
    """Tracking cascade only, one hypothesis T_init (4,4) on pyramids already
    built (dIpL: per-level (H_l, W_l, 3)); the Calib is made from calib_c,
    the baseline and the level-0 shape."""
    calib = calib_from_c(calib_c, baseline, dIpL[0].shape[1], dIpL[0].shape[0], n_levels)
    return _squeeze(track_cascade(
        ref, dIpL, calib, T_init[None], aff_init, ref_aff, ref_exposure, new_exposure,
        min_res_for_abort, settings,
    ))


def _pyramids(left, right, n_levels):
    dIpL, _ = build_pyramid(left.to(torch.float32), n_levels)
    dIpR, _ = build_pyramid(right.to(torch.float32), n_levels)
    return dIpL, dIpR


def _at_slot(x, slot):
    """x[slot] of one sequence's per-slot array; x[n, slot[n]] of N
    sequences' (slot (N,), a device gather)."""
    if isinstance(slot, torch.Tensor) and slot.dim() == 1:
        return at_rows(x, slot.long())
    return at_index(x, slot)


def _host_transforms(win, T_new, calib):
    """Per host slot: KRKi, Kt, R, t (host -> new frame) and the affine
    transfer inputs (with a leading N for N sequences)."""
    w2c = win.w2c()
    K = calib.K(0)
    Ki = calib.Ki(0)
    many = w2c.dim() == 4
    # products of one matrix per sequence: one call per sequence
    # (utils/tree.per_row), as one sequence alone makes it
    # inv_ex: the values of inv, without the error check that waits for the device
    T_hn = per_row(lambda a, b: torch.einsum("ij,fjk->fik", a, b), many,
                   T_new, torch.linalg.inv_ex(w2c).inverse)
    R_hn = T_hn[..., :3, :3]
    t_hn = T_hn[..., :3, 3]
    KRKi = per_row(lambda k, r, ki: torch.einsum("ij,fjk,kl->fil", k, r, ki), many, K, R_hn, Ki)
    Kt = per_row(lambda k, t: torch.einsum("ij,fj->fi", k, t), many, K, t_hn)
    return K, KRKi, Kt, R_hn, t_hn


def _aff_host_to_new(win, aff_new, new_exposure):
    aff_host = win.aff_g2l()
    a_rel = (
        torch.exp(aff_new[..., 0, None] - aff_host[..., 0])
        * torch.as_tensor(new_exposure)[..., None]
        / torch.clamp(win.ab_exposure, min=1e-9)
    )
    b_rel = aff_new[..., 1, None] - a_rel * aff_host[..., 1]
    return torch.stack([a_rel, b_rel], dim=-1)


def _nonkey_refine(win, imm, dI_left0, dI_right0, calib, T_ref_new, aff_new,
                   new_exposure, ref_slot, baseline, settings):
    """makeNonKeyFrame's depth refinement: per-host transforms to the new
    frame from window state + the tracked relative pose (one sequence, or N
    with per-sequence (N,) slots)."""
    T_new = matmul_fma(T_ref_new, _at_slot(win.w2c(), ref_slot))
    K, KRKi, Kt, R_hn, t_hn = _host_transforms(win, T_new, calib)
    aff_ht = _aff_host_to_new(win, aff_new, new_exposure)
    return IMM.trace_on_nonkey(
        imm, KRKi, Kt, R_hn, t_hn, aff_ht, dI_left0, dI_right0, K, baseline,
        win.frame_valid, settings=settings,
    )


def frame_step(left, right, ref, win, imm, calib_c, baseline, ref_slot: int,
               T_init, aff_init, ref_aff, ref_exposure, new_exposure,
               min_res_for_abort, settings: Settings = default_settings(),
               n_levels: int = 6, is_kf: bool = False):
    """Pyramids + one-hypothesis tracking cascade (+ for non-keyframes, the
    depth refinement). Returns ((dIpL, dIpR), imm', TrackOut)."""
    calib = calib_from_c(calib_c, baseline, left.shape[1], left.shape[0], n_levels)
    dIpL, dIpR = _pyramids(left, right, n_levels)
    track = _squeeze(track_cascade(
        ref, dIpL, calib, T_init[None], aff_init, ref_aff, ref_exposure,
        new_exposure, min_res_for_abort, settings,
    ))
    if not is_kf:
        imm = _nonkey_refine(
            win, imm, dIpL[0], dIpR[0], calib, track.T, track.aff,
            new_exposure, ref_slot, baseline, settings,
        )
    return (dIpL, dIpR), imm, track


def nonkey_refine_step(win, imm, dI_left0, dI_right0, calib_c, baseline, ref_slot: int,
                       T_ref_new, aff_new, new_exposure,
                       settings: Settings = default_settings(), n_levels: int = 6):
    """Standalone non-keyframe depth refinement."""
    calib = calib_from_c(calib_c, baseline, dI_left0.shape[1], dI_left0.shape[0], n_levels)
    return _nonkey_refine(
        win, imm, dI_left0, dI_right0, calib, T_ref_new, aff_new,
        new_exposure, ref_slot, baseline, settings,
    )


def tracking_ref_inputs(win, dI_new0, dI_right0, calib_c, baseline, newest_slot,
                        settings: Settings = default_settings(), n_levels: int = 6):
    """makeCoarseDepthL0 STEP1: per active point with an IN residual to the
    newest KF, take its projected center, re-verify its inverse depth by
    L->R / R->L static stereo, and emit (u, v, idepth, weight, valid). N
    stacked sequences: images (N, H, W, 3), newest_slot (N,), one K1 launch
    per direction for all of them."""
    Hd, Wd = dI_new0.shape[-3:-1]
    calib = calib_from_c(calib_c, baseline, Wd, Hd, n_levels)
    s = settings
    dev = dI_new0.device
    lead = tuple(win.frame_valid.shape[:-1])

    active = win.pt_status == W.PT_ACTIVE
    res_in = ba._at_col(win.res_exists, newest_slot) & (
        ba._at_col(win.res_state, newest_slot) == W.RES_IN)
    sel = active & res_in
    center = torch.stack([ba._at_col(win.res_center[..., k], newest_slot) for k in range(3)], -1)
    us = torch.round(center[..., 0])
    vs = torch.round(center[..., 1])
    ids = center[..., 2]

    n = us.shape[-1]
    usj = torch.clamp(us, 8.0, Wd - 9.0)
    vsj = torch.clamp(vs, 8.0, Hd - 9.0)
    color, weights_p, gradH, eth = trace_ops.extract_point_data(dI_new0, usj, vsj, s)
    K0 = calib.K(0)
    fresh_q = torch.full(lead + (n,), 10000.0, device=dev)
    fresh_st = torch.full(lead + (n,), trace_ops.IPS_UNINITIALIZED, dtype=torch.int32, device=dev)
    res_lr, idepth_stereo = trace_ops.trace_stereo(
        usj, vsj, ids * 0.1, ids * 1.9, color, weights_p, gradH, eth,
        fresh_q, fresh_st, K0, baseline, dI_right0, mode_right=True, settings=s,
    )
    lr_good = res_lr.status == trace_ops.IPS_GOOD
    u_r = torch.clamp(res_lr.last_uv[..., 0], 8.0, Wd - 9.0)
    v_r = torch.clamp(res_lr.last_uv[..., 1], 8.0, Hd - 9.0)
    color_r, weights_r, gradH_r, eth_r = trace_ops.extract_point_data(dI_right0, u_r, v_r, s)
    res_rl, _ = trace_ops.trace_stereo(
        u_r, v_r, ids * 0.1, ids * 1.9, color_r, weights_r, gradH_r, eth_r,
        fresh_q.clone(), fresh_st, K0, baseline, dI_new0, mode_right=False, settings=s,
    )
    u_delta = torch.abs(us - res_rl.last_uv[..., 0])
    depth = 1.0 / torch.where(idepth_stereo != 0, idepth_stereo, torch.full_like(idepth_stereo, float("inf")))
    stereo_ok = (
        lr_good & (u_delta < s.stereo_u_delta_max) & (depth > 0) & (depth < s.stereo_depth_max)
    )
    new_id = torch.where(stereo_ok, idepth_stereo, ids)
    hdif = 1.0 / torch.clamp(win.pt_idepth_hessian, min=1e-12)
    weight = torch.sqrt(1e-3 / (hdif + 1e-12))
    return us, vs, new_id, weight, sel


def cascade_batch(dIpL, ref, calib_c, baseline, T_inits, aff_init, ref_aff,
                  ref_exposure, new_exposure, min_res_for_abort,
                  settings: Settings = default_settings(), n_levels: int = 6) -> TrackOut:
    """All remaining retry-ladder hypotheses (K,4,4) as one batch; returns a
    batched TrackOut (selection happens on the host)."""
    calib = calib_from_c(calib_c, baseline, dIpL[0].shape[1], dIpL[0].shape[0], n_levels)
    return track_cascade(
        ref, dIpL, calib, T_inits, aff_init, ref_aff, ref_exposure, new_exposure,
        min_res_for_abort, settings,
    )


def _pick(nt, j):
    """Row j[n] of sequence n of an (N, K, ...) NamedTuple: (N, ...)."""
    return type(nt)(*[at_rows(x, j) for x in nt])


def _sequential_select(tb: TrackOut, last_rmse0, settings: Settings, n_tries: int) -> TrackOut:
    """The reference's hypothesis selection replayed over a pre-computed
    batch (N sequences' (N, K) rows, on the device): ladder order, strict
    improvement, stop at the accept gate."""
    res_all = tb.residuals[..., 0]
    ok_all = tb.ok & torch.isfinite(res_all)
    thr = last_rmse0 * settings.re_track_threshold
    achieved = torch.full_like(thr, float("inf"))
    best_k = torch.full(thr.shape, -1, dtype=torch.int64, device=thr.device)
    stopped = torch.zeros(thr.shape, dtype=torch.bool, device=thr.device)
    for k in range(n_tries):
        take = ~stopped & ok_all[:, k] & (res_all[:, k] < achieved)
        best_k = torch.where(take, torch.full_like(best_k, k), best_k)
        achieved = torch.where(take, res_all[:, k], achieved)
        stopped = stopped | ((best_k >= 0) & (achieved < thr))
    sel = _pick(tb, torch.clamp(best_k, min=0))
    return sel._replace(ok=best_k >= 0)


def _best_of(res_all, ok_all, good0):
    """Best-of with try-0 preference over one sequence's K hypotheses: the
    winner's index as a () device tensor (no host read). Try 0 wins unless
    another ok hypothesis has a strictly lower residual; ties go to the
    lowest index."""
    inf = torch.full_like(res_all, float("inf"))
    best0 = torch.where(good0, res_all[0], inf[0])
    cand = torch.cat([inf[:1], torch.where(ok_all, res_all, inf)[1:]])
    jbest = torch.argmin(cand)
    # cand's least value, cand[jbest] (an index by a tensor would read it on the host)
    return torch.where(torch.amin(cand) < best0, jbest, torch.zeros_like(jbest))


def _winners(res_all, ok_all, good0):
    """(N,) winners of N sequences' (N, K) hypotheses: `_best_of` on each
    sequence's row, so that every sequence's selection is its own call."""
    # as_tensor: the device tensor `_best_of` returns as it is (no copy)
    return torch.stack([
        torch.as_tensor(_best_of(res_all[n], ok_all[n], good0[n]), device=res_all.device)
        for n in range(res_all.shape[0])
    ])


def _best_select(tb: TrackOut, settings: Settings) -> TrackOut:
    """Best-of-residual selection with try-0 preference, per sequence."""
    res_all = tb.residuals[..., 0]
    ok_all = tb.ok & torch.isfinite(res_all)
    good0 = ok_all[:, 0] & (tb.sat_frac0[:, 0] <= 0.6)
    k = _winners(res_all, ok_all, good0)
    track = _pick(tb, k)
    return track._replace(ok=torch.where(k == 0, good0, at_rows(ok_all, k)))


def _select(tb: TrackOut, last_rmse0, settings: Settings, n_tries: int) -> TrackOut:
    if settings.hypothesis_selection == "best":
        return _best_select(tb, settings)
    return _sequential_select(tb, last_rmse0, settings, n_tries)


def _coarse_select(cb: CascadeCarry, k: int) -> CascadeCarry:
    """Winner over N sequences' coarse cascade carries (N, K) keyed on the
    level-k residual (best-of with try-0 preference), on the device;
    returns the winners' (N, 1) carry."""
    res_all = cb.residuals[..., k]
    ok_all = cb.ok & torch.isfinite(res_all)
    good0 = ok_all[:, 0] & (cb.sat_last[:, 0] <= 0.6)
    j = _winners(res_all, ok_all, good0)
    sel = CascadeCarry(*[at_rows(x, j)[:, None] for x in cb])
    return sel._replace(ok=torch.where(j == 0, good0, at_rows(ok_all, j))[:, None])


def frame_step_full(left, right, ref, win, imm, calib_c, baseline, ref_slot,
                    T_tries, aff_init, ref_aff, ref_exposure, new_exposure, last_rmse0,
                    settings: Settings = default_settings(), n_levels: int = 6,
                    n_tries: int = 5):
    """The complete non-keyframe step including the retry ladder:
    pyramids -> hypotheses -> selection -> speculative depth refinement at
    the selected pose. Returns ((dIpL, dIpR), imm', TrackOut, used_ladder).

    For N sequences (the JAX package's vmap): images (N, H, W), `ref`,
    `win` and `imm` stacked over N, calib_c (N, 4), baseline (N,),
    ref_slot (N,), T_tries (N, K, 4, 4), aff_init and ref_aff (N, 2),
    exposures and last_rmse0 (N,); every output leads with N. One sequence
    (images (H, W)) runs as the batch of one."""
    if left.dim() == 2:
        dev = left.device
        (dIpL, dIpR), imm_out, track, used = frame_step_full(
            left[None], right[None], lead_one(tuple(ref)), lead_one(win), lead_one(imm),
            calib_c[None], torch.as_tensor(baseline, device=dev)[None],
            torch.as_tensor(ref_slot, device=dev)[None], T_tries[None], aff_init[None],
            ref_aff[None], torch.as_tensor(ref_exposure, device=dev)[None],
            torch.as_tensor(new_exposure, device=dev)[None],
            torch.as_tensor(last_rmse0, device=dev)[None],
            settings=settings, n_levels=n_levels, n_tries=n_tries,
        )
        return first((dIpL, dIpR)), first(imm_out), first(track), used[0]
    N, H, Wd = left.shape
    dev = left.device
    calib = calib_from_c(calib_c, baseline, Wd, H, n_levels)
    dIpL, dIpR = _pyramids(left, right, n_levels)
    abort_inf = torch.full((n_levels,), float("inf"), device=dev)
    Ks = k_levels(calib)

    def tries(Ts):
        return track_cascade(
            ref, dIpL, calib, Ts, aff_init, ref_aff, ref_exposure, new_exposure,
            abort_inf, settings,
        )

    if settings.always_retry_ladder:
        kf_ = settings.ladder_fine_levels
        if kf_ > 0:
            # split ladder: every hypothesis runs only the coarse levels, the
            # winner on the level-kf_ residual descends the fine levels. This
            # path ignores hypothesis_selection, as the JAX package does.
            carry = _cascade_init(T_tries, aff_init, n_levels)
            cb = _cascade_levels(
                carry, ref, dIpL, Ks, range(n_levels - 1, kf_ - 1, -1),
                ref_aff, ref_exposure, new_exposure, abort_inf, settings,
            )
            sel = _coarse_select(cb, kf_)
            fine = _cascade_levels(
                sel, ref, dIpL, Ks, range(kf_ - 1, -1, -1), ref_aff,
                ref_exposure, new_exposure, abort_inf, settings,
            )
            track = _squeeze_rows(_cascade_finalize(fine, settings))
        else:
            track = _select(tries(T_tries), last_rmse0, settings, n_tries)
        need_ladder = torch.ones(N, dtype=torch.bool, device=dev)
    else:
        # try 0 alone; the other hypotheses (the JAX lax.cond, which vmap
        # turns into a select) run when some sequence needs them: a host
        # branch eagerly, an IF node in a captured program (utils/loop.cond)
        t0 = _squeeze_rows(tries(T_tries[:, :1]))
        res0 = t0.residuals[..., 0]
        good0 = t0.ok & torch.isfinite(res0) & (t0.sat_frac0 <= 0.6)
        need_ladder = ~(good0 & (res0 < last_rmse0 * settings.re_track_threshold))

        def ladder():
            tb = tries(T_tries[:, 1:])
            full = TrackOut(*[torch.cat([a[:, None], b], 1) for a, b in zip(t0, tb)])
            sel = _select(full, last_rmse0, settings, n_tries)
            return TrackOut(*[tracker_ops._bsel(need_ladder, a, b) for a, b in zip(sel, t0)])

        track = loop.cond(need_ladder.any(), ladder, t0, name="track.ladder")

    imm_out = _nonkey_refine(
        win, imm, dIpL[0], dIpR[0], calib, track.T, track.aff,
        new_exposure, ref_slot, baseline, settings,
    )
    return (dIpL, dIpR), imm_out, track, need_ladder


def kf_finalize(win, dI_stack, dI_new0, dI_right0, slot, frames_to_marg,
                prev_slot, calib_c, baseline,
                settings: Settings = default_settings(), n_levels: int = 6):
    """Post-BA keyframe tail (makeKeyFrame STEP7-11): re-linearize the newest
    KF at its optimized pose, final linearization + outlier removal +
    adaptive energy threshold, tracking-reference inputs, point flagging,
    and point marginalization into HM/bM. N stacked sequences: slots (N,),
    frames_to_marg (N, F)."""
    win = builder.set_frame_eval_pt(win, slot)
    win, energy = ba.linearize_all_final(win, dI_stack, slot, settings=settings)
    nres_pt = torch.sum(win.res_exists, dim=-1)
    win = win.replace(
        pt_status=torch.where(
            (win.pt_status == W.PT_ACTIVE) & (nres_pt == 0),
            torch.full_like(win.pt_status, W.PT_INACTIVE), win.pt_status,
        )
    )
    ref_inputs = tracking_ref_inputs(
        win, dI_new0, dI_right0, calib_c, baseline, slot, settings=settings, n_levels=n_levels,
    )
    win = ba.flag_points_for_removal(
        win, dI_stack, frames_to_marg, slot, prev_slot, settings=settings
    )
    n_marg = torch.sum(win.pt_status == W.PT_MARGINALIZE, dim=-1).to(torch.int32)
    n_drop = torch.sum(win.pt_status == W.PT_DROP, dim=-1).to(torch.int32)
    gone = (win.pt_status == W.PT_MARGINALIZE) | (win.pt_status == W.PT_DROP)
    win = ba.marginalize_points(win, settings=settings)
    return win, ref_inputs, gone, win.w2c(), win.aff_g2l(), energy, (n_marg, n_drop)


def kf_trace_step(win, imm, dI_new0, calib_c, baseline, T_new_w2c, aff_new, new_exposure,
                  settings: Settings = default_settings(), n_levels: int = 6):
    """makeKeyFrame STEP 1 (traceNewCoarseKey): temporal-trace every
    keyframe's immature points onto the incoming keyframe (N stacked
    sequences: one K1 launch for all)."""
    Hd, Wd = dI_new0.shape[-3:-1]
    calib = calib_from_c(calib_c, baseline, Wd, Hd, n_levels)
    _, KRKi, Kt, _, _ = _host_transforms(win, T_new_w2c, calib)
    aff_ht = _aff_host_to_new(win, aff_new, new_exposure)
    return IMM.trace_on_frame(imm, KRKi, Kt, aff_ht, dI_new0, win.frame_valid, settings=settings)
