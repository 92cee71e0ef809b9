"""Immature point management: creation, tracing across frames, activation.

Port of `stereo_dso_g2o_tpu/frontend/immature.py` (the ImmaturePoint
lifecycle: makeNewTraces, traceNewCoarseKey, traceNewCoarseNonKey,
activatePointsMT + optimizeImmaturePoint). Immature points live in a
fixed-capacity [F, CAP] structure of arrays per keyframe slot; traces run
on a compacted pool of live rows (`settings.trace_cap` lanes).

Every function also runs N sequences at once, as the JAX package's
batched frame program vmaps it: the sets and windows stacked over N
((N, F, CAP)), slots (N,), the pools and compactions per sequence row,
every size the same for all rows.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from stereo_dso_g2o_tpu_torch.backend import window as W
from stereo_dso_g2o_tpu_torch.config import PATTERN, Settings, default_settings
from stereo_dso_g2o_tpu_torch.ops import distance_map as DM
from stereo_dso_g2o_tpu_torch.ops import trace as trace_ops
from stereo_dso_g2o_tpu_torch.ops.interp import take
from stereo_dso_g2o_tpu_torch.ops.residuals import _bilinear3_frames, by_host
from stereo_dso_g2o_tpu_torch.utils.fixed import constant, nonzero_fixed, scatter_drop
from stereo_dso_g2o_tpu_torch.utils.timing import PROF
from stereo_dso_g2o_tpu_torch.utils.tree import at_index, at_rows, per_row, seq_scalar, set_index


@dataclasses.dataclass
class ImmatureSet:
    """[F, CAP] per-keyframe immature point arrays."""

    valid: torch.Tensor  # (F, C) bool
    u: torch.Tensor  # (F, C)
    v: torch.Tensor  # (F, C)
    idepth_min: torch.Tensor  # (F, C)
    idepth_max: torch.Tensor  # (F, C)
    color: torch.Tensor  # (F, C, 8)
    weights: torch.Tensor  # (F, C, 8)
    gradH: torch.Tensor  # (F, C, 2, 2)
    energy_th: torch.Tensor  # (F, C)
    quality: torch.Tensor  # (F, C)
    status: torch.Tensor  # (F, C) int32 (IPS_*)
    my_type: torch.Tensor  # (F, C) int32 (selector level 1/2/4)
    pixel_interval: torch.Tensor  # (F, C)
    last_uv: torch.Tensor  # (F, C, 2)

    def replace(self, **kw) -> "ImmatureSet":
        return dataclasses.replace(self, **kw)


def empty(F: int, cap: int, device) -> ImmatureSet:
    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return ImmatureSet(
        valid=torch.zeros((F, cap), dtype=torch.bool, device=device),
        u=z(F, cap),
        v=z(F, cap),
        idepth_min=z(F, cap),
        idepth_max=torch.full((F, cap), float("nan"), device=device),
        color=z(F, cap, 8),
        weights=z(F, cap, 8),
        gradH=z(F, cap, 2, 2),
        energy_th=z(F, cap),
        quality=torch.full((F, cap), 10000.0, device=device),
        status=torch.full((F, cap), trace_ops.IPS_UNINITIALIZED, dtype=torch.int32, device=device),
        my_type=torch.ones((F, cap), dtype=torch.int32, device=device),
        pixel_interval=z(F, cap),
        last_uv=z(F, cap, 2),
    )


def _set_slot(x, slot, val):
    """x with row `slot` set to val; for N stacked sequences and a (N,)
    slot, row slot[n] of sequence n."""
    out = x.clone()
    if not isinstance(val, torch.Tensor):
        val = constant(val, x.dtype, x.device)
    if isinstance(slot, torch.Tensor) and slot.dim() == 1:
        out[torch.arange(x.shape[0], device=x.device), slot.long()] = val
    else:
        set_index(out, slot, val)
    return out


def seed_slot(imm: ImmatureSet, slot, dI_host, us, vs, types, valid,
              settings: Settings = default_settings()) -> ImmatureSet:
    """makeNewTraces for one keyframe slot: fill its row with freshly
    selected pixels (idepth interval [0, inf), status UNINITIALIZED). N
    stacked sequences: slot (N,), dI_host (N, H, W, 3), points (N, cap)."""
    cap = imm.u.shape[-1]
    assert us.shape[-1] == cap, (us.shape[-1], cap)
    color, weights, gradH, eth = trace_ops.extract_point_data(dI_host, us, vs, settings)
    ok = valid & torch.all(torch.isfinite(color), dim=-1)
    return imm.replace(
        valid=_set_slot(imm.valid, slot, ok),
        u=_set_slot(imm.u, slot, us),
        v=_set_slot(imm.v, slot, vs),
        idepth_min=_set_slot(imm.idepth_min, slot, 0.0),
        idepth_max=_set_slot(imm.idepth_max, slot, float("nan")),
        color=_set_slot(imm.color, slot, color),
        weights=_set_slot(imm.weights, slot, weights),
        gradH=_set_slot(imm.gradH, slot, gradH),
        energy_th=_set_slot(imm.energy_th, slot, eth),
        quality=_set_slot(imm.quality, slot, 10000.0),
        status=_set_slot(imm.status, slot, trace_ops.IPS_UNINITIALIZED),
        my_type=_set_slot(imm.my_type, slot, types),
        pixel_interval=_set_slot(imm.pixel_interval, slot, 0.0),
        last_uv=_set_slot(imm.last_uv, slot, 0.0),
    )


def clear_slot(imm: ImmatureSet, slot: int) -> ImmatureSet:
    return imm.replace(valid=_set_slot(imm.valid, slot, False))


def _rows(x, idx, batched: bool):
    """x[idx] along the lane axis: of one sequence, or of each of N."""
    return at_rows(x, idx) if batched else x[idx]


def _compact_live(imm: ImmatureSet, host_valid, settings: Settings):
    """Gather live immature rows into a fixed (trace_cap,) pool. Returns
    (fields dict incl. `host` and `sel_ok`, scatter index (NC,), -1 for
    unused lanes). A set stacked over N sequences gives (N, NC) pools."""
    lead = tuple(imm.u.shape[:-2])
    F, C = imm.u.shape[-2:]
    NFULL = F * C
    NC = min(NFULL, settings.trace_cap)
    live = (imm.valid & host_valid[..., None]).reshape(lead + (NFULL,))
    idx = nonzero_fixed(live, NC, batched=bool(lead))
    sel_ok = idx >= 0
    safe = torch.clamp(idx, min=0)

    def g(x):
        flat = x.reshape(lead + (NFULL,) + tuple(x.shape[len(lead) + 2:]))
        return _rows(flat, safe, bool(lead))

    fields = dict(
        u=g(imm.u),
        v=g(imm.v),
        idepth_min=g(imm.idepth_min),
        idepth_max=g(imm.idepth_max),
        color=g(imm.color),
        weights=g(imm.weights),
        gradH=g(imm.gradH),
        energy_th=g(imm.energy_th),
        quality=g(imm.quality),
        # unused lanes run frozen (OOB never re-traces)
        status=torch.where(sel_ok, g(imm.status), torch.full_like(g(imm.status), trace_ops.IPS_OOB)),
        host=(safe // C),
        sel_ok=sel_ok,
    )
    return fields, idx


def _scatter_trace(imm: ImmatureSet, idx, traced: trace_ops.TraceResult) -> ImmatureSet:
    """Scatter compact-pool trace results back into the (F, C) arrays
    (unused lanes drop); per sequence row for (N, F, C) sets."""
    lead = tuple(imm.u.shape[:-2])
    F, C = imm.u.shape[-2:]
    NFULL = F * C

    def put(full, vals):
        flat = full.reshape(lead + (NFULL,) + tuple(full.shape[len(lead) + 2:]))
        return scatter_drop(flat, idx, vals, batched=bool(lead)).reshape(full.shape)

    return imm.replace(
        idepth_min=put(imm.idepth_min, traced.idepth_min),
        idepth_max=put(imm.idepth_max, traced.idepth_max),
        quality=put(imm.quality, traced.quality),
        status=put(imm.status, traced.status),
        pixel_interval=put(imm.pixel_interval, traced.pixel_interval),
        last_uv=put(imm.last_uv, traced.last_uv),
    )


def trace_on_frame(imm: ImmatureSet, KRKi, Kt, aff, dI_new, host_valid,
                   settings: Settings = default_settings()) -> ImmatureSet:
    """traceNewCoarseKey: epipolar-trace every keyframe's immature points
    onto a new frame, all hosts' points in one trace_batch call."""
    flat, sel = _compact_live(imm, host_valid, settings)
    h = flat["host"]
    batched = dI_new.dim() == 4
    traced = trace_ops.trace_batch(
        flat["u"], flat["v"], flat["idepth_min"], flat["idepth_max"],
        flat["color"], flat["weights"], flat["gradH"], flat["energy_th"],
        flat["quality"], flat["status"], _rows(KRKi, h, batched), _rows(Kt, h, batched),
        _rows(aff, h, batched), dI_new, settings=settings,
    )
    return _scatter_trace(imm, sel, traced)


class ActivationResult(NamedTuple):
    idepth: torch.Tensor  # (F, C)
    accepted: torch.Tensor  # (F, C)
    dropped: torch.Tensor  # (F, C)
    res_good: torch.Tensor  # (F, C, Ftgt)


def optimize_immature(imm: ImmatureSet, candidate, RTll, tTll, aff_ht, frame_valid,
                      dI_stack, c_value, settings: Settings = default_settings()):
    """optimizeImmaturePoint (legacy 1-dof idepth LM), batched over the
    compacted candidates (settings.activation_batch lanes); per sequence
    for N stacked sequences (c_value (N, 4), dI_stack (N, F, H, W, 3))."""
    lead = tuple(imm.u.shape[:-2])
    bt = bool(lead)
    F, C = imm.u.shape[-2:]
    dev = imm.u.device

    fx, fy, cx, cy = (seq_scalar(c_value[..., i], 2) for i in range(4))  # (lane, pixel)
    fx3, fy3, cx3, cy3 = (seq_scalar(c_value[..., i], 3) for i in range(4))  # (lane, frame, pixel)
    Hd, Wd = dI_stack.shape[-3:-1]
    wM3, hM3 = float(Wd - 3), float(Hd - 3)
    pat = constant(PATTERN, imm.u.dtype, dev)

    NFULL = F * C
    cand_full = (candidate & imm.valid).reshape(lead + (-1,))
    NC = min(NFULL, settings.activation_batch)
    flat_idx = nonzero_fixed(cand_full, NC, batched=bt)
    sel_ok = flat_idx >= 0
    safe = torch.clamp(flat_idx, min=0)

    def lanes(x, tail=()):
        return _rows(x.reshape(lead + (-1,) + tail), safe, bt)

    host = safe // C
    u = lanes(imm.u)
    v = lanes(imm.v)
    color = lanes(imm.color, (8,))
    weights = lanes(imm.weights, (8,))
    eth = lanes(imm.energy_th)
    cand = sel_ok

    Rm = _rows(RTll, host, bt)  # (NC, F, 3, 3)
    t = _rows(tTll, host, bt)  # (NC, F, 3)
    aff = _rows(aff_ht, host, bt)  # (NC, F, 2)
    tgt_ok = (cand[..., None] & frame_valid[..., None, :]
              & (host[..., None] != torch.arange(F, device=dev)))

    id0 = lanes(0.5 * (imm.idepth_min + imm.idepth_max))

    KliP = torch.stack(
        [
            (u[..., None] + pat[:, 0] - cx) / fx,
            (v[..., None] + pat[:, 1] - cy) / fy,
            torch.ones(u.shape + (8,), dtype=u.dtype, device=dev),
        ],
        dim=-1,
    )
    f_idx = torch.arange(F, device=dev)[None, :, None]

    def energy_H_b(idepth, res_oob, outlier_slack=1.0):
        ptp = (
            torch.einsum("...nfij,...npj->...nfpi", Rm, KliP)
            + t[..., None, :] * idepth[..., None, None, None]
        )
        drescale = 1.0 / ptp[..., 2]
        uu = ptp[..., 0] * drescale
        vv = ptp[..., 1] * drescale
        Ku = uu * fx3 + cx3
        Kv = vv * fy3 + cy3
        ok = (drescale > 0) & (Ku > 1.1) & (Kv > 1.1) & (Ku < wM3) & (Kv < hM3)
        oob = ~torch.all(ok, dim=-1) | res_oob

        hit = _bilinear3_frames(dI_stack, f_idx, Ku, Kv)
        r = hit[..., 0] - (aff[..., 0:1] * color[..., None, :] + aff[..., 1:2])
        ar = torch.abs(r)
        hw = torch.where(
            ar < settings.huber_th, torch.ones_like(ar),
            settings.huber_th / torch.clamp(ar, min=1e-12),
        )
        w2 = weights[..., None, :] ** 2
        energy = torch.sum(w2 * hw * r * r * (2.0 - hw), dim=-1)

        dxI = hit[..., 1] * fx3
        dyI = hit[..., 2] * fy3
        d_id = (
            dxI * drescale * (t[..., 0:1] - t[..., 2:3] * uu)
            + dyI * drescale * (t[..., 1:2] - t[..., 2:3] * vv)
        )
        hw2 = hw * w2
        Hdd_t = torch.sum(hw2 * d_id * d_id, dim=-1)
        bd_t = torch.sum(hw2 * r * d_id, dim=-1)

        lim = eth[..., None] * outlier_slack
        outlier = energy > lim
        energy = torch.where(outlier, lim.expand_as(energy), energy)
        state_in = tgt_ok & ~oob & ~outlier
        use = tgt_ok & ~oob
        z = torch.zeros_like(energy)
        Hdd = torch.sum(torch.where(use, Hdd_t, z), dim=-1)
        bd = torch.sum(torch.where(use, bd_t, z), dim=-1)
        E = torch.sum(torch.where(use, energy, z), dim=-1)
        return E, Hdd, bd, oob, state_in

    E, Hdd, bd, oob, state_in = energy_H_b(id0, torch.zeros_like(tgt_ok), outlier_slack=1000.0)

    idepth, E_best, Hc, bc = id0, E, Hdd, bd
    lam = torch.full_like(id0, 0.1)
    oob_c, in_c = oob, state_in
    for _ in range(settings.gn_its_on_point_activation):
        step = -(bc / (Hc * (1.0 + lam) + 1e-10))
        new_id = idepth + step
        E2, H2, b2, oob2, in2 = energy_H_b(new_id, oob_c)
        accept = E2 < E_best
        idepth = torch.where(accept, new_id, idepth)
        E_best = torch.where(accept, E2, E_best)
        Hc = torch.where(accept, H2, Hc)
        bc = torch.where(accept, b2, bc)
        lam = torch.where(accept, lam * 0.5, lam * 5.0)
        oob_c = oob_c | oob2
        in_c = torch.where(accept[..., None], in2, in_c)

    n_good = torch.sum(in_c, dim=-1)
    well_constrained = Hc >= settings.min_idepth_h_act
    finite = torch.isfinite(idepth)
    accepted = cand & finite & well_constrained & (n_good >= 1)
    dropped = cand & (~finite | (well_constrained & (n_good < 1)))

    out_idx = torch.where(sel_ok, safe, torch.full_like(safe, NFULL))

    def full(vals, dtype, tail=()):
        z = torch.zeros(lead + (NFULL,) + tail, dtype=dtype, device=dev)
        return scatter_drop(z, out_idx, vals, batched=bt).reshape(lead + (F, C) + tail)

    return ActivationResult(
        idepth=full(idepth, idepth.dtype),
        accepted=full(accepted, torch.bool),
        dropped=full(dropped, torch.bool),
        res_good=full(in_c, torch.bool, (F,)),
    )


def _not_slot(F, slot, device):
    """(F, 1) bool, False at the slot's row ((N, F, 1) for a (N,) slot)."""
    s = slot if isinstance(slot, torch.Tensor) else constant(slot, torch.int64, device)
    return (torch.arange(F, device=device) != s[..., None])[..., None]


def activation_candidates(imm: ImmatureSet, dist_map, KRKi1, Kt1, host_valid,
                          newest_slot, min_act_dist,
                          settings: Settings = default_settings(), *, h1: int, w1: int):
    """The distance-map candidate gate of activatePointsMT. Returns
    (candidate, delete, iu, iv) with (F, C) masks ((N, F, C) for N stacked
    sequences, dist_map (N, h1, w1))."""
    F, C = imm.u.shape[-2:]
    dev = imm.u.device
    st = imm.status
    bad = ~torch.isfinite(imm.idepth_max) | (st == trace_ops.IPS_OUTLIER)
    can_activate = (
        (
            (st == trace_ops.IPS_GOOD)
            | (st == trace_ops.IPS_SKIPPED)
            | (st == trace_ops.IPS_BADCONDITION)
            | (st == trace_ops.IPS_OOB)
        )
        & (imm.pixel_interval < 8)
        & (imm.quality > settings.min_trace_quality)
        & ((imm.idepth_max + imm.idepth_min) > 0)
    )
    mid = 0.5 * (imm.idepth_max + imm.idepth_min)
    P = torch.stack([imm.u, imm.v, torch.ones_like(imm.u)], -1)
    ptp = torch.einsum("...fij,...fcj->...fci", KRKi1, P) + Kt1[..., None, :] * mid[..., None]
    u1 = ptp[..., 0] / ptp[..., 2]
    v1 = ptp[..., 1] / ptp[..., 2]
    iu = (u1 + 0.5).to(torch.int32)
    iv = (v1 + 0.5).to(torch.int32)
    inb = (iu > 0) & (iv > 0) & (iu < w1) & (iv < h1)

    safe_u = torch.clamp(iu, 0, w1 - 1).long()
    safe_v = torch.clamp(iv, 0, h1 - 1).long()
    dist = (take(dist_map, safe_v, safe_u, dist_map.dim() == 3)
            + (ptp[..., 0] - torch.floor(ptp[..., 0])))
    far_enough = dist >= seq_scalar(min_act_dist, 2) * imm.my_type.to(imm.u.dtype)

    base = imm.valid & host_valid[..., None] & _not_slot(F, newest_slot, dev)
    candidate = base & ~bad & can_activate & inb & far_enough
    delete = base & (
        bad | (can_activate & ~inb) | (~can_activate & (st == trace_ops.IPS_OOB))
    )
    return candidate, delete, iu, iv


def trace_on_nonkey(imm: ImmatureSet, KRKi, Kt, R_new, t_new, aff, dI_new, dI_right,
                    K, baseline, host_valid,
                    settings: Settings = default_settings()) -> ImmatureSet:
    """traceNewCoarseNonKey: temporal epipolar trace onto the new frame,
    then L->R / R->L static-stereo refinement of the GOOD lanes (compacted
    to trace_cap//2), and reprojection of the refined interval back into
    the host. Keeps the reference's acceptance quirk: reject only when
    u_delta > 1 AND disparity < 10. Its six steps are `refine.*` sections
    of the profiler (tools/profile_refine_stages).

    For N sequences: imm stacked (N, F, C), KRKi (N, F, 3, 3), Kt, R_new,
    t_new and aff per sequence and host, images (N, H, W, 3), K (N, 3, 3),
    baseline and host_valid per sequence; every step runs once for all of
    them (three K1 launches in all)."""
    dev = imm.u.device
    batched = dI_new.dim() == 4
    lead = tuple(imm.u.shape[:-2])
    with PROF.section("refine.compact", True):
        flat, sel = _compact_live(imm, host_valid, settings)
        host_of = flat["host"]

    def rows(x, idx):
        return _rows(x, idx, batched)

    with PROF.section("refine.temporal_trace", True):
        traced = trace_ops.trace_batch(
            flat["u"], flat["v"], flat["idepth_min"], flat["idepth_max"],
            flat["color"], flat["weights"], flat["gradH"], flat["energy_th"],
            flat["quality"], flat["status"], rows(KRKi, host_of), rows(Kt, host_of),
            rows(aff, host_of), dI_new, settings=settings,
        )

    with PROF.section("refine.project_extract_new", True):
        good = flat["sel_ok"] & (traced.status == trace_ops.IPS_GOOD)
        Hd, Wd = dI_new.shape[-3:-1]
        n = flat["u"].shape[-1]

        NS = max(min(n, settings.trace_cap // 2), 1)
        gidx = nonzero_fixed(good, NS, batched=batched)
        g_ok = gidx >= 0
        gs_ = torch.clamp(gidx, min=0)
        u2 = torch.clamp(rows(traced.last_uv[..., 0], gs_), 8.0, Wd - 9.0)
        v2 = torch.clamp(rows(traced.last_uv[..., 1], gs_), 8.0, Hd - 9.0)

        ones = torch.ones_like(u2)
        P = torch.stack([rows(flat["u"], gs_), rows(flat["v"], gs_), ones], -1)
        host_g = rows(host_of, gs_)
        KRKi_pt = rows(KRKi, host_g)
        Kt_pt = rows(Kt, host_g)
        ptp_min = torch.einsum(
            "...nij,...nj->...ni", KRKi_pt, P / rows(traced.idepth_min, gs_)[..., None]) + Kt_pt
        id_min_proj = 1.0 / ptp_min[..., 2]
        ptp_max = torch.einsum(
            "...nij,...nj->...ni", KRKi_pt, P / rows(traced.idepth_max, gs_)[..., None]) + Kt_pt
        id_max_proj = 1.0 / ptp_max[..., 2]

        color2, weights2, gradH2, eth2 = trace_ops.extract_point_data(dI_new, u2, v2, settings)
        fresh_q = torch.full(lead + (NS,), 10000.0, device=dev)
        fresh_st = torch.where(
            g_ok,
            torch.full(lead + (NS,), trace_ops.IPS_UNINITIALIZED, dtype=torch.int32, device=dev),
            torch.full(lead + (NS,), trace_ops.IPS_OOB, dtype=torch.int32, device=dev),
        )

    with PROF.section("refine.stereo_lr", True):
        res_lr, _ = trace_ops.trace_stereo(
            u2, v2, id_min_proj, id_max_proj, color2, weights2, gradH2, eth2,
            fresh_q, fresh_st, K, baseline, dI_right, mode_right=True, settings=settings,
        )
        stereo_good = res_lr.status == trace_ops.IPS_GOOD

    with PROF.section("refine.extract_stereo_rl", True):
        u3 = torch.clamp(res_lr.last_uv[..., 0], 8.0, Wd - 9.0)
        v3 = torch.clamp(res_lr.last_uv[..., 1], 8.0, Hd - 9.0)
        color3, weights3, gradH3, eth3 = trace_ops.extract_point_data(dI_right, u3, v3, settings)
        res_rl, _ = trace_ops.trace_stereo(
            u3, v3, id_min_proj, id_max_proj, color3, weights3, gradH3, eth3,
            fresh_q.clone(), fresh_st, K, baseline, dI_new, mode_right=False, settings=settings,
        )

    with PROF.section("refine.reproject_scatter", True):
        u_delta = torch.abs(u2 - res_rl.last_uv[..., 0])
        disparity = u2 - res_lr.last_uv[..., 0]
        reject = stereo_good & (u_delta > 1.0) & (disparity < 10.0)
        accept = stereo_good & ~reject

        Ki = torch.linalg.inv_ex(K).inverse  # inv's values; no check that waits
        P2 = torch.stack([u2, v2, torch.ones_like(u2)], -1)
        # products of one matrix per sequence: one call per sequence
        # (utils/tree.per_row), as one sequence alone makes it
        KiP2 = per_row(lambda a, b: torch.einsum("ij,nj->ni", a, b), batched, Ki, P2)
        KRi = per_row(lambda a, b: torch.einsum("ij,fkj->fik", a, b), batched,
                      K, R_new)  # K @ R^T per host
        KRi_pt = rows(KRi, host_g)
        t_pt = rows(t_new, host_g)

        def backproj(id_stereo):
            pinv = torch.einsum("...nij,...nj->...ni", KRi_pt, KiP2 / id_stereo[..., None] - t_pt)
            return 1.0 / pinv[..., 2]

        id_min_new = backproj(res_lr.idepth_min)
        id_max_new = backproj(res_lr.idepth_max)

        dst = torch.where(g_ok, gidx, torch.full_like(gidx, n))
        zb = torch.zeros(lead + (n,), dtype=torch.bool, device=dev)
        zf = torch.zeros(lead + (n,), dtype=id_min_new.dtype, device=dev)
        upd_n = scatter_drop(zb, dst, accept & g_ok, batched=batched)
        rej_n = scatter_drop(zb, dst, reject & g_ok, batched=batched)
        idmin_n = scatter_drop(zf, dst, id_min_new, batched=batched)
        idmax_n = scatter_drop(zf, dst, id_max_new, batched=batched)

        refined = traced._replace(
            idepth_min=torch.where(upd_n, idmin_n, traced.idepth_min),
            idepth_max=torch.where(upd_n, idmax_n, traced.idepth_max),
            status=torch.where(rej_n, torch.full_like(traced.status, trace_ops.IPS_OUTLIER), traced.status),
        )
        return _scatter_trace(imm, sel, refined)


def insert_activated(win, imm: ImmatureSet, act: ActivationResult,
                     settings: Settings = default_settings(), max_insert: int = 1024):
    """activatePointsMT STEP4: accepted immature points become window points
    in free point slots with residuals to their IN targets; consumed and
    dropped immature slots are invalidated. Returns (win, imm, n_inserted),
    n_inserted a () tensor, (N,) for N stacked sequences.

    Fixed shapes, as the JAX function: `max_insert` lanes pair the accepted
    points with the free slots in index order, and no count is read. Its
    quirk is kept: the JAX function parks the lanes it does not use at
    point slot 0 and writes slot 0's old values back, and lets the last
    write win, so an insertion into a free slot 0 is lost whenever some
    lane is parked (the immature point is still consumed); its lanes
    without a source write "not consumed" to immature index 0 last. Here a
    write that loses goes to `utils/fixed.scatter_drop`'s spare row."""
    lead = tuple(imm.u.shape[:-2])
    bt = bool(lead)
    F, C = imm.u.shape[-2:]
    acc_flat = (act.accepted & imm.valid).reshape(lead + (-1,))
    src = nonzero_fixed(acc_flat, max_insert, batched=bt)
    free = nonzero_fixed(win.pt_status == W.PT_INACTIVE, max_insert, batched=bt)
    ok = (src >= 0) & (free >= 0)
    src_safe = torch.clamp(src, min=0)
    parked = ~ok.all(-1, keepdim=True)
    write = ok & ~((free == 0) & parked)
    dst = torch.where(write, free, torch.full_like(free, -1))

    def put(arr, vals):
        return scatter_drop(arr, dst, vals.to(arr.dtype), batched=bt)

    def const(val, dtype, shape=()):
        return torch.full(tuple(src.shape) + shape, val, dtype=dtype, device=src.device)

    def src_of(x, tail=()):
        flat = x.reshape(lead + (-1,) + tail)
        return at_rows(flat, src_safe) if bt else flat[src_safe]

    win = win.replace(
        pt_status=put(win.pt_status, const(W.PT_ACTIVE, torch.int32)),
        pt_host=put(win.pt_host, (src_safe // C).to(torch.int32)),
        pt_u=put(win.pt_u, src_of(imm.u)),
        pt_v=put(win.pt_v, src_of(imm.v)),
        pt_idepth=put(win.pt_idepth, src_of(act.idepth)),
        pt_idepth_zero=put(win.pt_idepth_zero, src_of(act.idepth)),
        pt_color=put(win.pt_color, src_of(imm.color, (8,))),
        pt_weights=put(win.pt_weights, src_of(imm.weights, (8,))),
        pt_has_prior=put(win.pt_has_prior, const(False, torch.bool)),
        pt_energy_th=put(win.pt_energy_th, src_of(imm.energy_th)),
        pt_num_good_res=put(win.pt_num_good_res, const(0, torch.int32)),
        pt_max_rel_baseline=put(win.pt_max_rel_baseline, const(0.0, torch.float32)),
        pt_idepth_hessian=put(win.pt_idepth_hessian, const(0.0, torch.float32)),
        res_exists=put(win.res_exists, src_of(act.res_good, (F,))),
        res_state=put(win.res_state, const(W.RES_IN, torch.int32, (F,))),
        res_linearized=put(win.res_linearized, const(False, torch.bool, (F,))),
        res_energy=put(win.res_energy, const(0.0, torch.float32, (F,))),
    )
    # consumed: the lanes with a source, each its own index; the JAX
    # function's sourceless lanes then write False at index 0
    none = torch.zeros(lead + (F * C,), dtype=torch.bool, device=src.device)
    inserted = scatter_drop(none, torch.where(src >= 0, src, torch.full_like(src, -1)), ok,
                            batched=bt)
    unused = (src < 0).any(-1, keepdim=True)
    inserted = torch.cat([inserted[..., :1] & ~unused, inserted[..., 1:]], -1)
    gone = inserted.reshape(lead + (F, C)) | act.dropped
    return win, imm.replace(valid=imm.valid & ~gone), ok.sum(-1)


def activation_gate(win, imm: ImmatureSet, newest_slot, min_act_dist, calib_c,
                    settings: Settings = default_settings(), *, h1: int, w1: int):
    """The activation candidate gate: project active points into the newest
    KF at level 1, grow the distance map, apply the candidate rules, and
    suppress same-cell duplicates (activatePointsMT STEP1-2). N stacked
    sequences: newest_slot (N,), min_act_dist (N,), calib_c (N, 4)."""
    fx, fy, cx, cy = calib_c[..., 0], calib_c[..., 1], calib_c[..., 2], calib_c[..., 3]
    zero = torch.zeros_like(fx)
    one = torch.ones_like(fx)
    K1 = torch.stack([
        torch.stack([fx * 0.5, zero, (cx + 0.5) * 0.5 - 0.5], -1),
        torch.stack([zero, fy * 0.5, (cy + 0.5) * 0.5 - 0.5], -1),
        torch.stack([zero, zero, one], -1),
    ], -2)
    Ki0 = torch.stack([
        torch.stack([1.0 / fx, zero, -cx / fx], -1),
        torch.stack([zero, 1.0 / fy, -cy / fy], -1),
        torch.stack([zero, zero, one], -1),
    ], -2)
    w2c = win.w2c()
    slot = newest_slot if isinstance(newest_slot, torch.Tensor) else constant(
        newest_slot, torch.int64, w2c.device)
    w2c_new = at_rows(w2c, slot.long()) if slot.dim() else at_index(w2c, slot)
    # products of one matrix per sequence: one call per sequence
    # (utils/tree.per_row), as one sequence alone makes it
    many = w2c.dim() == 4
    T_hn = per_row(lambda a, b: torch.einsum("ij,fjk->fik", a, b), many,
                   w2c_new, torch.linalg.inv_ex(w2c).inverse)
    KRKi1 = per_row(lambda k, r, ki: torch.einsum("ij,fjk,kl->fil", k, r, ki), many,
                    K1, T_hn[..., :3, :3], Ki0)
    Kt1 = per_row(lambda k, t: torch.einsum("ij,fj->fi", k, t), many, K1, T_hn[..., :3, 3])

    active = win.pt_status == W.PT_ACTIVE
    P = torch.stack([win.pt_u, win.pt_v, torch.ones_like(win.pt_u)], -1)
    ptp = torch.einsum("...nij,...nj->...ni", by_host(KRKi1, win), P) \
        + by_host(Kt1, win) * win.pt_idepth[..., None]
    pu = (ptp[..., 0] / ptp[..., 2] + 0.5).to(torch.int32)
    pv = (ptp[..., 1] / ptp[..., 2] + 0.5).to(torch.int32)
    inb = (pu > 0) & (pv > 0) & (pu < w1) & (pv < h1)
    dmap = DM.distance_map(pu, pv, active & inb, h1, w1, iters=18)

    cand, delete, iu, iv = activation_candidates(
        imm, dmap, KRKi1, Kt1, win.frame_valid, newest_slot, min_act_dist,
        settings=settings, h1=h1, w1=w1,
    )
    cand_flat = DM.suppress_same_cell(
        iu.flatten(-2), iv.flatten(-2), cand.flatten(-2), cell=2
    ).reshape(cand.shape)
    return cand_flat, delete
