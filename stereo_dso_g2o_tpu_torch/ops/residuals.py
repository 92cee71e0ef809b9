"""Batched point-frame residual linearization — the atomic unit of the BA.

Port of `stereo_dso_g2o_tpu/ops/residuals.py` (PointFrameResidual::
linearize over the whole [NP points x F target frames] residual cube):
FEJ geometry Jacobians Jpdxi/Jpdc/Jpdd, Huber-weighted image Jacobians
JIdx, photometric JabF, weighted residuals resF, the OOB/outlier state
machine and the centerProjectedTo side channel. A window stacked over N
sequences (leaves (N, ...), image stacks (N, F, H, W, 3)) runs as one.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from stereo_dso_g2o_tpu_torch.backend import window as W
from stereo_dso_g2o_tpu_torch.utils.fixed import constant
from stereo_dso_g2o_tpu_torch.utils.tree import at_rows, seq_scalar
from stereo_dso_g2o_tpu_torch.config import (
    PATTERN,
    SCALE_C,
    SCALE_F,
    SCALE_IDEPTH,
    Settings,
    default_settings,
)


class LinearizeOut(NamedTuple):
    new_state: torch.Tensor  # (NP, F) int32
    energy: torch.Tensor  # (NP, F)
    energy_wo: torch.Tensor  # (NP, F) -1 if not evaluated
    center: torch.Tensor  # (NP, F, 3)
    resF: torch.Tensor  # (NP, F, 8)
    Jpdxi: torch.Tensor  # (NP, F, 2, 6)
    Jpdc: torch.Tensor  # (NP, F, 2, 4)
    Jpdd: torch.Tensor  # (NP, F, 2)
    JIdx: torch.Tensor  # (NP, F, 2, 8)
    JabF: torch.Tensor  # (NP, F, 2, 8)


def _bilinear3_frames(dI_stack, f_idx, x, y):
    """Bilinear (I, gx, gy) sample from stacked frames (F, H, W, 3); from
    sequence n's frames for row n of (N, ...) coordinates when the stack is
    (N, F, H, W, 3)."""
    H, Wd = dI_stack.shape[-3:-1]
    x = torch.clamp(x, 0.0, Wd - 1.001)
    y = torch.clamp(y, 0.0, H - 1.001)
    xf = torch.floor(x)
    yf = torch.floor(y)
    ix = torch.nan_to_num(xf).long()  # NaN coords sample index 0 and stay NaN
    iy = torch.nan_to_num(yf).long()
    fx = (x - xf)[..., None]
    fy = (y - yf)[..., None]
    fi = f_idx.expand(x.shape).long()
    if dI_stack.dim() == 5:
        n = torch.arange(x.shape[0], device=x.device).reshape((-1,) + (1,) * (x.dim() - 1))

        def at(r, c):
            return dI_stack[n, fi, r, c]
    else:
        def at(r, c):
            return dI_stack[fi, r, c]
    top = (1 - fx) * at(iy, ix) + fx * at(iy, ix + 1)
    bot = (1 - fx) * at(iy + 1, ix) + fx * at(iy + 1, ix + 1)
    return (1 - fy) * top + fy * bot


def by_host(x, win: W.Window):
    """x[pt_host] of a per-host-slot tensor x: one entry per point (of each
    sequence for a stacked window)."""
    h = win.pt_host.long()
    return at_rows(x, h) if h.dim() == 2 else x[h]


def linearize(win: W.Window, dI_stack: torch.Tensor,
              settings: Settings = default_settings()) -> LinearizeOut:
    F = win.F
    NP = win.NP
    lead = tuple(win.frame_valid.shape[:-1])
    Hd, Wd = dI_stack.shape[-3:-1]
    wM3 = float(Wd - 3)
    hM3 = float(Hd - 3)
    dev = win.device

    pre = W.precalc(win)
    tgt = torch.arange(F, device=dev)

    RTll_0 = by_host(pre["RTll_0"], win)  # (NP, F, 3, 3)
    tTll_0 = by_host(pre["tTll_0"], win)
    KRKi = by_host(pre["KRKi"], win)
    Kt = by_host(pre["Kt"], win)
    aff = by_host(pre["aff"], win)  # (NP, F, 2)
    b0 = by_host(pre["b0"], win)  # (NP,)

    # intrinsics over the points (1) and over the (point, frame) pairs (2)
    fx1, fy1, cx1, cy1 = (seq_scalar(win.c_value[..., i], 1) for i in range(4))
    fx, fy, cx, cy = (seq_scalar(win.c_value[..., i], 2) for i in range(4))
    fxi1, fyi1 = 1.0 / fx1, 1.0 / fy1
    fxi = 1.0 / fx
    fyi = 1.0 / fy

    u = win.pt_u
    v = win.pt_v
    id_zero = win.pt_idepth_zero * SCALE_IDEPTH
    id_cur = win.pt_idepth * SCALE_IDEPTH
    color = win.pt_color
    weights = win.pt_weights

    # ---- center projection at the FEJ point ----
    KliP = torch.stack([(u - cx1) * fxi1, (v - cy1) * fyi1, torch.ones_like(u)], -1)
    ptp = torch.einsum("...nfij,...nj->...nfi", RTll_0, KliP) + tTll_0 * id_zero[..., None, None]
    drescale = 1.0 / ptp[..., 2]
    new_idepth = id_zero[..., None] * drescale
    uC = ptp[..., 0] * drescale
    vC = ptp[..., 1] * drescale
    Ku = uC * fx + cx
    Kv = vC * fy + cy
    center_ok = (drescale > 0) & (Ku > 1.1) & (Kv > 1.1) & (Ku < wM3) & (Kv < hM3)
    center = torch.stack([Ku, Kv, new_idepth], -1)

    # ---- geometric Jacobians at FEJ (Residuals.cpp:133-186) ----
    t0x, t0y, t0z = tTll_0[..., 0], tTll_0[..., 1], tTll_0[..., 2]
    d_d_x = drescale * (t0x - t0z * uC) * SCALE_IDEPTH * fx
    d_d_y = drescale * (t0y - t0z * vC) * SCALE_IDEPTH * fy

    R = RTll_0
    dCx2 = drescale * (R[..., 2, 0] * uC - R[..., 0, 0])
    dCx3 = fx * drescale * (R[..., 2, 1] * uC - R[..., 0, 1]) * fyi
    dCx0 = KliP[..., None, 0] * dCx2
    dCx1 = KliP[..., None, 1] * dCx3
    dCy2 = fy * drescale * (R[..., 2, 0] * vC - R[..., 1, 0]) * fxi
    dCy3 = drescale * (R[..., 2, 1] * vC - R[..., 1, 1])
    dCy0 = KliP[..., None, 0] * dCy2
    dCy1 = KliP[..., None, 1] * dCy3

    dCx0 = (dCx0 + uC) * SCALE_F
    dCx1 = dCx1 * SCALE_F
    dCx2 = (dCx2 + 1.0) * SCALE_C
    dCx3 = dCx3 * SCALE_C
    dCy0 = dCy0 * SCALE_F
    dCy1 = (dCy1 + vC) * SCALE_F
    dCy2 = dCy2 * SCALE_C
    dCy3 = (dCy3 + 1.0) * SCALE_C
    Jpdc = torch.stack(
        [
            torch.stack([dCx0, dCx1, dCx2, dCx3], -1),
            torch.stack([dCy0, dCy1, dCy2, dCy3], -1),
        ],
        dim=-2,
    )

    zero = torch.zeros_like(uC)
    Jx = torch.stack(
        [new_idepth * fx, zero, -new_idepth * uC * fx, -uC * vC * fx,
         (1 + uC * uC) * fx, -vC * fx], -1)
    Jy = torch.stack(
        [zero, new_idepth * fy, -new_idepth * vC * fy, -(1 + vC * vC) * fy,
         uC * vC * fy, uC * fy], -1)
    Jpdxi = torch.stack([Jx, Jy], dim=-2)
    Jpdd = torch.stack([d_d_x, d_d_y], -1)

    # ---- pattern residuals at the CURRENT state (Residuals.cpp:213-302) ----
    pat = constant(PATTERN, u.dtype, dev)
    pu = u[..., None] + pat[:, 0]
    pv = v[..., None] + pat[:, 1]
    P3 = torch.stack([pu, pv, torch.ones_like(pu)], -1)  # (NP, 8, 3)
    ptp8 = (
        torch.einsum("...nfij,...npj->...nfpi", KRKi, P3)
        + Kt[..., None, :] * id_cur[..., None, None, None]
    )
    Ku8 = ptp8[..., 0] / ptp8[..., 2]
    Kv8 = ptp8[..., 1] / ptp8[..., 2]
    pat_ok = (Ku8 > 1.1) & (Kv8 > 1.1) & (Ku8 < wM3) & (Kv8 < hM3)
    all_pat_ok = torch.all(pat_ok, dim=-1)

    hit = _bilinear3_frames(dI_stack, tgt[None, :, None], Ku8, Kv8)
    hitI = hit[..., 0]
    gx = hit[..., 1]
    gy = hit[..., 2]

    residual = hitI - (aff[..., 0:1] * color[..., None, :] + aff[..., 1:2])
    drdA = color[..., None, :] - b0[..., None, None]

    g2 = gx * gx + gy * gy
    c2 = settings.outlier_th_sum_component
    w_grad = torch.sqrt(c2 / (c2 + g2))
    w = 0.5 * (w_grad + weights[..., None, :])

    ar = torch.abs(residual)
    hw0 = torch.where(
        ar < settings.huber_th, torch.ones_like(ar),
        settings.huber_th / torch.clamp(ar, min=1e-12),
    )
    energy_terms = w * w * hw0 * residual * residual * (2.0 - hw0)
    energy_left = torch.sum(energy_terms, dim=-1)

    hw = torch.where(hw0 < 1.0, torch.sqrt(hw0), hw0) * w
    resF = residual * hw
    JIdx = torch.stack([gx * hw, gy * hw], dim=-2)
    JabF = torch.stack([drdA * hw, hw], dim=-2)
    if settings.affine_opt_mode_a < 0:
        JabF[..., 0, :] = 0.0
    if settings.affine_opt_mode_b < 0:
        JabF[..., 1, :] = 0.0

    wJI2_sum = torch.sum(hw * hw * (gx * gx + gy * gy), dim=-1)

    # ---- state machine (Residuals.cpp:304-335) ----
    prev_oob = win.res_state == W.RES_OOB
    proj_fail = ~(center_ok & all_pat_ok)

    fe_th = torch.maximum(
        by_host(win.frame_energy_th, win)[..., None], win.frame_energy_th[..., None, :]
    )
    outlier = (energy_left > fe_th) | (wJI2_sum < 2.0)
    energy_new = torch.where(outlier, fe_th, energy_left)

    new_state = torch.full(lead + (NP, F), W.RES_IN, dtype=torch.int32, device=dev)
    new_state = torch.where(outlier, torch.full_like(new_state, W.RES_OUTLIER), new_state)
    new_state = torch.where(proj_fail, torch.full_like(new_state, W.RES_OOB), new_state)
    new_state = torch.where(prev_oob, torch.full_like(new_state, W.RES_OOB), new_state)

    keep_old = prev_oob | proj_fail
    energy_out = torch.where(keep_old, win.res_energy, energy_new)
    energy_wo = torch.where(keep_old, torch.full_like(energy_left, -1.0), energy_left)

    return LinearizeOut(
        new_state=new_state, energy=energy_out, energy_wo=energy_wo,
        center=center, resF=resF, Jpdxi=Jpdxi, Jpdc=Jpdc, Jpdd=Jpdd,
        JIdx=JIdx, JabF=JabF,
    )


def _mask_like(m, new):
    return m.reshape(m.shape + (1,) * (new.ndim - m.ndim))


def apply_res(win: W.Window, lin: LinearizeOut, active_mask) -> W.Window:
    """PointFrameResidual::applyRes(copyJacobians=true): copy Jacobians for
    residuals whose new state is IN, advance the state machine."""
    upd = active_mask & win.res_exists
    take = upd & (lin.new_state == W.RES_IN) & (win.res_state != W.RES_OOB)

    def cp(old, new):
        return torch.where(_mask_like(take, new), new, old)

    return win.replace(
        J_resF=cp(win.J_resF, lin.resF),
        J_pdxi=cp(win.J_pdxi, lin.Jpdxi),
        J_pdc=cp(win.J_pdc, lin.Jpdc),
        J_pdd=cp(win.J_pdd, lin.Jpdd),
        J_Idx=cp(win.J_Idx, lin.JIdx),
        J_abF=cp(win.J_abF, lin.JabF),
        res_center=cp(win.res_center, lin.center),
        res_state=torch.where(
            upd & (win.res_state != W.RES_OOB), lin.new_state, win.res_state
        ),
        res_energy=torch.where(upd, lin.energy, win.res_energy),
        res_new_energy_wo=torch.where(upd, lin.energy_wo, win.res_new_energy_wo),
    )
