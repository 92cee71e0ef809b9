"""Mono coarse initializer: joint pose + per-point inverse-depth GN bootstrap.

Port of `stereo_dso_g2o_tpu/frontend/initializer.py`, the rebuild of
CoarseInitializer's monocular path (CoarseInitializer.{h,cpp}:
trackFrame:76-345, calcResAndGS:346-660, calcEC:660-688, optReg:690-731,
propagateUp:733-776, propagateDown:778-811, resetPoints:1121-1147,
doStep:1149-1196, applyStep:1198-1215, makeNN:1249+).

In stereo mode this path is dead code (stereo init completes after frame 0,
FullSystem.cpp:1088-1097); it is there for mono operation. The per-point
loops are batched tensor ops; the nanoflann 10-NN graph is the occupancy
grid of `utils/knn.py`. Each pyramid level's LM runs `max_iterations`
masked iterations, as the reference's `fori_loop` does: `accept` and
`done` stay tensors, and an iteration after `done` changes nothing.

Per-level point capacities derive from the reference densities
{0.03, 0.05, 0.15, 0.5, 1.0} x (w_l * h_l) (setFirstStereo:860).

The functions the JAX package jits are programs on the card
(`runtime/program.run`, one per level shape): `lm_level_init` (its
`max_iterations` trips unrolled into the graph), `propagate_up`,
`propagate_down`, `_grid_max_select`, `knn.grid_knn` and
`knn.grid_parent`. `track_frame` reads the device once, after the last
level (the JAX package reads the snap flag once a level).
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from stereo_dso_g2o_tpu_torch import default_device
from stereo_dso_g2o_tpu_torch.config import (
    PATTERN, SCALE_A, SCALE_B, SCALE_XI_ROT, SCALE_XI_TRANS, Settings, default_settings,
)
from stereo_dso_g2o_tpu_torch.models.camera import Calib
from stereo_dso_g2o_tpu_torch.ops.interp import bilinear
from stereo_dso_g2o_tpu_torch.runtime import program
from stereo_dso_g2o_tpu_torch.utils import host, knn, se3
from stereo_dso_g2o_tpu_torch.utils.fixed import constant, nonzero_fixed
from stereo_dso_g2o_tpu_torch.utils.smalls import fma

DENSITIES = (0.03, 0.05, 0.15, 0.5, 1.0)  # CoarseInitializer.cpp:860
ALPHA_K = 2.5 * 2.5
ALPHA_W = 150.0 * 150.0
REG_WEIGHT = 0.8
COUPLING_WEIGHT = 1.0
MAX_ITERATIONS = (5, 5, 10, 30, 50, 50)

# wM state scale (CoarseInitializer.cpp:59-62 — note the reference applies
# SCALE_XI_ROT to the translation rows; kept faithfully)
WM = np.asarray(
    [SCALE_XI_ROT] * 3 + [SCALE_XI_TRANS] * 3 + [SCALE_A, SCALE_B],
    dtype=np.float32,
)


@dataclasses.dataclass
class InitLevel:
    """Fixed-capacity point set of one pyramid level (Pnt, .h:38-97)."""

    valid: torch.Tensor  # (N,) bool
    u: torch.Tensor
    v: torch.Tensor
    idepth: torch.Tensor
    idepth_new: torch.Tensor
    iR: torch.Tensor
    is_good: torch.Tensor  # bool
    energy: torch.Tensor  # (N, 2)
    last_hessian: torch.Tensor
    max_step: torch.Tensor
    outlier_th: torch.Tensor
    my_type: torch.Tensor
    nn: torch.Tensor  # (N, 10) neighbour indices (-1 fill)
    parent: torch.Tensor  # (N,) parent in coarser level (-1 at top)
    Jb: torch.Tensor  # (N, 10) Schur buffer

    def replace(self, **kw) -> "InitLevel":
        return dataclasses.replace(self, **kw)


def _where_level(cond, a: InitLevel, b: InitLevel) -> InitLevel:
    """Field by field: b where cond (a scalar bool tensor), else a."""
    return InitLevel(**{
        f.name: torch.where(cond, getattr(b, f.name), getattr(a, f.name))
        for f in dataclasses.fields(InitLevel)
    })


class MonoInitializer:
    """Host orchestration: select -> NN graph -> per-frame trackFrame."""

    def __init__(self, calib: Calib, settings: Settings = default_settings(), device=None,
                 uniform=None):
        """device: where every tensor lives (None: the GPU; calib moves
        there); uniform: the selector's thinning draw (see ops/selector.py)."""
        dev = default_device(device)
        if calib.device != dev:
            calib = dataclasses.replace(calib, c=calib.c.to(dev), baseline=calib.baseline.to(dev))
        self.calib = calib
        self.settings = settings
        self.uniform = uniform
        self.levels: List[InitLevel] = []
        self.snapped = False
        self.frame_id = -1
        self.snapped_at = 0
        self.this_to_next = np.eye(4)
        self.this_to_next_aff = np.zeros(2)
        self.dI_first = None

    # -- first frame ----------------------------------------------------
    def set_first(self, dIp, asg):
        """Mono setFirst: select per-level pixels, init idepth=1, build NN."""
        from stereo_dso_g2o_tpu_torch.ops.selector import PixelSelector, map_to_points

        s = self.settings
        n_lvl = self.calib.n_levels
        self.dI_first = dIp
        self.levels = []
        sel = PixelSelector(s, uniform=self.uniform)
        for lvl in range(n_lvl):
            w_l, h_l = self.calib.w[lvl], self.calib.h[lvl]
            density = DENSITIES[min(lvl, len(DENSITIES) - 1)] * w_l * h_l
            cap = int(min(w_l * h_l, max(256, int(density * 1.5))))
            if lvl == 0:
                status, _ = sel.make_maps(dIp[0], asg[0], asg[1], asg[2], density)
                us, vs, types, valid = map_to_points(status, cap)
                types = types.to(torch.int32)
            else:
                us, vs, valid = program.run(_grid_max_select, (dIp[lvl], asg[lvl]), dict(cap=cap))
                types = torch.ones(cap, dtype=torch.int32, device=us.device)
            self.levels.append(_new_level(us, vs, types, valid, s))
        self._make_nn()
        self.snapped = False
        self.frame_id = 0
        self.snapped_at = 0

    def _cell(self, lvl: int, n: int) -> torch.Tensor:
        w_l, h_l = self.calib.w[lvl], self.calib.h[lvl]
        return torch.tensor(max(2.0, np.sqrt(w_l * h_l / max(n, 1))), dtype=torch.float32,
                            device=self.calib.device)

    def _make_nn(self):
        n_lvl = len(self.levels)
        for lvl in range(n_lvl):
            L = self.levels[lvl]
            w_l, h_l = self.calib.w[lvl], self.calib.h[lvl]
            gh = max(2, int(np.ceil(h_l / 2.0)))
            gw = max(2, int(np.ceil(w_l / 2.0)))
            nn_idx, _ = program.run(knn.grid_knn,
                                    (L.u, L.v, L.valid, self._cell(lvl, L.u.shape[0])),
                                    dict(gh=gh, gw=gw, k=10))
            parent = torch.full_like(L.parent, -1)
            if lvl + 1 < n_lvl:
                C = self.levels[lvl + 1]
                wc, hc = self.calib.w[lvl + 1], self.calib.h[lvl + 1]
                parent = program.run(
                    knn.grid_parent,
                    (L.u, L.v, L.valid, C.u, C.v, C.valid, self._cell(lvl + 1, C.u.shape[0])),
                    dict(gh=max(2, int(np.ceil(hc / 2.0))), gw=max(2, int(np.ceil(wc / 2.0)))))
            self.levels[lvl] = L.replace(nn=nn_idx, parent=parent)

    # -- per-frame tracking ---------------------------------------------
    def track_frame(self, dI_new_pyr) -> bool:
        """trackFrame: coarse-to-fine joint pose+idepth GN with Schur over
        idepth. Returns snapped && frame_id > snapped_at + 5 (ready)."""
        n_lvl = self.calib.n_levels
        dev = self.calib.device
        if not self.snapped:
            self.this_to_next = np.eye(4)
            for lvl in range(n_lvl):
                L = self.levels[lvl]
                self.levels[lvl] = L.replace(
                    iR=torch.ones_like(L.iR),
                    idepth_new=torch.ones_like(L.idepth_new),
                    last_hessian=torch.zeros_like(L.last_hessian),
                )

        T = torch.as_tensor(np.asarray(self.this_to_next, np.float32), device=dev)
        aff = torch.as_tensor(np.asarray(self.this_to_next_aff, np.float32), device=dev)
        # the snap flag stays on the device from level to level: each
        # level's result holds the flag it was given or'ed with its own
        snapped = torch.tensor(bool(self.snapped), device=dev)

        for lvl in range(n_lvl - 1, -1, -1):
            if lvl < n_lvl - 1:
                self.levels[lvl] = program.run(
                    propagate_down, (self.levels[lvl], self.levels[lvl + 1]), {})
            K_lvl = torch.stack([self.calib.fx(lvl), self.calib.fy(lvl),
                                 self.calib.cx(lvl), self.calib.cy(lvl)])
            L, T, aff, _, snapped = program.run(
                lm_level_init,
                (self.levels[lvl], self.dI_first[lvl], dI_new_pyr[lvl], K_lvl, T, aff, snapped),
                dict(settings=self.settings, top_level=lvl == n_lvl - 1,
                     max_iterations=MAX_ITERATIONS[min(lvl, len(MAX_ITERATIONS) - 1)]))
            self.levels[lvl] = L

        for lvl in range(n_lvl - 1):
            self.levels[lvl + 1] = program.run(
                propagate_up, (self.levels[lvl], self.levels[lvl + 1]), {})

        # the frame's one read
        T_np, aff_np, snapped_np = host.Fetch((T, aff, snapped)).get()
        self.this_to_next = T_np.astype(np.float64)
        self.this_to_next_aff = aff_np.astype(np.float64)
        snapped_flag = bool(snapped_np)

        self.frame_id += 1
        if not snapped_flag:
            self.snapped_at = 0
        if snapped_flag and self.snapped_at == 0 and not self.snapped:
            self.snapped_at = self.frame_id
        self.snapped = snapped_flag
        return self.snapped and self.frame_id > self.snapped_at + 5


def _new_level(us, vs, types, valid, settings: Settings) -> InitLevel:
    n = us.shape[0]
    dev = us.device

    def full(shape, value, dtype=torch.float32):
        return torch.full(shape, value, dtype=dtype, device=dev)

    return InitLevel(
        valid=valid,
        u=us.to(torch.float32),
        v=vs.to(torch.float32),
        idepth=full((n,), 1.0),
        idepth_new=full((n,), 1.0),
        iR=full((n,), 1.0),
        is_good=valid,
        energy=full((n, 2), 0.0),
        last_hessian=full((n,), 0.0),
        max_step=full((n,), 1e10),
        outlier_th=full((n,), 8.0 * settings.outlier_th),
        my_type=types,
        nn=full((n, 10), -1, torch.int32),
        parent=full((n,), -1, torch.int32),
        Jb=full((n, 10), 0.0),
    )


def _median(x: torch.Tensor) -> torch.Tensor:
    """`jnp.median` of all entries: the mean of the two middle values when
    the count is even (`torch.median` returns the lower one)."""
    s = torch.sort(x.reshape(-1)).values
    n = s.shape[0]
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


def _grid_max_select(dI, asg, cap: int):
    """Coarse-level selection: strongest gradient per sparsityFactor-grid cell
    above threshold (PixelSelector.h makePixelStatus/gridMaxSelection)."""
    H, W = asg.shape
    pot = 5  # sparsityFactor (settings.cpp:158)
    hp, wp = H // pot, W // pot
    g = asg[: hp * pot, : wp * pot].reshape(hp, pot, wp, pot)
    g = g.permute(0, 2, 1, 3).reshape(hp, wp, pot * pot)
    best = torch.argmax(g, dim=-1)  # the first maximum, as jnp.argmax
    val = torch.amax(g, dim=-1)
    med = _median(asg)
    ok = (val > med * 1.5) & (val > 1.0)
    dev = asg.device
    iy = best // pot + torch.arange(hp, device=dev)[:, None] * pot
    ix = best % pot + torch.arange(wp, device=dev)[None, :] * pot
    idx = nonzero_fixed(ok.reshape(-1), cap)
    valid = idx >= 0
    safe = torch.clamp(idx, min=0)
    return (
        ix.reshape(-1)[safe].to(torch.float32),
        iy.reshape(-1)[safe].to(torch.float32),
        valid,
    )


def _calc_res_gs(L: InitLevel, dI_ref, dI_new, K_lvl, T, aff, snapped, settings: Settings):
    """calcResAndGS: energies, 8x8 H/b, Schur parts, per-point Jb buffer."""
    fx, fy, cx, cy = K_lvl[0], K_lvl[1], K_lvl[2], K_lvl[3]
    Hd, Wd = dI_new.shape[:2]
    R = T[:3, :3]
    t = T[:3, 3]
    z = torch.zeros_like(fx)
    o = torch.ones_like(fx)
    Ki = torch.stack([
        torch.stack([1.0 / fx, z, -cx / fx]),
        torch.stack([z, 1.0 / fy, -cy / fy]),
        torch.stack([z, z, o]),
    ])
    RKi = R @ Ki
    a_exp = torch.exp(aff[0])

    pat = constant(PATTERN, torch.float32, L.u.device)
    pu = L.u[:, None] + pat[None, :, 0]  # (N, 8)
    pv = L.v[:, None] + pat[None, :, 1]
    # rounded as XLA computes them: the 3-term dot as a chain of FMAs, and
    # K's multiply-add as one FMA. At the identity pose a pattern pixel on
    # an integer coordinate lands exactly on the in-bounds edge (Ku > 1), so
    # the rounding decides the test.
    ones = torch.ones_like(pu)[..., None]
    pt = fma(RKi[:, 2], ones, fma(RKi[:, 1], pv[..., None], RKi[:, 0] * pu[..., None]))
    pt = pt + t[None, None, :] * L.idepth_new[:, None, None]
    u_n = pt[..., 0] / pt[..., 2]
    v_n = pt[..., 1] / pt[..., 2]
    Ku = fma(fx, u_n, cx)
    Kv = fma(fy, v_n, cy)
    new_idepth = L.idepth_new[:, None] / pt[..., 2]
    inb = (Ku > 1) & (Kv > 1) & (Ku < Wd - 2) & (Kv < Hd - 2) & (new_idepth > 0)

    hit = bilinear(dI_new, Ku, Kv)  # (N, 8, 3)
    ref_col = bilinear(dI_ref[..., 0], pu, pv)
    residual = hit[..., 0] - a_exp * ref_col - aff[1]
    ar = torch.abs(residual)
    hw0 = torch.where(ar < settings.huber_th, torch.ones_like(ar),
                      settings.huber_th / torch.clamp(ar, min=1e-12))
    energy_pix = hw0 * residual * residual * (2.0 - hw0)

    all_ok = torch.all(inb, dim=1) & L.valid & L.is_good
    energy = torch.sum(energy_pix, dim=1)
    good_new = all_ok & (energy <= L.outlier_th * 20.0)

    dxdd = (t[0] - t[2] * u_n) / pt[..., 2]
    dydd = (t[1] - t[2] * v_n) / pt[..., 2]
    hw = torch.where(hw0 < 1.0, torch.sqrt(hw0), hw0)
    dxI = hw * hit[..., 1] * fx
    dyI = hw * hit[..., 2] * fy
    dp = torch.stack(
        [
            new_idepth * dxI,
            new_idepth * dyI,
            -new_idepth * (u_n * dxI + v_n * dyI),
            -u_n * v_n * dxI - (1 + v_n * v_n) * dyI,
            (1 + u_n * u_n) * dxI + u_n * v_n * dyI,
            -v_n * dxI + u_n * dyI,
            -hw * a_exp * ref_col,
            -hw,
        ],
        dim=-1,
    )  # (N, 8pix, 8dof)
    dd = dxI * dxdd + dydd * dyI  # (N, 8)
    r = hw * residual

    max_step = 1.0 / torch.clamp(
        torch.linalg.vector_norm(torch.stack([dxdd * fx, dydd * fy], -1), dim=-1), min=1e-10)
    max_step = torch.where(inb, max_step, torch.full_like(max_step, 1e10)).amin(dim=1)

    m = good_new.to(torch.float32)
    J9 = torch.cat([dp, r[..., None]], dim=-1)  # (N, 8, 9)
    acc9 = torch.einsum("npi,npj,n->ij", J9, J9, m)

    Jb8 = torch.einsum("npi,np->ni", dp, dd)
    Jb_r = torch.einsum("np,np->n", r, dd)
    Jb_d = torch.einsum("np,np->n", dd, dd)

    # energy bookkeeping: bad points contribute their OLD energy (:385-391)
    zero = torch.zeros_like(energy)
    E_total = torch.sum(torch.where(good_new, energy,
                                    torch.where(L.valid & L.is_good, L.energy[:, 0], zero)))
    n_pts = torch.sum(L.valid).to(torch.float32)

    # alpha energy (:545-580)
    e1_new = (L.idepth_new - 1.0) ** 2
    E_alpha_pts = torch.sum(torch.where(good_new, e1_new, zero))
    alpha_energy = ALPHA_W * (E_alpha_pts + torch.sum(t * t) * n_pts)
    snap_now = alpha_energy > ALPHA_K * n_pts
    alpha_energy = torch.minimum(alpha_energy, ALPHA_K * n_pts)
    alpha_opt = torch.where(snap_now, torch.zeros_like(alpha_energy),
                            torch.full_like(alpha_energy, ALPHA_W))

    last_hessian_new = Jb_d
    coup = torch.where(alpha_opt == 0.0, torch.full_like(alpha_opt, COUPLING_WEIGHT),
                       torch.zeros_like(alpha_opt))
    Jb_r = Jb_r + alpha_opt * (L.idepth_new - 1.0)
    Jb_d = Jb_d + alpha_opt
    Jb_r = Jb_r + coup * (L.idepth_new - L.iR)
    Jb_d = Jb_d + coup
    Jb_d = 1.0 / (1.0 + Jb_d)
    Jb = torch.cat([Jb8, Jb_r[:, None], Jb_d[:, None]], dim=1)

    J9sc = Jb[:, :9]
    acc9SC = torch.einsum("ni,nj,n,n->ij", J9sc, J9sc, Jb[:, 9], m)

    H = acc9[:8, :8].clone()
    b = acc9[:8, 8].clone()
    Hsc = acc9SC[:8, :8]
    bsc = acc9SC[:8, 8]
    idx3 = torch.arange(3, device=H.device)
    H[idx3, idx3] += alpha_opt * n_pts
    tlog = se3.se3_log(T)[:3]
    b[:3] += tlog * alpha_opt * n_pts

    return dict(
        H=H, b=b, Hsc=Hsc, bsc=bsc, Jb=Jb,
        E=E_total, alpha=alpha_energy, n=n_pts,
        good_new=good_new, energy_new=torch.stack([energy, e1_new], -1),
        last_hessian_new=last_hessian_new,
        max_step=max_step,
        snap=snap_now & (alpha_energy == ALPHA_K * n_pts),
    )


def _opt_reg(L: InitLevel, snapped) -> InitLevel:
    """optReg: iR <- (1-w)*idepth + w*median(neighbour iR) (:690-731)."""
    nn = L.nn
    safe = torch.clamp(nn, min=0).long()
    n_iR = L.iR[safe]
    ok = (nn >= 0) & L.is_good[safe] & L.valid[safe]
    n_ok = torch.sum(ok, dim=1)
    vals = torch.where(ok, n_iR, torch.full_like(n_iR, float("inf")))
    vals = torch.sort(vals, dim=1).values
    mid = torch.clamp(n_ok // 2, 0, 9)
    med = torch.gather(vals, 1, mid[:, None])[:, 0]
    # one FMA, as XLA fuses it
    new_iR = fma(torch.full_like(med, 1.0 - REG_WEIGHT), L.idepth, REG_WEIGHT * med)
    upd = L.valid & L.is_good & (n_ok > 2)
    iR = torch.where(upd, new_iR, L.iR)
    iR = torch.where(snapped, iR, torch.ones_like(iR))
    return L.replace(iR=iR)


def lm_level_init(L: InitLevel, dI_ref, dI_new, K_lvl, T, aff, snapped,
                  settings: Settings = default_settings(), top_level: bool = False,
                  max_iterations: int = 10):
    """One pyramid level of the initializer's LM (trackFrame STEP4-5).

    Returns (L, T, aff, E (2,), snapped) after `max_iterations` masked
    iterations; nothing is read back to the host."""
    # resetPoints (:1121-1147)
    L = L.replace(energy=torch.zeros_like(L.energy), idepth_new=L.idepth)
    if top_level:
        nn = L.nn
        safe = torch.clamp(nn, min=0).long()
        ok = (nn >= 0) & L.is_good[safe] & L.valid[safe]
        snd = torch.sum(torch.where(ok, L.iR[safe], torch.zeros_like(L.iR[safe])), dim=1)
        sn = torch.sum(ok, dim=1)
        revive = L.valid & ~L.is_good & (sn > 0)
        mean_iR = snd / torch.clamp(sn, min=1)
        L = L.replace(
            is_good=L.is_good | revive,
            iR=torch.where(revive, mean_iR, L.iR),
            idepth=torch.where(revive, mean_iR, L.idepth),
            idepth_new=torch.where(revive, mean_iR, L.idepth_new),
        )

    first = _calc_res_gs(L, dI_ref, dI_new, K_lvl, T, aff, snapped, settings)
    # applyStep semantics for the pre-iteration state
    L = _apply(L, first)

    dev = L.u.device
    wM = constant(WM, torch.float32, dev)
    eye8 = torch.eye(8, dtype=torch.float32, device=dev)
    npx = dI_new.shape[0] * dI_new.shape[1]
    H, b, Hsc, bsc = first["H"], first["b"], first["Hsc"], first["bsc"]
    E_old = torch.stack([first["E"], first["alpha"]])
    lam = torch.full((), 0.1, dtype=torch.float32, device=dev)
    fails = torch.zeros((), dtype=torch.int32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    snapped_c = snapped

    for _ in range(max_iterations):
        Hl = H + torch.diag(torch.diag(H)) * lam - Hsc * (1.0 / (1.0 + lam))
        bl = b - bsc * (1.0 / (1.0 + lam))
        Hl = wM[:, None] * Hl * wM[None, :] * (0.01 / npx)
        bl = wM * bl * (0.01 / npx)
        sol = torch.linalg.solve_ex(Hl + 1e-10 * eye8, bl)[0]  # singular: non-finite, zeroed
        inc = -(wM * sol)
        inc = torch.where(torch.isfinite(inc), inc, torch.zeros_like(inc))

        T_new = se3.se3_exp(inc[:6]) @ T
        aff_new = aff + inc[6:8]
        # doStep (:1149-1196)
        bstep = L.Jb[:, 8] + L.Jb[:, :8] @ inc
        step = -bstep * L.Jb[:, 9] / (1.0 + lam)
        mstep = torch.clamp(0.25 * L.max_step, max=1e10)
        step = torch.minimum(torch.maximum(step, -mstep), mstep)
        new_id = torch.clamp(L.idepth + step, 1e-3, 50.0)
        L_try = L.replace(idepth_new=torch.where(L.is_good, new_id, L.idepth_new))

        res = _calc_res_gs(L_try, dI_ref, dI_new, K_lvl, T_new, aff_new, snapped_c, settings)
        # calcEC regularizer energies (:660-688)
        zero = torch.zeros_like(L_try.idepth)
        reg_old = torch.sum(torch.where(res["good_new"], (L_try.idepth - L_try.iR) ** 2, zero)) \
            * COUPLING_WEIGHT
        reg_new = torch.sum(torch.where(res["good_new"], (L_try.idepth_new - L_try.iR) ** 2,
                                        zero)) * COUPLING_WEIGHT
        reg_old = torch.where(snapped_c, reg_old, torch.zeros_like(reg_old))
        reg_new = torch.where(snapped_c, reg_new, torch.zeros_like(reg_new))

        accept = (E_old[0] + E_old[1] + reg_old) > (res["E"] + res["alpha"] + reg_new)
        accept = accept & ~done

        snapped_c = snapped_c | (accept & res["snap"])
        L_acc = _opt_reg(_apply(L_try, res), snapped_c)
        L = _where_level(accept, L, L_acc)
        T = torch.where(accept, T_new, T)
        aff = torch.where(accept, aff_new, aff)
        H = torch.where(accept, res["H"], H)
        b = torch.where(accept, res["b"], b)
        Hsc = torch.where(accept, res["Hsc"], Hsc)
        bsc = torch.where(accept, res["bsc"], bsc)
        E_old = torch.where(accept, torch.stack([res["E"], res["alpha"]]), E_old)
        lam = torch.where(
            done, lam,
            torch.where(accept, torch.clamp(lam * 0.5, min=1e-4), torch.clamp(lam * 4.0, max=1e4)),
        )
        fails = torch.where(done, fails, torch.where(accept, torch.zeros_like(fails), fails + 1))
        done = done | (torch.linalg.vector_norm(inc) <= 1e-4) | (fails >= 2)

    return L, T, aff, E_old, snapped_c


def _apply(L: InitLevel, res) -> InitLevel:
    """applyStep (:1198-1215)."""
    good = res["good_new"]
    return L.replace(
        energy=torch.where(good[:, None], res["energy_new"], L.energy),
        is_good=good,
        idepth=torch.where(L.is_good, L.idepth_new, L.iR),
        idepth_new=torch.where(L.is_good, L.idepth_new, L.iR),
        last_hessian=torch.where(good, res["last_hessian_new"], L.last_hessian),
        max_step=res["max_step"],
        Jb=res["Jb"],
    )


def propagate_up(src: InitLevel, dst: InitLevel) -> InitLevel:
    """propagateUp: information-weighted idepth pooling into parents."""
    parent = torch.clamp(src.parent, min=0).long()
    w_src = torch.where(src.valid & src.is_good & (src.parent >= 0), src.last_hessian,
                        torch.zeros_like(src.last_hessian))
    # summed in index order: on the card `index_add_` adds by atomics, in
    # an order that varies from run to run; an accumulating `index_put_`
    # sorts the indices first (on the CPU both add serially, in order)
    iR_sum = torch.zeros_like(dst.iR).index_put_((parent,), src.iR * w_src, accumulate=True)
    w_sum = torch.zeros_like(dst.iR).index_put_((parent,), w_src, accumulate=True)
    has = w_sum > 0
    new_iR = torch.where(has, iR_sum / torch.clamp(w_sum, min=1e-12), dst.iR)
    out = dst.replace(
        iR=new_iR,
        idepth=torch.where(has, new_iR, dst.idepth),
        is_good=dst.is_good | (has & dst.valid),
    )
    return _opt_reg(out, constant(True, torch.bool, dst.iR.device))


def propagate_down(dst: InitLevel, src: InitLevel) -> InitLevel:
    """propagateDown: parent-informed idepth init for the finer level."""
    parent = torch.clamp(dst.parent, min=0).long()
    p_good = (dst.parent >= 0) & src.is_good[parent] & (src.last_hessian[parent] >= 0.1)
    p_iR = src.iR[parent]
    p_h = src.last_hessian[parent]

    revive = dst.valid & ~dst.is_good & p_good
    blend = dst.valid & dst.is_good & p_good
    new_iR = (dst.iR * dst.last_hessian * 2 + p_iR * p_h) / torch.clamp(
        dst.last_hessian * 2 + p_h, min=1e-12)
    iR = torch.where(revive, p_iR, torch.where(blend, new_iR, dst.iR))
    out = dst.replace(
        iR=iR,
        idepth=torch.where(revive | blend, iR, dst.idepth),
        idepth_new=torch.where(revive | blend, iR, dst.idepth_new),
        is_good=dst.is_good | revive,
        last_hessian=torch.where(revive, torch.zeros_like(dst.last_hessian), dst.last_hessian),
    )
    return _opt_reg(out, constant(True, torch.bool, dst.iR.device))


def score_against_truth(level0: InitLevel, idepth_gt: np.ndarray, T_est, T_gt) -> dict:
    """How well an initializer recovered a rendered scene, as
    tests/test_initializer.py:61-79 judges it: level 0's good points, their
    median relative inverse-depth error against the renderer's up to the
    mono scale, and the cosine between the recovered translation `T_est`
    and the true one `T_gt` (4x4 each)."""
    valid, is_good, us, vs, est = (np.asarray(x.detach().cpu() if hasattr(x, "detach") else x)
                                   for x in (level0.valid, level0.is_good, level0.u, level0.v,
                                             level0.idepth))
    h, w = idepth_gt.shape
    good = valid & is_good
    gt = idepth_gt[np.clip(vs.astype(int), 0, h - 1), np.clip(us.astype(int), 0, w - 1)]
    lam = np.median(gt[good] / est[good])
    rel = float(np.median(np.abs(est[good] * lam - gt[good]) / gt[good]))
    t_est, t_gt = np.asarray(T_est)[:3, 3], np.asarray(T_gt)[:3, 3]
    cos = float(np.dot(t_est, t_gt) / (np.linalg.norm(t_est) * np.linalg.norm(t_gt) + 1e-12))
    return dict(n_good=int(good.sum()), median_rel_err=rel, t_cos=cos)
