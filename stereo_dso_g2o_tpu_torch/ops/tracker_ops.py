"""Coarse-tracker ops: reference idepth maps + direct image alignment.

Port of `stereo_dso_g2o_tpu/ops/tracker_ops.py` (CoarseTracker):

- `build_ref_maps`: weighted point splat at level 0, sum-pooling up the
  pyramid, 2-phase dilation, normalization (makeCoarseDepthL0 STEP2-5).
- `compact_ref_level`: one level's maps as fixed-capacity point lists.
- `calc_res`, `calc_gs`: warped Huber residuals and the 8x8 GN system.
- `lm_level`: the per-level LM loop with the in-loop cutoff repeat.

The JAX package vmaps the tracker over pose hypotheses, and the batched
frame program over sequences too; here the hypotheses are a batch
dimension K of the pose arguments, and sequences a leading dimension N of
everything per sequence: reference points (N, P), the new image
(N, H, W, 3), intrinsics (N, 4), affine and exposures, with poses
(N, K, 4, 4). B = N*K rows run as one: every reduction is along a row's own
points, so a row rounds as it does alone. Without the leading N (points
(P,), image (H, W, 3), K (4,), poses (K, 4, 4)) the same code is the one
sequence. The JAX `lax.while_loop` becomes `utils/loop.while_loop` over
`lm_trip`, which freezes the finished rows, as a vmapped while_loop does:
eagerly a host loop until every row is done (one host read an iteration
for the whole batch), in a captured program a CUDA WHILE node.

On CUDA tensors a trip is one launch of `csrc/lm_trip.cu` (`lm_trip_cuda`,
a block per row; `trip_launches()` counts the launches the devices ran);
on CPU tensors it is the plain version, `lm_trip_ref`, which the kernel
is held to (tests/test_torch_lm_trip.py).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from stereo_dso_g2o_tpu_torch.config import (
    SCALE_A,
    SCALE_B,
    SCALE_XI_ROT,
    SCALE_XI_TRANS,
    Settings,
    default_settings,
)
from stereo_dso_g2o_tpu_torch.ops.interp import take
from stereo_dso_g2o_tpu_torch.utils import loop, se3
from stereo_dso_g2o_tpu_torch.utils.fixed import constant, nonzero_fixed
from stereo_dso_g2o_tpu_torch.utils.smalls import cholesky_solve_small, fma

# ---------------------------------------------------------------------------
# reference map construction
# ---------------------------------------------------------------------------


def _dilate(idepth, wsum, shifts):
    num = torch.zeros_like(wsum)
    s_id = torch.zeros_like(idepth)
    s_w = torch.zeros_like(wsum)
    for dy, dx in shifts:
        wn = torch.roll(wsum, (dy, dx), dims=(-2, -1))
        idn = torch.roll(idepth, (dy, dx), dims=(-2, -1))
        m = wn > 0
        num = num + m
        s_id = s_id + torch.where(m, idn, torch.zeros_like(idn))
        s_w = s_w + torch.where(m, wn, torch.zeros_like(wn))
    hole = (wsum <= 0) & (num > 0)
    den = torch.clamp(num, min=1)
    return (
        torch.where(hole, s_id / den, idepth),
        torch.where(hole, s_w / den, wsum),
    )


def _dilate_diag(idepth, wsum):
    """Fill holes from the four diagonal neighbours (levels 0-1)."""
    return _dilate(idepth, wsum, ((-1, -1), (1, 1), (-1, 1), (1, -1)))


def _dilate_cross(idepth, wsum):
    """Fill holes from the four axis neighbours (levels >= 2)."""
    return _dilate(idepth, wsum, ((0, -1), (0, 1), (-1, 0), (1, 0)))


def build_ref_maps(us, vs, idepths, weights, valid, *, n_levels: int = 6, dI_ref=None):
    """Per-level (idepth_map, valid_map, color_map) tuples for tracking.

    us, vs: (P,) level-0 pixel coords; idepths, weights: (P,); valid: (P,);
    dI_ref: tuple of per-level (H,W,3) reference pyramids. N sequences:
    points (N, P), pyramids (N, H, W, 3), maps (N, H, W); each sequence's
    splat adds its points in the order one sequence alone adds them."""
    assert dI_ref is not None
    H, W = dI_ref[0].shape[-3:-1]
    lead = tuple(us.shape[:-1])
    dev = us.device
    iu = torch.clamp(us.to(torch.int64), 0, W - 1)
    iv = torch.clamp(vs.to(torch.int64), 0, H - 1)
    w_ok = torch.where(valid, weights, torch.zeros_like(weights)).float()
    flat = iv * W + iu
    if lead:  # one splat over all sequences' pixels, sequence after sequence
        flat = flat + torch.arange(lead[0], device=dev)[:, None] * (H * W)
    id_acc = torch.zeros(lead + (H * W,), dtype=torch.float32, device=dev)
    id_acc.view(-1).index_put_((flat.reshape(-1),), (idepths * w_ok).float().reshape(-1),
                               accumulate=True)
    w_acc = torch.zeros(lead + (H * W,), dtype=torch.float32, device=dev)
    w_acc.view(-1).index_put_((flat.reshape(-1),), w_ok.reshape(-1), accumulate=True)

    id_maps, w_maps = [id_acc.reshape(lead + (H, W))], [w_acc.reshape(lead + (H, W))]
    for _lvl in range(1, n_levels):
        idp = id_maps[-1]
        wp = w_maps[-1]
        h2, w2 = idp.shape[-2] // 2, idp.shape[-1] // 2

        def pool(x):
            return (
                x[..., 0 : 2 * h2 : 2, 0 : 2 * w2 : 2]
                + x[..., 0 : 2 * h2 : 2, 1 : 2 * w2 : 2]
                + x[..., 1 : 2 * h2 : 2, 0 : 2 * w2 : 2]
                + x[..., 1 : 2 * h2 : 2, 1 : 2 * w2 : 2]
            )

        id_maps.append(pool(idp))
        w_maps.append(pool(wp))

    out_id, out_valid, out_color = [], [], []
    for lvl in range(n_levels):
        idm, wm = id_maps[lvl], w_maps[lvl]
        if lvl < 2:
            idm, wm = _dilate_diag(idm, wm)
        else:
            idm, wm = _dilate_cross(idm, wm)
        ok = wm > 0
        idn = torch.where(ok, idm / torch.clamp(wm, min=1e-12), torch.full_like(idm, -1.0))
        hl, wl = idn.shape[-2:]
        xs = torch.arange(wl, device=dev)
        ys = torch.arange(hl, device=dev)
        interior = (
            (xs[None, :] >= 2) & (xs[None, :] < wl - 2)
            & (ys[:, None] >= 2) & (ys[:, None] < hl - 2)
        )
        colr = dI_ref[lvl][..., 0]
        ok = ok & interior & (idn > 0) & torch.isfinite(colr)
        out_id.append(torch.where(ok, idn, torch.full_like(idn, -1.0)))
        out_valid.append(ok)
        out_color.append(colr)
    return tuple(out_id), tuple(out_valid), tuple(out_color)


def compact_ref_level(id_map, valid_map, color_map, cap: int):
    """Compact one level's maps into fixed-capacity point lists ((N, cap)
    for N sequences' (N, H, W) maps)."""
    H, W = id_map.shape[-2:]
    batched = id_map.dim() == 3
    idx = nonzero_fixed(valid_map.flatten(-2), cap, batched=batched)
    ok = idx >= 0
    safe = torch.clamp(idx, min=0)
    u = (safe % W).to(torch.float32)
    v = (safe // W).to(torch.float32)
    zero = torch.zeros(safe.shape, dtype=torch.float32, device=id_map.device)
    return (
        u,
        v,
        torch.where(ok, torch.gather(id_map.flatten(-2), -1, safe), zero),
        torch.where(ok, torch.gather(color_map.flatten(-2), -1, safe), zero),
        ok,
    )


# ---------------------------------------------------------------------------
# residuals + normal equations
# ---------------------------------------------------------------------------


class ResStats(NamedTuple):
    energy: torch.Tensor  # (B,)
    num_terms: torch.Tensor  # (B,)
    num_saturated: torch.Tensor  # (B,)
    flow_t: torch.Tensor  # (B,)
    flow_rt: torch.Tensor  # (B,)
    buf_ok: torch.Tensor  # (B, N)
    buf_inb: torch.Tensor  # (B, N)
    buf_idepth: torch.Tensor
    buf_u: torch.Tensor
    buf_v: torch.Tensor
    buf_dx: torch.Tensor
    buf_dy: torch.Tensor
    buf_residual: torch.Tensor
    buf_weight: torch.Tensor
    buf_ref_color: torch.Tensor


def _bilinear3(dI, x, y):
    """Bilinear (I, gx, gy) sample of an (H, W, 3) level at (x, y); of
    image n of an (N, H, W, 3) stack for row n of (N, ...) coordinates."""
    stacked = dI.dim() == 4
    H, W = dI.shape[-3:-1]
    x = torch.clamp(x, 0.0, W - 1.001)
    y = torch.clamp(y, 0.0, H - 1.001)
    xf = torch.floor(x)
    yf = torch.floor(y)
    ix = torch.nan_to_num(xf).long()  # NaN coords sample index 0 and stay NaN
    iy = torch.nan_to_num(yf).long()
    fx = (x - xf)[..., None]
    fy = (y - yf)[..., None]
    top = (1 - fx) * take(dI, iy, ix, stacked) + fx * take(dI, iy, ix + 1, stacked)
    bot = (1 - fx) * take(dI, iy + 1, ix, stacked) + fx * take(dI, iy + 1, ix + 1, stacked)
    return (1 - fy) * top + fy * bot


def _huber_w(ar, th):
    return torch.where(ar < th, torch.ones_like(ar), th / torch.clamp(ar, min=1e-12))


def calc_res(
    pc_u, pc_v, pc_idepth, pc_color, pc_ok, dI_new, K_lvl, T_ref_new, aff_ab,
    cutoff_th, settings: Settings = default_settings(), compute_flow: bool = True,
) -> ResStats:
    """Photometric residuals of all reference points warped into the new frame
    (calcRes legacy semantics), for K pose hypotheses at once.

    pc_*: (P,); K_lvl: (4,); T_ref_new: (K,4,4); aff_ab: (K,2);
    cutoff_th: (K,). For N sequences (module docstring): pc_* (N, P),
    dI_new (N, H, W, 3), K_lvl (N, 4), T_ref_new (N, K, 4, 4), aff_ab
    (N, K, 2), cutoff_th (N, K)."""
    H, W = dI_new.shape[-3:-1]
    # per sequence, broadcast over its points ((..., 1)) and its rows' points
    fx, fy, cx, cy = (K_lvl[..., j, None] for j in range(4))
    fxr, fyr, cxr, cyr = (k[..., None] for k in (fx, fy, cx, cy))
    R = T_ref_new[..., :3, :3]
    t = T_ref_new[..., :3, 3]

    xn = (pc_u - cx) / fx
    yn = (pc_v - cy) / fy
    P = torch.stack([xn, yn, torch.ones_like(xn)], -1)  # (..., P, 3)
    PR = torch.einsum("...nk,...bjk->...bnj", P, R)  # P @ R^T
    pt = PR + t[..., None, :] * pc_idepth[..., None, :, None]
    u_n = pt[..., 0] / pt[..., 2]
    v_n = pt[..., 1] / pt[..., 2]
    # XLA contracts these multiply-adds into FMAs (one rounding). At the
    # identity pose an integer reference pixel lands exactly on the in-bounds
    # edge (Ku > 2), so the rounding decides the test: round it the same way.
    Ku = fma(fxr, u_n, cxr)
    Kv = fma(fyr, v_n, cyr)
    new_idepth = pc_idepth[..., None, :] / pt[..., 2]

    inb = (
        pc_ok[..., None, :]
        & (Ku > 2) & (Kv > 2) & (Ku < W - 3) & (Kv < H - 3)
        & (new_idepth > 0)
    )

    hit = _bilinear3(dI_new, Ku, Kv)
    residual = hit[..., 0] - (aff_ab[..., 0:1] * pc_color[..., None, :] + aff_ab[..., 1:2])
    ar = torch.abs(residual)
    hw = _huber_w(ar, settings.huber_th)

    cut = cutoff_th[..., None]
    saturated = inb & (ar > cut)
    good = inb & ~saturated
    max_energy = 2.0 * settings.huber_th * cut - settings.huber_th**2
    e_term = torch.where(
        good, hw * residual * residual * (2.0 - hw),
        torch.where(saturated, max_energy.expand_as(ar), torch.zeros_like(ar)),
    )
    energy = torch.sum(e_term, dim=-1)
    num_terms = torch.sum(inb, dim=-1)
    num_saturated = torch.sum(saturated, dim=-1)

    rows = tuple(T_ref_new.shape[:-2])
    if compute_flow:
        ti = t[..., None, :] * pc_idepth[..., None, :, None]
        ptT = P[..., None, :, :] + ti
        KuT = fxr * ptT[..., 0] / ptT[..., 2] + cxr
        KvT = fyr * ptT[..., 1] / ptT[..., 2] + cyr
        ptT2 = P[..., None, :, :] - ti
        KuT2 = fxr * ptT2[..., 0] / ptT2[..., 2] + cxr
        KvT2 = fyr * ptT2[..., 1] / ptT2[..., 2] + cyr
        pt3 = PR - ti
        Ku3 = fxr * pt3[..., 0] / pt3[..., 2] + cxr
        Kv3 = fyr * pt3[..., 1] / pt3[..., 2] + cyr

        m = pc_ok[..., None, :]
        nsel = torch.clamp(torch.sum(pc_ok, dim=-1), min=1)[..., None]
        u_ref, v_ref = pc_u[..., None, :], pc_v[..., None, :]

        def msum(x):
            return torch.sum(torch.where(m, x, torch.zeros_like(x)), dim=-1)

        flow_t = (
            msum((KuT - u_ref) ** 2 + (KvT - v_ref) ** 2)
            + msum((KuT2 - u_ref) ** 2 + (KvT2 - v_ref) ** 2)
        ) / (2.0 * nsel + 0.1)
        flow_rt = (
            msum((Ku - u_ref) ** 2 + (Kv - v_ref) ** 2)
            + msum((Ku3 - u_ref) ** 2 + (Kv3 - v_ref) ** 2)
        ) / (2.0 * nsel + 0.1)
    else:
        flow_t = torch.zeros(rows, dtype=dI_new.dtype, device=dI_new.device)
        flow_rt = torch.zeros(rows, dtype=dI_new.dtype, device=dI_new.device)

    return ResStats(
        energy=energy,
        num_terms=num_terms,
        num_saturated=num_saturated,
        flow_t=flow_t,
        flow_rt=flow_rt,
        buf_ok=good,
        buf_inb=inb,
        buf_idepth=new_idepth,
        buf_u=u_n,
        buf_v=v_n,
        buf_dx=hit[..., 1],
        buf_dy=hit[..., 2],
        buf_residual=residual,
        buf_weight=hw,
        buf_ref_color=pc_color[..., None, :].expand_as(residual),
    )


def _precond_scale(like):
    return constant((SCALE_XI_ROT,) * 3 + (SCALE_XI_TRANS,) * 3 + (SCALE_A, SCALE_B),
                    like.dtype, like.device)


def calc_gs(stats: ResStats, K_lvl, a_coeff, b0):
    """(B,8,8) H and (B,8) b from the warped buffers (calcGSSSE), scaled by
    the reference's preconditioners (including its rot/trans scale swap).

    a_coeff: (B,) photometric transfer slope; b0: reference frame's aff b.
    For N sequences: K_lvl (N, 4), rows (N, K), b0 (N,)."""
    fx, fy = K_lvl[..., 0, None, None], K_lvl[..., 1, None, None]
    b0 = torch.as_tensor(b0)[..., None, None]
    ok = stats.buf_ok
    n = torch.clamp(torch.sum(ok, dim=-1), min=1).to(torch.float32)

    dx = stats.buf_dx * fx
    dy = stats.buf_dy * fy
    u = stats.buf_u
    v = stats.buf_v
    idp = stats.buf_idepth

    J = torch.stack(
        [
            idp * dx,
            idp * dy,
            -idp * (u * dx + v * dy),
            -(u * v * dx + dy * (1.0 + v * v)),
            u * v * dy + dx * (1.0 + u * u),
            u * dy - v * dx,
            a_coeff[..., None] * (b0 - stats.buf_ref_color),
            -torch.ones_like(u),
            stats.buf_residual,
        ],
        dim=-1,
    )  # (B, N, 9)
    w = torch.where(ok, stats.buf_weight, torch.zeros_like(stats.buf_weight))
    Jw = J * w[..., None]
    if K_lvl.dim() == 2 and ok.shape[-2] == 1:
        # one row per sequence (the winners on the fine levels): a lone row
        # is a GEMM of its own, whose point sum the BLAS may split among
        # threads, and a batch of rows is summed otherwise; so each
        # sequence's row is its own GEMM, as the sequence alone computes it
        Hfull = torch.cat([torch.einsum("...ni,...nj->...ij", Jw[k:k + 1], J[k:k + 1])
                           for k in range(J.shape[0])])
    else:
        Hfull = torch.einsum("...ni,...nj->...ij", Jw, J)
    Hfull = Hfull / n[..., None, None]
    Hm = Hfull[..., :8, :8]
    bv = Hfull[..., :8, 8]
    scale = _precond_scale(Hm)
    return Hm * scale[:, None] * scale[None, :], bv * scale


# ---------------------------------------------------------------------------
# per-level LM loop
# ---------------------------------------------------------------------------


class LevelResult(NamedTuple):
    T: torch.Tensor  # (B,4,4) refined refToNew (rows (N, K) for N sequences)
    aff: torch.Tensor  # (B,2)
    res_per_point: torch.Tensor  # (B,) sqrt(E/num)
    flow_t: torch.Tensor
    flow_rt: torch.Tensor
    num_terms: torch.Tensor
    sat_frac: torch.Tensor  # (B,) saturation fraction at the final cutoff
    repeated: torch.Tensor  # (B,) bool


def _aff_transfer(ref_exposure, new_exposure, ref_aff, new_aff):
    """AffLight::fromToVecExposure; new_aff: (B, 2) -> (B, 2); for N
    sequences ref_aff (N, 2), exposures (N,), new_aff (N, K, 2)."""
    ref_exposure = torch.as_tensor(ref_exposure)[..., None]
    new_exposure = torch.as_tensor(new_exposure)[..., None]
    a = torch.exp(new_aff[..., 0] - ref_aff[..., 0, None]) * new_exposure / ref_exposure
    b = new_aff[..., 1] - a * ref_aff[..., 1, None]
    return torch.stack([a, b], dim=-1)


def _cutoff_rep_of(ar, inb, settings: Settings):
    """Closed-form while-doubling of levelCutoffRepeat: doubles while the
    saturated fraction exceeds 0.6 and rep < 50. ar, inb: (..., P)."""
    n = torch.clamp(torch.sum(inb, dim=-1), min=1)
    rep = torch.ones(ar.shape[:-1], dtype=torch.float32, device=ar.device)
    for _ in range(7):
        sat = torch.sum(inb & (ar > settings.coarse_cutoff_th * rep[..., None]), dim=-1) / n
        rep = torch.where((sat > 0.6) & (rep < 50.0), rep * 2.0, rep)
    return rep


def _energy_at_cutoff(ar, inb, cutoff, settings: Settings):
    """(energy, num_terms, sat_frac) at cutoff (...,) from |residual| (..., P)."""
    hw = _huber_w(ar, settings.huber_th)
    cut = cutoff[..., None]
    saturated = inb & (ar > cut)
    good = inb & ~saturated
    max_energy = 2.0 * settings.huber_th * cut - settings.huber_th**2
    e = torch.where(
        good, hw * ar * ar * (2.0 - hw),
        torch.where(saturated, max_energy.expand_as(ar), torch.zeros_like(ar)),
    )
    n = torch.sum(inb, dim=-1)
    return torch.sum(e, dim=-1), n, torch.sum(saturated, dim=-1) / torch.clamp(n, min=1)


def _bsel(mask, new, old):
    """Per-row select: mask (B,), tensors (B, ...) (rows of any rank)."""
    return torch.where(mask.reshape(mask.shape + (1,) * (new.ndim - mask.ndim)), new, old)


class LMProblem(NamedTuple):
    """What every LM trip of one level reads and none changes."""

    pc_u: torch.Tensor
    pc_v: torch.Tensor
    pc_idepth: torch.Tensor
    pc_color: torch.Tensor
    pc_ok: torch.Tensor
    dI_new: torch.Tensor
    K_lvl: torch.Tensor
    ref_aff: torch.Tensor
    ref_exposure: torch.Tensor
    new_exposure: torch.Tensor
    settings: Settings
    max_iterations: int


class LMCarry(NamedTuple):
    """The loop state of one level, per row; `lm_trip` updates it in place."""

    it: torch.Tensor  # (B,) int64 iterations of the current pass
    total: torch.Tensor  # (B,) int64 trips run
    T: torch.Tensor  # (B, 4, 4)
    aff: torch.Tensor  # (B, 2)
    E_old: torch.Tensor  # (B,)
    n_old: torch.Tensor  # (B,) int64
    lam: torch.Tensor  # (B,)
    Hm: torch.Tensor  # (B, 8, 8)
    bv: torch.Tensor  # (B, 8)
    cutoff: torch.Tensor  # (B,)
    ar: torch.Tensor  # (B, P) |residual| of the accepted pose
    inb: torch.Tensor  # (B, P)
    rep_pending: torch.Tensor  # (B,) bool
    done: torch.Tensor  # (B,) bool


_LAMBDA_EXTRAP_LIMIT = 0.001


def _lm_res(p: LMProblem, T, aff, cutoff, compute_flow=False):
    ab = _aff_transfer(p.ref_exposure, p.new_exposure, p.ref_aff, aff)
    return calc_res(
        p.pc_u, p.pc_v, p.pc_idepth, p.pc_color, p.pc_ok, p.dI_new, p.K_lvl, T, ab,
        cutoff, settings=p.settings, compute_flow=compute_flow,
    ), ab


def lm_init(p: LMProblem, T_init, aff_init, have_repeated):
    """The level's first residuals, cutoff and normal equations: (the
    carry, fresh tensors that alias no input; the rows' `repeated`)."""
    s = p.settings
    rows = tuple(T_init.shape[:-2])
    dev = T_init.device
    f32 = torch.float32
    stats_p, ab0 = _lm_res(p, T_init, aff_init, torch.full(rows, 1e30, dtype=f32, device=dev))
    ar0 = torch.abs(stats_p.buf_residual)
    inb0 = stats_p.buf_inb
    rep0 = _cutoff_rep_of(ar0, inb0, s)
    cutoff0 = s.coarse_cutoff_th * rep0
    stats0 = stats_p._replace(buf_ok=inb0 & (ar0 <= cutoff0[..., None]))
    E0, n0, _ = _energy_at_cutoff(ar0, inb0, cutoff0, s)
    H0, b0v = calc_gs(stats0, K_lvl=p.K_lvl, a_coeff=ab0[..., 0], b0=p.ref_aff[..., 1])
    rep_pending0 = (rep0 > 1.0) & ~have_repeated
    carry = LMCarry(
        it=torch.zeros(rows, dtype=torch.int64, device=dev),
        total=torch.zeros(rows, dtype=torch.int64, device=dev),
        T=T_init.clone(), aff=aff_init.clone(), E_old=E0, n_old=n0,
        lam=torch.full(rows, 0.01, dtype=f32, device=dev),
        Hm=H0, bv=b0v, cutoff=cutoff0, ar=ar0, inb=inb0,
        rep_pending=rep_pending0.clone(),
        done=torch.full(rows, p.max_iterations <= 0, dtype=torch.bool, device=dev),
    )
    return carry, rep_pending0


def _lm_solve(p: LMProblem, Hm, bv, lam):
    settings = p.settings
    rows = tuple(lam.shape)
    dev = lam.device
    opt_a = settings.affine_opt_mode_a >= 0
    opt_b = settings.affine_opt_mode_b >= 0
    Hl = Hm + torch.diag_embed(torch.diagonal(Hm, dim1=-2, dim2=-1)) * lam[..., None, None]
    if opt_a and opt_b:
        inc = cholesky_solve_small(Hl, -bv)
    elif not opt_a and not opt_b:
        inc6 = cholesky_solve_small(Hl[..., :6, :6], -bv[..., :6])
        inc = torch.cat([inc6, torch.zeros(rows + (2,), dtype=Hl.dtype, device=dev)], -1)
    elif opt_a and not opt_b:
        inc7 = cholesky_solve_small(Hl[..., :7, :7], -bv[..., :7])
        inc = torch.cat([inc7, torch.zeros(rows + (1,), dtype=Hl.dtype, device=dev)], -1)
    else:  # fix a, optimize b (stitch trick)
        idx = constant((0, 1, 2, 3, 4, 5, 7), torch.int64, dev)
        Hs = Hl[..., idx, :][..., idx]
        inc7 = cholesky_solve_small(Hs, -bv[..., idx])
        inc = torch.zeros(rows + (8,), dtype=Hl.dtype, device=dev)
        inc[..., :6] = inc7[..., :6]
        inc[..., 7] = inc7[..., 6]
    extrap = torch.where(
        lam < _LAMBDA_EXTRAP_LIMIT,
        torch.sqrt(torch.sqrt(_LAMBDA_EXTRAP_LIMIT / torch.clamp(lam, min=1e-12))),
        torch.ones_like(lam),
    )
    inc = inc * extrap[..., None]
    inc_scaled = inc * _precond_scale(Hm)
    fin = torch.isfinite(inc_scaled).all(dim=-1, keepdim=True)
    return torch.where(fin, inc_scaled, torch.zeros_like(inc_scaled)), inc


def lm_trip(p: LMProblem, c: LMCarry):
    """One LM iteration of every row that is not done, written into the
    carry in place; a row that is done keeps its carry (vmapped while_loop
    semantics), so a trip after every row is done changes nothing. On CUDA
    tensors one launch of the kernel (`lm_trip_cuda`), else the plain
    version (`lm_trip_ref`)."""
    if c.T.device.type == "cpu":
        lm_trip_ref(p, c)
    else:
        lm_trip_cuda(p, c)


def lm_trip_ref(p: LMProblem, c: LMCarry):
    """The plain PyTorch version of `lm_trip`, on any device."""
    s = p.settings
    max_iterations = p.max_iterations
    b_ref = p.ref_aff[..., 1]
    run = ~c.done
    inc_scaled, inc_raw = _lm_solve(p, c.Hm, c.bv, c.lam)
    T_new = se3.se3_exp(inc_scaled[..., :6]) @ c.T
    aff_new = c.aff + inc_scaled[..., 6:8]
    stats_new, ab_new = _lm_res(p, T_new, aff_new, c.cutoff)
    accept = (stats_new.energy / torch.clamp(stats_new.num_terms, min=1)) < (
        c.E_old / torch.clamp(c.n_old, min=1)
    )

    Hn, bn = calc_gs(stats_new, p.K_lvl, ab_new[..., 0], b_ref)
    T_out = _bsel(accept, T_new, c.T)
    aff_out = _bsel(accept, aff_new, c.aff)
    E_out = torch.where(accept, stats_new.energy, c.E_old)
    n_out = torch.where(accept, stats_new.num_terms, c.n_old)
    H_out = _bsel(accept, Hn, c.Hm)
    b_out = _bsel(accept, bn, c.bv)
    lam_out = torch.where(
        accept, c.lam * 0.5, torch.clamp(c.lam * 4.0, min=_LAMBDA_EXTRAP_LIMIT)
    )
    ar_out = _bsel(accept, torch.abs(stats_new.buf_residual), c.ar)
    inb_out = _bsel(accept, stats_new.buf_inb, c.inb)

    it1 = c.it + 1
    pass_end = (torch.linalg.norm(inc_raw, dim=-1) <= 1e-3) | (it1 >= max_iterations)
    do_rep = pass_end & c.rep_pending
    rep2 = _cutoff_rep_of(ar_out, inb_out, s)
    cutoff2 = s.coarse_cutoff_th * rep2
    E2, n2, _ = _energy_at_cutoff(ar_out, inb_out, cutoff2, s)
    it_out = torch.where(do_rep, torch.zeros_like(it1), it1)
    lam_out = torch.where(do_rep, torch.full_like(lam_out, 0.01), lam_out)
    cutoff_out = torch.where(do_rep, cutoff2, c.cutoff)
    E_out = torch.where(do_rep, E2, E_out)
    n_out = torch.where(do_rep, n2, n_out)
    done_out = (pass_end & ~do_rep) | (c.total + 1 >= 2 * max_iterations + 2)

    # every new value first, from the old carry; then the carry, in place
    new = LMCarry(
        it=torch.where(run, it_out, c.it),
        total=torch.where(run, c.total + 1, c.total),
        T=_bsel(run, T_out, c.T),
        aff=_bsel(run, aff_out, c.aff),
        E_old=torch.where(run, E_out, c.E_old),
        n_old=torch.where(run, n_out, c.n_old),
        lam=torch.where(run, lam_out, c.lam),
        Hm=_bsel(run, H_out, c.Hm),
        bv=_bsel(run, b_out, c.bv),
        cutoff=torch.where(run, cutoff_out, c.cutoff),
        ar=_bsel(run, ar_out, c.ar),
        inb=_bsel(run, inb_out, c.inb),
        rep_pending=torch.where(run, c.rep_pending & ~do_rep, c.rep_pending),
        done=torch.where(run, done_out, c.done),
    )
    for dst, src in zip(c, new):
        dst.copy_(src)


def lm_final(p: LMProblem, c: LMCarry, repeated) -> LevelResult:
    """The level's result from the final carry."""
    _, _, sat_f = _energy_at_cutoff(c.ar, c.inb, c.cutoff, p.settings)
    stats_f, _ = _lm_res(p, c.T, c.aff, c.cutoff, compute_flow=True)
    return LevelResult(
        T=c.T,
        aff=c.aff,
        res_per_point=torch.sqrt(c.E_old / torch.clamp(c.n_old, min=1)),
        flow_t=stats_f.flow_t,
        flow_rt=stats_f.flow_rt,
        num_terms=c.n_old,
        sat_frac=sat_f,
        repeated=repeated,
    )


def lm_level(
    pc_u, pc_v, pc_idepth, pc_color, pc_ok, dI_new, K_lvl,
    T_init,  # (K, 4, 4), or (N, K, 4, 4) for N sequences
    aff_init,  # (K, 2) / (N, K, 2)
    ref_aff,  # (2,) / (N, 2)
    ref_exposure,  # () / (N,)
    new_exposure,  # () / (N,)
    have_repeated,  # (K,) / (N, K) bool
    settings: Settings = default_settings(),
    max_iterations: int = 10,
) -> LevelResult:
    """One pyramid level of the tracker's LM (legacy loop), including the
    cutoff-repeat machinery, for K hypotheses of one sequence or of each of
    N sequences (see module docstring): `lm_init`, then `lm_trip` until
    every row is done (`utils/loop.while_loop`: a host loop eagerly, a WHILE
    node in a captured program; at most 2 * max_iterations + 2 trips),
    then `lm_final`."""
    p = LMProblem(pc_u, pc_v, pc_idepth, pc_color, pc_ok, dI_new, K_lvl, ref_aff,
                  ref_exposure, new_exposure, settings, max_iterations)
    carry, repeated = lm_init(p, T_init, aff_init, have_repeated)
    loop.while_loop(carry.done, lambda: lm_trip(p, carry), 2 * max_iterations + 2,
                    name="track.lm")
    return lm_final(p, carry, repeated)


# ---------------------------------------------------------------------------
# the LM trip kernel (csrc/lm_trip.cu)
# ---------------------------------------------------------------------------

# Launches of the kernel since the last reset_trip_launches(): an eager
# launch adds one here on the host; a launch captured into a program
# (runtime/program.py) hands the kernel the device's counter, which the
# kernel itself increments each time the graph, or the node's body around
# it, runs.
_TRIP_EAGER = [0]
_TRIP_COUNTERS = {}  # device -> () int64
_TRIP_FN = []
_TRIP_POINTERS = (
    "pc_u", "pc_v", "pc_idepth", "pc_color", "pc_ok", "dI", "K", "ref_aff", "ref_exposure",
    "new_exposure", "it", "total", "T", "aff", "E_old", "n_old", "lam", "Hm", "bv", "cutoff", "ar",
    "inb", "rep_pending", "done", "launches")


class TripArgs(ctypes.Structure):
    """csrc/lm_trip.cu's `LmArgs`: the operands' addresses, shapes, settings."""

    _fields_ = ([(k, ctypes.c_void_p) for k in _TRIP_POINTERS]
                + [(k, ctypes.c_int) for k in ("n_seq", "rows_per_seq", "P", "H", "W", "opt_a",
                                              "opt_b", "max_iterations")]
                + [(k, ctypes.c_float) for k in ("huber_th", "two_huber_th", "huber_th_sq",
                                                "cutoff_th")]
                + [("scale", ctypes.c_float * 8), ("ar_stride", ctypes.c_longlong * 3)])


def _card(device) -> torch.device:
    device = torch.device(device)
    return torch.device("cuda", torch.cuda.current_device()) if device.index is None else device


def trip_counter(device) -> torch.Tensor:
    """The () int64 counter of `device` that captured launches increment;
    a program makes it before it captures (a capture allocates in its own
    pool)."""
    device = _card(device)
    c = _TRIP_COUNTERS.get(device)
    if c is None:
        c = _TRIP_COUNTERS[device] = torch.zeros((), dtype=torch.int64, device=device)
    return c


def trip_launches(split: bool = False):
    """Kernel launches the devices ran since the last reset_trip_launches():
    the eager ones and the captured ones that ran, or (eager, captured)
    with `split` (reads the counters: waits for the device)."""
    captured = sum(int(c.item()) for c in _TRIP_COUNTERS.values())
    return (_TRIP_EAGER[0], captured) if split else _TRIP_EAGER[0] + captured


def reset_trip_launches():
    _TRIP_EAGER[0] = 0
    for c in _TRIP_COUNTERS.values():
        c.zero_()


def _trip_fn():
    """The kernel's C entry point `sdso_lm_trip`, built at first use."""
    if not _TRIP_FN:
        from stereo_dso_g2o_tpu_torch.ops import trace_cuda

        fn = ctypes.CDLL(str(trace_cuda.build(["lm_trip"])["lm_trip"])).sdso_lm_trip
        fn.argtypes = [ctypes.POINTER(TripArgs), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _TRIP_FN.append(fn)
    return _TRIP_FN[0]


def _dense(x: torch.Tensor) -> bool:
    """Every element of `x` in a place of its own, and nothing between."""
    order = sorted((st, sz) for st, sz in zip(x.stride(), x.shape) if sz > 1)
    want = 1
    for st, sz in order:
        if st != want:
            return False
        want *= sz
    return True


def _per_seq(x, n_seq: int, tail: tuple, like: torch.Tensor) -> torch.Tensor:
    """A problem operand as a contiguous (n_seq, *tail) float32 tensor on
    `like`'s device: a number becomes a constant, one sequence's operand is
    the batch of one, a broadcast one is expanded."""
    if not isinstance(x, torch.Tensor):
        x = constant(float(x), torch.float32, like.device)
    if x.dtype != torch.float32 or x.device != like.device:
        raise TypeError(f"a problem operand is {x.dtype} on {x.device}, not float32 on "
                        f"{like.device}")
    return x.expand((n_seq,) + tail).contiguous()


def trip_args(p: LMProblem, c: LMCarry, launches: int = 0):
    """(`TripArgs` of one trip, the tensors it points at) for the carry `c`
    of the problem `p`, laid out as the plain version's operands: rows
    (K,) of one sequence, or (N, K) of N sequences. Raises on what the
    kernel does not take. `launches`: the counter's address, or 0."""
    rows = tuple(c.T.shape[:-2])
    batched = p.pc_u.dim() == 2
    if len(rows) != 1 + batched or not rows[-1]:
        raise ValueError(f"carry rows {rows} for points {tuple(p.pc_u.shape)}")
    n_seq, per_seq, P = (p.pc_u.shape[0] if batched else 1), rows[-1], p.pc_u.shape[-1]
    if batched and rows[0] != n_seq:
        raise ValueError(f"carry rows {rows} for {n_seq} sequences")
    if p.dI_new.dim() != 3 + batched or p.dI_new.shape[-1] != 3:
        raise ValueError(f"image {tuple(p.dI_new.shape)} for points {tuple(p.pc_u.shape)}")
    H, W = p.dI_new.shape[-3:-1]
    dev = c.T.device
    want = {"it": ((), torch.int64), "total": ((), torch.int64), "T": ((4, 4), torch.float32),
            "aff": ((2,), torch.float32), "E_old": ((), torch.float32),
            "n_old": ((), torch.int64), "lam": ((), torch.float32),
            "Hm": ((8, 8), torch.float32), "bv": ((8,), torch.float32),
            "cutoff": ((), torch.float32), "ar": ((P,), torch.float32),
            "inb": ((P,), torch.bool), "rep_pending": ((), torch.bool),
            "done": ((), torch.bool)}
    ptrs = {}
    for name, (tail, dtype) in want.items():
        x = getattr(c, name)
        if tuple(x.shape) != rows + tail or x.dtype != dtype or x.device != dev:
            raise ValueError(f"carry {name}: {tuple(x.shape)} {x.dtype} on {x.device}, want "
                             f"{rows + tail} {dtype} on {dev}")
        if name not in ("ar", "inb") and not x.is_contiguous():
            raise ValueError(f"carry {name} must be contiguous (the trip writes it in place)")
        ptrs[name] = x.data_ptr()
    # |r| and the flags as the plain version lays them out: any strides,
    # the same for both where a dimension has more than one entry (the
    # index of the others is 0), no two points of the carry in one place
    strides = ((0,) * (not batched)) + tuple(c.ar.stride())
    same = all(a == b or n == 1 for a, b, n in zip(c.ar.stride(), c.inb.stride(), c.ar.shape))
    if not same or not _dense(c.ar):
        raise ValueError(f"carry ar, inb: strides {c.ar.stride()}, {c.inb.stride()} for shape "
                         f"{tuple(c.ar.shape)}")
    keep = {
        "pc_u": _per_seq(p.pc_u, n_seq, (P,), c.T), "pc_v": _per_seq(p.pc_v, n_seq, (P,), c.T),
        "pc_idepth": _per_seq(p.pc_idepth, n_seq, (P,), c.T),
        "pc_color": _per_seq(p.pc_color, n_seq, (P,), c.T),
        "dI": _per_seq(p.dI_new, n_seq, (H, W, 3), c.T),
        "K": _per_seq(p.K_lvl, n_seq, (4,), c.T), "ref_aff": _per_seq(p.ref_aff, n_seq, (2,), c.T),
        "ref_exposure": _per_seq(p.ref_exposure, n_seq, (), c.T),
        "new_exposure": _per_seq(p.new_exposure, n_seq, (), c.T),
    }
    if p.pc_ok.dtype != torch.bool or p.pc_ok.device != dev:
        raise TypeError(f"pc_ok is {p.pc_ok.dtype} on {p.pc_ok.device}, not bool on {dev}")
    keep["pc_ok"] = p.pc_ok.expand((n_seq, P)).contiguous()
    ptrs.update({k: v.data_ptr() for k, v in keep.items()})
    s = p.settings
    args = TripArgs(
        **ptrs, launches=launches or None, n_seq=n_seq, rows_per_seq=per_seq, P=P, H=H, W=W,
        opt_a=int(s.affine_opt_mode_a >= 0), opt_b=int(s.affine_opt_mode_b >= 0),
        max_iterations=p.max_iterations, huber_th=s.huber_th, two_huber_th=2.0 * s.huber_th,
        huber_th_sq=s.huber_th**2, cutoff_th=s.coarse_cutoff_th,
        scale=(ctypes.c_float * 8)(*((SCALE_XI_ROT,) * 3 + (SCALE_XI_TRANS,) * 3
                                     + (SCALE_A, SCALE_B))),
        ar_stride=(ctypes.c_longlong * 3)(*strides))
    return args, keep


def lm_trip_cuda(p: LMProblem, c: LMCarry):
    """`lm_trip` as one launch of csrc/lm_trip.cu on the current stream of
    the carry's device (a block per row); raises if the launch fails."""
    dev = c.T.device
    if torch.cuda.is_current_stream_capturing():
        counter = _TRIP_COUNTERS.get(_card(dev))
        if counter is None:
            raise RuntimeError(f"no trip counter on {dev}: call trip_counter() before capturing")
        args, _keep = trip_args(p, c, counter.data_ptr())
    else:
        args, _keep = trip_args(p, c)
        _TRIP_EAGER[0] += 1
    fn = _trip_fn()
    with torch.cuda.device(dev):
        rc = fn(ctypes.byref(args), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"lm_trip kernel launch failed: cudaError {rc}")


class TripBound(NamedTuple):
    bytes: float  # each operand read once, the carry written once
    ops: float  # f32 operations these rows need
    ms: float  # the larger of the two over the card's peaks
    by: str  # "bytes" or "operations"


def trip_bound(n_seq: int, per_seq: int, P: int, H: int, W: int) -> TripBound:
    """The least time the card could take for one trip of n_seq * per_seq
    rows of P points on (H, W) images: bytes, each once, over the memory
    rate (a sequence's 17 bytes a point, a row's four 12-byte taps a point
    up to its image's pixels, |r| and the in-bounds flag written), against
    the operations over the f32 peak (~240 a point-row: the warp 30, the
    sample 40, residual, weight and energy 15, the Jacobian 25, the 44
    sums 97, the rest; ~1000 a row for the solve and the pose)."""
    from stereo_dso_g2o_tpu_torch.ops.trace_cuda import F32_FLOP_PER_S, HBM_BYTES_PER_S

    rows = n_seq * per_seq
    nbytes = n_seq * P * 17 + rows * (12 * min(4 * P, H * W) + 5 * P + 4 * (16 + 64 + 8 + 12))
    flops = rows * (240 * P + 1000)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return TripBound(nbytes, flops, 1000.0 * max(t_bytes, t_ops),
                     "bytes" if t_bytes >= t_ops else "operations")
