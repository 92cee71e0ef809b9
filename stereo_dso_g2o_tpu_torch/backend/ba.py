"""Windowed photometric bundle adjustment with FEJ + marginalization.

Port of `stereo_dso_g2o_tpu/backend/ba.py` (the reference's legacy DSO
solver): host/target adjoints, H/b assembly in active (A), prior (L) and
Schur (SC) parts as one-hot-host contractions over the [NP, F] residual
cube, the marginal prior HM/bM, the preconditioned fixed-lambda solve with
late nullspace orthogonalization, back-substitution of the point steps,
point marginalization into HM/bM and slot-indexed frame marginalization.
The JAX `lax.while_loop` of `optimize_fused` is `utils/loop.while_loop`
(a WHILE node inside a captured program, a host loop eagerly) with the
same early exit, and its masked `fori_loop` over the flagged frames one
`utils/loop.cond` per slot.

The JAX functions take `axis_name=` and `psum` over it when the point axis
is sharded; here they take `reduce=`, a callable that sums a tensor over
the shards (`parallel/dist_ba.py` passes an all-reduce), applied at the
same places: the pair-block sums before the replicated priors are added,
the residual count, the Schur part, the active-point count and idepth sum
of the convergence test, and the energy. `None` is the one-shard path.

Every function also takes a window stacked over N sequences (each leaf with
a leading axis N, image stacks (N, F, H, W, 3), slots (N,)), as the JAX
package's batched keyframe program vmaps them: each op runs once for all
sequences, and the products that sum over a sequence's points run one per
sequence (`_per_seq`), so that a sequence's bits are the same alone and in
a batch. One window is the unbatched code it always was.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from stereo_dso_g2o_tpu_torch.backend import window as W
from stereo_dso_g2o_tpu_torch.config import (
    CPARS,
    SCALE_A,
    SCALE_B,
    SCALE_C,
    SCALE_F,
    SCALE_XI_ROT,
    SCALE_XI_TRANS,
    Settings,
    default_settings,
)
from stereo_dso_g2o_tpu_torch.ops import residuals as R
from stereo_dso_g2o_tpu_torch.utils import loop, se3
from stereo_dso_g2o_tpu_torch.utils.fixed import constant
from stereo_dso_g2o_tpu_torch.utils.tree import at_index, leaves, per_row, select_rows, tree_map

C_SCALE = np.asarray([SCALE_F, SCALE_F, SCALE_C, SCALE_C], dtype=np.float32)


def _c_scale(win):
    return constant(C_SCALE, torch.float32, win.device)


def _row_scale(win):
    return constant([SCALE_XI_TRANS] * 3 + [SCALE_XI_ROT] * 3 + [SCALE_A, SCALE_B],
                    win.state.dtype, win.device)


def _lead(win: W.Window):
    """() for one window, (N,) for a window stacked over N sequences."""
    return tuple(win.frame_valid.shape[:-1])


def _per_seq(fn, win: W.Window, *xs):
    """fn(*xs) for one window; for a stacked window, fn on each sequence's
    rows, stacked (`utils/tree.per_row`): the products that sum over the
    point axis, the solve, and the long sums, whose rounding would depend
    on the batch (on the card a long sum splits over blocks by how many
    sums run beside it, and a batched LU takes another algorithm than a
    single one). A sequence's bits are the same alone and in a batch of any
    size."""
    return per_row(fn, bool(_lead(win)), *xs)


def _ein(win: W.Window, eq: str, *ops):
    """torch.einsum(eq, *ops) of one window, per sequence for a stacked one
    (`_per_seq`): every product of the BA rounds as one sequence's alone."""
    return _per_seq(lambda *o: torch.einsum(eq, *o), win, *ops)


# ---------------------------------------------------------------------------
# adjoints & deltas
# ---------------------------------------------------------------------------


def adjoints(win: W.Window):
    """adHost/adTarget per (host, target) pair (setAdjointsF)."""
    ev = win.evalPT
    T_th = _ein(win, "tij,hjk->htik", ev, se3.inverse(ev))
    Adj = se3.adjoint(T_th)
    F = win.F
    dt, dev = ev.dtype, ev.device
    lead = _lead(win)
    AH = torch.zeros(lead + (F, F, 8, 8), dtype=dt, device=dev)
    AT = torch.zeros(lead + (F, F, 8, 8), dtype=dt, device=dev)
    AH[..., :6, :6] = -torch.swapaxes(Adj, -1, -2)
    AT[..., :6, :6] = torch.eye(6, dtype=dt, device=dev)

    aff0 = win.aff_g2l_0()
    affLL = W.aff_transfer(
        win.ab_exposure[..., :, None], win.ab_exposure[..., None, :],
        aff0[..., :, None, :], aff0[..., None, :, :],
    )
    a = affLL[..., 0]
    AT[..., 6, 6] = -a
    AT[..., 7, 7].fill_(-1.0)
    AH[..., 6, 6] = a
    AH[..., 7, 7] = a

    rs = _row_scale(win)
    return AH * rs[:, None], AT * rs[:, None]


def deltas(win: W.Window):
    """Frame/calib/point deltas from the FEJ point (setDeltaF)."""
    d_frame = win.state - win.state_zero
    dc = (win.c_value - win.c_zero) / _c_scale(win)
    d_pt = win.pt_idepth - win.pt_idepth_zero
    return d_frame, dc, d_pt


def ht_delta(win: W.Window, AH, AT, d_frame):
    """adHTdeltaF: per-pair relative 8-dof delta row vectors."""
    return _ein(win, "hi,htij->htj", d_frame, AH) + _ein(win, "ti,htij->htj", d_frame, AT
    )


def stitched_delta(win: W.Window, d_frame, dc):
    """getStitchedDeltaF: (D,) = [dc, d_frame_0, ..., d_frame_{F-1}]."""
    return torch.cat([dc, d_frame.flatten(-2)], -1)


def frame_priors(win: W.Window, settings: Settings):
    """FrameHessian::getPrior, per slot."""
    F = win.F
    first = win.frame_id == 0
    p = torch.zeros(_lead(win) + (F, 8), dtype=win.state.dtype, device=win.device)
    a_other = (settings.initial_aff_a_prior if settings.affine_opt_mode_a < 0
               else settings.affine_opt_mode_a)
    b_other = (settings.initial_aff_b_prior if settings.affine_opt_mode_b < 0
               else settings.affine_opt_mode_b)
    p[..., 6] = torch.where(first, torch.full_like(p[..., 6], settings.initial_aff_a_prior),
                            torch.full_like(p[..., 6], a_other))
    p[..., 7] = torch.where(first, torch.full_like(p[..., 7], settings.initial_aff_b_prior),
                            torch.full_like(p[..., 7], b_other))
    zero = torch.zeros_like(p[..., 0:3])
    first3 = first[..., None]
    p[..., 0:3] = torch.where(first3, torch.full_like(zero, settings.initial_trans_prior), zero)
    p[..., 3:6] = torch.where(first3, torch.full_like(zero, settings.initial_rot_prior), zero)
    return p * win.frame_valid[..., None]


# ---------------------------------------------------------------------------
# accumulation
# ---------------------------------------------------------------------------


class Accum(NamedTuple):
    H: torch.Tensor  # (D, D)
    b: torch.Tensor  # (D,)
    Hdd: torch.Tensor  # (NP,)
    bd: torch.Tensor  # (NP,)
    Hcd: torch.Tensor  # (NP, 4)
    nres: torch.Tensor  # ()


def _jp_delta(win: W.Window, dp, dc, d_pt):
    """Jp * delta along x and y of every residual: (NP, F) each."""
    def along(k):
        return (
            _ein(win, "nfk,nfk->nf",
                     win.J_pdxi[..., k, :], dp[..., :6])
            + _ein(win, "nfk,k->nf", win.J_pdc[..., k, :], dc)
            + win.J_pdd[..., k] * d_pt[..., None]
        )

    return along(0), along(1)


def _res_approx(win: W.Window, mode: int, dp, dc, d_pt):
    """resApprox per mode, from the accepted Jacobians."""
    if mode == 0:
        return win.J_resF
    if mode == 2:
        return win.res_to_zero
    Jp_dx, Jp_dy = _jp_delta(win, dp, dc, d_pt)
    return (
        win.res_to_zero
        + win.J_Idx[..., 0, :] * Jp_dx[..., None]
        + win.J_Idx[..., 1, :] * Jp_dy[..., None]
        + win.J_abF[..., 0, :] * dp[..., 6][..., None]
        + win.J_abF[..., 1, :] * dp[..., 7][..., None]
    )


def _onehot_host(win, dtype):
    F = win.F
    return (
        win.pt_host[..., None].long() == torch.arange(F, device=win.device)
    ).to(dtype)


def accumulate_top(win: W.Window, AH, AT, mask, mode: int, settings: Settings,
                   use_prior: bool, reduce=None):
    """AccumulatedTopHessianSSE::addPoint<mode> + stitchDouble."""
    F = win.F
    dtype = win.state.dtype
    dev = win.device
    lead = _lead(win)
    d_frame, dc, d_pt = deltas(win)
    dp = R.by_host(ht_delta(win, AH, AT, d_frame), win)  # (NP, F, 8)

    resA = _res_approx(win, mode, dp, dc, d_pt)
    m = mask.to(dtype)

    JIdx = win.J_Idx
    JabF = win.J_abF
    Jpdxi = win.J_pdxi
    Jpdc = win.J_pdc
    Jpdd = win.J_pdd

    JI_r = _ein(win, "nfp,nfkp->nfk", resA, JIdx)
    JIdx2 = _ein(win, "nfip,nfjp->nfij", JIdx, JIdx)

    G = torch.cat([Jpdc, Jpdxi], dim=-1)  # (NP, F, 2, 10)
    u10 = _ein(win, "nfip,nfia->nfpa", JIdx, G)  # (NP, F, 8, 10)
    V = torch.cat([u10, torch.swapaxes(JabF, -1, -2), resA[..., None]], dim=-1)

    onehot = _onehot_host(win, dtype)
    Vm = V * m[..., None, None]
    # pair[h, f] = sum_n onehot[n, h] * sum_p Vm[n,f,p,:]^T V[n,f,p,:]
    per = _ein(win, "nfpa,nfpb->nfab", Vm, V)  # (NP, F, 13, 13)
    pair = _ein(win, "nh,nfab->hfab", onehot, per)

    A8 = pair[..., 4:12, 4:12]
    Ac = pair[..., 4:12, 0:4]
    Acc = _per_seq(lambda q: torch.sum(q[..., 0:4, 0:4], dim=(0, 1)), win, pair)
    br = pair[..., 4:12, 12]
    bc = _per_seq(lambda q: torch.sum(q[..., 0:4, 12], dim=(0, 1)), win, pair)

    eyeF = torch.eye(F, dtype=dtype, device=dev)
    Hoff = _ein(win, "htab,htbc,htdc->htad", AH, A8, AT)
    Hsym = Hoff + torch.swapaxes(torch.swapaxes(Hoff, -4, -3), -1, -2)
    Hsym = Hsym * (1.0 - eyeF)[:, :, None, None]
    diag_h = _ein(win, "htab,htbc,htdc->had", AH, A8, AH)
    diag_t = _ein(win, "htab,htbc,htdc->tad", AT, A8, AT)

    D = CPARS + 8 * F
    Hout = torch.zeros(lead + (D, D), dtype=dtype, device=dev)
    bout = torch.zeros(lead + (D,), dtype=dtype, device=dev)

    Hff_total = Hsym + _per_seq(lambda d: torch.einsum("had,ht->htad", d, eyeF), win,
                                diag_h + diag_t)
    Hout[..., CPARS:, CPARS:] = Hff_total.transpose(-3, -2).reshape(lead + (8 * F, 8 * F))
    Hfc = _ein(win, "htab,htbc->hac", AH, Ac) + _ein(win, "htab,htbc->tac", AT, Ac)
    Hout[..., CPARS:, :CPARS] = Hfc.reshape(lead + (8 * F, CPARS))
    Hout[..., :CPARS, CPARS:] = Hfc.reshape(lead + (8 * F, CPARS)).transpose(-1, -2)
    Hout[..., :CPARS, :CPARS] = Acc

    bf = _ein(win, "htab,htb->ha", AH, br) + _ein(win, "htab,htb->ta", AT, br)
    bout[..., CPARS:] = bf.flatten(-2)
    bout[..., :CPARS] = bc

    if reduce is not None:
        # the pair-block sums are partial over the local point shard: summed
        # over the shards before the (replicated) priors go in, once
        Hout = reduce(Hout)
        bout = reduce(bout)

    if use_prior:
        prior_f = frame_priors(win, settings)
        d_prior = win.state
        ci = torch.arange(CPARS, device=dev)
        Hout[..., ci, ci] += settings.initial_calib_hessian
        bout[..., :CPARS] += settings.initial_calib_hessian * dc
        idx = CPARS + torch.arange(8 * F, device=dev)
        Hout[..., idx, idx] += prior_f.flatten(-2)
        bout[..., CPARS:] += (prior_f * d_prior).flatten(-2)

    JJd = _ein(win, "nfij,nfj->nfi", JIdx2, Jpdd)
    bd = torch.sum(m * _ein(win, "nfi,nfi->nf", JI_r, Jpdd), dim=-1)
    Hdd = torch.sum(m * _ein(win, "nfi,nfi->nf", JJd, Jpdd), dim=-1)
    Hcd = torch.sum(
        m[..., None]
        * (Jpdc[..., 0, :] * JJd[..., 0, None] + Jpdc[..., 1, :] * JJd[..., 1, None]),
        dim=-2,
    )
    nres = torch.sum(mask, dim=(-2, -1))
    if reduce is not None:
        nres = reduce(nres)
    return Accum(H=Hout, b=bout, Hdd=Hdd, bd=bd, Hcd=Hcd, nres=nres)


def point_prior(win: W.Window, settings: Settings, marg_fac=None):
    """EFPoint::priorF."""
    p = torch.where(
        win.pt_has_prior,
        torch.full_like(win.pt_idepth, settings.idepth_fix_prior),
        torch.zeros_like(win.pt_idepth),
    )
    if marg_fac is not None:
        p = p * marg_fac
    return p


class Schur(NamedTuple):
    H: torch.Tensor
    b: torch.Tensor
    HdiF: torch.Tensor  # (NP,)
    bdSum: torch.Tensor  # (NP,)
    Hcd: torch.Tensor  # (NP, 4)
    JpJdF: torch.Tensor  # (NP, F, 8)
    idepth_hessian: torch.Tensor  # (NP,)


def accumulate_sc(win: W.Window, AH, AT, active, acc: Accum, prior_pt,
                  shift_prior_to_zero: bool, reduce=None):
    """AccumulatedSCHessianSSE::addPoint + stitchDouble."""
    F = win.F
    dtype = win.state.dtype
    dev = win.device
    lead = _lead(win)
    _, _, d_pt = deltas(win)

    ngood = torch.sum(active, dim=-1)
    has = ngood > 0

    Hdd = torch.clamp(acc.Hdd + prior_pt, min=1e-10)
    zero = torch.zeros_like(Hdd)
    idepth_hessian = torch.where(has, Hdd, zero)
    HdiF = torch.where(has, 1.0 / Hdd, zero)
    bdSum = acc.bd
    if shift_prior_to_zero:
        bdSum = bdSum + prior_pt * d_pt
    bdSum = torch.where(has, bdSum, zero)
    Hcd = torch.where(has[..., None], acc.Hcd, torch.zeros_like(acc.Hcd))

    JIdx2 = _ein(win, "nfip,nfjp->nfij", win.J_Idx, win.J_Idx)
    JJd = _ein(win, "nfij,nfj->nfi", JIdx2, win.J_pdd)
    JabJIdx = _ein(win, "nfip,nfjp->nfij", win.J_abF, win.J_Idx)
    JpJd_pose = _ein(win, "nfki,nfk->nfi", win.J_pdxi, JJd)
    JpJd_ab = _ein(win, "nfij,nfj->nfi", JabJIdx, win.J_pdd)
    JpJdF = torch.cat([JpJd_pose, JpJd_ab], dim=-1) * active[..., None]

    D = CPARS + 8 * F
    Hout = torch.zeros(lead + (D, D), dtype=dtype, device=dev)
    bout = torch.zeros(lead + (D,), dtype=dtype, device=dev)

    Hout[..., :CPARS, :CPARS] = _ein(win, "ni,nj->ij", Hcd * HdiF[..., None], Hcd)
    bout[..., :CPARS] = _ein(win, "ni,n->i", Hcd, bdSum * HdiF)

    onehot = _onehot_host(win, dtype)
    X = JpJdF.flatten(-2)
    Xw = X * HdiF[..., None]
    Dflat = _ein(win, "nh,na,nb->hab", onehot, Xw, X)
    Dacc = Dflat.reshape(lead + (F, F, 8, F, 8)).transpose(-3, -2)
    Eacc = _ein(win, "nh,nti,nj->htij",
                    onehot, JpJdF, Hcd * HdiF[..., None])
    EBacc = _ein(win, "nh,nti,n->hti",
                     onehot, JpJdF, HdiF * bdSum)

    Hfc = _ein(win, "ijab,ijbc->iac", AH, Eacc) + _ein(win, "ijab,ijbc->jac", AT, Eacc)
    Hout[..., CPARS:, :CPARS] += Hfc.reshape(lead + (8 * F, CPARS))
    Hout[..., :CPARS, CPARS:] += Hfc.reshape(lead + (8 * F, CPARS)).transpose(-1, -2)
    bf = _ein(win, "ijab,ijb->ia", AH, EBacc) + _ein(win, "ijab,ijb->ja", AT, EBacc)
    bout[..., CPARS:] += bf.flatten(-2)

    eyeF = torch.eye(F, dtype=dtype, device=dev)
    t1 = _ein(win, "ijab,ijkbc,ikdc->iad", AH, Dacc, AH)
    Hff = _per_seq(lambda d: torch.einsum("iad,ij->ijad", d, eyeF), win, t1)
    Hff = Hff + _ein(win, "ijab,ijkbc,ikdc->jkad", AT, Dacc, AT)
    Hff = Hff + _ein(win, "ijab,ijkbc,ikdc->jiad", AT, Dacc, AH)
    Hff = Hff + _ein(win, "ijab,ijkbc,ikdc->ikad", AH, Dacc, AT)
    Hout[..., CPARS:, CPARS:] += Hff.transpose(-3, -2).reshape(lead + (8 * F, 8 * F))
    if reduce is not None:
        Hout = reduce(Hout)
        bout = reduce(bout)
    return Schur(H=Hout, b=bout, HdiF=HdiF, bdSum=bdSum, Hcd=Hcd, JpJdF=JpJdF,
                 idepth_hessian=idepth_hessian)


# ---------------------------------------------------------------------------
# nullspaces & orthogonalization
# ---------------------------------------------------------------------------


def nullspaces(win: W.Window):
    """Gauge nullspace columns N (D, 7): 6 pose + 1 scale."""
    F = win.F
    dtype, dev = win.state.dtype, win.device
    lead = _lead(win)
    Adj = se3.adjoint(win.evalPT)
    t = win.evalPT[..., :3, 3]
    inv_scale = constant([1.0 / SCALE_XI_TRANS] * 3 + [1.0 / SCALE_XI_ROT] * 3, dtype, dev)
    zc = torch.zeros(lead + (CPARS,), dtype=dtype, device=dev)
    valid = win.frame_valid[..., None]
    cols = []
    for i in range(6):
        n = torch.zeros(lead + (F, 8), dtype=dtype, device=dev)
        n[..., :6] = Adj[..., :, i] * inv_scale
        cols.append(torch.cat([zc, (n * valid).flatten(-2)], -1))
    n = torch.zeros(lead + (F, 8), dtype=dtype, device=dev)
    n[..., :3] = t * (1.0 / SCALE_XI_TRANS)
    cols.append(torch.cat([zc, (n * valid).flatten(-2)], -1))
    return torch.stack(cols, dim=-1)


def orthogonalize(x, N):
    """Remove nullspace components: x - N (N^T N)^-1 N^T x."""
    norms = torch.linalg.norm(N, dim=0, keepdim=True)
    Nn = N / torch.clamp(norms, min=1e-12)
    NtN = Nn.T @ Nn
    eye = torch.eye(NtN.shape[0], dtype=N.dtype, device=N.device)
    coef = _solve(NtN + 1e-10 * eye, Nn.T @ x)
    return x - Nn @ coef


# ---------------------------------------------------------------------------
# solve + resubstitute
# ---------------------------------------------------------------------------


class SolveOut(NamedTuple):
    x: torch.Tensor  # (D,)
    step_c: torch.Tensor  # (4,)
    step_f: torch.Tensor  # (F, 8)
    step_pt: torch.Tensor  # (NP,)


def _solve(A, b):
    """torch.linalg.solve(A, b) of a vector b with no error check (no wait
    for the device; a singular system gives non-finite values, which the
    caller zeroes). On the card b is the first column of a square
    right-hand side: one right-hand column of 16 rows or more takes a path
    there that allocates through the stream-ordered allocator, which the
    body of a WHILE or IF node cannot hold; a square one takes the path of
    `inv_ex`, which does not (NVIDIA H100, PyTorch 2.11)."""
    if not A.is_cuda:
        return torch.linalg.solve_ex(A, b, check_errors=False).result
    n = A.shape[-1]
    B = torch.cat([b[..., None], b.new_zeros(tuple(b.shape) + (n - 1,))], -1)
    return torch.linalg.solve_ex(A, B, check_errors=False).result[..., 0]


def solve_system(win: W.Window, acc_A: Accum, sc: Schur, settings: Settings,
                 iteration, lam=1e-5, do_orth=True):
    F = win.F
    D = CPARS + 8 * F
    dev = win.device
    lead = _lead(win)
    d_frame, dc, _ = deltas(win)

    bM_top = win.bM + _per_seq(torch.matmul, win, win.HM, stitched_delta(win, d_frame, dc))
    HFinal = acc_A.H + win.HM
    bFinal = acc_A.b + bM_top - sc.b

    diag = torch.arange(D, device=dev)
    HFinal = HFinal.clone()
    HFinal[..., diag, diag] = HFinal[..., diag, diag] * (1.0 + lam)
    HFinal = HFinal - sc.H * (1.0 / (1.0 + lam))

    slot_active = torch.cat(
        [torch.ones(lead + (CPARS,), dtype=torch.bool, device=dev),
         torch.repeat_interleave(win.frame_valid, 8, dim=-1)], -1
    )
    HFinal = torch.where(
        slot_active[..., :, None] & slot_active[..., None, :], HFinal, torch.zeros_like(HFinal)
    )
    HFinal[..., diag, diag] += torch.where(slot_active, 0.0, 1.0)
    bFinal = torch.where(slot_active, bFinal, torch.zeros_like(bFinal))

    # zero-information dimensions are unit-pinned (zero step), not solved
    no_info = torch.abs(HFinal[..., diag, diag]) < 1e-6
    HFinal[..., diag, diag] += torch.where(no_info, 1.0, 0.0)
    bFinal = torch.where(no_info, torch.zeros_like(bFinal), bFinal)

    SVecI = 1.0 / torch.sqrt(torch.abs(HFinal[..., diag, diag]) + 10.0)
    Hs = SVecI[..., :, None] * HFinal * SVecI[..., None, :]
    bs = SVecI * bFinal
    xs = _per_seq(_solve, win, Hs, bs)
    x = SVecI * xs

    # `iteration`: an int, or a () tensor inside BA's device loop (the JAX
    # package's `jnp.where(iteration >= 2, x_orth, x)`)
    if do_orth and isinstance(iteration, torch.Tensor):
        x = torch.where(iteration >= 2, _per_seq(orthogonalize, win, x, nullspaces(win)), x)
    elif do_orth and iteration >= 2:
        x = _per_seq(orthogonalize, win, x, nullspaces(win))

    # a non-finite solve must not poison the window state
    x = torch.where(torch.isfinite(x).all(-1, keepdim=True), x, torch.zeros_like(x))

    step_c = -x[..., :CPARS]
    step_f = -x[..., CPARS:].reshape(lead + (F, 8)) * win.frame_valid[..., None]

    AH, AT = adjoints(win)
    xf = x[..., CPARS:].reshape(lead + (F, 8))
    xAd = _ein(win, "hi,htij->htj", xf, AH) + _ein(win, "ti,htij->htj", xf, AT)

    active = win.res_exists & (win.res_state == W.RES_IN)
    ngood = torch.sum(active, dim=-1)
    b_pt = sc.bdSum - _per_seq(lambda a, b: a @ b.T, win, x[..., :CPARS], sc.Hcd)
    b_pt = b_pt - _ein(win, "nfj,nfj->n", R.by_host(xAd, win), sc.JpJdF * active[..., None]
    )
    step_pt = torch.where(ngood > 0, -b_pt * sc.HdiF, torch.zeros_like(b_pt))
    step_pt = torch.where(torch.isfinite(step_pt), step_pt, torch.zeros_like(step_pt))
    return SolveOut(x=x, step_c=step_c, step_f=step_f, step_pt=step_pt)


def apply_step(win: W.Window, out: SolveOut) -> W.Window:
    """doStepFromBackup with stepfac=1: state += step; point idepth steps
    also reset idepth_zero."""
    new_id = win.pt_idepth + out.step_pt
    return win.replace(
        state=win.state + out.step_f,
        c_value=win.c_value + out.step_c * _c_scale(win),
        pt_idepth=new_id,
        pt_idepth_zero=new_id,
    )


def step_converged(win: W.Window, out: SolveOut, settings: Settings, reduce=None):
    """Convergence test of doStepFromBackup; () bool tensor ((N,) for a
    stacked window)."""
    nf = torch.clamp(torch.sum(win.frame_valid, dim=-1), min=1)
    sumA = torch.sum(out.step_f[..., 6] ** 2, dim=-1) / nf
    sumB = torch.sum(out.step_f[..., 7] ** 2, dim=-1) / nf
    sumT = torch.sum(out.step_f[..., 0:3] ** 2, dim=(-2, -1)) / nf
    sumR = torch.sum(out.step_f[..., 3:6] ** 2, dim=(-2, -1)) / nf
    pt_ok = win.pt_status == W.PT_ACTIVE
    n_pt = torch.sum(pt_ok, dim=-1)
    sum_id = _per_seq(torch.sum, win, torch.where(pt_ok, torch.abs(win.pt_idepth),
                                                  torch.zeros_like(win.pt_idepth)))
    if reduce is not None:
        n_pt = reduce(n_pt)
        sum_id = reduce(sum_id)
    sumNID = sum_id / torch.clamp(n_pt, min=1)
    th = settings.th_opt_iterations
    return (
        (torch.sqrt(sumA) < 0.0005 * th)
        & (torch.sqrt(sumB) < 0.00005 * th)
        & (torch.sqrt(sumR) < 0.00005 * th)
        & (torch.sqrt(sumT) * sumNID < 0.00005 * th)
    )


# ---------------------------------------------------------------------------
# the optimization loop
# ---------------------------------------------------------------------------


def accumulate_priors(win: W.Window, settings: Settings):
    """The prior-only part of accumulateLF (frame/calib priors)."""
    F = win.F
    D = CPARS + 8 * F
    dtype, dev = win.state.dtype, win.device
    lead = _lead(win)
    _, dc, _ = deltas(win)
    H = torch.zeros(lead + (D, D), dtype=dtype, device=dev)
    b = torch.zeros(lead + (D,), dtype=dtype, device=dev)
    prior_f = frame_priors(win, settings)
    ci = torch.arange(CPARS, device=dev)
    H[..., ci, ci] += settings.initial_calib_hessian
    b[..., :CPARS] += settings.initial_calib_hessian * dc
    idx = CPARS + torch.arange(8 * F, device=dev)
    H[..., idx, idx] += prior_f.flatten(-2)
    b[..., CPARS:] += (prior_f * win.state).flatten(-2)
    NP = win.NP
    return Accum(
        H=H, b=b,
        Hdd=torch.zeros(lead + (NP,), dtype=dtype, device=dev),
        bd=torch.zeros(lead + (NP,), dtype=dtype, device=dev),
        Hcd=torch.zeros(lead + (NP, CPARS), dtype=dtype, device=dev),
        nres=torch.zeros(lead, dtype=torch.int64, device=dev),
    )


def _masked_energy(win: W.Window, mask, energy):
    """The energy summed over the residuals in `mask`, per sequence."""
    return _per_seq(torch.sum, win, torch.where(mask, energy, torch.zeros_like(energy)))


def ba_iteration(win: W.Window, dI_stack, iteration: int,
                 settings: Settings = default_settings(), reduce=None):
    """One GN iteration of the windowed BA (linearize -> accumulate ->
    solve -> step). Returns (win, energy, converged, nres). With `reduce`
    the window holds one shard of the points; the camera system, the counts
    and the energy are summed over the shards, the solve is replicated and
    the point steps stay local. A window stacked over N sequences (image
    stacks (N, F, H, W, 3)) iterates every sequence once."""
    active_set = win.res_exists & ~win.res_linearized
    lin = R.linearize(win, dI_stack, settings=settings)
    win = R.apply_res(win, lin, active_set)

    AH, AT = adjoints(win)
    active = win.res_exists & (win.res_state == W.RES_IN)
    mode0 = active & ~win.res_linearized
    accA = accumulate_top(win, AH, AT, mode0, 0, settings, use_prior=False, reduce=reduce)
    accL = accumulate_priors(win, settings)
    acc = Accum(
        H=accA.H + accL.H, b=accA.b + accL.b, Hdd=accA.Hdd + accL.Hdd,
        bd=accA.bd + accL.bd, Hcd=accA.Hcd + accL.Hcd, nres=accA.nres,
    )
    prior_pt = point_prior(win, settings)
    sc = accumulate_sc(win, AH, AT, active, acc, prior_pt, True, reduce=reduce)
    out = solve_system(win, acc, sc, settings, iteration)
    win = apply_step(win, out)
    win = win.replace(pt_idepth_hessian=sc.idepth_hessian)

    energy = _masked_energy(win, active_set, lin.energy)
    if reduce is not None:
        energy = reduce(energy)
    converged = step_converged(win, out, settings, reduce=reduce)
    return win, energy, converged, acc.nres


def optimize(win: W.Window, dI_stack, settings: Settings = default_settings(), max_its: int = 6):
    """FullSystem::optimize (legacy, FullSystemOptimize.cpp:871-1041), the
    JAX package's host loop: stop once `it >= min_opt_iterations` and the
    step converged. Returns (win, energy, nres) of the last iteration.
    (`optimize_fused` is the loop the frame program runs.)"""
    energy, nres = None, 0
    for it in range(max_its):
        win, energy, converged, nres = ba_iteration(win, dI_stack, it, settings=settings)
        if it >= settings.min_opt_iterations and bool(converged):
            break
    return win, energy, nres


def optimize_fused(win: W.Window, dI_stack, settings: Settings = default_settings(),
                   max_its: int = 6, reduce=None):
    """The whole GN loop (FullSystem::optimize, legacy) with the JAX
    package's early exit: a window stops once an iteration converged and
    at least min_opt_iterations ran. Returns (win, energy, nres).

    The JAX package's `lax.while_loop`: `utils/loop.while_loop` over a
    carry updated in place (a WHILE node inside a captured program, a host
    loop reading one flag a trip eagerly), at most `max_its` trips. A
    window stacked over N sequences is its vmap: every trip runs once for
    all sequences, a sequence that stopped keeps the window, energy and
    count it stopped with (a device mask `running` freezes its rows), and
    the loop ends when every sequence stopped or `max_its` ran. A trip
    after every row stopped changes nothing. Eagerly the host reads the
    rows' flags once a trip, after it.

    With `reduce` (see `ba_iteration`) every shard computes the flag from the
    same summed system, so it is the same everywhere; but it is read on the
    host, and a shard that left the loop alone would leave the others waiting
    in the next sum. So the count of shards that have not stopped goes
    through `reduce` too, and all stop together."""
    lead = _lead(win)
    dev = win.device
    carry = dict(
        win=tree_map(torch.clone, win),
        energy=torch.zeros(lead, dtype=torch.float32, device=dev),
        nres=torch.zeros(lead, dtype=torch.int32, device=dev),
        running=torch.ones(lead, dtype=torch.bool, device=dev),
        it=torch.zeros((), dtype=torch.int32, device=dev),
    )
    done = torch.full(lead, max_its <= 0, dtype=torch.bool, device=dev)

    def trip():
        c = carry
        w_n, e, conv, nr = ba_iteration(c["win"], dI_stack, c["it"], settings=settings,
                                        reduce=reduce)
        keep = c["running"]
        new = (select_rows(keep, w_n, c["win"]),
               torch.where(keep, e.to(torch.float32), c["energy"]),
               torch.where(keep, nr.to(torch.int32), c["nres"]))
        torch._foreach_copy_(leaves((c["win"], c["energy"], c["nres"])),
                             leaves(new))
        stop = conv & (c["it"] + 1 >= settings.min_opt_iterations)
        if reduce is not None:
            stop = reduce((~stop).to(torch.int32)) == 0
        c["running"].logical_and_(~stop)
        c["it"].add_(1)
        torch.logical_or(~c["running"], c["it"] >= max_its, out=done)

    loop.while_loop(done, trip, max_its, first_trip=max_its > 0, name="ba")
    return carry["win"], carry["energy"], carry["nres"]


# ---------------------------------------------------------------------------
# final linearization pass, point flagging, marginalization
# ---------------------------------------------------------------------------


def _slot_mask(win: W.Window, slot):
    """(F,) bool, True at `slot` (an int, or (N,) for N stacked sequences:
    (N, F))."""
    if not isinstance(slot, torch.Tensor):
        slot = constant(slot, torch.int64, win.device)
    return torch.arange(win.F, device=win.device) == slot[..., None]


def _at_col(x, slot):
    """x[..., slot] of a per-(point, frame) tensor (NP, F); x[n, :, slot[n]]
    of N stacked sequences' (N, NP, F) for a (N,) slot."""
    if not isinstance(slot, torch.Tensor) or slot.dim() == 0:
        return at_index(x, slot, -1)
    idx = slot.long().reshape(slot.shape + (1, 1)).expand(x.shape[:2] + (1,))
    return torch.gather(x, 2, idx)[..., 0]


def linearize_all_final(win: W.Window, dI_stack, newest_slot,
                        settings: Settings = default_settings()):
    """linearizeAll(fixLinearization=true) + setNewFrameEnergyTH."""
    dev = win.device
    active_set = win.res_exists & ~win.res_linearized
    lin = R.linearize(win, dI_stack, settings=settings)
    win = R.apply_res(win, lin, active_set)

    active = win.res_exists & (win.res_state == W.RES_IN)

    is_new = _slot_mask(win, newest_slot)
    tgt_new = is_new[..., None, :]
    sel = active_set & tgt_new & (win.res_new_energy_wo >= 0)
    vals = torch.where(sel, win.res_new_energy_wo,
                       torch.full_like(win.res_new_energy_wo, float("inf"))).flatten(-2)
    count = torch.sum(sel, dim=(-2, -1))
    svals = torch.sort(vals, dim=-1).values
    nth = (settings.frame_energy_th_n * count).to(torch.int32).long()
    nth_val = torch.sqrt(torch.gather(
        svals, -1, torch.clamp(nth, 0, svals.shape[-1] - 1)[..., None])[..., 0])
    th = nth_val * settings.frame_energy_th_fac_median
    th = (
        26.0 * settings.frame_energy_th_const_weight
        + th * (1.0 - settings.frame_energy_th_const_weight)
    )
    th = th * th * settings.overall_energy_th_weight**2
    th = torch.where(count > 0, th, torch.full_like(th, 12.0 * 12.0 * 8.0))
    new_th = torch.where(is_new, th[..., None], win.frame_energy_th)
    win = win.replace(frame_energy_th=new_th)

    pre = W.precalc(win)
    KRKi = R.by_host(pre["KRKi"], win)
    Kt = R.by_host(pre["Kt"], win)
    P3 = torch.stack([win.pt_u, win.pt_v, torch.ones_like(win.pt_u)], -1)
    ptp_inf = _ein(win, "nfij,nj->nfi", KRKi, P3)
    ptp = ptp_inf + Kt * win.pt_idepth[..., None, None]
    rel_bs = 0.01 * torch.linalg.norm(
        ptp_inf[..., :2] / ptp_inf[..., 2:3] - ptp[..., :2] / ptp[..., 2:3], dim=-1
    )
    rel_bs = torch.where(active, rel_bs, torch.zeros_like(rel_bs))
    win = win.replace(
        pt_max_rel_baseline=torch.maximum(win.pt_max_rel_baseline,
                                          torch.max(rel_bs, dim=-1).values),
        pt_num_good_res=win.pt_num_good_res
        + torch.sum(active & active_set, dim=-1).to(torch.int32),
    )
    win = win.replace(res_exists=win.res_exists & active)
    energy = _masked_energy(win, active_set, lin.energy)
    return win, energy


def res_to_zero_fixed(win: W.Window):
    """EFResidual::fixLinearizationF: res_toZeroF = resF - J * delta."""
    AH, AT = adjoints(win)
    d_frame, dc, d_pt = deltas(win)
    dp = R.by_host(ht_delta(win, AH, AT, d_frame), win)
    Jp_dx, Jp_dy = _jp_delta(win, dp, dc, d_pt)
    return (
        win.J_resF
        - win.J_Idx[..., 0, :] * Jp_dx[..., None]
        - win.J_Idx[..., 1, :] * Jp_dy[..., None]
        - win.J_abF[..., 0, :] * dp[..., 6][..., None]
        - win.J_abF[..., 1, :] * dp[..., 7][..., None]
    )


def flag_points_for_removal(win: W.Window, dI_stack, frames_to_marg, last_slot,
                            prev_slot, settings: Settings = default_settings()):
    """FullSystem::flagPointsForRemoval: classify every active point as
    KEEP / MARGINALIZE / DROP; relinearize + fix res_toZero for the
    marginalization candidates. frames_to_marg: (F,) bool tensor; for N
    stacked sequences (N, F), with (N,) slots."""
    active_pt = win.pt_status == W.PT_ACTIVE
    nres = torch.sum(win.res_exists, dim=-1)

    drop_simple = active_pt & ((win.pt_idepth < 0) | (nres == 0))

    res_in = win.res_exists & (win.res_state == W.RES_IN)
    vis_in_to_marg = torch.sum(res_in & frames_to_marg[..., None, :], dim=-1)
    oob_a = (
        (nres >= settings.min_good_active_res_for_marg)
        & (win.pt_num_good_res > settings.min_good_res_for_marg + 10)
        & (nres - vis_in_to_marg < settings.min_good_active_res_for_marg)
    )
    # recorded states outlive the residual's removal (see the JAX package)
    lr0_state = _at_col(win.res_state, last_slot)
    prev = prev_slot if isinstance(prev_slot, torch.Tensor) else constant(
        prev_slot, torch.int64, win.device)
    prev_ok = (prev >= 0)[..., None]
    lr1_state = _at_col(win.res_state, torch.clamp(prev, min=0))
    oob_b = lr0_state == W.RES_OOB
    oob_c = (nres >= 2) & (lr0_state == W.RES_OUTLIER) & prev_ok & (lr1_state == W.RES_OUTLIER)
    host_flagged = R.by_host(frames_to_marg, win)
    oob = active_pt & ~drop_simple & (oob_a | oob_b | oob_c | host_flagged)

    inlier = (nres >= settings.min_good_active_res_for_marg) & (
        win.pt_num_good_res >= settings.min_good_res_for_marg
    )

    lin = R.linearize(win, dI_stack, settings=settings)
    relin_mask = (oob & inlier)[..., None] & win.res_exists
    win = R.apply_res(win, lin, relin_mask)

    rtz = res_to_zero_fixed(win)
    fix_mask = relin_mask & (win.res_state == W.RES_IN)
    win = win.replace(
        res_to_zero=torch.where(fix_mask[..., None], rtz, win.res_to_zero),
        res_linearized=win.res_linearized | fix_mask,
    )

    well = inlier & (win.pt_idepth_hessian > settings.min_idepth_h_marg)
    marg = oob & well
    drop = drop_simple | (oob & ~well)
    status = win.pt_status
    status = torch.where(marg, torch.full_like(status, W.PT_MARGINALIZE), status)
    status = torch.where(drop & ~marg, torch.full_like(status, W.PT_DROP), status)
    return win.replace(pt_status=status)


def marginalize_points(win: W.Window, settings: Settings = default_settings()):
    """EnergyFunctional::marginalizePointsF: mode-2 accumulation of flagged
    points' fixed residuals, Schur over their idepth, folded into HM/bM;
    marginalized and dropped points removed."""
    AH, AT = adjoints(win)
    marg_pt = win.pt_status == W.PT_MARGINALIZE
    mask = (
        marg_pt[..., None] & win.res_exists & (win.res_state == W.RES_IN)
        & win.res_linearized
    )
    acc2 = accumulate_top(win, AH, AT, mask, 2, settings, use_prior=False)
    prior_pt = torch.where(
        marg_pt,
        point_prior(win, settings) * settings.idepth_fix_prior_marg_fac,
        torch.zeros_like(win.pt_idepth),
    )
    acc_masked = Accum(
        H=acc2.H, b=acc2.b,
        Hdd=torch.where(marg_pt, acc2.Hdd, torch.zeros_like(acc2.Hdd)),
        bd=torch.where(marg_pt, acc2.bd, torch.zeros_like(acc2.bd)),
        Hcd=torch.where(marg_pt[..., None], acc2.Hcd, torch.zeros_like(acc2.Hcd)),
        nres=acc2.nres,
    )
    sc2 = accumulate_sc(win, AH, AT, mask, acc_masked, prior_pt, False)
    win = win.replace(
        HM=win.HM + settings.marg_weight_fac * (acc2.H - sc2.H),
        bM=win.bM + settings.marg_weight_fac * (acc2.b - sc2.b),
    )
    gone = (win.pt_status == W.PT_MARGINALIZE) | (win.pt_status == W.PT_DROP)
    return win.replace(
        pt_status=torch.where(gone, torch.full_like(win.pt_status, W.PT_INACTIVE), win.pt_status),
        res_exists=win.res_exists & ~gone[..., None],
        res_linearized=win.res_linearized & ~gone[..., None],
    )


def _eliminate_block(Hs, bs, idx8):
    """Schur-eliminate the 8x8 block `idx8` of one scaled system."""
    blk = Hs[idx8][:, idx8]
    blk = 0.5 * (blk + blk.T)
    blk_inv = torch.linalg.inv_ex(
        blk + 1e-6 * torch.eye(8, dtype=blk.dtype, device=blk.device)).inverse
    rows = Hs[idx8, :]
    Hs = Hs - rows.T @ blk_inv @ rows
    bs = bs - rows.T @ (blk_inv @ bs[idx8])
    return Hs, bs


def marginalize_frame(win: W.Window, slot: int, settings: Settings = default_settings()):
    """EnergyFunctional::marginalizeFrame, slot-indexed: add the frame's
    prior, scaled Schur-eliminate its 8-dof block from HM/bM, zero the slot.
    The caller guarantees the frame hosts no points and no residuals target
    it. A stacked window marginalizes slot `slot` of every sequence."""
    F = win.F
    D = CPARS + 8 * F
    dev = win.device
    io = CPARS + 8 * slot
    idx8 = io + torch.arange(8, device=dev)

    HM = win.HM.clone()
    bM = win.bM.clone()
    prior_f = frame_priors(win, settings)[..., slot, :]
    HM[..., idx8, idx8] += prior_f
    bM[..., idx8] += prior_f * win.state[..., slot, :]

    SVec = torch.sqrt(torch.abs(torch.diagonal(HM, dim1=-2, dim2=-1)) + 10.0)
    SVecI = 1.0 / SVec
    Hs = SVecI[..., :, None] * HM * SVecI[..., None, :]
    bs = SVecI * bM
    Hs, bs = _per_seq(lambda h, b: _eliminate_block(h, b, idx8), win, Hs, bs)

    HM_new = SVec[..., :, None] * Hs * SVec[..., None, :]
    bM_new = SVec * bs
    HM_new = 0.5 * (HM_new + HM_new.transpose(-1, -2))

    d = torch.arange(D, device=dev)
    slot_mask = (d < io) | (d >= io + 8)
    HM_new = torch.where(slot_mask[:, None] & slot_mask[None, :], HM_new, torch.zeros_like(HM_new))
    bM_new = torch.where(slot_mask, bM_new, torch.zeros_like(bM_new))

    def zrow(x, val=0):
        out = x.clone()
        out[..., slot].fill_(val)
        return out

    def zrow8(x):
        out = x.clone()
        out[..., slot, :].fill_(0)
        return out

    return win.replace(
        HM=HM_new, bM=bM_new,
        frame_valid=zrow(win.frame_valid, False),
        frame_id=zrow(win.frame_id, -1),
        state=zrow8(win.state),
        state_zero=zrow8(win.state_zero),
        prior=zrow8(win.prior),
    )


def drop_frame_refs(win: W.Window, slot: int):
    """Remove residuals targeting `slot` and drop points hosted there."""
    F = win.F
    tgt = torch.arange(F, device=win.device) == slot
    hosted = (win.pt_host == slot) & (win.pt_status == W.PT_ACTIVE)
    return win.replace(
        res_exists=win.res_exists & ~tgt & ~hosted[..., None],
        pt_status=torch.where(hosted, torch.full_like(win.pt_status, W.PT_INACTIVE), win.pt_status),
    )


# the fields `marginalize_frame(drop_frame_refs(...))` changes
_MARG_FIELDS = ("HM", "bM", "frame_valid", "frame_id", "state", "state_zero", "prior",
                "res_exists", "pt_status")


def marginalize_frames_masked(win: W.Window, flagged, settings: Settings = default_settings()):
    """All flagged-frame marginalizations (drop refs + Schur-eliminate), in
    slot order. flagged: (F,) bool; for N stacked sequences (N, F), the JAX
    package's vmap of its masked loop over slots, which marginalizes each
    sequence's flagged slots in slot order.

    A tensor mask stays on the device: slot s is one `utils/loop.cond` on
    "some row flagged s" (an IF node inside a captured program, one read
    eagerly), whose body selects by rows, so an unflagged slot costs
    nothing. A numpy mask (the host `FullSystem`'s) is read as it is."""
    on_host = not isinstance(flagged, torch.Tensor)
    if on_host:
        flagged = np.asarray(flagged, dtype=bool)
    for s_ in range(win.F):
        rows = flagged[..., s_]
        if on_host and not rows.any():
            continue

        def body(w=win, s_=s_, rows=rows):
            w_m = marginalize_frame(drop_frame_refs(w, s_), s_, settings=settings)
            if on_host:
                if rows.all():
                    return w_m
                rows = torch.as_tensor(rows, device=w.device)
            return select_rows(rows, w_m, w)

        if on_host:
            win = body()
            continue
        new = loop.cond(rows.any(), lambda body=body: [getattr(body(), f) for f in _MARG_FIELDS],
                        [getattr(win, f) for f in _MARG_FIELDS])
        win = win.replace(**dict(zip(_MARG_FIELDS, new)))
    return win
