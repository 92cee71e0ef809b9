"""LM trips of the coarse tracker on a rendered plane, at the main path's
shapes, for the card test of `csrc/lm_trip.cu` (tests/test_torch_lm_trip.py)
and `chip_smoke.py` [lm_trip]. Imports no JAX.

`problem(lvl, ...)` gives one tracker level (`tracker_ops.LMProblem`) of N
sequences at 1216x352, 6 levels, each level's cap as `coarse_tracker.
level_caps` gives it (8192, 8192, 8192, 4096, 1672, 418) unless `caps`
says otherwise; `start(p, K)` the carry `lm_init` makes for K hypotheses a
sequence (poses a few percent off the truth); `edge_rows(c, p)` sets the
rows a trip has to handle besides: a rejected step, a row already done, a
cutoff repeat that ends its pass, a row with no in-bounds point, a NaN
pose. `compare(p, got, want, before)` sets one trip of the kernel beside
one of the plain version from the same carry. `tiny()` is a level of
random points small enough for a CPU test.
"""

from __future__ import annotations

import numpy as np
import torch

from stereo_dso_g2o_tpu_torch.config import default_settings
from stereo_dso_g2o_tpu_torch.frontend.coarse_tracker import MAX_ITERATIONS, level_caps
from stereo_dso_g2o_tpu_torch.io import synthetic
from stereo_dso_g2o_tpu_torch.models.camera import make_calib
from stereo_dso_g2o_tpu_torch.ops import tracker_ops as tops
from stereo_dso_g2o_tpu_torch.ops.pyramid import build_pyramid
from stereo_dso_g2o_tpu_torch.utils import se3

W_, H_, LEVELS = 1216, 352, 6
SETTINGS = default_settings()

# One trip from the same carry, kernel against plain version. Both run the
# same f32 arithmetic point by point; they differ in the order of the sums
# over P terms (the kernel's fixed tree against PyTorch's reductions and
# cuBLAS's GEMM) and of the 3x3 / 4x4 products in the pose step:
# - the sums (energy, H, b): 1e-4 of the size of their terms, the tests'
#   tolerance for a sum of ~1e3-1e4 f32 terms in another order: of the
#   energy itself, of the largest entry of H, of b_i Cauchy-Schwarz's
#   sqrt(H_ii * E / n) (b cancels to ~0 as the row converges);
# - the pose: 2e-6 absolute on the 4x4 entries (a few float32 ulps of a
#   unit rotation and of a translation of a few metres: the step's
#   products rounded in another order); the affine 1e-5 absolute and
#   relative (its step is solved from sums ~1e-6 apart, and the offset b
#   is in gray levels, up to tens);
# - |r| of an accepted step: 1e-3 absolute (a pose a few ulps apart moves
#   a warped pixel by ~1e-5 px, on gradients up to ~100 a pixel);
# - the in-bounds flags: a point whose warp lands within that of an edge
#   may fall either side, at most INB_FLIPS of a row's points.
SUM_RTOL, POSE_ATOL, AFF_TOL, AR_ATOL = 1e-4, 2e-6, 1e-5, 1e-3
INB_FLIPS = 1e-3
# the plain version's own margins under which its decisions are left
# unchecked: accept (E/n against E_old/n_old) and the end of a pass (the
# step's norm against 1e-3), relative
MARGIN = 1e-4


def _render(seed: int, T_cw: np.ndarray):
    scene = synthetic.default_scene(seed)
    K = synthetic.default_K(W_, H_)
    return K, scene, synthetic.render(scene, K, W_, H_, T_cw)


def _motion(seed: int) -> np.ndarray:
    rng = np.random.default_rng(1000 + seed)
    xi = np.concatenate([rng.uniform(-0.05, 0.05, 3), rng.uniform(-0.01, 0.01, 3)])
    return se3.se3_exp(torch.tensor(xi, dtype=torch.float64)).numpy()


def problem(lvl: int, n_seq: int = 1, device="cpu", caps=None, seed: int = 0):
    """(LMProblem of level `lvl` for `n_seq` sequences, the true poses
    (n_seq, 4, 4) float64); the operands lead with the sequence when
    n_seq > 1."""
    batched = n_seq > 1
    us_all, vs_all, id_all, col_all, ok_all, dI_all, T_gt = [], [], [], [], [], [], []
    for s in range(n_seq):
        K, scene, (ref_img, idepth) = _render(seed + s, np.eye(4))
        T = _motion(seed + s)
        new_img, _ = synthetic.render(scene, K, W_, H_, T)
        cal = make_calib(K[0, 0], K[1, 1], K[0, 2], K[1, 2], 0.54, W_, H_, n_levels=LEVELS,
                         device=device)
        cap = (level_caps(cal) if caps is None else caps)[lvl]
        rng = np.random.default_rng(seed + s)
        n_pts = 24000
        us = rng.integers(4, W_ - 4, n_pts).astype(np.float32)
        vs = rng.integers(4, H_ - 4, n_pts).astype(np.float32)
        ids = idepth[vs.astype(int), us.astype(int)].astype(np.float32)
        dref, _ = build_pyramid(torch.as_tensor(ref_img, device=device), LEVELS)
        dnew, _ = build_pyramid(torch.as_tensor(new_img, device=device), LEVELS)
        maps = tops.build_ref_maps(
            torch.as_tensor(us, device=device), torch.as_tensor(vs, device=device),
            torch.as_tensor(ids, device=device),
            torch.as_tensor(rng.uniform(0.5, 1.0, n_pts).astype(np.float32), device=device),
            torch.as_tensor(ids > 0, device=device), n_levels=LEVELS, dI_ref=dref)
        u, v, idp, col, ok = tops.compact_ref_level(maps[0][lvl], maps[1][lvl], maps[2][lvl], cap)
        for dst, x in zip((us_all, vs_all, id_all, col_all, ok_all, dI_all),
                          (u, v, idp, col, ok, dnew[lvl])):
            dst.append(x)
        T_gt.append(T)
        Kl = torch.stack([cal.fx(lvl), cal.fy(lvl), cal.cx(lvl), cal.cy(lvl)], -1).float()
    f32 = dict(dtype=torch.float32, device=device)
    if batched:
        ops = [torch.stack(x) for x in (us_all, vs_all, id_all, col_all, ok_all, dI_all)]
        lead = (n_seq,)
    else:
        ops = [x[0] for x in (us_all, vs_all, id_all, col_all, ok_all, dI_all)]
        lead = ()
    p = tops.LMProblem(
        *ops, K_lvl=Kl.expand(lead + (4,)).contiguous(),
        ref_aff=torch.zeros(lead + (2,), **f32), ref_exposure=torch.ones(lead, **f32),
        new_exposure=torch.full(lead, 1.05, **f32), settings=SETTINGS,
        max_iterations=MAX_ITERATIONS[min(lvl, len(MAX_ITERATIONS) - 1)])
    return p, np.stack(T_gt)


def start(p: tops.LMProblem, n_rows: int, T_gt: np.ndarray, seed: int = 0) -> tops.LMCarry:
    """The carry `lm_init` makes for `n_rows` hypotheses of every
    sequence: the true pose moved by a seeded twist of a few percent."""
    rng = np.random.default_rng(7 + seed)
    dev = p.pc_u.device
    Ts = []
    for T in T_gt:
        for _ in range(n_rows):
            xi = np.concatenate([rng.uniform(-0.02, 0.02, 3), rng.uniform(-0.004, 0.004, 3)])
            Ts.append(T @ se3.se3_exp(torch.tensor(xi, dtype=torch.float64)).numpy())
    lead = (len(T_gt), n_rows) if p.pc_u.dim() == 2 else (n_rows,)
    T_init = torch.as_tensor(np.stack(Ts), dtype=torch.float32, device=dev).reshape(lead + (4, 4))
    aff = torch.zeros(lead + (2,), dtype=torch.float32, device=dev)
    carry, _ = tops.lm_init(p, T_init, aff, torch.zeros(lead, dtype=torch.bool, device=dev))
    return carry


def edge_rows(c: tops.LMCarry, p: tops.LMProblem) -> tops.LMCarry:
    """Rows 1-4 of the first sequence made the edge cases (rows 0 and 5..
    stay as `lm_init` made them): 1 a step that must be rejected (E_old 0),
    2 a row already done, 3 a cutoff repeat due at the end of its pass, 4
    no point in bounds (the pose 100 m aside); and, of more than 5 rows,
    the last a NaN pose (its H NaN too)."""
    flat = tops.LMCarry(*(x.reshape((-1,) + tuple(x.shape[c.T.dim() - 2:])) for x in c))
    flat.E_old[1].fill_(0.0)
    flat.done[2].fill_(True)
    flat.rep_pending[3].fill_(True)
    flat.it[3].fill_(p.max_iterations - 1)
    flat.T[4, 0, 3].add_(100.0)
    if flat.T.shape[0] > 5:
        flat.T[-1].fill_(float("nan"))
        flat.Hm[-1].fill_(float("nan"))
    return c


def tiny(n_seq=None, rows=3, P=40, H=12, W=16, seed=0):
    """A level of random points on a random image, and its carry after
    `lm_init`, on the CPU (one sequence, or n_seq stacked): a problem a
    CPU test runs in milliseconds."""
    g = torch.Generator().manual_seed(seed)
    lead = () if n_seq is None else (n_seq,)

    def r(*shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(lead + shape, generator=g)

    p = tops.LMProblem(
        pc_u=r(P, lo=3, hi=W - 4), pc_v=r(P, lo=3, hi=H - 4), pc_idepth=r(P, lo=0.2, hi=1.0),
        pc_color=r(P, hi=200), pc_ok=r(P) < 0.9, dI_new=r(H, W, 3, hi=200),
        K_lvl=torch.tensor([10.0, 10.0, W / 2, H / 2]).expand(lead + (4,)).contiguous(),
        ref_aff=torch.zeros(lead + (2,)), ref_exposure=torch.ones(lead),
        new_exposure=torch.ones(lead), settings=SETTINGS, max_iterations=5)
    T = torch.eye(4).expand(lead + (rows, 4, 4)).clone()
    T[..., :3, 3] = 0.01 * torch.arange(rows, dtype=torch.float32)[:, None]
    carry, _ = tops.lm_init(p, T, torch.zeros(lead + (rows, 2)),
                            torch.zeros(lead + (rows,), dtype=torch.bool))
    return p, carry


def clone(c: tops.LMCarry) -> tops.LMCarry:
    return tops.LMCarry(*(x.clone() for x in c))


def _margins(p: tops.LMProblem, c: tops.LMCarry):
    """Where the plain version's own decisions from carry `c` are certain
    to MARGIN: (accept, end of pass), each (rows,) bool."""
    inc_scaled, inc_raw = tops._lm_solve(p, c.Hm, c.bv, c.lam)
    T_new = se3.se3_exp(inc_scaled[..., :6]) @ c.T
    stats, _ = tops._lm_res(p, T_new, c.aff + inc_scaled[..., 6:8], c.cutoff)
    e_new = stats.energy / torch.clamp(stats.num_terms, min=1)
    e_old = c.E_old / torch.clamp(c.n_old, min=1)
    none = (stats.num_terms == 0) & (c.n_old == 0)  # 0 against 0 on both sides
    accept = (torch.abs(e_new - e_old) > MARGIN * torch.abs(e_old)) | none
    norm = torch.linalg.norm(inc_raw, dim=-1)
    end = (torch.abs(norm - 1e-3) > MARGIN * 1e-3) | (c.it + 1 >= p.max_iterations)
    return accept, end


def compare(p: tops.LMProblem, got: tops.LMCarry, want: tops.LMCarry,
            before: tops.LMCarry) -> dict:
    """The kernel's trip `got` against the plain version's `want`, both
    from `before`: {check: rows (of those whose decisions are certain)
    outside it}; "done_rows_changed": fields of rows done before the trip
    that are not bit for bit as they were."""
    rows = tuple(want.T.shape[:-2])
    B = int(np.prod(rows))
    sure_accept, sure_end = (x.reshape(B).cpu() for x in _margins(p, before))

    def flat(x):
        return x.reshape((B,) + tuple(x.shape[len(rows):])).cpu()

    g, w, b0 = (tops.LMCarry(*(flat(x) for x in c)) for c in (got, want, before))
    done = b0.done
    out = {"done_rows_changed": sum(
        int(not torch.equal(gx[done], bx[done])
            and not torch.equal(torch.isnan(gx[done].double()), torch.isnan(bx[done].double())))
        for gx, bx in zip(g, b0))}
    sure = ~done & sure_accept & sure_end
    for name in ("it", "total", "rep_pending", "done"):
        out[name] = int(((getattr(g, name) != getattr(w, name)) & sure).sum())

    def far(a, b, atol, rtol=0.0):
        a, b = a.double(), b.double()
        ok = (torch.abs(a - b) <= atol + rtol * torch.abs(b)) | (torch.isnan(a) & torch.isnan(b))
        return ~ok.reshape(B, -1).all(-1) & sure

    hs = torch.nan_to_num(w.Hm.abs(), nan=0.0).reshape(B, -1).amax(-1).double()
    e_n = (w.E_old / torch.clamp(w.n_old, min=1)).double()
    bs = torch.sqrt(torch.diagonal(w.Hm, dim1=-2, dim2=-1).double().abs() * e_n[:, None])
    flips_allowed = int(np.ceil(INB_FLIPS * w.ar.shape[-1]))
    out.update(
        T=int(far(g.T, w.T, POSE_ATOL).sum()), aff=int(far(g.aff, w.aff, AFF_TOL, AFF_TOL).sum()),
        lam=int(far(g.lam, w.lam, 0.0).sum()), cutoff=int(far(g.cutoff, w.cutoff, 0.0).sum()),
        E=int(far(g.E_old, w.E_old, 0.0, SUM_RTOL).sum()),
        n=int(((torch.abs(g.n_old - w.n_old) > flips_allowed) & sure).sum()),
        H=int(far(g.Hm, w.Hm, SUM_RTOL * hs[:, None, None]).sum()),
        b=int(far(g.bv, w.bv, SUM_RTOL * torch.nan_to_num(bs)).sum()),
        ar=int(far(torch.where(w.inb, g.ar, 0.0), torch.where(w.inb, w.ar, 0.0), AR_ATOL).sum()),
        inb=int((((g.inb != w.inb).sum(-1) > flips_allowed) & sure).sum()),
        checked=int(sure.sum()))
    return out


def max_errors(got: tops.LMCarry, want: tops.LMCarry, before: tops.LMCarry) -> dict:
    """The largest differences of the running rows (for the record)."""
    ran = ~before.done.reshape(-1).bool()

    def err(a, b):
        a, b = a.reshape(ran.shape[0], -1)[ran].double(), b.reshape(ran.shape[0], -1)[ran].double()
        d = torch.abs(a - b)
        d = torch.where(torch.isnan(a) & torch.isnan(b), torch.zeros_like(d), d)
        return float(torch.nan_to_num(d, nan=float("inf")).max()) if d.numel() else 0.0

    return {k: err(getattr(got, k), getattr(want, k))
            for k in ("T", "aff", "E_old", "lam", "Hm", "bv", "cutoff")}
