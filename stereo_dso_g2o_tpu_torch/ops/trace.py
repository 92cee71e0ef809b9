"""Batched epipolar depth tracing.

Port of `stereo_dso_g2o_tpu/ops/trace.py` (ImmaturePoint::traceOn and
ImmaturePoint::traceStereo) over the whole point set:

  1. project the inverse-depth interval endpoints -> epipolar segment
  2. discrete search along the segment + second best outside a radius
  3. <=3-step 1-dof Gauss-Newton refinement along the epipolar direction
  4. error bound from the gradient-vs-epipolar angle, interval update,
     status state machine (GOOD/OOB/OUTLIER/SKIPPED/BADCONDITION)

Steps 2-3 run in one of the two kernels of `ops/trace_cuda.py` (a CUDA
kernel on the GPU, its plain PyTorch version on the CPU): the resident one,
or the slab one for images over the JAX package's 6 MB gate
(`trace_cuda.uses_slab_route`). `route="resident"` / `route="slab"` on
`trace_batch`, `trace` and `trace_stereo` forces either, for tests and
debugging; None means `DEFAULT_ROUTE`, and when that is None too, the
gate. Everything else is torch ops, masked fixed-shape, as in the JAX
package.

Every function also runs a batch of sequences at once, as the JAX
package's vmap of it does: an image stack (N, H, W, 3), the lanes' arrays
with a leading N ((N, L), (N, L, 8), (N, L, 3, 3), ...) and per-sequence
camera values ((N, 3, 3) K, (N,) baseline). Each lane's arithmetic is the
single call's, and one kernel launch serves the batch.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from stereo_dso_g2o_tpu_torch.config import PATTERN, Settings, default_settings
from stereo_dso_g2o_tpu_torch.ops import trace_cuda as tk
from stereo_dso_g2o_tpu_torch.ops.interp import take
from stereo_dso_g2o_tpu_torch.utils.fixed import constant
from stereo_dso_g2o_tpu_torch.utils.smalls import fma

# the route of a call made with route=None; None means the gate. A tool sets
# it to send every trace of a run through one kernel (tools/accuracy_probe
# route=..., as SDSO_TRACE_BACKEND reaches trace.default_backend in JAX).
DEFAULT_ROUTE = None

# Status codes (ImmaturePoint.h:50-56).
IPS_GOOD = 0
IPS_OOB = 1
IPS_OUTLIER = 2
IPS_SKIPPED = 3
IPS_BADCONDITION = 4
IPS_UNINITIALIZED = 5


class TraceResult(NamedTuple):
    status: torch.Tensor  # (N,) int32
    idepth_min: torch.Tensor  # (N,)
    idepth_max: torch.Tensor  # (N,)
    last_uv: torch.Tensor  # (N, 2) best match position (-1,-1 if none)
    pixel_interval: torch.Tensor  # (N,) 2*errorInPixel
    quality: torch.Tensor  # (N,) best/second-best ratio
    best_energy: torch.Tensor  # (N,)


def _pattern(dtype, device):
    return constant(PATTERN, dtype, device)


def extract_point_data(dI0, u, v, settings: Settings):
    """Per-point pattern colors, weights, gradH from the host image
    (ImmaturePoint constructor, ImmaturePoint.cpp:33-62).

    dI0: (H, W, 3); u, v: (N,). Returns (color (N,8), weights (N,8),
    gradH (N,2,2), energy_th (N,)). A stack dI0 (B, H, W, 3) takes (B, N)
    points and leads every output with B."""
    stacked = dI0.dim() == 4
    pat = _pattern(u.dtype, u.device)
    px = u[..., None] + pat[:, 0]
    py = v[..., None] + pat[:, 1]
    img = dI0[..., 0]
    H, W = img.shape[-2:]
    x = torch.clamp(px, 0.0, W - 1.001)
    y = torch.clamp(py, 0.0, H - 1.001)
    xf = torch.floor(x)
    yf = torch.floor(y)
    ix = torch.nan_to_num(xf).long()  # NaN coords sample index 0 and stay NaN
    iy = torch.nan_to_num(yf).long()
    dx = x - xf
    dy = y - yf
    tl = take(img, iy, ix, stacked)
    tr = take(img, iy, ix + 1, stacked)
    bl = take(img, iy + 1, ix, stacked)
    br = take(img, iy + 1, ix + 1, stacked)
    top = dx * tr + (1 - dx) * tl
    bot = dx * br + (1 - dx) * bl
    left = dy * bl + (1 - dy) * tl
    right = dy * br + (1 - dy) * tr
    color = dx * right + (1 - dx) * left
    gx = right - left
    gy = bot - top
    g2 = gx * gx + gy * gy
    c2 = settings.outlier_th_sum_component
    weights = torch.sqrt(c2 / (c2 + g2))
    sxx = torch.sum(gx * gx, -1)
    sxy = torch.sum(gx * gy, -1)
    syy = torch.sum(gy * gy, -1)
    gradH = torch.stack(
        [torch.stack([sxx, sxy], -1), torch.stack([sxy, syy], -1)], dim=-2
    )
    energy_th = torch.full_like(u, settings.energy_th())
    return color, weights, gradH, energy_th


def _search(dI, ptx, pty, dx, dy, num_steps, aff_a, aff_b, color, weights,
            patx, paty, pre_masked, S, settings: Settings, edge, route=None):
    """Run the epipolar kernel on sanitized lanes: masked lanes get position
    0 and zero steps (their outputs are discarded by the status machine)."""
    if route is None:
        route = DEFAULT_ROUTE
    if route not in (None, "resident", "slab"):
        raise ValueError(f"route must be None, 'resident' or 'slab', got {route!r}")
    if route is None:
        route = "slab" if tk.uses_slab_route(dI.shape[-3], dI.shape[-2]) else "resident"
    search = tk.epipolar_search_slab if route == "slab" else tk.epipolar_search

    def safe(x):
        return torch.where(pre_masked | ~torch.isfinite(x), torch.zeros_like(x), x)

    ns = torch.where(pre_masked, torch.zeros_like(num_steps), num_steps)
    scal = torch.stack(
        [safe(ptx), safe(pty), safe(dx), safe(dy), ns.to(torch.float32),
         aff_a, aff_b, torch.zeros_like(ptx)],
        dim=-1,
    )
    # patx / paty go as they are: slices of the rotated (N, 8, 2) pattern or
    # one pattern broadcast over the lanes; the kernels read them by stride
    return search(
        dI.contiguous(), scal, color.contiguous(), weights.contiguous(),
        patx, paty, S=S,
        huber_th=float(settings.huber_th),
        gn_iters=int(settings.trace_gn_iterations),
        gn_threshold=float(settings.trace_gn_threshold),
        radius=int(settings.min_trace_test_radius), edge=edge,
    )


def trace_batch(u, v, idepth_min, idepth_max, color, weights, gradH, energy_th,
                quality, status, KRKi, Kt, aff, dI_target,
                settings: Settings = default_settings(), route=None) -> TraceResult:
    """Trace every point's epipolar interval onto the target image, with
    per-point KRKi (N,3,3), Kt (N,3), aff (N,2) (traceOn); or, for a stack
    dI_target (B, H, W, 3), B sequences' points (B, N, ...) at once."""
    H, W = dI_target.shape[-3:-1]
    w_f = float(W)
    h_f = float(H)
    max_pix_search = (w_f + h_f) * settings.max_pix_search
    S = min(
        settings.trace_max_steps,
        int(np.ceil(max_pix_search / settings.trace_stepsize)) + 3,
    )
    f32 = u.dtype
    zero = torch.zeros_like(u)

    def inb(x, y):
        return (x > 4.0) & (y > 4.0) & (x < w_f - 5.0) & (y < h_f - 5.0)

    # -- STEP 1: project interval endpoints (ImmaturePoint.cpp:489-566) --
    # The projections round as XLA's fused multiply-adds do: the search
    # start's sub-pixel jitter (u_min*1000 - floor(u_min*1000), below)
    # keeps only the last bits of u_min, so one rounding there moves the
    # whole search by up to 2^-6 px.
    pr = fma(KRKi[..., 1], v[..., None], KRKi[..., 0] * u[..., None]) + KRKi[..., 2]
    ptp_min = fma(Kt, idepth_min[..., None], pr)
    u_min = ptp_min[..., 0] / ptp_min[..., 2]
    v_min = ptp_min[..., 1] / ptp_min[..., 2]
    oob_min = ~inb(u_min, v_min)

    finite_max = torch.isfinite(idepth_max)
    id_max_safe = torch.where(finite_max, idepth_max, zero)
    ptp_max = fma(Kt, id_max_safe[..., None], pr)
    u_max_f = ptp_max[..., 0] / ptp_max[..., 2]
    v_max_f = ptp_max[..., 1] / ptp_max[..., 2]
    oob_max_f = finite_max & ~inb(u_max_f, v_max_f)
    dist_f = torch.sqrt((u_min - u_max_f) ** 2 + (v_min - v_max_f) ** 2)
    skipped = finite_max & (dist_f < settings.trace_slack_interval)

    ptp_dir = fma(Kt, torch.full_like(Kt, 0.01), pr)
    u_dir = ptp_dir[..., 0] / ptp_dir[..., 2]
    v_dir = ptp_dir[..., 1] / ptp_dir[..., 2]
    ddx = u_dir - u_min
    ddy = v_dir - v_min
    dnorm = 1.0 / torch.sqrt(ddx * ddx + ddy * ddy + 1e-20)
    u_max_i = u_min + max_pix_search * ddx * dnorm
    v_max_i = v_min + max_pix_search * ddy * dnorm
    oob_max_i = (~finite_max) & ~inb(u_max_i, v_max_i)

    u_max = torch.where(finite_max, u_max_f, u_max_i)
    v_max = torch.where(finite_max, v_max_f, v_max_i)
    dist = torch.where(finite_max, dist_f, torch.full_like(dist_f, max_pix_search))

    # scale-change gate (:574-581)
    oob_scale = ~((idepth_min < 0) | ((ptp_min[..., 2] > 0.75) & (ptp_min[..., 2] < 1.5)))

    # -- STEP 2: error bound from gradient-vs-epipolar angle (:585-606) --
    dx0 = settings.trace_stepsize * (u_max - u_min)
    dy0 = settings.trace_stepsize * (v_max - v_min)
    gxx = gradH[..., 0, 0]
    gxy = gradH[..., 0, 1]
    gyy = gradH[..., 1, 1]
    a = dx0 * dx0 * gxx + 2 * dx0 * dy0 * gxy + dy0 * dy0 * gyy
    b = dy0 * dy0 * gxx - 2 * dx0 * dy0 * gxy + dx0 * dx0 * gyy
    error_in_pixel = 0.2 + 0.2 * (a + b) / torch.clamp(a, min=1e-20)
    badcond = (error_in_pixel * settings.trace_min_improvement_factor > dist) & finite_max
    error_in_pixel = torch.clamp(error_in_pixel, max=10.0)

    # -- STEP 3: discrete search (:610-693) --
    dx = dx0 / torch.clamp(dist, min=1e-20)
    dy = dy0 / torch.clamp(dist, min=1e-20)
    over = dist > max_pix_search
    u_max = torch.where(over, u_min + max_pix_search * dx, u_max)
    v_max = torch.where(over, v_min + max_pix_search * dy, v_max)
    dist = torch.clamp(dist, max=max_pix_search)

    num_steps = torch.clamp(
        (1.9999 + dist / settings.trace_stepsize).to(torch.int32), max=S - 1
    )
    oob_dxdy = ~(torch.isfinite(dx) & torch.isfinite(dy))

    rand_shift = u_min * 1000.0 - torch.floor(u_min * 1000.0)
    ptx = u_min - rand_shift * dx
    pty = v_min - rand_shift * dy

    # pattern rotated by the in-plane 2x2 of KRKi (:633-645)
    rot_pat = torch.einsum("...ij,pj->...pi", KRKi[..., :2, :2], _pattern(f32, u.device))

    pre_masked = (
        oob_min | oob_max_f | oob_max_i | skipped | oob_scale | badcond
        | oob_dxdy | (status == IPS_OOB)
    )
    out = _search(
        dI_target, ptx, pty, dx, dy, num_steps, aff[..., 0], aff[..., 1], color,
        weights, rot_pat[..., 0], rot_pat[..., 1], pre_masked, S, settings,
        tk.EDGE_CLAMP, route,
    )
    best_u = out[..., tk.OUT_BEST_U]
    best_v = out[..., tk.OUT_BEST_V]
    best_energy_search = out[..., tk.OUT_E_SEARCH]
    second_best = out[..., tk.OUT_SECOND_BEST]
    best_energy = out[..., tk.OUT_E_GN]

    # quality updates only for points that reached the discrete search
    # (the reference's traceOn early-returns before its quality update)
    reached_search = ~pre_masked
    new_quality = second_best / torch.clamp(best_energy_search, min=1e-20)
    quality_out = torch.where(
        reached_search & ((new_quality < quality) | (num_steps > 10)),
        new_quality.to(quality.dtype),
        quality,
    )

    # energy-based outlier gate (:774-793)
    too_high = ~(best_energy < energy_th * settings.trace_extra_slack_on_th)
    outlier_status = torch.where(
        status == IPS_OUTLIER, torch.full_like(status, IPS_OOB),
        torch.full_like(status, IPS_OUTLIER),
    )

    # -- STEP 5: interval update (:797-806) --
    horiz = dx * dx > dy * dy
    e = error_in_pixel

    def interval(coord, d, pr_c, kt_c):
        lo = (pr[..., 2] * (coord - e * d) - pr_c) / (kt_c - Kt[..., 2] * (coord - e * d))
        hi = (pr[..., 2] * (coord + e * d) - pr_c) / (kt_c - Kt[..., 2] * (coord + e * d))
        return lo, hi

    lo_u, hi_u = interval(best_u, dx, pr[..., 0], Kt[..., 0])
    lo_v, hi_v = interval(best_v, dy, pr[..., 1], Kt[..., 1])
    id_lo = torch.where(horiz, lo_u, lo_v)
    id_hi = torch.where(horiz, hi_u, hi_v)
    id_min_new = torch.minimum(id_lo, id_hi)
    id_max_new = torch.maximum(id_lo, id_hi)
    bad_interval = (
        ~torch.isfinite(id_min_new) | ~torch.isfinite(id_max_new) | (id_max_new < 0)
    )

    # -- status resolution in reverse of the reference's early-exit order --
    frozen = status == IPS_OOB

    def put(cond, code, st):
        return torch.where(cond, torch.full_like(st, code), st)

    st = torch.full_like(status, IPS_GOOD)
    st = put(bad_interval, IPS_OUTLIER, st)
    st = torch.where(too_high, outlier_status, st)
    st = put(oob_dxdy, IPS_OOB, st)
    st = put(badcond, IPS_BADCONDITION, st)
    st = put(oob_scale, IPS_OOB, st)
    st = put(skipped, IPS_SKIPPED, st)
    st = put(oob_max_f | oob_max_i, IPS_OOB, st)
    st = put(oob_min, IPS_OOB, st)
    st = put(frozen, IPS_OOB, st)

    updated = (st == IPS_GOOD) & ~frozen
    out_min = torch.where(updated, id_min_new, idepth_min)
    out_max = torch.where(updated, id_max_new, idepth_max)

    mid_u = 0.5 * (u_min + u_max)
    mid_v = 0.5 * (v_min + v_max)
    sk_bc = (st == IPS_SKIPPED) | (st == IPS_BADCONDITION)
    good = st == IPS_GOOD
    minus1 = torch.full_like(u, -1.0)
    last_u = torch.where(good, best_u, torch.where(sk_bc, mid_u, minus1))
    last_v = torch.where(good, best_v, torch.where(sk_bc, mid_v, minus1))
    pixel_interval = torch.where(
        good, 2.0 * error_in_pixel, torch.where(sk_bc, dist, zero)
    )
    quality_out = torch.where(frozen, quality, quality_out)

    return TraceResult(
        status=st,
        idepth_min=out_min,
        idepth_max=out_max,
        last_uv=torch.stack([last_u, last_v], dim=-1),
        pixel_interval=pixel_interval,
        quality=quality_out,
        best_energy=best_energy,
    )


def trace(u, v, idepth_min, idepth_max, color, weights, gradH, energy_th,
          quality, status, KRKi, Kt, aff, dI_target,
          settings: Settings = default_settings(), route=None) -> TraceResult:
    """Single host->target trace: KRKi (3,3), Kt (3,), aff (2,) shared by all
    points. Thin wrapper over trace_batch."""
    N = u.shape[0]
    return trace_batch(
        u, v, idepth_min, idepth_max, color, weights, gradH, energy_th,
        quality, status, KRKi.expand(N, 3, 3), Kt.expand(N, 3), aff.expand(N, 2),
        dI_target, settings=settings, route=route,
    )


def _stereo_finish(
    u_stereo, u, v, u_min, u_max, dist, best_u, best_energy,
    best_energy_search, quality, quality_out, status, energy_th,
    error_in_pixel, ktx, bf, dirx, idepth_min_stereo, idepth_max_stereo,
    oob_min, oob_max, skipped, badcond, settings: Settings,
):
    """Shared trace_stereo tail: outlier gate, interval update, status
    machine, last-UV bookkeeping (ImmaturePoint.cpp:411-457)."""
    too_high = ~(best_energy < energy_th * settings.trace_extra_slack_on_th)
    outlier_status = torch.where(
        status == IPS_OUTLIER, torch.full_like(status, IPS_OOB),
        torch.full_like(status, IPS_OUTLIER),
    )

    e = error_in_pixel
    id_a = (best_u - e * dirx - u) / ktx
    id_b = (best_u + e * dirx - u) / ktx
    id_min_new = torch.minimum(id_a, id_b)
    id_max_new = torch.maximum(id_a, id_b)
    bad_interval = (
        ~torch.isfinite(id_min_new) | ~torch.isfinite(id_max_new) | (id_max_new < 0)
    )

    frozen = status == IPS_OOB

    def put(cond, code, st):
        return torch.where(cond, torch.full_like(st, code), st)

    st = torch.full_like(status, IPS_GOOD)
    st = put(bad_interval, IPS_OUTLIER, st)
    st = torch.where(too_high, outlier_status, st)
    st = put(badcond, IPS_BADCONDITION, st)
    st = put(skipped, IPS_SKIPPED, st)
    st = put(oob_max, IPS_OOB, st)
    st = put(oob_min, IPS_OOB, st)
    st = put(frozen, IPS_OOB, st)

    updated = (st == IPS_GOOD) & ~frozen
    out_min = torch.where(updated, id_min_new, idepth_min_stereo)
    out_max = torch.where(updated, id_max_new, idepth_max_stereo)

    mid_u = 0.5 * (u_min + u_max)
    good = st == IPS_GOOD
    sk_bc = (st == IPS_SKIPPED) | (st == IPS_BADCONDITION)
    minus1 = torch.full_like(u, -1.0)
    last_u = torch.where(good, best_u, torch.where(sk_bc, mid_u, minus1))
    last_v = torch.where(good, v, torch.where(sk_bc, v, minus1))
    pixel_interval = torch.where(
        good, 2.0 * error_in_pixel, torch.where(sk_bc, dist, torch.zeros_like(dist))
    )
    quality_out = torch.where(frozen, quality, quality_out)

    res = TraceResult(
        status=st,
        idepth_min=out_min,
        idepth_max=out_max,
        last_uv=torch.stack([last_u, last_v], dim=-1),
        pixel_interval=pixel_interval,
        quality=quality_out,
        best_energy=best_energy,
    )
    idepth_stereo = (u_stereo - res.last_uv[..., 0]) / bf
    return res, idepth_stereo


def trace_stereo(u_stereo, v_stereo, idepth_min_stereo, idepth_max_stereo,
                 color, weights, gradH, energy_th, quality, status, K, baseline,
                 dI_target, mode_right: bool = True,
                 settings: Settings = default_settings(), route=None):
    """Static stereo trace (ImmaturePoint.cpp:94-457).

    mode_right=True matches left->right (bl = (-baseline,0,0)); False is the
    reverse check. Affine is fixed to (1,0). Returns (TraceResult,
    idepth_stereo) with idepth_stereo = (u_stereo - bestU)/bf, valid where
    status == GOOD. The epipolar line is horizontal, so the search runs the
    kernel with (dx, dy) = (dirx, 0), an unrotated pattern and zeros outside
    the image (the JAX "xla" strip formulation). A stack dI_target
    (B, H, W, 3) takes B sequences' (B, N) points with their (B, 3, 3) K and
    (B,) baselines."""
    H, W = dI_target.shape[-3:-1]
    w_f, h_f = float(W), float(H)
    max_pix_search = (w_f + h_f) * settings.max_pix_search
    S = min(settings.trace_max_steps, int(np.ceil(max_pix_search)) + 3)

    sign = -1.0 if mode_right else 1.0
    ktx = sign * K[..., 0, 0] * baseline
    bf = K[..., 0, 0] * baseline * (1.0 if mode_right else -1.0)
    if dI_target.dim() == 4:  # one value per sequence, over its points
        ktx, bf = ktx[..., None], bf[..., None]
    dirx = -1.0 if mode_right else 1.0

    u = u_stereo.to(torch.float32)
    v = v_stereo.to(torch.float32)

    def inb(x, y):
        return (x > 4.0) & (y > 4.0) & (x < w_f - 5.0) & (y < h_f - 5.0)

    u_min = fma(ktx, idepth_min_stereo, u)  # rounded as in trace_batch
    oob_min = ~inb(u_min, v)

    finite_max = torch.isfinite(idepth_max_stereo)
    id_max_safe = torch.where(finite_max, idepth_max_stereo, torch.zeros_like(idepth_max_stereo))
    u_max_f = u + ktx * id_max_safe
    oob_max_f = finite_max & ~inb(u_max_f, v)
    dist_f = torch.abs(u_min - u_max_f)
    skipped = finite_max & (dist_f < settings.trace_slack_interval)

    u_max_i = u_min + max_pix_search * dirx
    oob_max_i = (~finite_max) & ~inb(u_max_i, v)
    u_max = torch.where(finite_max, u_max_f, u_max_i)
    dist = torch.where(finite_max, dist_f, torch.full_like(dist_f, max_pix_search))

    gxx = gradH[..., 0, 0]
    gyy = gradH[..., 1, 1]
    error_in_pixel = 0.2 + 0.2 * (gxx + gyy) / torch.clamp(gxx, min=1e-20)
    badcond = (error_in_pixel * settings.trace_min_improvement_factor > dist) & finite_max
    error_in_pixel = torch.clamp(error_in_pixel, max=10.0)

    over = dist > max_pix_search
    u_max = torch.where(over, u_min + max_pix_search * dirx, u_max)
    dist = torch.clamp(dist, max=max_pix_search)
    num_steps = torch.clamp(
        (1.9999 + dist / settings.trace_stepsize).to(torch.int32), max=S - 1
    )

    rand_shift = u_min * 1000.0 - torch.floor(u_min * 1000.0)
    ptx = u_min - rand_shift * dirx

    pre_masked = (
        oob_min | oob_max_f | oob_max_i | skipped | badcond | (status == IPS_OOB)
    )
    pat = _pattern(torch.float32, u.device)
    lanes = tuple(u.shape) + (8,)
    out = _search(
        dI_target, ptx, v, torch.full_like(ptx, dirx), torch.zeros_like(ptx),
        num_steps, torch.ones_like(ptx), torch.zeros_like(ptx), color, weights,
        pat[:, 0].expand(lanes), pat[:, 1].expand(lanes), pre_masked,
        S, settings, tk.EDGE_ZERO, route,
    )
    best_u = out[..., tk.OUT_BEST_U]
    best_energy_search = out[..., tk.OUT_E_SEARCH]
    second_best = out[..., tk.OUT_SECOND_BEST]
    best_energy = out[..., tk.OUT_E_GN]

    new_quality = second_best / torch.clamp(best_energy_search, min=1e-20)
    quality_out = torch.where(
        ~pre_masked & ((new_quality < quality) | (num_steps > 10)),
        new_quality.to(quality.dtype),
        quality,
    )
    return _stereo_finish(
        u_stereo, u, v, u_min, u_max, dist, best_u, best_energy,
        best_energy_search, quality, quality_out, status, energy_th,
        error_in_pixel, ktx, bf, dirx, idepth_min_stereo, idepth_max_stereo,
        oob_min, oob_max_f | oob_max_i, skipped, badcond, settings,
    )
