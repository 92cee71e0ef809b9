"""MODE_STEREOMATCH: static-stereo inverse-depth map computation.

Port of `stereo_dso_g2o_tpu/frontend/stereo_match.py`
(FullSystem::stereoMatch, FullSystem.cpp:549-630): select high-gradient
pixels, trace each one left->right along the horizontal epipolar line,
verify by the reverse right->left trace (|u - u_back| < 1, 0 < depth < 70),
and emit (idepth, idepth_min, idepth_max) per accepted point.

The per-point loop is two batched `trace_stereo` calls over the full
fixed-capacity point set; the consistency gate is elementwise masking.
`stereo_match_points` is one program on the card (`runtime/program.run`,
the JAX package's `jax.jit`); the pyramids, the selector's passes and
their reads, and the map stay outside it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from stereo_dso_g2o_tpu_torch import default_device
from stereo_dso_g2o_tpu_torch.config import Settings, default_settings
from stereo_dso_g2o_tpu_torch.frontend.full_system import device_image
from stereo_dso_g2o_tpu_torch.models.camera import Calib
from stereo_dso_g2o_tpu_torch.ops import trace as trace_ops
from stereo_dso_g2o_tpu_torch.ops.pyramid import build_pyramid
from stereo_dso_g2o_tpu_torch.ops.selector import PixelSelector, map_to_points
from stereo_dso_g2o_tpu_torch.runtime import program


class StereoMatchResult(NamedTuple):
    us: torch.Tensor  # (cap,) selected pixel x
    vs: torch.Tensor  # (cap,) selected pixel y
    idepth: torch.Tensor  # (cap,) matched inverse depth (0 where invalid)
    idepth_min: torch.Tensor  # (cap,)
    idepth_max: torch.Tensor  # (cap,)
    good: torch.Tensor  # (cap,) bool: passed the L/R consistency gate
    valid: torch.Tensor  # (cap,) bool: slot holds a selected pixel


def stereo_match_points(us, vs, valid, dI_left, dI_right, K, baseline,
                        settings: Settings = default_settings(),
                        route=None) -> StereoMatchResult:
    """Batched L->R trace + R->L consistency check for given pixel
    locations. `route` forces one of the two epipolar kernels (ops/trace).
    On the card one program per shape (captured at its first call and
    replayed), eagerly on the CPU and inside `program.disabled()`."""
    return program.run(_match_points, (us, vs, valid, dI_left, dI_right, K, baseline),
                       dict(settings=settings, route=route), key=(trace_ops.DEFAULT_ROUTE,))


def _match_points(us, vs, valid, dI_left, dI_right, K, baseline, settings: Settings,
                  route) -> StereoMatchResult:
    """`stereo_match_points` run eagerly (what its program captures)."""
    dev = dI_left.device
    us = us.to(torch.float32)
    vs = vs.to(torch.float32)
    n = us.shape[0]

    def fresh():
        return (
            torch.zeros(n, device=dev), torch.full((n,), float("nan"), device=dev),
            torch.full((n,), 10000.0, device=dev),
            torch.full((n,), trace_ops.IPS_UNINITIALIZED, dtype=torch.int32, device=dev),
        )

    color, weights, gradH, energy_th = trace_ops.extract_point_data(dI_left, us, vs, settings)
    zeros, nans, quality, status = fresh()
    res_lr, idepth_lr = trace_ops.trace_stereo(
        us, vs, zeros, nans, color, weights, gradH, energy_th, quality, status,
        K, baseline, dI_right, mode_right=True, settings=settings, route=route,
    )
    good_lr = valid & (res_lr.status == trace_ops.IPS_GOOD)

    # reverse check: a fresh immature point at the matched right-image position
    eight = torch.full_like(us, 8.0)
    ur = torch.where(good_lr, res_lr.last_uv[:, 0], eight)
    vr = torch.where(good_lr, res_lr.last_uv[:, 1], eight)
    color_r, weights_r, gradH_r, energy_th_r = trace_ops.extract_point_data(
        dI_right, ur, vr, settings
    )
    zeros, nans, quality, status = fresh()
    res_rl, _ = trace_ops.trace_stereo(
        ur, vr, zeros, nans, color_r, weights_r, gradH_r, energy_th_r, quality, status,
        K, baseline, dI_left, mode_right=False, settings=settings, route=route,
    )

    u_delta = torch.abs(us - res_rl.last_uv[:, 0])
    depth = 1.0 / torch.where(idepth_lr != 0, idepth_lr, torch.full_like(idepth_lr, float("inf")))
    good = (
        good_lr
        & (res_rl.status == trace_ops.IPS_GOOD)
        & (u_delta < settings.stereo_u_delta_max)
        & (depth > 0)
        & (depth < settings.nonkey_stereo_depth_max)
    )
    zero = torch.zeros_like(idepth_lr)
    return StereoMatchResult(
        us=us,
        vs=vs,
        idepth=torch.where(good, idepth_lr, zero),
        idepth_min=torch.where(good, res_lr.idepth_min, zero),
        idepth_max=torch.where(good, res_lr.idepth_max, zero),
        good=good,
        valid=valid,
    )


def stereo_match(left_img, right_img, calib: Calib,
                 selector: Optional[PixelSelector] = None,
                 settings: Settings = default_settings(), device=None, route=None):
    """Full MODE_STEREOMATCH on one stereo pair.

    left_img/right_img: (H, W) images (numpy or tensors). Runs on `device`
    (None: the GPU). Returns (StereoMatchResult, idepth_map (H, W, 3)) like
    the reference's CV_32FC3 output."""
    dev = default_device(device)
    if selector is None:
        selector = PixelSelector(settings)
    n_lvl = calib.n_levels
    dIpL, asgL = build_pyramid(device_image(left_img, dev).to(torch.float32), n_lvl)
    dIpR, _ = build_pyramid(device_image(right_img, dev).to(torch.float32), n_lvl)

    status_map, _ = selector.make_maps(
        dIpL[0], asgL[0], asgL[1], asgL[2], settings.desired_immature_density
    )
    us, vs, _, valid = map_to_points(status_map, settings.immature_cap)

    K0 = calib.K(0).to(dev)
    result = stereo_match_points(
        us, vs, valid, dIpL[0], dIpR[0], K0, calib.baseline.to(dev),
        settings=settings, route=route,
    )

    H, W = dIpL[0].shape[:2]
    imap = torch.zeros((H, W, 3), dtype=torch.float32, device=dev)
    vals = torch.stack([result.idepth, result.idepth_min, result.idepth_max], -1)
    vals = torch.where(result.good[:, None], vals, torch.zeros_like(vals))
    # one point per pixel, so the assignment has no duplicate targets but
    # the unused slots, which all write zero to pixel (0, 0)
    imap[result.vs.long(), result.us.long()] = vals
    return result, imap
