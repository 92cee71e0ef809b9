"""Image pyramid + gradient construction.

Port of `stereo_dso_g2o_tpu/ops/pyramid.py` (FrameHessian::makeImages):
level l>0 intensity is 0.25 * the 2x2 box sum of level l-1; gradients are
central differences with a zero border; absSquaredGrad = dx^2 + dy^2.
Per level: an (H, W, 3) stack of (intensity, dx, dy) plus the (H, W)
squared-gradient map. A stack of images (N, H, W), one per sequence, gives
(N, H_l, W_l, 3) and (N, H_l, W_l) levels.
"""

from __future__ import annotations

import torch


def _downsample2(img):
    """0.25 * 2x2 box sum (HessianBlocks.cpp:159-170)."""
    H, W = img.shape[-2:]
    return 0.25 * (
        img[..., 0 : H - 1 : 2, 0 : W - 1 : 2]
        + img[..., 0 : H - 1 : 2, 1:W:2]
        + img[..., 1:H:2, 0 : W - 1 : 2]
        + img[..., 1:H:2, 1:W:2]
    )


def _gradients(img):
    """Central differences with zero border."""
    dx = torch.zeros_like(img)
    dy = torch.zeros_like(img)
    dx[..., 1:-1] = 0.5 * (img[..., 2:] - img[..., :-2])
    dy[..., 1:-1, :] = 0.5 * (img[..., 2:, :] - img[..., :-2, :])
    return dx, dy


def build_pyramid(img: torch.Tensor, n_levels: int = 6):
    """img: (H, W) float32 intensity, or (N, H, W) for N sequences.

    Returns (dIp, abs_sq_grad): tuples of n_levels (H_l, W_l, 3) and
    (H_l, W_l) tensors (with the leading N of a stack).
    """
    dIp = []
    asg = []
    cur = img
    for lvl in range(n_levels):
        if lvl > 0:
            cur = _downsample2(cur)
        dx, dy = _gradients(cur)
        dIp.append(torch.stack([cur, dx, dy], dim=-1))
        asg.append(dx * dx + dy * dy)
    return tuple(dIp), tuple(asg)


def build_pyramid_gamma(img: torch.Tensor, gamma_grad_lut: torch.Tensor, n_levels: int = 6):
    """build_pyramid with the squared-gradient map weighted by B'(I)^2
    (HessianBlocks.cpp:195-199)."""
    dIp, asg = build_pyramid(img, n_levels)
    out_asg = []
    for lvl in range(n_levels):
        inten = dIp[lvl][..., 0]
        idx = torch.clamp(inten, 0.0, 254.999).long()
        gw = gamma_grad_lut[idx]
        out_asg.append(asg[lvl] * gw * gw)
    return dIp, tuple(out_asg)
