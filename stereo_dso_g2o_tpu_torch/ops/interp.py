"""Batched bilinear image sampling.

Port of `stereo_dso_g2o_tpu/ops/interp.py`: the reference's floor-anchored
bilinear formula

    res = dxdy*I[y+1,x+1] + (dy-dxdy)*I[y+1,x] + (dx-dxdy)*I[y,x+1]
        + (1-dx-dy+dxdy)*I[y,x]

over an arbitrary batch of sample coordinates. Out-of-range coordinates are
clamped to [0, size - 1.001]; callers mask out-of-bounds samples.

`stacked=True` samples a stack of images, one per sequence (the leading
axis the JAX package's vmap adds): image n serves the coordinates of row n,
whose leading axis is the stack's.
"""

from __future__ import annotations

import torch


def take(img, iy, ix, stacked: bool = False):
    """img[iy, ix]; for a stack (N, H, W[, C]) the pixel of image n for row
    n of the (N, ...) indices."""
    if not stacked:
        return img[iy, ix]
    n = torch.arange(img.shape[0], device=img.device).reshape((-1,) + (1,) * (iy.dim() - 1))
    return img[n, iy, ix]


def _corners(img, iy, ix, stacked):
    return (
        take(img, iy, ix, stacked),
        take(img, iy, ix + 1, stacked),
        take(img, iy + 1, ix, stacked),
        take(img, iy + 1, ix + 1, stacked),
    )


def bilinear(img, x, y, stacked: bool = False):
    """Sample img at float coords.

    img: (H, W) or (H, W, C); x, y: any matching shape (...,). Stacked:
    img (N, H, W[, C]), x, y (N, ...).
    Returns (...,) or (..., C).
    """
    H, W = img.shape[int(stacked)], img.shape[int(stacked) + 1]
    x = torch.clamp(x, 0.0, W - 1.001)
    y = torch.clamp(y, 0.0, H - 1.001)
    xf = torch.floor(x)
    yf = torch.floor(y)
    ix = torch.nan_to_num(xf).long()  # NaN coords sample index 0 and stay NaN
    iy = torch.nan_to_num(yf).long()
    dx = x - xf
    dy = y - yf
    i00, i01, i10, i11 = _corners(img, iy, ix, stacked)
    if img.ndim == 3 + int(stacked):
        dx = dx[..., None]
        dy = dy[..., None]
    dxdy = dx * dy
    return (
        dxdy * i11
        + (dy - dxdy) * i10
        + (dx - dxdy) * i01
        + (1.0 - dx - dy + dxdy) * i00
    )


def bilinear_flat(img_flat, w, x, y):
    """Same as bilinear but for a flat (H*W,) or (H*W, C) buffer of width w
    (no clamping: the caller guarantees in-bounds coordinates)."""
    xf = torch.floor(x)
    yf = torch.floor(y)
    ix = torch.nan_to_num(xf).long()  # NaN coords sample index 0 and stay NaN
    iy = torch.nan_to_num(yf).long()
    dx = x - xf
    dy = y - yf
    base = ix + iy * w
    i00 = img_flat[base]
    i01 = img_flat[base + 1]
    i10 = img_flat[base + w]
    i11 = img_flat[base + w + 1]
    if img_flat.ndim == 2:
        dx = dx[..., None]
        dy = dy[..., None]
    dxdy = dx * dy
    return (
        dxdy * i11
        + (dy - dxdy) * i10
        + (dx - dxdy) * i01
        + (1.0 - dx - dy + dxdy) * i00
    )
