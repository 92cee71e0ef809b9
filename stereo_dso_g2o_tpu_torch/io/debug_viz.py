"""Debug image composition (FullSystemDebugStuff.cpp / debugPlotIDepthMap).

Port of `stereo_dso_g2o_tpu/io/debug_viz.py`, host numpy: renders
inverse-depth overlays and selection maps to PNG for offline inspection —
the headless stand-in for the reference's OpenCV windows. Inputs may be
numpy arrays or tensors (on any device).
"""

from __future__ import annotations

import numpy as np
import torch


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def _colormap_idepth(idepth, valid):
    """The reference's rainbow idepth coloring (makeRainbow3B-style)."""
    v = np.where(valid, idepth, 0.0)
    lo, hi = (np.percentile(v[valid], [5, 95]) if valid.any() else (0.0, 1.0))
    t = np.clip((v - lo) / max(hi - lo, 1e-9), 0, 1)
    r = np.clip(1.5 - np.abs(2.0 * t - 1.0) * 2.0 + 0.5, 0, 1)
    g = np.clip(1.5 - np.abs(2.0 * t - 0.5) * 2.0, 0, 1)
    b = np.clip(1.5 - np.abs(2.0 * t) * 2.0 + 0.0, 0, 1)
    return np.stack([r, g, b], -1)


def idepth_overlay(image: np.ndarray, us, vs, idepths, valid) -> np.ndarray:
    """Gray image with colored 3x3 dots at point locations (uint8 HxWx3)."""
    img = _host(image)
    H, W = img.shape
    base = np.clip(img, 0, 255).astype(np.uint8)
    out = np.stack([base] * 3, -1)
    us = _host(us).astype(int)
    vs = _host(vs).astype(int)
    idepths = _host(idepths)
    valid = _host(valid) & (us >= 1) & (us < W - 1) & (vs >= 1) & (vs < H - 1)
    if not valid.any():
        return out
    colors = (_colormap_idepth(idepths, valid) * 255).astype(np.uint8)
    for du in (-1, 0, 1):
        for dv in (-1, 0, 1):
            out[vs[valid] + dv, us[valid] + du] = colors[valid]
    return out


def selection_overlay(image: np.ndarray, status_map: np.ndarray) -> np.ndarray:
    """Selector debug view: level-0 green, level-1 blue, level-2 red
    (PixelSelector2 makeMaps plot, :297-326)."""
    img = np.clip(_host(image), 0, 255).astype(np.uint8)
    out = np.stack([img] * 3, -1)
    m = _host(status_map)
    out[m == 1] = [0, 255, 0]
    out[m == 2] = [0, 0, 255]
    out[m == 4] = [255, 0, 0]
    return out


def save_png(path: str, rgb: np.ndarray):
    from PIL import Image

    Image.fromarray(rgb).save(path)
