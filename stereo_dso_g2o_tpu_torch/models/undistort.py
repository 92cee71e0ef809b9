"""Geometric rectification + photometric calibration.

Port of `stereo_dso_g2o_tpu/models/undistort.py` (util/Undistort.{h,cpp}):
the five camera models (FOV/ATAN, RadTan, Equidistant, Kannala-Brandt,
Pinhole; Undistort.cpp:974-1240), calib-file parsing (5-line format incl. the
stereo baseline, :840-905), crop/full/none output-K modes
(makeOptimalK_crop), remap table generation, and the photometric
inverse-response + vignette correction (PhotometricUndistorter,
Undistort.h:36-60).

Remap construction is host numpy in float64, copied from the JAX module, so
the tables are the same bits after the float32 cast. The tables live on the
device (`device=None`: the GPU), where each frame is remapped with the
port's bilinear gather and corrected with a LUT gather.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from stereo_dso_g2o_tpu_torch import default_device
from stereo_dso_g2o_tpu_torch.ops.interp import bilinear


# ---------------------------------------------------------------------------
# distortion models: map OUTPUT pixel coords -> INPUT (distorted) pixel coords
# (the direction used for remapping; Undistort.cpp distortCoordinates)
# ---------------------------------------------------------------------------


def _norm(x, y, Knew):
    ix = (x - Knew[0, 2]) / Knew[0, 0]
    iy = (y - Knew[1, 2]) / Knew[1, 1]
    return ix, iy


def distort_fov(x, y, pars, Knew):
    fx, fy, cx, cy, omega = pars[:5]
    ix, iy = _norm(x, y, Knew)
    r = np.sqrt(ix * ix + iy * iy)
    d2t = 2.0 * np.tan(omega / 2.0)
    with np.errstate(invalid="ignore", divide="ignore"):
        fac = np.where(
            (r == 0) | (omega == 0), 1.0, np.arctan(r * d2t) / (omega * r)
        )
    return fx * fac * ix + cx, fy * fac * iy + cy


def distort_radtan(x, y, pars, Knew):
    fx, fy, cx, cy, k1, k2, p1, p2 = pars[:8]
    ix, iy = _norm(x, y, Knew)
    mx2 = ix * ix
    my2 = iy * iy
    mxy = ix * iy
    rho2 = mx2 + my2
    rad = k1 * rho2 + k2 * rho2 * rho2
    dx = ix + ix * rad + 2.0 * p1 * mxy + p2 * (rho2 + 2.0 * mx2)
    dy = iy + iy * rad + 2.0 * p2 * mxy + p1 * (rho2 + 2.0 * my2)
    return fx * dx + cx, fy * dy + cy


def distort_equidistant(x, y, pars, Knew):
    fx, fy, cx, cy, k1, k2, k3, k4 = pars[:8]
    ix, iy = _norm(x, y, Knew)
    r = np.sqrt(ix * ix + iy * iy)
    theta = np.arctan(r)
    t2 = theta * theta
    theta_d = theta * (1 + k1 * t2 + k2 * t2**2 + k3 * t2**3 + k4 * t2**4)
    with np.errstate(invalid="ignore", divide="ignore"):
        scaling = np.where(r > 1e-8, theta_d / r, 1.0)
    return fx * ix * scaling + cx, fy * iy * scaling + cy


def distort_kb(x, y, pars, Knew):
    fx, fy, cx, cy, k0, k1, k2, k3 = pars[:8]
    ix, iy = _norm(x, y, Knew)
    r = np.sqrt(ix * ix + iy * iy)
    theta = np.arctan2(r, 1.0)
    t = theta
    rd = t + k0 * t**3 + k1 * t**5 + k2 * t**7 + k3 * t**9
    with np.errstate(invalid="ignore", divide="ignore"):
        scaling = np.where(r > 1e-8, rd / r, 1.0)
    return fx * ix * scaling + cx, fy * iy * scaling + cy


def distort_pinhole(x, y, pars, Knew):
    fx, fy, cx, cy = pars[:4]
    ix, iy = _norm(x, y, Knew)
    return fx * ix + cx, fy * iy + cy


_MODELS = {
    "FOV": (distort_fov, 5),
    "RadTan": (distort_radtan, 8),
    "Equidistant": (distort_equidistant, 8),
    "KannalaBrandt": (distort_kb, 8),
    "Pinhole": (distort_pinhole, 4),
}


class Undistorter:
    """Geometric rectifier for one camera (Undistort base class behavior).
    `remap_x`, `remap_y` (float32) and `remap_ok` (bool) are (h, w) tensors
    on `device` (None: the GPU)."""

    def __init__(self, model: str, pars, w_org: int, h_org: int,
                 out_mode, w_out: int, h_out: int, baseline: float = 0.0,
                 device=None):
        self.device = default_device(device)
        self.model = model
        self.pars = np.asarray(pars, dtype=np.float64)
        self.w_org, self.h_org = w_org, h_org
        self.w, self.h = w_out, h_out
        self.baseline = baseline
        self.distort = _MODELS[model][0]

        if isinstance(out_mode, str) and out_mode == "crop":
            self.K = self._make_optimal_K_crop()
        elif isinstance(out_mode, str) and out_mode == "none":
            assert (w_out, h_out) == (w_org, h_org), "none mode needs matching sizes"
            self.K = np.array(
                [
                    [self.pars[0], 0, self.pars[2]],
                    [0, self.pars[1], self.pars[3]],
                    [0, 0, 1],
                ]
            )
            self.passthrough = model == "Pinhole"
        else:
            # explicit relative calibration (fx/w fy/h cx/w cy/h)
            fx, fy, cx, cy = out_mode
            self.K = np.array(
                [
                    [fx * w_out, 0, cx * w_out - 0.5],
                    [0, fy * h_out, cy * h_out - 0.5],
                    [0, 0, 1],
                ]
            )
        self.passthrough = getattr(self, "passthrough", False) and (
            (w_out, h_out) == (w_org, h_org)
        )
        self._make_remap()

    # makeOptimalK_crop (Undistort.cpp:561-660): find the largest output K
    # whose full remap stays inside the source image.
    def _make_optimal_K_crop(self):
        w, h = self.w, self.h

        def in_bounds(Knew):
            xs = np.concatenate(
                [
                    np.linspace(0, w - 1, 200),
                    np.full(200, 0.0),
                    np.linspace(0, w - 1, 200),
                    np.full(200, w - 1.0),
                ]
            )
            ys = np.concatenate(
                [
                    np.full(200, 0.0),
                    np.linspace(0, h - 1, 200),
                    np.full(200, h - 1.0),
                    np.linspace(0, h - 1, 200),
                ]
            )
            dx, dy = self.distort(xs, ys, self.pars, Knew)
            return (
                np.all(dx >= 0)
                and np.all(dx <= self.w_org - 1)
                and np.all(dy >= 0)
                and np.all(dy <= self.h_org - 1)
            )

        # scan focal scale downward from the original until the border fits
        fx0 = self.pars[0] * w / self.w_org
        fy0 = self.pars[1] * h / self.h_org
        scale_lo, scale_hi = 0.1, 3.0
        for _ in range(60):
            s = 0.5 * (scale_lo + scale_hi)
            Knew = np.array(
                [
                    [fx0 * s, 0, (w - 1) / 2.0],
                    [0, fy0 * s, (h - 1) / 2.0],
                    [0, 0, 1],
                ]
            )
            if in_bounds(Knew):
                scale_hi = s  # zoomed out enough; try zooming in (smaller f = wider)
            else:
                scale_lo = s
        s = scale_hi
        return np.array(
            [[fx0 * s, 0, (w - 1) / 2.0], [0, fy0 * s, (h - 1) / 2.0], [0, 0, 1]]
        )

    def _make_remap(self):
        ys, xs = np.mgrid[0 : self.h, 0 : self.w]
        dx, dy = self.distort(
            xs.astype(np.float64).ravel(), ys.astype(np.float64).ravel(),
            self.pars, self.K,
        )
        ok = (
            (dx >= 0) & (dx < self.w_org - 1) & (dy >= 0) & (dy < self.h_org - 1)
        )

        def table(a):
            return torch.as_tensor(a.reshape(self.h, self.w), device=self.device)

        self.remap_x = table(np.where(ok, dx, 0).astype(np.float32))
        self.remap_y = table(np.where(ok, dy, 0).astype(np.float32))
        self.remap_ok = table(ok)

    def undistort(self, img):
        """img: (H_org, W_org) tensor on the device (or numpy) -> (h, w)
        float32 tensor on the device."""
        img = torch.as_tensor(img, device=self.device).to(torch.float32)
        if self.passthrough:
            return img
        out = bilinear(img, self.remap_x, self.remap_y)
        return torch.where(self.remap_ok, out, torch.zeros_like(out))


class PhotometricUndistorter:
    """Inverse response + vignette correction (PhotometricUndistorter). `G`
    (256,) and `V` (h, w) are float32 tensors on `device` (None: the GPU),
    or None when the file is not given."""

    def __init__(self, gamma_path: Optional[str], vignette_path: Optional[str],
                 w: int, h: int, device=None):
        self.device = default_device(device)
        if gamma_path and os.path.exists(gamma_path):
            G = np.loadtxt(gamma_path).astype(np.float32)
            assert G.ndim == 1 and G.size >= 256, "pcalib must have >=256 values"
            G = G[:256]
            # normalize to [0, 255] output irradiance like the reference
            G = (G - G.min()) / (G.max() - G.min()) * 255.0
            self.G = torch.as_tensor(G, device=self.device)
        else:
            self.G = None
        if vignette_path and os.path.exists(vignette_path):
            from PIL import Image

            V = np.asarray(Image.open(vignette_path)).astype(np.float32)
            V = V / V.max()
            if V.shape != (h, w):
                yi = np.linspace(0, V.shape[0] - 1, h).astype(int)
                xi = np.linspace(0, V.shape[1] - 1, w).astype(int)
                V = V[np.ix_(yi, xi)]
            self.V = torch.as_tensor(np.maximum(V, 1e-3), device=self.device)
        else:
            self.V = None

    def __call__(self, img):
        out = torch.as_tensor(img, device=self.device).to(torch.float32)
        if self.G is not None:
            # float -> int truncates toward zero, as numpy's astype does
            out = self.G[torch.clamp(out, 0, 255).to(torch.int64)]
        if self.V is not None:
            out = out / self.V
        return out

    def gamma_grad_lut(self):
        """B'(I) table for gradient re-weighting (CalibHessian::getBGradOnly)."""
        if self.G is None:
            return None
        g = np.gradient(self.G.cpu().numpy())
        return torch.as_tensor(g.astype(np.float32), device=self.device)


def parse_calib_file(path: str):
    """Parse the reference's 5-line calib format (Undistort.cpp:700-905):

      line 1: model + params ("Pinhole fx fy cx cy 0" or "FOV ..." or raw
              "fx fy cx cy omega"; values <=1 are relative to image size)
      line 2: input size "w h"
      line 3: output mode: "crop" | "full" | "none" | "fx fy cx cy 0"
      line 4: output size "w h"
      line 5: baseline [m]

    Returns (model, pars, (w_org, h_org), out_mode, (w_out, h_out), baseline).
    """
    with open(path) as f:
        lines = [l.strip() for l in f if l.strip()]
    toks = lines[0].split()
    if toks[0] in _MODELS:
        model = toks[0]
        pars = [float(t) for t in toks[1:]]
    else:
        vals = [float(t) for t in toks]
        if len(vals) == 5:
            model = "FOV" if vals[4] != 0 else "Pinhole"
        elif len(vals) == 8:
            model = "RadTan"
        else:
            model = "Pinhole"
        pars = vals
    w_org, h_org = (int(v) for v in lines[1].split()[:2])
    # relative intrinsics (<=1) are scaled by image size (Undistort.cpp:737-760)
    if pars[0] <= 1.0 and pars[1] <= 1.0:
        pars[0] *= w_org
        pars[1] *= h_org
        pars[2] = pars[2] * w_org - 0.5
        pars[3] = pars[3] * h_org - 0.5
    l3 = lines[2]
    if l3 in ("crop", "full", "none"):
        out_mode = "crop" if l3 == "full" else l3  # full ~ crop fallback here
    else:
        out_mode = tuple(float(t) for t in l3.split()[:4])
    w_out, h_out = (int(v) for v in lines[3].split()[:2])
    baseline = float(lines[4]) if len(lines) > 4 else 0.0
    return model, pars, (w_org, h_org), out_mode, (w_out, h_out), baseline


def from_calib_file(path: str, device=None) -> Undistorter:
    model, pars, (w0, h0), out_mode, (w1, h1), bl = parse_calib_file(path)
    return Undistorter(model, pars, w0, h0, out_mode, w1, h1, baseline=bl, device=device)
