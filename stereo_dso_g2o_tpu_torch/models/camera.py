"""Camera calibration state: the per-level intrinsics pyramid + baseline.

Port of `stereo_dso_g2o_tpu/models/camera.py`. fx/fy/cx/cy live as a (4,)
value tensor (optimizable in windowed BA), per-level values follow
globalCalib.cpp:90-99:  fx_l = fx_0 * 0.5^l ; cx_l = (cx_0 + 0.5) / 2^l - 0.5.
A Calib of N sequences that share the image size holds (N, 4) intrinsics
and (N,) baselines; its per-level values and matrices lead with N.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from stereo_dso_g2o_tpu_torch import default_device


@dataclasses.dataclass
class Calib:
    c: torch.Tensor  # (4,) float32 fx, fy, cx, cy at level 0 (or (N, 4))
    baseline: torch.Tensor  # () float32 stereo baseline [m] (or (N,))
    w: Tuple[int, ...]  # per-level widths
    h: Tuple[int, ...]  # per-level heights

    @property
    def n_levels(self) -> int:
        return len(self.w)

    @property
    def device(self):
        return self.c.device

    def fx(self, lvl: int):
        return self.c[..., 0] * (0.5**lvl)

    def fy(self, lvl: int):
        return self.c[..., 1] * (0.5**lvl)

    def cx(self, lvl: int):
        return (self.c[..., 2] + 0.5) / (1 << lvl) - 0.5

    def cy(self, lvl: int):
        return (self.c[..., 3] + 0.5) / (1 << lvl) - 0.5

    def K(self, lvl: int):
        fx, fy, cx, cy = self.fx(lvl), self.fy(lvl), self.cx(lvl), self.cy(lvl)
        z = torch.zeros_like(fx)
        o = torch.ones_like(fx)
        return torch.stack(
            [
                torch.stack([fx, z, cx], -1),
                torch.stack([z, fy, cy], -1),
                torch.stack([z, z, o], -1),
            ],
            -2,
        )

    def Ki(self, lvl: int):
        fx, fy, cx, cy = self.fx(lvl), self.fy(lvl), self.cx(lvl), self.cy(lvl)
        z = torch.zeros_like(fx)
        o = torch.ones_like(fx)
        return torch.stack(
            [
                torch.stack([1.0 / fx, z, -cx / fx], -1),
                torch.stack([z, 1.0 / fy, -cy / fy], -1),
                torch.stack([z, z, o], -1),
            ],
            -2,
        )

    def bf(self):
        """baseline * fx — disparity-to-inverse-depth factor."""
        return self.baseline * self.c[..., 0]


def calib_from_c(c: torch.Tensor, baseline, w0: int, h0: int, n_levels: int) -> Calib:
    """Calib from a (4,) intrinsics tensor (or (N, 4) with (N,) baselines)
    and the level-0 image size."""
    return Calib(
        c=c,
        baseline=torch.as_tensor(baseline, dtype=torch.float32, device=c.device),
        w=tuple(w0 >> lvl for lvl in range(n_levels)),
        h=tuple(h0 >> lvl for lvl in range(n_levels)),
    )


def make_calib(fx, fy, cx, cy, baseline, w: int, h: int, n_levels: int = 6,
               device=None) -> Calib:
    """device=None: the GPU (`default_device`); "cpu" asks for the CPU."""
    device = default_device(device)
    ws = tuple(w >> lvl for lvl in range(n_levels))
    hs = tuple(h >> lvl for lvl in range(n_levels))
    for lvl in range(1, n_levels):
        if ws[lvl] * 2 != ws[lvl - 1] or hs[lvl] * 2 != hs[lvl - 1]:
            raise ValueError(
                f"image size {w}x{h} not divisible by 2^{n_levels - 1}; "
                f"crop/resize first (cf. globalCalib.cpp:55-60 warning)"
            )
    return Calib(
        c=torch.tensor([fx, fy, cx, cy], dtype=torch.float32, device=device),
        baseline=torch.tensor(float(baseline), dtype=torch.float32, device=device),
        w=ws,
        h=hs,
    )
