"""The benchmark's traffic generator: the rendered street corridor.

Frozen from `stereo_dso_g2o_tpu_torch/io/synthetic.py` at commit
6bc983070e31600c426f47f1ed626131eb797c90 (`smooth_texture`, `Rect`,
`PlaneScene`, `corridor_scene`, `forward_trajectory`, `stereo_pose`,
`default_K`, `_pack_scene`, `_supersample_kinvs` and the torch ray caster
`_raycast`), so that a later change to the port's copy does not change the
benchmark's frames. Departures, none changes a pixel's rule:

- the ray caster takes a batch of poses at once and every rectangle at
  once ((B, h, w, R) planes instead of one (h, w) plane a rectangle), with
  a rectangle's coordinates of the hit taken as (C - origin).e + s (d.e)
  (float32 rounding apart, the same: 1 pixel in 20,000 differs by one
  level), and skips a rectangle that lies wholly behind every camera of
  the batch (camera z under 0.1 at all four corners: no ray hits it, so
  the nearest hit is unchanged);
- it computes in a given dtype (`dtype=torch.bfloat16` is the control of
  the comparison that decides `correct`, `reference.py`).

Conventions: world-to-camera pose T_cw maps world points X_c = R X_w + t;
the right camera sits at +baseline along the left camera's x-axis.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch


def smooth_texture(rng: np.random.Generator, size: int = 512, octaves: int = 5) -> np.ndarray:
    """Multi-octave smooth random texture in [20, 235] (float32, square)."""
    tex = np.zeros((size, size), dtype=np.float64)
    amp = 1.0
    total = 0.0
    for o in range(octaves):
        n = max(2, size >> (octaves - 1 - o))
        grid = rng.standard_normal((n, n))
        yi = np.linspace(0, n - 1, size)
        xi = np.linspace(0, n - 1, size)
        y0 = np.floor(yi).astype(int)
        x0 = np.floor(xi).astype(int)
        y1 = np.minimum(y0 + 1, n - 1)
        x1 = np.minimum(x0 + 1, n - 1)
        fy = (yi - y0)[:, None]
        fx = (xi - x0)[None, :]
        up = (
            grid[np.ix_(y0, x0)] * (1 - fy) * (1 - fx)
            + grid[np.ix_(y0, x1)] * (1 - fy) * fx
            + grid[np.ix_(y1, x0)] * fy * (1 - fx)
            + grid[np.ix_(y1, x1)] * fy * fx
        )
        tex += amp * up
        total += amp
        amp *= 0.6
    tex /= total
    tex = (tex - tex.min()) / (tex.max() - tex.min() + 1e-12)
    return (20.0 + 215.0 * tex).astype(np.float32)


def _basis(normal):
    n = normal / np.linalg.norm(normal)
    a = np.array([1.0, 0.0, 0.0]) if abs(n[0]) < 0.9 else np.array([0.0, 1.0, 0.0])
    e1 = np.cross(n, a)
    e1 = e1 / np.linalg.norm(e1)
    return n, e1, np.cross(n, e1)


@dataclasses.dataclass
class Rect:
    """A finite textured rectangle: n.X = dist, |(X-origin).e1| <= ext1,
    |(X-origin).e2| <= ext2. An infinite one (ext inf) is a backdrop."""

    normal: np.ndarray
    dist: float
    origin: np.ndarray
    ext1: float
    ext2: float
    tex: np.ndarray
    tex_scale: float = 20.0
    e1: np.ndarray = None
    e2: np.ndarray = None

    def __post_init__(self):
        self.normal, self.e1, self.e2 = _basis(self.normal)


def corridor_scene(seed, length: float = 80.0, box_spacing: float = 9.0, lateral: float = 12.0,
                   backdrop_margin: float = 30.0, clearance: float = 2.5) -> List[Rect]:
    """A street corridor populated along a forward trajectory of up to
    `length` meters: staggered box faces, side facades, ground, backdrop
    (the last, infinite). `seed`: an int or a sequence of ints."""
    rng = np.random.default_rng(seed)
    rects: List[Rect] = []
    z = 6.0
    while z < length + backdrop_margin * 0.5:
        half_w = rng.uniform(1.0, 3.5)
        half_h = rng.uniform(1.0, 2.5)
        side = rng.choice([-1.0, 1.0])
        cx = side * rng.uniform(clearance + half_w, max(lateral, clearance + half_w + 0.5))
        cy = rng.uniform(-1.0, 1.5)
        nrm = np.array([rng.uniform(-0.15, 0.15), rng.uniform(-0.1, 0.1), -1.0])
        nrm = nrm / np.linalg.norm(nrm)
        origin = np.array([cx, cy, z])
        rects.append(Rect(nrm, float(nrm @ origin), origin, half_w, half_h,
                          smooth_texture(rng, 256), rng.uniform(15.0, 40.0)))
        z += rng.uniform(0.7, 1.3) * box_spacing
    full = length + backdrop_margin
    for sgn in (-1.0, 1.0):
        x = sgn * (lateral + 2.0)
        rects.append(Rect(np.array([-sgn, 0.0, 0.0]), -abs(x), np.array([x, 0.0, full * 0.5]),
                          full * 0.6, 4.0, smooth_texture(rng, 512), rng.uniform(10.0, 25.0)))
    rects.append(Rect(np.array([0.0, -1.0, 0.0]), -1.65, np.array([0.0, 1.65, full * 0.5]),
                      full * 0.7, lateral + 4.0, smooth_texture(rng, 512), rng.uniform(8.0, 20.0)))
    rects.append(Rect(np.array([0.02, -0.02, -1.0]), -(length + backdrop_margin), np.zeros(3),
                      np.inf, np.inf, smooth_texture(rng, 256), 5.0))
    return rects


def forward_trajectory(n: int, step: float = 0.35, yaw_amp: float = 0.15,
                       yaw_period: float = 60.0, y_bob: float = 0.01) -> np.ndarray:
    """KITTI-like forward trajectory with sinusoidal yaw and small vertical
    bobbing: world-to-camera poses T_cw (n, 4, 4), float64."""
    poses = np.empty((n, 4, 4))
    pos = np.zeros(3)
    for i in range(n):
        yaw = yaw_amp * np.sin(2 * np.pi * i / yaw_period)
        cy, sy = np.cos(yaw), np.sin(yaw)
        R_wc = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        if i > 0:
            pos = pos + step * (R_wc @ np.array([0.0, 0.0, 1.0]))
        T_wc = np.eye(4)
        T_wc[:3, :3] = R_wc
        T_wc[:3, 3] = pos + np.array([0.0, y_bob * np.sin(0.9 * i), 0.0])
        poses[i] = np.linalg.inv(T_wc)
    return poses


def stereo_pose(T_cw_left: np.ndarray, baseline: float) -> np.ndarray:
    """World-to-cam pose of the right camera: T_rw = Shift(-b) @ T_lw."""
    S = np.eye(4)
    S[0, 3] = -baseline
    return S @ T_cw_left


def default_K(w: int, h: int, fov_deg: float = 60.0) -> np.ndarray:
    f = 0.5 * w / np.tan(np.radians(fov_deg) / 2)
    return np.array([[f, 0, (w - 1) / 2.0], [0, f, (h - 1) / 2.0], [0, 0, 1.0]])


def _supersample_kinvs(K: np.ndarray, n: int) -> np.ndarray:
    """Inverse intrinsics for the n x n subpixel offsets (principal point
    shifted by -off)."""
    if n <= 1:
        return np.linalg.inv(K)[None]
    kinvs = []
    for a in range(n):
        for b in range(n):
            Ks = K.copy()
            Ks[:2, 2] = K[:2, 2] - np.array([(b + 0.5) / n - 0.5, (a + 0.5) / n - 0.5])
            kinvs.append(np.linalg.inv(Ks))
    return np.stack(kinvs)


class Scene:
    """A corridor packed on a device: the rectangles' planes, extents and
    textures as dense tensors, float32 (or `dtype`)."""

    def __init__(self, rects: List[Rect], device, dtype=torch.float32):
        self.rects = rects
        smax = max(r.tex.shape[0] for r in rects)
        tex = np.zeros((len(rects), smax, smax), np.float32)
        for i, r in enumerate(rects):
            tex[i, :r.tex.shape[0], :r.tex.shape[0]] = r.tex

        def t(x, dt=dtype):
            return torch.as_tensor(np.asarray(x, np.float32), device=device).to(dt)

        self.normal = t([r.normal for r in rects])
        self.dist = t([r.dist for r in rects])
        self.origin = t([r.origin for r in rects])
        self.e1 = t([r.e1 for r in rects])
        self.e2 = t([r.e2 for r in rects])
        self.ext1 = t([r.ext1 for r in rects])
        self.ext2 = t([r.ext2 for r in rects])
        self.tex = t(tex, torch.float32)
        self.tex_size = torch.as_tensor([r.tex.shape[0] for r in rects], device=device)
        self.tex_scale = t([r.tex_scale for r in rects])
        self.device, self.dtype = device, dtype

    def behind(self, poses_cw: np.ndarray) -> np.ndarray:
        """(R,) bool: the rectangle lies behind every camera of the batch
        (all four corners at camera z <= 0.1)."""
        out = np.zeros(len(self.rects), bool)
        for i, r in enumerate(self.rects):
            if not np.isfinite(r.ext1):
                continue
            c = np.array([r.origin + a * r.ext1 * r.e1 + b * r.ext2 * r.e2
                          for a in (-1, 1) for b in (-1, 1)])  # (4, 3)
            z = np.einsum("bj,cj->bc", poses_cw[:, 2, :3], c) + poses_cw[:, 2, 3:4]
            out[i] = bool((z <= 0.1).all())
        return out


def raycast(scene: Scene, K: np.ndarray, w: int, h: int, poses_cw: np.ndarray,
            supersample: int = 2, want_image: bool = True):
    """Poses (B, 4, 4) -> (images (B, h, w) supersample-averaged float32 or
    None, idepths (B, h, w) in the scene's dtype), on the scene's device.

    Strict nearest hit with s > 0.1 (the first rectangle wins ties),
    texture tiled by its own size, bilinear wrap sampling, idepth from the
    centre-ish supersample. Computed in the scene's dtype; the texture
    lookup in float32."""
    dev, dt = scene.device, scene.dtype
    BIG = 1e30 if dt == torch.float32 else 3e38
    poses = torch.as_tensor(np.asarray(poses_cw), device=dev).to(dt)  # (B, 4, 4)
    R, t = poses[:, :3, :3], poses[:, :3, 3]
    C = -torch.einsum("bji,bj->bi", R, t)  # (B, 3) camera centres
    vv, uu = torch.meshgrid(torch.arange(h, device=dev, dtype=torch.float32),
                            torch.arange(w, device=dev, dtype=torch.float32), indexing="ij")
    p = torch.stack([uu, vv, torch.ones_like(uu)], dim=-1)  # (h, w, 3)
    kinvs = torch.as_tensor(_supersample_kinvs(K, supersample), device=dev).float()
    n = supersample
    centre = ((n - 1) // 2) * n + (n - 1) // 2 if n > 1 else 0
    skip = scene.behind(np.asarray(poses_cw))
    act = torch.as_tensor(np.flatnonzero(~skip), device=dev)
    nrm, e1, e2 = scene.normal[act], scene.e1[act], scene.e2[act]
    ext1, ext2 = scene.ext1[act], scene.ext2[act]
    num = scene.dist[act][None, :] - C @ nrm.T  # (B, R)
    # (C - origin) . e, so that a = (C + s d - origin) . e = c + s (d . e)
    c1 = C @ e1.T - (scene.origin[act] * e1).sum(-1)
    c2 = C @ e2.T - (scene.origin[act] * e2).sum(-1)
    B = poses.shape[0]
    img = torch.zeros((B, h, w), dtype=torch.float32, device=dev) if want_image else None
    idepth = None
    for si in range(kinvs.shape[0]):
        if not want_image and si != centre:
            continue
        d_c = (p @ kinvs[si].T).to(dt)  # (h, w, 3): pixel rays, rounded to the dtype
        d_w = torch.einsum("hwj,bjk->bhwk", d_c, R)  # (B, h, w, 3)
        # every rectangle at once: (B, h, w, R)
        denom = d_w @ nrm.T
        safe = torch.abs(denom) >= 1e-12
        s_r = torch.where(safe, num[:, None, None, :]
                          / torch.where(safe, denom, torch.ones_like(denom)),
                          torch.full_like(denom, BIG))
        del denom
        a1 = c1[:, None, None, :] + s_r * (d_w @ e1.T)
        a2 = c2[:, None, None, :] + s_r * (d_w @ e2.T)
        hit = ((torch.abs(a1) <= ext1) & (torch.abs(a2) <= ext2) & safe
               & (s_r > 0.1) & (s_r < BIG))
        # the nearest hit; of equal ones the first rectangle, as min() gives
        best, j = torch.min(torch.where(hit, s_r, torch.full_like(s_r, BIG)), dim=-1)
        del s_r, hit, safe
        a1b = torch.gather(a1, -1, j[..., None])[..., 0]
        a2b = torch.gather(a2, -1, j[..., None])[..., 0]
        del a1, a2
        widx = act[j]
        found = best < BIG
        if si == centre:
            idepth = torch.where(found, 1.0 / best, torch.zeros_like(best))
        if not want_image:
            continue
        scale = scene.tex_scale[widx].float()
        size_i = scene.tex_size[widx]
        size = size_i.float()
        zero = torch.zeros_like(scale)
        ut = torch.remainder(torch.where(found, a1b.float() * scale, zero), size)
        vt = torch.remainder(torch.where(found, a2b.float() * scale, zero), size)
        x0f, y0f = torch.floor(ut), torch.floor(vt)
        fx = torch.clamp(ut - x0f, 0.0, 1.0)
        fy = torch.clamp(vt - y0f, 0.0, 1.0)
        x0 = torch.remainder(x0f.long(), size_i)
        y0 = torch.remainder(y0f.long(), size_i)
        x1 = torch.remainder(x0 + 1, size_i)
        y1 = torch.remainder(y0 + 1, size_i)
        tex = scene.tex
        val = (tex[widx, y0, x0] * (1 - fy) * (1 - fx) + tex[widx, y0, x1] * (1 - fy) * fx
               + tex[widx, y1, x0] * fy * (1 - fx) + tex[widx, y1, x1] * fy * fx)
        img = img + torch.where(found, val, zero)
    if want_image:
        img = img / kinvs.shape[0]
    return img, idepth


def render_stereo(scene: Scene, K: np.ndarray, w: int, h: int, baseline: float,
                  poses_cw: np.ndarray, exposures: Optional[np.ndarray] = None,
                  chunk: int = 16):
    """Stereo frames (lefts, rights): (N, h, w) uint8 tensors on the
    scene's device; the exposure scales both before the uint8 clip."""
    N = len(poses_cw)
    expo = np.ones(N) if exposures is None else np.asarray(exposures)
    dev = scene.device
    lefts = torch.empty((N, h, w), dtype=torch.uint8, device=dev)
    rights = torch.empty((N, h, w), dtype=torch.uint8, device=dev)
    for a in range(0, N, chunk):
        sl = slice(a, min(a + chunk, N))
        e = torch.as_tensor(expo[sl].astype(np.float32), device=dev)[:, None, None]
        for out, poses in ((lefts, poses_cw[sl]),
                           (rights, np.stack([stereo_pose(T, baseline) for T in poses_cw[sl]]))):
            img, _ = raycast(scene, K, w, h, poses)
            out[sl] = torch.clamp(img * e, 0.0, 255.0).to(torch.uint8)
    return lefts, rights


def true_idepth(scene: Scene, K: np.ndarray, w: int, h: int, poses_cw: np.ndarray,
                supersample: int = 1, chunk: int = 8) -> torch.Tensor:
    """(N, h, w) true inverse depth of each pose's left image, in the
    scene's dtype: at pixel centres (`supersample=1`), or at the sample the
    frames' idepth comes from."""
    outs = []
    for a in range(0, len(poses_cw), chunk):
        outs.append(raycast(scene, K, w, h, poses_cw[a:a + chunk], supersample,
                            want_image=False)[1])
    return torch.cat(outs)
