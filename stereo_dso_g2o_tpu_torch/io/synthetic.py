"""Synthetic stereo scenes: numpy scene builders and renderers + a torch
ray caster.

Port of `stereo_dso_g2o_tpu/io/synthetic.py`. The host numpy parts are
copies: the scene builders (`smooth_texture`, `default_scene`, `box_scene`,
`corridor_scene`, `forward_trajectory`, `default_K`, `stereo_pose`,
`_pack_scene`) and the reference renderers (`_sample_tex`, `render`,
`render_stereo_pair`, `render_sequence`, `render_multi`,
`render_multi_stereo_pair`), which give the same arrays as the JAX module's.
The jitted JAX ray caster (`_raycast_jax`) becomes `_raycast`, a torch ray
caster that renders one pose at a time on a device (rectangles are
intersected in a loop, so memory is one (h, w) plane per intermediate
instead of the (R, S2, h, w, 3) cube); `render_multi_batch`,
`render_multi_fast` and `render_stereo_sequence_fast` sit on it.

Conventions: world-to-camera pose T_cw maps world points X_c = R X_w + t;
the right camera sits at +baseline along the left camera's x-axis.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from stereo_dso_g2o_tpu_torch import default_device


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


def _sample_tex(tex: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Bilinear sample with wraparound (texture tiles infinitely)."""
    H, W = tex.shape
    u = np.mod(u, W)
    v = np.mod(v, H)
    x0 = np.floor(u).astype(int)
    y0 = np.floor(v).astype(int)
    fx = np.clip(u - x0, 0.0, 1.0)
    fy = np.clip(v - y0, 0.0, 1.0)
    # float mod of huge inputs can round to exactly W/H; re-wrap the integer
    x0 = np.mod(x0, W)
    y0 = np.mod(y0, H)
    x1 = (x0 + 1) % W
    y1 = (y0 + 1) % H
    return (
        tex[y0, x0] * (1 - fy) * (1 - fx)
        + tex[y0, x1] * (1 - fy) * fx
        + tex[y1, x0] * fy * (1 - fx)
        + tex[y1, x1] * fy * fx
    ).astype(np.float32)


@dataclasses.dataclass
class PlaneScene:
    """A textured plane n . X = dist in world coordinates."""

    normal: np.ndarray
    dist: float
    tex: np.ndarray
    tex_scale: float = 20.0
    e1: np.ndarray = None
    e2: np.ndarray = None

    def __post_init__(self):
        n = self.normal / np.linalg.norm(self.normal)
        self.normal = n
        a = np.array([1.0, 0.0, 0.0]) if abs(n[0]) < 0.9 else np.array([0.0, 1.0, 0.0])
        e1 = np.cross(n, a)
        self.e1 = e1 / np.linalg.norm(e1)
        self.e2 = np.cross(n, self.e1)


def default_scene(seed: int = 0) -> PlaneScene:
    """A plane tilted relative to the camera, ~5m away along +z."""
    rng = np.random.default_rng(seed)
    return PlaneScene(
        normal=np.array([0.15, -0.1, -1.0]),
        dist=-5.0,
        tex=smooth_texture(rng),
    )


@dataclasses.dataclass
class Rect:
    """A finite textured rectangle: n.X = dist, |(X-origin).e1| <= ext1,
    |(X-origin).e2| <= ext2."""

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
        n = self.normal / np.linalg.norm(self.normal)
        self.normal = n
        a = np.array([1.0, 0.0, 0.0]) if abs(n[0]) < 0.9 else np.array([0.0, 1.0, 0.0])
        e1 = np.cross(n, a)
        self.e1 = e1 / np.linalg.norm(e1)
        self.e2 = np.cross(n, self.e1)


@dataclasses.dataclass
class MultiScene:
    """A set of finite rectangles + an optional infinite backdrop plane."""

    rects: List[Rect]
    backdrop: Optional[PlaneScene] = None


def box_scene(
    seed: int = 0,
    n_boxes: int = 6,
    depth_range: Tuple[float, float] = (8.0, 40.0),
    lateral: float = 12.0,
    ground: bool = True,
    backdrop_dist: float = 60.0,
) -> MultiScene:
    """A KITTI-flavoured street block: frontal box faces at staggered depths,
    side facades, a ground plane, and a far backdrop. All primitives textured
    independently (no cross-boundary texture continuity to help matching)."""
    rng = np.random.default_rng(seed)
    rects: List[Rect] = []
    zs = np.sort(rng.uniform(depth_range[0], depth_range[1], n_boxes))
    for i, z in enumerate(zs):
        # frontal face (normal -z) at depth z, offset laterally; kept off the
        # exact optical axis so forward motion reveals occluded background
        cx = rng.uniform(-lateral, lateral)
        cy = rng.uniform(-1.0, 1.5)
        half_w = rng.uniform(1.0, 3.5)
        half_h = rng.uniform(1.0, 2.5)
        rects.append(
            Rect(
                normal=np.array([rng.uniform(-0.15, 0.15), rng.uniform(-0.1, 0.1), -1.0]),
                dist=-z,
                origin=np.array([cx, cy, z]),
                ext1=half_w,
                ext2=half_h,
                tex=smooth_texture(rng, 256),
                tex_scale=rng.uniform(15.0, 40.0),
            )
        )
    # two side facades (normals +-x), like building walls along the street
    for sgn in (-1.0, 1.0):
        x = sgn * (lateral + 2.0)
        rects.append(
            Rect(
                normal=np.array([-sgn, 0.0, 0.0]),
                dist=-abs(x),  # n.X = -sgn*x on the wall
                origin=np.array([x, 0.0, depth_range[1] * 0.5]),
                ext1=depth_range[1],
                ext2=4.0,
                tex=smooth_texture(rng, 256),
                tex_scale=rng.uniform(10.0, 25.0),
            )
        )
    if ground:
        rects.append(
            Rect(
                normal=np.array([0.0, -1.0, 0.0]),
                dist=-1.65,  # camera height above ground, KITTI-like
                origin=np.array([0.0, 1.65, depth_range[1] * 0.5]),
                ext1=depth_range[1] * 1.5,
                ext2=lateral + 4.0,
                tex=smooth_texture(rng, 256),
                tex_scale=rng.uniform(8.0, 20.0),
            )
        )
    backdrop = PlaneScene(
        normal=np.array([0.02, -0.02, -1.0]),
        dist=-backdrop_dist,
        tex=smooth_texture(rng, 256),
        tex_scale=5.0,
    )
    return MultiScene(rects=rects, backdrop=backdrop)


def corridor_scene(
    seed: int = 0,
    length: float = 80.0,
    box_spacing: float = 9.0,
    lateral: float = 12.0,
    ground: bool = True,
    backdrop_margin: float = 30.0,
    clearance: float = 2.5,
) -> MultiScene:
    """A street corridor populated along a forward trajectory of up to
    `length` meters: staggered box faces, side facades, ground, backdrop."""
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
        rects.append(
            Rect(
                normal=nrm,
                dist=float(nrm @ origin),
                origin=origin,
                ext1=half_w,
                ext2=half_h,
                tex=smooth_texture(rng, 256),
                tex_scale=rng.uniform(15.0, 40.0),
            )
        )
        z += rng.uniform(0.7, 1.3) * box_spacing
    full = length + backdrop_margin
    for sgn in (-1.0, 1.0):
        x = sgn * (lateral + 2.0)
        rects.append(
            Rect(
                normal=np.array([-sgn, 0.0, 0.0]),
                dist=-abs(x),
                origin=np.array([x, 0.0, full * 0.5]),
                ext1=full * 0.6,
                ext2=4.0,
                tex=smooth_texture(rng, 512),
                tex_scale=rng.uniform(10.0, 25.0),
            )
        )
    if ground:
        rects.append(
            Rect(
                normal=np.array([0.0, -1.0, 0.0]),
                dist=-1.65,
                origin=np.array([0.0, 1.65, full * 0.5]),
                ext1=full * 0.7,
                ext2=lateral + 4.0,
                tex=smooth_texture(rng, 512),
                tex_scale=rng.uniform(8.0, 20.0),
            )
        )
    backdrop = PlaneScene(
        normal=np.array([0.02, -0.02, -1.0]),
        dist=-(length + backdrop_margin),
        tex=smooth_texture(rng, 256),
        tex_scale=5.0,
    )
    return MultiScene(rects=rects, backdrop=backdrop)


def render_multi(
    scene: MultiScene, K: np.ndarray, w: int, h: int, T_cw: np.ndarray,
    supersample: int = 2,
) -> Tuple[np.ndarray, np.ndarray]:
    """Ray-cast the rectangle set. Returns (image, idepth) with exact GT.

    `supersample` > 1 area-integrates each pixel over an NxN subpixel grid
    (like a real sensor). Point-sampled high-frequency texture aliases
    differently from every viewpoint, which acts as several gray levels of
    view-dependent photometric noise and directly biases direct tracking —
    measured as ~5 gray levels of irreducible tracking RMSE at 1 sample."""
    if supersample > 1:
        n = supersample
        acc = None
        idepth0 = None
        for a in range(n):
            for b in range(n):
                off = np.array(
                    [(b + 0.5) / n - 0.5, (a + 0.5) / n - 0.5, 0.0]
                )
                Ks = K.copy()
                Ks[:2, 2] = K[:2, 2] - off[:2]
                im, idep = render_multi(scene, Ks, w, h, T_cw, supersample=1)
                acc = im if acc is None else acc + im
                if a == b == (n - 1) // 2:
                    idepth0 = idep  # center-ish sample for exact GT depth
        return (acc / (n * n)).astype(np.float32), idepth0

    R = T_cw[:3, :3]
    t = T_cw[:3, 3]
    C = -R.T @ t
    Kinv = np.linalg.inv(K)
    us, vs = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    d_c = np.stack([us, vs, np.ones_like(us)], axis=-1) @ Kinv.T  # (h, w, 3)
    d_w = d_c @ R

    best_s = np.full((h, w), np.inf)
    img = np.zeros((h, w), np.float32)

    def consider(s, hit_img, mask):
        nonlocal best_s, img
        closer = mask & np.isfinite(s) & (s > 0.1) & (s < best_s)
        best_s = np.where(closer, s, best_s)
        img = np.where(closer, hit_img, img)

    if scene.backdrop is not None:
        b = scene.backdrop
        denom = d_w @ b.normal
        s = (b.dist - C @ b.normal) / np.where(np.abs(denom) < 1e-12, np.nan, denom)
        X_w = C[None, None, :] + s[..., None] * d_w
        u_t = (X_w @ b.e1) * b.tex_scale
        v_t = (X_w @ b.e2) * b.tex_scale
        hit = _sample_tex(b.tex, np.nan_to_num(u_t), np.nan_to_num(v_t))
        consider(s, hit, np.ones((h, w), bool))

    for r in scene.rects:
        denom = d_w @ r.normal
        s = (r.dist - C @ r.normal) / np.where(np.abs(denom) < 1e-12, np.nan, denom)
        X_w = C[None, None, :] + s[..., None] * d_w
        rel = X_w - r.origin[None, None, :]
        a1 = rel @ r.e1
        a2 = rel @ r.e2
        inside = (np.abs(a1) <= r.ext1) & (np.abs(a2) <= r.ext2)
        u_t = a1 * r.tex_scale
        v_t = a2 * r.tex_scale
        hit = _sample_tex(r.tex, np.nan_to_num(u_t), np.nan_to_num(v_t))
        consider(s, hit, inside)

    valid = np.isfinite(best_s)
    # depth along camera z equals s because d_c z-component is 1
    idepth = np.where(valid, 1.0 / np.where(valid, best_s, 1.0), 0.0).astype(np.float32)
    img = np.where(valid, img, 0.0).astype(np.float32)
    return img, idepth


def _pack_scene(scene: MultiScene):
    """Pack a MultiScene into dense numpy arrays; the backdrop becomes one
    more "rect" with infinite extents and origin 0."""
    prims = []
    for r in scene.rects:
        prims.append((r.normal, r.dist, r.origin, r.e1, r.e2, r.ext1, r.ext2,
                      r.tex, r.tex_scale))
    if scene.backdrop is not None:
        b = scene.backdrop
        prims.append((b.normal, b.dist, np.zeros(3), b.e1, b.e2,
                      np.inf, np.inf, b.tex, b.tex_scale))
    R = len(prims)
    smax = max(p[7].shape[0] for p in prims)
    pack = {
        "normal": np.zeros((R, 3), np.float32),
        "dist": np.zeros((R,), np.float32),
        "origin": np.zeros((R, 3), np.float32),
        "e1": np.zeros((R, 3), np.float32),
        "e2": np.zeros((R, 3), np.float32),
        "ext1": np.zeros((R,), np.float32),
        "ext2": np.zeros((R,), np.float32),
        "tex": np.zeros((R, smax, smax), np.float32),
        "tex_size": np.zeros((R,), np.int32),
        "tex_scale": np.zeros((R,), np.float32),
    }
    for i, (n, d, o, e1, e2, x1, x2, tex, ts) in enumerate(prims):
        s = tex.shape[0]
        pack["normal"][i] = n
        pack["dist"][i] = d
        pack["origin"][i] = o
        pack["e1"][i] = e1
        pack["e2"][i] = e2
        pack["ext1"][i] = x1
        pack["ext2"][i] = x2
        pack["tex"][i, :s, :s] = tex
        pack["tex_size"][i] = s
        pack["tex_scale"][i] = ts
    return pack


def _raycast(pack, Kinv_ss, R_cw, t_cw, w: int, h: int, center_idx: int):
    """One pose: (img (h,w) supersample-averaged, idepth (h,w)), float32.

    Same rules as the JAX ray caster: strict nearest hit with s > 0.1 (the
    first primitive wins ties), texture tiled by its own size, bilinear wrap
    sampling, idepth from supersample `center_idx`."""
    dev = R_cw.device
    BIG = 1e30
    C = -R_cw.T @ t_cw
    vv, uu = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=dev),
        torch.arange(w, dtype=torch.float32, device=dev),
        indexing="ij",
    )
    p = torch.stack([uu, vv, torch.ones_like(uu)], dim=-1)  # (h, w, 3)
    nrm, dist, origin = pack["normal"], pack["dist"], pack["origin"]
    e1, e2, ext1, ext2 = pack["e1"], pack["e2"], pack["ext1"], pack["ext2"]
    tex, tex_size, tex_scale = pack["tex"], pack["tex_size"], pack["tex_scale"]
    num_all = dist - nrm @ C  # (R,)
    img = torch.zeros((h, w), dtype=torch.float32, device=dev)
    idepth = None
    for si in range(Kinv_ss.shape[0]):
        d_c = p @ Kinv_ss[si].T
        d_w = d_c @ R_cw
        best = torch.full((h, w), BIG, dtype=torch.float32, device=dev)
        a1b = torch.zeros_like(best)
        a2b = torch.zeros_like(best)
        widx = torch.zeros((h, w), dtype=torch.long, device=dev)
        for r in range(nrm.shape[0]):
            denom = d_w @ nrm[r]
            safe = torch.abs(denom) >= 1e-12
            s_r = torch.where(
                safe, num_all[r] / torch.where(safe, denom, torch.ones_like(denom)),
                torch.full_like(denom, BIG),
            )
            rel = C + s_r[..., None] * d_w - origin[r]
            a1 = rel @ e1[r]
            a2 = rel @ e2[r]
            valid = (
                (torch.abs(a1) <= ext1[r]) & (torch.abs(a2) <= ext2[r])
                & (s_r > 0.1) & (s_r < BIG)
            )
            better = valid & (s_r < best)
            best = torch.where(better, s_r, best)
            a1b = torch.where(better, a1, a1b)
            a2b = torch.where(better, a2, a2b)
            widx = torch.where(better, torch.full_like(widx, r), widx)
        hit = best < BIG
        ts_scale = tex_scale[widx]
        tsize_i = tex_size[widx]
        tsize = tsize_i.to(torch.float32)
        ut = torch.remainder(torch.where(hit, a1b * ts_scale, torch.zeros_like(a1b)), tsize)
        vt = torch.remainder(torch.where(hit, a2b * ts_scale, torch.zeros_like(a2b)), tsize)
        x0f = torch.floor(ut)
        y0f = torch.floor(vt)
        fx = torch.clamp(ut - x0f, 0.0, 1.0)
        fy = torch.clamp(vt - y0f, 0.0, 1.0)
        x0 = torch.remainder(x0f.long(), tsize_i)
        y0 = torch.remainder(y0f.long(), tsize_i)
        x1 = torch.remainder(x0 + 1, tsize_i)
        y1 = torch.remainder(y0 + 1, tsize_i)
        val = (
            tex[widx, y0, x0] * (1 - fy) * (1 - fx)
            + tex[widx, y0, x1] * (1 - fy) * fx
            + tex[widx, y1, x0] * fy * (1 - fx)
            + tex[widx, y1, x1] * fy * fx
        )
        img = img + torch.where(hit, val, torch.zeros_like(val))
        if si == center_idx:
            idepth = torch.where(hit, 1.0 / best, torch.zeros_like(best))
    return img / Kinv_ss.shape[0], idepth


def _supersample_kinvs(K: np.ndarray, supersample: int) -> np.ndarray:
    """Inverse intrinsics for the NxN subpixel offsets (principal point
    shifted by -off)."""
    n = supersample
    kinvs = []
    if n <= 1:
        kinvs.append(np.linalg.inv(K))
    else:
        for a in range(n):
            for b in range(n):
                off = np.array([(b + 0.5) / n - 0.5, (a + 0.5) / n - 0.5])
                Ks = K.copy()
                Ks[:2, 2] = K[:2, 2] - off
                kinvs.append(np.linalg.inv(Ks))
    return np.stack(kinvs).astype(np.float32)


def _device_pack(scene: MultiScene, device):
    return {k: torch.as_tensor(v, device=device) for k, v in _pack_scene(scene).items()}


def render_multi_batch(
    scene: MultiScene, K: np.ndarray, w: int, h: int, poses: np.ndarray,
    supersample: int = 2, device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Render poses (B,4,4) -> (imgs (B,h,w) float32, idepths (B,h,w)) on
    `device` (None: the GPU)."""
    device = default_device(device)
    pack = _device_pack(scene, device)
    kinvs = torch.as_tensor(_supersample_kinvs(K, supersample), device=device)
    n = supersample
    center_idx = ((n - 1) // 2) * n + (n - 1) // 2 if n > 1 else 0
    imgs, ideps = [], []
    for T in np.asarray(poses):
        Tt = torch.as_tensor(np.asarray(T, np.float32), device=device)
        img, idep = _raycast(pack, kinvs, Tt[:3, :3], Tt[:3, 3], w, h, center_idx)
        imgs.append(img)
        ideps.append(idep)
    return torch.stack(imgs), torch.stack(ideps)


def render_multi_fast(
    scene: MultiScene, K: np.ndarray, w: int, h: int, T_cw: np.ndarray,
    supersample: int = 2, device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The torch ray caster for one pose: render_multi's (image, idepth) as
    float32 (h, w) tensors on `device` (None: the GPU)."""
    imgs, ideps = render_multi_batch(scene, K, w, h, np.asarray(T_cw)[None],
                                     supersample, device=device)
    return imgs[0], ideps[0]


def render_multi_stereo_pair(
    scene: MultiScene, K: np.ndarray, w: int, h: int, baseline: float,
    T_cw: Optional[np.ndarray] = None, exposure: float = 1.0,
):
    """Returns (left, right, idepth_left); exposure scales both images
    (photometric variation — the reference's ab-affine estimation target)."""
    if T_cw is None:
        T_cw = np.eye(4)
    left, idepth = render_multi(scene, K, w, h, T_cw)
    right, _ = render_multi(scene, K, w, h, stereo_pose(T_cw, baseline))
    if exposure != 1.0:
        left = np.clip(left * exposure, 0.0, 255.0)
        right = np.clip(right * exposure, 0.0, 255.0)
    return left, right, idepth


def render_stereo_sequence_fast(
    scene: MultiScene,
    K: np.ndarray,
    w: int,
    h: int,
    baseline: float,
    poses_cw: List[np.ndarray],
    exposures: Optional[np.ndarray] = None,
    supersample: int = 2,
    device=None,
):
    """Render a stereo sequence on `device` (None: the GPU).

    Returns (lefts (N,h,w) uint8, rights (N,h,w) uint8) tensors on `device`;
    exposure is applied before the uint8 clip."""
    device = default_device(device)
    N = len(poses_cw)
    expo = np.ones(N) if exposures is None else np.asarray(exposures)
    pack = _device_pack(scene, device)
    kinvs = torch.as_tensor(_supersample_kinvs(K, supersample), device=device)
    n = supersample
    center_idx = ((n - 1) // 2) * n + (n - 1) // 2 if n > 1 else 0
    lefts = torch.empty((N, h, w), dtype=torch.uint8, device=device)
    rights = torch.empty((N, h, w), dtype=torch.uint8, device=device)
    for f, T in enumerate(poses_cw):
        e = torch.tensor(float(np.float32(expo[f])), device=device)
        for out, pose in ((lefts, np.asarray(T)), (rights, stereo_pose(np.asarray(T), baseline))):
            Tt = torch.as_tensor(pose.astype(np.float32), device=device)
            img, _ = _raycast(pack, kinvs, Tt[:3, :3], Tt[:3, 3], w, h, center_idx)
            out[f] = torch.clamp(img * e, 0.0, 255.0).to(torch.uint8)
    return lefts, rights


def forward_trajectory(
    n: int,
    step: float = 0.35,
    yaw_amp: float = 0.15,
    yaw_period: float = 60.0,
    y_bob: float = 0.01,
    seed: int = 1,
) -> List[np.ndarray]:
    """KITTI-like forward trajectory with sinusoidal yaw and small vertical
    bobbing. Returns world-to-camera poses T_cw. `seed` is accepted for
    signature parity with the JAX package; the trajectory is deterministic."""
    poses = []
    pos = np.zeros(3)
    for i in range(n):
        yaw = yaw_amp * np.sin(2 * np.pi * i / yaw_period)
        cy, sy = np.cos(yaw), np.sin(yaw)
        R_wc = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        fwd = R_wc @ np.array([0.0, 0.0, 1.0])
        if i > 0:
            pos = pos + step * fwd
        pos_i = pos + np.array([0.0, y_bob * np.sin(0.9 * i), 0.0])
        T_wc = np.eye(4)
        T_wc[:3, :3] = R_wc
        T_wc[:3, 3] = pos_i
        poses.append(np.linalg.inv(T_wc))
    return poses


def render(
    scene: PlaneScene, K: np.ndarray, w: int, h: int, T_cw: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    R = T_cw[:3, :3]
    t = T_cw[:3, 3]
    # camera center in world: C = -R^T t ; ray dir world: R^T K^{-1} p
    C = -R.T @ t
    Kinv = np.linalg.inv(K)
    us, vs = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    d_c = np.stack([us, vs, np.ones_like(us)], axis=-1) @ Kinv.T  # (h, w, 3)
    d_w = d_c @ R  # == (R^T @ d_c^T)^T
    n = scene.normal
    denom = d_w @ n
    s = (scene.dist - C @ n) / np.where(np.abs(denom) < 1e-12, np.nan, denom)
    X_w = C[None, None, :] + s[..., None] * d_w
    # depth along camera z equals s because d_c z-component is 1
    valid = np.isfinite(s) & (s > 0.1)
    idepth = np.where(valid, 1.0 / np.where(valid, s, 1.0), 0.0).astype(np.float32)
    u_t = (X_w @ scene.e1) * scene.tex_scale
    v_t = (X_w @ scene.e2) * scene.tex_scale
    img = _sample_tex(scene.tex, np.nan_to_num(u_t), np.nan_to_num(v_t))
    img = np.where(valid, img, 0.0).astype(np.float32)
    return img, idepth


def stereo_pose(T_cw_left: np.ndarray, baseline: float) -> np.ndarray:
    """World-to-cam pose of the right camera: T_rw = Shift(-b) @ T_lw."""
    S = np.eye(4)
    S[0, 3] = -baseline
    return S @ T_cw_left


def render_stereo_pair(
    scene: PlaneScene, K: np.ndarray, w: int, h: int, baseline: float,
    T_cw: Optional[np.ndarray] = None,
):
    """Returns (left, right, idepth_left)."""
    if T_cw is None:
        T_cw = np.eye(4)
    left, idepth = render(scene, K, w, h, T_cw)
    right, _ = render(scene, K, w, h, stereo_pose(T_cw, baseline))
    return left, right, idepth


def render_sequence(
    scene: PlaneScene,
    K: np.ndarray,
    w: int,
    h: int,
    baseline: float,
    poses_cw: List[np.ndarray],
):
    """Render a stereo sequence. Returns list of (left, right, idepth_left)."""
    return [render_stereo_pair(scene, K, w, h, baseline, T) for T in poses_cw]


def default_K(w: int, h: int, fov_deg: float = 60.0) -> np.ndarray:
    f = 0.5 * w / np.tan(np.radians(fov_deg) / 2)
    return np.array([[f, 0, (w - 1) / 2.0], [0, f, (h - 1) / 2.0], [0, 0, 1.0]])
