"""The epipolar-search kernel (CUDA, sm_90a) and its plain PyTorch version.

`epipolar_search` runs, for each of N lanes (immature points), the part of
ImmaturePoint::traceOn / traceStereo that the JAX package's Pallas kernel
`ops/trace_pallas.py::epipolar_search` runs:

  1. the discrete search: the 8-pixel pattern sampled bilinearly at
     pt + s*(dx, dy) for every step s < S, scored with the Huber energy of
     I - (a*color + b), steps s >= num_steps masked to +inf;
  2. the argmin (ties to the lowest step) and the second-best energy more
     than `radius` steps away;
  3. <= gn_iters steps of 1-dof Gauss-Newton along the line (step clamped
     to +-0.5, halve-and-backtrack on a worse energy, stop below
     gn_threshold, energy weighted by weights^2).

Inputs (all float32, contiguous, on one device):
  dI      (H, W, 3) level-0 image + central-difference gradients
  scal    (N, 8)    per lane: ptx, pty, dx, dy, num_steps, aff_a, aff_b, 0
  color, weights, patx, paty  (N, 8)
Output (N, 8): best_u, best_v (after GN), e_search, second_best, e_gn,
best_idx, 0, 0.

Sampling rules follow the JAX "xla" backend exactly:
  - EDGE_CLAMP (temporal search): `_pattern_energy`'s formula with sample
    coordinates clamped to [0, size - 1.001];
  - EDGE_ZERO (static-stereo search): the strip formulation, zeros outside
    the image, vertical then horizontal lerp; it requires dx = +-1, dy = 0
    and an integer pattern, which `trace_stereo` guarantees;
  - Gauss-Newton always samples with `interp.bilinear` (clamped).
Non-finite ptx/pty/dx/dy are read as 0 (callers mask those lanes).

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor
it runs `epipolar_search_ref`. `LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from stereo_dso_g2o_tpu_torch.ops.interp import bilinear

OUT_BEST_U = 0
OUT_BEST_V = 1
OUT_E_SEARCH = 2
OUT_SECOND_BEST = 3
OUT_E_GN = 4
OUT_BEST_IDX = 5

EDGE_CLAMP = 0
EDGE_ZERO = 1

MAX_STEPS = 128  # 4 steps per thread of a 32-thread warp

LAUNCHES = 0  # kernel launches since the last reset_launches()

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "csrc" / "epipolar_search.cu"
BUILD_DIR = _PKG / "_build"
_LIB = None
BUILD_SECONDS = None  # wall time of the build this process ran, if any


def reset_launches():
    global LAUNCHES
    LAUNCHES = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def build() -> Path:
    """Compile csrc/epipolar_search.cu for sm_90a into _build/ (once per
    source version). Returns the shared library's path."""
    global BUILD_SECONDS
    src = _SRC.read_bytes()
    tag = hashlib.sha256(src).hexdigest()[:16]
    out = BUILD_DIR / f"libepipolar_search_{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
        "-o", str(tmp), str(_SRC),
    ]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    BUILD_SECONDS = time.perf_counter() - t0
    (BUILD_DIR / "ptxas.log").write_text(proc.stdout + proc.stderr)
    return out


def _load():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.sdso_epipolar_search
        fn.argtypes = [ctypes.c_void_p] * 6 + [  # dI scal color weights patx paty
            ctypes.c_void_p,  # out
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # H W N S
            ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int,
            ctypes.c_int,  # edge
            ctypes.c_void_p,  # stream
        ]
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check(dI, scal, color, weights, patx, paty, S):
    if dI.dim() != 3 or dI.shape[2] != 3:
        raise ValueError(f"dI must be (H, W, 3), got {tuple(dI.shape)}")
    N = scal.shape[0]
    for name, t in (("scal", scal), ("color", color), ("weights", weights),
                    ("patx", patx), ("paty", paty)):
        if t.shape != (N, 8):
            raise ValueError(f"{name} must be ({N}, 8), got {tuple(t.shape)}")
    for name, t in (("dI", dI), ("scal", scal), ("color", color),
                    ("weights", weights), ("patx", patx), ("paty", paty)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != dI.device:
            raise ValueError(f"{name} is on {t.device}, dI on {dI.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 1 <= S <= MAX_STEPS:
        raise ValueError(f"S must be in [1, {MAX_STEPS}], got {S}")
    if dI.shape[0] < 2 or dI.shape[1] < 2:
        raise ValueError("image must be at least 2x2")


def epipolar_search(dI, scal, color, weights, patx, paty, *, S: int,
                    huber_th: float, gn_iters: int, gn_threshold: float,
                    radius: int, edge: int):
    """Discrete epipolar search + GN refinement per lane; (N, 8) float32."""
    global LAUNCHES
    _check(dI, scal, color, weights, patx, paty, S)
    if edge not in (EDGE_CLAMP, EDGE_ZERO):
        raise ValueError(f"unknown edge rule {edge}")
    if dI.device.type == "cpu":
        return epipolar_search_ref(
            dI, scal, color, weights, patx, paty, S=S, huber_th=huber_th,
            gn_iters=gn_iters, gn_threshold=gn_threshold, radius=radius, edge=edge,
        )
    if dI.device.type != "cuda":
        raise ValueError(f"unsupported device {dI.device}")
    N = scal.shape[0]
    out = torch.empty((N, 8), dtype=torch.float32, device=dI.device)
    if N == 0:
        return out
    lib = _load()
    H, W = dI.shape[0], dI.shape[1]
    with torch.cuda.device(dI.device):
        stream = torch.cuda.current_stream(dI.device).cuda_stream
        rc = lib.sdso_epipolar_search(
            dI.data_ptr(), scal.data_ptr(), color.data_ptr(), weights.data_ptr(),
            patx.data_ptr(), paty.data_ptr(), out.data_ptr(),
            H, W, N, int(S), float(huber_th), int(gn_iters), float(gn_threshold),
            int(radius), int(edge), stream,
        )
    if rc != 0:
        raise RuntimeError(f"epipolar_search kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out


# ---------------------------------------------------------------------------
# plain PyTorch version (the CPU path; the kernel is held against it)
# ---------------------------------------------------------------------------


def _sum8(x):
    """Sum over the 8 pattern pixels in pattern order (the kernel's order)."""
    s = x[:, 0]
    for p in range(1, 8):
        s = s + x[:, p]
    return s


def _finite_or_zero(x):
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x))


def _huber_energy(r, th):
    ar = torch.abs(r)
    hw = torch.where(ar < th, torch.ones_like(ar), th / torch.clamp(ar, min=1e-12))
    return hw, hw * r * r * (2.0 - hw)


def _sample_clamped(img, px, py):
    """`_pattern_energy`'s bilinear formula with clamped coordinates."""
    H, W = img.shape
    x = torch.clamp(px, 0.0, W - 1.001)
    y = torch.clamp(py, 0.0, H - 1.001)
    xf = torch.floor(x)
    yf = torch.floor(y)
    ix = torch.nan_to_num(xf).long()  # NaN coords sample index 0 and stay NaN
    iy = torch.nan_to_num(yf).long()
    fx = x - xf
    fy = y - yf
    return (
        (1 - fx) * (1 - fy) * img[iy, ix]
        + fx * (1 - fy) * img[iy, ix + 1]
        + (1 - fx) * fy * img[iy + 1, ix]
        + fx * fy * img[iy + 1, ix + 1]
    )


def _sample_zero_rows(img, ix0, fu, iy0, fv, steps, dirx, patx_i, paty_i):
    """Strip formulation: columns ix0 + s*dirx + dxp, rows iy0 + dyp, zero
    outside the image, vertical lerp then horizontal lerp. -> (N, S, 8)."""
    H, W = img.shape
    col = ix0[:, None, None] + steps[None, :, None] * dirx[:, None, None] + patx_i[:, None, :]
    row = (iy0[:, None] + paty_i)[:, None, :].expand_as(col)

    def tap(r, c):
        ok = (r >= 0) & (r < H) & (c >= 0) & (c < W)
        v = img[torch.clamp(r, 0, H - 1), torch.clamp(c, 0, W - 1)]
        return torch.where(ok, v, torch.zeros_like(v))

    fv_ = fv[:, None, None]
    fu_ = fu[:, None, None]
    row0 = (1.0 - fv_) * tap(row, col) + fv_ * tap(row + 1, col)
    row1 = (1.0 - fv_) * tap(row, col + 1) + fv_ * tap(row + 1, col + 1)
    return (1.0 - fu_) * row0 + fu_ * row1


def epipolar_search_ref(dI, scal, color, weights, patx, paty, *, S: int,
                        huber_th: float, gn_iters: int, gn_threshold: float,
                        radius: int, edge: int):
    """Plain PyTorch version of the kernel: the search + GN part of the JAX
    "xla" branch (ops/trace.py:329-410 temporal, :852-963 stereo)."""
    N = scal.shape[0]
    dev = dI.device
    f32 = torch.float32
    ptx = _finite_or_zero(scal[:, 0])
    pty = _finite_or_zero(scal[:, 1])
    dx = _finite_or_zero(scal[:, 2])
    dy = _finite_or_zero(scal[:, 3])
    nsteps = scal[:, 4]
    aff_a = scal[:, 5]
    aff_b = scal[:, 6]
    img = dI[..., 0]
    H, W = img.shape
    steps = torch.arange(S, dtype=f32, device=dev)

    energies = torch.zeros((N, S), dtype=f32, device=dev)
    if edge == EDGE_CLAMP:
        sx = ptx[:, None] + steps[None, :] * dx[:, None]
        sy = pty[:, None] + steps[None, :] * dy[:, None]
        for p in range(8):
            hit = _sample_clamped(img, sx + patx[:, None, p], sy + paty[:, None, p])
            r = hit - (aff_a[:, None] * color[:, None, p] + aff_b[:, None])
            energies = energies + _huber_energy(r, huber_th)[1]
    else:
        lim = float(S + 16)
        xc = torch.clamp(ptx, -lim, W + lim)
        yc = torch.clamp(pty, -8.0, H + 8.0)
        ix0 = torch.floor(xc)
        iy0 = torch.floor(yc)
        fu = xc - ix0
        fv = yc - iy0
        stepi = torch.arange(S, dtype=torch.long, device=dev)
        vals = _sample_zero_rows(
            img, ix0.long(), fu, iy0.long(), fv, stepi, torch.round(dx).long(),
            torch.round(patx).long(), torch.round(paty).long(),
        )
        for p in range(8):
            r = vals[:, :, p] - (aff_a[:, None] * color[:, None, p] + aff_b[:, None])
            energies = energies + _huber_energy(r, huber_th)[1]

    step_valid = steps[None, :] < nsteps[:, None]
    energies = torch.where(step_valid, energies, torch.full_like(energies, float("inf")))
    best_e, best_idx = torch.min(energies, dim=1)  # first index on ties
    outside = torch.abs(torch.arange(S, device=dev)[None, :] - best_idx[:, None]) > radius
    second = torch.min(
        torch.where(outside, energies, torch.full_like(energies, float("inf"))), dim=1
    ).values
    bidx_f = best_idx.to(f32)
    bu = ptx + bidx_f * dx
    bv = pty + bidx_f * dy

    e_gn = best_e
    if gn_iters > 0:
        u_bak, v_bak = bu, bv
        step_back = torch.zeros_like(bu)
        be = torch.full_like(bu, 1e5)
        done = torch.zeros(N, dtype=torch.bool, device=dev)
        for _ in range(gn_iters):
            hit = bilinear(dI, bu[:, None] + patx, bv[:, None] + paty)  # (N,8,3)
            r = hit[..., 0] - (aff_a[:, None] * color + aff_b[:, None])
            d_res = dx[:, None] * hit[..., 1] + dy[:, None] * hit[..., 2]
            hw, _ = _huber_energy(r, huber_th)
            Hgn = 1.0 + _sum8(hw * d_res * d_res)
            bgn = _sum8(hw * r * d_res)
            energy = _sum8(weights * weights * hw * r * r * (2.0 - hw))
            worse = energy > be
            sb_worse = step_back * 0.5
            u_worse = u_bak + sb_worse * dx
            v_worse = v_bak + sb_worse * dy
            step = torch.clamp(-bgn / Hgn, -0.5, 0.5)
            step = torch.where(torch.isfinite(step), step, torch.zeros_like(step))
            u_better = bu + step * dx
            v_better = bv + step * dy
            new_u = torch.where(done, bu, torch.where(worse, u_worse, u_better))
            new_v = torch.where(done, bv, torch.where(worse, v_worse, v_better))
            u_bak = torch.where(done | worse, u_bak, bu)
            v_bak = torch.where(done | worse, v_bak, bv)
            step_back = torch.where(done, step_back, torch.where(worse, sb_worse, step))
            be = torch.where(done | worse, be, energy)
            done = done | (torch.abs(step_back) < gn_threshold)
            bu, bv = new_u, new_v
        e_gn = be

    zero = torch.zeros_like(bu)
    return torch.stack([bu, bv, best_e, second, e_gn, bidx_f, zero, zero], dim=1)
