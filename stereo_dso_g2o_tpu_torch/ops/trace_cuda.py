"""The epipolar-search kernels (CUDA, sm_90a) and their plain PyTorch versions.

Two kernels compute the same function, as the JAX package's two Pallas
bodies do: `epipolar_search` (csrc/epipolar_search.cu, the resident body:
every tap read from the (H, W, 3) stack in global memory / L2) and
`epipolar_search_slab` (csrc/epipolar_search_slab.cu, the slab body: each
lane's band of the intensity plane staged in shared memory, gradients by
central differences of it). Both include csrc/epipolar_common.cuh, which
holds the search itself. `uses_slab_route` is the JAX package's gate
between them.

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

Inputs (all float32, on one device):
  dI      (H, W, 3) level-0 image + central-difference gradients, contiguous
  scal    (N, 8)    per lane: ptx, pty, dx, dy, num_steps, aff_a, aff_b, 0
  color, weights  (N, 8), contiguous
  patx, paty  (N, 8), any strides (a slice of a rotated (N, 8, 2) pattern
              or one pattern broadcast over the lanes is read in place)
Output (N, 8): best_u, best_v (after GN), e_search, second_best, e_gn,
best_idx, 0, 0.

`epipolar_search` also takes a batch of sequences, as the JAX package's
vmap of its kernel does: dI (B, H, W, 3) and every lane operand (B, N, 8),
lanes b searching image b; the output is (B, N, 8). One launch serves the
batch (the sequence is the kernel's second grid dimension), and a batch of
one gives the bits of the single-image call. `epipolar_search_slab` takes
a batch the same way (its (B, H, W) intensity planes).

Sampling rules follow the JAX "xla" backend exactly:
  - EDGE_CLAMP (temporal search): `_pattern_energy`'s formula with sample
    coordinates clamped to [0, size - 1.001];
  - EDGE_ZERO (static-stereo search): the strip formulation, zeros outside
    the image, vertical then horizontal lerp; it requires dx = +-1, dy = 0
    and an integer pattern, which `trace_stereo` guarantees;
  - Gauss-Newton always samples with `interp.bilinear` (clamped).
Non-finite ptx/pty/dx/dy are read as 0 (callers mask those lanes); a
num_steps that is NaN or <= 0 masks every step (best_idx 0, +inf energies).

`epipolar_search_slab` takes the same arguments and returns the same lanes;
it reads only channel 0 of dI and takes the Gauss-Newton gradients as
0.5 * (I(x+1, y) - I(x-1, y)) (zero on the image's border row/column), the
pyramid's rule, so both kernels sample the same values.

On a CUDA tensor a wrapper launches its kernel or raises; on a CPU tensor
it runs its plain version (`epipolar_search_ref`,
`epipolar_search_slab_ref`). `LAUNCHES` / `LAUNCHES_SLAB` count the kernel
launches the device ran: an eager launch adds one on the host; a launch
captured into a program (`runtime/program.py`) captures, next to it, an
increment of a per-device counter (`launch_counter`), so that the count
advances each time the graph, or the WHILE or IF node's body around it,
actually runs. Reading either name reads those counters (it waits for
the device). `search_bound` is the least time the card could take for one
search, which both kernels' times are set beside.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

import torch

from stereo_dso_g2o_tpu_torch.ops.interp import bilinear, take

OUT_BEST_U = 0
OUT_BEST_V = 1
OUT_E_SEARCH = 2
OUT_SECOND_BEST = 3
OUT_E_GN = 4
OUT_BEST_IDX = 5

EDGE_CLAMP = 0
EDGE_ZERO = 1

SMEM_MAX = 232448  # dynamic shared memory one block may use on sm_90
# Lanes per block, a warp per lane; the kernels take the number at launch.
WARPS = 8  # resident kernel
# ... whose block keeps S per-step energies per warp in the 48 KB of shared
# memory a launch gets without asking for more
MAX_STEPS = 48 * 1024 // (4 * WARPS)
SLAB_WARPS = 4  # slab kernel
BAND_CROSS = 16  # ... pixels staged across the line
BAND_EXTRA = 20  # ... and along it, beyond S: pattern, bilinear, gradient, GN travel, alignment

# published peaks of one H100 SXM: the roofline a search's bound is taken from
HBM_BYTES_PER_S, F32_FLOP_PER_S = 3.35e12, 67e12

# launches since the last reset_launches(), (resident, slab): made eagerly,
# counted on the host; captured into a program, counted on the device
_EAGER = [0, 0]
_COUNTERS = {}  # device -> (2,) int64 counter the captured launches increment
CAPTURED = [0, 0]  # launches captured into programs (not runs: sites)

_PKG = Path(__file__).resolve().parent.parent
SOURCES = {
    "epipolar_search": _PKG / "csrc" / "epipolar_search.cu",
    "epipolar_search_slab": _PKG / "csrc" / "epipolar_search_slab.cu",
}
HEADERS = [_PKG / "csrc" / "epipolar_common.cuh"]  # included by every source
# not a search: the WHILE node of a captured program (runtime/program.py),
# built in the same pass as the searches
RUNTIME_SOURCES = {"graph_while": _PKG / "csrc" / "graph_while.cu"}
BUILD_DIR = _PKG / "_build"
_LIBS = {}
BUILD_SECONDS = {}  # kernel name -> wall time of the nvcc run this process made


def reset_launches():
    _EAGER[:] = [0, 0]
    for c in _COUNTERS.values():
        c.zero_()


def launch_counter(device) -> torch.Tensor:
    """The (2,) int64 counter of launches captured on `device`; a program
    makes it before it captures (a capture allocates in its own pool)."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    c = _COUNTERS.get(device)
    if c is None:
        c = _COUNTERS[device] = torch.zeros(2, dtype=torch.int64, device=device)
    return c


def _count(k: int, device):
    """One launch of kernel k (0 resident, 1 slab) on `device`: on the host
    eagerly; under capture an increment of the device counter, captured
    next to the launch."""
    if not torch.cuda.is_current_stream_capturing():
        _EAGER[k] += 1
        return
    device = torch.device(device)
    c = _COUNTERS.get(device)
    if c is None:
        raise RuntimeError(f"no launch counter on {device}: call launch_counter() before capturing")
    c.narrow(0, k, 1).add_(1)
    CAPTURED[k] += 1


def launches() -> tuple:
    """(resident, slab) launches the device ran since the last
    reset_launches(): the eager ones and the captured ones that ran (reads
    the device counters: waits for the device)."""
    out = list(_EAGER)
    for c in _COUNTERS.values():
        for k, v in enumerate(c.tolist()):
            out[k] += v
    return tuple(out)


def __getattr__(name):
    # LAUNCHES / LAUNCHES_SLAB: launches(), one kernel each
    if name == "LAUNCHES":
        return launches()[0]
    if name == "LAUNCHES_SLAB":
        return launches()[1]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def nvcc_command(src, lib) -> list:
    """The compiler call that makes shared library `lib` from `src`."""
    return [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
        "-o", str(lib), str(src),
    ]


def build(names=None) -> dict:
    """Compile the named sources (default: all of SOURCES and
    RUNTIME_SOURCES) for sm_90a into _build/, once per version of the
    source and its headers, one nvcc process per source, all started
    together. Returns {name: shared library path}; the compiler's output
    (-Xptxas -v) goes to _build/ptxas_<name>.log."""
    sources = {**SOURCES, **RUNTIME_SOURCES}
    names = list(sources) if names is None else list(names)
    out, running = {}, []
    for name in names:
        src = sources[name]
        version = hashlib.sha256(src.read_bytes())
        for dep in HEADERS:
            version.update(dep.read_bytes())
        lib = BUILD_DIR / f"lib{name}_{version.hexdigest()[:16]}.so"
        out[name] = lib
        if lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(nvcc_command(src, tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((name, lib, tmp, proc, time.perf_counter()))
    failed = []
    for name, lib, tmp, proc, t0 in running:
        log, _ = proc.communicate()
        BUILD_SECONDS[name] = time.perf_counter() - t0
        (BUILD_DIR / f"ptxas_{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {sources[name].name} ({proc.returncode}):\n{log}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


_PTR = ctypes.c_void_p
_LANES = [_PTR] * 5  # scal color weights patx paty
_STRIDES = [ctypes.c_longlong] * 2  # pattern strides (lane, pixel)
_TAIL = [
    _PTR,  # out
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # H W N S
    ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int,
    ctypes.c_int,  # edge
]
_WARPS_STREAM = [ctypes.c_int, _PTR]
_ARGTYPES = {
    # image, lanes, pattern strides (sequence, lane, pixel), tail, (slab:
    # band length,) sequences, warps per block, stream
    "epipolar_search": [_PTR] + _LANES + [ctypes.c_longlong] + _STRIDES + _TAIL
    + [ctypes.c_int] + _WARPS_STREAM,
    "epipolar_search_slab": [_PTR] + _LANES + [ctypes.c_longlong] + _STRIDES + _TAIL
    + [ctypes.c_int] * 2 + _WARPS_STREAM,
}


def _load(name: str):
    """The kernel's C entry point `sdso_<name>`, built at first use."""
    if name not in _LIBS:
        fn = getattr(ctypes.CDLL(str(build([name])[name])), f"sdso_{name}")
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _LIBS[name] = fn
    return _LIBS[name]


def _check(dI, scal, color, weights, patx, paty, edge) -> bool:
    """Raise unless the operands are one image (H, W, 3) with (N, 8) lanes
    or a batch (B, H, W, 3) with (B, N, 8) lanes; True for a batch."""
    if dI.dim() not in (3, 4) or dI.shape[-1] != 3:
        raise ValueError(f"dI must be (H, W, 3) or (B, H, W, 3), got {tuple(dI.shape)}")
    batched = dI.dim() == 4
    lead = tuple(dI.shape[:1]) if batched else ()
    N = scal.shape[-2] if scal.dim() >= 2 else -1
    for name, t in (("scal", scal), ("color", color), ("weights", weights),
                    ("patx", patx), ("paty", paty)):
        if tuple(t.shape) != lead + (N, 8):
            raise ValueError(f"{name} must be {lead + (N, 8)}, got {tuple(t.shape)}")
    for name, t in (("dI", dI), ("scal", scal), ("color", color),
                    ("weights", weights), ("patx", patx), ("paty", paty)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != dI.device:
            raise ValueError(f"{name} is on {t.device}, dI on {dI.device}")
        if name not in ("patx", "paty") and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if dI.shape[-3] < 2 or dI.shape[-2] < 2:
        raise ValueError("image must be at least 2x2")
    if edge not in (EDGE_CLAMP, EDGE_ZERO):
        raise ValueError(f"unknown edge rule {edge}")
    if dI.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dI.device}")
    return batched


def _launch(name, image, scal, color, weights, patx, paty, H, W, S, huber_th,
            gn_iters, gn_threshold, radius, edge, *extra):
    """Launch kernel `name` on the current stream of `image` (the tensor it
    reads pixels from); `extra`: its arguments after `edge`. The lanes are
    (B, N, 8), the pattern strides lead with the sequence's; the output has
    their shape."""
    N = scal.shape[-2]
    if patx.stride() != paty.stride():  # the kernel takes one set of strides
        patx, paty = patx.contiguous(), paty.contiguous()
    out = torch.empty(scal.shape, dtype=torch.float32, device=scal.device)
    fn = _load(name)
    with torch.cuda.device(scal.device):
        stream = torch.cuda.current_stream(scal.device).cuda_stream
        rc = fn(
            image.data_ptr(), scal.data_ptr(), color.data_ptr(),
            weights.data_ptr(), patx.data_ptr(), paty.data_ptr(), *patx.stride(),
            out.data_ptr(), H, W, N, int(S), float(huber_th), int(gn_iters),
            float(gn_threshold), int(radius), int(edge), *extra, stream,
        )
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    return out


def epipolar_search(dI, scal, color, weights, patx, paty, *, S: int,
                    huber_th: float, gn_iters: int, gn_threshold: float,
                    radius: int, edge: int):
    """Discrete epipolar search + GN refinement per lane: (N, 8) float32
    for one image, (B, N, 8) for a batch of B sequences (one launch)."""
    batched = _check(dI, scal, color, weights, patx, paty, edge)
    if not 1 <= S <= MAX_STEPS:
        raise ValueError(f"S must be in [1, {MAX_STEPS}], got {S}")
    kw = dict(S=S, huber_th=huber_th, gn_iters=gn_iters, gn_threshold=gn_threshold,
              radius=radius, edge=edge)
    if dI.device.type == "cpu":
        return epipolar_search_ref(dI, scal, color, weights, patx, paty, **kw)
    ops = (dI, scal, color, weights, patx, paty)
    if not batched:  # the kernel takes a batch: one image is a batch of one
        ops = tuple(x[None] for x in ops)
    out = torch.empty(ops[1].shape, dtype=torch.float32, device=dI.device)
    if out.numel():
        out = _launch("epipolar_search", *ops, dI.shape[-3], dI.shape[-2], S, huber_th,
                      gn_iters, gn_threshold, radius, edge, ops[0].shape[0], WARPS)
        _count(0, dI.device)
    return out if batched else out[0]


class SearchBound(NamedTuple):
    bytes: float  # each operand read once, the output written once
    ops: float  # f32 operations these lanes need
    ms: float  # the larger of the two over the card's peaks
    by: str  # "bytes" or "operations": which of the two binds


def search_bound(H: int, W: int, scal, S: int, gn_iters: int) -> SearchBound:
    """The least time the card could take for one search of an (H, W)
    image on the lanes `scal` (N, 8), the same for both kernels (they
    compute one function); for a batch (B, N, 8) of B sequences, the sum of
    the B searches, each on its own plane. Bytes, each once, over the memory rate: the five (N, 8)
    operands, the (N, 8) output and the pixels of the intensity plane these
    lanes need, which is what the search reads (the gradients Gauss-Newton
    uses are differences of it). A lane needs the band under its valid
    steps (not S): along the line its steps plus 7 pixels (the pattern's 5,
    the bilinear neighbour, the gradient's step to each side less the
    shared one), 8 across (the same); a lane without a valid step needs
    only that 7 x 8 patch, for Gauss-Newton at step 0. Lanes overlap, so
    the sum is capped at the plane. Against the operations over the f32
    peak. Per (step, pixel): 2 adds for the position, a 4-tap bilinear (2
    floors, 2 subs, 8 mul/add for the weights, 7 for the sum), residual and
    Huber energy (9): 30; per GN iteration and pixel: three such samples
    with differenced gradients and the step: 80."""
    scal = scal.reshape((-1,) + tuple(scal.shape[-2:]))  # (B, N, 8)
    n = scal.shape[0] * scal.shape[1]
    per_seq = torch.ceil(torch.clamp(torch.nan_to_num(scal[..., 4], nan=0.0), 0, S)).sum(-1)
    steps = float(per_seq.sum())
    pixels = sum(min(H * W, 8 * (float(k) + 7 * scal.shape[1])) for k in per_seq)
    nbytes = 4 * (pixels + 5 * n * 8 + n * 8)
    flops = 8 * (30 * steps + 80 * gn_iters * n)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOP_PER_S
    return SearchBound(nbytes, flops, 1000.0 * max(t_bytes, t_ops),
                       "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# the slab route
# ---------------------------------------------------------------------------


def uses_slab_route(H: int, W: int) -> bool:
    """The JAX package's gate between its two kernel bodies
    (ops/trace.py:318,826): the slab body when the image, padded as
    `pad_image_for_search` pads it (8 + 64 rows to a multiple of 8, 128 +
    256 columns to a multiple of 128), exceeds 6 MB of float32."""
    Hp = ((H + 8 + 64 + 7) // 8) * 8
    Wp = ((W + 128 + 256 + 127) // 128) * 128
    return Hp * Wp * 4 > 6 * 2**20


def slab_window(S: int, band_len=None):
    """(pixels across the line, pixels along it, shared-memory bytes) of
    the band the slab kernel stages for one lane: BAND_CROSS pixels across
    at each of `band_len` major coordinates (default: the S-step segment
    plus BAND_EXTRA, rounded up to a multiple of 4), and the lane's S
    per-step energies. A block holds SLAB_WARPS lanes."""
    if band_len is None:
        band_len = (S + BAND_EXTRA + 3) // 4 * 4
    return BAND_CROSS, band_len, 4 * (BAND_CROSS * band_len + (S + 3) // 4 * 4)


_PLANES = []  # [(dI, dI._version, plane)], the two most recent images


def intensity_plane(dI):
    """Channel 0 of an (H, W, 3) image (or a (B, H, W, 3) batch) as a
    contiguous (H, W) plane ((B, H, W) planes), made once per image: a
    caller traces the same image several times per frame
    (immature.trace_on_nonkey), so the two most recent planes are kept,
    keyed on the image tensor itself and its version counter."""
    for img, version, plane in _PLANES:
        if img is dI and version == dI._version:
            return plane
    plane = dI[..., 0].contiguous()
    _PLANES.append((dI, dI._version, plane))
    del _PLANES[:-2]
    return plane


def epipolar_search_slab(dI, scal, color, weights, patx, paty, *, S: int,
                         huber_th: float, gn_iters: int, gn_threshold: float,
                         radius: int, edge: int, band_len=None):
    """`epipolar_search` through the slab kernel: same arguments, same
    (N, 8) float32 lanes, or (B, N, 8) for a batch (B, H, W, 3) of B
    sequences in one launch (the sequence is the kernel's second grid
    dimension). Only dI[..., 0] is read. `band_len` caps the staged band's
    length (a multiple of 4; default from S): taps beyond it read global
    memory, so it changes the time and never the answer."""
    batched = _check(dI, scal, color, weights, patx, paty, edge)
    if band_len is not None and (band_len < 4 or band_len % 4):
        raise ValueError(f"band_len must be a positive multiple of 4, got {band_len}")
    cross, band_len, smem = slab_window(S, band_len)
    if S < 1 or SLAB_WARPS * smem > SMEM_MAX:
        raise ValueError(
            f"S={S}: {SLAB_WARPS} bands of {cross}x{band_len} need {SLAB_WARPS * smem} bytes of "
            f"shared memory, the card gives a block {SMEM_MAX}"
        )
    kw = dict(S=S, huber_th=huber_th, gn_iters=gn_iters, gn_threshold=gn_threshold,
              radius=radius, edge=edge)
    if dI.device.type == "cpu":
        return epipolar_search_slab_ref(dI, scal, color, weights, patx, paty, **kw)
    plane = intensity_plane(dI)
    ops = (scal, color, weights, patx, paty)
    if not batched:  # the kernel takes a batch: one image is a batch of one
        plane, ops = plane[None], tuple(x[None] for x in ops)
    out = torch.empty(ops[0].shape, dtype=torch.float32, device=dI.device)
    if out.numel():
        out = _launch("epipolar_search_slab", plane, *ops, dI.shape[-3], dI.shape[-2], S,
                      huber_th, gn_iters, gn_threshold, radius, edge, band_len,
                      plane.shape[0], SLAB_WARPS)
        _count(1, dI.device)
    return out if batched else out[0]


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path; the kernels are held against them)
# ---------------------------------------------------------------------------


def _sum8(x):
    """Sum over the 8 pattern pixels in pattern order (the kernel's order)."""
    s = x[..., 0]
    for p in range(1, 8):
        s = s + x[..., p]
    return s


def _finite_or_zero(x):
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x))


def _huber_energy(r, th):
    ar = torch.abs(r)
    hw = torch.where(ar < th, torch.ones_like(ar), th / torch.clamp(ar, min=1e-12))
    return hw, hw * r * r * (2.0 - hw)


def _sample_clamped(img, px, py, stacked):
    """`_pattern_energy`'s bilinear formula with clamped coordinates."""
    H, W = img.shape[-2:]
    x = torch.clamp(px, 0.0, W - 1.001)
    y = torch.clamp(py, 0.0, H - 1.001)
    xf = torch.floor(x)
    yf = torch.floor(y)
    ix = torch.nan_to_num(xf).long()  # NaN coords sample index 0 and stay NaN
    iy = torch.nan_to_num(yf).long()
    fx = x - xf
    fy = y - yf
    return (
        (1 - fx) * (1 - fy) * take(img, iy, ix, stacked)
        + fx * (1 - fy) * take(img, iy, ix + 1, stacked)
        + (1 - fx) * fy * take(img, iy + 1, ix, stacked)
        + fx * fy * take(img, iy + 1, ix + 1, stacked)
    )


def _sample_zero_rows(img, ix0, fu, iy0, fv, steps, dirx, patx_i, paty_i, stacked):
    """Strip formulation: columns ix0 + s*dirx + dxp, rows iy0 + dyp, zero
    outside the image, vertical lerp then horizontal lerp. -> (..., N, S, 8)."""
    H, W = img.shape[-2:]
    col = ix0[..., None, None] + steps[:, None] * dirx[..., None, None] + patx_i[..., None, :]
    row = (iy0[..., None] + paty_i)[..., None, :].expand_as(col)

    def tap(r, c):
        ok = (r >= 0) & (r < H) & (c >= 0) & (c < W)
        v = take(img, torch.clamp(r, 0, H - 1), torch.clamp(c, 0, W - 1), stacked)
        return torch.where(ok, v, torch.zeros_like(v))

    fv_ = fv[..., None, None]
    fu_ = fu[..., None, None]
    row0 = (1.0 - fv_) * tap(row, col) + fv_ * tap(row + 1, col)
    row1 = (1.0 - fv_) * tap(row, col + 1) + fv_ * tap(row + 1, col + 1)
    return (1.0 - fu_) * row0 + fu_ * row1


def _sample3_plane(img, x, y, stacked=False):
    """`interp.bilinear` of (I, dI/dx, dI/dy) at float coords, the gradients
    taken from the intensity plane: 0.5 * (I(x+1, y) - I(x-1, y)), zero on
    the image's border row/column (ops/pyramid._gradients). -> (..., 3).
    `stacked`: planes (B, H, W), row b of the coordinates on plane b."""
    H, W = img.shape[-2:]
    x = torch.clamp(x, 0.0, W - 1.001)
    y = torch.clamp(y, 0.0, H - 1.001)
    xf = torch.floor(x)
    yf = torch.floor(y)
    ix = torch.nan_to_num(xf).long()
    iy = torch.nan_to_num(yf).long()
    dx = (x - xf)[..., None]
    dy = (y - yf)[..., None]

    def corner(r, c):
        inner_x = (c >= 1) & (c <= W - 2)
        inner_y = (r >= 1) & (r <= H - 2)
        def at(rr, cc):
            return take(img, rr, cc, stacked)

        gx = 0.5 * (at(r, torch.clamp(c + 1, max=W - 1)) - at(r, torch.clamp(c - 1, min=0)))
        gy = 0.5 * (at(torch.clamp(r + 1, max=H - 1), c) - at(torch.clamp(r - 1, min=0), c))
        zero = torch.zeros_like(gx)
        return torch.stack(
            [at(r, c), torch.where(inner_x, gx, zero), torch.where(inner_y, gy, zero)], dim=-1
        )

    dxdy = dx * dy
    return (
        dxdy * corner(iy + 1, ix + 1)
        + (dy - dxdy) * corner(iy + 1, ix)
        + (dx - dxdy) * corner(iy, ix + 1)
        + (1.0 - dx - dy + dxdy) * corner(iy, ix)
    )


def epipolar_search_ref(dI, scal, color, weights, patx, paty, **kw):
    """Plain PyTorch version of the resident kernel: the search + GN part of
    the JAX "xla" branch (ops/trace.py:329-410 temporal, :852-963 stereo).
    One image (H, W, 3) with (N, 8) lanes, or a batch (B, H, W, 3) with
    (B, N, 8) lanes, every op over the whole batch."""
    stacked = dI.dim() == 4
    return _search_ref(dI[..., 0], lambda x, y: bilinear(dI, x, y, stacked=stacked),
                       scal, color, weights, patx, paty, stacked=stacked, **kw)


def epipolar_search_slab_ref(dI, scal, color, weights, patx, paty, **kw):
    """Plain PyTorch version of the slab kernel: the same function with the
    Gauss-Newton gradients differenced from the intensity plane. One image
    (H, W, 3) with (N, 8) lanes, or a batch (B, H, W, 3) with (B, N, 8)
    lanes, every op over the whole batch."""
    stacked = dI.dim() == 4
    img = dI[..., 0]
    return _search_ref(img, lambda x, y: _sample3_plane(img, x, y, stacked),
                       scal, color, weights, patx, paty, stacked=stacked, **kw)


def _search_ref(img, sample3, scal, color, weights, patx, paty, *, S: int,
                huber_th: float, gn_iters: int, gn_threshold: float,
                radius: int, edge: int, stacked: bool):
    """The search on the (H, W) plane `img` (or the (B, H, W) planes of a
    batch, `stacked`, lanes (B, N, 8)); `sample3(x, y)` gives the (..., 3)
    bilinear sample of (I, dI/dx, dI/dy) for Gauss-Newton."""
    lead = tuple(scal.shape[:-1])
    dev = img.device
    f32 = torch.float32
    ptx = _finite_or_zero(scal[..., 0])
    pty = _finite_or_zero(scal[..., 1])
    dx = _finite_or_zero(scal[..., 2])
    dy = _finite_or_zero(scal[..., 3])
    nsteps = scal[..., 4]
    aff_a = scal[..., 5]
    aff_b = scal[..., 6]
    H, W = img.shape[-2:]
    steps = torch.arange(S, dtype=f32, device=dev)

    energies = torch.zeros(lead + (S,), dtype=f32, device=dev)
    if edge == EDGE_CLAMP:
        sx = ptx[..., None] + steps * dx[..., None]
        sy = pty[..., None] + steps * dy[..., None]
        for p in range(8):
            hit = _sample_clamped(img, sx + patx[..., None, p], sy + paty[..., None, p], stacked)
            r = hit - (aff_a[..., None] * color[..., None, p] + aff_b[..., None])
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
            torch.round(patx).long(), torch.round(paty).long(), stacked,
        )
        for p in range(8):
            r = vals[..., p] - (aff_a[..., None] * color[..., None, p] + aff_b[..., None])
            energies = energies + _huber_energy(r, huber_th)[1]

    step_valid = steps < nsteps[..., None]
    energies = torch.where(step_valid, energies, torch.full_like(energies, float("inf")))
    best_e, best_idx = torch.min(energies, dim=-1)  # first index on ties
    outside = torch.abs(torch.arange(S, device=dev) - best_idx[..., None]) > radius
    second = torch.min(
        torch.where(outside, energies, torch.full_like(energies, float("inf"))), dim=-1
    ).values
    bidx_f = best_idx.to(f32)
    bu = ptx + bidx_f * dx
    bv = pty + bidx_f * dy

    e_gn = best_e
    if gn_iters > 0:
        u_bak, v_bak = bu, bv
        step_back = torch.zeros_like(bu)
        be = torch.full_like(bu, 1e5)
        done = torch.zeros(lead, dtype=torch.bool, device=dev)
        for _ in range(gn_iters):
            hit = sample3(bu[..., None] + patx, bv[..., None] + paty)  # (..., N, 8, 3)
            r = hit[..., 0] - (aff_a[..., None] * color + aff_b[..., None])
            d_res = dx[..., None] * hit[..., 1] + dy[..., None] * hit[..., 2]
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
    return torch.stack([bu, bv, best_e, second, e_gn, bidx_f, zero, zero], dim=-1)
