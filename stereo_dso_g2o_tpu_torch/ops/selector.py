"""Gradient-histogram pixel selection.

Port of `stereo_dso_g2o_tpu/ops/selector.py` (PixelSelector2):
per-32x32-block gradient-histogram thresholds, 3-scale potential-grid
selection with a per-cell pseudo-random direction (integer hash), and the
host-side density controller with random thinning.

The thinning draw is injectable: `PixelSelector(uniform=...)` takes a
function `uniform(salt, shape) -> tensor of U[0,1)`. The default draws from
a `torch.Generator` seeded from the salt; the JAX package's host selector
draws from `jax.random.PRNGKey(salt)`, so parity tests pass in a function
that returns the JAX draw. The graph path's keyframe branch draws with
`graph_uniform`, the JAX package's own draw (threefry2x32) computed on the
device from the device salt, equal to it bit for bit.

`block_thresholds`, `select` and `map_to_points` also take a leading
sequence axis (images (N, H, W)), as the JAX package's batched keyframe
program vmaps them; `select` then takes a potential and a salt per
sequence, on the device: the potential is snapped there, and each
supported potential's cell winners are one `utils/loop.cond` over the rows
that have it (the JAX package's `lax.switch`), so a new potential captures
nothing new.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from stereo_dso_g2o_tpu_torch.config import Settings, default_settings
from stereo_dso_g2o_tpu_torch.utils import loop
from stereo_dso_g2o_tpu_torch.utils.fixed import constant, nonzero_fixed

# The 16 unit direction vectors (PixelSelector2.cpp:368-384).
_DIRECTIONS = np.array(
    [
        [0, 1.0000], [0.3827, 0.9239], [0.1951, 0.9808], [0.9239, 0.3827],
        [0.7071, 0.7071], [0.3827, -0.9239], [0.8315, 0.5556], [0.8315, -0.5556],
        [0.5556, -0.8315], [0.9808, 0.1951], [0.9239, -0.3827], [0.7071, -0.7071],
        [0.5556, 0.8315], [0.9808, -0.1951], [1.0000, 0.0000], [0.1951, -0.9808],
    ],
    dtype=np.float32,
)

_M32 = 0xFFFFFFFF


def _cell_hash(bx, by, salt: int):
    """Deterministic per-cell direction index in [0, 16): the JAX package's
    uint32 hash, computed in int64 and masked to 32 bits after every
    multiply."""
    h = ((bx * 2654435761) & _M32) ^ ((by * 40503) & _M32) ^ (salt & _M32)
    h = ((h ^ (h >> 13)) * 0x5BD1E995) & _M32
    return (h >> 4) & 0xF


def block_thresholds(asg0: torch.Tensor, settings: Settings = default_settings()):
    """Per-32x32-block smoothed squared gradient thresholds (makeHists).
    Returns (H//32, W//32) float32 ((N, ...) for (N, H, W))."""
    H, W = asg0.shape[-2:]
    lead = tuple(asg0.shape[:-2])
    dev = asg0.device
    h32, w32 = H // 32, W // 32
    g = torch.clamp(torch.sqrt(asg0).to(torch.int32), max=48)
    xs = torch.arange(W, device=dev)
    ys = torch.arange(H, device=dev)
    valid = (
        (xs[None, :] >= 1) & (xs[None, :] <= W - 2)
        & (ys[:, None] >= 1) & (ys[:, None] <= H - 2)
    )
    gb = g[..., : h32 * 32, : w32 * 32].reshape(lead + (h32, 32, w32, 32))
    vb = valid[: h32 * 32, : w32 * 32].reshape(h32, 32, w32, 32)
    bins = torch.arange(49, device=dev, dtype=torch.int32)
    le = (gb[..., None] <= bins) & vb[..., None]
    cum = torch.sum(le, dim=(-4, -2))  # (h32, w32, 49)
    total = torch.sum(vb, dim=(1, 3))
    th_count = (total * settings.min_grad_hist_cut + 0.5).to(torch.int32)
    meets = cum >= th_count[..., None] + 1
    first = torch.argmax(meets.to(torch.uint8), dim=-1)
    any_meets = torch.any(meets, dim=-1)
    quant = torch.where(any_meets, first, torch.full_like(first, 90))
    ths = quant.to(torch.float32) + settings.min_grad_hist_add

    def box(x):
        total = torch.zeros_like(x)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                y = torch.roll(x, (dy, dx), dims=(-2, -1))
                if dy == 1:
                    y[..., 0, :].fill_(0.0)
                if dy == -1:
                    y[..., -1, :].fill_(0.0)
                if dx == 1:
                    y[..., :, 0].fill_(0.0)
                if dx == -1:
                    y[..., :, -1].fill_(0.0)
                total = total + y
        return total

    sm = box(ths) / box(torch.ones_like(ths))
    return sm * sm


class Selection(NamedTuple):
    status_map: torch.Tensor  # (H, W) int32 in {0,1,2,4}
    counts: torch.Tensor  # (3,) int32


SUPPORTED_POTS = (1, 2, 3, 4, 5, 6, 8, 10, 12, 16)


def snap_pot(pot: int) -> int:
    """Nearest supported potential (ties -> smaller = denser)."""
    return min(SUPPORTED_POTS, key=lambda p: (abs(p - pot), p))


def _select_at_pot(v0, v1, v2, pot: int, H: int, W: int):
    """3-scale cell-winner selection at one potential; the winner per cell
    is the first maximal score in raster order. Scores (H, W), or (N, H, W)
    for N sequences at the same potential."""
    dev = v0.device
    lead = tuple(v0.shape[:-2])
    B = 4 * pot
    Hp = ((H + B - 1) // B) * B
    Wp = ((W + B - 1) // B) * B

    def pad(x):
        return torch.nn.functional.pad(x, (0, Wp - W, 0, Hp - H), value=-1.0)

    v0p, v1p, v2p = pad(v0), pad(v1), pad(v2)

    def block_argmax(v, b):
        hb, wb = Hp // b, Wp // b
        vb = v.reshape(lead + (hb, b, wb, b)).transpose(-3, -2).reshape(lead + (hb, wb, b * b))
        best, arg = torch.max(vb, dim=-1)
        iy = arg // b + torch.arange(hb, device=dev)[:, None] * b
        ix = arg % b + torch.arange(wb, device=dev)[None, :] * b
        return best, iy, ix

    def any4(x, h, w):
        return x.reshape(lead + (h, 2, w, 2)).transpose(-3, -2).reshape(lead + (h, w, 4)).any(-1)

    b0v, b0y, b0x = block_argmax(v0p, pot)
    sel0 = b0v > 0
    b1v, b1y, b1x = block_argmax(v1p, 2 * pot)
    h1, w1 = b1v.shape[-2:]
    sel0_any = any4(sel0, h1, w1)
    sel1 = (~sel0_any) & (b1v > 0)
    b2v, b2y, b2x = block_argmax(v2p, 4 * pot)
    h2, w2 = b2v.shape[-2:]
    sel1_any = any4(sel1, h2, w2)
    sel0_any2 = any4(sel0_any, h2, w2)
    sel2 = (~sel0_any2) & (~sel1_any) & (b2v > 0)

    status = torch.zeros(lead + (Hp * Wp,), dtype=torch.int32, device=dev)
    for by, bx, sel, code in ((b0y, b0x, sel0, 1), (b1y, b1x, sel1, 2), (b2y, b2x, sel2, 4)):
        val = torch.where(sel, code, 0).to(torch.int32).flatten(-2)
        status = status.scatter_reduce(-1, (by * Wp + bx).flatten(-2), val, reduce="amax")
    status = status.reshape(lead + (Hp, Wp))[..., :H, :W]
    counts = torch.stack([x.sum((-2, -1)) for x in (sel0, sel1, sel2)], -1).to(torch.int32)
    return status, counts


def select(dI0, asg0, asg1, asg2, ths_smoothed, pot, th_factor: float = 1.0,
           salt=0, settings: Settings = default_settings()) -> Selection:
    """One selection pass at potential `pot` (PixelSelector2::select).

    N sequences (images (N, H, W), thresholds (N, h32, w32)) take `pot` and
    `salt` as (N,) integer tensors on the device (or sequences of N ints),
    as the JAX package's vmap of its traced potential: each potential is
    snapped to `SUPPORTED_POTS` on the device (ties to the smaller), each
    sequence's directions hash its own salt on its own cell sizes (pot,
    2 pot, 4 pot), and the cell winners run once for each supported
    potential that some sequence has (`utils/loop.cond`), over all rows,
    kept where the row has it."""
    H, W = asg0.shape[-2:]
    lead = tuple(asg0.shape[:-2])
    dev = asg0.device
    dirs = constant(_DIRECTIONS, torch.float32, dev)
    if lead:
        supported = constant(SUPPORTED_POTS, torch.int64, dev)
        pot = torch.as_tensor(pot, device=dev).to(torch.int64)
        snapped = supported[torch.argmin(torch.abs(supported - pot[:, None]), dim=-1)]
        cell0 = snapped[:, None]
        salt = torch.as_tensor(salt, device=dev).to(torch.int64)[:, None, None]
    else:
        pot = snap_pot(int(pot))
        cell0 = pot

    xs = torch.arange(W, device=dev)
    ys = torch.arange(H, device=dev)
    border = (
        (xs[None, :] >= 4) & (xs[None, :] < W - 5)
        & (ys[:, None] >= 4) & (ys[:, None] <= H - 4)
    )
    th0 = ths_smoothed[
        ...,
        torch.clamp(ys[:, None] >> 5, max=ths_smoothed.shape[-2] - 1),
        torch.clamp(xs[None, :] >> 5, max=ths_smoothed.shape[-1] - 1),
    ]
    dw1 = settings.grad_downweight_per_level
    dw2 = dw1 * dw1
    th1 = th0 * dw1
    th2 = th1 * dw2

    gx = dI0[..., 1]
    gy = dI0[..., 2]

    x1 = (xs.to(torch.float32) * 0.5 + 0.25).to(torch.int64)
    y1 = (ys.to(torch.float32) * 0.5 + 0.25).to(torch.int64)
    ag1 = asg1[..., torch.clamp(y1[:, None], max=asg1.shape[-2] - 1),
               torch.clamp(x1[None, :], max=asg1.shape[-1] - 1)]
    x2 = (xs.to(torch.float32) * 0.25 + 0.125).to(torch.int64)
    y2 = (ys.to(torch.float32) * 0.25 + 0.125).to(torch.int64)
    ag2 = asg2[..., torch.clamp(y2[:, None], max=asg2.shape[-2] - 1),
               torch.clamp(x2[None, :], max=asg2.shape[-1] - 1)]

    pass0 = border & (asg0 > th0 * th_factor)
    pass1 = border & (ag1 > th1 * th_factor)
    pass2 = border & (ag2 > th2 * th_factor)

    def dir_field(cell, s):
        bx = xs // cell
        by = ys // cell
        # argument order as in the JAX package: (rows, cols)
        return dirs[_cell_hash(by[..., :, None], bx[..., None, :], s)]  # (H, W, 2)

    d0 = dir_field(cell0, salt * 3 + 0)
    d1 = dir_field(2 * cell0, salt * 3 + 1)
    d2f = dir_field(4 * cell0, salt * 3 + 2)

    if settings.select_direction_distribution:
        dn0 = torch.abs(gx * d0[..., 0] + gy * d0[..., 1])
        dn1 = torch.abs(gx * d1[..., 0] + gy * d1[..., 1])
        dn2 = torch.abs(gx * d2f[..., 0] + gy * d2f[..., 1])
    else:
        dn0, dn1, dn2 = asg0, ag1, ag2

    neg = torch.full_like(asg0, -1.0)
    v0 = torch.where(pass0, dn0, neg)
    v1 = torch.where(pass1, dn1, neg)
    v2 = torch.where(pass2, dn2, neg)
    if not lead:
        status, counts = _select_at_pot(v0, v1, v2, pot, H, W)
        return Selection(status_map=status, counts=counts)
    out = (torch.zeros(lead + (H, W), dtype=torch.int32, device=dev),
           torch.zeros(lead + (3,), dtype=torch.int32, device=dev))
    for p in SUPPORTED_POTS:
        rows = snapped == p

        def at_pot(p=p, rows=rows, prev=out):
            st, cnt = _select_at_pot(v0, v1, v2, p, H, W)
            return (torch.where(rows[:, None, None], st, prev[0]),
                    torch.where(rows[:, None], cnt, prev[1]))

        out = loop.cond(rows.any(), at_pot, out)
    return Selection(status_map=out[0], counts=out[1])


_M32_MASK = 0xFFFFFFFF


def _threefry2x32(k0, k1, x0, x1):
    """JAX's threefry2x32 hash (`jax/_src/prng.py`, 5 x 4 rounds) on
    uint32 values held in int64 tensors, masked to 32 bits after every
    add and shift."""
    M = _M32_MASK
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    rotations = ((13, 15, 26, 6), (17, 29, 16, 24))
    x0 = (x0 + ks[0]) & M
    x1 = (x1 + ks[1]) & M
    for i in range(5):
        for r in rotations[i % 2]:
            x0 = (x0 + x1) & M
            x1 = (((x1 << r) & M) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M
    return x0, x1


def graph_uniform(salt, shape) -> torch.Tensor:
    """The JAX package's keyframe thinning draw (graph_system.py:492-495),
    `jax.random.uniform(jax.random.fold_in(jax.random.PRNGKey(17),
    uint32(salt)), shape)` (float32, threefry with partitionable bits),
    bit for bit, on the device of `salt`: a () or (N,) integer tensor, one
    draw of `shape` per salt ((N,) + shape). No host read."""
    salt = salt.to(torch.int64) & _M32_MASK
    zero = torch.zeros_like(salt)
    # PRNGKey(17) = (0, 17); fold_in hashes the count pair (0, salt)
    k0, k1 = _threefry2x32(zero, zero + 17, zero, salt)
    n = int(np.prod(shape))
    lo = torch.arange(n, dtype=torch.int64, device=salt.device)  # the iota's low words
    b0, b1 = _threefry2x32(k0[..., None], k1[..., None], torch.zeros_like(lo), lo)
    bits = ((b0 ^ b1) >> 9) | 0x3F800000  # 23 mantissa bits under the exponent of 1.0
    u = bits.to(torch.int32).view(torch.float32) - 1.0
    return u.reshape(tuple(salt.shape) + tuple(shape))


def torch_uniform(salt: int, shape, device) -> torch.Tensor:
    """U[0,1) draw from a torch.Generator seeded from the salt."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(salt) & 0x7FFFFFFF)
    return torch.rand(shape, generator=gen, device=device)


class PixelSelector:
    """Host-side density controller (PixelSelector2::makeMaps).

    Holds the adaptive `current_potential` between frames, re-runs `select`
    with an adjusted potential until the yield is within [0.25, 1.25]x of the
    requested density, and randomly thins overshoot with
    `uniform(salt, shape, device)`."""

    def __init__(self, settings: Settings = default_settings(), seed: int = 0,
                 uniform: Optional[Callable] = None):
        self.settings = settings
        self.current_potential = 3
        self._seed = seed
        self._calls = 0
        self.uniform = torch_uniform if uniform is None else uniform

    def make_maps(self, dI0, asg0, asg1, asg2, density: float, th_factor: float = 1.0):
        """Returns (status_map (H,W) int32 in {0,1,2,4}, num_selected)."""
        ths = block_thresholds(asg0, self.settings)
        self._calls += 1
        salt = self._seed * 1000003 + self._calls
        pot = self.current_potential
        for recursion in range(2, -1, -1):
            selm = select(dI0, asg0, asg1, asg2, ths, pot, th_factor, salt, self.settings)
            num_have = float(torch.sum(selm.counts))
            quotia = density / max(num_have, 1.0)
            K = num_have * (pot + 1) * (pot + 1)
            ideal_pot = max(int(np.sqrt(K / density) - 1), 1)
            if recursion > 0 and quotia > 1.25 and pot > 1:
                pot = snap_pot(min(ideal_pot, pot - 1))
                continue
            if recursion > 0 and quotia < 0.25:
                pot = snap_pot(max(ideal_pot, pot + 1))
                continue
            break
        self.current_potential = snap_pot(max(ideal_pot, 1))

        status = selm.status_map
        if quotia < 0.95:
            u = self.uniform(salt, tuple(status.shape), status.device)
            keep = torch.as_tensor(u, device=status.device) < quotia
            status = torch.where(keep, status, torch.zeros_like(status))
            num_have = float(torch.sum(status > 0))
        return status, int(num_have)


def map_to_points(status_map: torch.Tensor, cap: int):
    """Compact a selection map into fixed-capacity point arrays (raster
    order, zero-padded): (us, vs, types, valid), (cap,) each ((N, cap) for
    N sequences' (N, H, W) maps)."""
    H, W = status_map.shape[-2:]
    batched = status_map.dim() == 3
    flat = status_map.flatten(-2)
    idx = nonzero_fixed(flat > 0, cap, batched=batched)
    valid = idx >= 0
    safe = torch.clamp(idx, min=0)
    us = (safe % W).to(torch.float32)
    vs = (safe // W).to(torch.float32)
    picked = torch.gather(flat, -1, safe)
    types = torch.where(valid, picked, torch.zeros_like(picked))
    return us, vs, types, valid
