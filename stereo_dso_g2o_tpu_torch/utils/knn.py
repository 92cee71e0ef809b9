"""Grid-based approximate K-nearest-neighbours for selected image points.

Port of `stereo_dso_g2o_tpu/utils/knn.py`: the occupancy grid with a
5x5-cell candidate neighbourhood that stands in for the reference's
nanoflann KD-tree (CoarseInitializer.h:217-246, makeNN
CoarseInitializer.cpp:1249+), used only by the mono initializer's 10-NN
regularization graph and parent links.

Two points of the JAX functions are kept exactly:
- the occupancy scatter is last-writer-wins over ALL lanes, the -1 that an
  invalid lane writes into a valid point's cell included (what XLA's scatter
  does with duplicate indices; `index_put_` leaves duplicates undefined), so
  the grid holds, per cell, the highest lane that lands there, or -1 when
  that lane is invalid;
- `jax.lax.top_k` returns tied candidates lowest position first, so the k
  nearest are taken by a stable sort.
"""

from __future__ import annotations

import torch

from stereo_dso_g2o_tpu_torch.utils.smalls import fma


def _occupancy(ci, cj, valid, gh: int, gw: int) -> torch.Tensor:
    """(gh, gw) int32 grid: the last lane (highest index) landing in each
    cell if it is valid, else -1."""
    n = ci.shape[0]
    lanes = torch.arange(n, dtype=torch.int64, device=ci.device)
    flat = cj.long() * gw + ci.long()
    last = torch.full((gh * gw,), -1, dtype=torch.int64, device=ci.device)
    last = last.scatter_reduce(0, flat, lanes, reduce="amax", include_self=True)
    ok = (last >= 0) & valid[last.clamp(min=0)]
    return torch.where(ok, last, torch.full_like(last, -1)).to(torch.int32).reshape(gh, gw)


def _cells(us, vs, cell, gh: int, gw: int):
    ci = torch.clamp((us / cell).to(torch.int32), 0, gw - 1)
    cj = torch.clamp((vs / cell).to(torch.int32), 0, gh - 1)
    return ci, cj


def _gather_cells(grid, ci, cj, offsets, gh: int, gw: int) -> torch.Tensor:
    cand = []
    for dy, dx in offsets:
        yy = torch.clamp(cj + dy, 0, gh - 1).long()
        xx = torch.clamp(ci + dx, 0, gw - 1).long()
        cand.append(grid[yy, xx])
    return torch.stack(cand, dim=1)


def grid_knn(us, vs, valid, cell, *, gh: int, gw: int, k: int = 10):
    """K nearest neighbours among (us, vs) via an occupancy grid.

    us, vs: (N,) point coords; valid: (N,) bool; cell: cell size in pixels.
    gh, gw: grid dims (>= ceil(max_v/cell)+1 etc.).
    Returns (idx (N, k) int32 with -1 fill, dist2 (N, k)).
    """
    N = us.shape[0]
    ci, cj = _cells(us, vs, cell, gh, gw)
    grid = _occupancy(ci, cj, valid, gh, gw)
    offs = [(dy, dx) for dy in range(-2, 3) for dx in range(-2, 3)]
    cand = _gather_cells(grid, ci, cj, offs, gh, gw)  # (N, 25)

    safe = torch.clamp(cand, min=0).long()
    du = us[safe] - us[:, None]
    dv = vs[safe] - vs[:, None]
    d2 = fma(du, du, dv * dv)  # XLA contracts the sum into one FMA
    own = torch.arange(N, device=us.device)[:, None]
    bad = (cand < 0) | (cand == own) | ~valid[:, None]
    d2 = torch.where(bad, torch.full_like(d2, float("inf")), d2)

    order = torch.sort(d2, dim=1, stable=True).indices[:, :k]
    dist2 = torch.gather(d2, 1, order)
    idx = torch.gather(cand, 1, order)
    inf = torch.isinf(dist2)
    idx = torch.where(inf, torch.full_like(idx, -1), idx)
    return idx.to(torch.int32), torch.where(inf, torch.zeros_like(dist2), dist2)


def grid_parent(us, vs, valid, us_c, vs_c, valid_c, cell, *, gh: int, gw: int):
    """Nearest coarser-level point ("parent" link, makeNN parent search):
    for each fine point, the closest of the coarser points in a 3x3 cell
    neighbourhood around (u/2, v/2). Returns (N,) int32, -1 where none."""
    pu = us * 0.5
    pv = vs * 0.5
    ci, cj = _cells(us_c, vs_c, cell, gh, gw)
    grid = _occupancy(ci, cj, valid_c, gh, gw)
    qi, qj = _cells(pu, pv, cell, gh, gw)
    offs = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    cand = _gather_cells(grid, qi, qj, offs, gh, gw)  # (N, 9)
    safe = torch.clamp(cand, min=0).long()
    du = us_c[safe] - pu[:, None]
    dv = vs_c[safe] - pv[:, None]
    d2 = fma(du, du, dv * dv)
    d2 = torch.where((cand < 0) | ~valid[:, None], torch.full_like(d2, float("inf")), d2)
    best = torch.argmin(d2, dim=1)  # the first minimum, as jnp.argmin
    parent = torch.gather(cand, 1, best[:, None])[:, 0]
    none = torch.isinf(torch.amin(d2, dim=1))
    return torch.where(none, torch.full_like(parent, -1), parent).to(torch.int32)
