"""Coarse distance map for spatially-uniform point activation.

Port of `stereo_dso_g2o_tpu/ops/distance_map.py` (CoarseDistanceMap): the
BFS distance transform becomes an iterated masked min-pool with the same
chamfer metric, and the greedy re-insertion of accepted candidates becomes
one-winner-per-cell suppression. Both take a leading sequence axis: (N, P)
points give (N, h1, w1) maps, every row its own.
"""

from __future__ import annotations

import torch


def distance_map(us1, vs1, valid, h1: int, w1: int, iters: int = 40):
    """us1, vs1: (N,) level-1 integer pixel coords of projected active
    points. Returns (h1, w1) float32 chamfer distances (seeds 0, growth
    capped at `iters`, unreached = 1000)."""
    dev = us1.device
    lead = tuple(us1.shape[:-1])
    iu = torch.clamp(us1.to(torch.int64), 0, w1 - 1)
    iv = torch.clamp(vs1.to(torch.int64), 0, h1 - 1)
    big = 1000.0
    d = torch.full(lead + (h1 * w1,), big, dtype=torch.float32, device=dev)
    seed = torch.where(valid, torch.zeros(iu.shape, dtype=torch.float32, device=dev),
                       torch.full(iu.shape, big, dtype=torch.float32, device=dev))
    d = d.scatter_reduce(-1, iv * w1 + iu, seed, reduce="amin", include_self=True)
    d = d.reshape(lead + (h1, w1))

    def roll2(x, dy, dx):
        y = torch.roll(x, (dy, dx), dims=(-2, -1))
        if dy == 1:
            y[..., 0, :].fill_(big)
        if dy == -1:
            y[..., -1, :].fill_(big)
        if dx == 1:
            y[..., :, 0].fill_(big)
        if dx == -1:
            y[..., :, -1].fill_(big)
        return y

    def grow(d, k, diag):
        n = torch.minimum(
            torch.minimum(roll2(d, 0, 1), roll2(d, 0, -1)),
            torch.minimum(roll2(d, 1, 0), roll2(d, -1, 0)),
        )
        if diag:
            nd = torch.minimum(
                torch.minimum(roll2(d, 1, 1), roll2(d, 1, -1)),
                torch.minimum(roll2(d, -1, 1), roll2(d, -1, -1)),
            )
            n = torch.minimum(n, nd)
        return torch.minimum(d, torch.where(n < k, torch.full_like(d, k), torch.full_like(d, big)))

    # growDistBFS: even sweeps use the 4-neighbourhood, odd ones add diagonals
    for k in range(1, iters):
        d = grow(d, float(k), diag=(k % 2 != 0))
    return d


def suppress_same_cell(us1, vs1, accept, cell: int = 2):
    """Keep at most one accepted candidate per (cell x cell) level-1 grid
    cell: the lowest original index wins (stable sort)."""
    n = accept.shape[-1]
    key = (vs1.to(torch.int64) // cell) * 100000 + (us1.to(torch.int64) // cell)
    key = torch.where(accept, key, -torch.arange(1, n + 1, device=key.device))
    sort_idx = torch.sort(key, dim=-1, stable=True).indices
    sorted_key = torch.gather(key, -1, sort_idx)
    first = torch.cat(
        [torch.ones(tuple(key.shape[:-1]) + (1,), dtype=torch.bool, device=key.device),
         sorted_key[..., 1:] != sorted_key[..., :-1]], -1
    )
    win = torch.zeros_like(accept).scatter(-1, sort_idx, first)
    return accept & win
