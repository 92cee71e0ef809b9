"""Fixed-shape helpers that JAX provides and PyTorch does not.

- `nonzero_fixed` is `jnp.nonzero(mask, size=size, fill_value=-1)[0]` for a
  1-D mask: the indices of the True entries in raster order, cut or padded
  with -1 to exactly `size` entries (row by row for a batch of masks).
- `scatter_drop` is `dst.at[idx].set(vals, mode="drop")`: rows whose index is
  out of range are dropped instead of raising.
"""

from __future__ import annotations

import torch


def nonzero_fixed(mask: torch.Tensor, size: int, batched: bool = False) -> torch.Tensor:
    """(size,) int64 indices of True entries of a 1-D mask, -1 padded.
    batched: a (N, M) mask gives (N, size), row by row (the JAX package's
    vmap of the 1-D form)."""
    flat = mask if batched else mask.reshape(-1)
    n = flat.shape[-1]
    # stable sort of (not mask) puts True entries first, in index order
    order = torch.sort((~flat).to(torch.uint8), dim=-1, stable=True).indices
    if size > n:
        pad = torch.zeros(tuple(order.shape[:-1]) + (size - n,), dtype=order.dtype,
                          device=order.device)
        order = torch.cat([order, pad], dim=-1)
    idx = order[..., :size]
    count = flat.sum(-1, keepdim=True)
    keep = torch.arange(size, device=flat.device) < count
    return torch.where(keep, idx, torch.full_like(idx, -1))


def scatter_drop(dst: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
                 batched: bool = False) -> torch.Tensor:
    """Out-of-place `dst.at[idx].set(vals, mode="drop")` along dim 0;
    batched: along dim 1, row by row (dst (N, M, ...), idx (N, K), vals
    (N, K, ...))."""
    if batched:
        N, M = dst.shape[:2]
        ok = (idx >= 0) & (idx < M)
        rows = torch.arange(N, device=idx.device)[:, None] * M
        flat_idx = torch.where(ok, idx + rows, torch.full_like(idx, -1)).reshape(-1)
        out = scatter_drop(dst.reshape((N * M,) + tuple(dst.shape[2:])), flat_idx,
                           vals.reshape((-1,) + tuple(vals.shape[2:])))
        return out.reshape(dst.shape)
    ok = (idx >= 0) & (idx < dst.shape[0])
    out = dst.clone()
    out[idx[ok]] = vals[ok].to(dst.dtype)
    return out
