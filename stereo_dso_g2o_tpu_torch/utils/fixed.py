"""Fixed-shape helpers that JAX provides and PyTorch does not.

- `nonzero_fixed` is `jnp.nonzero(mask, size=size, fill_value=-1)[0]` for a
  1-D mask: the indices of the True entries in raster order, cut or padded
  with -1 to exactly `size` entries.
- `scatter_drop` is `dst.at[idx].set(vals, mode="drop")`: rows whose index is
  out of range are dropped instead of raising.
"""

from __future__ import annotations

import torch


def nonzero_fixed(mask: torch.Tensor, size: int) -> torch.Tensor:
    """(size,) int64 indices of True entries of a 1-D mask, -1 padded."""
    flat = mask.reshape(-1)
    n = flat.shape[0]
    # stable sort of (not mask) puts True entries first, in index order
    order = torch.sort((~flat).to(torch.uint8), stable=True).indices
    if size > n:
        order = torch.cat(
            [order, torch.zeros(size - n, dtype=order.dtype, device=order.device)]
        )
    idx = order[:size]
    count = flat.sum()
    keep = torch.arange(size, device=flat.device) < count
    return torch.where(keep, idx, torch.full_like(idx, -1))


def scatter_drop(dst: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Out-of-place `dst.at[idx].set(vals, mode="drop")` along dim 0."""
    ok = (idx >= 0) & (idx < dst.shape[0])
    out = dst.clone()
    out[idx[ok]] = vals[ok].to(dst.dtype)
    return out
