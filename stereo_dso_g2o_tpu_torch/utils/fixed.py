"""Fixed-shape helpers that JAX provides and PyTorch does not.

- `nonzero_fixed` is `jnp.nonzero(mask, size=size, fill_value=-1)[0]` for a
  1-D mask: the indices of the True entries in raster order, cut or padded
  with -1 to exactly `size` entries (row by row for a batch of masks).
- `scatter_drop` is `dst.at[idx].set(vals, mode="drop")`: rows whose index is
  out of range are dropped instead of raising; a negative index drops too
  (the JAX package's call sites send an unused lane's -1 past the end).
- `constant` is a tensor of Python values made once per device and kept: a
  captured program reads it, where it could not copy it from the host.
"""

from __future__ import annotations

import numpy as np
import torch

_CONSTANTS = {}


def constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """`torch.as_tensor(values, dtype=dtype, device=device)`, made at the
    first call for these values, type and device and returned from then on
    (read it, never write it)."""
    arr = np.asarray(values)
    device = torch.device(device)
    key = (arr.dtype.str, arr.shape, arr.tobytes(), dtype, device)
    t = _CONSTANTS.get(key)
    if t is None:
        t = _CONSTANTS[key] = torch.as_tensor(arr, dtype=dtype, device=device)
    return t


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
    """Out-of-place `dst.at[idx].set(vals, mode="drop")` along dim 0, a
    negative index dropped as one past the end is. batched: along dim 1,
    row by row (dst (N, M, ...), idx (N, K), vals (N, K, ...)).
    Fixed-shape: the rows that drop are written to a spare row past the
    end, so no mask selects them (a masked index is a `nonzero`, which
    waits for the device)."""
    if batched:
        N, M = dst.shape[:2]
        ok = (idx >= 0) & (idx < M)
        rows = torch.arange(N, device=idx.device)[:, None] * M
        flat_idx = torch.where(ok, idx + rows, torch.full_like(idx, N * M)).reshape(-1)
        out = scatter_drop(dst.reshape((N * M,) + tuple(dst.shape[2:])), flat_idx,
                           vals.reshape((-1,) + tuple(vals.shape[2:])))
        return out.reshape(dst.shape)
    M = dst.shape[0]
    at = torch.where((idx >= 0) & (idx < M), idx, torch.full_like(idx, M))
    out = torch.cat([dst, dst.new_zeros((1,) + tuple(dst.shape[1:]))])
    out.index_put_((at,), vals.to(dst.dtype))
    return out[:M]
