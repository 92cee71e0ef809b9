"""Trees of tensors: NamedTuples, dataclasses, tuples and lists down to
tensors, mapped leaf by leaf (the part of `jax.tree_util` the port uses)."""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


def tree_map(fn: Callable, tree, *rest):
    """`fn` over the tensor leaves of `tree` (and of `rest`, trees of the
    same structure), rebuilt in the structure of `tree`."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{
            f.name: tree_map(fn, getattr(tree, f.name), *[getattr(r, f.name) for r in rest])
            for f in dataclasses.fields(tree)
        })
    if isinstance(tree, (tuple, list)):
        items = [tree_map(fn, x, *[r[i] for r in rest]) for i, x in enumerate(tree)]
        return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)
    raise TypeError(f"tree_map: a {type(tree).__name__} is neither a tensor nor a container")


def leaves(tree) -> list:
    """The tensor leaves of a tree, in `tree_map`'s order."""
    out = []
    tree_map(lambda x: out.append(x) or x, tree)
    return out


def lead_one(tree):
    """Every leaf with a leading axis of one: one sequence as a batch of one."""
    return tree_map(lambda x: x[None], tree)


def first(tree):
    """Row 0 of every leaf: the one sequence of a batch of one."""
    return tree_map(lambda x: x[0], tree)


def at_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[n, idx[n]] for every row n of a batch: x (N, M, ...), idx (N,) or
    (N, K) (one index or K indices per row)."""
    n = torch.arange(x.shape[0], device=x.device).reshape((-1,) + (1,) * (idx.dim() - 1))
    return x[n, idx]


def at_index(x: torch.Tensor, i, dim: int = 0) -> torch.Tensor:
    """x[i] along `dim`, for an int or a 0-dim integer tensor `i`: a tensor
    index is gathered on the device (an index by a 0-dim tensor reads it on
    the host)."""
    if isinstance(i, torch.Tensor):
        return x.index_select(dim, i.reshape(1).long()).squeeze(dim)
    return x.select(dim, i)


def set_index(x: torch.Tensor, i, val):
    """x[i] = val in place along the first axis, for an int (or any index
    Python takes) or a 0-dim integer tensor `i`, which is written on the
    device with no read (`val` a tensor then)."""
    if isinstance(i, torch.Tensor) and i.dim() == 0:
        x.index_put_((i.reshape(1).long(),), val.to(x.dtype))
    else:
        x[i] = val


def seq_scalar(x, nd: int):
    """A per-sequence scalar, () for one sequence or (N,) for N, shaped to
    broadcast over `nd` trailing axes of the sequence's tensors."""
    x = torch.as_tensor(x)
    return x.reshape(tuple(x.shape) + (1,) * nd) if x.dim() else x


def per_row(fn: Callable, batched: bool, *xs):
    """fn(*xs); with `batched`, fn on each row of the leading axis of every
    x, stacked (leaf by leaf for a tuple of outputs): each row is the call
    one row alone makes. For products whose rounding depends on the batch:
    a BLAS splits a lone GEMM's sum over threads and not a batch's, and on
    the card cuBLAS runs a product batched over the sequence axis alone as
    one GEMM for one sequence and as a batched GEMM for several, and picks
    the batched algorithm by the batch count."""
    if not batched:
        return fn(*xs)
    outs = [fn(*[x[i] for x in xs]) for i in range(xs[0].shape[0])]
    join = (lambda o: o[0][None]) if len(outs) == 1 else torch.stack  # one row: a view
    if isinstance(outs[0], tuple):
        return tuple(join(o) for o in zip(*outs))
    return join(outs)


def select_rows(keep: torch.Tensor, new, old):
    """`new` where the (N,) mask `keep` is set, `old` elsewhere, leaf by
    leaf over two trees stacked over N (a leaf both share is passed
    through)."""
    def pick(a, b):
        if a is b:
            return a
        return torch.where(keep.reshape(keep.shape + (1,) * (a.dim() - keep.dim())), a, b)

    return tree_map(pick, new, old)
