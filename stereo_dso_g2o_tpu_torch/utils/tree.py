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
