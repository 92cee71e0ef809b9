"""The frame program's device-to-host reads, counted in one place.

The JAX package's frame program is one XLA program with one small fetch a
frame. The port's track half is one captured program on the card
(`runtime/program.py`), which reads nothing; the rest, and the track half
run eagerly, is Python, and wherever its code needs a device value on the
host (the flag that ends a loop, a slot that indexes a host list, the
keyframe's packed values, the fetched bundle) the host waits for the
device. Every such read goes through `flag`, `item` or `tolist` here
(one Python-level read each: `bool`, `.item()`, `.tolist()`), or is
announced with `count` where it is made elsewhere (the lagged drain of a
bundle), and adds one to `READS`. Synchronizations inside torch ops
(masked indexing, `nonzero`, a linalg error check) are not counted.
"""

from __future__ import annotations

import torch

READS = 0  # device->host reads since the last reset()


def reset():
    global READS
    READS = 0


def count(n: int = 1):
    """Announce `n` reads made outside this module."""
    global READS
    READS += n


def flag(x: torch.Tensor) -> bool:
    """One read: a () bool tensor as a Python bool."""
    count()
    return bool(x)


def item(x: torch.Tensor):
    """One read: a one-element tensor as a Python number."""
    count()
    return x.item()


def tolist(x: torch.Tensor):
    """One read: a tensor as a (nested) Python list or scalar."""
    count()
    return x.tolist()
