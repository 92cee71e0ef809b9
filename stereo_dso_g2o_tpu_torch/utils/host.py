"""The frame program's device-to-host reads, counted in one place.

The JAX package's frame program is one XLA program with one small fetch a
frame. The port's frame program is one captured program on the card
(`runtime/program.py`), which reads nothing; run eagerly it is Python,
and wherever its code needs a device value on the host (the flag that
ends a loop or picks a branch, the fetched bundle) the host waits for the
device. Every such read goes through `flag`, `item` or `tolist` here
(one Python-level read each: `bool`, `.item()`, `.tolist()`), or is
announced with `count` where it is made elsewhere (the lagged drain of a
bundle, `Fetch.get`), and adds one to `READS`. Synchronizations inside
torch ops (masked indexing, `nonzero`, a linalg error check) are not
counted.
"""

from __future__ import annotations

import numpy as np
import torch

from stereo_dso_g2o_tpu_torch.utils.tree import leaves

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


class Fetch:
    """A tree of tensors copied to the host: the copy starts at
    construction and `get()` waits for it (one read). On the card the
    leaves are packed into one byte buffer and copied into pinned memory
    behind the work already queued, so the host does not wait at the start
    and `get()` waits for that work only, not for what was queued after
    it: the host may run ahead of the device until then."""

    def __init__(self, tree):
        xs = leaves(tree)
        self.meta = [(tuple(x.shape), x.dtype) for x in xs]
        self.event = None
        if xs and xs[0].is_cuda:
            flat = torch.cat([x.detach().reshape(-1).contiguous().view(torch.uint8) for x in xs])
            self.buf = torch.empty(flat.shape, dtype=torch.uint8, pin_memory=True)
            self.buf.copy_(flat, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.buf = xs

    def get(self) -> list:
        """The leaves as numpy arrays, in `utils/tree.leaves` order."""
        count()
        if self.event is None:
            return [x.numpy() for x in self.buf]
        self.event.synchronize()
        raw, out, at = self.buf.numpy(), [], 0
        for shape, dtype in self.meta:
            dt = torch.empty(0, dtype=dtype).numpy().dtype
            n = int(np.prod(shape)) * dt.itemsize
            out.append(np.frombuffer(raw, dtype=dt, count=n // dt.itemsize, offset=at)
                       .reshape(shape).copy())
            at += n
        return out
