"""Loops and branches whose course the device decides: the port's
`lax.while_loop` and `lax.cond`.

Eagerly (on the CPU, or on the card outside a captured program) a loop is
a host loop, one read of its flag before every trip (`utils/host.py`), and
a branch one read of its predicate. While `runtime/program.py` captures a
program (inside `capturing`), the same loop becomes a CUDA WHILE node and
the branch an IF node, both added by `csrc/graph_while.cu`, whose library
the capture hands in: nothing is read, the device decides. Under
`bounded()` every loop runs to its bound and every branch's body runs,
with no read: what the nodes compute, checked where there is no card (a
trip after the last changes nothing, and a body leaves what its predicate
does not select as it was).

A node's body is captured once and runs as often as the device decides,
so no search kernel may be launched inside one: its launch counter
(`ops/trace_cuda.LAUNCHES`), which a replay advances by the launches
captured, would then count one launch whatever the trips. `_conditional`
raises if the counters moved while a body was captured.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
from typing import Callable, Optional

import torch

from stereo_dso_g2o_tpu_torch.utils import host

_BOUNDED = False
_CAPTURE: Optional["Capture"] = None  # the capture in progress
_BODY_STREAMS = {}  # (device, depth) -> the stream node bodies are captured on


@dataclasses.dataclass
class Capture:
    """What a capture in progress gives its loops and branches: the bound
    `csrc/graph_while.cu` (`sdso_cond_begin`, `sdso_cond_end`), the graph
    pool a body's allocations go to, and a function that reads the search
    kernels' launch counters. It counts the nodes it adds."""

    lib: ctypes.CDLL
    body_pool: tuple
    launches: Callable[[], tuple]
    depth: int = 0
    while_nodes: int = 0
    if_nodes: int = 0
    body_nodes: int = 0


@contextlib.contextmanager
def bounded():
    """Within the block, loops run to their bound and branches always."""
    global _BOUNDED
    prev, _BOUNDED = _BOUNDED, True
    try:
        yield
    finally:
        _BOUNDED = prev


@contextlib.contextmanager
def capturing(lib, body_pool, launches):
    """Within the block (a graph capture), loops and branches on a
    capturing stream become conditional nodes; yields their `Capture`."""
    global _CAPTURE
    if _CAPTURE is not None:
        raise RuntimeError("a program is already being captured")
    _CAPTURE = Capture(lib, body_pool, launches)
    try:
        yield _CAPTURE
    finally:
        _CAPTURE = None


def _capturing(t: torch.Tensor) -> bool:
    return t.is_cuda and torch.cuda.is_current_stream_capturing()


def _check(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what} failed: cudaError {rc}")


@contextlib.contextmanager
def _allocate_to(device: torch.device, pool):
    """Route this thread's allocations to the graph pool `pool`."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    torch._C._cuda_beginAllocateCurrentThreadToPool(idx, pool)
    try:
        yield
    finally:
        torch._C._cuda_endAllocateToPool(idx, pool)


def _conditional(flag: torch.Tensor, body: Callable[[], None], is_while: bool):
    """A conditional node on the () bool `flag` whose body `body()` is
    captured on a stream of its own (one per nesting depth). A body's
    allocations go to the capture's body pool, a pool of their own: a
    body's temporaries are reused only by later bodies, which run after it
    (the thread is routed there once, at the outermost body)."""
    cap = _CAPTURE
    if cap is None:
        raise RuntimeError("a loop or branch is being captured outside runtime/program.py")
    dev = flag.device
    key = (dev, cap.depth)
    stream = _BODY_STREAMS.get(key)
    if stream is None:
        stream = _BODY_STREAMS[key] = torch.cuda.Stream(dev)
    handle = ctypes.c_ulonglong()
    _check(cap.lib.sdso_cond_begin(torch.cuda.current_stream(dev).cuda_stream, stream.cuda_stream,
                                   flag.data_ptr(), int(is_while), ctypes.byref(handle)),
           "adding a conditional node")
    nodes = ctypes.c_ulonglong()
    routed = _allocate_to(dev, cap.body_pool) if cap.depth == 0 else contextlib.nullcontext()
    launches = cap.launches()
    cap.depth += 1
    try:
        with torch.cuda.stream(stream), routed:
            body()
            _check(cap.lib.sdso_cond_end(stream.cuda_stream, flag.data_ptr() if is_while else None,
                                         handle, ctypes.byref(nodes)), "capturing a node's body")
    finally:
        cap.depth -= 1
    if cap.launches() != launches:
        raise RuntimeError(
            f"a search kernel was launched inside a {'WHILE' if is_while else 'IF'} node's body "
            f"(launch counters {launches} -> {cap.launches()}): a replay would count it once "
            f"whatever the trips or branch; launch it outside the loop or branch")
    cap.body_nodes += nodes.value


def _while_node(done: torch.Tensor, trip: Callable[[], None]):
    """`while_loop` inside a capture: a WHILE node whose body is `trip` and
    whose condition, "some entry of `done` is not set", the device
    evaluates before every trip."""
    flag = torch.logical_not(done.all())

    def body():
        trip()
        torch.logical_not(done.all(), out=flag)

    _conditional(flag, body, True)
    _CAPTURE.while_nodes += 1


def _if_node(pred: torch.Tensor, body: Callable, otherwise):
    """`cond` inside a capture: an IF node on `pred`, whose body writes
    `body()`'s result over a copy of `otherwise`."""
    outs = [x.clone() for x in otherwise]

    def write():
        for o, r in zip(outs, body()):
            o.copy_(r)

    _conditional(pred.to(torch.bool), write, False)
    _CAPTURE.if_nodes += 1
    return type(otherwise)(*outs)


def while_loop(done: torch.Tensor, trip: Callable[[], None], bound: int):
    """Run `trip()` until every entry of the bool tensor `done` is set.
    `trip` updates `done` and the rest of its carry in place; a trip after
    every entry is set must change nothing, and after `bound` trips every
    entry is set."""
    if _capturing(done):
        _while_node(done, trip)
    elif _BOUNDED:
        for _ in range(bound):
            trip()
    else:
        while not host.flag(done.all()):
            trip()


def cond(pred: torch.Tensor, body: Callable, otherwise):
    """`body()` if the () bool tensor `pred` holds, else `otherwise` (a
    NamedTuple of tensors of body's shapes). `body` must give `otherwise`'s
    values wherever it does not act, so running it always is the same."""
    if _capturing(pred):
        return _if_node(pred, body, otherwise)
    if _BOUNDED or host.flag(pred):
        return body()
    return otherwise
